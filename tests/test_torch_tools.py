"""The port's telemetry readers and data tools against the JAX
package's, and its telemetry / trace / serve / obs smokes on the CPU.

- metrics_report, agg and trace_export give the JAX tools' output, byte
  for byte, on the same JSONL streams (streams the port's own smokes
  wrote: the port's sinks emit the JAX schema);
- write_synth_mnist and digits_to_idx write the JAX tools' idx bytes;
- telemetry_smoke, trace_smoke, serve_smoke and obs_smoke exit 0 with
  `--dev cpu`.
"""

import gzip
import json
import os
import time

import pytest

from cxxnet_tpu.tools import agg as jax_agg
from cxxnet_tpu.tools import metrics_report as jax_report
from cxxnet_tpu.tools import trace_export as jax_trace
from cxxnet_tpu_torch.tools import agg, metrics_report, trace_export


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """events/metrics JSONL of a port training run (telemetry_smoke) and
    request traces of a port serve storm (trace_smoke), on the CPU."""
    from cxxnet_tpu_torch.tools import telemetry_smoke, trace_smoke
    d = str(tmp_path_factory.mktemp("streams"))
    rc_train = telemetry_smoke.main(["--out", d, "--dev", "cpu"])
    rc_trace = trace_smoke.main(["--out", d, "--dev", "cpu"])
    return {"dir": d, "rc": (rc_train, rc_trace),
            "metrics": os.path.join(d, "metrics.jsonl"),
            "events": os.path.join(d, "events.jsonl"),
            "trace_events": os.path.join(d, "trace_events.jsonl")}


def test_telemetry_and_trace_smokes_pass_on_the_cpu(streams):
    assert streams["rc"] == (0, 0)


def _out(capsys, fn, *args):
    capsys.readouterr()
    rc = fn(*args)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("flags", [[], ["--json"]])
def test_metrics_report_equals_jax(streams, capsys, flags):
    args = [streams["metrics"]] + flags
    want = _out(capsys, jax_report.main, args)
    got = _out(capsys, metrics_report.main, args)
    assert got == want and want[0] == 0 and "round" in want[1]


@pytest.mark.parametrize("flags", [[], ["--json"], ["--verdict-json"],
                                   ["--stale-secs", "0.5"]])
def test_agg_equals_jax(streams, capsys, monkeypatch, flags):
    # ages and staleness read the wall clock: pin it
    monkeypatch.setattr(time, "time", lambda: 1.9e9)
    args = [streams["metrics"], streams["events"]] + flags
    want = _out(capsys, jax_agg.main, args)
    got = _out(capsys, agg.main, args)
    assert got == want and want[1]


def test_trace_export_equals_jax(streams, capsys, tmp_path):
    outs = {}
    for name, mod in (("jax", jax_trace), ("port", trace_export)):
        trace = tmp_path / f"{name}.json"
        summary = tmp_path / f"{name}.summary.json"
        rc, text = _out(capsys, mod.main, [
            streams["trace_events"], "-o", str(trace),
            "--summary-json", str(summary)])
        outs[name] = (rc, text.replace(str(trace), "TRACE"),
                      trace.read_bytes(), summary.read_bytes())
    assert outs["port"] == outs["jax"]
    assert outs["jax"][0] == 0
    assert json.loads(outs["jax"][2])["traceEvents"]


def _idx_bytes(d):
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".gz"):
            with gzip.open(os.path.join(d, name), "rb") as f:
                out[name] = f.read()
    return out


def test_write_synth_mnist_equals_jax(tmp_path):
    from cxxnet_tpu.tools.telemetry_smoke import write_synth_mnist as jw
    from cxxnet_tpu_torch.tools.telemetry_smoke import write_synth_mnist
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    for seed, prefix, n in ((0, "train", 256), (1, "test", 64)):
        jw(str(a), n, seed, prefix)
        write_synth_mnist(str(b), n, seed, prefix)
    assert _idx_bytes(b) == _idx_bytes(a) and len(_idx_bytes(a)) == 4


def test_fused_smoke_uses_the_one_synthetic_writer():
    from cxxnet_tpu_torch.tools import fused_smoke, telemetry_smoke
    assert fused_smoke.write_synth_mnist is telemetry_smoke.write_synth_mnist


def test_digits_to_idx_equals_jax(tmp_path):
    pytest.importorskip("sklearn")
    from cxxnet_tpu.tools import digits_to_idx as jd
    from cxxnet_tpu_torch.tools import digits_to_idx as pd
    assert jd.build(str(tmp_path / "jax")) == pd.build(str(tmp_path / "p"))
    a, b = _idx_bytes(tmp_path / "jax"), _idx_bytes(tmp_path / "p")
    assert b == a and sorted(a) == [
        "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz",
        "train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"]


def test_digits_to_idx_names_sklearn_when_missing(monkeypatch, tmp_path):
    import sys
    from cxxnet_tpu_torch.tools import digits_to_idx as pd
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        pd.build(str(tmp_path))


def test_serve_smoke_passes_on_the_cpu(tmp_path):
    from cxxnet_tpu_torch.tools import serve_smoke
    assert serve_smoke.main(["--out", str(tmp_path), "--dev", "cpu"]) == 0


def test_obs_smoke_passes_on_the_cpu(tmp_path):
    from cxxnet_tpu_torch.tools import obs_smoke
    assert obs_smoke.main(["--out", str(tmp_path), "--dev", "cpu"]) == 0
