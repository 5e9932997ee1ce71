"""The port's serving-front smokes and bench tools on the CPU:
serve_http_smoke and canary_smoke exit 0 with `--dev cpu`, the canary's
verdicts (promote the mid-storm publish, roll back the poisoned one)
are the JAX tool's, and bench_attn / bench_pool print their JSON lines
at a small shape."""

import json
import re

import pytest


def _verdicts(text):
    return [(m.group(1), m.group(2)) for m in
            re.finditer(r"^  \[(ok|FAIL)\] (.+)$", text, re.M)]


def test_serve_http_smoke_passes_on_the_cpu(tmp_path, capsys):
    from cxxnet_tpu_torch.tools import serve_http_smoke
    assert serve_http_smoke.main(["--out", str(tmp_path), "--dev",
                                  "cpu"]) == 0
    lines = _verdicts(capsys.readouterr().out)
    assert len(lines) == 9 and all(ok == "ok" for ok, _ in lines)


def test_canary_verdicts_equal_jax(tmp_path, capsys):
    from cxxnet_tpu.tools import canary_smoke as jax_canary
    from cxxnet_tpu_torch.tools import canary_smoke
    rc = canary_smoke.main(["--out", str(tmp_path / "port"), "--dev",
                            "cpu"])
    port = _verdicts(capsys.readouterr().out)
    (tmp_path / "jax").mkdir()
    jrc = jax_canary.run_smoke(str(tmp_path / "jax"))
    want = _verdicts(capsys.readouterr().out)
    assert rc == jrc == 0
    assert port == want
    labels = [label for _, label in port]
    assert any("auto-promoted" in lb for lb in labels)
    assert any("auto-rolled-back" in lb for lb in labels)


@pytest.mark.parametrize("tool,args,n", [
    ("bench_attn", ["--shape", "1,2,32,8", "--steps", "1"], 4),
    ("bench_pool", ["--batch", "1", "--steps", "1"], 3),
])
def test_bench_tools_print_one_json_line_per_config(capsys, tool, args, n):
    import importlib
    mod = importlib.import_module(f"cxxnet_tpu_torch.tools.{tool}")
    assert mod.main(args + ["--dev", "cpu"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(rows) == n
    for r in rows:
        assert "error" not in r and r["device"] == "cpu"
        ms = [v for k, v in r.items() if k.endswith("ms")]
        assert ms and all(v > 0 for v in ms)
