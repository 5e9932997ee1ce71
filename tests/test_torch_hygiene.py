"""The port stands alone: cxxnet_tpu_torch imports neither jax nor
anything of cxxnet_tpu (checked in a fresh interpreter and by scanning
the sources), its entry points run on the card unless asked for the
CPU, `dev` specs map as documented, and keys it does not implement
raise instead of being ignored."""

import os
import re
import subprocess
import sys

import pytest
import torch

import cxxnet_tpu_torch
from cxxnet_tpu_torch import kernels
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve import Server
from cxxnet_tpu_torch.utils.device import device_from_spec
from torch_port_util import NARROW_ALEXNET

PKG = os.path.dirname(os.path.abspath(cxxnet_tpu_torch.__file__))
REPO = os.path.dirname(PKG)


# the analysis tier and the tools ported with it
ANALYSIS_AND_TOOLS = (
    "analysis", "analysis.astlint", "analysis.graph_audit",
    "analysis.lock_audit", "analysis.__main__", "tools.common",
    "tools.agg", "tools.metrics_report", "tools.trace_export",
    "tools.digits_to_idx", "tools.telemetry_smoke", "tools.trace_smoke",
    "tools.obs_smoke", "tools.serve_smoke", "tools.serve_http_smoke",
    "tools.canary_smoke", "tools.pass_smoke", "tools.bench_attn",
    "tools.bench_pool")
# the entry points among them that run on a device
DEVICE_TOOLS = ("telemetry_smoke", "trace_smoke", "obs_smoke",
                "serve_smoke", "serve_http_smoke", "canary_smoke",
                "pass_smoke", "bench_attn", "bench_pool")


def _modules():
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                yield rel.replace(os.sep, ".").removesuffix(".__init__")


def test_import_everything_pulls_no_jax_and_no_cxxnet_tpu():
    mods = sorted(set(_modules()))
    for m in ("ops.lrn", "utils.profiler", "nnet.tuning",
              "tools.fused_smoke", "tools.profile_step", "tools.autotune",
              "parallel", "parallel.mesh", "parallel.distributed",
              "parallel.sharding", "tools.launch_dist",
              *ANALYSIS_AND_TOOLS):
        assert f"cxxnet_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'cxxnet_tpu'\n"
        "             or m.startswith('cxxnet_tpu.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_sources_import_no_jax_and_no_cxxnet_tpu():
    pat = re.compile(r"^\s*(import\s+(jax|cxxnet_tpu)\b(?!_torch)"
                     r"|from\s+(jax|cxxnet_tpu)\b(?!_torch))", re.M)
    hits = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    hits += [f"{path}: {m.group(0)}"
                             for m in pat.finditer(fh.read())]
    assert hits == []
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as fh:
        assert not pat.search(fh.read())


def test_surface_modules_stand_alone():
    """The reference's surface (the numpy wrapper, the C ABI shim and
    its build, the reference-binary format) is in the port's tree, and
    the C ABI library embeds cxxnet_tpu_torch.capi: it imports no module
    of cxxnet_tpu and includes nothing of native/."""
    mods = set(_modules())
    for m in ("wrapper", "capi", "capi_build", "nnet.legacy_format"):
        assert f"cxxnet_tpu_torch.{m}" in mods
    for name in ("cxxnet_wrapper.cc", "cxxnet_wrapper.h", "capi_driver.c"):
        with open(os.path.join(PKG, "csrc", name), encoding="utf-8") as f:
            src = f.read()
        imports = re.findall(r'PyImport_ImportModule\("([^"]+)"\)', src)
        assert imports == (["cxxnet_tpu_torch.capi"]
                           if name.endswith(".cc") else [])
        assert not re.search(r"cxxnet_tpu\.(?!capi)|cxxnet_tpu\.capi",
                             src.replace("cxxnet_tpu_torch", ""))
        includes = re.findall(r'#include\s*[<"]([^>"]+)[>"]', src)
        assert not any("native" in i or "/" in i for i in includes)


def test_entry_points_default_to_the_card(monkeypatch):
    """With no card, the default device raises and names the CPU
    spelling; asking for the CPU works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        NetTrainer()
    with pytest.raises(RuntimeError, match="dev = cpu"):
        NetTrainer(dev="gpu")
    tr = NetTrainer(cfg=NARROW_ALEXNET, device="cpu")
    tr.init_model()
    assert tr.device.type == "cpu"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Server(tr)
    with Server(tr, max_batch=2, device="cpu") as srv:
        assert srv.submit(torch.zeros(3, 35, 35).numpy()).result(
            timeout=60).shape == (1, 10)


@pytest.mark.parametrize("tool", DEVICE_TOOLS)
def test_tools_default_to_the_card(monkeypatch, tmp_path, tool):
    """Every new tool runs on the card unless asked for the CPU: with no
    card its entry point raises and names `--dev cpu`, before it writes
    anything."""
    import importlib
    mod = importlib.import_module(f"cxxnet_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    args = ([] if tool.startswith("bench") else ["--out", str(out)])
    with pytest.raises(RuntimeError, match="--dev cpu"):
        mod.main(args)
    assert not out.exists() or not any(out.iterdir())


@pytest.mark.parametrize("flag", ["--graph-audit", "--lock-audit"])
def test_audits_default_to_the_card(monkeypatch, flag):
    from cxxnet_tpu_torch.analysis.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--dev cpu"):
        main([flag])


def test_dev_conf_key_picks_the_device():
    assert NetTrainer(cfg="dev = cpu\n").device.type == "cpu"
    assert NetTrainer(dev="cpu").device.type == "cpu"


@pytest.mark.parametrize("spec,want", [
    ("cpu", "cpu"), ("gpu", "cuda:0"), ("gpu:0", "cuda:0"),
    ("cuda", "cuda:0"), ("tpu", "cuda:0"), ("tpu:0", "cuda:0"),
])
def test_dev_mapping(spec, want):
    assert device_from_spec(spec) == want


SMALL_NET = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 4
layer[1->1] = softmax
netconfig=end
input_shape = 1,1,8
batch_size = 64
silent = 1
"""


@pytest.mark.parametrize("spec", ["tpu:0-63", "gpu:0,1", "tpu:0-3"])
def test_multi_device_specs_raise(spec):
    """A multi-device spec declares a data axis of one rank per listed
    card: it maps to this worker's card (rank 0: the first listed), and
    a trainer started alone with it raises, naming param_server = dist
    and tools/launch_dist."""
    assert device_from_spec(spec) == "cuda:0"
    tr = NetTrainer(device="cpu", cfg=SMALL_NET)
    tr.set_param("dev", spec)
    with pytest.raises(ValueError,
                       match="param_server = dist under tools/launch_dist"):
        tr.init_model()


@pytest.mark.parametrize("key,val,exc,match", [
    ("mesh", "pipe:2", NotImplementedError, "pipe"),
    ("mesh", "expert:2", NotImplementedError, "expert"),
    # the seq axis is ported: in one process its mesh raises at the
    # build, as a data or model axis does (the id it had while the axis
    # itself raised)
    pytest.param("mesh", "seq:2", ValueError, "param_server = dist",
                 id="mesh-seq:2-NotImplementedError-seq"),
    ("mesh", "model:2", ValueError, "param_server = dist"),
    ("mesh", "data:2", ValueError, "param_server = dist"),
])
def test_result_changing_keys_raise(key, val, exc, match):
    """What the parallelism slices do not port raises naming itself:
    the pipe and expert axes at set_param; a data, model or seq axis
    larger than the job (one process here) at the net's build."""
    tr = NetTrainer(device="cpu", cfg=SMALL_NET)
    with pytest.raises(exc, match=match):
        tr.set_param(key, val)
        tr.init_model()


@pytest.mark.parametrize("key,val,attr,want", [
    ("tuning_cache", "tc.json", "tuning_cache", "tc.json"),
    ("remat", "1", "remat", 1),
    ("profile", "1", "profile", 1),
    ("steps_per_dispatch", "4", "steps_per_dispatch", 4),
    ("trace_round", "2", "trace_round", 2),
    ("profile_dir", "prof", "profile", 1),
])
def test_single_device_keys_are_accepted(key, val, attr, want):
    """The trainer's single-device keys, once refused, are ported:
    set_param takes them and the trainer holds the value (profile_dir
    turns profile on, as in the JAX package)."""
    tr = NetTrainer(device="cpu")
    tr.set_param(key, val)
    assert getattr(tr, attr) == want


@pytest.mark.parametrize("key,val", [
    ("graph_passes", ""), ("zero_stage", "0"), ("steps_per_dispatch", "1"),
    ("device_augment", "0"), ("serve_deadline_ms", "0.0"),
    ("pass_fold_conv_bn", "0"), ("graph_passes", "quantize_int8"),
    ("graph_passes", "all"), ("pass_fold_conv_bn", "1"),
])
def test_inert_values_are_accepted(key, val):
    NetTrainer(device="cpu").set_param(key, val)


def test_layer_not_yet_ported_raises_at_net_build():
    """Every layer type of the JAX package is ported: an unknown type
    raises ValueError at net build with the JAX package's message
    (cxxnet_tpu/layers/base.py:276-277)."""
    tr = NetTrainer(cfg=NARROW_ALEXNET.replace("= lrn", "= prelux"),
                    device="cpu")
    with pytest.raises(ValueError) as err:
        tr.init_model()
    assert str(err.value) == 'unknown layer type: "prelux"'


def test_iterator_not_yet_ported_raises(monkeypatch, tmp_path):
    """The data pipeline's refusals: use_native = 1 with no device given
    means the card (the native decoder, nvJPEG), and with no card it
    raises naming device="cpu" rather than decoding on the host.
    Multi-worker sharding is ported: a threadbuffer chain passes
    dist_num_worker / dist_worker_rank down to its imgbin base."""
    from cxxnet_tpu_torch.io import create_iterator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lst = tmp_path / "empty.lst"
    lst.write_text("")
    it = create_iterator([("iter", "imgbin"), ("image_list", str(lst)),
                          ("use_native", "1"), ("silent", "1"),
                          ("iter", "end")])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        it.init()
    it = create_iterator([("iter", "imgbin"), ("dist_num_worker", "2"),
                          ("dist_worker_rank", "1"),
                          ("iter", "threadbuffer"), ("iter", "end")])
    while not hasattr(it, "dist_num_worker"):
        it = getattr(it, "base", None) or it.inner
    assert (it.dist_num_worker, it.dist_worker_rank) == (2, 1)


def test_kernels_are_not_built_at_import():
    """Importing the package builds nothing: the libraries appear only
    when a wrapper first needs one (on the card)."""
    assert set(kernels.SOURCES) == set(kernels.LAUNCHES)
    for name, src in kernels.SOURCES.items():
        assert os.path.exists(os.path.join(kernels.CSRC, src))
    assert "lrn_fwd" not in kernels._libs or torch.cuda.is_available()
