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


def _modules():
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                yield rel.replace(os.sep, ".").removesuffix(".__init__")


def test_import_everything_pulls_no_jax_and_no_cxxnet_tpu():
    mods = sorted(set(_modules()))
    assert "cxxnet_tpu_torch.ops.lrn" in mods
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


def test_dev_conf_key_picks_the_device():
    assert NetTrainer(cfg="dev = cpu\n").device.type == "cpu"
    assert NetTrainer(dev="cpu").device.type == "cpu"


@pytest.mark.parametrize("spec,want", [
    ("cpu", "cpu"), ("gpu", "cuda:0"), ("gpu:0", "cuda:0"),
    ("cuda", "cuda:0"), ("tpu", "cuda:0"), ("tpu:0", "cuda:0"),
])
def test_dev_mapping(spec, want):
    assert device_from_spec(spec) == want


@pytest.mark.parametrize("spec", ["tpu:0-63", "gpu:0,1", "tpu:0-3"])
def test_multi_device_specs_raise(spec):
    with pytest.raises(NotImplementedError, match="multi-device"):
        device_from_spec(spec)


@pytest.mark.parametrize("key,val", [
    ("tuning_cache", "tc.json"), ("remat", "1"),
    ("profile", "1"), ("zero_stage", "2"), ("mesh", "data:2"),
    ("steps_per_dispatch", "4"), ("telemetry_steps", "10"),
    ("model_format", "cxxnet"), ("extra_data_num", "1"),
    ("serve_port", "8080"), ("swap_watch", "m.model"),
])
def test_result_changing_keys_raise(key, val):
    tr = NetTrainer(device="cpu")
    with pytest.raises(NotImplementedError, match=key):
        tr.set_param(key, val)


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


def test_iterator_not_yet_ported_raises():
    """The routes of the data pipeline the port has not: the native
    decoder and multi-worker sharding."""
    from cxxnet_tpu_torch.io import create_iterator
    with pytest.raises(NotImplementedError, match="use_native"):
        create_iterator([("iter", "imgbin"), ("use_native", "1"),
                         ("iter", "end")])
    with pytest.raises(NotImplementedError, match="dist_num_worker"):
        create_iterator([("iter", "imgbin"), ("dist_num_worker", "2"),
                         ("iter", "threadbuffer"), ("iter", "end")])


def test_kernels_are_not_built_at_import():
    """Importing the package builds nothing: the libraries appear only
    when a wrapper first needs one (on the card)."""
    assert set(kernels.SOURCES) == set(kernels.LAUNCHES)
    for name, src in kernels.SOURCES.items():
        assert os.path.exists(os.path.join(kernels.CSRC, src))
    assert "lrn_fwd" not in kernels._libs or torch.cuda.is_available()
