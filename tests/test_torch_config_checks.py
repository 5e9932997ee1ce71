"""The port's config checks against the JAX package's: the value checks
of the trainer (stage_dtype, eval_inflight, the serve knobs) raise the
same exception with the same message in both packages, and the schema
check of the CLI (a registry generated from the port's own source) gives
every shipped conf the same verdict as the JAX package's, rejects a
misspelt key with the same did-you-mean, is bypassed by
`schema_check = 0`, and knows every key the JAX package knows - each
either handled by the port or listed as not ported, in which case
setting it raises NotImplementedError naming the key."""

import glob
import os

import numpy as np
import pytest
import torch

from cxxnet_tpu.analysis import schema as jax_schema
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils.config import ConfigError as JaxConfigError
from cxxnet_tpu.utils.config import validate_known_keys as jax_validate
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.analysis import schema as port_schema
from cxxnet_tpu_torch.io.iter_mnist import MNISTIterator
from cxxnet_tpu_torch.layers.base import create_layer
from cxxnet_tpu_torch.nnet.trainer import NetTrainer as PortTrainer
from cxxnet_tpu_torch.utils.config import ConfigError as PortConfigError
from cxxnet_tpu_torch.utils.config import \
    validate_known_keys as port_validate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "**", "*.conf"),
                            recursive=True))

MLP = """netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 4
layer[1->1] = softmax
netconfig=end
input_shape = 1,1,6
batch_size = 2
"""


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the exception is the result
        return type(e), str(e)
    return None


# (pairs set in order, where it must raise: set_param or init_model)
F1_CASES = {
    "stage_dtype_float16": ([("stage_dtype", "float16")], "set"),
    "stage_dtype_int8": ([("stage_dtype", "int8")], "set"),
    "stage_bf16_under_f32": ([("dtype", "float32"),
                              ("stage_dtype", "bfloat16")], "init"),
    "eval_inflight_negative": ([("eval_inflight", "-1")], "set"),
    "serve_shed_clear_ms_negative": ([("serve_shed_clear_ms", "-1")],
                                     "set"),
    "swap_poll_ms_zero": ([("swap_poll_ms", "0")], "set"),
    "swap_poll_ms_negative": ([("swap_poll_ms", "-5")], "set"),
    "swap_canary_window_zero": ([("swap_canary_window", "0")], "set"),
}


def _f1_outcome(make, pairs, stage):
    tr = make()
    for k, v in pairs[:-1]:
        tr.set_param(k, v)
    got = _raised(lambda: tr.set_param(*pairs[-1]))
    if stage == "init":
        assert got is None
        got = _raised(tr.init_model)
    return got


@pytest.mark.parametrize("case", sorted(F1_CASES))
def test_f1_bad_values_raise_as_in_jax(case):
    pairs, stage = F1_CASES[case]
    want = _f1_outcome(lambda: JaxTrainer(cfg=MLP), pairs, stage)
    got = _f1_outcome(lambda: PortTrainer(cfg=MLP, device="cpu"), pairs,
                      stage)
    assert want is not None and want[0] is ValueError, want
    assert got == want


def test_f1_accepted_stage_dtypes_stage_the_same_bits():
    """stage_dtype = float32 | bfloat16 are accepted under bfloat16 and
    stage the same bits (the host cast and the device cast both round to
    nearest even); the default follows the compute dtype."""
    rows = np.random.RandomState(3).randn(2, 1, 1, 6).astype(np.float32)
    staged = []
    for sd in ("", "float32", "bfloat16"):
        tr = PortTrainer(cfg=MLP + "dtype = bfloat16\n", device="cpu")
        tr.set_param("stage_dtype", sd)
        tr.init_model()
        t = tr.stage_infer_rows(rows)
        assert t.dtype == torch.bfloat16
        staged.append(t)
    assert all(torch.equal(staged[0], t) for t in staged[1:])


@pytest.mark.parametrize("conf", EXAMPLES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_f2_example_confs_get_the_jax_verdict(conf):
    assert port_schema.check_config_file(conf) == \
        jax_schema.check_config_file(conf)


@pytest.mark.parametrize("typo", ["batch_sizee", "num_rond", "dtyp",
                                  "graph_pases"])
def test_f2_misspelt_key_raises_with_the_jax_suggestion(typo):
    pairs = [("batch_size", "8"), (typo, "256")]
    with pytest.raises(JaxConfigError) as want:
        jax_validate(pairs, source="my.conf")
    with pytest.raises(PortConfigError) as got:
        port_validate(pairs, source="my.conf")
    assert str(got.value) == str(want.value)
    assert "did you mean" in str(got.value)


def test_f2_cli_checks_file_and_command_line_and_schema_check_0_bypasses(
        tmp_path):
    good = tmp_path / "good.conf"
    good.write_text(MLP)
    with pytest.raises(PortConfigError, match=r"'num_rond' \(did you "
                       r"mean 'num_round'\?\) in command-line override"):
        port_main.LearnTask().load_conf(str(good), ["num_rond=3"])
    conf = tmp_path / "net.conf"
    conf.write_text(MLP + "batch_sizee = 256\n")
    with pytest.raises(PortConfigError, match=r"'batch_sizee' \(did you "
                       r"mean 'batch_size'\?\) in .*net\.conf"):
        port_main.LearnTask().load_conf(str(conf), ["dev=cpu"])
    task = port_main.LearnTask()
    task.load_conf(str(conf), ["dev=cpu", "schema_check=0", "num_rond=3"])
    assert ("batch_sizee", "256") in task.cfg
    # the same typo through the CLI's entry point
    with pytest.raises(PortConfigError, match="batch_sizee"):
        port_main.main([str(conf), "dev=cpu"])


def test_f2_every_jax_key_is_known_to_the_port():
    want = jax_schema.build_registry()
    got = port_schema.build_registry()
    missing = sorted(set(want.exact) - set(got.exact))
    assert not missing, missing
    assert {p for p, _ in want.prefixes} <= {p for p, _ in got.prefixes}


# a value each not-ported key takes in the JAX package and that is not
# its inert default ("7" unless the key wants text)
_NP_VALUE = {"model_format": "cxxnet", "stage_dtype": "bfloat16"}


def _setters():
    return {
        "cxxnet_tpu_torch/main.py":
            lambda k, v: port_main.LearnTask().set_param(k, v),
        "cxxnet_tpu_torch/nnet/trainer.py":
            lambda k, v: PortTrainer(device="cpu").set_param(k, v),
        "cxxnet_tpu_torch/layers/base.py":
            lambda k, v: create_layer("fullc").set_param(k, v),
        "cxxnet_tpu_torch/io/iterators.py":
            lambda k, v: MNISTIterator().set_param(k, v),
    }


@pytest.mark.parametrize("table", sorted(_setters()))
def test_f2_not_ported_keys_raise_naming_the_key(table):
    reg = port_schema.build_registry()
    keys = sorted(k for k, where in reg.not_ported.items()
                  if any(w.startswith(table + ":") for w in where))
    assert keys
    setter = _setters()[table]
    for key in keys:
        val = _NP_VALUE.get(key, "7")
        with pytest.raises(NotImplementedError, match=key):
            setter(key, val)
