"""Reference-binary checkpoints (`model_format = cxxnet`) in the port,
held to the JAX package on the CPU: the cases of
tests/test_legacy_format.py run against the port's own copy
(cxxnet_tpu_torch/nnet/legacy_format.py) on the net covering every
weighted layer type (grouped conv, batch_norm, prelu, bias, fullc with
and without a bias).

Weights cross from the JAX trainer (`carry`), so every comparison of
files and loaded params is exact: both packages write the same bytes
for the same weights and each loads the other's file bit for bit. The
predictions of a reloaded net are compared within the port (bitwise)."""

import io
import struct

import jax
import numpy as np
import pytest

from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils.config import parse_config_string
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet import legacy_format
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from torch_port_util import carry

NET = """
netconfig=start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  nchannel = 8
  ngroup = 2
layer[1->2] = relu
layer[2->3] = batch_norm:bn1
layer[3->4] = prelu:pr1
layer[4->5] = max_pooling
  kernel_size = 2
  stride = 2
layer[5->6] = flatten
layer[6->7] = fullc:fc1
  nhidden = 12
layer[7->7] = bias:bs1
layer[7->8] = fullc:fc2
  nhidden = 4
  no_bias = 1
layer[8->8] = softmax
netconfig=end
input_shape = 4,8,8
random_type = gaussian
eta = 0.1
batch_size = 4
silent = 1
eval_train = 0
"""


def _jax(cfg=NET, extra=()):
    t = JaxTrainer()
    for k, v in parse_config_string(cfg) + list(extra):
        t.set_param(k, v)
    return t


def _port(cfg=NET, extra=()):
    t = NetTrainer(device="cpu")
    for k, v in parse_config_string(cfg) + list(extra):
        t.set_param(k, v)
    return t


def _trained_pair(steps=3):
    """A JAX trainer trained a few steps (so every tensor, bias and
    batch_norm slope included, is off its init) and a port trainer
    holding the same weights and update counter."""
    jt = _jax(extra=[("model_format", "cxxnet")])
    jt.init_model()
    rng = np.random.RandomState(0)
    for _ in range(steps):
        jt.update(JaxBatch(
            data=rng.randn(4, 4, 8, 8).astype(np.float32),
            label=rng.randint(0, 4, size=(4, 1)).astype(np.float32)))
    pt = _port(extra=[("model_format", "cxxnet")])
    pt.init_model()
    carry(jt, pt)
    pt.epoch = jt.epoch
    return jt, pt


def _save(tr) -> bytes:
    buf = io.BytesIO()
    tr.save_model(buf)
    return buf.getvalue()


def _np(tr, jax_side):
    if jax_side:
        return jax.tree.map(np.asarray, tr.state["params"])
    return {lk: {pn: t.numpy() for pn, t in d.items()}
            for lk, d in tr.state["params"].items()}


def _assert_params_equal(a, b):
    assert sorted(a) == sorted(b)
    for lk in a:
        assert sorted(a[lk]) == sorted(b[lk]), lk
        for pn in a[lk]:
            np.testing.assert_array_equal(a[lk][pn], b[lk][pn])


def test_byte_layout():
    t = _port(extra=[("model_format", "cxxnet")])
    t.init_model()
    raw = _save(t)
    assert struct.unpack_from("<i", raw, 0)[0] == 0       # net_type
    nn, nl = struct.unpack_from("<ii", raw, 4)
    assert nn == t.net_cfg.num_nodes and nl == t.net_cfg.num_layers
    assert struct.unpack_from("<3I", raw, 12) == (4, 8, 8)
    (slen,) = struct.unpack_from("<Q", raw, 4 + 152)       # NetParam: 152 B
    assert raw[4 + 160: 4 + 160 + slen].decode() == "in"
    off = 4 + 152
    for _ in range(nn):
        (n,) = struct.unpack_from("<Q", raw, off)
        off += 8 + n
    assert struct.unpack_from("<i", raw, off)[0] == 10     # conv
    assert legacy_format._LAYER_PARAM_SIZE == 328


def test_files_are_byte_equal_to_jax():
    jt, pt = _trained_pair()
    assert _save(pt) == _save(jt)


def test_each_package_loads_the_others_file():
    jt, pt = _trained_pair()
    # the port loads the JAX package's file
    p2 = _port()
    p2.load_model(io.BytesIO(_save(jt)))
    _assert_params_equal(_np(jt, True), _np(p2, False))
    assert p2.epoch == jt.epoch == 3
    # and the JAX package loads the port's
    j2 = _jax()
    j2.load_model(io.BytesIO(_save(pt)))
    _assert_params_equal(_np(pt, False), _np(j2, True))
    assert j2.epoch == 3
    # a reloaded port net predicts as the one that saved it
    rng = np.random.RandomState(1)
    b = DataBatch(data=rng.randn(4, 4, 8, 8).astype(np.float32),
                  label=np.zeros((4, 1), np.float32))
    np.testing.assert_array_equal(pt.predict_dist(b), p2.predict_dist(b))


def test_roundtrip_after_port_training():
    pt = _port(extra=[("model_format", "cxxnet")])
    pt.init_model()
    rng = np.random.RandomState(2)
    for _ in range(3):
        pt.update(DataBatch(
            data=rng.randn(4, 4, 8, 8).astype(np.float32),
            label=rng.randint(0, 4, size=(4, 1)).astype(np.float32)))
    raw = _save(pt)
    p2 = _port()
    p2.load_model(io.BytesIO(raw))
    _assert_params_equal(_np(pt, False), _np(p2, False))
    assert p2.epoch == pt.epoch == 3
    # saved again, the file is the same bytes
    p2.set_param("model_format", "cxxnet")
    assert _save(p2) == raw


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_structure_mismatch_rejected(pkg):
    jt, pt = _trained_pair(steps=0)
    raw = _save(jt if pkg == "jax" else pt)
    for cfg in (NET.replace("nhidden = 12", "nhidden = 16"),
                NET.replace("layer[1->2] = relu", "layer[1->2] = tanh")):
        other = _port(cfg)
        with pytest.raises(ValueError, match="shape|mismatch"):
            other.load_model(io.BytesIO(raw))


def test_finetune_from_legacy_model():
    jt, _pt = _trained_pair()
    raw = _save(jt)
    t2 = _port(NET.replace("nhidden = 4", "nhidden = 7"))
    t2.init_model()
    t2.copy_model_from(io.BytesIO(raw))
    a, b = _np(jt, True), _np(t2, False)
    for lk, pn in (("cv1", "wmat"), ("cv1", "bias"), ("fc1", "wmat"),
                   ("bn1", "slope"), ("pr1", "slope"), ("bs1", "bias")):
        np.testing.assert_array_equal(a[lk][pn], b[lk][pn])
    assert b["fc2"]["wmat"].shape[0] == 7  # not copied (shape change)


def test_torch_layer_rejected_in_legacy_format():
    cfg = NET.replace(
        "layer[1->2] = relu",
        'layer[1->2] = torch:tc1\n  torch_module = "nn.Conv2d(8,8,1)"')
    errs = []
    for t in (_jax(cfg), _port(cfg)):
        t.set_param("model_format", "cxxnet")
        t.init_model()
        with pytest.raises(ValueError, match="no reference encoding") as ei:
            t.save_model(io.BytesIO())
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


def test_model_format_value_checked_as_in_jax():
    for t in (_jax(), _port()):
        with pytest.raises(ValueError,
                           match="model_format must be native or cxxnet"):
            t.set_param("model_format", "caffe")


def test_native_format_still_roundtrips():
    jt, pt = _trained_pair()
    pt.set_param("model_format", "native")
    raw = _save(pt)
    p2 = _port()
    p2.load_model(io.BytesIO(raw))
    _assert_params_equal(_np(pt, False), _np(p2, False))
