"""Shared pieces of the port's tests (tests/test_torch_*.py): the card
fixture, a narrow AlexNet-shaped conf, and the JAX -> port weight carry
(which imports jax only when called: the card's tests run where no jax
is installed)."""

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch import convert

CUDA_SKIP = ("needs an NVIDIA card; run on the card with: python -m "
             "pytest tests/test_torch_cuda.py -m cuda --noconftest -q")


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import or
    collection time, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip(CUDA_SKIP)
    return torch.device("cuda:0")


# AlexNet's layer sequence (examples/ImageNet/AlexNet.conf) cut to a
# 3x35x35 input, 8-16 channels and 32 hidden units: grouped conv2/4/5,
# both lrn layers, the dropout self-loops and the softmax head; the fc
# layers draw wide gaussians so that the predicted class depends on the
# input
NARROW_ALEXNET = """
netconfig=start
layer[0->1] = conv:conv1
  kernel_size = 5
  stride = 2
  nchannel = 8
layer[1->2] = relu
layer[2->3] = max_pooling
  kernel_size = 3
  stride = 2
layer[3->4] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[4->5] = conv:conv2
  ngroup = 2
  nchannel = 16
  kernel_size = 3
  pad = 1
layer[5->6] = relu
layer[6->7] = max_pooling
  kernel_size = 3
  stride = 2
layer[7->8] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[8->9] = conv:conv3
  nchannel = 16
  kernel_size = 3
  pad = 1
layer[9->10] = relu
layer[10->11] = conv:conv4
  nchannel = 16
  ngroup = 2
  kernel_size = 3
  pad = 1
layer[11->12] = relu
layer[12->13] = conv:conv5
  nchannel = 8
  ngroup = 2
  kernel_size = 3
  pad = 1
  init_bias = 0.1
layer[13->14] = relu
layer[14->15] = max_pooling
  kernel_size = 3
  stride = 2
layer[15->16] = flatten
layer[16->17] = fullc:fc6
  random_type = gaussian
  init_sigma = 0.3
  nhidden = 32
layer[17->18] = relu
layer[18->18] = dropout
  threshold = 0.5
layer[18->19] = fullc:fc7
  random_type = gaussian
  init_sigma = 0.3
  nhidden = 32
layer[19->20] = relu
layer[20->20] = dropout
  threshold = 0.5
layer[20->21] = fullc:fc8
  random_type = gaussian
  init_sigma = 0.3
  nhidden = 10
layer[21->21] = softmax
netconfig=end
input_shape = 3,35,35
batch_size = 8
random_type = xavier
silent = 1
seed = 3
dev = cpu
"""


def carry(jax_trainer, port_trainer):
    """Copy the JAX trainer's params into the port trainer (numpy in
    between, shapes checked against the port's network)."""
    import jax
    port_trainer._set_params(convert.params_from_numpy(
        jax.device_get(jax_trainer.state["params"]),
        port_trainer.net.param_shapes(), port_trainer.device))


def numpy_keep(trainer, seed):
    """Dropout masks for every dropout layer of `trainer`'s net, drawn
    with numpy ({layer index: boolean array of the layer's input
    shape}) - what `update(keep=...)` injects so that two devices train
    with the same masks."""
    rng = np.random.RandomState(seed)
    out = {}
    for idx, info in enumerate(trainer.net_cfg.layers):
        if info.type_name == "dropout":
            shape = trainer.net.node_shapes[info.nindex_in[0]]
            pkeep = 1.0 - trainer.net.layer_objs[idx].threshold
            out[idx] = rng.rand(*shape) < pkeep
    return out


# the extra-input net of tests/test_trainer.py:505-523: node in_1 (one
# extra input of 1x1x4) concatenated onto the data; the label depends
# only on the extra input, so a net that is not fed in_1 cannot learn
EXTRA_NET = """
extra_data_num = 1
extra_data_shape[0] = 1,1,4
netconfig=start
layer[in,in_1->2] = concat
layer[2->3] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[3->4] = relu
layer[4->5] = fullc:fc2
  nhidden = 2
  init_sigma = 0.1
layer[5->5] = softmax
netconfig=end
input_shape = 1,1,4
batch_size = 8
eta = 0.2
momentum = 0.9
metric = error
silent = 1
"""


def extra_batches(n, seed, rows=8):
    """`n` (data, extra, label) triples of EXTRA_NET: label = whether
    the extra input's entries sum above 0."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(rows, 1, 1, 4).astype(np.float32)
        e = rng.randn(rows, 1, 1, 4).astype(np.float32)
        y = (e.reshape(rows, 4).sum(1) > 0).astype(np.float32)
        out.append((x, e, y.reshape(rows, 1)))
    return out


def csr_of(data, cls, **kw):
    """The sparse CSR view of dense rows (every nonzero entry, row-major)
    as a batch of `cls` (either package's DataBatch) with `data` None;
    `kw` fills the other fields."""
    flat = np.asarray(data, np.float32).reshape(len(data), -1)
    nz = flat != 0
    return cls(sparse_row_ptr=np.concatenate(
                   [[0], np.cumsum(nz.sum(1))]).astype(np.int64),
               sparse_findex=np.nonzero(nz)[1].astype(np.uint32),
               sparse_fvalue=flat[nz], **kw)
