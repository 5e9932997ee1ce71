"""The CLI on imgbin data, port against JAX package, on the CPU in float32:
a narrow conf with the AlexNet layer kinds (conv, relu, max_pooling,
lrn, fullc, softmax; input_shape 3,32,32 cropped from 40 x 40 images)
reads `iter = imgbin` + `iter = threadbuffer` with the host augmenter
(rand_crop, rand_mirror, a mean image created on the first run) and an
eval block. Both CLIs train one round from the same JAX-written
model_in: the mean files are byte-equal, the eval lines agree to
METRIC_TOL and the saved params to STEP_TOL (tests/test_torch_train.py:
rtol 1e-4 / atol 1e-5 for params, rtol 1e-5 / atol 1e-6 for metric
values); then `continue = 1` trains round 2 in both, to the same bars,
and `task = pred` writes the same predictions."""

import os

import numpy as np

from cxxnet_tpu import main as jax_main
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from test_torch_io import write_set
from test_torch_train import STEP_TOL, assert_metric_lines_match

NET = """
netconfig=start
layer[0->1] = conv:c1
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
layer[4->5] = flatten
layer[5->6] = fullc:fc
  nhidden = 3
  init_sigma = 0.05
layer[6->6] = softmax
netconfig=end
input_shape = 3,32,32
batch_size = 8
seed = 5
silent = 1
dev = cpu
eta = 0.05
momentum = 0.9
wd = 0.0001
metric = error
metric = logloss
save_model = 1
num_round = 1
max_round = 1
divideby = 64
"""

BLOCKS = """
data = train
iter = imgbin
  image_list = "{d}/tr.lst"
  image_bin = "{d}/tr.bin"
  image_mean = "{d}/mean_{pkg}.bin"
  rand_crop = 1
  rand_mirror = 1
  shuffle = 1
  use_native = 0
iter = threadbuffer
iter = end
eval = val
iter = imgbin
  image_list = "{d}/va.lst"
  image_bin = "{d}/va.bin"
  image_mean = "{d}/mean_{pkg}.bin"
  use_native = 0
iter = threadbuffer
iter = end
pred = {d}/pred_{pkg}.txt
iter = imgbin
  image_list = "{d}/va.lst"
  image_bin = "{d}/va.bin"
  image_mean = "{d}/mean_{pkg}.bin"
  use_native = 0
iter = end
model_dir = {d}/models_{pkg}
"""


def _params(path):
    tr = NetTrainer(cfg=NET, device="cpu")
    with open(path, "rb") as fi:
        tr.load_model(fi)
    return tr.epoch, convert.params_to_numpy(tr.state["params"],
                                             tr.net.param_shapes())


def _assert_models_match(d, name):
    (ej, pj), (ep, pp) = (_params(f"{d}/models_{pkg}/{name}")
                          for pkg in ("jax", "port"))
    assert ej == ep
    for lk in pj:
        for pn in pj[lk]:
            np.testing.assert_allclose(pp[lk][pn], pj[lk][pn], **STEP_TOL,
                                       err_msg=f"{name} {lk}/{pn}")


def _lines(err):
    return [ln for ln in err.splitlines() if ln.startswith(("[", "\t"))]


def test_cli_imgbin_train_continue_pred_match_jax(tmp_path, capsys):
    d = str(tmp_path)
    write_set(d, "tr", 40, 40, 21)
    write_set(d, "va", 16, 40, 22)
    confs = {}
    for pkg in ("jax", "port"):
        confs[pkg] = os.path.join(d, f"{pkg}.conf")
        with open(confs[pkg], "w") as f:
            f.write(NET + BLOCKS.format(d=d, pkg=pkg))
    init = os.path.join(d, "0000.model")
    seed_tr = JaxTrainer(cfg=NET)
    seed_tr.init_model()
    with open(init, "wb") as fo:
        seed_tr.save_model(fo)
    out = {}
    for pkg, mod in (("jax", jax_main), ("port", port_main)):
        capsys.readouterr()
        assert mod.main([confs[pkg], f"model_in={init}"]) == 0
        out[pkg] = _lines(capsys.readouterr().err)
    with open(f"{d}/mean_jax.bin", "rb") as a, \
            open(f"{d}/mean_port.bin", "rb") as b:
        assert a.read() == b.read()
    assert len(out["port"]) == len(out["jax"]) == 2  # eval line, round 1
    assert out["port"][1].startswith("[1]\ttrain-error:")
    for g, w in zip(out["port"], out["jax"]):
        assert g.split("\t")[0] == w.split("\t")[0]
        assert_metric_lines_match(g, w)
    _assert_models_match(d, "0001.model")

    for pkg, mod in (("jax", jax_main), ("port", port_main)):
        capsys.readouterr()
        assert mod.main([confs[pkg], "continue=1", "num_round=2"]) == 0
        out[pkg] = _lines(capsys.readouterr().err)
    assert out["port"][-1].startswith("[2]\ttrain-error:")
    for g, w in zip(out["port"], out["jax"]):
        assert_metric_lines_match(g, w)
    _assert_models_match(d, "0002.model")

    for pkg, mod in (("jax", jax_main), ("port", port_main)):
        assert mod.main([confs[pkg], "task=pred",
                         f"model_in={d}/models_{pkg}/0002.model"]) == 0
    with open(f"{d}/pred_jax.txt") as a, open(f"{d}/pred_port.txt") as b:
        want, got = a.read().split(), b.read().split()
    assert len(got) == 16 and got == want
