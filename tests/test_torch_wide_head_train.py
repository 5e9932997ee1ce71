"""wide_head trained by both packages on the CPU: the port follows the
JAX trainer step by step, and both diverge at the same step.

wide_head (chip_smoke.py phase 8f) is examples/LongSeq/seq_mnist.conf
with its block widened to 1,024 features, two heads of 512 in the
non-causal attention layer and in each block of the causal
transformer_stack. With the file's own updater (sgd, eta 0.1, momentum
0.9) it does not train: the cross-entropy rises from the first step and
the weights overflow within a few. This file holds the port's trajectory
against the JAX trainer's up to that point, from the JAX init carried
by cxxnet_tpu_torch/convert.py, so that phase 8f, which runs the same
steps on the card against the port on the CPU, tells a kernel fault
from the configuration's own divergence. Cut to batch 8 in float32;
depth, widths and updater are the file's own.
"""

import os

import jax
import numpy as np

from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu_torch import convert
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer

SEQ_CONF = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "LongSeq", "seq_mnist.conf")
WIDE_HEAD_NET = """netconfig=start
layer[0->1] = seq_fullc:wide
  nhidden = 1024
layer[1->2] = pos_embed:pe
  init_sigma = 0.02
layer[2->3,4] = split
layer[3->5] = layernorm:ln1
layer[5->6] = attention:att1
  nhead = 2
  causal = 0
layer[6,4->7] = add
layer[7->8] = transformer_stack:ts1
  nlayer = 2
  nhead = 2
  nhidden = 4096
  causal = 1
layer[8->9] = flatten
layer[9->10] = fullc:head
  nhidden = 10
  init_sigma = 0.01
layer[10->10] = softmax
netconfig=end"""
ROWS, STEPS = 8, 6
# every param after each of the first two steps (later steps amplify
# rounding as the weights grow) and the cross-entropy at each finite
# step
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
CE_RTOL = 1e-3


def wide_head_cfg() -> str:
    """seq_mnist.conf's net and settings with WIDE_HEAD_NET as its
    netconfig (no iterators), at batch ROWS in float32 on the CPU."""
    with open(SEQ_CONF) as f:
        text = f.read()
    rest = text.split("netconfig=start", 1)[1].split("netconfig=end", 1)[1]
    cfg = WIDE_HEAD_NET + rest
    for old, new in (("dev = tpu", "dev = cpu"),
                     ("batch_size = 100", f"batch_size = {ROWS}"),
                     ("dtype = bfloat16", "dtype = float32")):
        assert old in cfg, old
        cfg = cfg.replace(old, new)
    return cfg + "\nsilent = 1\nseed = 7\n"


def cross_entropy(probs: np.ndarray, labels: np.ndarray) -> float:
    picked = probs[np.arange(len(labels)), labels[:, 0].astype(int)]
    return float(-np.mean(np.log(np.maximum(picked, 1e-30))))


def test_wide_head_diverges_alike_in_both_packages():
    """The same batch STEPS times: after each step the two packages'
    predict_dist is finite on both or on neither, the cross-entropy
    agrees while it is finite, every param agrees after steps 1 and 2;
    the cross-entropy rises at the first step and both go non-finite
    at one step within STEPS."""
    cfg = wide_head_cfg()
    rng = np.random.RandomState(27)
    images = rng.rand(ROWS, 1, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, size=(ROWS, 1)).astype(np.float32)
    jt = JaxTrainer(cfg=cfg)
    jt.init_model()
    pt = NetTrainer(cfg=cfg, device="cpu")
    pt.init_model()
    convert.train_state_from_numpy(
        pt, {"params": jax.device_get(jt.state["params"]),
             "ustate": jax.device_get(jt.state["ustate"]),
             "epoch": jt.epoch})

    def ces():
        jp = np.asarray(jt.predict_dist(JaxBatch(data=images, label=labels)))
        pp = np.asarray(pt.predict_dist(DataBatch(data=images,
                                                  label=labels)))
        return jp, pp

    jp, pp = ces()
    history = [cross_entropy(jp, labels)]
    np.testing.assert_allclose(cross_entropy(pp, labels), history[0],
                               rtol=CE_RTOL)
    diverged = None
    for step in range(1, STEPS + 1):
        jt.update(JaxBatch(data=images, label=labels))
        pt.update(DataBatch(data=images, label=labels))
        jp, pp = ces()
        finite = bool(np.isfinite(jp).all())
        assert bool(np.isfinite(pp).all()) == finite, (
            f"step {step}: JAX finite {finite}, the port not")
        if not finite:
            diverged = step
            break
        history.append(cross_entropy(jp, labels))
        np.testing.assert_allclose(cross_entropy(pp, labels), history[-1],
                                   rtol=CE_RTOL, err_msg=f"step {step}")
        if step <= 2:
            jpar = jax.device_get(jt.state["params"])
            for k, d in jpar.items():
                for n, a in d.items():
                    np.testing.assert_allclose(
                        pt.state["params"][k][n].detach().numpy(),
                        np.asarray(a), **PARAM_TOL,
                        err_msg=f"step {step}: {k}/{n}")
    assert diverged is not None, f"no divergence in {STEPS} steps: {history}"
    assert history[1] > 2 * history[0], history
