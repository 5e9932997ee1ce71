"""The port's updaters (cxxnet_tpu_torch/updater) against the JAX
package's: the same config pairs build both, the same numpy weight and
20 numpy gradients go through `create_updater(...).apply` epoch by
epoch, and weight and state are compared after every epoch.

Tolerance: rtol 1e-6 / atol 1e-6 (float32 on both sides, the same
expressions in the same order; XLA may contract a multiply-add that
torch rounds twice, and its float32 pow (the polydecay schedule) differs
from the C library's by an ulp, so the weights - |w| up to ~4 after 20
epochs - drift apart by an ulp or two: atol is two float32 ulps there,
for entries that pass near zero). Adam alone: rtol 1e-5. Its bias
correction 1 - (1-decay)^t cancels, and XLA's float32 pow differs from
the C library's by an ulp at some t (t = 9 and 20 for decay 0.001),
which the cancellation turns into up to 7e-6 relative in the step
size."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cxxnet_tpu.updater import UpdaterParam as JaxParam
from cxxnet_tpu.updater import create_updater as jax_create
from cxxnet_tpu_torch.updater import UpdaterParam, create_updater

TOL = dict(rtol=1e-6, atol=1e-6)
ADAM_TOL = dict(rtol=1e-5, atol=1e-6)
EPOCHS = 20

CASES = {
    "sgd_constant": ("sgd", [("lr", "0.1"), ("momentum", "0.9"),
                             ("wd", "0.01")]),
    "sgd_clip_nan": ("sgd", [("lr", "0.05"), ("clip_gradient", "0.3"),
                             ("wd", "0.001")]),
    "sgd_expdecay": ("sgd", [("lr", "0.2"), ("lr:schedule", "expdecay"),
                             ("lr:gamma", "0.5"), ("lr:step", "3")]),
    "sgd_polydecay": ("sgd", [("eta", "0.2"), ("lr:schedule", "polydecay"),
                              ("lr:gamma", "0.3"), ("lr:alpha", "0.7"),
                              ("lr:step", "2")]),
    "sgd_factor_min": ("sgd", [("lr", "0.1"), ("lr:schedule", "factor"),
                               ("lr:factor", "0.1"), ("lr:step", "4"),
                               ("lr:minimum_lr", "0.002")]),
    "sgd_start_epoch": ("sgd", [("lr", "0.1"), ("lr:schedule", "factor"),
                                ("lr:step", "1"), ("lr:start_epoch", "5")]),
    "sgd_momentum_schedule": ("sgd", [
        ("lr", "0.05"), ("momentum", "0.0"), ("momentum_schedule", "1"),
        ("base_momentum", "0.5"), ("final_momentum", "0.95"),
        ("saturation_epoch", "10")]),
    "nag": ("nag", [("lr", "0.05"), ("momentum", "0.8"), ("wd", "0.02")]),
    "nag_expdecay": ("nag", [("lr", "0.1"), ("lr:schedule", "expdecay"),
                             ("lr:gamma", "0.1"), ("lr:step", "7")]),
    "adam": ("adam", [("lr", "0.01")]),
    "adam_wd_quirk": ("adam", [("lr", "0.02"), ("wd", "0.05")]),
}


def _grads(shape, seed, nan=False):
    rng = np.random.RandomState(seed)
    gs = [(rng.randn(*shape) * 2.0).astype(np.float32)
          for _ in range(EPOCHS)]
    if nan:
        for g in gs[::3]:
            g[0, ::2] = np.nan
    return gs


def _run_both(kind, pairs, tag="wmat", kwargs=None, nan=False):
    kwargs = kwargs or {}
    jp, pp = JaxParam(tag), UpdaterParam(tag)
    for k, v in pairs:
        jp.set_param(k, v)
        pp.set_param(k, v)
    ju = jax_create(kind, jp, **kwargs)
    pu = create_updater(kind, pp, **kwargs)
    tol = ADAM_TOL if kind == "adam" else TOL
    w0 = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    jw = jnp.asarray(w0)
    jstate = ju.init_state(jw)
    pw = torch.from_numpy(w0.copy())
    pstate = pu.init_state(pw)
    for epoch, g in enumerate(_grads(w0.shape, 2, nan)):
        jstate, jw = ju.apply(jstate, jw, jnp.asarray(g), epoch)
        pu.apply(pstate, pw, torch.from_numpy(g), epoch)
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), **tol)
        assert sorted(pstate) == sorted(jstate)
        for name in pstate:
            np.testing.assert_allclose(pstate[name].numpy(),
                                       np.asarray(jstate[name]), **tol)
    assert np.all(np.isfinite(pw.numpy()))
    return pw.numpy(), w0


@pytest.mark.parametrize("case", sorted(CASES))
def test_updater_matches_jax_over_20_epochs(case):
    kind, pairs = CASES[case]
    w, w0 = _run_both(kind, pairs, nan=case == "sgd_clip_nan")
    assert not np.allclose(w, w0)


@pytest.mark.parametrize("beta1,beta2", [("0.2", "0.01"), ("0.05", "0.1")])
def test_adam_betas_match_jax(beta1, beta2):
    """The trainer maps `beta1`/`beta2` to Adam's decay1/decay2
    (trainer.py:627-630); the updater takes them as-is."""
    _run_both("adam", [("lr", "0.01")],
              kwargs=dict(decay1=float(beta1), decay2=float(beta2)))


@pytest.mark.parametrize("tag,lr,wd", [("wmat", 0.3, 0.01),
                                        ("bias", 0.02, 0.0)])
def test_tag_scoping(tag, lr, wd):
    """`wmat:lr` reaches only the wmat updater, `bias:lr` only bias."""
    pairs = [("lr", "0.1"), ("wd", "0.5"), ("wmat:lr", "0.3"),
             ("wmat:wd", "0.01"), ("bias:lr", "0.02"), ("bias:wd", "0")]
    p = UpdaterParam(tag)
    for k, v in pairs:
        p.set_param(k, v)
    assert (p.base_lr, p.wd) == (lr, wd)
    _run_both("sgd", pairs, tag=tag)


@pytest.mark.parametrize("epoch", [0, 1, 3, 9, 10, 57])
@pytest.mark.parametrize("case", ["sgd_expdecay", "sgd_polydecay",
                                  "sgd_factor_min", "sgd_start_epoch",
                                  "sgd_momentum_schedule"])
def test_schedule_matches_jax(case, epoch):
    _, pairs = CASES[case]
    jp, pp = JaxParam(), UpdaterParam()
    for k, v in pairs:
        jp.set_param(k, v)
        pp.set_param(k, v)
    jlr, jmom = jp.schedule(epoch)
    lr, mom = pp.schedule(epoch)
    np.testing.assert_allclose(lr, float(jlr), rtol=1e-7)
    np.testing.assert_allclose(mom, float(jmom), rtol=1e-7)


def test_unknown_updater_raises():
    with pytest.raises(ValueError, match="unknown updater type"):
        create_updater("rmsprop", UpdaterParam())
