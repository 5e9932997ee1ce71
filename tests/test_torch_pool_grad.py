"""The port's max-pool backward (cxxnet_tpu_torch/ops/pooling.py) against
the JAX package's: `grad_mode = ties` - every position equal to the
window max gets the window's full gradient - against jax.vjp of
cxxnet_tpu.ops.pooling.pool2d(grad_mode="ties") on inputs full of exact
ties (relu'd, integer-valued), padded pools, truncated boundary windows,
rectangular kernels and stride > kernel; `grad_mode = winner` against
JAX's winner rule on tie-free inputs (the two single-winner rules agree
only where the max is unique); sum/avg pooling's gradients.

Tolerance: the ties backward adds the same float32 gradients in another
order (at most ceil(k/s)^2 terms per position), so rtol 1e-6 /
atol 1e-6; the forward values are identical (max is exact)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu.ops import pooling as jax_pool
from cxxnet_tpu_torch.ops import pooling as port_pool
from cxxnet_tpu_torch.ops.routing import Routing

TOL = dict(rtol=1e-6, atol=1e-6)

# (shape, ky, kx, stride, pad_y, pad_x): AlexNet's 3x3 s2 pools, a
# truncated boundary window (the ceil-flavoured output size), padding,
# rectangular kernels, stride > kernel, stride 1
GEOMS = [
    ((2, 3, 13, 13), 3, 3, 2, 0, 0),
    ((2, 3, 12, 12), 3, 3, 2, 0, 0),
    ((1, 2, 10, 9), 3, 3, 2, 1, 1),
    ((2, 2, 11, 8), 3, 2, 2, 0, 0),
    ((1, 3, 9, 12), 2, 4, 3, 1, 0),
    ((2, 2, 10, 10), 2, 2, 3, 0, 0),
    ((1, 2, 7, 7), 3, 3, 1, 1, 1),
    ((1, 1, 4, 4), 2, 2, 2, 0, 0),
]


def _tied(shape, seed):
    """relu of small integers: most windows hold several exact maxima
    (zeros after relu, or repeated integers)."""
    rng = np.random.RandomState(seed)
    return np.maximum(rng.randint(-3, 4, shape), 0).astype(np.float32)


def _tie_free(shape, seed):
    """A permutation of distinct values: every window max is unique."""
    n = int(np.prod(shape))
    return (np.random.RandomState(seed).permutation(n).reshape(shape)
            .astype(np.float32) * 0.5 - n / 4)


def _jax_vjp(x, g, mode, ky, kx, s, py, px, grad_mode="ties"):
    out, vjp = jax.vjp(lambda a: jax_pool.pool2d(
        a, mode, ky, kx, s, py, px, grad_mode), jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def _port_vjp(x, g, mode, ky, kx, s, py, px, grad_mode="ties"):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port_pool.pool2d(xt, mode, ky, kx, s, py, px, grad_mode)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), xt.grad.numpy()


def _upstream(x, mode, ky, kx, s, py, px, seed=1):
    shape = jax_pool.pool2d(jnp.asarray(x), mode, ky, kx, s, py, px).shape
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _gid(g):
    return "x".join(map(str, g[1:])) + f"-{g[0][2]}x{g[0][3]}"


@pytest.mark.parametrize("geom", GEOMS, ids=_gid)
def test_ties_backward_matches_jax(geom):
    shape, ky, kx, s, py, px = geom
    x = _tied(shape, seed=0)
    g = _upstream(x, "max", ky, kx, s, py, px)
    want_out, want = _jax_vjp(x, g, "max", ky, kx, s, py, px)
    got_out, got = _port_vjp(x, g, "max", ky, kx, s, py, px)
    np.testing.assert_array_equal(got_out, want_out)
    np.testing.assert_allclose(got, want, **TOL)
    # the duplicated gradient: more positions get a share than under
    # the single-winner rule
    _, win = _port_vjp(x, g, "max", ky, kx, s, py, px, "winner")
    assert np.count_nonzero(got) > np.count_nonzero(win)


def test_all_zero_window_gives_every_position_the_gradient():
    """The post-relu case: a window of identical values passes its
    full gradient to every position."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    g = np.arange(1, 5, dtype=np.float32).reshape(1, 1, 2, 2)
    _, got = _port_vjp(x, g, "max", 2, 2, 2, 0, 0)
    want = np.kron(g[0, 0], np.ones((2, 2), np.float32))
    np.testing.assert_array_equal(got[0, 0], want)


@pytest.mark.parametrize("geom", GEOMS[:6], ids=_gid)
def test_winner_backward_matches_jax_on_tie_free_inputs(geom):
    shape, ky, kx, s, py, px = geom
    x = _tie_free(shape, seed=2)
    g = _upstream(x, "max", ky, kx, s, py, px, seed=3)
    want_out, want = _jax_vjp(x, g, "max", ky, kx, s, py, px, "winner")
    got_out, got = _port_vjp(x, g, "max", ky, kx, s, py, px, "winner")
    np.testing.assert_array_equal(got_out, want_out)
    np.testing.assert_allclose(got, want, **TOL)
    # with unique maxima both rules agree
    _, ties = _port_vjp(x, g, "max", ky, kx, s, py, px, "ties")
    np.testing.assert_allclose(ties, got, **TOL)


@pytest.mark.parametrize("mode", ["sum", "avg"])
@pytest.mark.parametrize("geom", [GEOMS[0], GEOMS[2], GEOMS[4]],
                         ids=["3x3s2", "pad1", "rect-s3"])
def test_sum_avg_backward_matches_jax(mode, geom):
    shape, ky, kx, s, py, px = geom
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    g = _upstream(x, mode, ky, kx, s, py, px, seed=5)
    want_out, want = _jax_vjp(x, g, mode, ky, kx, s, py, px)
    got_out, got = _port_vjp(x, g, mode, ky, kx, s, py, px)
    np.testing.assert_allclose(got_out, want_out, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_relu_max_pooling_layer_backward_matches_jax():
    """The layer path: relu_max_pooling composes relu with the ties
    Function; an input of exactly 0 gets half the gradient through the
    relu in both packages (jnp.maximum's rule)."""
    from cxxnet_tpu.layers import create_layer as jax_layer
    from cxxnet_tpu_torch.layers import create_layer as port_layer
    x = np.random.RandomState(6).randint(-2, 3, (2, 3, 9, 9)).astype(
        np.float32)
    lays = []
    for make in (jax_layer, port_layer):
        lay = make("relu_max_pooling")
        lay.set_param("kernel_size", "3")
        lay.set_param("stride", "2")
        lay.infer_shapes([x.shape])
        lays.append(lay)
    out, vjp = jax.vjp(lambda a: lays[0].apply({}, [a], train=True)[0],
                       jnp.asarray(x))
    g = np.random.RandomState(7).randn(*out.shape).astype(np.float32)
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    got_out = lays[1]({}, [xt])[0]
    got_out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got_out.detach().numpy(), np.asarray(out))
    np.testing.assert_allclose(xt.grad.numpy(), want, **TOL)


def test_forward_without_autograd_is_the_native_pool():
    """Serving (no autograd) takes the one 2-D max_pool2d forward; it
    equals the separable forward the ties Function runs."""
    x = torch.from_numpy(_tied((2, 3, 13, 13), seed=8))
    with torch.no_grad():
        plain = port_pool.pool2d(x, "max", 3, 3, 2)
    sep = port_pool.pool2d(x.clone().requires_grad_(True), "max", 3, 3, 2)
    assert torch.equal(plain, sep.detach())


def test_bad_grad_mode_raises():
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(ValueError, match="unknown grad_mode"):
        port_pool.pool2d(x, "max", 2, 2, 2, grad_mode="first")
    with pytest.raises(ValueError, match="only exists for max"):
        port_pool.pool2d(x, "avg", 2, 2, 2, grad_mode="winner")


@pytest.mark.parametrize("geom", GEOMS, ids=_gid)
def test_tie_routing_replays_another_legs_decisions(geom):
    """Routing (ops/routing.py) over the ties backward: a leg that
    replays another leg's recorded tie decisions routes its gradient
    exactly as that leg did. Leg A pools a relu'd integer input full of
    exact ties; leg B the same input with every other value raised by
    one float32 ulp, which breaks ties the way two summation orders do.
    B's own backward differs from A's; with A's decisions replayed B's
    input gradient equals A's bit for bit, and `differ` counts exactly
    the covered decisions B would have made the other way. Replaying
    into another graph raises."""
    shape, ky, kx, s, py, px = geom
    xa = _tied(shape, seed=0)
    bump = np.arange(xa.size).reshape(shape) % 2 == 0
    xb = np.where(bump, np.nextafter(xa, np.float32(np.inf)), xa)
    g = _upstream(xa, "max", ky, kx, s, py, px)
    with Routing() as rec_a:
        _, ga = _port_vjp(xa, g, "max", ky, kx, s, py, px)
    with Routing() as rec_b:
        _, gb_own = _port_vjp(xb, g, "max", ky, kx, s, py, px)
    with Routing(replay=rec_a) as replay:
        _, gb = _port_vjp(xb, g, "max", ky, kx, s, py, px)
    assert np.array_equal(gb, ga)
    flipped = sum(int((rec_a.decisions[k] != rec_b.decisions[k]).sum())
                  for k in rec_a.decisions)
    assert replay.differ == {"max-pool": flipped, "relu": 0}
    assert flipped > 0 and not np.array_equal(gb_own, ga)
    other = (shape[0], shape[1], shape[2] + 1, shape[3])
    with pytest.raises(ValueError, match="not the same graph"):
        with Routing(replay=rec_a):
            _port_vjp(np.zeros(other, np.float32),
                      _upstream(np.zeros(other, np.float32), "max", ky, kx,
                                s, py, px), "max", ky, kx, s, py, px)


def test_relu_routing_replays_another_legs_gates():
    """Routing over relu (ops/nn.py): recording changes nothing (the
    values and gradients of max(x, 0), half the gradient at exactly 0);
    a leg whose inputs sit on the other side of zero takes the recorded
    gates - its input gradient is the recording leg's, bit for bit - and
    `differ` counts the gates it would have set the other way."""
    from cxxnet_tpu_torch.ops import nn as nn_ops
    rng = np.random.RandomState(3)
    xa = rng.randn(4, 5, 6).astype(np.float32)
    xa[0, 0, :3] = 0.0
    xb = xa.copy()
    xb[1, :, 0] = -xb[1, :, 0]  # 5 gates flip
    g = torch.from_numpy(rng.randn(4, 5, 6).astype(np.float32))

    def leg(x, routing):
        xt = torch.from_numpy(x).requires_grad_(True)
        with routing:
            out = nn_ops.relu(xt)
        out.backward(g)
        return out.detach().numpy(), xt.grad.numpy()

    plain = torch.from_numpy(xa).requires_grad_(True)
    torch.maximum(plain, plain.new_zeros(())).backward(g)
    rec = Routing()
    out_a, ga = leg(xa, rec)
    assert np.array_equal(out_a, np.maximum(xa, 0))
    assert np.array_equal(ga, plain.grad.numpy())
    assert np.array_equal(ga[0, 0, :3], 0.5 * g.numpy()[0, 0, :3])
    replay = Routing(replay=rec)
    out_b, gb = leg(xb, replay)
    assert np.array_equal(gb, ga)
    assert replay.differ == {"max-pool": 0, "relu": 5}
    gate = rec.decisions[("relu", 0)].numpy()
    assert np.array_equal(out_b, xb * (gate * np.float32(0.5)))
