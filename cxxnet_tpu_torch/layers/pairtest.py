"""PairTest: differential testing of layer implementations, and
conv_im2col (counterpart of cxxnet_tpu/layers/pairtest.py; reference
pairtest_layer-inl.hpp:15-203, type encoding layer.h:314-315,354-358).

`layer[...] = pairtest-A-B` runs a master implementation A and a slave
implementation B of one op on the same inputs and params and forwards
the MASTER's outputs. With `pairtest_print = 1` each forward prints the
largest relative error of every output whose error passes
`pairtest_tol` (default 1e-5, the reference's threshold); the errors of
the last forward stay in `last_errors`. `run_pairtest` is the full
check: forward, input gradients and param gradients through autograd.

`conv_im2col` is a convolution computed the reference's way - an
explicit im2col (F.unfold) and one matrix product per group
(convolution_layer-inl.hpp:70-106) - the trusted slave of
`pairtest-conv-conv_im2col`.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from cxxnet_tpu_torch.layers.base import (
    Layer, Params, Shape, create_layer, register_layer)
from cxxnet_tpu_torch.layers.common import ConvolutionLayer


@register_layer
class ConvIm2ColLayer(ConvolutionLayer):
    """Grouped conv through explicit im2col + GEMM; numerically the op
    of `conv` (no int8 route and no fused activation: the graph passes
    stamp only `conv`)."""

    type_name = "conv_im2col"

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        p = self.param
        x = inputs[0]
        w = params["wmat"]
        ky, kx, g = p.kernel_height, p.kernel_width, p.num_group
        b, c = x.shape[:2]
        ipg = c // g
        # (b, c*ky*kx, oh*ow), channel-major rows: c outer, then ky, kx
        col = F.unfold(x, (ky, kx), padding=(p.pad_y, p.pad_x),
                       stride=p.stride)
        oh = (x.shape[2] + 2 * p.pad_y - ky) // p.stride + 1
        ow = (x.shape[3] + 2 * p.pad_x - kx) // p.stride + 1
        col = col.reshape(b, g, ipg * ky * kx, oh * ow)
        wg = w.reshape(g, p.num_channel // g, ipg * ky * kx)
        out = torch.einsum("goi,bgix->bgox", wg, col)
        out = out.reshape(b, p.num_channel, oh, ow)
        if "bias" in params:
            out = out + params["bias"][None, :, None, None]
        return [out]


def max_rel_err(a: torch.Tensor, b: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """max|a - b| / (max|b| + eps): the reference's Cmp relative error
    (pairtest_layer-inl.hpp:160-180) normalised by b's scale, which
    near-zero elements cannot blow up."""
    a, b = a.float(), b.float()
    return (a - b).abs().max() / (b.abs().max() + eps)


class PairTestLayer(Layer):
    """Master and slave on the same inputs and params; forwards the
    master's outputs (pairtest_layer-inl.hpp:61-78). `master:key` /
    `slave:key` route a key to one side, an unprefixed key goes to
    both."""

    type_name = "pairtest"

    def __init__(self, master_type: str, slave_type: str, name: str = ""):
        super().__init__(name)
        self.master = create_layer(master_type, name)
        self.slave = create_layer(slave_type, name)
        self.tol = 1e-5
        self.print_divergence = False
        self.last_errors: List[float] = []
        self.uses_rng = self.master.uses_rng or self.slave.uses_rng

    def set_param(self, name: str, val: str) -> None:
        if name == "pairtest_tol":
            self.tol = float(val)
            return
        if name == "pairtest_print":
            self.print_divergence = bool(int(val))
            return
        if name.startswith("master:"):
            self.master.set_param(name[len("master:"):], val)
        elif name.startswith("slave:"):
            self.slave.set_param(name[len("slave:"):], val)
        else:
            self.master.set_param(name, val)
            self.slave.set_param(name, val)
        self.uses_rng = self.master.uses_rng or self.slave.uses_rng

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        m = self.master.infer_shapes(list(in_shapes))
        s = self.slave.infer_shapes(list(in_shapes))
        if [tuple(x) for x in m] != [tuple(x) for x in s]:
            raise ValueError(
                f"pairtest: master/slave shape mismatch {m} vs {s}")
        return m

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        return self.master.param_shapes(list(in_shapes))

    def init_params(self, gen, in_shapes: List[Shape]) -> Params:
        # one param set, mirrored into both (SyncWeight,
        # pairtest_layer-inl.hpp:84-101)
        state = gen.get_state()
        mp = self.master.init_params(gen, list(in_shapes))
        gen.set_state(state)
        sp = self.slave.init_params(gen, list(in_shapes))
        if ({k: tuple(v.shape) for k, v in mp.items()}
                != {k: tuple(v.shape) for k, v in sp.items()}):
            raise ValueError("pairtest: master/slave param mismatch")
        return mp

    def param_tags(self) -> Dict[str, str]:
        return self.master.param_tags()

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        # the slave draws what the master drew: one generator state
        state = gen.get_state() if gen is not None else None
        m_out = self.master(params, inputs, train=train, gen=gen, keep=keep)
        if state is not None:
            gen.set_state(state)
        s_out = self.slave(params, inputs, train=train, gen=gen, keep=keep)
        if self.print_divergence:
            with torch.no_grad():
                self.last_errors = [float(max_rel_err(a, b))
                                    for a, b in zip(m_out, s_out)]
            for i, err in enumerate(self.last_errors):
                if err > self.tol:
                    print(f"PairTest[{self.name}] out[{i}] max rel err "
                          f"{err}", file=sys.stdout, flush=True)
        return m_out


def run_pairtest(layer: PairTestLayer, in_shapes: List[Shape],
                 seed: int = 0, train: bool = True,
                 device: Optional[torch.device] = None) -> Dict[str, float]:
    """Forward, input-gradient and param-gradient max relative errors
    between master and slave (the check set of
    pairtest_layer-inl.hpp:61-126): {"out[i]", "in_grad[i]",
    "wgrad/<name>": err}. Params and inputs come from `seed` (float32,
    on `device`, the CPU by default); the scalar differentiated is
    sum_i (i + 1) * sum(out[i])."""
    device = torch.device(device or "cpu")
    gen = torch.Generator().manual_seed(seed)
    layer.infer_shapes(list(in_shapes))
    params = {k: v.to(device) for k, v in
              layer.init_params(gen, list(in_shapes)).items()}
    xs = [torch.randn(tuple(s), generator=gen).to(device)
          for s in in_shapes]
    report: Dict[str, float] = {}
    results = []
    for impl in (layer.master, layer.slave):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        x = [t.clone().requires_grad_(True) for t in xs]
        rgen = torch.Generator(device=device).manual_seed(seed + 1)
        with torch.enable_grad():
            outs = impl(p, x, train=train, gen=rgen)
            total = sum((o.float() * (i + 1.0)).sum()
                        for i, o in enumerate(outs))
            grads = torch.autograd.grad(total, x + list(p.values()),
                                        allow_unused=True)
        results.append((outs, grads, list(p)))
    (m_out, m_g, names), (s_out, s_g, _) = results
    for i, (a, b) in enumerate(zip(m_out, s_out)):
        report[f"out[{i}]"] = float(max_rel_err(a.detach(), b.detach()))
    keys = [f"in_grad[{i}]" for i in range(len(xs))] + [
        f"wgrad/{n}" for n in names]
    refs = xs + [params[n] for n in names]
    for key, ref, a, b in zip(keys, refs, m_g, s_g):
        # an input a side does not use has no gradient: zeros
        a = torch.zeros_like(ref) if a is None else a
        b = torch.zeros_like(ref) if b is None else b
        report[key] = float(max_rel_err(a, b))
    return report
