"""Network: NetConfig DAG -> forward (counterpart of
cxxnet_tpu/nnet/network.py).

Connections run in declaration order exactly like the reference
(neural_net-inl.hpp Forward :107-132). A shared connection
(`share[tag]`) reuses the primary layer's module and its entry in the
params dict; a self-loop layer (`layer[+0]`, in == out) overwrites its
node. Params are passed in as {param_key: {"wmat", "bias"}} - the JAX
package's keys - so the trainer can hold a float32 master copy and a
compute-dtype copy side by side.

`dtype_plan` ({layer index: torch dtype}, stamped by the autocast graph
pass) casts each listed layer's floating inputs and params to its
compute dtype before the layer runs; None (no plan) leaves the casts to
the trainer, which casts wholesale.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from cxxnet_tpu_torch.layers import create_layer
from cxxnet_tpu_torch.layers.base import Layer, Shape
from cxxnet_tpu_torch.layers.common import SplitLayer
from cxxnet_tpu_torch.layers.loss import LossLayer
from cxxnet_tpu_torch.nnet.net_config import NetConfig


def param_key(cfg: NetConfig, layer_index: int) -> str:
    """Stable key for a layer's params: its name, else its index."""
    info = cfg.layers[layer_index]
    return info.name if info.name else f"layer_{layer_index}"


class Network(nn.Module):
    """Layer modules + inferred node shapes; the forward."""

    def __init__(self, cfg: NetConfig, batch_size: int):
        super().__init__()
        self.cfg = cfg
        self.layer_objs = nn.ModuleList()
        self.node_shapes: List[Optional[Shape]] = [None] * cfg.num_nodes
        self.dtype_plan: Optional[Dict[int, torch.dtype]] = None

        c, y, x = cfg.input_shape
        if c * y * x == 0:
            raise ValueError("input_shape must be set")
        if cfg.extra_data_num:
            raise NotImplementedError(
                f"extra_data_num = {cfg.extra_data_num}: extra input "
                "nodes are not ported to cxxnet_tpu_torch yet")
        self.node_shapes[0] = (batch_size, c, y, x)

        # build layer modules and run shape inference in declaration order
        for idx, info in enumerate(cfg.layers):
            if info.is_shared:
                layer = self.layer_objs[info.primary_layer_index]
            else:
                layer = create_layer(info.type_name, info.name)
                for k, v in cfg.defcfg:
                    layer.set_param(k, v)
                for k, v in cfg.layercfg[idx]:
                    layer.set_param(k, v)
            self.layer_objs.append(layer)
            if isinstance(layer, SplitLayer):
                layer.num_out = len(info.nindex_out)
            if isinstance(layer, LossLayer):
                if info.nindex_in != info.nindex_out:
                    raise ValueError(
                        f"{info.type_name}: loss layer must be a self-loop")
                if layer.target not in cfg.label_name_map:
                    raise ValueError(
                        f"LossLayer: unknown target={layer.target}")
            in_shapes = []
            for j in info.nindex_in:
                if self.node_shapes[j] is None:
                    raise ValueError(
                        f"node {cfg.node_names[j]} used before it is "
                        "produced")
                in_shapes.append(self.node_shapes[j])
            out_shapes = layer.infer_shapes(list(in_shapes))
            if len(out_shapes) != len(info.nindex_out):
                raise ValueError(
                    f"{info.type_name}: produced {len(out_shapes)} outputs "
                    f"for {len(info.nindex_out)} output nodes")
            for j, s in zip(info.nindex_out, out_shapes):
                self.node_shapes[j] = s

    # ------------------------------------------------------------------
    def init_params(self, seed: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Float32 CPU params from `seed`: one torch.Generator per layer,
        seeded from (seed, layer index) - the role jax.random.fold_in
        plays in the JAX package."""
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        for idx, info in enumerate(self.cfg.layers):
            if info.is_shared:
                continue
            gen = torch.Generator().manual_seed(seed * 1000003 + idx)
            in_shapes = [self.node_shapes[j] for j in info.nindex_in]
            p = self.layer_objs[idx].init_params(gen, list(in_shapes))
            if p:
                params[param_key(self.cfg, idx)] = p
        return params

    def param_shapes(self) -> Dict[str, Dict[str, tuple]]:
        """{param_key: {name: shape}} - what a checkpoint must carry."""
        out = {}
        for idx, info in enumerate(self.cfg.layers):
            if info.is_shared:
                continue
            in_shapes = [self.node_shapes[j] for j in info.nindex_in]
            shapes = self.layer_objs[idx].param_shapes(list(in_shapes))
            if shapes:
                out[param_key(self.cfg, idx)] = shapes
        return out

    # ------------------------------------------------------------------
    def forward(
        self, params: Dict[str, Dict[str, torch.Tensor]],
        data: torch.Tensor, *, train: bool = False,
        gens: Optional[Callable[[int], torch.Generator]] = None,
        keep: Optional[Dict[int, torch.Tensor]] = None,
        labels: Optional[Dict[str, torch.Tensor]] = None,
        mask: Optional[torch.Tensor] = None,
        taps: Optional[Dict[int, Optional[torch.Tensor]]] = None,
    ) -> Tuple[List[Optional[torch.Tensor]], torch.Tensor]:
        """Run all connections in declaration order on node-0 `data`.

        train: training semantics (dropout draws a mask, a `has_aux`
        layer's auxiliary loss joins the total; inference runs every
        layer's plain forward). A layer that draws random numbers gets
        `gens(layer_index)` - the trainer seeds one generator per
        (seed, step, layer index), the role fold_in(rng, idx) plays in
        the JAX package - unless `keep` holds an injected draw for that
        layer index (dropout's boolean mask, or the uniform tensor of
        insanity, prelu and insanity_max_pooling).
        labels: label field -> (b, width) tensor; when given, each loss
        layer adds grad_scale * sum(mask * per_example_loss) to the
        total. mask: (b,) validity of the rows (padding rows 0), also
        handed to `has_aux` layers.
        taps: {layer index: None}, filled in place with each listed
        layer's first INPUT as the layer receives it (after the dtype
        plan's cast) - before a self-loop layer overwrites its node, so
        a `layer[+0] = batch_norm` is tapped at its input, which the
        graph passes' calibration needs.

        Returns (every node's value - None for nodes never written -,
        total_loss as a float32 scalar). A loss layer writes its
        forward_transform into its node, as in the JAX package."""
        cfg = self.cfg
        values: List[Optional[torch.Tensor]] = [None] * cfg.num_nodes
        values[0] = data
        total_loss = torch.zeros((), dtype=torch.float32,
                                 device=data.device)
        for idx, info in enumerate(cfg.layers):
            layer: Layer = self.layer_objs[idx]
            pkey = param_key(
                cfg, info.primary_layer_index if info.is_shared else idx)
            xs = [values[j] for j in info.nindex_in]
            p = params.get(pkey, {})
            want = (self.dtype_plan.get(idx)
                    if self.dtype_plan is not None else None)
            if want is not None:
                xs = [x.to(want) if x.is_floating_point() else x
                      for x in xs]
                p = {k: (v.to(want) if v.is_floating_point() else v)
                     for k, v in p.items()}
            if taps is not None and idx in taps:
                taps[idx] = xs[0]
            if isinstance(layer, LossLayer) and labels is not None:
                flat = xs[0].reshape(xs[0].shape[0], -1)
                per_ex = layer.per_example_loss(flat, labels[layer.target])
                if mask is not None:
                    per_ex = per_ex * mask
                total_loss = total_loss + layer.grad_scale * torch.sum(
                    per_ex)
            lkeep = keep.get(idx) if (train and keep) else None
            gen = (gens(idx) if (train and layer.uses_rng and lkeep is None
                                 and gens is not None) else None)
            if train and layer.has_aux:
                # an auxiliary loss term (moe's load balance) joins the
                # total the loss layers accumulate
                outs, aux = layer.forward_with_aux(
                    p, xs, train=train, gen=gen, keep=lkeep, mask=mask)
                total_loss = total_loss + aux
            else:
                outs = layer(p, xs, train=train, gen=gen, keep=lkeep)
            for j, o in zip(info.nindex_out, outs):
                values[j] = o
        return values, total_loss

    # ------------------------------------------------------------------
    def node_index(self, name: str) -> int:
        """Resolve a node reference: name, or `top[-k]` counting from the
        last node (ExtractFeature syntax, nnet_impl-inl.hpp:200-223)."""
        if name.startswith("top[-") and name.endswith("]"):
            k = int(name[5:-1])
            return self.cfg.num_nodes - k
        if name in self.cfg.node_name_map:
            return self.cfg.node_name_map[name]
        raise KeyError(f"unknown node name {name}")
