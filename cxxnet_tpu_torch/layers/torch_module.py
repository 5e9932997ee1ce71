"""`torch`: a torch.nn.Module in the netconfig DAG (counterpart of
cxxnet_tpu/plugin/torch_adapter.py, the role of the reference's caffe
adapter, src/plugin/caffe_adapter-inl.hpp).

    layer[a->b] = torch:mylayer
      torch_module = "nn.Conv2d(3, 8, 3, padding=1)"

The expression is evaluated with `torch` and `torch.nn as nn` in scope.
In the port the module is simply part of the graph: it runs on the
trainer's device inside the forward, in float32 (its input and params
cast up, its output cast back to the input's dtype, as the JAX package
runs it), through torch.func.functional_call on the params tree. Its
parameters live in that tree under their names with "." replaced by
"_", initialised by the module's own init and tagged `bias` (1-D) or
`wmat`, so the port's updaters train them and checkpoints carry them.
A stochastic module (Dropout) draws, in training, from the layer's
generator. Buffers (running statistics) are neither trained nor
checkpointed; building such a module warns, as in the JAX package.
"""

from __future__ import annotations

import warnings
from typing import Dict, List

import torch
from torch import nn

from cxxnet_tpu_torch.layers.base import Layer, Params, Shape, register_layer


def _sanitize(name: str) -> str:
    return name.replace(".", "_")


@register_layer
class TorchModuleLayer(Layer):
    """`torch`: wraps the torch.nn.Module built from `torch_module`."""

    type_name = "torch"
    uses_rng = True

    def __init__(self, name: str = ""):
        super().__init__(name)
        self.module_expr = ""
        # kept out of nn.Module registration: its parameters are the
        # params tree's, not the network's
        self.__dict__["_module"] = None

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "torch_module":
            self.module_expr = val
            self.__dict__["_module"] = None

    def module(self) -> nn.Module:
        mod = self.__dict__["_module"]
        if mod is not None:
            return mod
        if not self.module_expr:
            raise ValueError(
                "torch adapter: must set torch_module = <expression>")
        mod = eval(self.module_expr,  # noqa: S307 - the conf owns it
                   {"torch": torch, "nn": nn}).float()
        bufs = [n for n, _ in mod.named_buffers()]
        if bufs:
            warnings.warn(
                "torch adapter: module has stateful buffers "
                f"{bufs}; they are neither trained nor checkpointed "
                "(running stats will stay at their init values)",
                stacklevel=2)
        self.__dict__["_module"] = mod
        return mod

    def infer_shapes(self, in_shapes: List[Shape]) -> List[Shape]:
        self.check_one_to_one(in_shapes)
        mod = self.module()
        with torch.no_grad():
            out = mod.cpu()(torch.zeros(*in_shapes[0]))
        if out.dim() != 4:
            raise ValueError(
                "torch adapter: module must map NCHW -> NCHW, got "
                f"{tuple(out.shape)}")
        return [tuple(out.shape)]

    def param_shapes(self, in_shapes: List[Shape]) -> Dict[str, tuple]:
        return {_sanitize(n): tuple(p.shape)
                for n, p in self.module().named_parameters()}

    def init_params(self, gen, in_shapes: List[Shape]) -> Params:
        # the module's own initialisation is the layer's init
        return {_sanitize(n): p.detach().cpu().float().clone()
                for n, p in self.module().named_parameters()}

    def param_tags(self) -> Dict[str, str]:
        return {_sanitize(n): ("bias" if p.dim() == 1 else "wmat")
                for n, p in self.module().named_parameters()}

    def forward(self, params, inputs, train=False, gen=None, keep=None):
        x = inputs[0]
        mod = self.module()
        if next(iter(mod.buffers()), x).device != x.device:
            mod.to(x.device)
        mod.train(train)
        tree = {n: params[_sanitize(n)].float()
                for n, _ in mod.named_parameters()}
        if train and gen is not None:
            seed = int(torch.randint(2 ** 31 - 1, (1,), generator=gen,
                                     device=gen.device))
            devices = [x.device.index or 0] if x.is_cuda else []
            with torch.random.fork_rng(devices=devices):
                torch.manual_seed(seed)
                out = torch.func.functional_call(mod, tree, (x.float(),))
        else:
            out = torch.func.functional_call(mod, tree, (x.float(),))
        return [out.to(x.dtype)]
