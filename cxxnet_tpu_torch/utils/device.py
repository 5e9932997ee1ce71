"""Device policy: entry points run on the card unless asked for the CPU.

`dev` specs as the shipped confs spell them map to one torch device:
`cpu` (and `cpu:N`) is the CPU; `gpu`, `gpu:0`, `cuda`, `cuda:0`,
`tpu` and `tpu:0` all mean `cuda:0`. Multi-device specs (`tpu:0-63`,
`gpu:0,1`) belong to the parallelism slice and raise
NotImplementedError. With no card present a CUDA device raises a
RuntimeError that names the CPU spelling instead of quietly running on
the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda:0"


def device_from_spec(spec: str) -> str:
    """A conf's `dev = ...` value -> "cpu" or "cuda:0"."""
    kind, _, idx = spec.strip().partition(":")
    kind = kind.lower()
    if kind not in ("cpu", "gpu", "cuda", "tpu"):
        raise ValueError(f"unknown dev = {spec!r} (cpu, gpu, cuda or tpu)")
    if idx and ("-" in idx or "," in idx):
        raise NotImplementedError(
            f"dev = {spec}: multi-device runs are not ported yet "
            "(parallelism slice, see ROADMAP); use one device")
    if kind == "cpu":
        return "cpu"
    if idx and int(idx) != 0:
        raise NotImplementedError(
            f"dev = {spec}: the port runs on cuda:0 only so far")
    return DEFAULT_DEVICE


def resolve_device(name: str) -> torch.device:
    """torch.device for `name` ("cpu", "cuda", "cuda:0", or a dev spec);
    raises when a card is asked for and none is present."""
    name = str(name)
    if name.startswith("cuda"):
        dev = torch.device(name if ":" in name else DEFAULT_DEVICE)
    else:
        dev = torch.device(device_from_spec(name))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {dev}: cxxnet_tpu_torch runs on the card "
            "by default; pass device=\"cpu\" (or set dev = cpu in the "
            "conf) to run on the CPU")
    return dev
