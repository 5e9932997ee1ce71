"""Device policy: entry points run on the card unless asked for the CPU.

`dev` specs as the shipped confs spell them map to one torch device:
`cpu` (and `cpu:N`) is the CPU; `gpu:K` / `cuda:K` / `tpu:K` is card K;
`gpu`, `cuda` and `tpu` name no card and mean this worker's default,
cuda:<local rank> (cuda:0 outside a multi-worker job). A multi-device
spec (`gpu:0-3`, `gpu:0,1`; parsed in parallel/mesh.py) declares a data
axis of one rank per listed card, and maps to the card this worker's
local rank picks from the list. With no card present a CUDA device
raises a RuntimeError that names the CPU spelling instead of quietly
running on the CPU; a local rank past the cards present raises too,
naming the spelling that puts every rank on one card.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda:0"


def _local_rank() -> int:
    from cxxnet_tpu_torch.parallel.distributed import local_rank
    return local_rank()


def default_device() -> str:
    """This worker's card: cuda:<local rank> in a multi-worker job,
    cuda:0 otherwise. A local rank past the cards present raises, naming
    the spelling that puts every rank on one card."""
    r = _local_rank()
    n = torch.cuda.device_count()
    if n and r >= n:
        raise RuntimeError(
            f"local rank {r} has no card of its own (this machine has {n}); "
            "to run every rank of the job on one card name it (dev = gpu:0)")
    return f"cuda:{r}"


def check_spec(spec: str) -> None:
    """Validate a `dev` value without choosing a device: a conf's own
    `dev` may still be overridden on the command line, so the rank's card
    is chosen (and a missing one refused) only by device_from_spec."""
    kind, _, idx = spec.strip().partition(":")
    if kind.lower() not in ("cpu", "gpu", "cuda", "tpu"):
        raise ValueError(f"unknown dev = {spec!r} (cpu, gpu, cuda or tpu)")
    if idx:
        from cxxnet_tpu_torch.parallel.mesh import parse_device_spec
        parse_device_spec(spec)


def device_from_spec(spec: str) -> str:
    """A conf's `dev = ...` value -> "cpu" or "cuda:K"."""
    kind, _, idx = spec.strip().partition(":")
    kind = kind.lower()
    if kind not in ("cpu", "gpu", "cuda", "tpu"):
        raise ValueError(f"unknown dev = {spec!r} (cpu, gpu, cuda or tpu)")
    if kind == "cpu":
        return "cpu"
    if idx and ("-" in idx or "," in idx):
        from cxxnet_tpu_torch.parallel.mesh import parse_device_spec
        ids = parse_device_spec(spec)
        r = _local_rank()
        if r >= len(ids):
            raise ValueError(
                f"dev = {spec} lists {len(ids)} devices but this is "
                f"local rank {r}")
        return f"cuda:{ids[r]}"
    if idx:
        return f"cuda:{int(idx)}"
    return default_device()


def resolve_device(name: str) -> torch.device:
    """torch.device for `name` ("cpu", "cuda", "cuda:0", or a dev spec);
    raises when a card is asked for and none is present."""
    name = str(name)
    if name.startswith("cuda"):
        dev = torch.device(name if ":" in name else default_device())
    else:
        dev = torch.device(device_from_spec(name))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {dev}: cxxnet_tpu_torch runs on the card "
            "by default; pass device=\"cpu\" (or set dev = cpu in the "
            "conf) to run on the CPU")
    return dev
