"""The multi-process runtime on torch.distributed (counterpart of
cxxnet_tpu/parallel/distributed.py).

The reference scales with a parameter server (mshadow-ps); the JAX
package replaces it with multi-controller SPMD. In PyTorch's idiom a
data-parallel job is N processes, one device each, joined in one
process group: the gradients ride an all-reduce inside the step.

Config surface as in the JAX package:
    param_server = dist          -> join the job
    dist_coordinator = host:port -> the store's address (env CXN_COORDINATOR)
    dist_num_worker = N          -> process count (env CXN_NUM_WORKER)
    dist_worker_rank = i         -> this process   (env CXN_WORKER_RANK)
and the iterators' dist_num_worker / dist_worker_rank pick each worker's
data shard. A one-worker job is a no-op.

The backend: NCCL where each rank has a card of its own; gloo on the
CPU and where ranks share one card (NCCL refuses two ranks on one
device). gloo reduces and broadcasts CUDA tensors but gathers and
reduce-scatters only host tensors, so `all_gather` and `reduce_scatter`
stage a CUDA tensor through pinned host memory under gloo -
explicitly, counted in `host_staged`. Every collective takes its group
(the mesh's data or model group). There is no
quiet swap: a failure at init or in a collective raises and fails the
rank (tools/launch_dist then tears the job down).

`check_replicated` is the test_on_server / CheckWeight_ analog: every
replicated param must be bitwise the same on every rank.
"""

from __future__ import annotations

import atexit
import datetime
import json
import os
import time
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cxxnet_tpu_torch.utils.config import ConfigError
from cxxnet_tpu_torch.utils.fault import retry

# bounded init retry defaults (overridable per call and by the
# dist_init_* config keys), as in the JAX package: a peer still binding
# the store costs a backoff, but an address that is simply wrong must
# become a clear error, not an endless connect loop
INIT_ATTEMPTS = 5
INIT_BACKOFF = 0.5
INIT_DEADLINE = 120.0
# how long a collective may wait for its peers before it fails the rank
# (a peer may be building a kernel library at its first step)
COLLECTIVE_SECS = 900.0

_state: Dict[str, object] = {"backend": "", "device": None, "store": None}
# how long rank 0, which serves the store, waits at exit for the others
EXIT_WAIT_SECS = 30.0
# collectives staged through pinned host memory (gloo over CUDA tensors)
host_staged = [0]
# reduce-scatters run (ZeRO stage >= 2's gradients)
reduce_scatters = [0]
# the seq axis's exchanges: ring hops and all-to-alls
seq_exchanges = {"hop": 0, "all_to_all": 0}
# the pipe axis's exchanges: stage-to-stage sends and receives, and the
# broadcasts of the last stage's output and stage 0's input gradient
pipe_exchanges = {"send": 0, "recv": 0, "broadcast": 0}


def local_rank() -> int:
    """This worker's index among the workers of its host: CXN_LOCAL_RANK,
    else CXN_WORKER_RANK in a multi-worker job (tools/launch_dist runs
    every worker on one host), else 0."""
    if "CXN_LOCAL_RANK" in os.environ:
        return int(os.environ["CXN_LOCAL_RANK"])
    if int(os.environ.get("CXN_NUM_WORKER", "1")) > 1:
        return int(os.environ.get("CXN_WORKER_RANK", "0"))
    return 0


def shares_device(spec: str) -> bool:
    """Whether every rank of a job runs on the device `spec` names: one
    explicit device index (`gpu:0`, `cuda:0`), or a list that repeats
    one. A spec without an index puts rank i on cuda:<local rank i>."""
    kind, _, idx = str(spec).strip().partition(":")
    if not idx or kind.lower() == "cpu":
        return False
    from cxxnet_tpu_torch.parallel.mesh import parse_device_spec
    ids = parse_device_spec(spec)
    return len(ids) == 1 or len(set(ids)) < len(ids)


def backend_for(device: torch.device, spec: str = "") -> str:
    """gloo on the CPU and where the ranks share one card; NCCL where
    each rank has a card of its own."""
    if device.type != "cuda" or shares_device(spec):
        return "gloo"
    return "nccl"


def is_initialized() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def backend() -> str:
    """The process group's backend ('' when no job was joined)."""
    return str(_state["backend"])


def init_distributed(coordinator: Optional[str] = None,
                     num_workers: Optional[int] = None,
                     rank: Optional[int] = None,
                     attempts: int = INIT_ATTEMPTS,
                     backoff: float = INIT_BACKOFF,
                     deadline: float = INIT_DEADLINE,
                     device: torch.device = torch.device("cpu"),
                     spec: str = "") -> None:
    """Join the job (idempotent).

    Arguments fall back to CXN_COORDINATOR / CXN_NUM_WORKER /
    CXN_WORKER_RANK (the launcher sets them). A one-worker job is a
    no-op. Rank 0 serves the store at the coordinator's address; the
    connection is retried with exponential backoff and jitter, its total
    wait capped by `deadline` seconds, and exhaustion raises ConfigError
    naming the coordinator (the JAX package's text)."""
    if is_initialized():
        return
    coordinator = coordinator or os.environ.get("CXN_COORDINATOR", "")
    num_workers = num_workers if num_workers is not None else int(
        os.environ.get("CXN_NUM_WORKER", "1"))
    rank = rank if rank is not None else int(
        os.environ.get("CXN_WORKER_RANK", "0"))
    if num_workers <= 1:
        return
    if not coordinator:
        raise ValueError(
            "param_server=dist needs dist_coordinator (or "
            "CXN_COORDINATOR) when dist_num_worker > 1")
    host, _, port = coordinator.rpartition(":")
    be = backend_for(device, spec)
    if device.type == "cuda":
        torch.cuda.set_device(device)

    @retry(attempts=max(1, attempts), backoff=backoff,
           jitter=backoff / 2, retry_on=(RuntimeError, OSError),
           deadline=deadline)
    def _connect():
        store = torch.distributed.TCPStore(
            host or "127.0.0.1", int(port), num_workers, rank == 0,
            timeout=datetime.timedelta(seconds=deadline),
            wait_for_workers=False)
        torch.distributed.init_process_group(
            be, store=store, rank=rank, world_size=num_workers,
            timeout=datetime.timedelta(seconds=COLLECTIVE_SECS))
        _state["store"] = store

    try:
        _connect()
    except (RuntimeError, OSError) as e:
        raise ConfigError(
            f"param_server=dist: could not join the job at "
            f"{coordinator} as rank {rank}/{num_workers} after "
            f"{attempts} attempts (deadline {deadline:g}s): {e}"
        ) from e
    _state["backend"] = be
    _state["device"] = device
    atexit.register(_shutdown, rank, num_workers)
    # each rank's first line: where it runs and over what
    sys.stderr.write(f"param_server=dist: rank {rank}/{num_workers} joined "
                     f"at {coordinator} on {device} over {be}\n")
    sys.stderr.flush()


def _shutdown(rank: int, num_workers: int) -> None:
    """At exit: every peer drops its process group first and then checks
    out at the store; rank 0, which serves the store, waits (bounded by
    EXIT_WAIT_SECS) until every peer has checked out, and only then
    drops its own group and leaves. A peer never tears its group down
    after the store is gone (a rank that checked out before its own
    teardown could lose the store to rank 0 halfway through it)."""
    store = _state["store"]
    if rank != 0 and is_initialized():
        torch.distributed.destroy_process_group()
    try:
        if rank == 0:
            end = time.monotonic() + EXIT_WAIT_SECS
            while (store.add("cxn_exit", 0) < num_workers - 1
                   and time.monotonic() < end):
                time.sleep(0.05)
        else:
            store.add("cxn_exit", 1)
    except RuntimeError:
        pass  # a peer already gone: nothing left to wait for
    if is_initialized():
        torch.distributed.destroy_process_group()


def init_from_config(pairs: Sequence[Tuple[str, str]],
                     device: torch.device = torch.device("cpu"),
                     spec: str = "") -> None:
    """Pull the dist_* keys out of a config pair list and join the job
    when `param_server = dist`."""
    cfg = dict(pairs)
    if cfg.get("param_server", "local") != "dist":
        return
    init_distributed(
        coordinator=cfg.get("dist_coordinator"),
        num_workers=int(cfg["dist_num_worker"])
        if "dist_num_worker" in cfg else None,
        rank=int(cfg["dist_worker_rank"])
        if "dist_worker_rank" in cfg else None,
        attempts=int(cfg.get("dist_init_retries", INIT_ATTEMPTS)),
        backoff=float(cfg.get("dist_init_backoff", INIT_BACKOFF)),
        deadline=float(cfg.get("dist_init_deadline", INIT_DEADLINE)),
        device=device, spec=spec or cfg.get("dev", ""))


def read_membership(coord_dir: str, attempts: int = INIT_ATTEMPTS,
                    backoff: float = INIT_BACKOFF,
                    deadline: float = INIT_DEADLINE) -> Dict[str, Any]:
    """The pod membership record (``generation.json`` - written by the
    elastic supervisor before each launch, parallel/coordinator.py),
    read with the same bounded retry discipline as the job's init: the
    record may lag the worker by a beat at generation start, and on a
    network filesystem a read can transiently fail - but a coord_dir
    that never produces a record must become a clear ConfigError, not
    a silent hang or a crash on the first ENOENT."""
    path = os.path.join(coord_dir, "generation.json")

    @retry(attempts=max(1, attempts), backoff=backoff,
           jitter=backoff / 2, retry_on=(OSError,), deadline=deadline)
    def _read() -> Dict[str, Any]:
        with open(path, "r", encoding="utf-8") as f:
            try:
                rec = json.load(f)
            except ValueError as e:
                # torn read on close-to-open-consistency filesystems:
                # transient, retry-absorbable like the OSError path
                raise OSError(f"unparseable membership record: {e}")
        if not isinstance(rec, dict) or "members" not in rec:
            raise OSError(f"membership record missing 'members': {rec}")
        return rec

    try:
        return _read()
    except OSError as e:
        raise ConfigError(
            f"elastic: cannot read pod membership record {path} "
            f"after {attempts} attempts (deadline {deadline:g}s): {e}"
        ) from e


def process_count() -> int:
    return torch.distributed.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return torch.distributed.get_rank() if is_initialized() else 0


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group=None,
                op: str = "sum") -> torch.Tensor:
    """Sum (or `op = "max"`: the largest of) `t` over the group's ranks,
    in place."""
    torch.distributed.all_reduce(
        t, op=(torch.distributed.ReduceOp.MAX if op == "max"
               else torch.distributed.ReduceOp.SUM), group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's `t` (same shape on every rank), in rank order, on
    t's device. Under gloo a CUDA tensor goes through pinned host
    memory (gloo gathers host tensors only)."""
    n = torch.distributed.get_world_size(group)
    t = t.contiguous()
    if t.is_cuda and torch.distributed.get_backend(group) == "gloo":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        outs = [torch.empty_like(host) for _ in range(n)]
        torch.distributed.all_gather(outs, host, group=group)
        host_staged[0] += 1
        return [o.to(t.device, non_blocking=True) for o in outs]
    outs = [torch.empty_like(t) for _ in range(n)]
    torch.distributed.all_gather(outs, t, group=group)
    return outs


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group's ranks of a flat tensor laid out as N
    equal chunks, of which this rank gets chunk `rank` (on t's device):
    no rank holds the whole sum. Under gloo a CUDA tensor goes through
    pinned host memory (gloo reduce-scatters host tensors only)."""
    n = torch.distributed.get_world_size(group)
    t = t.contiguous().reshape(-1)
    if t.numel() % n:
        raise ValueError(f"reduce_scatter: {t.numel()} elements do not "
                         f"split into {n} chunks")
    reduce_scatters[0] += 1
    staged = t.is_cuda and torch.distributed.get_backend(group) == "gloo"
    src = t
    if staged:
        src = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        src.copy_(t)
        host_staged[0] += 1
    out = torch.empty(t.numel() // n, dtype=t.dtype, device=src.device)
    torch.distributed.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device, non_blocking=True) if staged else out


def _staged(t: torch.Tensor, group) -> bool:
    """Whether `t` crosses through pinned host memory: a CUDA tensor
    over gloo (gloo moves host tensors only, but for its reduce and
    broadcast)."""
    return t.is_cuda and torch.distributed.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    host_staged[0] += 1
    return host


def _as_bytes(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes back to back (any dtypes): one buffer, one
    transfer."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in ts])


def _from_bytes(buf: torch.Tensor, like: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        part = buf[off:off + n]
        if off % t.element_size():
            part = part.clone()  # a view must start on its dtype's size
        out.append(part.view(t.dtype).view(t.shape))
        off += n
    return out


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """`t` laid out as N equal chunks along dim 0 (N = the group's
    size): chunk j goes to the group's rank j, and chunk j of the result
    came from rank j. Any dtype (the bytes move). Under gloo a CUDA
    tensor goes through pinned host memory."""
    n = torch.distributed.get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(t.shape)} does not "
                         f"split into {n} chunks")
    seq_exchanges["all_to_all"] += 1
    src = _as_bytes([t]).view(n, -1)
    if _staged(src, group):
        src = _to_host(src)
    out = torch.empty_like(src)
    torch.distributed.all_to_all_single(out, src, group=group)
    return _from_bytes(out.reshape(-1).to(t.device, non_blocking=True),
                       [t])[0]


class Hop:
    """One ring hop in flight (ring_hop): `wait()` returns the tensors
    received from the previous rank, shaped and typed as those sent."""

    def __init__(self, reqs, send: torch.Tensor, recv: torch.Tensor, like,
                 device):
        self._reqs, self._send, self._recv = reqs, send, recv
        self._like, self._device = like, device

    def wait(self) -> List[torch.Tensor]:
        for r in self._reqs:
            r.wait()
        return _from_bytes(self._recv.to(self._device, non_blocking=True),
                           self._like)


def ring_hop(ts: Sequence[torch.Tensor], group, dst: int, src: int) -> Hop:
    """Send the tensors to job rank `dst` and receive as many bytes from
    job rank `src`, as one batch_isend_irecv over `group`, packed into
    one buffer; returns at once (the compute of the step overlaps the
    transfer). Under gloo a CUDA tensor goes through pinned host
    memory."""
    seq_exchanges["hop"] += 1
    buf = _as_bytes(ts)
    device = buf.device
    if _staged(buf, group):
        buf = _to_host(buf)
        recv = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    else:
        recv = torch.empty_like(buf)
    reqs = torch.distributed.batch_isend_irecv([
        torch.distributed.P2POp(torch.distributed.isend, buf, dst, group),
        torch.distributed.P2POp(torch.distributed.irecv, recv, src, group)])
    return Hop(reqs, buf, recv, list(ts), device)


class Sent:
    """A stage send in flight (send): `wait()` blocks until it is out.
    It holds the buffer until then."""

    def __init__(self, reqs, buf: torch.Tensor):
        self._reqs, self._buf = reqs, buf

    def wait(self) -> None:
        for r in self._reqs:
            r.wait()


def _p2p(op, buf: torch.Tensor, peer: int, group):
    return torch.distributed.batch_isend_irecv(
        [torch.distributed.P2POp(op, buf, peer, group)])


def send(ts: Sequence[torch.Tensor], group, dst: int) -> Sent:
    """Send the tensors to job rank `dst` of `group`, packed into one
    buffer of bytes, as one batch_isend_irecv; returns at once (the
    caller waits before it reuses or frees what it sent). Under gloo a
    CUDA tensor goes through pinned host memory."""
    pipe_exchanges["send"] += 1
    buf = _as_bytes(ts)
    if _staged(buf, group):
        buf = _to_host(buf)
    return Sent(_p2p(torch.distributed.isend, buf, dst, group), buf)


def recv(like: Sequence[torch.Tensor], group, src: int,
         device: torch.device) -> List[torch.Tensor]:
    """Receive what job rank `src` sent with `send`: tensors shaped and
    typed as `like` (their shapes and dtypes are read; meta tensors do),
    on `device`."""
    pipe_exchanges["recv"] += 1
    n = sum(t.numel() * t.element_size() for t in like)
    staged = (device.type == "cuda"
              and torch.distributed.get_backend(group) == "gloo")
    buf = torch.empty(n, dtype=torch.uint8, pin_memory=staged,
                      device="cpu" if staged else device)
    for r in _p2p(torch.distributed.irecv, buf, src, group):
        r.wait()
    return _from_bytes(buf.to(device, non_blocking=True), like)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Job rank `src`'s `t` on every rank of `group` (the others pass a
    tensor of the same shape and dtype to receive into); any dtype (the
    bytes move). Under gloo a CUDA tensor goes through pinned host
    memory."""
    pipe_exchanges["broadcast"] += 1
    buf = _as_bytes([t])
    staged = _staged(buf, group)
    if staged:
        buf = _to_host(buf)
    torch.distributed.broadcast(buf, src, group=group)
    if not staged and torch.distributed.get_rank() == src:
        return t
    return _from_bytes(buf.to(t.device, non_blocking=True), [t])[0]


def host_sum(arr: np.ndarray, group=None) -> np.ndarray:
    """A host array summed over the ranks (float64 kept): the metrics'
    cross-rank reduce. NCCL reduces on the rank's card, gloo on the
    host."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    dev = _state["device"]
    if backend() == "nccl":
        t = t.to(dev)
    torch.distributed.all_reduce(t, group=group)
    return t.cpu().numpy()


def fetch_local(t: torch.Tensor) -> np.ndarray:
    """A device tensor -> this rank's host view (its rows of a
    batch-sharded output; the full value of a replicated one)."""
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# consistency checking (test_on_server analog)
# ---------------------------------------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def _bits(t: torch.Tensor) -> int:
    """A checksum of a tensor's bits: the int32 words summed in int64."""
    t = t.detach().contiguous()
    if t.element_size() == 4:
        words = t.view(torch.int32)
    else:
        words = t.float().view(torch.int32)
    return int(words.long().sum())


def check_replicated(tree, name: str = "params", group=None,
                     skip: Sequence[str] = ()) -> List[str]:
    """Replicated leaves must be bitwise the same on every rank: each
    rank's checksums are gathered and compared with rank 0's. Returns
    one description per leaf that differs ([] = consistent); `skip`
    names leaves kept sharded by design."""
    leaves = [(p, t) for p, t in _leaves(tree) if p not in skip]
    if not is_initialized() or not leaves:
        return []
    mine = torch.tensor([_bits(t) for _, t in leaves], dtype=torch.int64)
    if backend() == "nccl":
        mine = mine.to(_state["device"])
    rows = [r.cpu() for r in all_gather(mine, group)]
    bad = []
    for i, (path, _) in enumerate(leaves):
        for r in range(1, len(rows)):
            if int(rows[r][i]) != int(rows[0][i]):
                bad.append(f"{name}{path}: rank {r} diverges from rank 0")
    return bad
