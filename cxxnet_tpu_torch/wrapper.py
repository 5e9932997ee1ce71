"""numpy-facing wrapper API (counterpart of cxxnet_tpu/wrapper.py).

API parity with the reference's wrapper/cxxnet.py:64-312 (`Net`,
`DataIter`, `train()`): the same call signatures and semantics, numpy
in and out, bound directly to the in-process trainer. The C ABI
(capi.py, csrc/cxxnet_wrapper.cc) drives this module.

Device: `Net(dev=...)` and `train(dev=...)` run on the card by default
(`cuda:0`; the JAX wrapper defaults to the CPU). `dev = "cpu"` is the
CPU; `gpu`, `gpu:0`, `cuda` and `tpu` mean the card. With no card the
default raises and names `cpu`.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils.config import parse_config_string
from cxxnet_tpu_torch.utils.device import DEFAULT_DEVICE, device_from_spec


class DataIter:
    """Config-built data iterator (CXNIOCreateFromConfig semantics) on
    `dev` ("cpu", or gpu / cuda / tpu for the card, the default, as for
    Net), which routes imgbin's use_native (io/iter_img.py)."""

    def __init__(self, cfg: str, dev: str = DEFAULT_DEVICE):
        self._it = create_iterator(parse_config_string(cfg),
                                   device=device_from_spec(dev))
        self._it.init()
        self.head = True
        self.tail = False

    def next(self) -> bool:
        ret = self._it.next()
        self.head = False
        self.tail = not ret
        return ret

    def before_first(self) -> None:
        self._it.before_first()
        self.head = True
        self.tail = False

    def check_valid(self) -> None:
        if self.head:
            raise RuntimeError(
                "iterator at head state, call next to get to valid state")
        if self.tail:
            raise RuntimeError("iterator reaches end")

    def get_data(self) -> np.ndarray:
        self.check_valid()
        return self._it.value().data

    def get_label(self) -> np.ndarray:
        self.check_valid()
        return self._it.value().label

    @property
    def value(self) -> DataBatch:
        self.check_valid()
        return self._it.value()


def _batch_from_numpy(data: np.ndarray,
                      label: Optional[np.ndarray]) -> DataBatch:
    if data.ndim != 4:
        raise ValueError(
            "need 4 dimensional tensor (batch, channel, height, width)")
    if label is None:
        label = np.zeros((data.shape[0], 1), dtype=np.float32)
    label = np.asarray(label, dtype=np.float32)
    if label.ndim == 1:
        label = label.reshape(-1, 1)
    if label.shape[0] != data.shape[0]:
        raise ValueError("data size mismatch")
    return DataBatch(data=np.asarray(data, dtype=np.float32), label=label)


class Net:
    """Neural net object (CXNNetCreate semantics), on `dev`."""

    def __init__(self, dev: str = DEFAULT_DEVICE, cfg: str = ""):
        self._net = NetTrainer(cfg=cfg, device=device_from_spec(dev))
        self._server = None

    def set_param(self, name, value) -> None:
        self._net.set_param(str(name), str(value))

    def init_model(self) -> None:
        self._net.init_model()

    def load_model(self, fname: str) -> None:
        with open(fname, "rb") as f:
            self._net.load_model(f)

    def save_model(self, fname: str) -> None:
        with open(fname, "wb") as f:
            self._net.save_model(f)

    def start_round(self, round_counter: int) -> None:
        """The reference's StartRound: rolls the step profiler over
        (`profile` / `profile_dir`: the previous round's summary, the
        next round's trace)."""
        self._net.start_round(round_counter)

    def update(self, data: Union[DataIter, np.ndarray],
               label: Optional[np.ndarray] = None) -> None:
        if isinstance(data, DataIter):
            data.check_valid()
            self._net.update(data.value)
        elif isinstance(data, np.ndarray):
            if label is None:
                raise ValueError("need label to use update")
            self._net.update(_batch_from_numpy(data, label))
        else:
            raise TypeError(f"update does not support type {type(data)}")

    def evaluate(self, data: DataIter, name: str) -> str:
        if not isinstance(data, DataIter):
            raise TypeError("evaluate expects a DataIter")
        return self._net.evaluate(data._it, name)

    def _batch(self, data: Union[DataIter, np.ndarray]) -> DataBatch:
        if isinstance(data, DataIter):
            data.check_valid()
            return data.value
        return _batch_from_numpy(data, None)

    def predict(self, data: Union[DataIter, np.ndarray]) -> np.ndarray:
        return self._net.predict(self._batch(data))

    def predict_dist(self,
                     data: Union[DataIter, np.ndarray]) -> np.ndarray:
        return self._net.predict_dist(self._batch(data))

    def extract(self, data: Union[DataIter, np.ndarray],
                node_name: str) -> np.ndarray:
        return self._net.extract_feature(self._batch(data), node_name)

    def calibrate_passes(self, data: np.ndarray,
                         label: Optional[np.ndarray] = None) -> bool:
        """Capture the fold_conv_bn / quantize_int8 calibration
        statistics from one numpy batch. predict/extract calibrate on
        their first batch; call this before serve_start so the Server
        serves the transformed graph (an uncalibrated Server serves the
        float graph and warns). Returns True when statistics were
        captured."""
        return self._net.calibrate_graph_passes(
            _batch_from_numpy(np.asarray(data, dtype=np.float32), label))

    # -- serving -----------------------------------------------------------
    def serve_start(self, max_batch: int = 0,
                    max_wait_ms: Optional[float] = None,
                    replicas: Optional[int] = None,
                    http_port: Optional[int] = None,
                    queue_limit: Optional[int] = None,
                    deadline_ms: Optional[float] = None,
                    swap_watch: Optional[str] = None) -> None:
        """Start the continuous-batching Server over this net (its
        buckets warmed here). Unset arguments fall back to the net's
        serve_* keys. http_port attaches /predict (0 = ephemeral; the
        bound port is `net._server.metrics_server.port`); queue_limit
        arms load shedding; swap_watch the checkpoint hot-swap
        poller."""
        if self._server is not None:
            raise RuntimeError("server already started")
        from cxxnet_tpu_torch.serve import Server
        srv = Server(self._net, max_batch=max_batch,
                     max_wait_ms=max_wait_ms, replicas=replicas,
                     http_port=http_port, queue_limit=queue_limit,
                     deadline_ms=deadline_ms, swap_watch=swap_watch,
                     device=str(self._net.device))
        # attached only once running: a failed warmup leaves
        # serve_start retryable
        srv.warmup()
        srv.start()
        self._server = srv

    def _running(self):
        if self._server is None:
            raise RuntimeError("call serve_start first")
        return self._server

    def serve_submit(self, data: np.ndarray, block: bool = True):
        """Submit numpy rows ((n, c, y, x) or one (c, y, x) instance)
        to the running Server: the raw final-node rows (n, width) with
        block=True, else a future whose result() yields them."""
        fut = self._running().submit(np.asarray(data, dtype=np.float32))
        return fut.result() if block else fut

    def serve_swap(self, path: str) -> bool:
        """Hot-swap the running Server's weights from a checkpoint;
        False (the old weights keep serving) for a torn, corrupt or
        mismatched file."""
        return self._running().swap_to(path)

    def serve_stop(self) -> dict:
        """Drain and stop the Server; returns its stats()."""
        srv, self._server = self._running(), None
        return srv.stop()

    def serve_drain(self) -> dict:
        """Graceful shutdown: refuse new submissions, resolve every
        queued request, then stop. Returns stats()."""
        srv, self._server = self._running(), None
        return srv.drain()

    def has_layer(self, layer_name: str) -> bool:
        return layer_name in self._net.net_cfg.layer_name_map

    def get_weight(self, layer_name: str, tag: str) -> np.ndarray:
        w, _ = self._net.get_weight(layer_name, tag)
        return w

    def set_weight(self, weight: np.ndarray, layer_name: str,
                   tag: str) -> None:
        self._net.set_weight(np.asarray(weight, dtype=np.float32),
                             layer_name, tag)


# train()'s staging cutoff: a dataset whose staged batches take fewer
# bytes is staged once (module-level so tests can force either path)
_STAGE_BYTES_LIMIT = 256 * 2 ** 20


class _Slices:
    """numpy arrays as a DataIter of batch_size slices (train()'s
    prefetched path)."""

    def __init__(self, data, label, batch_size: int):
        self.data, self.label, self.bs = data, label, batch_size
        self.i = -batch_size

    def before_first(self) -> None:
        self.i = -self.bs

    def next(self) -> bool:
        self.i += self.bs
        return self.i < self.data.shape[0]

    def value(self) -> DataBatch:
        i, bs = self.i, self.bs
        return _batch_from_numpy(self.data[i:i + bs], self.label[i:i + bs])


def train(cfg: str, data, label, num_round: int,
          param, eval_data=None, batch_size: int = 128,
          dev: str = DEFAULT_DEVICE) -> Net:
    """Train a Net on numpy arrays (cxxnet.py:301-312).

    A dataset whose staged batches (float32, padded to whole batches)
    take fewer than _STAGE_BYTES_LIMIT bytes is staged on the device
    once and replayed every round; a larger one streams through the
    staging prefetcher (io/prefetch.py: batch k+1 staged while step k
    runs). Both give the trajectory of plain update() calls. Under
    `steps_per_dispatch = K` the staged batches are stacked into K-step
    chunks once, or the prefetcher assembles chunks; each round then
    runs one update_chunk per chunk.

    eval_data: optional (data, label) pair; the classification error is
    printed to stderr after every round. The final partial batch of each
    round trains too (padded)."""
    from cxxnet_tpu_torch import telemetry
    net = Net(dev=dev, cfg=cfg)
    net.set_param("batch_size", batch_size)
    for k, v in (param.items() if isinstance(param, dict) else param):
        net.set_param(k, v)
    net.init_model()
    tr = net._net
    n = data.shape[0]
    c, hh, ww = tr.net_cfg.input_shape
    n_batches = (n + batch_size - 1) // batch_size
    staged_bytes = n_batches * batch_size * c * hh * ww * 4
    staged = pf = None
    k = tr.steps_per_dispatch
    if staged_bytes < _STAGE_BYTES_LIMIT:
        staged = [tr.stage_batch(_batch_from_numpy(
            data[i:i + batch_size], label[i:i + batch_size]))
            for i in range(0, n, batch_size)]
        if k > 1:
            staged = [tr.stage_chunk(staged[i:i + k])
                      for i in range(0, len(staged), k)]
    else:
        pf = tr.prefetch(_Slices(data, label, batch_size), depth=1,
                         chunk=k)
    try:
        for r in range(num_round):
            net.start_round(r)
            if staged is not None:
                for s in staged:
                    tr.update(s)
            else:
                pf.before_first()
                while pf.next():
                    tr.update(pf.value())
            if eval_data is not None:
                ed, el = eval_data
                pred = np.concatenate(
                    [net.predict(ed[i:i + batch_size])
                     for i in range(0, ed.shape[0], batch_size)])
                err = float((pred != np.asarray(el).reshape(-1)).mean())
                telemetry.stderr(f"[{r}]\teval-error:{err:g}\n",
                                 event_kind="eval", round=r,
                                 values={"eval-error": err})
    finally:
        if pf is not None:
            pf.close()  # a mid-round error must not leak the worker
    return net
