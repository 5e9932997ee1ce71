"""The port's staged prefetch (io/prefetch.py) on the CPU, modelled on
tests/test_prefetch.py: the staged tensors equal stage_batch's streamed
ones bit for bit under every staging dtype and device_augment, three SGD
steps staged and streamed leave bitwise-equal params, a pass restarts on
before_first, a worker error reaches the consumer, close() is terminal,
and none of these leaves a live thread. The CLI's train loop stages
through the prefetcher by default (prefetch_stage = 1) and streams under
prefetch_stage = 0, with the same trained model."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.io.prefetch import StagedPrefetcher
from cxxnet_tpu_torch.nnet.trainer import NetTrainer, StagedBatch
from torch_port_util import NARROW_ALEXNET

TRAIN = "eta = 0.05\nmomentum = 0.9\nwd = 0.0005\nmetric = error\n"


class ListIter:
    def __init__(self, items):
        self.items = items

    def before_first(self):
        self.i = -1

    def next(self):
        self.i += 1
        return self.i < len(self.items)

    def value(self):
        return self.items[self.i]


def synth(n, rows=8, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [DataBatch(
        data=(rng.randint(0, 256, (rows, 3, 35, 35)).astype(dtype)
              if dtype == np.uint8 else
              (rng.randn(rows, 3, 35, 35) * 3).astype(dtype)),
        label=rng.randint(0, 10, (rows, 1)).astype(np.float32),
        num_batch_padd=1 if rows < 8 else 0) for _ in range(n)]


def trainer(extra=""):
    t = NetTrainer(cfg=NARROW_ALEXNET + TRAIN + extra, device="cpu")
    t.init_model()
    return t


def live_prefetchers():
    return [t for t in threading.enumerate()
            if t.name == "staged-prefetch" and t.is_alive()]


def wait_no_prefetchers(timeout=10.0):
    deadline = time.monotonic() + timeout
    while live_prefetchers() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not live_prefetchers()


def assert_same_staged(a: StagedBatch, b: StagedBatch):
    assert a.data.dtype == b.data.dtype
    assert torch.equal(a.data, b.data)
    assert torch.equal(a.mask, b.mask)
    assert sorted(a.labels) == sorted(b.labels)
    for k in a.labels:
        assert torch.equal(a.labels[k], b.labels[k])
    assert a.ready is None and b.ready is None


@pytest.mark.parametrize("extra,dtype", [
    ("", np.float32), ("dtype = bfloat16\n", np.float32),
    ("dtype = bfloat16\nstage_dtype = float32\n", np.float32),
    ("device_augment = 1\ninput_shape = 3,31,31\n", np.uint8),
    ("dtype = bfloat16\ndevice_augment = 1\nstage_dtype = bfloat16\n"
     "input_shape = 3,31,31\n", np.uint8)])
def test_prefetched_staging_equals_streamed_bitwise(extra, dtype):
    t = trainer(extra)
    items = synth(3, dtype=dtype) + synth(1, rows=5, seed=2, dtype=dtype)
    pf = t.prefetch(ListIter(items), depth=2)
    pf.before_first()
    got = []
    while pf.next():
        got.append(pf.value())
    assert len(got) == len(items)
    for g, b in zip(got, items):
        assert_same_staged(g, t.stage_batch(b))
    assert got[-1].mask.tolist() == [1.0] * 5 + [0.0] * 3
    wait_no_prefetchers()


def test_three_sgd_steps_staged_equal_streamed():
    items = synth(3, seed=4)
    t1, t2 = trainer(), trainer()
    for b in items:
        t1.update(b)
    pf = t2.prefetch(ListIter(items), depth=1)
    pf.before_first()
    n = 0
    while pf.next():
        assert isinstance(pf.value(), StagedBatch)
        t2.update(pf.value())
        n += 1
    assert n == 3
    for lk, d in t1.state["params"].items():
        for pn, w in d.items():
            assert torch.equal(w, t2.state["params"][lk][pn]), (lk, pn)
    assert t1.epoch == t2.epoch == 3
    wait_no_prefetchers()


def test_prefetcher_restarts_on_before_first():
    items = synth(5)
    t = trainer()
    pf = t.prefetch(ListIter(items), depth=1)
    pf.before_first()
    assert pf.next()  # consume one, abandon the pass
    pf.before_first()
    count = 0
    while pf.next():
        count += 1
    assert count == len(items)
    # an exhausted pass stays exhausted until the next before_first
    assert not pf.next()
    assert not pf.next()
    pf.before_first()
    assert pf.next()
    pf.close()
    wait_no_prefetchers()


def test_prefetcher_close_is_terminal():
    items = synth(3)
    t = trainer()
    pf = t.prefetch(ListIter(items), depth=1)
    pf.before_first()
    assert pf.next()
    pf.close()
    assert not pf.next()
    assert pf._thread is None  # no resurrected worker
    pf.close()  # idempotent
    wait_no_prefetchers()
    pf.before_first()  # explicit reopen works
    count = 0
    while pf.next():
        count += 1
    assert count == len(items)
    pf.close()
    wait_no_prefetchers()


def test_prefetcher_propagates_source_errors():
    class Boom(ListIter):
        def value(self):
            if self.i == 1:
                raise OSError("decode failed")
            return super().value()

    t = trainer()
    pf = t.prefetch(Boom(synth(3)), depth=1)
    pf.before_first()
    assert pf.next()
    with pytest.raises(OSError, match="decode failed"):
        pf.next()
    assert not pf.next()  # a dead worker: False, not a hang
    wait_no_prefetchers()
    # an error still queued when the consumer stops is raised by close()
    pf = StagedPrefetcher(lambda b, ring: b, Boom(synth(3)), depth=3)
    pf.before_first()
    time.sleep(0.2)
    with pytest.raises(OSError, match="decode failed"):
        pf.close()
    wait_no_prefetchers()


def test_fused_chunks_are_not_ported():
    with pytest.raises(NotImplementedError, match="steps_per_dispatch"):
        trainer().prefetch(ListIter([]), chunk=4)


CLI_CONF = """
data = train
iter = mnist
  path_img = "{d}/train-images-idx3-ubyte.gz"
  path_label = "{d}/train-labels-idx1-ubyte.gz"
  input_flat = 0
  shuffle = 1
iter = end
netconfig=start
layer[0->1] = conv:c1
  kernel_size = 5
  stride = 2
  nchannel = 4
layer[1->2] = relu
layer[2->3] = lrn
  local_size = 3
  alpha = 0.01
  beta = 0.75
  knorm = 1
layer[3->4] = flatten
layer[4->5] = fullc:fc
  nhidden = 10
layer[5->5] = softmax
netconfig=end
input_shape = 1,28,28
batch_size = 20
seed = 2
silent = 1
dev = cpu
eta = 0.1
num_round = 2
max_round = 2
"""


def test_cli_trains_through_the_prefetcher_by_default(tmp_path,
                                                      monkeypatch):
    from test_torch_train import write_mnist
    d = str(tmp_path)
    write_mnist(d, "train", 100, 3)
    conf = os.path.join(d, "c.conf")
    with open(conf, "w") as f:
        f.write(CLI_CONF.format(d=d))
    seen = []
    orig = NetTrainer.update

    def record(self, batch, keep=None):
        seen.append(type(batch))
        return orig(self, batch, keep)

    monkeypatch.setattr(NetTrainer, "update", record)
    assert port_main.main([conf, f"model_dir={d}/m1"]) == 0
    assert seen and all(t is StagedBatch for t in seen), set(seen)
    seen.clear()
    assert port_main.main([conf, f"model_dir={d}/m0",
                           "prefetch_stage=0"]) == 0
    assert seen and all(t is DataBatch for t in seen), set(seen)
    for name in ("0001.model", "0002.model"):
        with open(f"{d}/m1/{name}", "rb") as a, \
                open(f"{d}/m0/{name}", "rb") as b:
            assert a.read() == b.read()
    wait_no_prefetchers()
