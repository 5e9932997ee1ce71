"""Augmentation in the port against the JAX package, on the CPU.

- Host augmenter (io/augment.py): the same imgbin chains with every
  augment key - rand_crop, rand_mirror / mirror, crop_*_start,
  mean_value, max_random_contrast / max_random_illumination, divideby,
  scale, a crop-sized image_mean created on the first run, a full-frame
  one, and bowl.conf's affine keys - give the same batches bit for bit,
  and the two mean files are byte-equal (same RandomState draws, same
  numpy / scipy calls).
- Device augment (ops/augment.py): the eval path against the JAX
  package's make_device_augment (deterministic, compared directly;
  bar bitwise, the same float32 operations in the same order), the
  train path against the host AugmentIterator with its draws replayed
  from its RandomState (bitwise), uint8 staging end to end through
  NetTrainer, the staged dtype against the JAX trainer's _host_input,
  and the CLI's device-augment block checks, which raise where the JAX
  CLI's raise, with its messages."""

import os

import numpy as np
import pytest
import torch

import jax

from cxxnet_tpu import main as jax_main
from cxxnet_tpu.io import create_iterator as jax_create
from cxxnet_tpu.io.augment import save_mean_image
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.ops.augment_jit import make_device_augment as jax_daug
from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.io import create_iterator as port_create
from cxxnet_tpu_torch.io.augment import AugmentIterator
from cxxnet_tpu_torch.io.data import DataBatch, DataInst
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops.augment import make_device_augment
from cxxnet_tpu_torch.utils.config import parse_config_string
from test_torch_io import _block, assert_same_batches, batches, write_set

# ---------------------------------------------------------------------------
# host augmenter
# ---------------------------------------------------------------------------

AUG_CASES = {
    "crop-mirror-jitter-created-mean": (
        20, "input_shape = 3,16,16\nrand_crop = 1\nrand_mirror = 1\n"
        "max_random_contrast = 0.2\nmax_random_illumination = 10\n"
        "divideby = 256\nimage_mean = \"{mean}\"\nshuffle = 1\n"),
    "mean-value-fixed-crop": (
        20, "input_shape = 3,14,15\nmean_value = 104,117,123\n"
        "max_random_contrast = 0.3\nmax_random_illumination = 5\n"
        "scale = 0.5\nmirror = 1\ncrop_y_start = 3\ncrop_x_start = 1\n"
        "seed_data = 7\n"),
    "full-frame-mean": (
        20, "input_shape = 3,16,16\nrand_crop = 1\nrand_mirror = 1\n"
        "image_mean = \"{full}\"\nmax_random_contrast = 0.1\n"
        "seed_data = 2\n"),
    # bowl.conf's train block (examples/kaggle_bowl/bowl.conf) on 48 x 48
    # images for its 3,40,40 input
    "bowl-affine": (
        48, "input_shape = 3,40,40\nimage_mean = \"{mean}\"\n"
        "rand_mirror = 1\nrand_crop = 1\nmax_rotate_angle = 180\n"
        "max_aspect_ratio = 0.5\nmax_shear_ratio = 0.3\n"
        "min_crop_size = 32\nmax_crop_size = 48\nshuffle = 1\n"),
}


@pytest.mark.parametrize("case", sorted(AUG_CASES))
def test_host_augmenter_matches_jax_bitwise(tmp_path, case):
    size, keys = AUG_CASES[case]
    d = str(tmp_path)
    lst, root, binp = write_set(d, "s", 12, size, 5)
    full = os.path.join(d, "full.bin")
    save_mean_image(full, np.random.RandomState(1).uniform(
        0, 255, (3, size, size)).astype(np.float32))
    out, means = {}, {}
    for pkg, create in (("port", port_create), ("jax", jax_create)):
        means[pkg] = os.path.join(d, f"mean_{pkg}.bin")
        text = (_block("imgbin", lst, root, binp,
                       "batch_size = 4\nround_batch = 1\n"
                       + keys.format(mean=means[pkg], full=full))
                + "iter = threadbuffer\niter = end\n")
        out[pkg] = batches(create, text)
        # a second chain loads the file the first one created
        out[pkg + "2"] = batches(create, text, passes=1)
    assert_same_batches(out["port"], out["jax"])
    assert_same_batches(out["port2"], out["jax2"])
    if "{mean}" in keys:
        with open(means["port"], "rb") as a, open(means["jax"], "rb") as b:
            assert a.read() == b.read()


# ---------------------------------------------------------------------------
# device augment
# ---------------------------------------------------------------------------

class _ListBase:
    """A DataInst source for a bare AugmentIterator."""

    def __init__(self, insts):
        self.insts = insts
        self.pos = 0

    def set_param(self, name, val):
        pass

    def init(self):
        pass

    def before_first(self):
        self.pos = 0

    def next(self):
        if self.pos >= len(self.insts):
            return False
        self._out = self.insts[self.pos]
        self.pos += 1
        return True

    def value(self):
        return self._out


def replay_draws(seed, n, yy_max, xx_max, rand_crop, rand_mirror):
    """The host AugmentIterator's per-instance draws, replayed from its
    RandomState(0 + seed_data) in its order, in ops/augment.py's form."""
    rng = np.random.RandomState(seed)
    out = {k: [] for k in ("yy", "xx", "mirror", "contrast",
                           "illumination")}
    for _ in range(n):
        yy = xx = 0
        if rand_crop and (yy_max or xx_max):
            yy = rng.randint(0, yy_max + 1)
            xx = rng.randint(0, xx_max + 1)
        out["yy"].append(yy)
        out["xx"].append(xx)
        out["contrast"].append(rng.uniform())
        out["illumination"].append(rng.uniform())
        out["mirror"].append(bool(rand_mirror and rng.uniform() < 0.5))
    return {"yy": torch.tensor(out["yy"]), "xx": torch.tensor(out["xx"]),
            "mirror": torch.tensor(out["mirror"]),
            "contrast": torch.tensor(out["contrast"], dtype=torch.float64),
            "illumination": torch.tensor(out["illumination"],
                                         dtype=torch.float64)}


RAW = (3, 24, 22)
OUT = (3, 16, 15)

# name: (mean kind, keys)
TRAIN_CASES = {
    "crop-mirror-jitter-crop-mean": ("crop", dict(
        rand_crop=1, rand_mirror=1, max_random_contrast=0.3,
        max_random_illumination=12.0, scale=1 / 256)),
    "raw-mean": ("raw", dict(rand_crop=1, rand_mirror=1,
                             max_random_contrast=0.2, scale=0.5)),
    "mean-value": ("values", dict(rand_crop=1, max_random_illumination=7.0,
                                  max_random_contrast=0.1, mirror=1)),
    "no-mean-jitter-skipped": ("none", dict(
        rand_crop=1, rand_mirror=1, max_random_contrast=0.5,
        max_random_illumination=9.0, scale=2.0)),
    "fixed-crop-over-random": ("crop", dict(
        rand_crop=1, rand_mirror=1, crop_y_start=1, crop_x_start=6,
        max_random_contrast=0.4)),
}


def _means(kind):
    rng = np.random.RandomState(8)
    return {"crop": rng.uniform(0, 200, OUT).astype(np.float32),
            "raw": rng.uniform(0, 200, RAW).astype(np.float32),
            "values": None, "none": None}[kind]


def _host_keys(kind, kw, seed):
    keys = [("input_shape", ",".join(map(str, OUT))),
            ("seed_data", str(seed))]
    if kind == "values":
        keys.append(("mean_value", "104.5,117,123.25"))
    for k, v in kw.items():
        keys.append((k, repr(float(v)) if k == "scale" else str(v)))
    return keys


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_device_augment_train_path_equals_host_with_replayed_draws(case):
    kind, kw = TRAIN_CASES[case]
    seed, n = 11, 9
    rng = np.random.RandomState(3)
    raw = rng.randint(0, 256, (n,) + RAW).astype(np.uint8)
    mean = _means(kind)
    host = AugmentIterator(_ListBase([
        DataInst(index=i, data=raw[i], label=np.zeros(1, np.float32))
        for i in range(n)]))
    for k, v in _host_keys(kind, kw, seed):
        host.set_param(k, v)
    host.meanimg = mean
    host.before_first()
    want = []
    while host.next():
        want.append(host.value().data)
    want = np.stack(want)

    fn = make_device_augment(
        OUT, mean_loader=(lambda: mean) if mean is not None else None,
        mean_values=(104.5, 117.0, 123.25) if kind == "values" else None,
        **kw)
    draws = replay_draws(seed, n, RAW[1] - OUT[1], RAW[2] - OUT[2],
                         kw.get("rand_crop", 0), kw.get("rand_mirror", 0))
    got = fn(torch.from_numpy(raw), True, draws=draws).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mean_kind", ["none", "crop", "raw", "values"])
@pytest.mark.parametrize("mirror", [0, 1])
@pytest.mark.parametrize("fixed", [False, True])
def test_device_augment_eval_path_equals_jax(mean_kind, mirror, fixed):
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, (5,) + RAW).astype(np.uint8)
    mean = _means(mean_kind)
    kw = dict(scale=0.25, mirror=mirror, rand_crop=1, rand_mirror=1,
              max_random_contrast=0.5, max_random_illumination=3.0)
    if fixed:
        kw.update(crop_y_start=2, crop_x_start=7)
    mv = (1.5, 2.5, 3.5) if mean_kind == "values" else None
    loader = (lambda: mean) if mean is not None else None
    want = np.asarray(jax_daug(OUT, mean_loader=loader, mean_values=mv,
                               **kw)(raw, jax.random.PRNGKey(0), False))
    got = make_device_augment(OUT, mean_loader=loader, mean_values=mv,
                              **kw)(torch.from_numpy(raw), False).numpy()
    np.testing.assert_array_equal(got, want)


def test_device_augment_random_draws_are_subwindows_and_seeded():
    raw = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (6,) + RAW).astype(np.uint8))
    fn = make_device_augment(OUT, rand_crop=1, rand_mirror=1)
    outs = [fn(raw, True, torch.Generator().manual_seed(s)).numpy()
            for s in (5, 5, 6)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    r = raw.numpy().astype(np.float32)
    for i, img in enumerate(outs[0]):
        hits = [(y, x, m) for y in range(RAW[1] - OUT[1] + 1)
                for x in range(RAW[2] - OUT[2] + 1) for m in (0, 1)
                if np.array_equal(img, (r[i, :, y:y + OUT[1], x:x + OUT[2]]
                                        [:, :, ::-1] if m else
                                        r[i, :, y:y + OUT[1], x:x + OUT[2]]))]
        assert hits, i


def test_device_augment_refuses_bad_shapes_and_offsets():
    raw = torch.zeros((2,) + RAW, dtype=torch.uint8)
    with pytest.raises(ValueError, match="crop_y_start=9"):
        make_device_augment(OUT, crop_y_start=9)(raw, False)
    with pytest.raises(ValueError, match="cannot produce"):
        make_device_augment((3, 30, 30))(raw, False)
    with pytest.raises(ValueError, match="mean image"):
        make_device_augment(OUT, mean_loader=lambda: np.zeros(
            (3, 5, 5), np.float32))(raw, False)


# ---------------------------------------------------------------------------
# through the trainer
# ---------------------------------------------------------------------------

NET = """
netconfig=start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 4
layer[1->2] = relu
layer[2->3] = lrn
  local_size = 3
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[3->4] = flatten
layer[4->5] = fullc:fc
  nhidden = 3
layer[5->5] = softmax
netconfig=end
input_shape = 3,16,15
batch_size = 6
eta = 0.1
momentum = 0.9
metric = error
seed = 4
silent = 1
dev = cpu
"""


def test_uint8_staging_end_to_end_equals_host_pipeline():
    """device_augment = 1: a uint8 batch stages as uint8, the step
    augments it on the device (deterministic spec: centre crop, a mean
    value, mirror, divideby) - the same params after two steps, bit for
    bit, as a trainer fed the host pipeline's float32 batch."""
    spec = "mean_value = 104,117,123\nmirror = 1\ndivideby = 256\n"
    rng = np.random.RandomState(2)
    raw = rng.randint(0, 256, (6,) + RAW).astype(np.uint8)
    label = rng.randint(0, 3, (6, 1)).astype(np.float32)
    host = AugmentIterator(_ListBase([
        DataInst(index=i, data=raw[i], label=label[i]) for i in range(6)]))
    for k, v in parse_config_string(spec + "input_shape = 3,16,15\n"):
        host.set_param(k, v)
    host.before_first()
    hosted = []
    while host.next():
        hosted.append(host.value().data)
    plain = NetTrainer(cfg=NET)
    plain.init_model()
    daug = NetTrainer(cfg=NET + spec + "device_augment = 1\n")
    daug.init_model()
    staged = daug.stage_batch(DataBatch(data=raw, label=label))
    assert staged.data.dtype == torch.uint8
    assert tuple(staged.data.shape) == (6,) + RAW
    for _ in range(2):
        daug.update(staged)
        plain.update(DataBatch(data=np.stack(hosted), label=label))
    for lk, d in plain.state["params"].items():
        for pn, t in d.items():
            assert torch.equal(t, daug.state["params"][lk][pn]), (lk, pn)
    ev = DataBatch(data=raw, label=label)
    assert daug.evaluate(iter_of([ev]), "t") == plain.evaluate(
        iter_of([DataBatch(data=np.stack(hosted), label=label)]), "t")


def iter_of(items):
    class It:
        def before_first(self):
            self.i = -1

        def next(self):
            self.i += 1
            return self.i < len(items)

        def value(self):
            return items[self.i]
    return It()


# (dtype, stage_dtype): stage_dtype = bfloat16 under float32 compute is
# refused at init by both packages (test_torch_config_checks)
@pytest.mark.parametrize("dtype,stage_dtype", [
    ("float32", ""), ("float32", "float32"), ("bfloat16", ""),
    ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("daug", [0, 1])
@pytest.mark.parametrize("src", ["uint8", "float32"])
def test_staged_dtype_follows_jax_host_input(dtype, stage_dtype, daug, src):
    data = np.zeros((2, 3, 4, 4), getattr(np, src))
    jt = JaxTrainer()
    pt = NetTrainer(device="cpu")
    for t in (jt, pt):
        t.set_param("dtype", dtype)
        t.set_param("stage_dtype", stage_dtype)
        t.set_param("device_augment", str(daug))
    want = np.dtype(jt._host_input(data).dtype).name
    got = str(pt._staged_dtype(data)).replace("torch.", "")
    assert got == want


# ---------------------------------------------------------------------------
# the CLI's device-augment block checks
# ---------------------------------------------------------------------------

HEAD = """
netconfig=start
layer[0->1] = flatten
layer[1->2] = fullc
  nhidden = 4
layer[2->2] = softmax
netconfig=end
input_shape = 1,6,6
batch_size = 4
eta = 0.1
dev = cpu
"""

BLOCK_CASES = {
    "divergent-eval-scale": ("train", "device_augment = 1\n", "",
                             "  scale = 0.5\n", "", ValueError),
    "divergent-eval-mean": ("train", "device_augment = 1\n", "",
                            '  image_mean = "m.bin"\n', "", ValueError),
    "block-only-device-augment": ("train", "", "",
                                  "  device_augment = 1\n", "", ValueError),
    "equivalent-spec": ("train", "device_augment = 1\nscale = 0.00390625\n",
                        "", "  mirror = 0\n  divideby = 256\n", "", None),
    "unused-eval-under-pred": ("pred", "device_augment = 1\n", "",
                               "  scale = 0.5\n", "", None),
    "divergent-pred-under-pred": ("pred", "device_augment = 1\n",
                                  "  mirror = 1\n", "", "  mirror = 0\n",
                                  None),
    "pred-block-mirror": ("pred", "device_augment = 1\n", "", "",
                          "  mirror = 1\n", None),
    "train-block-only-daug-under-pred": ("pred", "", "  device_augment = 1\n",
                                         "", "", ValueError),
}


def _conf(glob, train, ev, pred):
    return (HEAD + glob + "data = train\niter = mnist\n" + train
            + "iter = end\neval = test\niter = mnist\n" + ev
            + "iter = end\npred = out.txt\niter = mnist\n" + pred
            + "iter = end\n")


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_cli_device_augment_block_checks_match_jax(case):
    task, glob, train, ev, pred, exc = BLOCK_CASES[case]
    pairs = parse_config_string(_conf(glob, train, ev, pred))
    outcomes = []
    for mod, make in ((jax_main, "_create_net"), (port_main, "create_net")):
        t = mod.LearnTask()
        t.set_param("silent", "1")
        for k, v in pairs:
            t.set_param(k, v)
        t.set_param("task", task)
        try:
            getattr(t, make)()
            outcomes.append(None)
        except ValueError as e:
            outcomes.append((type(e), str(e)))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (exc is None)
