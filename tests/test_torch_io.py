"""The port's image data pipeline against the JAX package's, on the CPU:
decode, the BinaryPage / im2bin / imgbin_partition files, and every
iterator chain of create_iterator (img, imgbin, imgbinx, threadbuffer,
membuffer, attachtxt, the retry wrapper) with the host augmenter.

Bar: bitwise. Both packages draw from the same numpy RandomState seeds
in the same order and call the same numpy / scipy / PIL code, so every
batch (data, label, inst_index, num_batch_padd, extra_data), every
written file and the mean image they create must be equal byte for
byte. The image sets are small (12-48 pixels, 10-40 instances), written
by PIL as JPEG, PNG and binary PPM."""

import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

from cxxnet_tpu.io import create_iterator as jax_create
from cxxnet_tpu.io.iter_img import decode_image as jax_decode
from cxxnet_tpu.tools import im2bin as jax_im2bin
from cxxnet_tpu.tools import imgbin_partition as jax_part
from cxxnet_tpu.utils import binary_page as jax_bp
from cxxnet_tpu.utils import fault as jax_fault
from cxxnet_tpu.utils.config import parse_config_string
from cxxnet_tpu_torch.io import create_iterator as port_create
from cxxnet_tpu_torch.io.iter_img import ImageBinIterator
from cxxnet_tpu_torch.io.iter_img import decode_image as port_decode
from cxxnet_tpu_torch.io.iterators import shard_quota
from cxxnet_tpu_torch.tools import im2bin as port_im2bin
from cxxnet_tpu_torch.tools import imgbin_partition as port_part
from cxxnet_tpu_torch.utils import binary_page as port_bp

FORMATS = ("JPEG", "PNG", "PPM")


def encode(arr: np.ndarray, fmt: str) -> bytes:
    """(h, w, 3) uint8 -> the blob PIL writes (JPEG at quality 90; a
    (h, w) array as a gray image, PGM for "PPM")."""
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **(
        {"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def write_set(d, name, n, size, seed, label_width=1, fmts=FORMATS,
              base=100):
    """n images (size x size, a class signal plus noise) under d/name/,
    their .lst and a .bin packed by the JAX package's im2bin. Returns
    (lst, root, bin)."""
    rng = np.random.RandomState(seed)
    root = os.path.join(d, name) + "/"
    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(n):
        cls = i % 3
        arr = rng.randint(0, 200, (size, size, 3)).astype(np.uint8)
        arr[:, :, cls] = np.minimum(arr[:, :, cls] + 50, 255)
        fmt = fmts[i % len(fmts)]
        fname = f"im{i}.{fmt.lower()}"
        with open(root + fname, "wb") as f:
            f.write(encode(arr, fmt))
        labels = "\t".join(str(float(cls + k)) for k in range(label_width))
        lines.append(f"{base + i}\t{labels}\t{fname}")
    lst = os.path.join(d, name + ".lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    binp = os.path.join(d, name + ".bin")
    jax_im2bin.im2bin(lst, root, binp)
    return lst, root, binp


def batches(create, text, passes=2):
    """Every batch of `passes` passes over the chain built from `text`,
    copied (iterators may reuse their buffers)."""
    it = create(parse_config_string(text))
    it.init()
    out = []
    for _ in range(passes):
        it.before_first()
        while it.next():
            b = it.value()
            out.append((np.array(b.data), np.array(b.label),
                        None if b.inst_index is None
                        else np.array(b.inst_index), b.num_batch_padd,
                        [np.array(e) for e in b.extra_data]))
    return out


def assert_same_batches(got, want):
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            if b is None:
                assert a is None
                continue
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert g[3] == w[3]
        assert len(g[4]) == len(w[4])
        for a, b in zip(g[4], w[4]):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("imgsets"))
    out = {"d": d, "a": write_set(d, "a", 24, 20, 1),
           "lw2": write_set(d, "lw2", 13, 20, 2, label_width=2)}
    # two partitions for the image_conf_prefix template (tpl%d)
    for k in range(2):
        write_set(d, f"tpl{k}", 9, 20, 10 + k, base=200 + 100 * k)
    with open(os.path.join(d, "side.txt"), "w") as f:
        for i in range(0, 24, 2):
            f.write(f"{100 + i} {i * 0.5} {i + 1.25} 3\n")
    return out


def _block(kind, lst, root, binp, extra=""):
    src = {"img": f'image_list = "{lst}"\nimage_root = "{root}"\n',
           "imgbin": f'image_list = "{lst}"\nimage_bin = "{binp}"\n',
           "imgbinx": f'image_list = "{lst}"\nimage_bin = "{binp}"\n'}
    # use_native = 0: the JAX package's Python decode (PIL), also where
    # its native library is built; the port has only this path
    return f"iter = {kind}\n{src[kind]}silent = 1\nuse_native = 0\n{extra}"


# (iterator, block keys, what is chained over it). The imgbin chains
# with round_batch = 0 take batch sizes that divide the set: the JAX
# package's Python imgbin path blocks on a next() after the end of a
# pass, which a zero-padded tail asks for (the port's does not:
# test_imgbin_zero_padded_tail_ends_the_pass)
CHAINS = {
    "img-shuffle-rb1": ("img", "shuffle = 1\nseed_data = 5\n"
                        "round_batch = 1\nbatch_size = 7\n"
                        "input_shape = 3,16,16\nrand_crop = 1\n"
                        "rand_mirror = 1\n", ""),
    "img-rb0": ("img", "batch_size = 5\ninput_shape = 3,16,16\n", ""),
    "imgbin-shuffle-rb1": ("imgbin", "shuffle = 1\nseed_data = 3\n"
                           "round_batch = 1\nbatch_size = 7\n"
                           "input_shape = 3,20,20\n", ""),
    "imgbin-rb0-crop": ("imgbin", "round_batch = 0\nbatch_size = 6\n"
                        "input_shape = 3,14,12\ncrop_y_start = 2\n"
                        "crop_x_start = 5\nmirror = 1\n", ""),
    "imgbinx-shuffle": ("imgbinx", "shuffle = 1\nbatch_size = 6\n"
                        "input_shape = 3,18,18\nrand_crop = 1\n"
                        "decode_threads = 2\n", ""),
    "imgbin-threadbuffer": ("imgbin", "shuffle = 1\nseed_data = 9\n"
                            "batch_size = 4\ninput_shape = 3,16,16\n"
                            "rand_mirror = 1\n",
                            "iter = threadbuffer\nbuffer_size = 1\n"),
    "imgbin-membuffer": ("imgbin", "shuffle = 1\nbatch_size = 4\n"
                         "input_shape = 3,16,16\nrand_crop = 1\n",
                         "iter = membuffer\nmax_nbatch = 2\n"),
    "imgbin-attachtxt": ("imgbin", "batch_size = 5\nround_batch = 1\n"
                         "input_shape = 3,16,16\n",
                         'iter = attachtxt\nfilename = "{side}"\n'),
    "imgbin-skipread": ("imgbin", "batch_size = 4\ntest_skipread = 1\n"
                        "input_shape = 3,16,16\n", ""),
    "imgbin-decode-threads-0-retry": ("imgbin", "batch_size = 8\n"
                                   "decode_threads = 0\nio_retry = 2\n"
                                   "input_shape = 3,16,16\n", ""),
}


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_iterator_chains_match_jax_bitwise(sets, case):
    kind, keys, chain = CHAINS[case]
    lst, root, binp = sets["a"]
    side = os.path.join(sets["d"], "side.txt")
    text = (_block(kind, lst, root, binp, keys)
            + chain.format(side=side) + "iter = end\n")
    if case == "imgbin-skipread":
        # test_skipread serves the first batch forever: take 3 of them
        got, want = [], []
        for create, out in ((port_create, got), (jax_create, want)):
            it = create(parse_config_string(text))
            it.init()
            it.before_first()
            for _ in range(3):
                assert it.next()
                out.append((np.array(it.value().data),
                            np.array(it.value().label),
                            np.array(it.value().inst_index), 0, []))
        assert_same_batches(got, want)
        return
    assert_same_batches(batches(port_create, text),
                        batches(jax_create, text))


def test_imgbin_zero_padded_tail_ends_the_pass(sets):
    """imgbin with round_batch = 0 and a short tail: the port's pass
    ends after the zero-padded batch, and its batches are the JAX
    package's `img` batches over the same files (same order, same
    decode)."""
    lst, root, binp = sets["a"]
    keys = "batch_size = 5\ninput_shape = 3,16,16\n"
    got = batches(port_create, _block("imgbin", lst, root, binp, keys)
                  + "iter = end\n")
    assert len(got) == 10 and got[4][3] == 1
    assert_same_batches(got, batches(jax_create, _block(
        "img", lst, root, binp, keys) + "iter = end\n"))


def test_label_width_2_matches_jax(sets):
    lst, root, binp = sets["lw2"]
    text = _block("imgbin", lst, root, binp,
                  "label_width = 2\nbatch_size = 4\nround_batch = 1\n"
                  "shuffle = 1\ninput_shape = 3,20,20\n") + "iter = end\n"
    got = batches(port_create, text)
    assert got[0][1].shape == (4, 2)
    assert_same_batches(got, batches(jax_create, text))


def test_image_conf_prefix_template_matches_jax(sets):
    d = sets["d"]
    text = (f'iter = imgbinx\nimage_conf_prefix = "{d}/tpl%d"\n'
            "image_conf_ids = 0-1\nsilent = 1\nshuffle = 1\nuse_native = 0\n"
            "seed_data = 4\nbatch_size = 5\nround_batch = 1\n"
            "input_shape = 3,16,16\nrand_crop = 1\niter = end\n")
    got = batches(port_create, text)
    # 18 instances from the two .bin files: 4 batches, the last one
    # filled by wrapping round
    assert got[3][3] == 2 and len({int(i) for b in got[:4]
                                   for i in b[2]}) == 18
    assert_same_batches(got, batches(jax_create, text))


def test_instance_sharding_matches_jax(sets):
    """The imgbin iterator's instance-level quota, held to the JAX
    package's: each worker of a data-parallel job reads its shard."""
    from cxxnet_tpu.io.iter_img import ImageBinIterator as JaxBin
    lst, root, binp = sets["a"]
    assert shard_quota(24, 5, 2) == (4, 2)
    for rank in range(5):
        outs = []
        for cls in (ImageBinIterator, JaxBin):
            it = cls()
            for k, v in (("image_list", lst), ("image_bin", binp),
                         ("silent", "1"), ("dist_num_worker", "5"),
                         ("use_native", "0"),
                         ("dist_worker_rank", str(rank)),
                         ("shuffle", "1")):
                it.set_param(k, v)
            it.init()
            got = []
            while it.next():
                got.append((it.value().index, it.value().data.copy()))
            outs.append(got)
        assert len(outs[0]) == 4
        assert [i for i, _ in outs[0]] == [i for i, _ in outs[1]]
        for (_, a), (_, b) in zip(*outs):
            np.testing.assert_array_equal(a, b)


def test_native_route_takes_only_its_ranks_records(sets):
    """The native reader's route (use_native = 1; on the CPU its plain
    version, PlainBinReader, which the nvJPEG reader shares the
    ordinal filter with) serves each rank exactly the records the
    Python path serves it: the shards are disjoint, each holds the
    quota, and the images are the same."""
    lst, root, binp = sets["a"]
    seen = []
    for rank in range(5):
        outs = []
        for native in ("1", "0"):
            it = ImageBinIterator(device="cpu")
            for k, v in (("image_list", lst), ("image_bin", binp),
                         ("silent", "1"), ("dist_num_worker", "5"),
                         ("use_native", native),
                         ("dist_worker_rank", str(rank))):
                it.set_param(k, v)
            it.init()
            got = []
            while it.next():
                got.append((it.value().index, it.value().data.copy()))
            outs.append(got)
        assert [i for i, _ in outs[0]] == [i for i, _ in outs[1]]
        assert len(outs[0]) == 4
        for (_, a), (_, b) in zip(*outs):
            np.testing.assert_array_equal(a, b)
        seen.extend(i for i, _ in outs[0])
    assert len(set(seen)) == len(seen) == 20


def test_io_retry_absorbs_a_transient_read_error(sets, monkeypatch):
    """io_retry: a read error (OSError) on the 3rd next() of the chain
    under the retry wrapper is retried; both packages, the error
    injected at the same point (the JAX package's io.next fault point
    fires inside the retried call, before the chain's next()), give
    the same batches."""
    lst, root, binp = sets["a"]
    text = _block("imgbin", lst, root, binp,
                  "batch_size = 4\nio_retry = 3\nio_retry_backoff = 0\n"
                  "input_shape = 3,16,16\nshuffle = 1\n") + "iter = end\n"
    jax_fault.clear()
    jax_fault.inject("io.next", "ioerror", at=3)
    try:
        want = batches(jax_create, text, passes=1)
    finally:
        jax_fault.clear()
    it = port_create(parse_config_string(text))
    inner = it.inner
    calls = {"n": 0}
    real_next = inner.next

    def flaky():
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("transient read error")
        return real_next()

    monkeypatch.setattr(inner, "next", flaky)
    it.init()
    got = []
    it.before_first()
    while it.next():
        b = it.value()
        got.append((np.array(b.data), np.array(b.label),
                    np.array(b.inst_index), b.num_batch_padd, []))
    assert calls["n"] > 3
    assert_same_batches(got, want)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _blob(fmt, seed=0, shape=(13, 17)):
    rng = np.random.RandomState(seed)
    if fmt == "PGM":
        return encode(rng.randint(0, 256, shape).astype(np.uint8), "PPM")
    return encode(rng.randint(0, 256, shape + (3,)).astype(np.uint8), fmt)


@pytest.mark.parametrize("fmt", ["PPM", "PGM", "PNG", "JPEG"])
def test_decode_matches_jax_bitwise(fmt):
    blob = _blob(fmt)
    got, want = port_decode(blob), jax_decode(blob)
    assert got.dtype == np.uint8 and got.shape == want.shape == (3, 13, 17)
    np.testing.assert_array_equal(got, want)


def test_pnm_header_comments_and_odd_whitespace():
    pix = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    blob = b"P6\n# a comment\n3  2\n#x\n255\n" + pix.tobytes()
    np.testing.assert_array_equal(port_decode(blob), jax_decode(blob))
    with pytest.raises(ValueError, match="truncated PNM raster"):
        port_decode(blob[:-1])


def test_decode_without_pillow(monkeypatch):
    """P6 / P5 decode with numpy alone; any other format names Pillow
    and the blob's format."""
    ppm, pgm, jpg = _blob("PPM"), _blob("PGM"), _blob("JPEG")
    want = port_decode(ppm), port_decode(pgm)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(port_decode(ppm), want[0])
    np.testing.assert_array_equal(port_decode(pgm), want[1])
    with pytest.raises(ImportError, match=r"\(JPEG\) needs Pillow"):
        port_decode(jpg)


# ---------------------------------------------------------------------------
# file formats
# ---------------------------------------------------------------------------

def test_binary_page_files_cross_both_ways(tmp_path):
    rng = np.random.RandomState(3)
    blobs = [rng.bytes(int(n)) for n in rng.randint(1, 5000, 40)]
    paths = {}
    for name, bp in (("jax", jax_bp), ("port", port_bp)):
        paths[name] = str(tmp_path / f"{name}.bin")
        with open(paths[name], "wb") as fo:
            w = bp.BinaryPageWriter(fo)
            for b in blobs:
                w.push(b)
            w.close()
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    for reader in (jax_bp, port_bp):
        for name in paths:
            with open(paths[name], "rb") as fi:
                got = [x for page in reader.iter_page_blobs(fi) for x in page]
            assert got == blobs


def test_im2bin_and_partition_outputs_are_byte_equal(sets, tmp_path):
    lst, root, binp = sets["a"]
    out = str(tmp_path / "port.bin")
    assert port_im2bin.im2bin(lst, root, out) == 24
    with open(out, "rb") as a, open(binp, "rb") as b:
        assert a.read() == b.read()
    for mode in ("contiguous", "roundrobin"):
        for name, mod in (("jax", jax_part), ("port", port_part)):
            mod.make_partitions(lst, root, str(tmp_path / f"{name}{mode}"),
                                3, mode, pack=True)
        for i in range(3):
            for ext in ("lst", "bin"):
                with open(tmp_path / f"jax{mode}.{i}.{ext}", "rb") as a, \
                        open(tmp_path / f"port{mode}.{i}.{ext}", "rb") as b:
                    assert a.read() == b.read()
    port_part.make_partitions(lst, root, str(tmp_path / "mk"), 2,
                              makefile=True)
    with open(tmp_path / "mk.mk") as f:
        assert "python -m cxxnet_tpu_torch.tools.im2bin" in f.read()
