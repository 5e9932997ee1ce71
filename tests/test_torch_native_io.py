"""The port's native image decoder path (`use_native`, io/native.py) on
the CPU: `PlainBinReader`, the plain version of the nvJPEG reader,
against the JAX package's `NativeBinReader` (native/cxxnet_io.cc:
libjpeg and libpng) on the same .bin files, and the port's imgbin
iterator under use_native = 1 on `device = "cpu"` against the JAX
package's use_native = 1 iterator; then the routing table of
io/iter_img.py and its refusals.

Bar: bitwise. PNG and PPM decode through the same PIL / numpy code in
both packages (the JAX library hands PPM back raw to PIL and decodes
PNG with libpng, which gives PIL's bytes); this machine's libjpeg and
PIL's give the same JPEG bytes too. Records, shuffled label orders and
batches must be equal. Tests of the JAX reader skip where its library
is not built, as tests/test_native_io.py does. The nvJPEG reader itself
runs only on the card (tests/test_torch_cuda.py).
"""

import io
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image

from cxxnet_tpu.io import create_iterator as jax_create
from cxxnet_tpu.io.native import NativeBinReader as JaxReader
from cxxnet_tpu.io.native import native_available
from cxxnet_tpu.tools import im2bin as jax_im2bin
from cxxnet_tpu.utils.config import parse_config_string
from cxxnet_tpu_torch import kernels
from cxxnet_tpu_torch.io import create_iterator as port_create
from cxxnet_tpu_torch.io import native as port_native
from cxxnet_tpu_torch.io.iter_img import ImageBinIterator
from cxxnet_tpu_torch.io.native import (FACTORS, JPEG_KINDS,
                                        NativeBinReader, PlainBinReader,
                                        encode_jpeg, ycc_to_rgb)
from cxxnet_tpu_torch.utils import binary_page as port_bp

FORMATS = ("JPEG", "PNG", "PPM")


@pytest.fixture
def jax_native():
    if not native_available():
        pytest.skip("the JAX package's native io library is not built")


def encode(arr: np.ndarray, fmt: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **(
        {"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def write_bin(d, name, n, size, seed, fmts=FORMATS, blobs=None):
    """n size x size images (noise plus a class channel) in `fmts` by
    turns, their .lst and the .bin packed by the JAX package's im2bin;
    `blobs` (name -> bytes) replaces an image's file. Returns (lst, bin,
    labels)."""
    rng = np.random.RandomState(seed)
    root = os.path.join(d, name) + "/"
    os.makedirs(root, exist_ok=True)
    lines, labels = [], []
    for i in range(n):
        cls = i % 5
        arr = rng.randint(0, 200, (size, size, 3)).astype(np.uint8)
        arr[:, :, cls % 3] = np.minimum(arr[:, :, cls % 3] + 50, 255)
        fmt = fmts[i % len(fmts)]
        fname = f"im{i}.{fmt.lower()}"
        with open(root + fname, "wb") as f:
            f.write((blobs or {}).get(fname) or encode(arr, fmt))
        lines.append(f"{i}\t{cls}\t{fname}")
        labels.append(cls)
    lst = os.path.join(d, name + ".lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    binp = os.path.join(d, name + ".bin")
    jax_im2bin.im2bin(lst, root, binp)
    return lst, binp, labels


def drain(reader, passes=1):
    out = []
    for _ in range(passes):
        reader.before_first()
        while True:
            rec = reader.next()
            if rec is None:
                break
            out.append(rec)
    reader.close()
    return out


def assert_same_records(got, want):
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("out_mode", [1, 2])
@pytest.mark.parametrize("fmts", [("PNG",), ("PPM",), ("JPEG",), FORMATS],
                         ids=["png", "ppm", "jpeg", "mixed"])
def test_plain_reader_matches_jax_native(tmp_path, jax_native, fmts,
                                         out_mode):
    _, binp, _ = write_bin(str(tmp_path), "s", 14, 24, 3, fmts)
    got = drain(PlainBinReader([binp], n_threads=3, out_mode=out_mode))
    want = drain(JaxReader([binp], n_threads=3, out_mode=out_mode))
    assert got[0].dtype == (np.uint8 if out_mode == 2 else np.float32)
    assert_same_records(got, want)


@pytest.mark.parametrize("kind", JPEG_KINDS + ("cmyk",))
def test_plain_reader_matches_jax_native_on_every_jpeg_kind(tmp_path,
                                                            jax_native,
                                                            kind):
    """Each JPEG kind the nvJPEG decoder takes (and CMYK, which the JAX
    library hands back raw, as the port's does) decodes in PlainBinReader
    as in the JAX package's reader, bitwise."""
    rng = np.random.RandomState(JPEG_KINDS.index(kind) if kind in
                                JPEG_KINDS else 99)
    blobs = {}
    for i in range(6):
        arr = rng.randint(0, 256, (32 + 8 * i, 48, 3)).astype(np.uint8)
        if kind == "cmyk":
            buf = io.BytesIO()
            Image.fromarray(arr).convert("CMYK").save(buf, format="JPEG",
                                                      quality=90)
            blobs[f"im{i}.jpeg"] = buf.getvalue()
        else:
            blobs[f"im{i}.jpeg"] = encode_jpeg(arr, kind)
    _, binp, _ = write_bin(str(tmp_path), "s", 6, 8, 4, ("JPEG",), blobs)
    got = drain(PlainBinReader([binp], n_threads=2, out_mode=2))
    want = drain(JaxReader([binp], n_threads=2, out_mode=2))
    assert [g.shape for g in got] == [(3, 32 + 8 * i, 48) for i in range(6)]
    assert_same_records(got, want)


@pytest.mark.parametrize("threads", [1, 4])
def test_plain_reader_decode_threads(tmp_path, jax_native, threads):
    _, binp, _ = write_bin(str(tmp_path), "s", 21, 16, 5)
    got = drain(PlainBinReader([binp], n_threads=threads, max_inflight=5))
    want = drain(JaxReader([binp], n_threads=threads, max_inflight=5))
    assert_same_records(got, want)


def test_plain_reader_order_under_contention(tmp_path):
    """Stream order with four decode threads a core, a window of 3 and
    the interpreter switching threads as often as it can: records of 40
    distinct sizes come back in order, pass after pass."""
    import sys
    from cxxnet_tpu_torch.utils.binary_page import BinaryPageWriter
    rng = np.random.RandomState(12)
    binp = str(tmp_path / "order.bin")
    with open(binp, "wb") as f:
        w = BinaryPageWriter(f)
        for i in range(40):
            w.push(encode(rng.randint(0, 255, (8 + i, 40 - i, 3)).astype(
                np.uint8), ("PNG", "PPM", "JPEG")[i % 3]))
        w.close()
    keep = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = drain(PlainBinReader([binp], n_threads=4 * (os.cpu_count()
                                                          or 1),
                                   max_inflight=3), passes=3)
    finally:
        sys.setswitchinterval(keep)
    assert [g.shape for g in got] == [(3, 8 + i, 40 - i)
                                      for i in range(40)] * 3


def test_plain_reader_restart(tmp_path, jax_native):
    _, binp, _ = write_bin(str(tmp_path), "s", 5, 12, 7)
    got = drain(PlainBinReader([binp]), passes=3)
    want = drain(JaxReader([binp]), passes=3)
    assert len(got) == 15
    assert_same_records(got, want)


def test_plain_reader_multi_bin(tmp_path, jax_native):
    _, b1, _ = write_bin(str(tmp_path), "a", 3, 12, 8)
    _, b2, _ = write_bin(str(tmp_path), "b", 4, 12, 9)
    got = drain(PlainBinReader([b1, b2]))
    want = drain(JaxReader([b1, b2]))
    assert len(got) == 7
    assert_same_records(got, want)


@pytest.mark.parametrize("make", [JaxReader, PlainBinReader],
                         ids=["jax", "port"])
def test_missing_file_raises(tmp_path, jax_native, make):
    r = make([str(tmp_path / "nope.bin")])
    r.before_first()
    with pytest.raises(IOError, match="cannot open"):
        r.next()
    r.close()


def _damage(path, how):
    with open(path, "r+b") as f:
        if how == "truncated page":
            f.truncate(port_bp.K_PAGE_SIZE - 1)
        elif how == "corrupt page header":
            f.write(np.int32(-1).tobytes())
        else:  # corrupt blob offsets: the first blob ends past the page
            f.seek(8)
            f.write(np.int32(port_bp.K_PAGE_SIZE + 1).tobytes())


@pytest.mark.parametrize("how", ["truncated page", "corrupt page header",
                                 "corrupt blob offsets"])
def test_damaged_page_raises_as_the_native_reader(tmp_path, jax_native, how):
    _, binp, _ = write_bin(str(tmp_path), "s", 3, 12, 4)
    _damage(binp, how)
    for make in (JaxReader, PlainBinReader):
        r = make([binp])
        r.before_first()
        with pytest.raises(IOError, match=how):
            while r.next() is not None:
                pass
        r.close()


def test_truncated_jpeg_surfaces_the_host_decoders_error(tmp_path,
                                                         jax_native):
    """A JPEG cut inside its headers: libjpeg (and, on the card, nvJPEG)
    hands it back raw and PIL's error surfaces at that record."""
    arr = np.random.RandomState(2).randint(0, 150, (64, 64, 3)).astype(
        np.uint8)
    cut = {"im1.jpeg": encode(arr, "JPEG")[:300]}
    _, binp, _ = write_bin(str(tmp_path), "s", 3, 64, 2, ("JPEG",), cut)
    for make in (JaxReader, PlainBinReader):
        r = make([binp], n_threads=2)
        r.before_first()
        assert r.next().shape == (3, 64, 64)
        with pytest.raises(OSError, match="Truncated File Read"):
            r.next()
        r.close()


def _imgbin(lst, binp, extra=""):
    return (f'iter = imgbin\nimage_list = "{lst}"\nimage_bin = "{binp}"\n'
            f"use_native = 1\nsilent = 1\n{extra}")


def _labels_and_batches(it):
    it.before_first()
    labels, data = [], []
    while it.next():
        b = it.value()
        labels.extend(int(v) for v in b.label[:, 0])
        data.append((np.array(b.data), np.array(b.label),
                     np.array(b.inst_index)))
    return labels, data


@pytest.mark.parametrize("shuffle", [0, 1])
def test_imgbin_use_native_matches_jax(tmp_path, jax_native, shuffle):
    """The whole chain under use_native = 1: the port on the CPU
    (PlainBinReader) against the JAX package (its native library),
    batch for batch, with the host augmenter's crop and mirror."""
    lst, binp, _ = write_bin(str(tmp_path), "s", 30, 20, 6)
    text = _imgbin(lst, binp, f"shuffle = {shuffle}\nshuffle_buffer = 7\n"
                   "rand_crop = 1\nrand_mirror = 1\ninput_shape = 3,16,16\n"
                   "batch_size = 8\nround_batch = 1\n")
    port = port_create(parse_config_string(text), device="cpu")
    port.init()
    jax = jax_create(parse_config_string(text))
    jax.init()
    for _ in range(2):
        (pl, pd), (jl, jd) = _labels_and_batches(port), \
            _labels_and_batches(jax)
        assert pl == jl
        assert len(pd) == len(jd) == 4
        for a, b in zip(pd, jd):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_shuffled_label_order_follows_device_augment(tmp_path, jax_native):
    """The reservoir's cap divides 64 MiB by a record's bytes: float32
    records (device_augment = 0) of 128 x 128 cap it at 341, uint8
    records (device_augment = 1) at the shuffle_buffer of 1,024, so a
    400-image pass shuffles differently in the two modes - in both
    packages alike."""
    lst, binp, _ = write_bin(str(tmp_path), "s", 400, 128, 11, ("JPEG",))
    orders = {}
    for daug in (0, 1):
        text = _imgbin(lst, binp, f"shuffle = 1\ndevice_augment = {daug}\n"
                       "input_shape = 3,128,128\nbatch_size = 100\n")
        got = []
        for create, kw in ((port_create, {"device": "cpu"}),
                           (jax_create, {})):
            it = create(parse_config_string(text), **kw)
            it.init()
            labels, data = _labels_and_batches(it)
            got.append((labels, [d[2] for d in data]))
            assert data[0][0].dtype == (np.uint8 if daug else np.float32)
        assert got[0][0] == got[1][0]
        for a, b in zip(got[0][1], got[1][1]):
            np.testing.assert_array_equal(a, b)
        orders[daug] = got[0][1]
    assert any((a != b).any() for a, b in zip(orders[0], orders[1]))


# ---------------------------------------------------------------------------
# YccToRgb's arithmetic: its plain version against libjpeg's own
# ---------------------------------------------------------------------------

# libjpeg's decode stopped before the upsampling: the planes of a JPEG
# after its IDCT as coded (Y, Cb, Cr; R, G, B; or a grayscale Y), at their
# subsampled sizes (raw_data_out), written as int32 w, h, cw, ch (0, 0 for
# one component) then the planes
RAWDEC_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>
int main(int argc, char **argv) {
  FILE *f = fopen(argv[1], "rb"), *o = fopen(argv[2], "wb");
  struct jpeg_decompress_struct c; struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e); jpeg_create_decompress(&c);
  jpeg_stdio_src(&c, f); jpeg_read_header(&c, TRUE);
  c.raw_data_out = TRUE; c.out_color_space = c.jpeg_color_space;
  jpeg_start_decompress(&c);
  int nc = c.num_components, pw[3], ph[3], done = 0; unsigned char *pl[3];
  for (int k = 0; k < nc; k++) {
    pw[k] = c.comp_info[k].width_in_blocks * 8;
    ph[k] = c.comp_info[k].height_in_blocks * 8 + 64;
    pl[k] = calloc((size_t)pw[k] * ph[k], 1);
  }
  int dims[4] = {(int)c.image_width, (int)c.image_height,
                 nc == 3 ? (int)c.comp_info[1].downsampled_width : 0,
                 nc == 3 ? (int)c.comp_info[1].downsampled_height : 0};
  fwrite(dims, 4, 4, o);
  while (c.output_scanline < c.output_height) {
    JSAMPROW rows[3][32]; JSAMPARRAY bufs[3];
    for (int k = 0; k < nc; k++) {
      int v = c.comp_info[k].v_samp_factor * 8;
      int at = done * c.comp_info[k].v_samp_factor;
      for (int r = 0; r < v; r++)
        rows[k][r] = pl[k] + (size_t)(at + r) * pw[k];
      bufs[k] = rows[k];
    }
    jpeg_read_raw_data(&c, bufs, c.max_v_samp_factor * 8);
    done += 8;
  }
  int w[3] = {dims[0], dims[2], dims[2]}, h[3] = {dims[1], dims[3], dims[3]};
  for (int k = 0; k < nc; k++)
    for (int r = 0; r < h[k]; r++)
      fwrite(pl[k] + (size_t)r * pw[k], 1, w[k], o);
  fclose(o);
  jpeg_finish_decompress(&c); jpeg_destroy_decompress(&c);
  return 0;
}
"""


@pytest.fixture(scope="module")
def rawdec(tmp_path_factory):
    """The libjpeg plane dumper, compiled here; skips where no C compiler
    and libjpeg headers are installed."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler to build the libjpeg plane dumper")
    d = tmp_path_factory.mktemp("rawdec")
    (d / "rawdec.c").write_text(RAWDEC_C)
    exe = str(d / "rawdec")
    out = subprocess.run([cc, "-O2", str(d / "rawdec.c"), "-o", exe,
                          "-ljpeg"], capture_output=True, text=True)
    if out.returncode != 0:
        pytest.skip(f"libjpeg headers or library missing: {out.stderr}")
    return exe


@pytest.mark.parametrize("sub", JPEG_KINDS)
@pytest.mark.parametrize("h,w", [(48, 64), (37, 53), (1, 9), (17, 2),
                                 (3, 4), (2, 5), (9, 1)])
def test_ycc_to_rgb_plain_is_libjpegs_arithmetic(rawdec, tmp_path, sub, h,
                                                 w):
    """libjpeg's planes after its IDCT through ycc_to_rgb's plain version
    give PIL's decode of the JPEG bitwise, for every kind the decoder
    takes: the upsampling (edges, odd sizes, both biases, replication
    where libjpeg replicates), the colour tables and the R, G, B and
    grayscale codings are libjpeg's, so the card's YccToRgb, held to this
    plain version bitwise there, adds no error of its own."""
    arr = np.random.RandomState(h * w + JPEG_KINDS.index(sub)).randint(
        0, 256, (h, w, 3)).astype(np.uint8)
    blob = encode_jpeg(arr, sub)
    (tmp_path / "a.jpg").write_bytes(blob)
    subprocess.run([rawdec, str(tmp_path / "a.jpg"), str(tmp_path / "a.raw")],
                   check=True)
    raw = (tmp_path / "a.raw").read_bytes()
    pw, ph, cw, ch = np.frombuffer(raw[:16], np.int32)
    assert (pw, ph) == (w, h)
    y = torch.from_numpy(np.frombuffer(raw, np.uint8, w * h, 16).reshape(
        h, w).copy())
    if sub == "gray":
        got = ycc_to_rgb(y, None, None, 1, 1, port_native.GRAY)
    else:
        cb, cr = (torch.from_numpy(np.frombuffer(
            raw, np.uint8, cw * ch, 16 + w * h + k * cw * ch).reshape(
                ch, cw).copy()) for k in (0, 1))
        hf, vf = FACTORS["4:4:4" if sub == "rgb" else sub]
        assert (cw, ch) == (-(-w // hf), -(-h // vf))
        got = ycc_to_rgb(y, cb, cr, hf, vf, port_native.RGB if sub == "rgb"
                         else port_native.YCC)
    want = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
    np.testing.assert_array_equal(got.numpy(), want.transpose(2, 0, 1))


def test_ycc_to_rgb_refuses_what_it_cannot_take():
    y = torch.zeros(8, 9, dtype=torch.uint8)
    c = torch.zeros(4, 5, dtype=torch.uint8)
    assert ycc_to_rgb(y, c, c, 2, 2).shape == (3, 8, 9)
    assert ycc_to_rgb(y, None, None, 1, 1, port_native.GRAY).shape == (
        3, 8, 9)
    with pytest.raises(ValueError, match="luma plane"):
        ycc_to_rgb(y, c, c, 2, 1)
    with pytest.raises(ValueError, match="FACTORS only"):
        ycc_to_rgb(y, c, c, 4, 2)
    with pytest.raises(ValueError, match="none for GRAY"):
        ycc_to_rgb(y, c, c, 1, 1, port_native.GRAY)
    with pytest.raises(ValueError, match="none for GRAY"):
        ycc_to_rgb(y, None, None, 1, 1)
    with pytest.raises(ValueError, match="coding 3"):
        ycc_to_rgb(y, c, c, 2, 2, 3)
    with pytest.raises(ValueError, match="uint8"):
        ycc_to_rgb(y.float(), c, c, 2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ycc_to_rgb(y, c.t().contiguous().t(), c, 2, 2)


# ---------------------------------------------------------------------------
# the routing table of io/iter_img.py and its refusals
# ---------------------------------------------------------------------------

def _base(it):
    """The ImageBinIterator at the bottom of a create_iterator chain."""
    while not isinstance(it, ImageBinIterator):
        it = getattr(it, "inner", None) or it.base
    return it


@pytest.fixture
def small_bin(tmp_path):
    lst, binp, _ = write_bin(str(tmp_path), "s", 6, 12, 1, ("PNG",))
    return lst, binp


@pytest.mark.parametrize("use_native,device,route", [
    (-1, "cpu", "python"), (0, "cpu", "python"), (1, "cpu", "plain"),
    (-1, None, "python"), (0, None, "python"), (0, "cuda:0", "python")])
def test_use_native_routes(small_bin, capsys, use_native, device, route):
    lst, binp = small_bin
    text = _imgbin(lst, binp, "silent = 0\ninput_shape = 3,12,12\n"
                   "batch_size = 3\n").replace(
                       "use_native = 1", f"use_native = {use_native}")
    it = port_create(parse_config_string(text), device=device)
    it.init()
    base = _base(it)
    assert base._native_mode == (route != "python")
    mode = "python" if route == "python" else "native"
    assert f"({mode} decode)" in capsys.readouterr().out
    if route == "plain":
        assert isinstance(base._native, PlainBinReader)
    assert sum(b.data.shape[0] for b in it) == 6


def test_use_native_1_with_no_device_and_no_card_raises(small_bin,
                                                        monkeypatch):
    """No device given: use_native = 1 means the card, and with none the
    iterator raises naming device="cpu" instead of decoding on the
    host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lst, binp = small_bin
    it = port_create(parse_config_string(_imgbin(lst, binp)))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        it.init()


@pytest.mark.parametrize("use_native,device", [(-1, "cuda:0"),
                                               (1, "cuda:0"), (1, None)])
def test_card_routes_reach_the_decoder_and_never_fall_back(
        small_bin, monkeypatch, use_native, device):
    """On the card -1 and 1 (and 1 with no device) take nvJPEG: a decoder
    that does not build or load raises naming use_native = 0; nothing
    takes the PIL path silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def broken(name):
        assert name == "nvjpeg_decode"
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    monkeypatch.setattr(kernels, "load", broken)
    lst, binp = small_bin
    text = _imgbin(lst, binp).replace("use_native = 1",
                                      f"use_native = {use_native}")
    it = port_create(parse_config_string(text), device=device)
    with pytest.raises(RuntimeError, match="use_native = 0") as err:
        it.init()
    assert "nvcc not found" in str(err.value)


def test_native_reader_load_failure_names_use_native_0(small_bin,
                                                       monkeypatch):
    def broken(name):
        raise OSError("libnvjpeg.so.12: cannot open shared object file")
    monkeypatch.setattr(kernels, "load", broken)
    with pytest.raises(RuntimeError, match="set use_native = 0"):
        NativeBinReader([small_bin[1]], device="cuda:0")
    with pytest.raises(RuntimeError, match="use_native = 0"):
        port_native.decoder_facts()


def test_readers_refuse_other_out_modes(small_bin):
    for mode in (0, 3):
        with pytest.raises(ValueError, match="out_mode"):
            PlainBinReader([small_bin[1]], out_mode=mode)
        with pytest.raises(ValueError, match="out_mode"):
            NativeBinReader([small_bin[1]], out_mode=mode)


def test_decoder_counts_and_flags(monkeypatch):
    """The decoder is a registered library that keeps its own counts (its
    kernel's launches, the raw hand-backs apart): they read 0 while it is
    not loaded, without loading it; once it is, launches() and
    raw_handbacks() read them from it, check() adds nothing of its own
    and reset_launches() zeroes them there. nvjpeg's link flags go only
    on its own source (they go into its library's digest)."""
    assert kernels.SOURCES["nvjpeg_decode"] == "nvjpeg_io.cu"
    kernels.reset_launches()
    assert kernels.launches()["nvjpeg_decode"] == 0
    assert kernels.raw_handbacks() == 0
    assert "nvjpeg_decode" not in kernels._libs

    class Library:  # the library's counter ABI
        counts = [7, 2]

        def cxio_counters(self, out):
            out[0], out[1] = self.counts

        def cxio_reset_counters(self):
            self.counts = [0, 0]
    monkeypatch.setitem(kernels._libs, "nvjpeg_decode", Library())
    kernels.check("nvjpeg_decode", 0)
    assert kernels.launches()["nvjpeg_decode"] == 7
    assert kernels.raw_handbacks() == 2
    kernels.reset_launches()
    assert kernels.launches()["nvjpeg_decode"] == 0
    assert kernels.raw_handbacks() == 0
    assert kernels.source_flags("lrn_fwd") == kernels.NVCC_FLAGS


def test_bench_io_runs_both_paths_on_the_cpu(capsys):
    """tools/bench_io.py streams its set through use_native = 0 and 1 (on
    the CPU: PlainBinReader) and reports both rates."""
    from cxxnet_tpu_torch.tools import bench_io
    assert bench_io.main(["24", "16", "2", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("python decode: ")
    assert out[1].startswith("native decode (PIL in the native path's "
                             "order, 2 threads, cpu): ")
