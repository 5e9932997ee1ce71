"""BinaryPage: the fixed-size packed-blob page format of imgbin datasets
(own copy of cxxnet_tpu/utils/binary_page.py; the two write and read the
same bytes).

Byte-compatible with the reference format (src/utils/io.h:254-326):

- A page is exactly 64 MiB (``4 * (64 << 18)`` bytes), zero-initialized.
- ``int32[0]`` = number of objects N.
- ``int32[1..N+1]`` = cumulative end offsets; object r occupies the byte
  range ``[page_size - off[r+1], page_size - off[r])`` counted from the
  page start, i.e. blobs are packed backwards from the end of the page.
- A page file (.bin) is a plain concatenation of such pages.

`iter_page_blobs` is the Python imgbin path's reader; `read_bin_blobs`
is the plain version of the native decoder's page reader
(csrc/nvjpeg_io.cu, the counterpart of native/cxxnet_io.cc's
ReaderMain), with its checks and messages.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, List, Optional, Sequence

# 64 << 18 int32 slots = 64 MiB
K_PAGE_NUM_INTS = 64 << 18
K_PAGE_SIZE = 4 * K_PAGE_NUM_INTS


class BinaryPage:
    """One fixed 64MiB page holding a stack of binary blobs."""

    def __init__(self, buf: Optional[bytearray] = None):
        if buf is None:
            buf = bytearray(K_PAGE_SIZE)
        if len(buf) != K_PAGE_SIZE:
            raise ValueError("BinaryPage buffer must be exactly 64MiB")
        self._buf = buf

    def clear(self) -> None:
        self._buf[:] = bytes(K_PAGE_SIZE)

    def _get_int(self, i: int) -> int:
        return struct.unpack_from("<i", self._buf, 4 * i)[0]

    def _set_int(self, i: int, v: int) -> None:
        struct.pack_into("<i", self._buf, 4 * i, v)

    @property
    def size(self) -> int:
        return self._get_int(0)

    def _free_bytes(self) -> int:
        n = self.size
        return (K_PAGE_NUM_INTS - (n + 2)) * 4 - self._get_int(n + 1)

    def push(self, blob: bytes) -> bool:
        """Append a blob; returns False when the page is full."""
        if self._free_bytes() < len(blob) + 4:
            return False
        n = self.size
        end = self._get_int(n + 1) + len(blob)
        self._set_int(n + 2, end)
        self._buf[K_PAGE_SIZE - end:K_PAGE_SIZE - end + len(blob)] = blob
        self._set_int(0, n + 1)
        return True

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, r: int) -> bytes:
        if not 0 <= r < self.size:
            raise IndexError("BinaryPage index out of bounds")
        start = self._get_int(r + 1)
        end = self._get_int(r + 2)
        return bytes(self._buf[K_PAGE_SIZE - end:K_PAGE_SIZE - start])

    def save(self, fo: BinaryIO) -> None:
        fo.write(self._buf)

    @classmethod
    def load(cls, fi: BinaryIO) -> Optional["BinaryPage"]:
        buf = fi.read(K_PAGE_SIZE)
        if len(buf) < K_PAGE_SIZE:
            return None
        return cls(bytearray(buf))


class BinaryPageWriter:
    """Streams blobs into consecutive pages of an output file."""

    def __init__(self, fo: BinaryIO):
        self._fo = fo
        self._page = BinaryPage()

    def push(self, blob: bytes) -> None:
        if not self._page.push(blob):
            self._page.save(self._fo)
            self._page.clear()
            if not self._page.push(blob):
                raise ValueError(
                    f"blob of {len(blob)} bytes exceeds 64MiB page capacity")

    def close(self) -> None:
        if self._page.size > 0:
            self._page.save(self._fo)
            self._page.clear()


def iter_page_blobs(fi: BinaryIO) -> Iterator[List[bytes]]:
    """Yield the blob list of each page in a .bin file."""
    while True:
        page = BinaryPage.load(fi)
        if page is None:
            return
        yield [page[i] for i in range(page.size)]


def read_bin_blobs(paths: Sequence[str]) -> Iterator[bytes]:
    """Every blob of the .bin files in stream order, checked as the
    native page reader checks them: a file that does not open, a short
    last page (truncated), a page header whose count cannot fit, or a
    blob's offsets outside the page each raise IOError with the native
    reader's message (native/cxxnet_io.cc:226-278)."""
    for path in paths:
        try:
            f = open(path, "rb")
        except OSError as e:
            raise IOError(f"cannot open {path}") from e
        with f:
            while True:
                buf = f.read(K_PAGE_SIZE)
                if not buf:
                    break
                if len(buf) < K_PAGE_SIZE:
                    raise IOError(f"truncated page in {path}")
                n = struct.unpack_from("<i", buf, 0)[0]
                if n < 0 or n + 2 > K_PAGE_NUM_INTS:
                    raise IOError(f"corrupt page header in {path}")
                offs = struct.unpack_from(f"<{n + 1}i", buf, 4)
                for r in range(n):
                    start, end = offs[r], offs[r + 1]
                    if start < 0 or end < start or end > K_PAGE_SIZE:
                        raise IOError(f"corrupt blob offsets in {path}")
                    yield buf[K_PAGE_SIZE - end:K_PAGE_SIZE - start]
