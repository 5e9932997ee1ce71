"""The divergence error and the atomic file writer (own copies of what the
training path needs from cxxnet_tpu/utils/fault.py)."""

from __future__ import annotations

import contextlib
import os


class DivergenceError(RuntimeError):
    """Training diverged: ``max_bad_rounds`` consecutive non-finite
    update rounds (the trainer's divergence guard, check_nan = 1)."""


@contextlib.contextmanager
def atomic_writer(path: str, mode: str = "wb"):
    """Write `path` atomically: the body writes to ``path + ".tmp"``
    and a successful exit fsyncs it and ``os.replace``s it into place,
    so `path` holds either the complete new content or the old. On
    error the tmp file is removed and the error propagates."""
    tmp = path + ".tmp"
    fo = open(tmp, mode)
    try:
        yield fo
        fo.flush()
        os.fsync(fo.fileno())
        fo.close()
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            fo.close()
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
