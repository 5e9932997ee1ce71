"""The divergence error, the atomic file writer and the retry decorator
(own copies of what the training path and the data pipeline need from
cxxnet_tpu/utils/fault.py; the fault-injection registry is not ported)."""

from __future__ import annotations

import contextlib
import functools
import os
import random
import sys
import time
from typing import Callable, Optional, Tuple, Type


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


def default_on_retry(fn, attempt, total, exc, sleep_s):
    """Per-retry notification on stderr (the JAX package's text)."""
    sys.stderr.write(
        f"retry: {getattr(fn, '__qualname__', fn)} failed "
        f"(attempt {attempt}/{total}: {type(exc).__name__}: {exc}); "
        f"retrying in {sleep_s:.2f}s\n")


def retry(attempts: int = 3, backoff: float = 0.05, jitter: float = 0.05,
          retry_on: Tuple[Type[BaseException], ...] = (OSError,),
          on_retry: Optional[Callable] = None):
    """Decorator: retry on transient errors with exponential backoff.

    - ``attempts``: total call attempts (1 = no retry).
    - ``backoff``: initial sleep between attempts, doubled each retry.
    - ``jitter``: uniform [0, jitter) seconds added to each sleep so
      many workers retrying the same shared resource don't stampede.
    - ``retry_on``: exception classes considered transient; anything
      else propagates immediately.
    - ``on_retry(fn, attempt, attempts, exc, sleep_s)``: hook for the
      per-retry warning; default writes it to stderr.
    """
    if attempts < 1:
        raise ValueError("retry: attempts must be >= 1")
    notify = on_retry or default_on_retry

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            delay = backoff
            for attempt in range(1, attempts + 1):
                try:
                    return fn(*args, **kwargs)
                except retry_on as exc:
                    if attempt >= attempts:
                        raise
                    sleep_s = delay + random.uniform(0.0, jitter)
                    notify(fn, attempt, attempts, exc, sleep_s)
                    time.sleep(sleep_s)
                    delay *= 2
            raise AssertionError("unreachable")  # pragma: no cover
        return wrapped
    return deco
