"""Continuous-batching inference serving and its production front
(serve/server.py)."""

from cxxnet_tpu_torch.serve.server import (  # noqa: F401
    RETRY_AFTER_COLD_S, DeadlineExpiredError, QueueFullError, Server,
    bucket_sizes, ladder_buckets, ladder_from_histogram,
    predictions_from_rows)
