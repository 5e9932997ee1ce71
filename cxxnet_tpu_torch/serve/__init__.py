"""Continuous-batching inference serving (serve/server.py)."""

from cxxnet_tpu_torch.serve.server import (  # noqa: F401
    Server, bucket_sizes, predictions_from_rows)
