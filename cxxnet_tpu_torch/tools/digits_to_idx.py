"""Write the sklearn handwritten-digits dataset as MNIST idx files (the
port's copy of cxxnet_tpu/tools/digits_to_idx.py; the same bytes).

The reference's acceptance bar is "run example/MNIST/MNIST.conf
unmodified -> ~98% accuracy" (example/MNIST/README.md:104-109). On a
machine with no network the real MNIST files cannot be fetched; the
nearest REAL handwriting data available offline is
sklearn.datasets.load_digits (1797 scanned 8x8 digits from the UCI
optical-recognition corpus). This tool upsamples them to 28x28 and
writes gzip idx files with the exact MNIST magic/layout, so MNIST.conf
runs byte-for-byte unmodified against real handwritten data. It needs
scipy and scikit-learn, and raises an ImportError naming scikit-learn
where that is missing.

Usage: python -m cxxnet_tpu_torch.tools.digits_to_idx <outdir> [test_fraction]
"""

from __future__ import annotations

import gzip
import os
import struct
import sys

import numpy as np


def write_idx(out_dir: str, prefix: str, images: np.ndarray,
              labels: np.ndarray) -> None:
    """gzip idx files: magic 2051 (images) / 2049 (labels), big-endian
    dims, uint8 payload - the layout iter_mnist expects."""
    n, rows, cols = images.shape
    with gzip.open(os.path.join(
            out_dir, f"{prefix}-images-idx3-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, rows, cols))
        f.write(np.ascontiguousarray(images, np.uint8).tobytes())
    with gzip.open(os.path.join(
            out_dir, f"{prefix}-labels-idx1-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">ii", 2049, n))
        f.write(np.ascontiguousarray(labels, np.uint8).tobytes())


def load_split(test_fraction: float = 0.2, seed: int = 0) -> tuple:
    """The canonical acceptance split: (train_x, train_y, test_x,
    test_y), images uint8 (n, 28, 28). ONE function owns the
    upsampling + shuffle so the framework acceptance runs and the
    same-split external baselines (docs/acceptance/baseline_mlp.py)
    provably train on identical data."""
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise ImportError(
            "digits_to_idx needs scikit-learn (sklearn.datasets."
            "load_digits holds the handwritten digits it writes); it is "
            "not installed here") from e
    from scipy import ndimage

    d = load_digits()
    imgs = d.images  # (1797, 8, 8) float in [0, 16]
    up = np.stack([
        ndimage.zoom(im, 28.0 / 8.0, order=1) for im in imgs])
    up = np.clip(up * (255.0 / 16.0), 0, 255).astype(np.uint8)
    labels = d.target.astype(np.uint8)

    rng = np.random.RandomState(seed)
    order = rng.permutation(len(up))
    n_test = int(len(up) * test_fraction)
    test_idx, train_idx = order[:n_test], order[n_test:]
    return (up[train_idx], labels[train_idx],
            up[test_idx], labels[test_idx])


def build(out_dir: str, test_fraction: float = 0.2,
          seed: int = 0) -> tuple:
    train_x, train_y, test_x, test_y = load_split(test_fraction, seed)
    os.makedirs(out_dir, exist_ok=True)
    write_idx(out_dir, "train", train_x, train_y)
    write_idx(out_dir, "t10k", test_x, test_y)
    return len(train_x), len(test_x)


def main(argv) -> int:
    out_dir = argv[0] if argv else "./data"
    frac = float(argv[1]) if len(argv) > 1 else 0.2
    ntr, nte = build(out_dir, frac)
    print(f"wrote {ntr} train / {nte} test real handwritten digits "
          f"to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
