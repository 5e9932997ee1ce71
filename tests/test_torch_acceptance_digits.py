"""Real-data acceptance of the port's training path: MNIST_CONV.conf
and the sequence family's examples/LongSeq/seq_mnist.conf, unmodified
but for `dev=cpu num_round=40` (and `dtype=float32` for seq_mnist, as
tests/test_acceptance_digits.py runs it), on the sklearn handwritten
digits corpus (cxxnet_tpu/tools/digits_to_idx.py), through both
packages' CLIs. The port's test error must land in the JAX package's
band: the mean over the last 5 rounds within [min - 1/300, max + 1/300]
of the JAX package's last 5 rounds (300 test rows are scored, so 1/300
is one test image), and the port's last round at most the bar of
tests/test_acceptance_digits.py: 0.02 for MNIST_CONV (>= 98% accuracy),
0.05 for seq_mnist (>= 95%).

examples/LongSeq/stack_moe.conf (4 stacked transformer blocks and a
top-2 moe with its aux loss) runs the same way as seq_mnist, from one
JAX-drawn init with two dropout streams, and lands in the JAX package's
band of 10 last-round errors widened by one test image.

Slow (~30 s, ~2 min and several minutes CPU): gated behind
CXN_RUN_ACCEPTANCE=1, like the JAX package's acceptance test.
"""

import os
import re
import shutil

import pytest

pytestmark = pytest.mark.skipif(
    os.environ.get("CXN_RUN_ACCEPTANCE") != "1",
    reason="slow acceptance run; set CXN_RUN_ACCEPTANCE=1")


def _test_errors(main, conf, capfd, extra=()):
    main([conf, "dev=cpu", "silent=1", "num_round=40", "max_round=40",
          "save_model=0", *extra])
    err = capfd.readouterr().err
    return [float(m.group(1)) for m in
            re.finditer(r"test-error:([0-9.]+)", err)]


def test_port_digits_error_in_jax_band(tmp_path, capfd, monkeypatch):
    from cxxnet_tpu import main as jax_main
    from cxxnet_tpu.tools.digits_to_idx import build
    from cxxnet_tpu_torch import main as port_main

    build(str(tmp_path / "data"))
    conf = str(tmp_path / "MNIST_CONV.conf")
    shutil.copy(os.path.join(os.path.dirname(__file__), "..", "examples",
                             "MNIST", "MNIST_CONV.conf"), conf)
    monkeypatch.chdir(tmp_path)
    want = _test_errors(jax_main.main, conf, capfd)[-5:]
    got = _test_errors(port_main.main, conf, capfd)[-5:]
    assert len(want) == len(got) == 5
    lo, hi = min(want) - 1 / 300, max(want) + 1 / 300
    assert lo <= sum(got) / 5 <= hi, (got, want)
    assert got[-1] <= 0.02, (got, want)


def _from_one_jax_init(conf_rel, tmp_path, capfd, monkeypatch):
    """Both packages from the JAX package's initial weights, each with
    dropout streams seed 0 and 1: (JAX errors, port errors), the last 5
    rounds of each run."""
    from cxxnet_tpu import main as jax_main
    from cxxnet_tpu.tools.digits_to_idx import build
    from cxxnet_tpu_torch import main as port_main

    build(str(tmp_path / "data"))
    conf = str(tmp_path / os.path.basename(conf_rel))
    shutil.copy(os.path.join(os.path.dirname(__file__), "..", conf_rel),
                conf)
    monkeypatch.chdir(tmp_path)
    jax_main.main([conf, "dev=cpu", "silent=1", "dtype=float32",
                   "num_round=0", "max_round=0"])
    capfd.readouterr()
    init = os.path.join("models", "0000.model")
    assert os.path.exists(init)
    want, got = [], []
    for seed in (0, 1):
        extra = ("dtype=float32", f"model_in={init}", f"seed={seed}")
        want.append(_test_errors(jax_main.main, conf, capfd, extra)[-5:])
        got.append(_test_errors(port_main.main, conf, capfd, extra)[-5:])
    return want, got


def test_port_stack_moe_digits_error_in_jax_band(tmp_path, capfd,
                                                 monkeypatch):
    """stack_moe.conf (moe aux loss on, dropout 0.2) on the digits: the
    port's mean over its 10 last-round errors lies within the JAX
    package's 10, widened by one test image, and each port run ends at
    most one test image above the JAX run of its seed."""
    want, got = _from_one_jax_init(
        os.path.join("examples", "LongSeq", "stack_moe.conf"), tmp_path,
        capfd, monkeypatch)
    print(f"stack_moe.conf digits, last 5 rounds: JAX {want}, port {got}")
    for w, g in zip(want, got):
        assert len(w) == len(g) == 5
        assert g[-1] <= w[-1] + 1 / 300, (got, want)
    flat_w = [e for w in want for e in w]
    flat_g = [e for g in got for e in g]
    lo, hi = min(flat_w) - 1 / 300, max(flat_w) + 1 / 300
    assert lo <= sum(flat_g) / 10 <= hi, (got, want)


def test_port_seq_digits_error_in_jax_band(tmp_path, capfd, monkeypatch):
    """seq_mnist.conf at eta 0.1 sits at the edge of stability: from some
    initial weights both packages diverge to a constant class (the JAX
    package at seeds 1 and 2, the port at its own seeds 0 and 2), and
    the dropout stream alone moves the JAX package's last-5-round mean
    by 2.4 test images (0.0153 vs 0.0233 from one init). So both start
    from the JAX package's initial weights (models/0000.model), each
    trains with two dropout streams (seed 0 and 1), and the band is the
    JAX package's 10 last-round errors widened by one test image."""
    want, got = _from_one_jax_init(
        os.path.join("examples", "LongSeq", "seq_mnist.conf"), tmp_path,
        capfd, monkeypatch)
    for seed, mine in enumerate(got):
        assert len(mine) == 5 and mine[-1] <= 0.05, (seed, mine, want)
    flat_w = [e for w in want for e in w]
    flat_g = [e for g in got for e in g]
    assert len(flat_w) == len(flat_g) == 10
    lo, hi = min(flat_w) - 1 / 300, max(flat_w) + 1 / 300
    assert lo <= sum(flat_g) / 10 <= hi, (got, want)
