"""Real-data acceptance of the port's training path: MNIST_CONV.conf,
unmodified but for `dev=cpu num_round=40`, on the sklearn handwritten
digits corpus (cxxnet_tpu/tools/digits_to_idx.py), through both
packages' CLIs. The port's test error must land in the JAX package's
band: the mean over the last 5 rounds within [min - 1/300, max + 1/300]
of the JAX package's last 5 rounds (300 test rows are scored, so 1/300
is one test image), and the port's last round at most 0.02 - the bar of
tests/test_acceptance_digits.py (>= 98% accuracy).

Slow (~30 s CPU): gated behind CXN_RUN_ACCEPTANCE=1, like the JAX
package's acceptance test.
"""

import os
import re
import shutil

import pytest

pytestmark = pytest.mark.skipif(
    os.environ.get("CXN_RUN_ACCEPTANCE") != "1",
    reason="slow acceptance run; set CXN_RUN_ACCEPTANCE=1")


def _test_errors(main, conf, capfd):
    main([conf, "dev=cpu", "silent=1", "num_round=40", "max_round=40",
          "save_model=0"])
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
