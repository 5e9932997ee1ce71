"""The port's graph-pass smoke (cxxnet_tpu_torch/tools/pass_smoke.py)
on the CPU: fold parity at batch_size = 96, dead-layer elimination,
activation fusion, the 1x1 merge, the int8 leg and the tuning-cache
replay, every check of the JAX tool's but the lowered-module size."""


def test_pass_smoke_passes_on_the_cpu(tmp_path, capsys):
    from cxxnet_tpu_torch.tools import pass_smoke
    rc = pass_smoke.main(["--out", str(tmp_path), "--dev", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("[ok]") == 21 and "[FAIL]" not in out
