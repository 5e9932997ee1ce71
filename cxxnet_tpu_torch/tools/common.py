"""What the port's smoke and bench tools share: the device rule, the
`--out` / `--keep` / `--dev` command line, and the CLI child.

Every tool runs on the card unless it is asked for the CPU (`--dev
cpu`); with no card the default raises and names `--dev cpu`, rather
than carrying on on the CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Callable, List, Optional, Sequence

from cxxnet_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tool_device(dev: str = "") -> str:
    """The torch device a tool runs on: `dev` as given ("cpu", "cuda",
    a conf's dev spec), the card when it is empty. Raises with no card,
    naming `--dev cpu`."""
    try:
        return str(resolve_device(dev or DEFAULT_DEVICE))
    except RuntimeError as e:
        raise RuntimeError(
            f"{e}. The port's tools run on the card by default: pass "
            "--dev cpu to run one on the CPU") from None


def cli_dev(device: str) -> str:
    """The CLI's `dev` value for a torch device string."""
    return "cpu" if device == "cpu" else "gpu"


def cli_env() -> dict:
    """Environment of a CLI child: the repo on PYTHONPATH, so that
    `python -m cxxnet_tpu_torch.main` imports from any directory."""
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def run_cli(conf: str, *overrides: str, timeout: float = 540,
            cwd: Optional[str] = None) -> subprocess.CompletedProcess:
    """`python -m cxxnet_tpu_torch.main conf k=v ...` in a child."""
    return subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.main", conf, *overrides],
        env=cli_env(), capture_output=True, text=True, timeout=timeout,
        cwd=cwd)


def smoke_main(name: str, run: Callable[[str, str], int],
               argv: Optional[Sequence[str]] = None) -> int:
    """`python -m cxxnet_tpu_torch.tools.<name> [--out DIR] [--keep]
    [--dev DEV]`: resolve the device (raising with no card unless
    `--dev cpu`), then run(out_dir, device) in DIR, a kept temporary
    directory, or a temporary directory removed afterwards."""
    args: List[str] = list(sys.argv[1:] if argv is None else argv)
    opts = {}
    for flag in ("--out", "--dev"):
        if flag in args:
            i = args.index(flag)
            if i + 1 >= len(args):
                print(f"usage: {name} [--out DIR] [--keep] [--dev DEV]")
                return 2
            opts[flag] = args[i + 1]
            del args[i:i + 2]
    keep = "--keep" in args
    args = [a for a in args if a != "--keep"]
    if args:
        print(f"{name}: unknown arguments {args}; usage: {name} "
              "[--out DIR] [--keep] [--dev DEV]")
        return 2
    device = tool_device(opts.get("--dev", ""))
    if "--out" in opts:
        os.makedirs(opts["--out"], exist_ok=True)
        return run(opts["--out"], device)
    if keep:
        d = tempfile.mkdtemp(prefix=f"{name}_")
        rc = run(d, device)
        print(f"{name}: artifacts kept in {d}")
        return rc
    with tempfile.TemporaryDirectory() as d:
        return run(d, device)


def device_name(device: str) -> str:
    """The card's name (torch.cuda.get_device_name), "cpu" on the CPU."""
    if device == "cpu":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(torch.device(device))


def time_ms(fn: Callable[[], object], steps: int, device: str,
            warmup: int = 1) -> float:
    """Mean milliseconds of one fn() call over `steps` back-to-back
    calls after `warmup` untimed ones: CUDA events around the loop on
    the card, the host clock on the CPU."""
    import time

    import torch
    for _ in range(warmup):
        fn()
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        return (time.perf_counter() - t0) / steps * 1e3
    dev = torch.device(device)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps
