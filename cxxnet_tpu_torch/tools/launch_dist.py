#!/usr/bin/env python3
"""launch_dist: start an N-worker data-parallel job on this host
(counterpart of cxxnet_tpu/tools/launch_dist.py).

Usage:
  python -m cxxnet_tpu_torch.tools.launch_dist -n 2 \\
      [--coordinator 127.0.0.1:29500] -- \\
      python -m cxxnet_tpu_torch.main train.conf param_server=dist

Each worker gets CXN_COORDINATOR / CXN_NUM_WORKER / CXN_WORKER_RANK
(and CXN_LOCAL_RANK, its index on this host) in its environment; rank 0
serves the process group's store at the coordinator's address. When one
worker exits non-zero the others are terminated (killed after a grace
period), so that no survivor hangs in a collective waiting for its
peer, and the launcher exits with the first failure's code.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import List

GRACE_SECS = 10.0


def launch(cmd: List[str], num_workers: int,
           coordinator: str = "127.0.0.1:29500",
           extra_env: dict | None = None) -> int:
    procs = []
    for rank in range(num_workers):
        env = dict(os.environ)
        env["CXN_COORDINATOR"] = coordinator
        env["CXN_NUM_WORKER"] = str(num_workers)
        env["CXN_WORKER_RANK"] = str(rank)
        env["CXN_LOCAL_RANK"] = str(rank)
        if extra_env:
            env.update(extra_env)
        procs.append(subprocess.Popen(cmd, env=env))
    # poll every worker: one failing must tear the job down
    rc = 0
    live = list(procs)
    while live and rc == 0:
        time.sleep(0.2)
        for p in list(live):
            code = p.poll()
            if code is not None:
                live.remove(p)
                rc = rc or code
    if rc:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        end = time.monotonic() + GRACE_SECS
        for p in procs:
            try:
                p.wait(timeout=max(0.1, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
    for p in procs:
        p.wait()
        rc = rc or p.returncode
    return rc


def cli_main(argv: List[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    num_workers = 2
    coordinator = "127.0.0.1:29500"
    cmd: List[str] = []
    i = 0
    while i < len(args):
        a = args[i]
        if a in ("-n", "--num-workers"):
            num_workers = int(args[i + 1])
            i += 2
        elif a == "--coordinator":
            coordinator = args[i + 1]
            i += 2
        elif a == "--":
            cmd = args[i + 1:]
            break
        else:
            print(__doc__)
            return 1
    if not cmd:
        print(__doc__)
        return 1
    return launch(cmd, num_workers, coordinator)


if __name__ == "__main__":
    sys.exit(cli_main())
