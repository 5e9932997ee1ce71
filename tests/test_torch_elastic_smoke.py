"""tools/elastic_smoke.py on the CPU: the JAX tool's pod (a b24 MLP, 3
members, 6 rounds, the leader killed at its 7th dispatched step)
reshapes 3 -> 2 through the port's supervisor and CLI, and passes the
JAX tool's four assertions - a reshape with a new leader, one publisher
a round and no orphan temporary file, the final checkpoint's sha256
equal to an uninterrupted 2-member run's from the same rollback
checkpoint, and the eval lines equal after the rollback. Run in a child
process, as the tool runs."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_elastic_smoke_reshapes_three_to_two_on_the_cpu(tmp_path):
    out = tmp_path / "out"
    env = {k: v for k, v in os.environ.items()
           if k not in ("CXN_MEMBER_ID", "CXN_WORKER_RANK", "CXXNET_FAULT",
                        "CXN_NUM_WORKER", "CXN_COORDINATOR")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.tools.elastic_smoke",
         "--dev", "cpu", "--out", str(out), "--json",
         str(tmp_path / "s.json")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    assert "elastic-smoke: PASS" in p.stdout
    s = json.load(open(tmp_path / "s.json"))
    assert s["ok"] and all(c["ok"] for c in s["checks"])
    assert len(s["checks"]) == 9
    assert s["generations"] == {"0": [0, 1, 2], "1": [1, 2]}
    assert [0, 0] in s["leaders"] and [1, 1] in s["leaders"]
    assert s["rollback_round"] == 3
    assert s["publishers"] == {str(r): ["m0" if r <= 3 else "m1"]
                               for r in range(7)}
    sha = s["sha256"]
    assert sha["interrupted"] == sha["uninterrupted"] != ""
    ev = s["eval_lines"]
    for r in ("4", "5", "6"):
        assert ev["interrupted"][r] == ev["uninterrupted"][r]
    # each generation's timing is on the record; the killed generation
    # was torn down, the last one ended by itself
    t = s["timing"]
    assert t["0"]["spawn_to_first_step_s"] > 0
    assert t["1"]["spawn_to_first_step_s"] > 0
    assert t["0"]["teardown_s"] is not None
    # every member of generation 0 left its last whole round's record
    assert sorted(s["launches_a"]) == ["m0.g0", "m1.g0", "m1.g1", "m2.g0",
                                       "m2.g1"]
    assert s["launches_a"]["m0.g0"]["round"] == 3
    assert s["manifest"]["round"] == 6 and s["manifest"]["writer"] == 1
