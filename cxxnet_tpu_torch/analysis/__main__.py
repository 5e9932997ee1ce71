"""graftlint CLI for the port (counterpart of cxxnet_tpu/analysis/
__main__.py).

    python -m cxxnet_tpu_torch.analysis [paths...] [options]

Modes (combinable; each contributes to the exit code and the JSON
report):

  paths...              tier-1 AST lint over .py trees (default mode;
                        with no paths, lints the cxxnet_tpu_torch
                        package)
  --check-configs DIR   config schema sweep: every *.conf under DIR
                        validated against the port's key registry
  --graph-audit         tier-2: run the real train / eval / infer /
                        serve paths under the dispatch probe and assert
                        on what they dispatch (analysis/graph_audit.py;
                        on the card also the kernel routing)
  --lock-audit          concurrency tier-2: run the serve-storm /
                        prefetch-round / watchdog-stall / native-decode
                        scenarios under the lock shim and assert an
                        acyclic lock-order graph, no lock held across a
                        card sync or tensor read, and non-vacuous
                        coverage

Options:

  --json FILE           write the combined machine-readable report
  --rules GL002,GL004   restrict tier-1 to a rule subset
  --show-waived         list waived findings in the text output
  --list-rules          print the rule catalog and exit
  --dump-keys           print the config-key registry
  --max-seconds S       fail if the tier-1 lint exceeded S seconds
  --lock-audit-scenarios a,b
                        restrict the lock audit to a scenario subset
  --lock-audit-max-seconds S
                        fail if the lock audit exceeded S seconds
  --seed-inversion      inject the deliberate two-lock ABBA fixture
                        into the lock audit - the gate's self-test (the
                        audit MUST then exit non-zero)
  --dev cpu|cuda        where the audits run: the card unless the CPU
                        is asked for; with no card they raise and name
                        --dev cpu (the lint runs anywhere)

Exit codes: 0 = clean (zero unwaived findings, all audit checks
pass), 1 = findings/audit failures, 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from cxxnet_tpu_torch.analysis import schema
from cxxnet_tpu_torch.analysis.astlint import (
    RULES, lint_paths, render_text)

_PKG = os.path.dirname(os.path.abspath(__file__))
_DEFAULT_PATH = os.path.dirname(_PKG)


def _find_confs(root: str) -> List[str]:
    if os.path.isfile(root):
        return [root]
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        out.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                   if f.endswith(".conf"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cxxnet_tpu_torch.analysis",
        description="graftlint: framework-aware static analysis")
    ap.add_argument("paths", nargs="*", help="python trees to lint")
    ap.add_argument("--check-configs", action="append", default=[],
                    metavar="DIR")
    ap.add_argument("--graph-audit", action="store_true")
    ap.add_argument("--lock-audit", action="store_true")
    ap.add_argument("--lock-audit-scenarios", default="",
                    metavar="a,b")
    ap.add_argument("--lock-audit-max-seconds", type=float,
                    default=0.0)
    ap.add_argument("--seed-inversion", action="store_true")
    ap.add_argument("--json", dest="json_out", default="")
    ap.add_argument("--rules", default="")
    ap.add_argument("--show-waived", action="store_true")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--dump-keys", action="store_true")
    ap.add_argument("--max-seconds", type=float, default=0.0)
    ap.add_argument("--dev", default="")
    args = ap.parse_args(argv)
    if args.seed_inversion and not args.lock_audit:
        print("--seed-inversion requires --lock-audit")
        return 2

    if args.list_rules:
        for rid, name in sorted(RULES.items()):
            print(f"{rid}  {name}")
        return 0
    if args.dump_keys:
        reg = schema.get_registry()
        for key in sorted(reg.exact):
            print(f"{key:28s} {reg.exact[key][0]}")
        for pfx, where in reg.prefixes:
            print(f"{pfx + '*':28s} {where}")
        for rx, where in reg.patterns:
            print(f"{rx.pattern:28s} {where}")
        return 0

    report = {}
    failed = False

    # -- tier 1: AST lint ---------------------------------------------------
    run_lint = bool(args.paths) or not (args.check_configs
                                        or args.graph_audit
                                        or args.lock_audit)
    if run_lint:
        paths = args.paths or [_DEFAULT_PATH]
        # a missing path or an empty tree must FAIL, not vacuously
        # pass - a renamed package would otherwise turn the gate
        # green-and-useless forever
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            print(f"graftlint: path(s) do not exist: {missing}")
            return 2
        rules = [r.strip() for r in args.rules.split(",")
                 if r.strip()] or None
        findings, n_files, elapsed = lint_paths(paths, rules)
        if n_files == 0:
            print(f"graftlint: no .py files under {paths} - "
                  "refusing to pass an empty scan")
            return 2
        print(render_text(findings, n_files, elapsed,
                          show_waived=args.show_waived))
        unwaived = [f for f in findings if not f.waived]
        report["lint"] = {
            "files": n_files, "elapsed_s": round(elapsed, 3),
            "findings": [f.to_dict() for f in findings],
            "unwaived": len(unwaived),
            "waived": sum(1 for f in findings if f.waived),
        }
        if unwaived:
            failed = True
        if args.max_seconds and elapsed > args.max_seconds:
            print(f"graftlint: FAIL - lint took {elapsed:.2f}s, "
                  f"budget is {args.max_seconds:.0f}s")
            report["lint"]["over_budget"] = True
            failed = True

    # -- config schema sweep ------------------------------------------------
    if args.check_configs:
        missing = [r for r in args.check_configs
                   if not os.path.exists(r)]
        if missing:
            print(f"config-schema: path(s) do not exist: {missing}")
            return 2
        confs = []
        for root in args.check_configs:
            confs.extend(_find_confs(root))
        if not confs:
            print(f"config-schema: no .conf files under "
                  f"{args.check_configs} - refusing to pass an "
                  "empty sweep")
            return 2
        results = []
        n_bad = 0
        for conf in confs:
            try:
                bad = schema.check_config_file(conf)
            except Exception as e:  # parse error is a finding too
                results.append({"conf": conf, "error": str(e)})
                n_bad += 1
                print(f"{conf}: parse error: {e}")
                continue
            results.append({"conf": conf, "unknown": [
                {"key": k, "suggestion": s} for k, s in bad]})
            for k, s in bad:
                n_bad += 1
                hint = f" (did you mean '{s}'?)" if s else ""
                print(f"{conf}: unknown config key '{k}'{hint}")
        print(f"config-schema: {len(confs)} conf file(s), "
              f"{n_bad} unknown key(s)")
        report["configs"] = {"files": len(confs), "unknown": n_bad,
                             "results": results}
        if n_bad:
            failed = True

    device = ""
    if args.graph_audit or args.lock_audit:
        from cxxnet_tpu_torch.tools.common import tool_device
        device = tool_device(args.dev)

    # -- tier 2: graph audit ------------------------------------------------
    if args.graph_audit:
        from cxxnet_tpu_torch.analysis.graph_audit import run_audit
        audit = run_audit(device)
        for chk in audit["checks"]:
            mark = "ok" if chk["ok"] else "FAIL"
            print(f"  [{mark}] {chk['target']}: {chk['check']}"
                  + (f" - {chk['detail']}" if chk.get("detail")
                     else ""))
        for d in audit["deferred"]:
            print(f"  [deferred] {d['target']}: {d['reason']}")
        n_fail = sum(1 for c in audit["checks"] if not c["ok"])
        print(f"graph-audit: {len(audit['checks'])} checks, "
              f"{n_fail} failed, {len(audit['deferred'])} deferred "
              f"({audit['device']})")
        report["audit"] = audit
        if n_fail:
            failed = True

    # -- concurrency tier 2: runtime lock audit -----------------------------
    if args.lock_audit:
        from cxxnet_tpu_torch.analysis.lock_audit import run_lock_audit
        scen = tuple(s.strip()
                     for s in args.lock_audit_scenarios.split(",")
                     if s.strip()) or None
        try:
            audit = run_lock_audit(scenarios=scen,
                                   seed_inversion=args.seed_inversion,
                                   device=device)
        except ValueError as e:  # unknown scenario name = usage error
            print(f"lock-audit: {e}")
            return 2
        for chk in audit["checks"]:
            mark = "ok" if chk["ok"] else "FAIL"
            print(f"  [{mark}] {chk['target']}: {chk['check']}"
                  + (f" - {chk['detail']}" if chk.get("detail")
                     else ""))
        for site in audit["contended"]:
            print(f"  contended: {site['site']} "
                  f"({site['kind']}, x{site['instances']}) "
                  f"acq={site['acquisitions']} "
                  f"wait={site['wait_total_ms']:.1f}ms "
                  f"held_max={site['held_max_ms']:.1f}ms")
        print(f"lock-audit: {len(audit['checks'])} checks, "
              f"{audit['failed']} failed; {audit['sites']} lock "
              f"sites, {len(audit['edges'])} order edges, "
              f"{audit['elapsed_s']:.1f}s")
        report["lock_audit"] = audit
        if audit["failed"]:
            failed = True
        budget = args.lock_audit_max_seconds
        if budget and audit["elapsed_s"] > budget:
            print(f"lock-audit: FAIL - audit took "
                  f"{audit['elapsed_s']:.1f}s, budget is "
                  f"{budget:.0f}s")
            audit["over_budget"] = True
            failed = True

    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
