"""graftlint for the port: framework-aware analysis of cxxnet_tpu_torch
(counterpart of cxxnet_tpu/analysis/).

- **tier 1, AST lint** (astlint.py): stdlib-``ast`` rules over the
  Python source, with stable GLxxx ids, per-line waivers
  (``# graftlint: disable=GL004 reason``) and text/JSON reporters: the
  torch form of the host-sync rule on hot paths, wall-clock durations,
  config keys, metric names and the concurrency rules GL010-GL016. No
  torch import.
- **tier 2, graph audit** (graph_audit.py): run the real train / eval /
  infer / serve paths under a dispatch probe (aten ops, host reads,
  plain-version calls, kernel launches) and assert on what they
  dispatch - no float64, no host sync inside a step, updates in place,
  bounded programs, the graph passes' and int8's effect on the op
  trace, and on the card the routing of every main path through the
  hand-written kernels.
- **concurrency tier 2** (lock_audit.py): a Lock/RLock construction
  shim records per-thread acquisition sequences over the real serve /
  prefetch / watchdog / decoder paths and fails on a cyclic lock-order
  graph or a lock held across a card sync or tensor read.

Plus the **config schema registry** (schema.py) behind the CLI's schema
check. CLI: ``python -m cxxnet_tpu_torch.analysis [paths]
[--check-configs DIR] [--graph-audit] [--lock-audit] [--json FILE]
[--dev cpu|cuda]`` - exit 0 iff zero unwaived findings and every audit
check passed.
"""

from cxxnet_tpu_torch.analysis.astlint import (
    Finding, RULES, lint_paths, render_text)
from cxxnet_tpu_torch.analysis.schema import (
    KeyRegistry, get_registry, unknown_keys, validate_pairs)

__all__ = [
    "Finding", "RULES", "lint_paths", "render_text",
    "KeyRegistry", "get_registry", "unknown_keys",
    "validate_pairs",
]
