"""Config schema registry: every `key = value` config key the port
recognizes (own copy of cxxnet_tpu/analysis/schema.py, over the port's
source tree).

Every config pair is routed to every component, and each component
picks out what it understands (`set_param` chains), so a misspelt key
is consumed by nobody and silently changes nothing: `batch_sizee = 256`
would train at the default batch size. The registry closes that hole
without a hand-kept list: it is generated by scanning the package
source with stdlib ``ast`` for the key comparisons inside
``set_param`` / ``set_global_param`` / ``configure`` handlers
(`name == "batch_size"`, `name in (...)`, `name.startswith("metric")`),
so a new handler key is registered by existing.

Key classes:

- **exact** keys, harvested from the handlers (with source locations);
- **not ported** keys: the module-level ``_NOT_PORTED`` tables (the
  CLI's, the trainer's, the layers' and the data pipeline's) - keys of
  the JAX package whose component or option the port does not implement
  yet. They are recognized (a conf written for the JAX package passes
  the check) and raise NotImplementedError naming the key where they are
  set to anything but their inert value;
- **prefix** keys, from ``name.startswith(...)`` handlers (the
  pairtest layer's ``master:`` / ``slave:`` scopes among them);
- **pattern** keys (regexes) for the structured key grammars:
  ``layer[...]``, ``metric[name,node]``, ``extra_data_shape[i]``,
  ``label_vec[a,b)``, ``lr:schedule`` and tag-scoped updater params
  (``wmat:lr``, ``bias:wd``).

Plus a small builtin set of structural keys consumed outside any
handler (the `data` / `eval` / `pred` / `iter` block markers, the
netconfig bracket, the distributed bootstrap keys, the check's own off
switch).

Unknown keys get a did-you-mean suggestion (closest exact key by
``difflib``). ``validate_pairs`` raises ``ConfigError``; the CLI runs it
on every parsed config unless ``schema_check = 0``.
"""

from __future__ import annotations

import ast
import difflib
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from cxxnet_tpu_torch.utils.config import ConfigError

# package root (cxxnet_tpu_torch/) - the tree the registry is generated
# from
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# handler function names whose key comparisons define the schema.
# set_param/set_global_param take the key as their first parameter;
# NetConfig.configure replays a pair LIST and compares a loop var
# literally named `name` - scanned with that binding
_HANDLER_NAMES = ("set_param", "set_global_param", "configure")

# the module-level tables of keys the port refuses for now
_NOT_PORTED_TABLE = "_NOT_PORTED"

# structural keys consumed outside set_param handlers
_BUILTIN_KEYS: Dict[str, str] = {
    "data": "main.py:_split_blocks (train iterator block marker)",
    "eval": "main.py:_split_blocks (eval iterator block marker)",
    "pred": "main.py:_split_blocks (pred iterator block marker)",
    "iter": "io/__init__.py:create_iterator (iterator chain)",
    "netconfig": "nnet/net_config.py:configure (net block bracket)",
    # the JAX package's multi-controller bootstrap: read only under
    # param_server = dist, which the trainer refuses
    "dist_coordinator": "distributed bootstrap (param_server = dist)",
    "dist_worker_rank": "distributed bootstrap (param_server = dist)",
    "dist_init_retries": "distributed bootstrap (param_server = dist)",
    "dist_init_backoff": "distributed bootstrap (param_server = dist)",
    "dist_init_deadline": "distributed bootstrap (param_server = dist)",
    # the JAX package's persistent XLA compilation cache directory
    # (cxxnet_tpu/nnet/trainer.py:457-467): it never changes results,
    # and torch has no XLA cache to point it at, so the port accepts
    # the key with no effect
    "compile_cache": "accepted with no effect (the JAX package's XLA "
                     "compilation cache; torch has none)",
}

# updater param names a "<tag>:" prefix may scope (updater/param.py
# strips the tag and processes the rest)
_TAG_SCOPED = ("lr", "eta", "wd", "momentum", "clip_gradient",
               "momentum_schedule", "final_momentum", "base_momentum",
               "saturation_epoch", "silent")

# structured key grammars the handlers parse with re.match - one
# (regex, consumer) per grammar
_PATTERNS: Tuple[Tuple[str, str], ...] = (
    (r"layer\[[^\]]+\]", "nnet/net_config.py (layer declaration)"),
    (r"metric\[[^,\]]+,[^\]]+\]", "nnet/trainer.py (node-scoped metric)"),
    (r"extra_data_shape\[\d+\]", "nnet/net_config.py"),
    (r"label_vec\[\d+,\d+\)", "nnet/net_config.py (label slicing)"),
    (r"(?:lr|eta):(?:schedule|gamma|alpha|step|factor|minimum_lr"
     r"|start_epoch)", "updater/param.py (lr schedule)"),
    (r"\w+:(?:%s)" % "|".join(_TAG_SCOPED),
     "updater/param.py (tag-scoped param, e.g. wmat:lr)"),
)


@dataclass
class KeyRegistry:
    """The recognized-key universe with provenance."""

    exact: Dict[str, List[str]] = field(default_factory=dict)
    prefixes: List[Tuple[str, str]] = field(default_factory=list)
    patterns: List[Tuple[re.Pattern, str]] = field(default_factory=list)
    # the exact keys that come from a _NOT_PORTED table
    not_ported: Dict[str, List[str]] = field(default_factory=dict)

    def add_exact(self, key: str, where: str) -> None:
        self.exact.setdefault(key, []).append(where)

    def recognizes(self, key: str) -> bool:
        if key in self.exact:
            return True
        if any(key.startswith(p) for p, _ in self.prefixes):
            return True
        return any(rx.fullmatch(key) for rx, _ in self.patterns)

    def suggest(self, key: str) -> Optional[str]:
        """Closest known exact key, or None when nothing is near."""
        hits = difflib.get_close_matches(key, self.exact.keys(), n=1,
                                         cutoff=0.6)
        return hits[0] if hits else None


def _first_param(fn: ast.FunctionDef) -> Optional[str]:
    """Name of the key parameter of a handler (first arg past self)."""
    args = [a.arg for a in fn.args.args if a.arg != "self"]
    return args[0] if args else None


def _scan_handler(fn: ast.FunctionDef, rel: str,
                  reg: KeyRegistry) -> None:
    """Harvest key comparisons against the handler's key parameter."""
    param = "name" if fn.name == "configure" else _first_param(fn)
    if param is None:
        return
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare) and len(node.ops) == 1:
            left, right = node.left, node.comparators[0]
            where = f"{rel}:{node.lineno}"
            if isinstance(node.ops[0], ast.Eq):
                # name == "k" (either side)
                for a, b in ((left, right), (right, left)):
                    if (isinstance(a, ast.Name) and a.id == param
                            and isinstance(b, ast.Constant)
                            and isinstance(b.value, str)):
                        reg.add_exact(b.value, where)
            elif isinstance(node.ops[0], ast.In):
                # name in ("a", "b", ...)
                if (isinstance(left, ast.Name) and left.id == param
                        and isinstance(right, (ast.Tuple, ast.List,
                                               ast.Set))):
                    for el in right.elts:
                        if (isinstance(el, ast.Constant)
                                and isinstance(el.value, str)):
                            reg.add_exact(el.value, where)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "startswith"
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id == param
              and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            # name.startswith("metric") -> prefix key
            reg.prefixes.append((node.args[0].value,
                                 f"{rel}:{node.lineno}"))


def _scan_not_ported(tree: ast.Module, rel: str, reg: KeyRegistry) -> None:
    """Harvest the string keys of a module-level `_NOT_PORTED = {...}`
    table."""
    for node in tree.body:
        if isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        elif isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        else:
            continue
        if not (isinstance(value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id == _NOT_PORTED_TABLE
                for t in targets)):
            continue
        where = f"{rel}:{node.lineno} (not ported)"
        for k in value.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                reg.add_exact(k.value, where)
                reg.not_ported.setdefault(k.value, []).append(where)


def build_registry(root: str = _PKG_ROOT) -> KeyRegistry:
    """Generate the registry by scanning the package source tree."""
    reg = KeyRegistry()
    for key, where in _BUILTIN_KEYS.items():
        reg.add_exact(key, where)
    for rx, where in _PATTERNS:
        reg.patterns.append((re.compile(rx), where))
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "build", "csrc")]
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, os.path.dirname(root))
            try:
                with open(path, "r", encoding="utf-8") as f:
                    src = f.read()
                # cheap prefilter before the (expensive) ast.parse: a
                # file with no handler and no table cannot register keys
                if not any(h in src for h in _HANDLER_NAMES
                           + (_NOT_PORTED_TABLE,)):
                    continue
                tree = ast.parse(src)
            except (OSError, SyntaxError):
                continue  # unparseable files cannot register keys
            _scan_not_ported(tree, rel, reg)
            for node in ast.walk(tree):
                if (isinstance(node, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                        and node.name in _HANDLER_NAMES):
                    _scan_handler(node, rel, reg)
    return reg


_REG: Optional[KeyRegistry] = None


def get_registry(refresh: bool = False) -> KeyRegistry:
    """Process-cached registry (the source scan parses the package's
    handler modules)."""
    global _REG
    if _REG is None or refresh:
        _REG = build_registry()
    return _REG


def unknown_keys(
        pairs: Sequence[Tuple[str, str]],
) -> List[Tuple[str, Optional[str]]]:
    """(key, suggestion) for every unrecognized key, in order, deduped."""
    reg = get_registry()
    out: List[Tuple[str, Optional[str]]] = []
    seen = set()
    for name, _ in pairs:
        if name in seen or reg.recognizes(name):
            continue
        seen.add(name)
        out.append((name, reg.suggest(name)))
    return out


def validate_pairs(pairs: Sequence[Tuple[str, str]],
                   source: str = "") -> None:
    """Raise ConfigError for unknown keys, with did-you-mean help."""
    bad = unknown_keys(pairs)
    if not bad:
        return
    loc = f" in {source}" if source else ""
    lines = []
    for key, hint in bad:
        msg = f"unknown config key '{key}'"
        if hint:
            msg += f" (did you mean '{hint}'?)"
        lines.append(msg)
    raise ConfigError(
        "ConfigSchema: " + "; ".join(lines) + loc
        + " - no component consumes this key, so it would silently "
        "change nothing (set schema_check = 0 to bypass)")


def check_config_file(path: str) -> List[Tuple[str, Optional[str]]]:
    """Unknown keys of one conf file (parse errors propagate)."""
    from cxxnet_tpu_torch.utils.config import parse_config_file
    return unknown_keys(parse_config_file(path))
