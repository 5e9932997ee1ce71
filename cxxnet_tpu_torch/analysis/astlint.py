"""graftlint tier 1 for the port: a stdlib-``ast`` lint (own copy of
cxxnet_tpu/analysis/astlint.py, with its Finding, waiver grammar,
reporters and rule ids; no torch import).

Rules (stable ids - the waiver contract):

- **GL002 host-sync-in-hot-path** (the torch form): inside a function
  marked ``# graftlint: hot-path``, a host read of the device -
  ``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` /
  ``.synchronize()`` (``torch.cuda.synchronize``, a stream's or an
  event's) / ``.to("cpu")`` / ``np.asarray`` / ``np.array`` and
  ``float()`` / ``int()`` / ``bool()`` of a computed value. Each one
  stalls the host until the card has drained its queue, so every one on
  a hot path must be deliberate and waived with its reason. A cast of a
  bare name, attribute or subscript is host arithmetic and not flagged.
- **GL004 wallclock-duration**: ``time.time()`` - durations must use
  ``time.monotonic()`` (NTP step/slew makes wall-clock deltas lie);
  genuine wall-clock TIMESTAMPS carry a waiver naming that purpose.
- **GL006 unknown-config-key**: a string-literal subscript or
  ``.get`` on a cfg-like dict whose key the port's config schema
  registry (analysis/schema.py) does not recognize - a typo'd key
  silently reads the default forever.
- **GL007 unsharded-large-intermediate** (the torch form): in a
  mesh-aware module - one under ``parallel/``, or one that imports the
  cut placements ``ZeroCut`` / ``ParamCut`` (parallel/sharding.py) - an
  allocator (``zeros_like`` / ``empty_like`` / ``full_like`` /
  ``ones_like``) of a weight-named value (params, grads, accumulator,
  updater state, moments, the master weights ``master`` / ``w``, the
  gradient tree ``gtree`` / ``g``), directly or as the function a
  ``map`` / ``_tree_map`` applies, in a statement that does not go
  through the cut (no ``local`` / ``local_tree`` / ``owned`` /
  ``cut_shape`` / ``local_shape`` / ``reduce_scatter`` call). The
  allocation takes the shape of what it is given: where a rank holds
  only its cut of that value, an allocation from the whole tensor
  builds on every rank the whole tensor the ZeRO stages and the model,
  expert and pipe cuts exist to keep off it. A waiver names what keeps
  the tensor whole there (the stage that holds it whole, the gather
  that fills it).
- **GL008 metric-name-style**: a string-literal metric/beacon name
  passed to a telemetry instrument call (``telemetry.inc`` /
  ``set_gauge`` / ``observe`` / ``span`` / ``counter`` / ``gauge`` /
  ``histogram`` / ``beacon``) that does not match the dotted-lowercase
  grammar ``[a-z0-9_]+(\\.[a-z0-9_]+)+`` - the registry creates
  instruments on first use, so an off-grammar name silently opens a
  parallel series every dashboard and alert rule misses.
- **GL010..GL016 concurrency tier**: lock-discipline rules over the
  threading surface - bare ``.acquire()`` outside ``with``/try-finally
  (GL010), ``threading.Thread`` that never sets ``daemon=`` (GL011), a
  thread target/``run`` method writing instance or module state with
  no lock in scope (GL012), ``.join()`` with no timeout on a thread
  (GL013), ``Condition.wait`` not wrapped in a predicate ``while`` loop
  (GL014), blocking calls (``queue.get`` / ``accept`` / un-timeouted
  ``wait`` / ``sleep`` / subprocess waits) made while a lock is held
  (GL015), and the ``# guarded-by: <lock>`` annotation convention -
  every write to an annotated attribute must sit inside a ``with
  <lock>`` block in the same function (GL016). The runtime half of the
  tier is ``analysis/lock_audit.py``.
- **GL090 bad-waiver**: a waiver without a reason, or naming an
  unknown rule id.
- **GL091 unused-waiver**: a waiver that suppressed nothing.

Rules of the JAX package's lint that do not carry over:

- GL001 (rng-key-reuse): torch generators hold their state and advance
  on every draw, so there is no key value that two draws could share;
- GL003 (tracer-branch): eager PyTorch traces nothing - a Python branch
  on a tensor is a host read, which GL002 covers on the hot paths;
- GL005 (donated-arg-reuse): there is no buffer donation in eager
  PyTorch - the trainer updates its tensors in place, and the graph
  audit (analysis/graph_audit.py, ``update-in-place``) checks that.

Waiver syntax, per line::

    x = time.time()  # graftlint: disable=GL004 epoch timestamp
    # graftlint: disable=GL002 the guard's one readback a chunk
    fin = torch.stack(flags).cpu().numpy()

(a standalone waiver comment applies to the next line). Functions are
marked hot-path with ``# graftlint: hot-path`` on the ``def`` line or
the line above.
"""

from __future__ import annotations

import ast
import io
import os
import re
import time
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from cxxnet_tpu_torch.analysis import schema

RULES: Dict[str, str] = {
    "GL002": "host-sync-in-hot-path",
    "GL004": "wallclock-duration",
    "GL006": "unknown-config-key",
    "GL007": "unsharded-large-intermediate",
    "GL008": "metric-name-style",
    "GL010": "bare-acquire",
    "GL011": "thread-daemon-missing",
    "GL012": "unlocked-thread-shared-write",
    "GL013": "join-no-timeout",
    "GL014": "condition-wait-no-predicate",
    "GL015": "blocking-call-under-lock",
    "GL016": "guarded-by-violation",
    "GL090": "bad-waiver",
    "GL091": "unused-waiver",
}

# the JAX package's rule ids this lint does not carry (module docstring)
NOT_CARRIED = ("GL001", "GL003", "GL005")

# the GL01x subset: the concurrency tier (together with waiver hygiene, which cannot be waived)
CONCURRENCY_RULES = ("GL010", "GL011", "GL012", "GL013", "GL014",
                     "GL015", "GL016")

_WAIVE_RE = re.compile(
    r"graftlint:\s*disable=([A-Za-z0-9_,\s]*?)(?:\s+(.*))?$")
_HOT_RE = re.compile(r"graftlint:\s*hot-path\b")
# the guarded-by annotation grammar (docs/STATIC_ANALYSIS.md): names
# the lock expression protecting the attribute whose initialization
# the comment sits on (or above) - `self._lock`, or a bare module
# lock name
_GUARDED_RE = re.compile(r"guarded-by:\s*([A-Za-z_][A-Za-z0-9_.]*)")


# GL002, the torch form: methods that read a tensor back to the host or
# wait on the card, and the numpy constructors that do so on a tensor
_SYNC_METHODS = frozenset({"item", "cpu", "tolist", "numpy",
                           "synchronize"})
_NP_NAMES = frozenset({"np", "numpy", "onp"})
_CAST_BUILTINS = frozenset({"float", "int", "bool"})
# GL007: allocators that take the shape of a (possibly cut) tensor; the
# names of the values a rank may hold only its cut of; the cut's calls
# that make a statement go through it; the cut placements whose import
# makes a module mesh-aware
_ALLOCATORS = frozenset({"zeros_like", "ones_like", "full_like",
                         "empty_like"})
_WEIGHTY_RE = re.compile(
    r"param|grad|accum|ustate|state|weight|moment|master|gtree|^[wg]$",
    re.IGNORECASE)
_CUT_CALLS = frozenset({"local", "local_tree", "owned", "cut_shape",
                        "local_shape", "reduce_scatter"})
_CUT_NAMES = frozenset({"ZeroCut", "ParamCut"})


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    waived: bool = False
    reason: str = ""

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule, "name": RULES.get(self.rule, ""),
            "path": self.path, "line": self.line, "col": self.col,
            "message": self.message, "waived": self.waived,
            "reason": self.reason,
        }


@dataclass
class _Waiver:
    rules: List[str]
    reason: str
    src_line: int      # where the comment sits
    target_line: int   # the line it excuses
    used: bool = False


@dataclass
class _FileCtx:
    path: str
    rel: str
    tree: ast.AST
    mesh_aware: bool = False
    waivers: List[_Waiver] = field(default_factory=list)
    hot_lines: Set[int] = field(default_factory=set)
    # raw `# guarded-by:` notes: (target_line, lock_text, comment_line)
    guard_notes: List[Tuple[int, str, int]] = field(
        default_factory=list)
    findings: List[Finding] = field(default_factory=list)

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.rel, line=node.lineno,
            col=node.col_offset, message=message))


# ---------------------------------------------------------------------------
# comments: waivers + hot-path markers
# ---------------------------------------------------------------------------
def _scan_comments(ctx: _FileCtx, source: str) -> None:
    try:
        toks = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):
        return
    lines = source.splitlines()
    for tok in toks:
        if tok.type != tokenize.COMMENT:
            continue
        line_no = tok.start[0]
        before = lines[line_no - 1][:tok.start[1]]
        standalone = not before.strip()
        # a standalone waiver/marker comment applies to the NEXT line
        target = line_no + 1 if standalone else line_no
        if _HOT_RE.search(tok.string):
            ctx.hot_lines.add(target)
            continue
        g = _GUARDED_RE.search(tok.string)
        if g:
            ctx.guard_notes.append((target, g.group(1), line_no))
            continue
        m = _WAIVE_RE.search(tok.string)
        if not m:
            continue
        ids = [r.strip() for r in m.group(1).split(",") if r.strip()]
        reason = (m.group(2) or "").strip()
        w = _Waiver(rules=ids, reason=reason, src_line=line_no,
                    target_line=target)
        ctx.waivers.append(w)
        bad = [r for r in ids if r not in RULES]
        if bad or not ids:
            ctx.findings.append(Finding(
                "GL090", ctx.rel, line_no, tok.start[1],
                f"waiver names unknown rule id(s) {bad or ids}"))
        elif not reason:
            ctx.findings.append(Finding(
                "GL090", ctx.rel, line_no, tok.start[1],
                f"waiver for {','.join(ids)} has no reason - say why "
                "the finding is intended"))


def _apply_waivers(ctx: _FileCtx) -> None:
    for f in ctx.findings:
        if f.rule in ("GL090", "GL091"):
            continue  # waiver hygiene cannot be waived away
        for w in ctx.waivers:
            if f.line == w.target_line and f.rule in w.rules:
                f.waived, f.reason = True, w.reason
                w.used = True
                break
    for w in ctx.waivers:
        if not w.used and all(r in RULES for r in w.rules) and w.rules:
            ctx.findings.append(Finding(
                "GL091", ctx.rel, w.src_line, 0,
                f"waiver for {','.join(w.rules)} suppresses nothing - "
                "stale, delete it"))


# ---------------------------------------------------------------------------
# expression helpers
# ---------------------------------------------------------------------------
def _last_name(func: ast.expr) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _walk_no_funcs(node: ast.AST):
    """ast.walk that does not descend into nested def/lambda (each
    function is analyzed in its own visit, with its own scope)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _assigned_names(target: ast.expr) -> Set[str]:
    out = set()
    for n in ast.walk(target):
        if isinstance(n, ast.Name) and isinstance(
                n.ctx, (ast.Store, ast.Del)):
            out.add(n.id)
    return out


def _walk_no_funcs_inclusive(node: ast.AST):
    yield node
    yield from _walk_no_funcs(node)



# ---------------------------------------------------------------------------
# GL002 host-sync-in-hot-path (the torch form)
# ---------------------------------------------------------------------------
def _is_cpu_target(call: ast.Call) -> bool:
    """`.to("cpu")` / `.to(device="cpu")` / `.to(torch.device("cpu"))`."""
    for a in list(call.args[:1]) + [kw.value for kw in call.keywords
                                    if kw.arg == "device"]:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if (isinstance(a, ast.Call) and _last_name(a.func) == "device"
                and a.args and isinstance(a.args[0], ast.Constant)
                and a.args[0].value == "cpu"):
            return True
    return False


def _rule_host_sync(ctx: _FileCtx, fn: ast.AST) -> None:
    fname = getattr(fn, "name", "<lambda>")
    for n in _walk_no_funcs(fn):
        if not isinstance(n, ast.Call):
            continue
        func = n.func
        what = ""
        if (isinstance(func, ast.Name)
                and func.id in _CAST_BUILTINS and len(n.args) == 1
                and not isinstance(n.args[0], ast.Constant)):
            # a cast of a bare name/attr/subscript is host arithmetic;
            # a cast of a COMPUTED value (float(loss.sum()),
            # int(flags.all())) is the readback shape
            if any(isinstance(sub, ast.Call)
                   for sub in ast.walk(n.args[0])):
                what = f"{func.id}()"
        elif isinstance(func, ast.Attribute):
            if func.attr in _SYNC_METHODS:
                what = f".{func.attr}()"
            elif func.attr == "to" and _is_cpu_target(n):
                what = '.to("cpu")'
            elif (func.attr in ("asarray", "array")
                  and isinstance(func.value, ast.Name)
                  and func.value.id in _NP_NAMES):
                what = f"{func.value.id}.{func.attr}()"
        if what:
            ctx.emit(
                "GL002", n,
                f"{what} in hot-path function '{fname}' reads the "
                f"device on the host - a sync that drains the card's "
                f"queue before the host can go on")


# ---------------------------------------------------------------------------
# GL004 wallclock-duration
# ---------------------------------------------------------------------------
def _rule_wallclock(ctx: _FileCtx) -> None:
    # both alias forms: `from time import time as t` (bare-name call)
    # and `import time as _time` (module-attribute call)
    fn_aliases: Set[str] = set()
    mod_aliases: Set[str] = {"time"}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for al in node.names:
                if al.name == "time":
                    fn_aliases.add(al.asname or al.name)
        elif isinstance(node, ast.Import):
            for al in node.names:
                if al.name == "time":
                    mod_aliases.add(al.asname or al.name)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        hit = (isinstance(f, ast.Attribute) and f.attr == "time"
               and isinstance(f.value, ast.Name)
               and f.value.id in mod_aliases) or (
            isinstance(f, ast.Name) and f.id in fn_aliases)
        if hit:
            ctx.emit(
                "GL004", node,
                "time.time() - durations must use time.monotonic() "
                "(wall clock steps/slews under NTP); a genuine "
                "timestamp needs a waiver naming that purpose")


# ---------------------------------------------------------------------------
# GL006 unknown-config-key
# ---------------------------------------------------------------------------
def _cfg_like(expr: ast.expr, aliases: Set[str]) -> bool:
    if isinstance(expr, ast.Name):
        low = expr.id.lower()
        return "cfg" in low or "conf" in low or expr.id in aliases
    if isinstance(expr, ast.Attribute):
        low = expr.attr.lower()
        return "cfg" in low or "conf" in low
    return False


def _rule_cfg_keys(ctx: _FileCtx, fn: ast.AST) -> None:
    reg = schema.get_registry()
    # one-hop aliases: dc = self._daug_cfg
    aliases: Set[str] = set()
    for n in _walk_no_funcs(fn):
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and _cfg_like(n.value, set())):
            aliases.add(n.targets[0].id)

    def check_key(node: ast.AST, key: str) -> None:
        if reg.recognizes(key):
            return
        hint = reg.suggest(key)
        extra = f" (did you mean '{hint}'?)" if hint else ""
        ctx.emit(
            "GL006", node,
            f"config key '{key}' is not in the schema registry - no "
            f"set_param handler consumes it{extra}")

    for n in _walk_no_funcs(fn):
        if (isinstance(n, ast.Subscript)
                and isinstance(n.slice, ast.Constant)
                and isinstance(n.slice.value, str)
                and _cfg_like(n.value, aliases)):
            check_key(n, n.slice.value)
        elif (isinstance(n, ast.Call)
              and isinstance(n.func, ast.Attribute)
              and n.func.attr == "get"
              and _cfg_like(n.func.value, aliases)
              and n.args
              and isinstance(n.args[0], ast.Constant)
              and isinstance(n.args[0].value, str)):
            check_key(n, n.args[0].value)


# ---------------------------------------------------------------------------
# GL008 metric-name-style (module-wide, like GL004)
# ---------------------------------------------------------------------------
# the dotted-lowercase metric naming grammar (docs/OBSERVABILITY.md):
# at least two [a-z0-9_]+ segments joined by dots
_METRIC_NAME_RE = re.compile(r"[a-z0-9_]+(\.[a-z0-9_]+)+")
# span() names nest into "outer/inner" registry paths at runtime (the
# API's documented idiom uses short segment names like "round" /
# "step"), so a span segment may be a SINGLE lowercase token - the
# style bugs (uppercase, spaces, dashes) still flag
_SPAN_NAME_RE = re.compile(r"[a-z0-9_]+(\.[a-z0-9_]+)*")
# telemetry calls whose first string argument IS a series name
_METRIC_CALLS = frozenset({
    "inc", "set_gauge", "observe", "span", "counter", "gauge",
    "histogram", "beacon",
})


def _tel_name(name: str) -> bool:
    """Exact telemetry-identifier match: `telemetry`, `tel`, `_tel`,
    `_TEL`, `self._tel`, `my_tel` - NOT substring hits like `hotel`
    or `intel` (a substring rule would fail CI on unrelated APIs)."""
    low = name.lower()
    return (low.lstrip("_") in ("tel", "telemetry")
            or low.endswith(("_tel", "_telemetry")))


def _tel_receiver(expr: ast.expr) -> bool:
    """Is this call receiver telemetry-flavored? Covers the repo's
    idioms - `telemetry.inc`, `tel.observe`, `self._tel.span`,
    `telemetry.get().inc` - without dragging unrelated `.observe()`
    APIs into the rule."""
    if isinstance(expr, ast.Name):
        return _tel_name(expr.id)
    if isinstance(expr, ast.Attribute):
        return _tel_name(expr.attr) or _tel_receiver(expr.value)
    if isinstance(expr, ast.Call):
        return _tel_receiver(expr.func)
    return False


def _rule_metric_names(ctx: _FileCtx) -> None:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in _METRIC_CALLS
                and _tel_receiver(func.value)):
            continue
        if not (node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue  # dynamic names are the caller's responsibility
        name = node.args[0].value
        rx = (_SPAN_NAME_RE if func.attr == "span"
              else _METRIC_NAME_RE)
        if not rx.fullmatch(name):
            what = ("span segment" if func.attr == "span"
                    else "metric name")
            ctx.emit(
                "GL008", node,
                f"{what} {name!r} in telemetry.{func.attr}() does "
                f"not match the dotted-lowercase naming grammar - "
                f"off-grammar names silently create parallel series "
                f"no dashboard or alert rule watches")


# ---------------------------------------------------------------------------
# GL010-GL016: the concurrency tier (lock discipline)
# ---------------------------------------------------------------------------
# receiver-name fallbacks: a lock PASSED into a function has no
# visible construction, but the repo's naming is consistent enough
# that the suffix identifies it
_LOCKNAME_RE = re.compile(r"(^|_)(lock|mutex)s?$", re.IGNORECASE)
_CONDNAME_RE = re.compile(r"(^|_)cond(ition)?$", re.IGNORECASE)


def _dotted_text(e: ast.expr) -> str:
    """`self._cond` / `mod.lock` -> their dotted text, WITHOUT the
    ast.unparse cost; "" for anything that is not a plain Name/
    Attribute chain (such receivers are never lock-flavored)."""
    parts = []
    while isinstance(e, ast.Attribute):
        parts.append(e.attr)
        e = e.value
    if not isinstance(e, ast.Name):
        return ""
    parts.append(e.id)
    parts.reverse()
    return ".".join(parts)
_LOCK_FACTORIES = frozenset({"Lock", "RLock"})
_COND_FACTORIES = frozenset({"Condition"})
_EVENT_FACTORIES = frozenset({"Event", "Semaphore", "BoundedSemaphore",
                              "Barrier"})
_QUEUE_FACTORIES = frozenset({"Queue", "LifoQueue", "PriorityQueue",
                              "SimpleQueue"})
_SUBPROC_BLOCKERS = frozenset({"run", "check_call", "check_output",
                               "call"})


@dataclass
class _ConcInfo:
    """Module-wide concurrency flavor map: which expression texts are
    locks, conditions, events, queues, threads - collected from their
    construction sites."""
    locks: Set[str] = field(default_factory=set)
    conds: Set[str] = field(default_factory=set)
    events: Set[str] = field(default_factory=set)
    queues: Set[str] = field(default_factory=set)
    threads: Set[str] = field(default_factory=set)
    thread_classes: Set[str] = field(default_factory=set)
    # attr name -> (lock expr text, declaration line)
    guarded: Dict[str, Tuple[str, int]] = field(default_factory=dict)

    def lockish(self, text: str) -> bool:
        if not text:
            return False
        if text in self.locks or text in self.conds:
            return True
        if text in self.events or text in self.queues:
            return False
        last = text.rsplit(".", 1)[-1]
        return bool(_LOCKNAME_RE.search(last)
                    or _CONDNAME_RE.search(last))

    def condish(self, text: str) -> bool:
        if text in self.conds:
            return True
        if (text in self.events or text in self.locks
                or text in self.queues):
            return False
        return bool(_CONDNAME_RE.search(text.rsplit(".", 1)[-1]))

    def queueish(self, text: str) -> bool:
        if text in self.queues:
            return True
        last = text.rsplit(".", 1)[-1].lower().lstrip("_")
        return last in ("q", "queue") or last.endswith("_q") \
            or "queue" in last

    def threadish(self, text: str) -> bool:
        if text in self.threads:
            return True
        return "thread" in text.rsplit(".", 1)[-1].lower()


def _is_thread_base(base: ast.expr) -> bool:
    return _last_name(base) == "Thread"


def _conc_collect(ctx: _FileCtx,
                  nodes: Sequence[ast.AST]) -> _ConcInfo:
    conc = _ConcInfo()
    # pass 0: Thread subclasses (their constructors are thread
    # factories too)
    for node in nodes:
        if isinstance(node, ast.ClassDef) and any(
                _is_thread_base(b) for b in node.bases):
            conc.thread_classes.add(node.name)
    # pass 1: factory assignments
    for node in nodes:
        targets: List[ast.expr] = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if not (isinstance(value, ast.Call) and targets):
            continue
        name = _last_name(value.func)
        dest = (conc.locks if name in _LOCK_FACTORIES
                else conc.conds if name in _COND_FACTORIES
                else conc.events if name in _EVENT_FACTORIES
                else conc.queues if name in _QUEUE_FACTORIES
                else conc.threads if (name == "Thread"
                                      or name in conc.thread_classes)
                else None)
        if dest is None:
            continue
        for t in targets:
            if isinstance(t, (ast.Name, ast.Attribute)):
                text = _dotted_text(t)
                if text:
                    dest.add(text)
    # pass 2: thread collections (`self._threads.append(t)`) and loop
    # variables over them (`for t in self._threads:`)
    coll: Set[str] = set()
    for node in nodes:
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append" and node.args
                and _dotted_text(node.args[0]) in conc.threads):
            coll.add(_dotted_text(node.func.value))
    for node in nodes:
        if isinstance(node, (ast.For, ast.AsyncFor)):
            it = _dotted_text(node.iter)
            if it in coll or conc.threadish(it):
                for n in _assigned_names(node.target):
                    conc.threads.add(n)
    # guarded-by notes -> attribute registry (GL016). The note must
    # sit on (or above) an attribute assignment - a dangling note is
    # itself a finding, not silently-ignored documentation
    decl_lines: Dict[int, str] = {}
    for node in nodes:
        tgt = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            tgt = node.target
        if isinstance(tgt, ast.Attribute) and isinstance(
                tgt.ctx, ast.Store):
            decl_lines.setdefault(node.lineno, tgt.attr)
    for target_line, lock_text, src_line in ctx.guard_notes:
        attr = decl_lines.get(target_line)
        if attr is None:
            ctx.findings.append(Finding(
                "GL016", ctx.rel, src_line, 0,
                f"guarded-by annotation '{lock_text}' matches no "
                f"attribute assignment on line {target_line}"))
            continue
        conc.guarded[attr] = (lock_text, target_line)
    return conc


def _has_timeout(call: ast.Call) -> bool:
    return bool(call.args) or any(kw.arg == "timeout"
                                  for kw in call.keywords)


def _releases(stmts: Sequence[ast.stmt], text: str) -> bool:
    for st in stmts:
        for n in _walk_no_funcs_inclusive(st):
            if (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "release"
                    and _dotted_text(n.func.value) == text):
                return True
    return False


def _store_attr_targets(st: ast.stmt) -> List[ast.expr]:
    """Store targets of a simple statement, with subscripts unwrapped
    to their base (`self._hits[k] = v` writes `self._hits`)."""
    if isinstance(st, ast.Assign):
        targets = list(st.targets)
    elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
        targets = [st.target]
    else:
        return []
    out = []
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, (ast.Name, ast.Attribute)) and isinstance(
                    n.ctx, (ast.Store, ast.Del)):
                out.append(n)
            elif isinstance(n, ast.Subscript) and isinstance(
                    n.ctx, (ast.Store, ast.Del)):
                base = n.value
                while isinstance(base, ast.Subscript):
                    base = base.value
                if isinstance(base, (ast.Name, ast.Attribute)):
                    out.append(base)
    return out


def _guard_matches(held: Sequence[str], base_text: str,
                   lock_text: str) -> bool:
    """Does any held `with` context satisfy the guarded-by note? The
    note is written against the declaring object (`self._lock`); a
    write through another base (`_TEL._beacons`) must hold the SAME
    lock attribute on ITS base (`_TEL._beacon_lock`)."""
    if lock_text in held:
        return True
    if "." in lock_text and base_text:
        expected = base_text + "." + lock_text.rsplit(".", 1)[-1]
        return expected in held
    return False


def _scan_concurrency_scope(ctx: _FileCtx, conc: _ConcInfo,
                            body: Sequence[ast.stmt],
                            fname: str) -> None:
    """GL010/GL011/GL013/GL014/GL015/GL016 over one scope (a function
    body or the module body), tracking the lexical `with <lock>` stack
    and predicate-loop nesting."""
    in_init = fname == "__init__"

    def check_call(n: ast.Call, held: List[str], in_while: bool,
                   sibling_try: Optional[ast.Try],
                   fin_releases: Set[str]) -> None:
        func = n.func
        if not isinstance(func, ast.Attribute):
            return
        recv = _dotted_text(func.value)
        attr = func.attr
        if attr == "acquire" and conc.lockish(recv):
            ok = (recv in fin_releases
                  or (sibling_try is not None
                      and _releases(sibling_try.finalbody, recv)))
            if not ok:
                ctx.emit(
                    "GL010", n,
                    f"bare {recv}.acquire() with no try/finally "
                    f"release - an exception here leaks the lock "
                    f"forever; use `with {recv}:`")
        elif (attr == "wait" and conc.condish(recv)
                and not in_while):
            ctx.emit(
                "GL014", n,
                f"{recv}.wait() outside a predicate `while` loop - "
                f"condition waits wake spuriously and on stale "
                f"notifies; re-check the predicate in a loop "
                f"(`while not <pred>: {recv}.wait(...)`)")
        elif (attr == "join" and not n.args and not n.keywords
                and conc.threadish(recv)):
            ctx.emit(
                "GL013", n,
                f"{recv}.join() with no timeout - a wedged thread "
                f"hangs shutdown forever; join with a timeout and "
                f"handle the still-alive case")
        if not held:
            return
        # --- GL015: blocking while a lock is held ---
        what = ""
        if (attr == "get" and conc.queueish(recv)
                and not (n.args
                         and isinstance(n.args[0], ast.Constant)
                         and n.args[0].value is False)):
            what = f"{recv}.get()"
        elif attr == "accept" and not n.args:
            what = f"{recv}.accept()"
        elif (attr in ("wait", "communicate")
                and recv not in held       # cond.wait on the HELD
                and not _has_timeout(n)):  # lock releases it
            what = f"{recv}.{attr}()"
        elif attr == "join" and not n.args and not n.keywords \
                and conc.threadish(recv):
            what = f"{recv}.join()"
        elif attr == "sleep":
            what = f"{recv}.sleep()"
        elif (attr in _SUBPROC_BLOCKERS
                and isinstance(func.value, ast.Name)
                and func.value.id == "subprocess"
                and not any(kw.arg == "timeout" for kw in n.keywords)):
            what = f"subprocess.{attr}()"
        if what:
            ctx.emit(
                "GL015", n,
                f"blocking {what} while holding {held[-1]} - every "
                f"other thread needing the lock stalls behind this "
                f"wait (and a producer/consumer pair deadlocks); "
                f"move the blocking call outside the `with` block")

    def check_thread_ctor(n: ast.Call, st: ast.stmt,
                          body_: Sequence[ast.stmt], idx: int) -> None:
        if _last_name(n.func) != "Thread":
            return
        if any(kw.arg == "daemon" for kw in n.keywords):
            return
        # `t = Thread(...)` followed by `t.daemon = ...` in the same
        # scope counts
        if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                and isinstance(st.targets[0], ast.Name):
            tname = st.targets[0].id
            for later in body_[idx + 1:]:
                for sub in _walk_no_funcs_inclusive(later):
                    if (isinstance(sub, ast.Attribute)
                            and sub.attr == "daemon"
                            and isinstance(sub.ctx, ast.Store)
                            and _dotted_text(sub.value) == tname):
                        return
        ctx.emit(
            "GL011", n,
            "threading.Thread() without daemon= - an undecided "
            "lifetime either blocks interpreter exit (non-daemon "
            "leak) or dies mid-write (accidental daemon); decide "
            "explicitly")

    def check_guarded_stores(st: ast.stmt, held: List[str]) -> None:
        if in_init:
            return  # construction precedes publication
        for tgt in _store_attr_targets(st):
            if not isinstance(tgt, ast.Attribute):
                continue
            note = conc.guarded.get(tgt.attr)
            if note is None:
                continue
            lock_text, decl_line = note
            if st.lineno == decl_line:
                continue
            base_text = _dotted_text(tgt.value)
            if not _guard_matches(held, base_text, lock_text):
                ctx.emit(
                    "GL016", tgt,
                    f"write to '{_dotted_text(tgt)}' outside `with "
                    f"{lock_text}` - the field is annotated "
                    f"guarded-by: {lock_text} (declared line "
                    f"{decl_line})")

    def exprs_of(st: ast.stmt) -> List[ast.expr]:
        out = []
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                out.append(child)
        return out

    def check_exprs(exprs: Sequence[ast.expr], held: List[str],
                    in_while: bool, sibling_try: Optional[ast.Try],
                    fin_releases: Set[str], body_: Sequence[ast.stmt],
                    idx: int, st: ast.stmt) -> None:
        for e in exprs:
            for n in _walk_no_funcs_inclusive(e):
                if isinstance(n, ast.Call):
                    check_call(n, held, in_while, sibling_try,
                               fin_releases)
                    check_thread_ctor(n, st, body_, idx)

    def scan(body_: Sequence[ast.stmt], held: List[str],
             in_while: bool, fin_releases: Set[str]) -> None:
        for idx, st in enumerate(body_):
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            nxt = body_[idx + 1] if idx + 1 < len(body_) else None
            sibling_try = nxt if isinstance(nxt, ast.Try) else None
            check_guarded_stores(st, held)
            if isinstance(st, (ast.With, ast.AsyncWith)):
                pushed = list(held)
                ctx_exprs = []
                for item in st.items:
                    ctx_exprs.append(item.context_expr)
                    t = _dotted_text(item.context_expr)
                    if conc.lockish(t):
                        pushed = pushed + [t]
                check_exprs(ctx_exprs, held, in_while, sibling_try,
                            fin_releases, body_, idx, st)
                scan(st.body, pushed, in_while, fin_releases)
            elif isinstance(st, ast.While):
                # a wait in the loop TEST is the predicate-loop idiom
                # too (`while not ev.wait(t): ...`)
                check_exprs([st.test], held, True, sibling_try,
                            fin_releases, body_, idx, st)
                scan(st.body, held, True, fin_releases)
                scan(st.orelse, held, in_while, fin_releases)
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                check_exprs([st.iter], held, in_while, sibling_try,
                            fin_releases, body_, idx, st)
                scan(st.body, held, in_while, fin_releases)
                scan(st.orelse, held, in_while, fin_releases)
            elif isinstance(st, ast.If):
                check_exprs([st.test], held, in_while, sibling_try,
                            fin_releases, body_, idx, st)
                scan(st.body, held, in_while, fin_releases)
                scan(st.orelse, held, in_while, fin_releases)
            elif isinstance(st, ast.Try):
                # an acquire in the try body excused by this try's own
                # finally-release (the acquire-then-try idiom)
                fin = set(fin_releases)
                for fin_st in st.finalbody:
                    for n in _walk_no_funcs_inclusive(fin_st):
                        if (isinstance(n, ast.Call)
                                and isinstance(n.func, ast.Attribute)
                                and n.func.attr == "release"):
                            fin.add(_dotted_text(n.func.value))
                scan(st.body, held, in_while, fin)
                for h in st.handlers:
                    scan(h.body, held, in_while, fin_releases)
                scan(st.orelse, held, in_while, fin_releases)
                scan(st.finalbody, held, in_while, fin_releases)
            else:
                check_exprs(exprs_of(st), held, in_while, sibling_try,
                            fin_releases, body_, idx, st)

    scan(body, [], False, set())


def _thread_target_functions(
        ctx: _FileCtx, conc: _ConcInfo,
        nodes: Sequence[ast.AST]) -> List[ast.AST]:
    """Functions that run ON a spawned thread: `target=` of a Thread
    construction (bare name, local closure, or `self._method`), and
    the `run` method of every Thread subclass."""
    by_name: Dict[str, List[ast.AST]] = {}
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, []).append(node)
    out: List[ast.AST] = []
    seen: Set[int] = set()

    def add(fn: ast.AST) -> None:
        if id(fn) not in seen:
            seen.add(id(fn))
            out.append(fn)

    for node in nodes:
        if isinstance(node, ast.ClassDef) and any(
                _is_thread_base(b) for b in node.bases):
            for item in node.body:
                if isinstance(item, ast.FunctionDef) \
                        and item.name == "run":
                    add(item)
        if not (isinstance(node, ast.Call)
                and (_last_name(node.func) == "Thread"
                     or _last_name(node.func) in conc.thread_classes)):
            continue
        for kw in node.keywords:
            if kw.arg != "target":
                continue
            name = ""
            if isinstance(kw.value, ast.Name):
                name = kw.value.id
            elif (isinstance(kw.value, ast.Attribute)
                  and isinstance(kw.value.value, ast.Name)
                  and kw.value.value.id in ("self", "cls")):
                name = kw.value.attr
            for fn in by_name.get(name, ()):
                add(fn)
    return out


def _rule_unlocked_thread_writes(ctx: _FileCtx, conc: _ConcInfo,
                                 fn: ast.AST) -> None:
    """GL012 over one thread-target function: stores to instance
    attributes (`self.x = ...`) or declared-global names with no lock
    held are cross-thread data races waiting for a reader. Fields
    carrying a guarded-by annotation are GL016's responsibility; the
    fix is a lock, a queue handoff, or the annotation."""
    fname = getattr(fn, "name", "<lambda>")
    args = getattr(fn, "args", None)
    self_name = ""
    if args is not None:
        pos = list(args.posonlyargs) + list(args.args)
        if pos and pos[0].arg in ("self", "cls"):
            self_name = pos[0].arg
    declared_globals: Set[str] = set()
    for n in _walk_no_funcs(fn):
        if isinstance(n, ast.Global):
            declared_globals.update(n.names)

    def scan(body: Sequence[ast.stmt], held: bool) -> None:
        for st in body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                locked = held or any(
                    conc.lockish(_dotted_text(i.context_expr))
                    for i in st.items)
                scan(st.body, locked)
                continue
            if not held:
                for tgt in _store_attr_targets(st):
                    what = ""
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == self_name
                            and self_name):
                        if tgt.attr in conc.guarded:
                            continue  # GL016 checks those
                        what = _dotted_text(tgt)
                    elif (isinstance(tgt, ast.Name)
                          and tgt.id in declared_globals):
                        what = f"global {tgt.id}"
                    if what:
                        ctx.emit(
                            "GL012", tgt,
                            f"thread target '{fname}' writes shared "
                            f"state '{what}' with no lock in scope - "
                            f"a concurrent reader sees torn/stale "
                            f"state; guard it with a lock, hand it "
                            f"over a queue, or annotate the field "
                            f"guarded-by its lock")
            for sub in (getattr(st, "body", None),
                        getattr(st, "orelse", None),
                        getattr(st, "finalbody", None)):
                if sub:
                    scan(sub, held)
            for h in getattr(st, "handlers", []) or []:
                scan(h.body, held)

    scan(getattr(fn, "body", []), False)


def _rule_thread_subclass_daemon(ctx: _FileCtx,
                                 nodes: Sequence[ast.AST]) -> None:
    """GL011's class form: a Thread subclass must decide daemon-ness
    in its __init__ (super().__init__(daemon=...) or self.daemon=)."""
    for node in nodes:
        if not (isinstance(node, ast.ClassDef)
                and any(_is_thread_base(b) for b in node.bases)):
            continue
        init = next((f for f in node.body
                     if isinstance(f, ast.FunctionDef)
                     and f.name == "__init__"), None)
        decided = False
        if init is not None:
            for n in _walk_no_funcs(init):
                if (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "__init__"
                        and any(kw.arg == "daemon"
                                for kw in n.keywords)):
                    decided = True
                elif (isinstance(n, ast.Attribute)
                      and n.attr == "daemon"
                      and isinstance(n.ctx, ast.Store)):
                    decided = True
        if not decided:
            ctx.emit(
                "GL011", node,
                f"Thread subclass '{node.name}' never sets daemon= "
                f"(inherits non-daemon: a leaked instance blocks "
                f"interpreter exit); pass daemon= to "
                f"super().__init__ or set self.daemon in __init__")


def _concurrency_pass(ctx: _FileCtx) -> None:
    # one pre-walked node list shared by every sub-pass (ast.walk is
    # the dominant cost of walking the same tree nine times)
    nodes = list(ast.walk(ctx.tree))
    conc = _conc_collect(ctx, nodes)
    _rule_thread_subclass_daemon(ctx, nodes)
    # every scope: module body + each function body
    _scan_concurrency_scope(ctx, conc, ctx.tree.body, "<module>")
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _scan_concurrency_scope(ctx, conc, node.body, node.name)
    for fn in _thread_target_functions(ctx, conc, nodes):
        _rule_unlocked_thread_writes(ctx, conc, fn)


# ---------------------------------------------------------------------------
# GL007 unsharded-large-intermediate (the torch form)
# ---------------------------------------------------------------------------
def _mesh_aware(ctx: _FileCtx) -> bool:
    """A module under parallel/, or one that imports a cut placement."""
    parts = os.path.normpath(ctx.rel).split(os.sep)
    if "parallel" in parts[:-1]:
        return True
    return any(isinstance(n, ast.ImportFrom)
               and any(al.name in _CUT_NAMES for al in n.names)
               for n in ast.walk(ctx.tree))


def _value_names(expr: ast.expr) -> Set[str]:
    """The names an expression reads a value from (an attribute's last
    name, a subscript's base), not the names of the calls it makes."""
    out: Set[str] = set()
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            out.discard(_last_name(n.func))
    return out


def _rule_unsharded_intermediate(ctx: _FileCtx, fn: ast.AST) -> None:
    fname = getattr(fn, "name", "<lambda>")

    def weighty(exprs: Sequence[ast.expr]) -> str:
        for e in exprs:
            for name in sorted(_value_names(e)):
                if _WEIGHTY_RE.search(name):
                    return name
        return ""

    for st in _walk_no_funcs_inclusive(fn):
        # simple statements only: the smallest enclosing statement is
        # the waiver / cut granularity
        if not isinstance(st, (ast.Assign, ast.AugAssign,
                               ast.AnnAssign, ast.Return, ast.Expr)):
            continue
        calls = [n for n in _walk_no_funcs_inclusive(st)
                 if isinstance(n, ast.Call)]
        if any(_last_name(n.func) in _CUT_CALLS for n in calls):
            continue
        for n in calls:
            call = _last_name(n.func)
            args = list(n.args) + [kw.value for kw in n.keywords]
            if call in _ALLOCATORS:
                src = weighty(args)
                if src:
                    ctx.emit(
                        "GL007", n,
                        f"{call}('{src}') in '{fname}' of a mesh-aware "
                        "module builds the whole tensor where a rank may "
                        "hold only its cut; take the shape through the "
                        "cut (ParamCut.local / ZeroCut.owned), or waive "
                        "naming what keeps the tensor whole here")
            elif call.endswith("map") and any(
                    isinstance(a, (ast.Name, ast.Attribute))
                    and _last_name(a) in _ALLOCATORS for a in n.args):
                src = weighty(n.args[1:])
                if src:
                    ctx.emit(
                        "GL007", n,
                        f"{call} of an allocator over '{src}' in "
                        f"'{fname}' of a mesh-aware module builds a "
                        "whole tensor a leaf where a rank may hold only "
                        "its cut; take the shapes through the cut, or "
                        "waive naming what keeps the tree whole here")


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------
def _function_visits(ctx: _FileCtx) -> None:
    """Visit every function: the config-key rule everywhere, the
    allocation rule in mesh-aware modules, the host-sync rule in
    hot-path marked ones."""
    ctx.mesh_aware = _mesh_aware(ctx)
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _rule_cfg_keys(ctx, node)
            if ctx.mesh_aware:
                _rule_unsharded_intermediate(ctx, node)
            if node.lineno in ctx.hot_lines:
                _rule_host_sync(ctx, node)


def lint_file(path: str, rel: Optional[str] = None) -> List[Finding]:
    rel = rel or path
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source)
    except (OSError, SyntaxError) as e:
        return [Finding("GL090", rel, getattr(e, "lineno", 0) or 0, 0,
                        f"file does not parse: {e}")]
    ctx = _FileCtx(path=path, rel=rel, tree=tree)
    _scan_comments(ctx, source)
    _rule_wallclock(ctx)
    _rule_metric_names(ctx)
    _concurrency_pass(ctx)
    _function_visits(ctx)
    _apply_waivers(ctx)
    ctx.findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return ctx.findings


def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__"
                           and not d.startswith(".")]
            out.extend(os.path.join(dirpath, f)
                       for f in sorted(filenames)
                       if f.endswith(".py"))
    return out


def lint_paths(
        paths: Sequence[str],
        rules: Optional[Sequence[str]] = None,
) -> Tuple[List[Finding], int, float]:
    """Lint every .py under `paths`. Returns (findings, n_files,
    elapsed_s). `rules` filters to a subset of rule ids."""
    t0 = time.monotonic()
    findings: List[Finding] = []
    files = iter_py_files(paths)
    for path in files:
        findings.extend(lint_file(path, os.path.relpath(path)))
    if rules:
        keep = set(rules)
        findings = [f for f in findings if f.rule in keep]
    return findings, len(files), time.monotonic() - t0


def render_text(findings: Sequence[Finding], n_files: int,
                elapsed_s: float, show_waived: bool = False) -> str:
    lines = []
    unwaived = [f for f in findings if not f.waived]
    for f in unwaived:
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.rule} "
                     f"[{RULES.get(f.rule, '?')}] {f.message}")
    n_waived = sum(1 for f in findings if f.waived)
    if show_waived:
        for f in findings:
            if f.waived:
                lines.append(
                    f"{f.path}:{f.line}: {f.rule} waived: {f.reason}")
    lines.append(
        f"graftlint: {len(unwaived)} finding(s), {n_waived} waived, "
        f"{n_files} files in {elapsed_s:.2f}s")
    return "\n".join(lines)
