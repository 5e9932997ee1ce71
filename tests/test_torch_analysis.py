"""The port's AST lint (cxxnet_tpu_torch/analysis/astlint.py) and its CLI,
held to the JAX package's lint.

- every fixture snippet of tests/test_graftlint.py and
  tests/test_concurrency_lint.py, linted by both packages, gives the
  same findings (rule, line, column, waived) for the rules they share;
- GL002 and GL007 in their torch forms get their own cases;
- the port's tree has zero unwaived findings, every waiver a reason;
- the CLI's exit codes: 0 clean, 1 findings, 2 usage or a vacuous scan.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

from cxxnet_tpu.analysis import astlint as jax_lint
from cxxnet_tpu_torch.analysis import astlint as port_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "cxxnet_tpu_torch")

# the rules both lints carry with one meaning (GL002 and GL007 have
# their torch forms, tested below; GL090/GL091 are compared where a
# snippet's waivers name no rule the two lints do not share)
SHARED = ("GL004", "GL006", "GL008", "GL010", "GL011", "GL012", "GL013",
          "GL014", "GL015", "GL016")
TORCH_FORM = ("GL002", "GL007")
NOT_SHARED = ("GL001", "GL003", "GL005") + TORCH_FORM


def _snippets():
    """(case id, source) of every `_lint(tmp_path, <source>)` call in the
    JAX package's lint tests (module-level string constants resolved)."""
    out = []
    for fname in ("test_graftlint.py", "test_concurrency_lint.py"):
        path = os.path.join(REPO, "tests", fname)
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        consts = {}
        for node in tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                try:
                    consts[node.targets[0].id] = ast.literal_eval(
                        node.value)
                except ValueError:
                    pass

        def value(e):
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                return e.value
            if isinstance(e, ast.Name) and isinstance(
                    consts.get(e.id), str):
                return consts[e.id]
            if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Add):
                a, b = value(e.left), value(e.right)
                return None if a is None or b is None else a + b
            return None

        for fn in tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            k = 0
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "_lint"
                        and len(node.args) >= 2):
                    src = value(node.args[1])
                    if src is not None:
                        out.append((f"{fname[5:-3]}::{fn.name}[{k}]", src))
                        k += 1
    return out


SNIPPETS = _snippets()


def test_fixture_harvest_covers_both_files():
    ids = [i for i, _ in SNIPPETS]
    assert len(ids) >= 60
    assert any(i.startswith("graftlint::test_gl004") for i in ids)
    assert any(i.startswith("concurrency_lint::test_gl016") for i in ids)


def _key(findings, rules):
    return sorted((f.rule, f.line, f.col, f.waived) for f in findings
                  if f.rule in rules)


@pytest.mark.parametrize("case,src", SNIPPETS, ids=[i for i, _ in SNIPPETS])
def test_shared_rule_findings_equal_jax(tmp_path, case, src):
    p = tmp_path / "snippet.py"
    p.write_text(src)
    want = jax_lint.lint_file(str(p), "snippet.py")
    got = port_lint.lint_file(str(p), "snippet.py")
    assert _key(got, SHARED) == _key(want, SHARED)
    names_other = any(f"disable={r}" in src or f",{r}" in src
                      for r in NOT_SHARED)
    if not names_other:
        assert _key(got, ("GL090", "GL091")) == _key(
            want, ("GL090", "GL091"))


def test_rule_catalog():
    assert set(port_lint.RULES) == set(jax_lint.RULES) - set(
        port_lint.NOT_CARRIED)
    assert port_lint.CONCURRENCY_RULES == jax_lint.CONCURRENCY_RULES
    for rid in port_lint.NOT_CARRIED:
        assert rid in port_lint.__doc__


# ---------------------------------------------------------------------------
# GL002 in its torch form
# ---------------------------------------------------------------------------
def _lint(tmp_path, src):
    p = tmp_path / "snippet.py"
    p.write_text(src)
    return port_lint.lint_file(str(p), "snippet.py")


def _rules(findings, waived=False):
    return [f.rule for f in findings if f.waived == waived]


@pytest.mark.parametrize("expr,what", [
    ("loss.item()", ".item()"),
    ("flags.cpu()", ".cpu()"),
    ("rows.tolist()", ".tolist()"),
    ("torch.cuda.synchronize()", ".synchronize()"),
    ("ev.synchronize()", ".synchronize()"),
    ('out.to("cpu")', '.to("cpu")'),
    ('out.to(device="cpu")', '.to("cpu")'),
    ("float(loss.sum())", "float()"),
    ("bool(torch.isfinite(w).all())", "bool()"),
    ("np.asarray(rows)", "np.asarray()"),
])
def test_gl002_host_reads_in_hot_path_flag(tmp_path, expr, what):
    fs = _lint(tmp_path, f"""
import numpy as np
import torch
# graftlint: hot-path
def step(self, loss, flags, rows, ev, out, w):
    x = {expr}
    return x
""")
    assert _rules(fs) == ["GL002"]
    assert what in fs[0].message and "'step'" in fs[0].message


def test_gl002_numpy_of_cpu_copy_flags_both(tmp_path):
    # .cpu() and .numpy() on one line are two findings one waiver covers
    fs = _lint(tmp_path, """
# graftlint: hot-path
def step(fin):
    # graftlint: disable=GL002 the guard's one readback
    return fin.cpu().numpy()
""")
    assert _rules(fs) == [] and _rules(fs, waived=True) == ["GL002"] * 2


@pytest.mark.parametrize("expr", [
    "float(lr)", "int(self.count)", "bool(flags[0])", "x.to(dev)",
    "x.to(torch.bfloat16)", "x.float()", "x.sum()",
])
def test_gl002_device_side_and_host_arithmetic_ok(tmp_path, expr):
    fs = _lint(tmp_path, f"""
import torch
# graftlint: hot-path
def step(self, x, lr, flags, dev):
    return {expr}
""")
    assert _rules(fs) == []


def test_gl002_only_in_marked_functions(tmp_path):
    fs = _lint(tmp_path, """
def helper(loss):
    return loss.item()

def step(loss):  # graftlint: hot-path
    def inner():
        return loss.item()
    return inner
""")
    # unmarked and nested functions are not hot paths
    assert _rules(fs) == []


def test_gl002_marker_on_def_line(tmp_path):
    fs = _lint(tmp_path, """
def step(loss):  # graftlint: hot-path
    return loss.item()
""")
    assert _rules(fs) == ["GL002"]


# ---------------------------------------------------------------------------
# GL007 in its torch form
# ---------------------------------------------------------------------------
_GL007_HEADER = """
import torch
from cxxnet_tpu_torch.parallel.sharding import ParamCut, ZeroCut
"""


@pytest.mark.parametrize("stmt,what", [
    ("acc = torch.zeros_like(grads)", "zeros_like('grads')"),
    ("acc = torch.empty_like(self.params[lk][pn])",
     "empty_like('params')"),
    ("acc = torch.full_like(master[lk][pn], 0.5)", "full_like('master')"),
    ("acc = torch.ones_like(w)", "ones_like('w')"),
    ("return torch.zeros_like(ustate[lk])", "zeros_like('ustate')"),
])
def test_gl007_allocator_of_a_weight_flags(tmp_path, stmt, what):
    fs = _lint(tmp_path, _GL007_HEADER + f"""
def step(self, grads, master, w, ustate, lk, pn):
    {stmt}
    return acc
""")
    assert _rules(fs) == ["GL007"]
    assert what in fs[0].message and "'step'" in fs[0].message


def test_gl007_mapped_allocator_flags(tmp_path):
    fs = _lint(tmp_path, _GL007_HEADER + """
def step(self, gtree):
    self._accum = _tree_map(torch.zeros_like, gtree)
    moments = list(map(torch.empty_like, self.moments))
""")
    assert _rules(fs) == ["GL007", "GL007"]
    assert "'gtree'" in fs[0].message and "_tree_map" in fs[0].message


@pytest.mark.parametrize("stmt", [
    "acc = cut.owned(torch.zeros_like(grads), lk, pn)",
    "acc = torch.zeros(cut.cut_shape(lk, pn)) + torch.zeros_like(grads)",
    "tree = cut.local_tree({k: torch.zeros_like(v) for k, v in params})",
    "acc = z.reduce_scatter({k: torch.zeros_like(g) for k, g in grads})",
])
def test_gl007_statement_through_the_cut_ok(tmp_path, stmt):
    fs = _lint(tmp_path, _GL007_HEADER + f"""
def step(cut, z, grads, params, lk, pn):
    {stmt}
""")
    assert _rules(fs) == []


def test_gl007_mesh_less_module_not_flagged(tmp_path):
    # no cut imported and not under parallel/: a rank holds whole tensors
    fs = _lint(tmp_path, """
import torch

def step(params, grads):
    return torch.zeros_like(params), torch.empty_like(grads)
""")
    assert _rules(fs) == []


def test_gl007_modules_under_parallel_are_mesh_aware(tmp_path):
    src = """
import torch

def step(grads):
    return torch.zeros_like(grads)
"""
    d = tmp_path / "pkg" / "parallel"
    d.mkdir(parents=True)
    (d / "m.py").write_text(src)
    fs = port_lint.lint_file(str(d / "m.py"), os.path.join(
        "pkg", "parallel", "m.py"))
    assert _rules(fs) == ["GL007"]
    assert _rules(_lint(tmp_path, src)) == []


def test_gl007_small_values_and_shapes_ok(tmp_path):
    fs = _lint(tmp_path, _GL007_HEADER + """
def step(x, rows, buf):
    y = torch.zeros_like(x)      # 'x' is not weight-named
    z = torch.empty_like(rows)
    return y, z, torch.empty_like(buf)
""")
    assert _rules(fs) == []


def test_gl007_waivable_and_stale_waiver_reported(tmp_path):
    fs = _lint(tmp_path, _GL007_HEADER + """
def step(grads, x):
    # graftlint: disable=GL007 stage 1 keeps the gradients whole
    acc = torch.zeros_like(grads)
    # graftlint: disable=GL007 nothing to excuse here
    y = torch.zeros_like(x)
    return acc, y
""")
    assert _rules(fs, waived=True) == ["GL007"]
    assert _rules(fs) == ["GL091"]


def test_gl007_finds_of_the_port_tree_carry_their_reasons():
    """The port lints clean under GL007: its two finds (the trainer's
    accumulator and the gather target of a cut update) carry reasoned
    waivers naming what keeps the tensor whole."""
    findings, _, _ = port_lint.lint_paths([PKG], rules=["GL007"])
    assert findings and all(f.waived and f.reason for f in findings)
    assert {os.path.basename(f.path) for f in findings} == {"trainer.py"}


def test_jax_only_rules_are_unknown_waivers(tmp_path):
    fs = _lint(tmp_path, """
x = 1  # graftlint: disable=GL005 no donation in eager torch
""")
    assert _rules(fs) == ["GL090"]


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------
def test_port_tree_has_zero_unwaived_findings():
    findings, n_files, _ = port_lint.lint_paths([PKG])
    unwaived = [f for f in findings if not f.waived]
    assert unwaived == [], "\n".join(
        f"{f.path}:{f.line}: {f.rule} {f.message}" for f in unwaived)
    assert n_files > 80
    waived = [f for f in findings if f.waived]
    assert waived and all(f.reason for f in waived)


def test_port_hot_paths_are_marked():
    """The microstep body of update_chunk, the Server's dispatch and the
    staging worker carry the hot-path marker, so GL002 watches them."""
    want = {("nnet/trainer.py", "_microsteps"), ("nnet/trainer.py",
                                                "_micro"),
            ("nnet/trainer.py", "update_chunk"),
            ("serve/server.py", "_run_batch"), ("serve/server.py", "run"),
            ("io/prefetch.py", "_run")}
    found = set()
    for rel, _ in want:
        path = os.path.join(PKG, rel)
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if "graftlint: hot-path" in line:
                nxt = lines[i + 1] if i + 1 < len(lines) else ""
                for r, name in want:
                    if r == rel and f"def {name}(" in nxt:
                        found.add((r, name))
    assert found == want


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _cli(*args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=300)


def test_cli_lints_the_port_tree_clean():
    r = _cli("--dev", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "graftlint: 0 finding(s)" in r.stdout


def test_cli_exit_codes_and_json_report(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\nt = time.time()\n")
    report = tmp_path / "report.json"
    r = _cli(str(bad), "--json", str(report))
    assert r.returncode == 1
    rep = json.loads(report.read_text())
    assert rep["lint"]["unwaived"] == 1
    assert rep["lint"]["findings"][0]["rule"] == "GL004"
    good = tmp_path / "good.py"
    good.write_text("import time\nt = time.monotonic()\n")
    r = _cli(str(good), "--check-configs", os.path.join(REPO, "examples"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 unknown key(s)" in r.stdout


def test_cli_refuses_vacuous_scan_and_usage_errors(tmp_path):
    assert _cli(str(tmp_path / "no_such_dir")).returncode == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert _cli(str(empty)).returncode == 2
    assert _cli("--check-configs", str(empty)).returncode == 2
    assert _cli("--no-such-flag").returncode == 2
    assert _cli("--seed-inversion").returncode == 2


def test_cli_list_rules_and_dump_keys():
    r = _cli("--list-rules")
    assert r.returncode == 0
    assert [ln.split()[0] for ln in r.stdout.splitlines()] == sorted(
        port_lint.RULES)
    r = _cli("--dump-keys")
    assert r.returncode == 0 and "batch_size" in r.stdout


def test_cli_audits_default_to_the_card():
    """With no card, --graph-audit / --lock-audit raise and name
    --dev cpu instead of running on the CPU."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    for flag in ("--graph-audit", "--lock-audit"):
        r = subprocess.run(
            [sys.executable, "-m", "cxxnet_tpu_torch.analysis", flag],
            capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
        assert r.returncode != 0
        assert "--dev cpu" in r.stderr
