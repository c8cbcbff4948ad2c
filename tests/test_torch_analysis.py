"""The port's saralint (``repro_torch.analysis``): every check fires at the
right ``file:line`` and severity on a known-bad fixture and stays silent
on a known-good one, the inline-suppression round trip, the CLI, the
port's tree scanning clean, and parity with the reference's linter
(``repro.analysis``) on the same fixture corpora.  The kernel-contract
tests stand in for the reference's pallas-contract ones; the torch forms
of dispatch-escape stand in for retrace-hazard, which has no counterpart
in an eager port."""

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import run_paths
from repro_torch.analysis.core import render_report

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def write(tmp_path, rel, text):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text))
    return p


def lineno(path: Path, needle: str) -> int:
    """1-indexed line of the first line containing ``needle``."""
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        if needle in line:
            return i
    raise AssertionError(f"{needle!r} not in {path}")


def by_check(findings, check):
    return [f for f in findings if f.check == check and not f.suppressed]


# ---------------------------------------------------------------------------
# dispatch-escape
# ---------------------------------------------------------------------------

def test_dispatch_escape_fires_on_raw_gemms(tmp_path):
    p = write(tmp_path, "models/bad.py", """\
        import torch

        def layer(x, q, k, params):
            y = torch.einsum("mk,kn->mn", x, params["w_proj"])
            s = torch.einsum("bqd,bkd->bqk", q, k)
            z = x @ params["w1"]
            return y, s, z
        """)
    found = by_check(run_paths([str(tmp_path)]), "dispatch-escape")
    assert len(found) == 3
    sev = {f.line: f.severity for f in found}
    assert sev[lineno(p, "w_proj")] == "error"       # weight operand
    assert sev[lineno(p, "bqd,bkd")] == "warning"    # activation-activation
    assert sev[lineno(p, "@ params")] == "error"     # matmul vs weight
    assert all(f.path == "models/bad.py" for f in found)


def test_dispatch_escape_ignores_dispatch_and_out_of_scope(tmp_path):
    write(tmp_path, "models/good.py", """\
        from repro_torch import dispatch

        def layer(x, w):
            return dispatch.gemm(x, w, site="layer.proj")
        """)
    write(tmp_path, "kernels/free.py", """\
        import torch

        def helper(a, w):
            return torch.einsum("mk,kn->mn", a, w)   # kernels/ not in scope
        """)
    assert by_check(run_paths([str(tmp_path)]), "dispatch-escape") == []


def test_dispatch_escape_torch_forms(tmp_path):
    """The contractions with no jnp spelling: the matmul / mm / bmm
    methods (the receiver an operand), F.linear, addmm / baddbmm, and an
    nn.Linear built in scope (always an error); casts and views are looked
    through; module functions are not methods."""
    p = write(tmp_path, "models/forms.py", """\
        import numpy as np
        import torch
        import torch.nn.functional as F
        from torch import nn

        def layer(x, h, a, b, w_gate, params):
            y1 = x.matmul(w_gate)
            y2 = a.bmm(b)
            y3 = params["w2"].t().mm(h)
            y4 = F.linear(x, params["w_up"])
            y5 = torch.addmm(h, a, b)
            y6 = torch.baddbmm(h, a, b.to(torch.float32))
            y7 = x.float() @ w_gate.contiguous()
            y8 = np.dot(a, b)
            proj = nn.Linear(8, 8)
            y9 = torch.nn.Linear(8, 8, bias=False)
            return y1, y2, y3, y4, y5, y6, y7, y8, proj, y9
        """)
    found = by_check(run_paths([str(tmp_path)]), "dispatch-escape")
    sev = {f.line: f.severity for f in found}
    assert sev == {
        lineno(p, "x.matmul"): "error", lineno(p, "a.bmm"): "warning",
        lineno(p, ".mm(h)"): "error", lineno(p, "F.linear"): "error",
        lineno(p, "addmm"): "warning", lineno(p, "baddbmm"): "warning",
        lineno(p, "x.float() @"): "error", lineno(p, "np.dot"): "warning",
        lineno(p, "nn.Linear(8, 8)"): "error",
        lineno(p, "torch.nn.Linear"): "error"}
    assert len(found) == 10


# ---------------------------------------------------------------------------
# kernel-contract (the counterpart of pallas-contract)
# ---------------------------------------------------------------------------

_BUILD = """\
    import ctypes

    _P, _I = ctypes.c_void_p, ctypes.c_int
    SIGNATURES = {
        "lib_a": {
            "a_launch": [_I, _P] + [_I] * 3,
            "b_launch": [_P] * 2,
        },
    }


    def library(name):
        raise RuntimeError("fixture")
    """


def test_kernel_contract_launch_arity(tmp_path):
    write(tmp_path, "kernels/_build.py", _BUILD)
    p = write(tmp_path, "kernels/k.py", """\
        from . import _build


        def args3():
            return (1, 2, 3)


        def run(x, fn):
            _build.library("lib_a").a_launch(1, x, 3, 4)
            lib = _build.library("lib_a")
            lib.b_launch(x)
            _build.library("lib_a").c_launch(x)
            getattr(_build.library("lib_a"), fn)(x, *args3())
            _build.library("lib_a").a_launch(x, *x)


        def one():
            run(0, "a_launch")
            run(1, "nope_launch")
        """)
    found = by_check(run_paths([str(tmp_path)]), "kernel-contract")
    msgs = {}
    for f in found:
        msgs.setdefault(f.line, []).append(f.message)
    assert "4 argument(s)" in msgs[lineno(p, "a_launch(1, x")][0]
    assert "declares 5" in msgs[lineno(p, "a_launch(1, x")][0]
    assert "1 argument(s)" in msgs[lineno(p, "lib.b_launch")][0]
    assert "does not declare" in msgs[lineno(p, "c_launch")][0]
    # fn resolves through the module's calls of run(): a_launch takes 5
    # but gets 4, and nope_launch is undeclared
    got = msgs[lineno(p, "getattr(")]
    assert len(got) == 2 and any("nope_launch" in m for m in got) \
        and any("4 argument(s)" in m for m in got)
    # a starred argument of no fixed length is skipped, never guessed
    assert lineno(p, "a_launch(x, *x)") not in msgs
    assert len(found) == 5


def test_kernel_contract_clean_call_site(tmp_path):
    write(tmp_path, "kernels/_build.py", _BUILD)
    write(tmp_path, "kernels/k.py", """\
        from . import _build


        def launch_args(x):
            return (x, 1, 2, 3)


        def run(x, lse):
            _build.library("lib_a").a_launch(1, x, 3, 4, 5)
            lib = _build.library("lib_a")
            launch = lib.b_launch if lse else lib.b_launch
            launch(x, x)
            _build.library("lib_a").a_launch(x, *launch_args(x))
        """)
    assert by_check(run_paths([str(tmp_path)]), "kernel-contract") == []


def test_kernel_contract_twin_registry(tmp_path):
    k = write(tmp_path, "kernels/k.py", """\
        def good_cuda(x):
            return x


        def good_plain(x):
            return x


        def other_attention_plain(x):
            return x


        def aliased_cuda(x):
            return x


        def lonely_cuda(x):
            return x


        aliased_plain = other_attention_plain
        """)
    ops = write(tmp_path, "kernels/ops.py", """\
        from .k import (aliased_cuda, good_cuda, good_plain, lonely_cuda,
                        other_attention_plain)


        class _Fn:
            @staticmethod
            def forward(x):
                return good_cuda(x) if x else good_plain(x)


        def good(x):
            return _Fn.forward(x)


        def other_attention(x):
            if x:
                return other_attention_plain(x)
            return aliased_cuda(x)


        def forgetful(x):
            return aliased_cuda(x)


        def lonely(x):
            return lonely_cuda(x)


        def launch_counts():
            return {"good": good_cuda.launches,
                    "plain_calls": good_plain.calls}
        """)
    found = by_check(run_paths([str(tmp_path)]), "kernel-contract")
    lines = sorted((f.path, f.line) for f in found)
    lc = lineno(ops, "def launch_counts")
    assert lines == sorted([
        ("kernels/k.py", lineno(k, "def lonely_cuda")),        # no twin
        ("kernels/ops.py", lineno(ops, "def forgetful")),       # twin unused
        ("kernels/ops.py", lc),     # aliased_cuda's launches not reported
        ("kernels/ops.py", lc)])    # its twin not in plain_calls
    msgs = " ".join(f.message for f in found)
    assert "lonely_plain" in msgs and "other_attention_plain" in msgs
    assert "aliased_cuda.launches" in msgs
    assert "other_attention_plain.calls" in msgs


def test_kernel_contract_holds_the_real_kernels(tmp_path):
    """The port's kernels/ scans clean, every launch names a declared
    function, six launches are held to their argument counts, and
    breaking a twin, a plain-call count or a signature is caught."""
    from repro_torch.analysis.checks import kernel_contract as kc
    from repro_torch.analysis.core import Context, collect_files
    files, root = collect_files([str(PKG)])
    resolved, counted = set(), 0
    for sf in files:
        if not kc._in_kernels(sf):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                t = kc._targets(sf, node.func, node)
                if t:
                    resolved |= {fn for _, fn in t}
                    counted += kc._arg_count(sf, node) is not None
    sigs = kc._signatures(Context(files, root))
    assert resolved == {fn for lib in sigs.values() for fn in lib}
    assert len(resolved) == 13 and counted == 5
    dst = tmp_path / "kernels"
    shutil.copytree(PKG / "kernels", dst,
                    ignore=shutil.ignore_patterns("csrc", "__pycache__"))
    assert by_check(run_paths([str(tmp_path)]), "kernel-contract") == []

    def broken(rel, old, new):
        p = dst / rel
        text = p.read_text()
        assert old in text
        p.write_text(text.replace(old, new, 1))
        found = by_check(run_paths([str(tmp_path)]), "kernel-contract")
        p.write_text(text)
        return found

    f = broken("ops.py", "+ adaptnetx_plain.calls", "")
    assert len(f) == 1 and "adaptnetx_plain.calls" in f[0].message
    f = broken("paged_attn.py", "def paged_prefix_plain(",
               "def paged_prefix_x(")
    assert len(f) == 1 and "paged_prefix_cuda" in f[0].message
    f = broken("_build.py", '"flash_fwd_launch": [_I, _P, _P, _P, _P, _P]',
               '"flash_fwd_launch": [_I, _P, _P, _P, _P]')
    assert len(f) == 1 and "declares 17" in f[0].message


# ---------------------------------------------------------------------------
# cow-gate
# ---------------------------------------------------------------------------

def test_cow_gate_flags_ungated_writer(tmp_path):
    p = write(tmp_path, "serving/writer.py", """\
        def ungated(arena, rows, k):
            return _arena_write_chunk(arena, rows, k)

        def gated(pool, arena, rows, k):
            pool.ensure_writable("r", 0)
            return _arena_write_chunk(arena, rows, k)

        def sanitize(arena, bid):
            arena.poison_page(bid)
        """)
    found = by_check(run_paths([str(tmp_path)]), "cow-gate")
    assert [f.line for f in found] == [lineno(p, "def ungated") + 1,
                                       lineno(p, "poison_page")]
    assert "ungated" in found[0].message and "sanitize" in found[1].message


def test_cow_gate_gate_function_itself_exempt(tmp_path):
    write(tmp_path, "serving/pool.py", """\
        def ensure_writable(self, rid, i):
            return copy_page(self.arena, i)
        """)
    assert by_check(run_paths([str(tmp_path)]), "cow-gate") == []


def test_cow_gate_writers_exist_in_the_port():
    """Every writer and gate the check knows is defined or assigned in
    the port, so a rename cannot quietly empty the check."""
    from repro_torch.analysis.checks.cow_gate import GATES, WRITERS
    names = set()
    for p in PKG.rglob("*.py"):
        if "analysis" in p.parts:
            continue
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                    elif isinstance(t, ast.Attribute):
                        names.add(t.attr)
    assert not (WRITERS | GATES) - names, (WRITERS | GATES) - names


# ---------------------------------------------------------------------------
# obs-taxonomy
# ---------------------------------------------------------------------------

_TRACE_FIXTURE = """\
    CATEGORIES = ("step", "request")
    STEP_PHASES = ("decode", "sample")
    COUNTERS = ("jit_compiles",)
    GAUGES = ("kv_pages_in_use",)
    """


def test_obs_taxonomy_checks_literals_against_declarations(tmp_path):
    write(tmp_path, "obs/trace.py", _TRACE_FIXTURE)
    p = write(tmp_path, "serving/emit.py", """\
        def record(obs, timeline, items):
            obs.count("jit_compiles", 1)
            obs.count("jit_compile", 1)
            obs.gauge("kv_pages_in_use", 3)
            timeline.phase("decodee")
            obs.instant("step", "x")
            obs.instant("stepp", "x")
            items.count("not_a_recorder")
        """)
    found = by_check(run_paths([str(tmp_path)]), "obs-taxonomy")
    assert sorted(f.line for f in found) == [
        lineno(p, '"jit_compile"'),
        lineno(p, '"decodee"'),
        lineno(p, '"stepp"'),
    ]
    assert all(f.severity == "error" for f in found)


def test_obs_taxonomy_skips_without_trace_module(tmp_path):
    write(tmp_path, "serving/emit.py", """\
        def record(obs):
            obs.count("anything_goes", 1)
        """)
    assert by_check(run_paths([str(tmp_path)]), "obs-taxonomy") == []


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

def test_suppression_round_trip(tmp_path):
    p = write(tmp_path, "models/supp.py", """\
        import torch

        def scores(q, k):
            # saralint: ok[dispatch-escape] activation-activation score
            s = torch.einsum("bqd,bkd->bqk", q, k)
            t = torch.einsum("bqd,bkd->bqk", q, k)  # saralint: ok[dispatch-escape]
            return s + t
        """)
    findings = run_paths([str(tmp_path)])
    supp = [f for f in findings if f.suppressed]
    assert {f.line for f in supp} == {lineno(p, "s = torch"),
                                      lineno(p, "t = torch")}
    assert supp[0].suppress_reason == "activation-activation score"
    # the reason-less pragma suppresses its finding but is itself an error
    active = [f for f in findings if not f.suppressed]
    assert [f.check for f in active] == ["suppression-reason"]
    assert active[0].line == lineno(p, "t = torch")
    report = render_report(findings)
    assert "2 suppressed" in report and "1 error(s)" in report


def test_wrong_check_id_does_not_suppress(tmp_path):
    write(tmp_path, "models/supp2.py", """\
        import torch

        def scores(q, k):
            return torch.einsum("bqd,bkd->bqk", q, k)  # saralint: ok[cow-gate] wrong id
        """)
    found = by_check(run_paths([str(tmp_path)]), "dispatch-escape")
    assert len(found) == 1 and not found[0].suppressed


# ---------------------------------------------------------------------------
# CLI + the port's tree
# ---------------------------------------------------------------------------

def _run_cli(*args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=cwd, env=env, capture_output=True, text=True)


def test_cli_real_tree_is_clean():
    r = _run_cli("src/repro_torch", "--json")
    assert r.returncode == 0, r.stdout + r.stderr
    payload = json.loads(r.stdout)
    assert payload["summary"]["errors"] == 0
    assert payload["summary"]["warnings"] == 0
    # every suppression in the tree documents its reason
    supp = [f for f in payload["findings"] if f["suppressed"]]
    assert supp and all(f["suppress_reason"] for f in supp)
    # the default path is the port's tree
    r = _run_cli()
    assert r.returncode == 0 and "0 error(s), 0 warning(s)" in r.stdout


def test_cli_exit_code_on_findings(tmp_path):
    write(tmp_path, "models/bad.py", """\
        import torch

        def layer(x, w):
            return torch.einsum("mk,kn->mn", x, w)
        """)
    r = _run_cli(str(tmp_path))
    assert r.returncode == 1
    assert "dispatch-escape" in r.stdout
    # a warning gates as an error does
    write(tmp_path, "models/bad.py", """\
        import torch

        def layer(q, k):
            return torch.einsum("bqd,bkd->bqk", q, k)
        """)
    r = _run_cli(str(tmp_path))
    assert r.returncode == 1 and "1 warning(s)" in r.stdout


def test_cli_list_checks():
    r = _run_cli("--list-checks")
    assert r.returncode == 0
    for cid in ("dispatch-escape", "cow-gate", "obs-taxonomy",
                "kernel-contract"):
        assert cid in r.stdout
    # no counterpart in the port: BlockSpecs and jit retraces
    assert "pallas-contract" not in r.stdout
    assert "retrace-hazard" not in r.stdout


# ---------------------------------------------------------------------------
# parity with the reference's linter on the same corpora
# ---------------------------------------------------------------------------

def _keys(findings, checks):
    return sorted((f.check, f.severity, f.path, f.line) for f in findings
                  if f.check in checks and not f.suppressed)


def _both(root):
    from repro.analysis import run_paths as ref_run_paths
    return ref_run_paths([str(root)]), run_paths([str(root)])


def test_parity_cow_gate_obs_taxonomy_suppressions(tmp_path):
    """cow-gate, obs-taxonomy and suppression-reason give the reference's
    (check, severity, path, line) lists on the reference's corpora and on
    one over every writer both packages know."""
    from repro.analysis.checks.cow_gate import WRITERS as REF_WRITERS
    from repro_torch.analysis.checks.cow_gate import WRITERS
    shared = sorted(REF_WRITERS & WRITERS)
    assert {"_arena_write_chunk", "copy_page", "apply_moves",
            "paged_prefill_write", "_draft_loop"} <= set(shared)
    write(tmp_path, "serving/writer.py", """\
        def ungated(arena, rows, k):
            return _arena_write_chunk(arena, rows, k)

        def gated(pool, arena, rows, k):
            pool.ensure_writable("r", 0)
            return _arena_write_chunk(arena, rows, k)
        """)
    write(tmp_path, "serving/pool.py", """\
        def ensure_writable(self, rid, i):
            return copy_page(self.arena, i)
        """)
    body = "\n".join(
        f"def ungated_{i}(self, x):\n    self.{n}(x)\n    {n}(x)\n\n"
        f"def gated_{i}(self, x):\n    self._cow_chunk_pages(x)\n"
        f"    self.{n}(x)\n\n"
        f"def reasoned_{i}(self, x):\n"
        f"    # saralint: ok[cow-gate] private pages\n    self.{n}(x)\n\n"
        f"def reasonless_{i}(self, x):\n    self.{n}(x)  # saralint: ok[cow-gate]\n"
        for i, n in enumerate(shared))
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "all_writers.py").write_text(body)
    (tmp_path / "kernels").mkdir()
    (tmp_path / "kernels" / "out_of_scope.py").write_text(
        "def f(a):\n    copy_page(a)\n")
    write(tmp_path, "obs/trace.py", _TRACE_FIXTURE)
    write(tmp_path, "serving/emit.py", """\
        def record(obs, timeline, items, rec):
            obs.count("jit_compiles", 1)
            obs.count("jit_compile", 1)
            obs.gauge("kv_pages_in_use", 3)
            rec.gauge("kv_pages", 3)
            timeline.phase("decodee")
            obs.instant("step", "x")
            obs.span("stepp", "x")
            items.count("not_a_recorder")
            # saralint: ok[obs-taxonomy]
            obs.emit("nope", "x")
        """)
    ref, port = _both(tmp_path)
    checks = ("cow-gate", "obs-taxonomy", "suppression-reason")
    want = _keys(ref, checks)
    assert _keys(port, checks) == want
    assert {c for c, *_ in want} == set(checks)
    assert len([k for k in want if k[0] == "cow-gate"]) == len(shared) + 1
    assert len([k for k in want if k[0] == "suppression-reason"]) == \
        len(shared) + 1


# each pair spells one contraction in jnp and in torch, line for line
_ESCAPE_PAIRS = [
    ("import jax.numpy as jnp", "import torch",
     'y = jnp.einsum("mk,kn->mn", x, params["w_proj"])',
     'y = torch.einsum("mk,kn->mn", x, params["w_proj"])'),
    ("import jax.numpy as jnp", "import torch",
     'y = jnp.einsum("bqd,bkd->bqk", q, k)',
     'y = torch.einsum("bqd,bkd->bqk", q, k)'),
    ("import jax.numpy as jnp", "import torch",
     "y = jnp.matmul(x, w1)", "y = torch.matmul(x, w1)"),
    ("import jax.numpy as jnp", "import torch",
     "y = jnp.dot(q, k)", "y = torch.mm(q, k)"),
    ("import jax.numpy as jnp", "import torch",
     "y = jnp.tensordot(x, kernel, 1)", "y = torch.tensordot(x, kernel, 1)"),
    ("import jax.numpy as jnp", "import torch",
     "y = x.astype(jnp.float32) @ wt.T", "y = x.to(torch.float32) @ wt.T"),
    ("import jax.numpy as jnp", "import torch",
     "y = q @ k.swapaxes(-1, -2)", "y = q @ k.transpose(-1, -2)"),
    ("import jax.numpy as jnp", "import torch",
     "y = jnp.dot(x, self.weight.reshape(4, 4))",
     "y = torch.matmul(x, self.weight.reshape(4, 4))"),
    ("import numpy as np", "import numpy as np",
     'y = np.einsum("ij,jk->ik", h, p["w2"])',
     'y = np.einsum("ij,jk->ik", h, p["w2"])'),
    ("import jax.numpy as jnp", "import torch",
     "y = jnp.einsum('ij,jk->ik', h, g)  # saralint: ok[dispatch-escape] why",
     "y = torch.einsum('ij,jk->ik', h, g)  # saralint: ok[dispatch-escape] why"),
]


@pytest.mark.parametrize("ref_import,port_import,ref_line,port_line",
                         _ESCAPE_PAIRS)
@pytest.mark.parametrize("rel", ["models/layer.py", "core/adaptnet.py",
                                 "serving/out_of_scope.py"])
def test_parity_dispatch_escape(tmp_path, rel, ref_import, port_import,
                                ref_line, port_line):
    """The same code spelt in jnp and in torch gives the reference's
    dispatch-escape lines and severities (and none out of scope)."""
    src = ("{imp}\n\n\ndef layer(self, x, q, k, h, g, w1, wt, kernel, "
           "params, p):\n    {line}\n    return y\n")
    write(tmp_path / "ref", rel, src.format(imp=ref_import, line=ref_line))
    write(tmp_path / "port", rel, src.format(imp=port_import,
                                             line=port_line))
    from repro.analysis import run_paths as ref_run_paths
    ref = [(f.severity, f.path, f.line, f.suppressed) for f in
           ref_run_paths([str(tmp_path / "ref")])
           if f.check == "dispatch-escape"]
    port = [(f.severity, f.path, f.line, f.suppressed) for f in
            run_paths([str(tmp_path / "port")])
            if f.check == "dispatch-escape"]
    assert port == ref
    assert bool(ref) == (rel != "serving/out_of_scope.py")
