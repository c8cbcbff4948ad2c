"""Observability parity: the port's ``repro_torch.obs`` against the JAX
package's ``repro.obs``.

- the reference ``tests/test_obs.py``'s recorder, span, timeline and
  export cases, each run with the same calls on both packages' objects:
  equal event sequences (category, name, phase, track, args; timestamps
  aside), equal counters, gauges, raised errors and validator verdicts;
- a traced reduced-llama run (paged, chunk 8, greedy, step clock) through
  the port's engine and the JAX engine (pinned to ``execute="xla"``) on
  one trace: the request, step, dispatch and arena events in the same
  order with the same args (``ts``, ``dur`` and compile events aside),
  equal counters (``jit_compiles`` included) and gauges, and
  ``site_timings`` with the same scopes and sites.  One difference is
  named: a dispatch event's ``backend`` is the port's ``"torch"`` where
  the reference says ``"xla"`` (the plain version on the CPU, ROADMAP.md
  section 3);
- the same comparison on the spec path (``spec_draft="self"``) and on
  reduced rwkv6 (the dense slot layout), where the decode scope's
  dispatch events record M = num_slots against the reference's M = 1 (the
  port batches the slots, the reference vmaps them; ROADMAP.md section 3)
  and the analytic costs follow M; those three args are compared apart;
- each package's ``validate_trace`` accepting the other's export;
- ``JitWatch`` (a new argument signature counts a compile) and the
  registry's dispatch events (emitted only inside a call with a new
  signature, once a site), and every recorder call site of the port held
  to the closed taxonomy.

Tolerance: none; every compared value is exact.
"""

import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.models.api import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.serving import EngineConfig, Request, ServingEngine

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _ev(e):
    """An event without its timestamps."""
    return (e.cat, e.name, e.ph, e.track,
            json.dumps(e.args, sort_keys=True, default=str))


def _raises(fn):
    try:
        fn()
    except Exception as exc:             # noqa: BLE001 — compared by type
        return type(exc).__name__
    return None


# ---------------------------------------------------------------------------
# the reference's unit cases, on both packages' objects
# ---------------------------------------------------------------------------

def case_tiers(ns, tmp_path):
    out = []
    for spans in (False, True):
        rec = ns.TraceRecorder(spans=spans)
        rec.count("c")
        rec.count("c", 2)
        rec.gauge("g", 0.5)
        rec.instant("arena", "reserve", rid="r0")
        with rec.span("step", "decode"):
            pass
        out.append((dict(rec.counters), dict(rec.gauges),
                    [_ev(e) for e in rec.events()]))
    assert out[0][0] == {"c": 3} and len(out[0][2]) == 0
    assert {e[0] for e in out[1][2]} == {"arena", "step"}
    return out


def case_ring(ns, tmp_path):
    rec = ns.TraceRecorder(capacity=4, spans=True)
    for i in range(10):
        rec.instant("arena", f"e{i}")
    assert len(rec) == 4 and rec.dropped == 6
    return rec.dropped, [_ev(e) for e in rec.events()]


def case_scope_wall(ns, tmp_path):
    rec = ns.TraceRecorder()
    rec.add_scope_wall("decode", 0.25)
    rec.add_scope_wall("decode", 0.75)
    assert rec.scope_wall["decode"] == [2, 1.0]
    return dict(rec.scope_wall)


def case_retire_once(ns, tmp_path):
    rec = ns.TraceRecorder(spans=True)
    tr = ns.RequestTracker(rec)
    tr.on_submit("r0")
    tr.on_admit("r0", slot=0)
    tr.on_first_token("r0")
    tr.on_retire("r0", tokens=5)
    err = _raises(lambda: tr.on_retire("r0"))
    assert tr.closed == 1 and err == "TraceError"
    return tr.closed, err, [_ev(e) for e in rec.events()]


def case_preempt_mid_prefill(ns, tmp_path):
    rec = ns.TraceRecorder(spans=True)
    tr = ns.RequestTracker(rec)
    tr.on_submit("r0")
    tr.on_admit("r0", slot=0)
    tr.on_prefill_chunk("r0", tokens=8, dur=0.01)
    tr.on_preempt("r0")
    assert tr.open_requests() == {"r0": "queued"}
    return tr.open_requests(), [_ev(e) for e in rec.events()]


def case_readmit_cycle(ns, tmp_path):
    rec = ns.TraceRecorder(spans=True)
    tr = ns.RequestTracker(rec)
    tr.on_submit("r0")
    for cycle in range(3):
        tr.on_admit("r0", slot=0)
        if cycle < 2:
            tr.on_preempt("r0")
    tr.on_retire("r0")
    tr.on_submit("r1")
    tr.on_finish("r1", "expired", reason="deadline")
    assert tr.closed == 2
    return tr.closed, [_ev(e) for e in rec.events()]


def case_illegal(ns, tmp_path):
    rec = ns.TraceRecorder(spans=True)
    tr = ns.RequestTracker(rec)
    errs = [_raises(lambda: tr.on_retire("ghost"))]
    tr.on_submit("r0")
    errs += [_raises(lambda: tr.on_submit("r0")),
             _raises(lambda: tr.on_retire("r0")),
             _raises(lambda: tr.on_preempt("r0"))]
    assert errs == ["TraceError"] * 4
    return errs, [_ev(e) for e in rec.events()]


def case_empty_export(ns, tmp_path):
    rec = ns.TraceRecorder(spans=True)
    doc = json.loads(json.dumps(ns.to_chrome_trace(rec)))
    p = tmp_path / f"empty_{ns.__name__}.json"
    ns.write_chrome_trace(str(p), rec)
    out = (ns.validate_trace(doc),
           ns.validate_trace(json.loads(p.read_text())), doc)
    assert out[0] == [] and out[1] == []
    return out


def case_timeline(ns, tmp_path):
    rec = ns.TraceRecorder(spans=True)
    tl = ns.StepTimeline(rec)
    for _ in range(3):
        tl.begin()
        with tl.phase("schedule"):
            pass
        with tl.phase("decode", lanes=2):
            pass
        with tl.phase("sample"):
            pass
        tl.end(active=2)
    doc = json.loads(json.dumps(ns.to_chrome_trace(rec)))
    errs = ns.validate_trace(doc, require_categories=("step",))
    assert tl.steps == 3 and errs == []
    for step in range(3):
        evs = sorted((e for e in doc["traceEvents"] if e.get("ph") == "X"
                      and e["args"].get("step") == step),
                     key=lambda e: e["ts"])
        root = next(e for e in evs if e["name"] == "engine_step")
        kids = [e for e in evs if e is not root]
        assert [k["name"] for k in kids] == ["schedule", "decode", "sample"]
        end = root["ts"]
        for k in kids:
            assert k["ts"] >= end - 1e-3
            end = k["ts"] + k["dur"]
        assert end <= root["ts"] + root["dur"] + 1e-3
    return tl.steps, errs, [_ev(e) for e in rec.events()]


def case_timeline_misuse(ns, tmp_path):
    tl = ns.StepTimeline(ns.TraceRecorder(spans=True))
    errs = [_raises(lambda: tl.phase("decode")), _raises(tl.end)]
    tl.begin()
    errs.append(_raises(tl.begin))
    assert errs == ["TraceError"] * 3
    return errs


def case_validate_corruption(ns, tmp_path):
    bad = {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 0, "cat": "step", "name": "engine_step",
         "ts": 0.0, "dur": 100.0, "args": {"step": 0}},
        {"ph": "X", "pid": 1, "tid": 0, "cat": "step", "name": "schedule",
         "ts": 0.0, "dur": 60.0, "args": {"step": 0}},
        {"ph": "X", "pid": 1, "tid": 0, "cat": "step", "name": "decode",
         "ts": 50.0, "dur": 20.0, "args": {"step": 0}}]}
    out = (ns.validate_trace([]), ns.validate_trace({"traceEvents":
                                                     [{"ph": "Z"}]}),
           ns.validate_trace(bad),
           ns.validate_trace({"traceEvents": []},
                             require_categories=("compile",)))
    assert out[0] and out[1] and any("overlaps" in e for e in out[2])
    assert any("no 'compile'" in e for e in out[3])
    return out


def case_jsonl(ns, tmp_path):
    rec = ns.TraceRecorder(spans=True)
    rec.count("jit_compiles")
    rec.instant("dispatch", "site", track="dispatch", m=64, k=32, n=128)
    p = tmp_path / f"t_{ns.__name__}.jsonl"
    ns.write_jsonl(str(p), rec, meta={"arch": "llama3.2-1b"})
    lines = [json.loads(x) for x in p.read_text().splitlines()]
    assert lines[0]["record"] == "meta" and \
        lines[0]["counters"]["jit_compiles"] == 1
    for line in lines[1:]:
        line.pop("ts")
    return lines


CASES = [case_tiers, case_ring, case_scope_wall, case_retire_once,
         case_preempt_mid_prefill, case_readmit_cycle, case_illegal,
         case_empty_export, case_timeline, case_timeline_misuse,
         case_validate_corruption, case_jsonl]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_obs_units_match_reference(case, tmp_path):
    assert case(tobs, tmp_path) == case(jobs, tmp_path)


def test_taxonomy_is_the_reference():
    from repro.obs import trace as jt
    from repro_torch.obs import trace as tt
    for name in ("CATEGORIES", "REQUIRED_CATEGORIES", "STEP_PHASES",
                 "COUNTERS", "GAUGES"):
        assert getattr(tt, name) == getattr(jt, name), name


def _literal_calls(tree):
    """(method, first string literal) of every recorder-style call."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            owner = ast.unparse(node.func.value)
            yield node.func.attr, owner, node.args[0].value


def test_recorder_call_sites_use_the_taxonomy():
    """Every literal counter, gauge, step phase and event category a
    port module hands its recorder is in the closed taxonomy."""
    from repro_torch.obs.trace import (CATEGORIES, COUNTERS, GAUGES,
                                       STEP_PHASES)
    seen = set()
    for p in PKG.rglob("*.py"):
        for attr, owner, lit in _literal_calls(ast.parse(p.read_text())):
            rec_like = any(w in owner for w in ("obs", "recorder", "rec"))
            if attr == "phase" and "timeline" in owner:
                assert lit in STEP_PHASES, (p, lit)
            elif not rec_like:
                continue
            elif attr == "count":
                assert lit in COUNTERS, (p, lit)
            elif attr == "gauge":
                assert lit in GAUGES, (p, lit)
            elif attr in ("instant", "emit", "span", "slice"):
                assert lit in CATEGORIES, (p, lit)
            else:
                continue
            seen.add((attr, lit))
    # the engine's own series are among them
    assert {("count", "faults_contained"), ("gauge", "kv_pages_in_use"),
            ("phase", "sync"), ("count", "shared_prefix_steps")} <= seen


# ---------------------------------------------------------------------------
# JitWatch and the registry's dispatch events
# ---------------------------------------------------------------------------

def test_jitwatch_counts_new_signatures_and_gates_dispatch_events():
    from repro_torch import dispatch
    from repro_torch.core.sara import SaraDispatcher
    rec = tobs.TraceRecorder(spans=True)
    reg = dispatch.SiteRegistry(recorder=rec)

    def model(x, w):
        for _ in range(3):               # one site run thrice, one trace
            x = dispatch.gemm(x, w, site="layer.mlp.up")
        return x

    watched = tobs.JitWatch(model, "decode", rec)
    w = torch.eye(8)
    with dispatch.use(SaraDispatcher(), execute="torch", registry=reg), \
            reg.scope("decode"):
        for m in (2, 2, 4, 2):
            watched(torch.ones(m, 8), w)
        dispatch.gemm(torch.ones(2, 8), w, site="unembed")   # eager
    assert rec.counters["jit_compiles"] == 2
    assert rec.counters["jit_compiles.decode"] == 2
    assert [e.args["shapes"] for e in rec.events("compile")] == \
        [["2x8", "8x8"], ["4x8", "8x8"]]
    # one event a site a new-signature call, and every eager record
    disp = [(e.args["site"], e.args["m"]) for e in rec.events("dispatch")]
    assert disp == [("layer.mlp.up", 2), ("layer.mlp.up", 4),
                    ("unembed", 2)]
    assert rec.counters["dispatch_records"] == 3
    assert reg.records == 13             # the registry itself: every call
    assert rec.tracing is None and rec.traced == set()


# ---------------------------------------------------------------------------
# traced engine runs against the JAX engine
# ---------------------------------------------------------------------------

def _pair(arch):
    jcfg = get_arch(arch).reduced()
    tcfg = tget_arch(arch).reduced()
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(_flatten(jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def llama():
    return _pair("llama3.2-1b")


@pytest.fixture(scope="module")
def rwkv():
    return _pair("rwkv6-1.6b")


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(f"r{i}", rng.integers(0, vocab, n).astype(np.int32), 6)
            for i, n in enumerate((5, 13, 21))]


def _run_both(pair, **kw):
    jcfg, jp, tcfg, tp = pair
    common = dict(num_slots=2, max_len=32, block_size=4, temperature=0.0,
                  clock="steps", trace=True, **kw)
    jeng = JServingEngine(jcfg, JEngineConfig(**common, execute="xla"),
                          params=jp)
    jout = jeng.run(_requests(JRequest, jcfg.vocab_size))
    teng = ServingEngine(tcfg, EngineConfig(**common), params=tp,
                         device="cpu")
    tout = teng.run(_requests(Request, tcfg.vocab_size))
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid])
    return jeng, teng


def _events(eng, apart=()):
    """The engine's events in buffer order, compile events aside; the
    reference's "xla" backend read as the port's "torch"; ``apart`` args
    of dispatch events taken out (compared by the caller)."""
    out = []
    for e in eng.obs.events():
        if e.cat == "compile":
            continue
        args = dict(e.args)
        if e.cat == "dispatch":
            if args.get("backend") == "xla":
                args["backend"] = "torch"
            for k in apart:
                args.pop(k, None)
        out.append((e.cat, e.name, e.ph, e.track,
                    json.dumps(args, sort_keys=True, default=str)))
    return out


def _same_trace(jeng, teng, apart=()):
    jev, tev = _events(jeng, apart), _events(teng, apart)
    assert len(tev) == len(jev)
    for i, (a, b) in enumerate(zip(jev, tev)):
        assert a == b, (i, a, b)
    assert {e[0] for e in tev} >= set(tobs.REQUIRED_CATEGORIES) - \
        {"compile"}
    assert teng.obs.counters == jeng.obs.counters
    assert teng.obs.gauges == jeng.obs.gauges
    assert teng.obs.dropped == jeng.obs.dropped == 0
    jst, tst = jeng.site_timings(), teng.site_timings()
    assert list(tst) == list(jst)
    for scope in jst:
        assert list(tst[scope]["sites"]) == list(jst[scope]["sites"])
        assert tst[scope]["calls"] == jst[scope]["calls"]
    assert teng.dispatch_stats()["jit_compiles"] == \
        jeng.dispatch_stats()["jit_compiles"]
    assert teng.req_spans.closed == jeng.req_spans.closed == 3
    assert teng.req_spans.open_requests() == {}


def test_traced_llama_run_matches_reference(llama, tmp_path):
    jeng, teng = _run_both(llama, kv_layout="paged", prefill_chunk=8)
    _same_trace(jeng, teng)
    assert teng.obs.counters["jit_compiles.paged_decode"] == 3
    # each package's validator accepts the other's export
    tp, jp = tmp_path / "port.json", tmp_path / "ref.json"
    jsonl = teng.export_trace(str(tp))
    jeng.export_trace(str(jp))
    tdoc, jdoc = json.loads(tp.read_text()), json.loads(jp.read_text())
    for doc in (tdoc, jdoc):
        assert jobs.validate_trace(doc, jobs.REQUIRED_CATEGORIES) == []
        assert tobs.validate_trace(doc, tobs.REQUIRED_CATEGORIES) == []
    assert jsonl.endswith(".jsonl") and (tmp_path / "port.jsonl").exists()
    assert tdoc["otherData"]["counters"] == jdoc["otherData"]["counters"]
    assert set(tdoc["otherData"]["site_timings"]) == \
        set(jdoc["otherData"]["site_timings"])


def test_traced_spec_run_matches_reference(llama):
    jeng, teng = _run_both(llama, kv_layout="paged", prefill_chunk=8,
                           spec_draft="self", spec_k=3)
    _same_trace(jeng, teng)
    assert teng.obs.counters["jit_compiles.spec_draft_loop"] == 1
    assert teng.obs.counters["spec_steps"] > 0


def test_traced_rwkv_run_matches_reference(rwkv):
    """The dense slot layout: every event equal but the decode scope's
    dispatch M (num_slots in the port, 1 in the reference's vmapped
    trace) and the analytic costs, which follow M."""
    apart = ("m", "cost_s", "cost_best_s")
    jeng, teng = _run_both(rwkv, kv_layout="dense", prefill_chunk=None)
    _same_trace(jeng, teng, apart=apart)
    jd = [e.args for e in jeng.obs.events("dispatch")]
    td = [e.args for e in teng.obs.events("dispatch")]
    for j, t in zip(jd, td):
        if t["scope"] == "decode":
            assert (t["m"], j["m"]) == (2, 1)
        else:
            assert [t[k] for k in apart] == [j[k] for k in apart]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_traced_bucketed_llama_run_matches_reference(llama, layout):
    """Bucketed prefill on both KV layouts (the dense slot caches, or the
    buckets scattered into pages through ``paged_write``): every event,
    counter and compile count equal the JAX engine's, but, on the dense
    layout, the decode scope's dispatch M (num_slots in the port, 1 in
    the reference's vmapped trace) and the analytic costs that follow
    it."""
    apart = ("m", "cost_s", "cost_best_s") if layout == "dense" else ()
    jeng, teng = _run_both(llama, kv_layout=layout, prefill_chunk=None)
    _same_trace(jeng, teng, apart=apart)
    names = ("prefill", "decode") if layout == "dense" else \
        ("prefill", "paged_write", "paged_decode")
    for name in names:
        key = f"jit_compiles.{name}"
        assert teng.obs.counters[key] == jeng.obs.counters[key] > 0, key
