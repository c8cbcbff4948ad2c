"""Fault-tolerance parity: the port's seeded fault schedule, chaos
injector and engine error boundary against the JAX package's.

- ``FaultSchedule``'s draws (fires, peeks, picks over seeds, salts and
  probabilities) bitwise the reference's, and ``make_fail_injector``;
- ``FaultInjector``'s picks (pool OOM, poison page, stalls, preemption)
  equal on the same candidates, with the same ``fault`` events;
- every scenario of the reference's ``tests/test_faults.py`` (deadline
  expiry, shedding, the goodput twin, cancellation, rejected requests,
  chaos pool OOM, poison trapped by the sanitizer, the poison refusal
  without sanitize, stalls and forced preemption, the preemption budget,
  same-seed reruns, spec poison mid-verify, spec stalls and preemption)
  served by the port's engine and by the JAX engine (pinned to
  ``execute="xla"``) from the same JAX-initialised weights: equal
  outcomes, equal counters and survivor tokens bitwise (reduced llama is
  f32).  The reference's asserts run on both.  Where the reference
  scenario uses the default layout (dense off TPU), both engines serve
  the paged layout with 8-token chunks; two more scenarios run chaos on
  the dense slot layout of reduced rwkv6 and of reduced llama3.2-1b (a
  forced stall rolls the lane's state or KV cache back).

Tolerance: none; every compared value is exact.
"""

import types

import jax
import numpy as np
import pytest
import torch

import repro.runtime.failplan as jfp
import repro.serving as jserving
import repro.serving.faults as jfaults
import repro_torch.runtime.failplan as tfp
import repro_torch.serving as tserving
import repro_torch.serving.faults as tfaults
from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.models.api import build_model as jbuild
from repro.obs import TraceRecorder as JRecorder
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.obs import TraceRecorder as TRecorder

PAGED = dict(kv_layout="paged", prefill_chunk=8)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# FaultSchedule and FaultInjector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,p,salt", [(0, 0.5, 0), (7, 0.05, 1),
                                         (3, 0.15, 4), (11, 1.0, 2)])
def test_fault_schedule_draws_match_reference(seed, p, salt):
    def draws(mod):
        s = mod.FaultSchedule(seed, probability=p, steps={5, 40}, salt=salt)
        peek = [s.peek(i) for i in range(200)]
        fires = [s.fires(i) for i in range(200)] + \
            [s.fires(i) for i in range(200)]          # once: no re-fire
        picks = [s.pick(i, n) for i in range(100) for n in (1, 3, 7, 1000)]
        return peek, fires, picks, sorted(s.fired)
    assert draws(tfp) == draws(jfp)
    out = draws(tfp)
    assert any(out[0]) and out[1][200:] == [False] * 200


def test_fault_schedule_refusals_and_injector_adapter():
    for mod in (tfp, jfp):
        with pytest.raises(ValueError):
            mod.FaultSchedule(probability=1.5)
        with pytest.raises(ValueError):
            mod.FaultSchedule().pick(0, 0)
    inj = tfp.make_fail_injector(tfp.FaultSchedule(steps={2}), KeyError,
                                 "boom")
    inj(1)
    with pytest.raises(KeyError, match="boom at step 2"):
        inj(2)
    inj(2)                                   # fired once, replays clean


def test_fault_injector_picks_match_reference():
    def run(mod, rec_cls):
        rec = rec_cls(spans=True)
        inj = mod.FaultInjector(mod.ChaosConfig(
            seed=5, pool_oom_p=0.3, poison_p=0.3, stall_p=0.3,
            stall_steps=3, preempt_p=0.3), recorder=rec)
        reqs = [types.SimpleNamespace(rid=f"r{i}") for i in range(5)]
        out = []
        for step in range(60):
            live = reqs[step % 3:]
            oom = inj.pool_oom(step, live)
            pois = inj.poison(step, [(r, [10 * i + j for j in range(i + 1)])
                                     for i, r in enumerate(live)])
            stall = inj.stall_lanes(step, live)
            pre = inj.preempt(step, live)
            out.append((oom and oom.rid, pois and (pois[0].rid, pois[1]),
                        [r.rid for r in stall], pre and pre.rid))
        err = inj.oom_error(3, reqs[1])
        return (out, inj.summary(), inj.total_injected(),
                dict(rec.counters),
                [(e.name, e.track, sorted(e.args.items()))
                 for e in rec.events()],
                type(err).__name__, str(err), mod.fault_rids(err))
    assert run(tfaults, TRecorder) == run(jfaults, JRecorder)
    assert run(tfaults, TRecorder)[2] > 10
    assert tfaults.OUTCOMES == jfaults.OUTCOMES
    assert tfaults.OUTCOME_COUNTERS == jfaults.OUTCOME_COUNTERS


# ---------------------------------------------------------------------------
# the reference's engine scenarios, in both packages
# ---------------------------------------------------------------------------

def _pair(arch):
    jcfg = get_arch(arch).reduced()
    tcfg = tget_arch(arch).reduced()
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(_flatten(jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def llama():
    return _pair("llama3.2-1b")


def _packages(pair):
    """The two packages' serving entry points over one set of weights."""
    jcfg, jp, tcfg, tp = pair
    return (types.SimpleNamespace(
                name="jax", cfg=jcfg, sv=jserving,
                engine=lambda **kw: jserving.ServingEngine(
                    jcfg, jserving.EngineConfig(execute="xla", **kw),
                    params=jp)),
            types.SimpleNamespace(
                name="torch", cfg=tcfg, sv=tserving,
                engine=lambda **kw: tserving.ServingEngine(
                    tcfg, tserving.EngineConfig(**kw), params=tp,
                    device="cpu")))


def _prompts(cfg, n, prompt_len, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
            for _ in range(n)]


def _result(eng, reqs):
    """What the two packages must agree on: outcomes, tokens, counters,
    the chaos / fault keys of the summary, the pool whole."""
    s = eng.summary()
    assert eng.pool.num_free == eng.pool.num_blocks
    return {"outcomes": {r.rid: r.outcome for r in reqs},
            "tokens": {r.rid: list(map(int, r.generated)) for r in reqs},
            "counters": dict(eng.obs.counters),
            "summary": {k: v for k, v in s.items()
                        if k.startswith(("chaos_", "faults_", "requests_",
                                         "kv_poison", "kv_generation",
                                         "kv_leaked", "preempt_",
                                         "engine_step"))
                        or k in ("completed", "completed_in_deadline",
                                 "decode_steps", "preemptions", "stalls",
                                 "kv_draft_leaked_blocks")}}


def sc_expires(p):
    eng = p.engine(num_slots=1, max_len=40, temperature=0.0, **PAGED)
    pr = _prompts(p.cfg, 2, 8)
    slow = p.sv.Request("slow", pr[0], 12)
    doomed = p.sv.Request("doomed", pr[1], 4, deadline_s=2.0)
    res = eng.run([slow, doomed])
    assert slow.outcome == "done" and len(res["slow"]) == 12
    assert doomed.outcome == "expired" and len(res["doomed"]) == 0
    s = eng.summary()
    assert s["requests_expired"] == 1 and s["completed"] == 1
    return _result(eng, [slow, doomed])


def sc_sheds(p):
    eng = p.engine(num_slots=1, max_len=40, temperature=0.0, **PAGED)
    for _ in range(4):
        eng.metrics._ttft_win.append(10.0)
    hopeless = p.sv.Request("hopeless", _prompts(p.cfg, 1, 8)[0], 4,
                            deadline_s=3.0)
    res = eng.run([hopeless])
    assert hopeless.outcome == "shed" and len(res["hopeless"]) == 0
    assert eng.summary()["requests_shed"] == 1
    return _result(eng, [hopeless])


def sc_goodput(p):
    eng = p.engine(num_slots=2, max_len=40, temperature=0.0,
                   max_prefills_per_step=2, **PAGED)
    pr = _prompts(p.cfg, 2, 8)
    relaxed = p.sv.Request("relaxed", pr[0], 6, deadline_s=1000.0)
    tight = p.sv.Request("tight", pr[1], 6, deadline_s=0.5)
    eng.run([relaxed, tight])
    s = eng.summary()
    assert s["completed"] == 2 and s["completed_in_deadline"] == 1
    return _result(eng, [relaxed, tight])


def sc_cancel(p):
    eng = p.engine(num_slots=1, max_len=40, temperature=0.0, **PAGED)
    pr = _prompts(p.cfg, 3, 8)
    reqs = [p.sv.Request(n, x, g) for n, x, g in
            zip(("active", "queued", "other"), pr, (12, 4, 4))]
    for r in reqs:
        eng.submit(r)
    assert eng.step()
    reqs[0].cancel()
    reqs[1].cancel()
    while eng.step():
        pass
    assert [r.outcome for r in reqs] == ["cancelled", "cancelled", "done"]
    assert eng.summary()["requests_cancelled"] == 2
    return _result(eng, reqs)


def sc_rejected(p):
    eng = p.engine(num_slots=2, max_len=24, temperature=0.0, **PAGED)
    good = p.sv.Request("good", _prompts(p.cfg, 1, 8)[0], 4)
    empty = p.sv.Request("empty", np.zeros((0,), np.int32), 4)
    huge = p.sv.Request("huge", _prompts(p.cfg, 1, 20)[0], 20)
    res = eng.run([empty, good, huge])
    assert good.outcome == "done" and len(res["good"]) == 4
    assert empty.outcome == huge.outcome == "rejected"
    assert eng.summary()["requests_rejected"] == 2
    return _result(eng, [empty, good, huge])


def sc_pool_oom(p):
    eng = p.engine(num_slots=2, max_len=24, temperature=0.0,
                   max_prefills_per_step=2,
                   chaos=p.sv.ChaosConfig(seed=3, pool_oom_p=1.0), **PAGED)
    reqs = [p.sv.Request(f"r{i}", x, 4)
            for i, x in enumerate(_prompts(p.cfg, 3, 8))]
    eng.run(reqs)
    assert all(r.outcome == "failed" for r in reqs)
    s = eng.summary()
    assert s["faults_injected"] >= 3 and s["chaos_pool_oom_injected"] >= 3
    assert s["faults_contained"] >= 3 and s["requests_failed"] == 3
    return _result(eng, reqs)


def _chaos_engine(p, chaos=None, **kw):
    cfg = dict(num_slots=2, max_len=31, block_size=8, temperature=0.0,
               kv_layout="paged", prefill_chunk=8, sanitize=True,
               max_prefills_per_step=2, chaos=chaos)
    cfg.update(kw)
    return p.engine(**cfg)


def sc_poison(p):
    prompts = _prompts(p.cfg, 4, 12, seed=5)
    baseline = _chaos_engine(p).run(
        [p.sv.Request(f"r{i}", x, 6) for i, x in enumerate(prompts)])
    reqs = [p.sv.Request(f"r{i}", x, 6) for i, x in enumerate(prompts)]
    eng = _chaos_engine(p, p.sv.ChaosConfig(seed=4, poison_p=0.2))
    res = eng.run(reqs)
    s = eng.summary()
    assert s["chaos_poison_injected"] >= 1 and s["kv_poison_hits"] >= 1
    assert s["faults_contained"] >= 1
    done = [r for r in reqs if r.outcome == "done"]
    assert done and any(r.outcome == "failed" for r in reqs)
    for r in done:
        np.testing.assert_array_equal(res[r.rid], baseline[r.rid])
    return _result(eng, reqs)


def sc_stall_preempt(p):
    eng = p.engine(num_slots=2, max_len=31, block_size=8, temperature=0.0,
                   kv_layout="paged", prefill_chunk=4,
                   max_prefills_per_step=2,
                   chaos=p.sv.ChaosConfig(seed=2, stall_p=0.4,
                                          stall_steps=2, preempt_p=0.4))
    reqs = [p.sv.Request(f"r{i}", x, 5)
            for i, x in enumerate(_prompts(p.cfg, 3, 12, seed=9))]
    res = eng.run(reqs)
    assert eng.summary()["faults_injected"] >= 1
    for r in reqs:
        assert r.outcome in ("done", "failed")
        if r.outcome == "done":
            assert len(res[r.rid]) == 5
    return _result(eng, reqs)


def sc_preempt_budget(p):
    eng = p.engine(num_slots=2, max_len=40, temperature=0.0,
                   preempt_budget=1, **PAGED)
    victim = p.sv.Request("victim", _prompts(p.cfg, 1, 8)[0], 8)
    eng.submit(victim)
    assert eng.step() and victim.slot >= 0
    eng._preempt(victim)
    assert victim.outcome == "" and victim.slot == -1
    assert eng.step()
    eng._preempt(victim)
    assert victim.outcome == "failed"
    s = eng.summary()
    assert s["preempt_budget_exhausted"] == 1 and s["requests_failed"] == 1
    assert not eng.step()
    return _result(eng, [victim])


def sc_same_seed(p):
    def once():
        reqs = [p.sv.Request(f"r{i}", x, 5)
                for i, x in enumerate(_prompts(p.cfg, 4, 12, seed=5))]
        eng = _chaos_engine(p, p.sv.ChaosConfig(
            seed=6, pool_oom_p=0.15, poison_p=0.15, stall_p=0.1,
            preempt_p=0.1))
        eng.run(reqs)
        return _result(eng, reqs)
    a, b = once(), once()
    assert a == b
    return a


def _spec_chaos_engine(p, chaos=None, **kw):
    return _chaos_engine(p, chaos, spec_draft="self", spec_k=3, **kw)


def sc_spec_poison(p):
    prompts = _prompts(p.cfg, 4, 12, seed=5)
    baseline = _spec_chaos_engine(p).run(
        [p.sv.Request(f"r{i}", x, 6) for i, x in enumerate(prompts)])
    reqs = [p.sv.Request(f"r{i}", x, 6) for i, x in enumerate(prompts)]
    eng = _spec_chaos_engine(p, p.sv.ChaosConfig(seed=4, poison_p=0.2))
    res = eng.run(reqs)
    s = eng.summary()
    assert s["chaos_poison_injected"] >= 1 and s["kv_poison_hits"] >= 1
    assert s["faults_contained"] >= 1
    failed = [r for r in reqs if r.outcome == "failed"]
    done = [r for r in reqs if r.outcome == "done"]
    assert failed and done
    for r in done:
        np.testing.assert_array_equal(res[r.rid], baseline[r.rid])
    assert eng.spec.live_pages() == 0 and s["kv_draft_leaked_blocks"] == 0
    for r in failed:
        assert eng.spec.rows(r.rid) == 0
    return _result(eng, reqs)


def sc_spec_stall_preempt(p):
    eng = p.engine(num_slots=2, max_len=31, block_size=8, temperature=0.0,
                   kv_layout="paged", prefill_chunk=4,
                   max_prefills_per_step=2, spec_draft="self", spec_k=2,
                   chaos=p.sv.ChaosConfig(seed=2, stall_p=0.4,
                                          stall_steps=2, preempt_p=0.4))
    reqs = [p.sv.Request(f"r{i}", x, 5)
            for i, x in enumerate(_prompts(p.cfg, 3, 12, seed=9))]
    res = eng.run(reqs)
    assert eng.summary()["faults_injected"] >= 1
    for r in reqs:
        assert r.outcome in ("done", "failed")
        if r.outcome == "done":
            assert len(res[r.rid]) == 5
    assert eng.spec.live_pages() == 0
    return _result(eng, reqs)


SCENARIOS = [sc_expires, sc_sheds, sc_goodput, sc_cancel, sc_rejected,
             sc_pool_oom, sc_poison, sc_stall_preempt, sc_preempt_budget,
             sc_same_seed, sc_spec_poison, sc_spec_stall_preempt]


# summary keys only the port has: its step count, and the teardown audit
# it runs on every run where the reference audits under sanitize alone
PORT_ONLY = {"engine_steps", "kv_leaked_tables", "kv_leaked_refs",
             "kv_pinned_pages", "kv_poison_fills", "kv_draft_leaked_blocks"}


def _same(t, j):
    ts, js = t.pop("summary"), j.pop("summary")
    assert t == j
    assert set(ts) - set(js) <= PORT_ONLY
    assert {k: ts[k] for k in js} == js


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[3:] for s in SCENARIOS])
def test_engine_scenario_matches_reference(llama, scenario):
    jp, tp = _packages(llama)
    _same(scenario(tp), scenario(jp))


def test_chaos_poison_requires_sanitize(llama):
    for p in _packages(llama):
        with pytest.raises(ValueError, match="sanitize"):
            p.engine(chaos=p.sv.ChaosConfig(poison_p=0.5), **PAGED)


def test_dense_layout_chaos_matches_reference():
    """Reduced rwkv6 on the dense slot layout under pool OOMs, stalls (the
    lane's state rolls back to the snapshot taken before the step) and
    forced preemption: equal outcomes, counters and tokens, and every
    request that finished emits the fault-free run's tokens."""
    _dense_chaos("rwkv6-1.6b")


def test_dense_attention_layout_chaos_matches_reference():
    """The same on reduced llama3.2-1b's dense KV layout (bucketed
    prefill; a stalled lane's KV cache rolls back to its snapshot)."""
    _dense_chaos("llama3.2-1b")


def _dense_chaos(arch):
    jpk, tpk = _packages(_pair(arch))

    def run(p, chaos):
        eng = p.engine(num_slots=2, max_len=24, temperature=0.0,
                       kv_layout="dense", prefill_chunk=None,
                       max_prefills_per_step=2, chaos=chaos)
        reqs = [p.sv.Request(f"r{i}", x, 5)
                for i, x in enumerate(_prompts(p.cfg, 4, 9, seed=3))]
        eng.run(reqs)
        return _result(eng, reqs)

    chaos = dict(seed=1, pool_oom_p=0.1, stall_p=0.4, stall_steps=2,
                 preempt_p=0.3)
    t = run(tpk, tpk.sv.ChaosConfig(**chaos))
    stalls = t["summary"]["chaos_stall_injected"]
    _same(t, run(jpk, jpk.sv.ChaosConfig(**chaos)))
    assert stalls >= 1
    base = run(tpk, None)
    for rid, o in t["outcomes"].items():
        if o == "done":
            assert t["tokens"][rid] == base["tokens"][rid]
