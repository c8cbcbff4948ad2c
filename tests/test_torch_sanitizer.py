"""KV-arena sanitizer parity: the reference's ``tests/test_sanitizer.py``
engine cases, served by the port's engine and by the JAX engine (pinned
to ``execute="xla"``) from the same JAX-initialised reduced llama3.2-1b,
both paged with 8-token chunks under ``sanitize=True``:

- a clean sanitized run (plain, and with the prefix cache and with
  speculative decoding): zero poison hits, generation faults and leaks,
  pages poisoned on free, equal tokens, counters and sanitizer totals;
- an injected use-after-free (a page a decoding lane still reads
  NaN-poisoned in the arena) trapped at the very next step, attributed to
  that lane and contained: the victim fails, the other request finishes
  its budget with the tokens of the fault-free run, in both packages;
- a stale block table (a page freed and handed out again after the
  table was built) trapped by the generation replay.

Tolerance: none; every compared value is exact (reduced llama is f32).
"""

import types

import jax
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.models.api import build_model as jbuild
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch

KEYS = ("kv_sanitize_checks", "kv_poison_fills", "kv_poison_hits",
        "kv_generation_faults", "kv_leaked_tables", "kv_leaked_refs",
        "kv_pinned_pages", "faults_contained", "requests_failed",
        "completed")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pkgs():
    jcfg = get_arch("llama3.2-1b").reduced()
    tcfg = tget_arch("llama3.2-1b").reduced()
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(_flatten(jp), tcfg, "cpu")
    common = dict(num_slots=2, max_len=24, temperature=0.0, seed=0,
                  kv_layout="paged", prefill_chunk=8, sanitize=True)
    return (types.SimpleNamespace(
                cfg=jcfg, sv=jserving,
                engine=lambda **kw: jserving.ServingEngine(
                    jcfg, jserving.EngineConfig(execute="xla",
                                                **common, **kw),
                    params=jp)),
            types.SimpleNamespace(
                cfg=tcfg, sv=tserving,
                engine=lambda **kw: tserving.ServingEngine(
                    tcfg, tserving.EngineConfig(**common, **kw), params=tp,
                    device="cpu")))


def _requests(p, n, prompt_len, gen):
    rng = np.random.default_rng(0)
    return [p.sv.Request(f"r{i}", rng.integers(0, p.cfg.vocab_size,
                                               prompt_len).astype(np.int32),
                         gen) for i in range(n)]


def _clean(p, **kw):
    eng = p.engine(**kw)
    outs = eng.run(_requests(p, 3, 12, 4))
    assert all(len(v) == 4 for v in outs.values())
    s = eng.summary()
    assert s["kv_sanitize_checks"] > 0 and s["kv_poison_fills"] > 0
    assert s["kv_poison_hits"] == 0 and s["kv_generation_faults"] == 0
    assert s["kv_leaked_tables"] == 0 and s["kv_leaked_refs"] == 0
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()
    assert eng.pool.num_free == eng.pool.num_blocks
    return ({k: v.tolist() for k, v in outs.items()},
            {k: s.get(k) for k in KEYS}, dict(eng.obs.counters))


@pytest.mark.parametrize("kw", [{}, {"prefix_cache": True},
                                {"spec_draft": "self", "spec_k": 3}],
                         ids=["plain", "prefix_cache", "spec"])
def test_sanitized_run_is_clean_and_matches_reference(pkgs, kw):
    jp, tp = pkgs
    assert _clean(tp, **kw) == _clean(jp, **kw)


def _uaf(p):
    eng = p.engine()
    reqs = _requests(p, 2, 12, 6)
    for r in reqs:
        eng.submit(r)
    for _ in range(8):
        assert eng.step()
        live = [r for r in eng.sched.active.values()
                if not r.prefilling and r.generated]
        if live:
            break
    assert live, "no decoding lane after 8 steps"
    victim = live[0]
    # a page the lane's table still names, poisoned as if freed while
    # referenced: the very next decode streams NaN into its logits
    eng.arena.poison_page(eng.pool.table(victim.rid).blocks[0])
    step = eng._step_idx
    assert eng.step()                        # contained, not crashed
    assert victim.outcome == "failed"
    assert victim.rid not in eng.pool.live_requests()
    assert int(eng.obs.counters["kv_poison_hits"]) >= 1
    assert int(eng.obs.counters["faults_contained"]) >= 1
    while eng.step():
        pass
    other = [r for r in reqs if r is not victim][0]
    assert other.outcome == "done" and len(other.generated) == 6
    assert eng.pool.num_free == eng.pool.num_blocks
    return (victim.rid, step, other.rid, list(map(int, other.generated)),
            dict(eng.obs.counters))


def test_injected_uaf_trapped_attributed_and_contained(pkgs):
    jp, tp = pkgs
    t = _uaf(tp)
    assert t == _uaf(jp)
    # the survivor's tokens are those of the fault-free run
    clean = tp.engine().run(_requests(tp, 2, 12, 6))
    assert t[3] == clean[t[2]].tolist()


def test_stale_table_trapped_by_generation_replay(pkgs):
    _, tp = pkgs
    eng = tp.engine()
    pool = eng.pool
    pool.alloc("a", 8)
    tables = pool.dense_block_table(["a"], 2)
    gens = pool.table_generations(["a"], 2)
    eng._check_generations(["a"], tables, gens)        # fresh: passes
    pool.free("a")
    pool.alloc("b", pool.num_blocks * pool.block_size)  # reuses a's pages
    with pytest.raises(tserving.SanitizerError, match="use-after-free"):
        eng._check_generations(["a"], tables, gens)
    assert eng.obs.counters["kv_generation_faults"] == 1
    assert pool.generation_faults == 1
    pool.free("b")
