"""Speculative decoding parity: the port's accept rule, verify step, draft
side (``SpecDecoder``) and engine against the JAX package on the same
numpy inputs and weights (JAX-initialised, carried across with
``params_from_numpy``), then the reference's engine-level edge cases held
to the port's own plain greedy decode.

Tolerances: the verify step's logits and written arena rows 2e-5 / 1e-5
in f32 (two layers of f32 GEMMs and softmax summed in different orders;
deepseek's MLA and MoE 1e-4 on logits, as ``test_torch_engine.py``'s
steps); rows past ``chunk_lens`` are garbage in both packages and the
trash page takes colliding writes, so neither is compared.  Drafted
tokens, row counts, preemptions, greedy tokens, ``spec_*`` counters and
the verify scope's recommendations exact.  The reference is pinned to
its XLA twins (``execute="xla"``, the paged XLA route it takes off TPU);
the port runs its plain versions, as it does for CPU tensors.

The edge cases run without the reference's ``sanitize``, which the port
does not have yet (its engine audits the pools at the end of every run
instead).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.models.api import build_model as jbuild
from repro.obs import TraceRecorder
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving.spec_decode import SpecDecoder as JSpecDecoder
from repro.serving.spec_decode import accept_tokens as jaccept_tokens
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.models.api import build_model as tbuild
from repro_torch.serving import (EngineConfig, Request, ServingEngine,
                                 SpecDecoder, accept_tokens, resolve_draft)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def llama():
    """Reduced llama3.2-1b (2 layers, d = 64, hd 16, f32), JAX-initialised,
    in both packages."""
    jcfg = get_arch("llama3.2-1b").reduced()
    tcfg = tget_arch("llama3.2-1b").reduced()
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_numpy(_flatten(jparams), tcfg,
                                                  "cpu")


@pytest.fixture(scope="module")
def deepseek():
    jcfg = get_arch("deepseek-v3-671b").reduced()
    tcfg = tget_arch("deepseek-v3-671b").reduced()
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_numpy(_flatten(jparams), tcfg,
                                                  "cpu")


# ---------------------------------------------------------------------------
# the accept rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drafts,argmax,want", [
    ([5, 7, 9], [5, 7, 9, 11], (3, [5, 7, 9, 11])),      # accept all
    ([5, 7, 9], [6, 7, 9, 11], (0, [6])),                # reject all
    ([5, 7, 9, 4], [5, 7, 8, 4, 2], (2, [5, 7, 8])),     # partial
    ([], [42], (0, [42]))],                              # preempted lane
    ids=["all", "none", "partial", "empty"])
def test_accept_tokens_matches_reference(drafts, argmax, want):
    assert accept_tokens(drafts, argmax) == want == \
        jaccept_tokens(drafts, argmax)


def test_accept_tokens_sweep_matches_reference():
    """500 seeded drafts of 0-6 tokens over a 3-token vocabulary (so that
    prefixes match often) against argmax rows one longer, as numpy ints."""
    rng = np.random.default_rng(0)
    for _ in range(500):
        k = int(rng.integers(0, 7))
        d = rng.integers(0, 3, k).astype(np.int32)
        am = rng.integers(0, 3, k + 1).astype(np.int64)
        got = accept_tokens(d, am)
        assert got == jaccept_tokens(d, am)
        a, committed = got
        assert committed == [int(t) for t in am[:a + 1]]
        assert all(isinstance(t, int) for t in committed)


# ---------------------------------------------------------------------------
# the verify step
# ---------------------------------------------------------------------------

BS, W = 4, 4


def _verify_inputs(cfg, rng):
    """Four lanes of C = 4 rows (k = 3) over one random arena: chunk
    lengths 0, 1, 4 and 4 at kv offsets 0, 5 (inside a page), 7 (the
    chunk crosses a page) and 8 (on a page boundary)."""
    S, C = 4, 4
    chunk = np.array([0, 1, 4, 4], np.int32)
    kv = np.array([0, 5, 7, 8], np.int32)
    tables = rng.permutation(S * W).astype(np.int32).reshape(S, W)
    toks = rng.integers(0, cfg.vocab_size, (S, C)).astype(np.int32)
    ja = jbuild(cfg).init_paged_arena(S * W + 1, BS)
    arena = {n: rng.standard_normal(a.shape).astype(np.float32)
             for n, a in ja.items()}
    return toks, arena, tables, kv, chunk


@pytest.mark.parametrize("which,tol", [("llama", 2e-5), ("deepseek", 1e-4)])
def test_paged_verify_step_matches_reference(request, which, tol):
    """Logits at every row up to each lane's chunk length and the arena
    rows the step wrote, against the reference's ``paged_verify_step``."""
    jcfg, jparams, tcfg, tparams = request.getfixturevalue(which)
    toks, arena, tables, kv, chunk = _verify_inputs(
        jcfg, np.random.default_rng(1))
    with jdispatch.use(execute="xla"):
        jl, ja = jbuild(jcfg).paged_verify_step(
            jparams, jnp.asarray(toks), {n: jnp.asarray(a)
                                         for n, a in arena.items()},
            jnp.asarray(tables), jnp.asarray(kv), jnp.asarray(chunk))
    ta = {n: torch.from_numpy(a.copy()) for n, a in arena.items()}
    with torch.no_grad():
        tl, ta = tbuild(tcfg, device="cpu").paged_verify_step(
            tparams, torch.from_numpy(toks), ta,
            *(torch.from_numpy(a) for a in (tables, kv, chunk)))
    jl = np.asarray(jl)
    assert tl.shape == jl.shape == (4, 4, jcfg.vocab_size)
    assert tl.dtype == torch.float32
    for s, n in enumerate(chunk):
        if n:
            assert np.abs(tl.numpy()[s, :n] - jl[s, :n]).max() <= tol
    for name in ("k", "v"):
        diff = np.abs(ta[name].numpy()[:, :-1] - np.asarray(ja[name])[:, :-1])
        assert diff.max() <= 1e-5


def test_paged_verify_row_zero_is_the_decode_step(llama):
    """Row 0 of a verify chunk is the pending token plain decode would
    run: its logits equal the port's decode step over a copy of the same
    arena (the same GEMMs and masked softmax, one row)."""
    _, _, tcfg, tparams = llama
    toks, arena, tables, kv, chunk = _verify_inputs(
        tcfg, np.random.default_rng(2))
    m = tbuild(tcfg, device="cpu")
    t = {n: torch.from_numpy(a) for n, a in (("tables", tables), ("kv", kv),
                                             ("chunk", chunk))}
    live = chunk > 0
    with torch.no_grad():
        vl, _ = m.paged_verify_step(
            tparams, torch.from_numpy(toks),
            {n: torch.from_numpy(a.copy()) for n, a in arena.items()},
            t["tables"], t["kv"], t["chunk"])
        dl, _ = m.paged_decode_step(
            tparams, torch.from_numpy(toks[:, :1]),
            {n: torch.from_numpy(a.copy()) for n, a in arena.items()},
            t["tables"], t["kv"], torch.from_numpy(live.astype(np.int32)))
    assert (vl[live, 0] - dl[live]).abs().max().item() <= 2e-5


def test_paged_verify_step_refuses_recurrent_family():
    from repro_torch.models import serving
    cfg = tget_arch("rwkv6-1.6b").reduced()
    z = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot verify through the paged"):
        serving.paged_verify_step({}, z, cfg, {}, z, z[:, 0], z[:, 0])


# ---------------------------------------------------------------------------
# the draft side
# ---------------------------------------------------------------------------

def _lane_requests(cls, specs):
    """(slot, prompt length, generated) -> requests with the same tokens
    in either package."""
    rng = np.random.default_rng(5)
    out = {}
    for slot, n, gen in specs:
        r = cls(rid=f"r{slot}", prompt=rng.integers(1, 500, n)
                .astype(np.int32), max_new_tokens=20)
        r.generated = [int(t) for t in rng.integers(1, 500, gen)]
        r.slot = slot
        out[slot] = r
    return out


def _decoders(llama, num_blocks, k=3):
    jcfg, jparams, tcfg, tparams = llama
    kw = dict(num_slots=3, block_size=BS, num_blocks=num_blocks,
              max_blocks_per_slot=8, chunk=8, spec_k=k)
    # the reference's decoder counts its compiles into a recorder
    return (JSpecDecoder(jcfg, jparams, recorder=TraceRecorder(), **kw),
            SpecDecoder(tcfg, tparams, **kw))


def _draft_both(jd, td, specs, quotas):
    jreqs, treqs = (_lane_requests(c, specs) for c in (JRequest, Request))
    with jdispatch.use(execute="xla"):
        jout = jd.draft({s: (jreqs[s], quotas[s]) for s in jreqs})
    tout = td.draft({s: (treqs[s], quotas[s]) for s in treqs})
    return jout, tout, jreqs, treqs


def test_draft_matches_reference(llama):
    """Three lanes (a fresh 13-token context catching up over two 8-row
    chunks, a 5-token one, and one drafting k = 1 of 3), then a steady
    step after partial commits: the proposed tokens, the row counts and
    the pool's tables equal the reference's."""
    jd, td = _decoders(llama, num_blocks=24)
    specs = [(0, 10, 3), (1, 5, 0), (2, 7, 2)]
    quotas = {0: 3, 1: 3, 2: 1}
    jout, tout, jreqs, treqs = _draft_both(jd, td, specs, quotas)
    assert tout == jout and tout[1] == 0
    assert td._rows == jd._rows
    for rid in jd.pool.live_requests():
        assert td.pool.table(rid).blocks == jd.pool.table(rid).blocks
    # commit part of each draft, as the engine does, and draft again: the
    # lanes resume from their committed rows (no catch-up gap on lane 0)
    drafts = tout[0]
    for s, (a, extra) in {0: (2, 1), 1: (0, 1), 2: (1, 0)}.items():
        for reqs, dec in ((jreqs, jd), (treqs, td)):
            r = reqs[s]
            r.generated += [int(t) for t in drafts.get(s, [])[:a]] + \
                [7] * extra
            dec.commit(r.rid, r.context_len - 1)
    with jdispatch.use(execute="xla"):
        jout2 = jd.draft({s: (jreqs[s], 3) for s in jreqs})
    tout2 = td.draft({s: (treqs[s], 3) for s in treqs})
    assert tout2 == jout2
    assert td._rows == jd._rows


def test_draft_preemption_matches_reference(llama):
    """A 5-page draft pool for three lanes that need 4, 2 and 3 pages: the
    same lanes are draft-preempted (pages freed, absent from the drafts)
    and the survivors propose the same tokens as the reference's."""
    jd, td = _decoders(llama, num_blocks=5)
    specs = [(0, 12, 2), (1, 4, 1), (2, 9, 0)]
    quotas = {0: 3, 1: 3, 2: 3}
    jout, tout, _, _ = _draft_both(jd, td, specs, quotas)
    assert tout == jout and tout[1] > 0
    assert td._rows == jd._rows
    assert sorted(td.pool.live_requests()) == sorted(jd.pool.live_requests())
    assert td.live_pages() == jd.pool.num_in_use
    for rid in list(td.pool.live_requests()):
        td.release(rid)
    td.check()
    assert td.live_pages() == 0 and td._rows == {}


# ---------------------------------------------------------------------------
# engine parity with the JAX engine
# ---------------------------------------------------------------------------

COMMON = dict(num_slots=2, max_len=40, block_size=8, kv_layout="paged",
              prefill_chunk=8, temperature=0.0, seed=0, clock="steps")


def _requests(cls, n, prompt_len=12, gen=8, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=f"r{i}", prompt=rng.integers(1, 500, prompt_len)
                .astype(np.int32), max_new_tokens=gen) for i in range(n)]


def _poisson_trace(cls, n=6, rate=0.5, seed=3):
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    return [cls(rid=f"p{i}", prompt=rng.integers(
                1, 500, int(rng.integers(6, 20))).astype(np.int32),
                max_new_tokens=int(rng.integers(3, 10)),
                arrival_time=float(arrivals[i])) for i in range(n)]


SPEC_KEYS = ("spec_steps", "spec_drafted_tokens", "spec_accepted_tokens",
             "spec_bonus_tokens", "spec_draft_preempts", "decode_steps")


def _scope(registry, scope):
    return {s: (r.m, r.k, r.n, r.block_m, r.block_n, r.block_k, r.mode)
            for s, r in registry.sites(scope).items()}


def _spec_both(models, reqs, draft_params=None, **kw):
    """The same requests through the JAX spec engine, the port's spec
    engine and the port's plain engine; returns the two spec engines
    after checking every token."""
    jcfg, jparams, tcfg, tparams = models
    e = dict(COMMON, **kw)
    jeng = JServingEngine(jcfg, JEngineConfig(**e, execute="xla"),
                          params=jparams)
    jout = jeng.run(reqs(JRequest))
    teng = ServingEngine(tcfg, EngineConfig(**e), params=tparams,
                         device="cpu")
    if draft_params is not None:
        teng.spec.params = draft_params
    tout = teng.run(reqs(Request))
    plain = {k: v for k, v in e.items() if not k.startswith("spec_")}
    pout = ServingEngine(tcfg, EngineConfig(**plain), params=tparams,
                         device="cpu").run(reqs(Request))
    assert set(tout) == set(jout) == set(pout)
    for rid in jout:
        assert np.array_equal(tout[rid], jout[rid]), (rid, tout[rid],
                                                      jout[rid])
        assert np.array_equal(tout[rid], pout[rid])
    ts, js = teng.summary(), jeng.summary()
    for key in SPEC_KEYS:
        assert ts[key] == js[key], (key, ts[key], js[key])
    assert _scope(teng.registry, "spec_verify") == \
        _scope(jeng.registry, "spec_verify") != {}
    assert _scope(teng.registry, "spec_draft") == \
        _scope(jeng.registry, "spec_draft") != {}
    teng.pool.check()
    assert teng.pool.num_free == teng.pool.num_blocks
    assert teng.spec.live_pages() == 0
    assert ts["kv_draft_leaked_blocks"] == 0
    assert all(r.outcome == "done" for r in teng.requests.values())
    return jeng, teng


def test_spec_engine_matches_reference_poisson(llama):
    """Self-speculation on the reference's Poisson trace: tokens, counters
    and the verify scope's tiles equal the JAX engine's, more than one
    token committed a verify step."""
    _, teng = _spec_both(llama, lambda c: _poisson_trace(c),
                         spec_draft="self", spec_k=3)
    s = teng.summary()
    assert s["spec_steps"] > 0 and s["spec_accepted_per_step"] > 1.0


def test_spec_engine_matches_reference_gemma_draft(llama):
    """A draft that disagrees: reduced gemma-2b (MQA, GeGLU) with the JAX
    engine's draft weights (``PRNGKey(seed + 2)``) carried across, so the
    draft proposes the same tokens and the counters can match."""
    jg = get_arch("gemma-2b").reduced()
    tg = tget_arch("gemma-2b").reduced()
    jdraft = jbuild(jg).init(jax.random.PRNGKey(COMMON["seed"] + 2))
    _, teng = _spec_both(llama, lambda c: _requests(c, 3),
                         draft_params=params_from_numpy(_flatten(jdraft), tg,
                                                        "cpu"),
                         spec_draft="gemma-2b", spec_k=3)
    assert teng.spec.cfg == tg
    s = teng.summary()
    assert s["spec_drafted_tokens"] > s["spec_accepted_tokens"]
    assert s["spec_accept_rate"] < 1.0


def test_spec_engine_matches_reference_deepseek(deepseek):
    """Self-speculation on reduced deepseek-v3: the verify chunk runs the
    absorbed-MLA prefill (plain version) over the latent arena and the
    draft rounds the MLA decode."""
    _spec_both(deepseek, lambda c: _requests(c, 2, gen=6),
               spec_draft="self", spec_k=2)


def test_resolve_draft_shares_or_builds(llama):
    """``self`` and a name resolving to the target's config share its
    params; another arch gets fresh params of its own config."""
    _, _, tcfg, tparams = llama
    assert resolve_draft(tcfg, tparams, "self", 0) == (tcfg, tparams)
    cfg, params = resolve_draft(tcfg, tparams, "llama3.2-1b", 0)
    assert cfg == tcfg and params is tparams
    cfg, params = resolve_draft(tcfg, tparams, "gemma-2b", 0)
    assert cfg == tget_arch("gemma-2b").reduced()
    assert params["embed"].shape == (512, 64)
    assert "unembed" not in params           # tied embeddings


# ---------------------------------------------------------------------------
# the reference's edge cases, held to the port's own plain decode
# ---------------------------------------------------------------------------

def _engine(tcfg, tparams, **kw):
    return ServingEngine(tcfg, EngineConfig(**dict(COMMON, **kw)),
                         params=tparams, device="cpu")


def test_spec_budget_truncates_commit(llama):
    """A commit larger than the remaining budget stops exactly at
    max_new_tokens."""
    _, _, tcfg, tparams = llama
    plain = _engine(tcfg, tparams).run(_requests(Request, 2, gen=2))
    spec = _engine(tcfg, tparams, spec_draft="self", spec_k=4).run(
        _requests(Request, 2, gen=2))
    for rid in plain:
        assert len(spec[rid]) == 2
        assert np.array_equal(plain[rid], spec[rid])


def test_spec_rollback_into_shared_cow_pages(llama):
    """A cache-hit lane's verify rows start inside pages shared with the
    prefix cache: the engine copies them before writing, so the donor's
    pages stay intact and both the donor and the recipient decode the
    cache-off tokens."""
    _, _, tcfg, tparams = llama
    prompt = np.random.default_rng(7).integers(1, 500, 16).astype(np.int32)

    def req(rid):
        return Request(rid=rid, prompt=prompt.copy(), max_new_tokens=8)

    base = _engine(tcfg, tparams).run([req("b")])["b"]
    eng = _engine(tcfg, tparams, spec_draft="self", spec_k=3,
                  prefix_cache=True)
    first = eng.run([req("a")])["a"]
    second = eng.run([req("c")])["c"]
    assert np.array_equal(base, first) and np.array_equal(base, second)
    s = eng.summary()
    assert s["cache_hit_tokens"] > 0 and s["kv_cow_copies"] > 0
    assert eng.pool.cow_copies > 0
    eng.pool.check()


def test_spec_draft_preemption(llama):
    """A starved draft pool (4 pages) preempts draft lanes without losing
    parity or leaking draft pages."""
    _, _, tcfg, tparams = llama
    plain = _engine(tcfg, tparams).run(_requests(Request, 3))
    eng = _engine(tcfg, tparams, spec_draft="self", spec_k=3,
                  spec_draft_blocks=4)
    spec = eng.run(_requests(Request, 3))
    for rid in plain:
        assert np.array_equal(plain[rid], spec[rid])
    s = eng.summary()
    assert s["spec_draft_preempts"] > 0
    assert s["kv_draft_leaked_blocks"] == 0
    assert eng.spec.live_pages() == 0


# ---------------------------------------------------------------------------
# config validation and the CLI
# ---------------------------------------------------------------------------

def test_spec_config_validation(llama):
    """The reference's five refusals with its words.  The port resolves
    ``prefill_chunk`` through the layout: a recurrent target resolves to
    no chunk, and a paged one with ``prefill_chunk=None`` is refused by
    the layout itself."""
    _, _, tcfg, tparams = llama
    rwkv = tget_arch("rwkv6-1.6b").reduced()
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(rwkv, EngineConfig(spec_draft="self"), device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(tcfg, EngineConfig(kv_layout="paged",
                                         prefill_chunk=None,
                                         spec_draft="self"), device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        _engine(tcfg, tparams, spec_draft="self", temperature=0.7)
    with pytest.raises(ValueError, match="spec_k"):
        _engine(tcfg, tparams, spec_draft="self", spec_k=0)
    with pytest.raises(ValueError, match="family"):
        _engine(tcfg, tparams, spec_draft="rwkv6-1.6b")
    with pytest.raises(ValueError, match="shared_prefix_decode"):
        _engine(tcfg, tparams, spec_draft="self", prefix_cache=True,
                shared_prefix_decode=True)
    narrow = tcfg.replace(vocab_size=256)
    with pytest.raises(ValueError, match="vocab 512 != target vocab 256"):
        resolve_draft(narrow, None, "gemma-2b", 0)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(narrow, EngineConfig(**dict(
            COMMON, spec_draft="gemma-2b")), device="cpu")


def test_spec_smoke_cli():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--spec-draft", "self", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "spec-decode smoke OK (draft=self" in r.stdout
