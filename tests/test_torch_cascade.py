"""Cascade (shared-prefix) decode parity: the port's prefix cache, its plain
cascade attention versions (what CPU tensors run, and what the CUDA kernels
are held against on the card), its shared decode step and its engine with
``prefix_cache`` / ``shared_prefix_decode``, each against the JAX package
on the same numpy inputs.

Tolerances: 1e-5 absolute in f32 on attention outputs and softmax states
of magnitude ~1 (the Pallas kernels, run in interpret mode, take an online
softmax, the oracles one masked softmax: summation order only); exact
where both sides compute the same masked softmax over the same table
(``shared_paged_attention_plain`` against the reference's oracle and
against ``paged_attention_plain``, at equal table width only: the
reference itself differs by ~1e-7 when the widths differ); 1e-4 on logits
and 1e-5 on arena rows for the model step, as ``test_torch_model.py``;
identical greedy tokens and cache counters for the engines.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.kernels import ref as jref
from repro.kernels.paged_attn import (paged_gqa_decode_lse_pallas,
                                      paged_gqa_prefix_pallas)
from repro.models.api import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving.kv_pool import KVBlockPool as JKVBlockPool
from repro.serving.prefix_cache import PrefixCache as JPrefixCache
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attn import (NEG, _attn_plan,
                                            merge_softmax_states,
                                            paged_attention_lse_plain,
                                            paged_attention_plain,
                                            shared_paged_attention_plain,
                                            shared_prefix_attention_plain)
from repro_torch.models import serving
from repro_torch.models.api import build_model as tbuild
from repro_torch.serving import (EngineConfig, KVBlockPool, PoolError,
                                 PrefixCache, Request, ServingEngine)

BS = 4
TOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(ours, theirs, tol=TOL):
    return np.abs(np.asarray(ours) - np.asarray(theirs)).max() <= tol


def _cascade_inputs(rng, KVH, G, hd=16, P=3, pad=2):
    """Five lanes over one arena: lanes 0-2 share the first P pages
    (prefix lengths P*BS, P*BS and (P-1)*BS: a member may take fewer
    pages of the run), lane 3 is not in the group, lane 4 is a member
    with an empty unique suffix; the unique lengths are ragged and
    include 0.  ``prefix_pages`` is padded with ``pad`` repeats of the
    last id."""
    S = 5
    prefix_lens = np.array([P, P, P - 1, 0, P], np.int32) * BS
    unique_lens = np.array([5, 1, 8, 9, 0], np.int32)
    uw = 3
    nxt = P
    utables = np.zeros((S, uw), np.int32)
    full = []
    for s in range(S):
        n = -(-int(unique_lens[s]) // BS)
        own = list(range(nxt, nxt + n))
        nxt += n
        row = own if own else [0]
        utables[s, :len(row)] = row
        utables[s, len(row):] = row[-1]
        full.append(list(range(prefix_lens[s] // BS)) + own)
    prefix_pages = np.array(list(range(P)) + [P - 1] * pad, np.int32)
    NB = nxt + 1
    k = rng.standard_normal((NB, BS, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((NB, BS, KVH, hd)).astype(np.float32)
    q = rng.standard_normal((S, KVH * G, hd)).astype(np.float32)
    return dict(q=q, k=k, v=v, prefix_pages=prefix_pages,
                prefix_lens=prefix_lens, utables=utables,
                unique_lens=unique_lens, full=full)


def _full_tables(full, width):
    t = np.zeros((len(full), width), np.int32)
    for s, row in enumerate(full):
        row = row if row else [0]
        t[s, :len(row)] = row
        t[s, len(row):] = row[-1]
    return t


# ---------------------------------------------------------------------------
# plain versions against the reference's oracles and Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("KVH,G", [(2, 2), (1, 4)])
def test_decode_lse_plain_matches_pallas_and_ref(cap, KVH, G):
    rng = np.random.default_rng(20 + int(cap) + KVH)
    x = _cascade_inputs(rng, KVH, G)
    S, hd = x["q"].shape[0], x["q"].shape[-1]
    scale = 1.0 / hd ** 0.5
    ours = paged_attention_lse_plain(
        _t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["utables"]),
        _t(x["unique_lens"]), scale=scale, logit_cap=cap)
    args = [jnp.asarray(a) for a in (x["q"], x["k"], x["v"], x["utables"],
                                     x["unique_lens"])]
    oracle = jref.paged_attention_lse_ref(*args, scale=scale, logit_cap=cap)
    qg = args[0].reshape(S, KVH, G, hd)
    pallas = paged_gqa_decode_lse_pallas(qg, *args[1:], scale, True,
                                         logit_cap=cap)
    for i, (o, p) in enumerate(zip(ours, oracle)):
        assert _close(o.numpy(), p), i
    assert _close(ours[0].numpy(), np.asarray(pallas[0]).reshape(S, -1, hd))
    for i in (1, 2):
        assert _close(ours[i].numpy(), np.asarray(pallas[i]).reshape(S, -1))
    # the empty lane is exactly the empty state
    assert np.all(ours[0][4].numpy() == 0.0)
    assert np.all(ours[1][4].numpy() == NEG)
    assert np.all(ours[2][4].numpy() == 0.0)


@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("KVH,G", [(2, 2), (1, 4)])
def test_prefix_plain_matches_pallas_and_ref(cap, KVH, G):
    rng = np.random.default_rng(30 + int(cap) + KVH)
    x = _cascade_inputs(rng, KVH, G)
    S, hd = x["q"].shape[0], x["q"].shape[-1]
    scale = 1.0 / hd ** 0.5
    ours = shared_prefix_attention_plain(
        _t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["prefix_pages"]),
        _t(x["prefix_lens"]), scale=scale, logit_cap=cap)
    args = [jnp.asarray(a) for a in (x["q"], x["k"], x["v"],
                                     x["prefix_pages"], x["prefix_lens"])]
    oracle = jref.shared_prefix_attention_ref(*args, scale=scale,
                                              logit_cap=cap)
    qg = args[0].reshape(S, KVH, G, hd)
    pallas = paged_gqa_prefix_pallas(qg, *args[1:], scale, True,
                                     logit_cap=cap)
    for i, (o, p) in enumerate(zip(ours, oracle)):
        assert _close(o.numpy(), p), i
    assert _close(ours[0].numpy(), np.asarray(pallas[0]).reshape(S, -1, hd))
    for i in (1, 2):
        assert _close(ours[i].numpy(), np.asarray(pallas[i]).reshape(S, -1))
    # the non-member lane is exactly the empty state, in both packages
    for o, m, l in (ours, [np.asarray(a) for a in pallas]):
        o, m, l = (np.asarray(a).reshape(S, -1) for a in (o, m, l))
        assert np.all(o[3] == 0.0) and np.all(m[3] == NEG) and \
            np.all(l[3] == 0.0)


@pytest.mark.parametrize("cap", [0.0, 5.0])
def test_combined_plain_is_bitwise_the_plain_decode(cap):
    rng = np.random.default_rng(40 + int(cap))
    x = _cascade_inputs(rng, 2, 2, pad=0)
    hd = x["q"].shape[-1]
    scale = 1.0 / hd ** 0.5
    # equal width: the combined table is as wide as the full tables
    width = x["prefix_pages"].shape[0] + x["utables"].shape[1]
    full = _full_tables(x["full"], width)
    lens = x["prefix_lens"] + x["unique_lens"]
    ours = shared_paged_attention_plain(
        _t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["utables"]),
        _t(x["unique_lens"]), _t(x["prefix_pages"]), _t(x["prefix_lens"]),
        scale=scale, logit_cap=cap).numpy()
    plain = paged_attention_plain(_t(x["q"]), _t(x["k"]), _t(x["v"]),
                                  _t(full), _t(lens), scale=scale,
                                  logit_cap=cap).numpy()
    oracle = np.asarray(jref.shared_paged_attention_ref(
        *[jnp.asarray(a) for a in (x["q"], x["k"], x["v"], x["utables"],
                                   x["unique_lens"], x["prefix_pages"],
                                   x["prefix_lens"])],
        scale=scale, logit_cap=cap))
    assert np.array_equal(ours, plain)
    assert _close(ours, oracle)
    # the wrapper runs the plain version for CPU tensors, no kernel
    ops.reset_counts()
    via = ops.shared_paged_attention(
        _t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["utables"]),
        _t(x["unique_lens"]), _t(x["prefix_pages"]), _t(x["prefix_lens"]),
        logit_cap=cap).numpy()
    assert np.array_equal(via, ours)
    counts = ops.launch_counts()
    assert counts["paged_prefix"] == 0 and counts["paged_decode_lse"] == 0
    assert counts["plain_calls"] == 1


@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("KVH,G", [(2, 2), (1, 4)])
def test_two_phase_merge_matches_combined(cap, KVH, G):
    """The kernels' route (prefix phase, unique phase, merge), taken with
    the plain versions, against the one-softmax combined version."""
    rng = np.random.default_rng(50 + int(cap) + KVH)
    x = _cascade_inputs(rng, KVH, G)
    hd = x["q"].shape[-1]
    scale = 1.0 / hd ** 0.5
    a = [_t(x[n]) for n in ("q", "k", "v")]
    pre = shared_prefix_attention_plain(*a, _t(x["prefix_pages"]),
                                        _t(x["prefix_lens"]), scale=scale,
                                        logit_cap=cap)
    uni = paged_attention_lse_plain(*a, _t(x["utables"]),
                                    _t(x["unique_lens"]), scale=scale,
                                    logit_cap=cap)
    merged, _, _ = merge_softmax_states(*pre, *uni)
    combined = shared_paged_attention_plain(
        *a, _t(x["utables"]), _t(x["unique_lens"]), _t(x["prefix_pages"]),
        _t(x["prefix_lens"]), scale=scale, logit_cap=cap)
    assert _close(merged.numpy(), combined.numpy())
    # the reference's merge gives the same union state
    jm = jref.merge_softmax_states(*[jnp.asarray(t.numpy())
                                     for t in (*pre, *uni)])
    ours = merge_softmax_states(*pre, *uni)
    for o, j in zip(ours, jm):
        assert _close(o.numpy(), j)


def test_merge_with_an_empty_side_is_the_identity():
    rng = np.random.default_rng(60)
    o = _t(rng.standard_normal((3, 4, 8)).astype(np.float32))
    m = _t(rng.standard_normal((3, 4)).astype(np.float32))
    l = _t(rng.uniform(0.5, 4.0, (3, 4)).astype(np.float32))
    eo, em, el = torch.zeros_like(o), torch.full_like(m, NEG), \
        torch.zeros_like(l)
    for args in ((o, m, l, eo, em, el), (eo, em, el, o, m, l)):
        mo, mm, ml = merge_softmax_states(*args)
        assert torch.equal(mm, m) and torch.equal(ml, l)
        assert torch.allclose(mo, o, atol=1e-6, rtol=0)
    zo, zm, zl = merge_softmax_states(eo, em, el, eo, em, el)
    assert torch.all(zo == 0.0) and torch.all(zl == 0.0)


# ---------------------------------------------------------------------------
# the shared-prefix kernel's split-KV arithmetic (csrc/paged_attn.cu): each
# split's page columns attended alone, the states merged in split order
# ---------------------------------------------------------------------------

def _split_prefix(q, k, v, pages, plens, plan, scale, cap):
    """The plain twin of the prefix kernel's split-and-merge: split j
    attends the prefix columns [j * pages, (j + 1) * pages) through
    ``shared_prefix_attention_plain`` (lanes whose prefix ends before them
    get the empty state), and ``merge_softmax_states`` folds the splits in
    ascending order from the empty state.  Returns (o, m, l)."""
    S, H = q.shape[0], q.shape[1]
    P, bs = pages.shape[0], k.shape[1]
    o = torch.zeros((S, H, v.shape[-1]))
    m = torch.full((S, H), NEG)
    l = torch.zeros((S, H))
    for j in range(plan.splits):
        c0, c1 = j * plan.pages, min((j + 1) * plan.pages, P)
        if c1 <= c0:
            continue
        lens = torch.clamp(plens - c0 * bs, 0, (c1 - c0) * bs)
        part = shared_prefix_attention_plain(
            q, k, v, pages[c0:c1].contiguous(), lens, scale=scale,
            logit_cap=cap)
        o, m, l = merge_softmax_states(o, m, l, *part)
    return o.to(q.dtype), m, l


def _prefix_split_inputs(rng, KVH, G, hd, P=40, pad=2):
    """Six lanes over a P-page prefix (pages of 4 rows) on shuffled arena
    pages: the whole run, one row short of it, a non-member, a prefix
    inside the first split, one on a 24-row boundary (7 forced splits of 6
    pages) and one a row past it."""
    plens = np.array([P * BS, P * BS - 1, 0, 3, 24, 25], np.int32)
    pages = rng.permutation(P + 3)[:P].astype(np.int32)
    pages = np.concatenate([pages, np.full(pad, pages[-1], np.int32)])
    k = rng.standard_normal((P + 3, BS, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((P + 3, BS, KVH, hd)).astype(np.float32)
    q = rng.standard_normal((6, KVH * G, hd)).astype(np.float32)
    return q, k, v, pages, plens


@pytest.mark.parametrize("splits", [None, 2, 7], ids=["plan", "2", "7"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("cap", [0.0, 5.0])
def test_split_prefix_twin_matches_plain_ref_and_pallas(splits, hd, cap):
    """The twin equals the one-softmax plain version, the reference's
    oracle and its Pallas kernel (interpret) within 2e-5 on o and 1e-5
    relative on m and l, under the plan's split count (3 splits of 16
    pages: 64 rows each) and forced ones; the non-member lane is exactly
    (0, -1e30, 0)."""
    rng = np.random.default_rng(hd + int(cap) + (splits or 0))
    KVH, G = 2, 2
    q, k, v, pages, plens = _prefix_split_inputs(rng, KVH, G, hd)
    S, W = q.shape[0], pages.shape[0]
    scale = 1.0 / hd ** 0.5
    plan = _attn_plan(1, S * G, KVH, W, BS, hd, hd, 4, 132, splits=splits)
    if splits is None:
        assert (plan.splits, plan.pages) == (3, 16)
    tq, tk, tv, tp, tl = (_t(x) for x in (q, k, v, pages, plens))
    o, m, l = _split_prefix(tq, tk, tv, tp, tl, plan, scale, cap)
    args = [jnp.asarray(x) for x in (q, k, v, pages, plens)]
    wants = [shared_prefix_attention_plain(tq, tk, tv, tp, tl, scale=scale,
                                           logit_cap=cap),
             jref.shared_prefix_attention_ref(*args, scale=scale,
                                              logit_cap=cap),
             paged_gqa_prefix_pallas(args[0].reshape(S, KVH, G, hd),
                                     *args[1:], scale, True, logit_cap=cap)]
    for wo, wm, wl in wants:
        wo, wm, wl = (np.asarray(x).reshape(S, KVH * G, -1)
                      for x in (wo, wm, wl))
        wm, wl = wm[..., 0], wl[..., 0]
        assert np.abs(o.numpy() - wo).max() <= 2e-5
        assert (np.abs(m.numpy() - wm) / np.maximum(np.abs(wm), 1.0)).max() \
            <= 1e-5
        assert (np.abs(l.numpy() - wl) / np.maximum(wl, 1.0)).max() <= 1e-5
    assert torch.all(o[2] == 0) and torch.all(m[2] == NEG) and \
        torch.all(l[2] == 0)


# ---------------------------------------------------------------------------
# the prefix cache: the port's copy against the reference, op for op
# ---------------------------------------------------------------------------

def _serve(pool, cache, rid, prompt):
    """Admit ``prompt`` as the scheduler would (share the matched pages,
    reserve the rest) and index its full pages; returns (matched, added)
    or the string "oom"."""
    pages = cache.match(prompt)
    cache.record_lookup(len(pages))
    try:
        if pages:
            pool.share(rid, pages)
            pool.extend(rid, len(prompt))
        else:
            pool.alloc(rid, len(prompt))
    except Exception as e:                       # both pools raise alike
        if pages and rid in pool.live_requests():
            pool.free(rid)
        return f"oom:{type(e).__name__}"
    nfull = len(prompt) // pool.block_size
    added = cache.insert(prompt, pool.table(rid).blocks[:nfull])
    return pages, added


def test_prefix_cache_matches_reference_op_for_op():
    rng = np.random.default_rng(70)
    heads = [rng.integers(0, 50, 12).astype(np.int32) for _ in range(3)]
    pools = (KVBlockPool(24, BS), JKVBlockPool(24, BS))
    caches = (PrefixCache(pools[0]), JPrefixCache(pools[1]))
    live = []
    for step in range(60):
        op = rng.choice(["serve", "serve", "free", "evict"])
        if op == "serve":
            head = heads[rng.integers(len(heads))][:rng.integers(4, 13)]
            tail = rng.integers(0, 50, rng.integers(0, 9)).astype(np.int32)
            prompt = np.concatenate([head, tail]).astype(np.int32)
            rid = f"r{step}"
            got = [_serve(p, c, rid, prompt) for p, c in zip(pools, caches)]
            if not isinstance(got[0], str):
                live.append(rid)
        elif op == "free" and live:
            rid = live.pop(int(rng.integers(len(live))))
            got = [p.free(rid) for p in pools]
        else:
            n = int(rng.integers(1, 4))
            exclude = (caches[0].pages()[:1]
                       if rng.integers(2) and caches[0].pages() else None)
            got = [c.evict(n, exclude=exclude) for c in caches]
        assert got[0] == got[1], (step, op, got)
        assert pools[0].num_free == pools[1].num_free, step
        assert sorted(caches[0].pages()) == sorted(caches[1].pages()), step
        assert caches[0].stats() == caches[1].stats(), step
    for rid in live:
        for p in pools:
            p.free(rid)
    assert caches[0].clear() == caches[1].clear()
    assert caches[0].stats() == caches[1].stats()
    assert caches[0].hits > 0 and caches[0].evicted_pages > 0
    for p in pools:
        p.check()
        assert p.num_free == p.num_blocks


def test_cache_eviction_spares_referenced_pages():
    pool = KVBlockPool(8, BS)
    cache = PrefixCache(pool)
    prompt = np.arange(8, dtype=np.int32)
    pool.alloc("a", 8)
    blocks = list(pool.table("a").blocks)
    assert cache.insert(prompt, blocks) == 2
    assert cache.evict(2) == 0                   # "a" still holds both
    pool.free("a")
    assert pool.num_free == 6                    # pinned by the trie
    assert cache.match(prompt) == blocks
    assert cache.evict(2) == 2 and pool.num_free == 8
    with pytest.raises(PoolError):
        pool.unpin(0)


# ---------------------------------------------------------------------------
# model and engine against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = get_arch("llama3.2-1b").reduced()
    tcfg = tget_arch("llama3.2-1b").reduced()
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_numpy(_flatten(jparams), tcfg,
                                                  "cpu")


def test_shared_decode_step_matches_reference(weights):
    jcfg, jparams, tcfg, tparams = weights
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    rng = np.random.default_rng(80)
    L, KVH, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    NB = 8                                      # page 7 is the trash page
    arena = {n: (rng.standard_normal((L, NB, BS, KVH, hd)) * 0.5)
             .astype(np.float32) for n in ("k", "v")}
    # lanes 0 and 1 share pages 0-1; lane 2 is outside the group
    tables = np.array([[0, 1, 2, 3], [0, 1, 4, 4], [5, 6, 6, 6]], np.int32)
    kv = np.array([13, 11, 6], np.int32)
    wm = np.array([1, 1, 1], np.int32)
    prefix_pages = np.array([0, 1, 1, 1], np.int32)     # padded
    prefix_lens = np.array([8, 8, 0], np.int32)
    utables = np.array([[2, 3], [4, 4], [5, 6]], np.int32)
    ulens = kv + wm - prefix_lens
    toks = rng.integers(0, tcfg.vocab_size, (3, 1)).astype(np.int32)
    ops_in = (tables, kv, wm, prefix_pages, prefix_lens, utables, ulens)

    ja = {n: jnp.asarray(a) for n, a in arena.items()}
    jl, ja = jm.paged_shared_decode_step(
        jparams, jnp.asarray(toks), {}, ja, *[jnp.asarray(a) for a in ops_in])
    ta = {n: _t(a.copy()) for n, a in arena.items()}
    with torch.no_grad():
        tl, ta = tm.paged_shared_decode_step(tparams, _t(toks), ta,
                                             *[_t(a) for a in ops_in])
    assert _close(tl.numpy(), jl, 1e-4)
    for n in ("k", "v"):
        assert _close(ta[n].numpy()[:, :-1], np.asarray(ja[n])[:, :-1])
    # the step wrote each lane's pending row where its full table says
    assert not np.array_equal(ta["k"].numpy()[:, 3, 1], arena["k"][:, 3, 1])


@pytest.mark.parametrize("field,value", [("attention_type", "mla"),
                                         ("family", "ssm")])
def test_shared_decode_step_refuses_what_it_does_not_cover(weights, field,
                                                           value):
    cfg = dataclasses.replace(weights[2], **{field: value})
    with pytest.raises(ValueError, match="cascade"):
        serving.paged_shared_decode_step(None, None, cfg, None, *[None] * 7)


def _engines(weights, prompts, gen=6, **kw):
    """The same requests through the JAX engine (pinned to XLA) and the
    port's, from the same weights; returns both engines and outputs."""
    jcfg, jparams, tcfg, tparams = weights
    common = dict(num_slots=2, max_len=23, block_size=8, temperature=0.0,
                  kv_layout="paged", prefill_chunk=8, clock="steps")
    common.update(kw)
    jeng = JServingEngine(jcfg, JEngineConfig(**common, execute="xla"),
                          params=jparams)
    jout = jeng.run([JRequest(f"r{i}", p, gen)
                     for i, p in enumerate(prompts)])
    teng = ServingEngine(tcfg, EngineConfig(**common), params=tparams,
                         device="cpu")
    tout = teng.run([Request(f"r{i}", p, gen)
                     for i, p in enumerate(prompts)])
    assert set(tout) == set(jout)
    for rid in jout:
        assert len(tout[rid]) == gen
        assert np.array_equal(tout[rid], jout[rid]), (rid, tout[rid],
                                                      jout[rid])
    return jeng, teng


def _same_cache_counters(jeng, teng):
    jc, tc = jeng.prefix_cache, teng.prefix_cache
    assert (tc.hits, tc.misses, tc.reused_pages, tc.inserted_pages,
            tc.evicted_pages) == (jc.hits, jc.misses, jc.reused_pages,
                                  jc.inserted_pages, jc.evicted_pages)
    assert teng.pool.cow_copies == jeng.pool.cow_copies
    assert teng.pool.shared_pages == jeng.pool.shared_pages
    assert teng.metrics.cache_hit_tokens == jeng.metrics.cache_hit_tokens
    assert teng.metrics.cache_hit_pages == jeng.metrics.cache_hit_pages
    assert teng.metrics.prefill_kv_write_rows == \
        jeng.metrics.prefill_kv_write_rows
    assert teng.metrics.prefill_flops_saved == pytest.approx(
        jeng.metrics.prefill_flops_saved)
    # the trie's pins are all that is left; clearing it makes the pool
    # whole again
    assert sorted(teng.prefix_cache.pages()) == \
        sorted(jeng.prefix_cache.pages())
    assert teng.summary()["kv_pinned_pages"] == len(tc.pages())
    teng.prefix_cache.clear()
    teng.pool.check()
    assert teng.pool.num_free == teng.pool.num_blocks


def test_engine_prefix_cache_cow_matches_reference(weights):
    """Three identical 16-token prompts on one slot: both recipients match
    the whole prompt and resume at the minus-one offset inside the last
    shared page, the write that must copy-on-write."""
    cfg = weights[0]
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    prompts = [prompt.copy() for _ in range(3)]
    jeng, teng = _engines(weights, prompts, num_slots=1, num_blocks=6,
                          prefix_cache=True)
    assert teng.prefix_cache.hits == 2
    assert teng.prefix_cache.reused_pages == 4
    assert teng.pool.cow_copies >= 2
    assert teng.metrics.cache_hit_tokens == 2 * 15
    s = teng.summary()
    assert s["prefix_cache_hits"] == 2 and s["kv_cow_copies"] >= 2
    assert s["shared_prefix_steps"] == 0
    _same_cache_counters(jeng, teng)


def test_engine_cascade_decode_matches_reference(weights):
    """Four 20-token prompts opening with the same 16 tokens on two slots:
    r0/r1 prefill together (r1 misses), then r2/r3 both hit and decode
    side by side through the donor's pages, the group the cascade needs."""
    cfg = weights[0]
    rng = np.random.default_rng(12)
    shared = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    prompts = []
    for _ in range(4):
        p = rng.integers(0, cfg.vocab_size, 20).astype(np.int32)
        p[:16] = shared
        prompts.append(p)
    jeng, teng = _engines(weights, prompts, max_len=30, prefix_cache=True,
                          shared_prefix_decode=True)
    steps = int(jeng.obs.counters.get("shared_prefix_steps", 0))
    assert teng.shared_prefix_steps > 0
    assert teng.shared_prefix_steps == steps
    assert teng.summary()["shared_prefix_steps"] == steps
    assert teng.shared_prefix_lanes >= 2 * steps
    _same_cache_counters(jeng, teng)


def test_cascade_needs_the_prefix_cache():
    with pytest.raises(ValueError, match="prefix_cache"):
        ServingEngine(tget_arch("llama3.2-1b").reduced(),
                      EngineConfig(shared_prefix_decode=True), device="cpu")
