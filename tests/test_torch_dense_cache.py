"""The dense KV cache, bucketed prefill and the blockwise attention route
against the JAX reference, on the CPU in f32.

- ``_chunked_attn`` / ``_chunked_attn_tri`` against the reference's with
  the softcap, ``q_offset`` / ``kv_len`` masks and the triangular walk;
  per-lane ``(B,)`` offsets against the reference run one lane at a time
  (its dense engine gives each lane scalars under ``vmap``).
- ``gqa_self_attention`` and absorbed ``mla_self_attention`` over a cache
  (prefill into a fresh cache, then decode), per lane.
- ``init_cache`` for every family, ``prefill(length=)`` over a padded
  bucket and a decode step after it, ``paged_prefill_write``.
- The dense layout and the bucketed prefill on the paged layout, served
  by the port's engine and the JAX engine: tokens, KV rows and the site
  registry (the port decodes every slot in one call, so its decode sites
  record M = num_slots where the reference's vmapped trace records 1).

Tolerances: f32 blockwise attention sums in the reference's order but
torch's einsum contracts in its own, so outputs agree to ~1e-6 of their
O(1) magnitude; 2e-5 absolute leaves a margin.  Model logits (O(1), a
few layers) are held to 5e-5.  Greedy tokens must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.models import attention as jattn
from repro.models import serving as jserving
from repro.models.api import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.models import attention as tattn
from repro_torch.models import serving as tserving
from repro_torch.models.api import build_model as tbuild
from repro_torch.serving import EngineConfig, Request, ServingEngine

ATOL = 2e-5
LOGIT_ATOL = 5e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(seed, B=2, Sq=7, Skv=20, KVH=2, G=2, hd=8, hd_v=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, KVH, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KVH, hd_v or hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("logit_cap", [0.0, 5.0])
@pytest.mark.parametrize("q_offset,kv_len", [(0, 20), (5, 12), (13, 20),
                                             (0, 9)])
@pytest.mark.parametrize("chunk", [4, 64])
def test_chunked_attn_matches_reference(causal, logit_cap, q_offset, kv_len,
                                        chunk):
    q, k, v = _qkv(0, hd_v=6)
    want = jattn._chunked_attn(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               q_offset=q_offset, kv_len=kv_len, chunk=chunk,
                               logit_cap=logit_cap)
    got = tattn._chunked_attn(_t(q), _t(k), _t(v), causal=causal,
                              q_offset=q_offset, kv_len=kv_len, chunk=chunk,
                              logit_cap=logit_cap)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("chunk", [4, 7, 32])
@pytest.mark.parametrize("logit_cap", [0.0, 5.0])
def test_chunked_attn_tri_matches_reference(chunk, logit_cap):
    """The triangular walk (``causal_skip`` from position 0, the
    reference's ``_chunked_attn_tri``) equals the reference's and the
    full masked grid; with a nonzero offset it is not taken."""
    q, k, v = _qkv(1, Sq=20, Skv=20)
    kw = dict(kv_len=18, chunk=chunk, logit_cap=logit_cap, causal=True)
    want = jattn._chunked_attn(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), q_offset=0, causal_skip=True,
                               **kw)
    tri = tattn._chunked_attn(_t(q), _t(k), _t(v), q_offset=0,
                              causal_skip=True, **kw)
    full = tattn._chunked_attn(_t(q), _t(k), _t(v), q_offset=0, **kw)
    np.testing.assert_allclose(tri.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(tri.numpy(), full.numpy(), atol=ATOL)
    shifted = jattn._chunked_attn(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), q_offset=1,
                                  causal_skip=True, **kw)
    np.testing.assert_allclose(
        tattn._chunked_attn(_t(q), _t(k), _t(v), q_offset=1,
                            causal_skip=True, **kw).numpy(),
        np.asarray(shifted), atol=ATOL)


@pytest.mark.parametrize("Sq", [1, 5])
@pytest.mark.parametrize("logit_cap", [0.0, 5.0])
def test_chunked_attn_per_lane_offsets(Sq, logit_cap):
    """(B,) q_offset / kv_len: each lane equals the reference run on that
    lane alone with its scalars."""
    B = 4
    q, k, v = _qkv(2, B=B, Sq=Sq, Skv=24)
    offs = np.array([0, 3, 10, 19])
    lens = offs + Sq
    got = tattn._chunked_attn(_t(q), _t(k), _t(v), causal=True,
                              q_offset=_t(offs), kv_len=_t(lens), chunk=8,
                              logit_cap=logit_cap)
    for b in range(B):
        want = jattn._chunked_attn(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
            jnp.asarray(v[b:b + 1]), causal=True, q_offset=int(offs[b]),
            kv_len=int(lens[b]), chunk=8, logit_cap=logit_cap)
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want),
                                   atol=ATOL)


@pytest.mark.parametrize("args", [dict(impl="xla"),
                                  dict(impl="pallas", q_offset=2),
                                  dict(impl="pallas", logit_cap=30.0),
                                  dict(impl="pallas", kv_len=3),
                                  dict(impl="pallas", decode=True)])
def test_multihead_attention_blockwise_route(args):
    """Every call the flash kernels do not take runs the blockwise route,
    as the reference's does (the Pallas route's own parity is in
    test_torch_flash_attn.py)."""
    args = dict(args)
    rng = np.random.default_rng(3)
    Sq = 1 if args.pop("decode", False) else 6
    q = rng.standard_normal((2, Sq, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    want = jattn.multihead_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True, chunk=4,
                                     **args)
    got = tattn.multihead_attention(_t(q), _t(k), _t(v), causal=True,
                                    chunk=4, **args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _models(arch, **replace):
    jcfg = get_arch(arch).reduced().replace(**replace)
    tcfg = tget_arch(arch).reduced().replace(**replace)
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, tm, jp, params_from_numpy(_flatten(jp), tcfg,
                                                     "cpu")


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_gqa_self_attention_with_cache_per_lane(softcap):
    """Prefill into a fresh cache, then two decode steps: lane b of the
    port's batch equals the reference run on lane b alone (a prompt of
    its own length, as the dense engine's vmapped lanes)."""
    jcfg, tcfg, _, _, jp, tp = _models("llama3.2-1b",
                                       attn_logit_softcap=softcap)
    jl = _layer0(jp["layers"]["attn"])
    tl = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    rng = np.random.default_rng(4)
    B, S, ML, d = 2, 6, 16, jcfg.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    steps = [rng.standard_normal((B, 1, d)).astype(np.float32)
             for _ in range(2)]
    lens = [6, 3]                     # lane 1 prefilled 3 rows, then decodes
    cache = tattn.init_gqa_cache(tcfg, B, ML, torch.float32, "cpu")
    cache.length[1] = 0
    outs = {}
    with torch.no_grad():
        # the prefill of lane 0 (6 rows) and lane 1 (3 rows) as two calls
        # into the same cache, then batched decode steps
        for b in range(B):
            one = tattn.KVCache(cache.k[b:b + 1], cache.v[b:b + 1],
                                cache.length[b:b + 1])
            o, new = tattn.gqa_self_attention(
                tl, _t(x[b:b + 1, :lens[b]]),
                torch.arange(lens[b])[None], tcfg, cache=one)
            cache.length[b] = new.length[0]
            outs[b, "prefill"] = o.numpy()
        for i, xs in enumerate(steps):
            pos = cache.length.long()[:, None]
            o, cache = tattn.gqa_self_attention(tl, _t(xs), pos, tcfg,
                                                cache=cache)
            outs["decode", i] = o.numpy()
    for b in range(B):
        jc = jattn.init_gqa_cache(jcfg, 1, ML, jnp.float32)
        with jdispatch.use(execute="xla"):
            o, jc = jattn.gqa_self_attention(
                jl, jnp.asarray(x[b:b + 1, :lens[b]]),
                jnp.arange(lens[b])[None], jcfg, cache=jc)
            np.testing.assert_allclose(outs[b, "prefill"], np.asarray(o),
                                       atol=ATOL)
            for i, xs in enumerate(steps):
                o, jc = jattn.gqa_self_attention(
                    jl, jnp.asarray(xs[b:b + 1]),
                    jnp.asarray([[lens[b] + i]]), jcfg, cache=jc)
                np.testing.assert_allclose(outs["decode", i][b:b + 1],
                                           np.asarray(o), atol=ATOL)
        assert int(jc.length) == int(cache.length[b])
        np.testing.assert_allclose(cache.k[b].numpy(), np.asarray(jc.k[0]),
                                   atol=ATOL)


def test_mla_self_attention_with_cache_per_lane():
    """Absorbed MLA over a dense latent cache, as the GQA test: prefill
    then decode, lane for lane; and the expanded full-sequence path (no
    cache, training) against the reference's, on the blockwise route."""
    jcfg, tcfg, _, _, jp, tp = _models("deepseek-v3-671b")
    jl = _layer0(jp["layers"]["attn"])
    tl = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    rng = np.random.default_rng(5)
    B, ML, d = 2, 12, jcfg.d_model
    lens = [5, 2]
    x = rng.standard_normal((B, 5, d)).astype(np.float32)
    xs = rng.standard_normal((B, 1, d)).astype(np.float32)
    cache = tattn.init_mla_cache(tcfg, B, ML, torch.float32, "cpu")
    with torch.no_grad():
        pre = {}
        for b in range(B):
            one = tattn.KVCache(cache.k[b:b + 1], cache.v[b:b + 1],
                                cache.length[b:b + 1])
            o, new = tattn.mla_self_attention(
                tl, _t(x[b:b + 1, :lens[b]]), torch.arange(lens[b])[None],
                tcfg, cache=one)
            cache.length[b] = new.length[0]
            pre[b] = o.numpy()
        dec, cache = tattn.mla_self_attention(
            tl, _t(xs), cache.length.long()[:, None], tcfg, cache=cache)
        full, none = tattn.mla_self_attention(tl, _t(x),
                                              torch.arange(5)[None], tcfg)
    assert none is None
    with jdispatch.use(execute="xla"):
        want, _ = jattn.mla_self_attention(jl, jnp.asarray(x),
                                           jnp.arange(5)[None], jcfg)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=ATOL)
    for b in range(B):
        jc = jattn.init_mla_cache(jcfg, 1, ML, jnp.float32)
        with jdispatch.use(execute="xla"):
            o, jc = jattn.mla_self_attention(
                jl, jnp.asarray(x[b:b + 1, :lens[b]]),
                jnp.arange(lens[b])[None], jcfg, cache=jc)
            np.testing.assert_allclose(pre[b], np.asarray(o), atol=ATOL)
            o, jc = jattn.mla_self_attention(
                jl, jnp.asarray(xs[b:b + 1]), jnp.asarray([[lens[b]]]),
                jcfg, cache=jc)
        np.testing.assert_allclose(dec.numpy()[b:b + 1], np.asarray(o),
                                   atol=ATOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b",
                                  "deepseek-v3-671b", "rwkv6-1.6b",
                                  "internvl2-76b", "seamless-m4t-medium"])
def test_init_cache_matches_reference(arch):
    """Every family's cache has the reference's leaves, shapes and dtypes;
    the port keeps a KV length per sequence (L, B) where the reference's
    batch shares one (L,)."""
    jcfg, tcfg = get_arch(arch).reduced(), tget_arch(arch).reduced()
    src = 6 if jcfg.family == "encdec" else 0
    jc = jserving.init_cache(jcfg, 3, 10, src_len=src)
    tc = tserving.init_cache(tcfg, 3, "cpu", 10, src_len=src)
    jflat = {k: np.asarray(a) for k, a in _flatten(jc).items()}
    tflat = {}
    for k, v in tc.items():
        if isinstance(v, tuple):
            tflat.update({f"{k}/{f}": t for f, t in zip(v._fields, v)})
        else:
            tflat[k] = v
    assert set(jflat) == set(tflat)
    for k, a in jflat.items():
        t = tflat[k]
        assert not t.any(), k
        if k == "pos":
            assert tuple(t.shape) == (3,)
        elif k == "layers/length":
            assert tuple(t.shape) == a.shape + (3,)
        else:
            assert tuple(t.shape) == a.shape, k
            assert str(t.dtype).split(".")[-1] == str(a.dtype), k
    with pytest.raises(ValueError):
        if jcfg.family != "ssm":
            tserving.init_cache(tcfg, 1, "cpu", 0)
        else:
            tserving.prefill(None, {"tokens": torch.zeros(1, 4, dtype=int)},
                             tcfg, tc, length=2)


def _batch(cfg, rng, B, n, src=6):
    toks = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.frontend.num_tokens, cfg.frontend.feature_dim)
        ).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_features"] = rng.standard_normal(
            (B, src, cfg.frontend.feature_dim)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma-2b",
                                  "qwen2-moe-a2.7b", "deepseek-v3-671b",
                                  "internvl2-76b", "seamless-m4t-medium"])
def test_padded_prefill_then_decode_matches_reference(arch):
    """A right-padded bucket of 12 with 9 valid tokens: logits at row 8,
    pos and every KV length advanced by 9 (+ the vlm frontend rows), then
    a decode step; logits, K rows, lengths and pos as the reference's."""
    jcfg, tcfg, jm, tm, jp, tp = _models(arch)
    rng = np.random.default_rng(6)
    batch = _batch(jcfg, rng, 2, 12)
    src = 6 if jcfg.family == "encdec" else 0
    with jdispatch.use(execute="xla"):
        jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                            jm.init_cache(2, 40, src_len=src), jnp.int32(9))
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jd, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {k: _t(v) for k, v in batch.items()},
                            tm.init_cache(2, 40, src_len=src), length=9)
        td, tc = tm.decode_step(tp, _t(nxt), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=LOGIT_ATOL)
    np.testing.assert_allclose(tc["layers"].k.numpy(),
                               np.asarray(jc["layers"].k), atol=ATOL)
    want = np.asarray(jc["layers"].length)
    assert (tc["layers"].length.numpy() == want[:, None]).all()
    assert (tc["pos"].numpy() == int(jc["pos"])).all()
    if jcfg.family == "encdec":
        np.testing.assert_allclose(tc["cross_k"].numpy(),
                                   np.asarray(jc["cross_k"]), atol=ATOL)


def test_paged_prefill_write_matches_reference():
    """A batch-1 dense cache scattered page by page into the arena: the
    same pages as the reference's, bucket padding included."""
    jcfg, tcfg, jm, tm, jp, tp = _models("llama3.2-1b")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 512, (1, 16)).astype(np.int32)
    with jdispatch.use(execute="xla"):
        _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                           jm.init_cache(1, 20), jnp.int32(11))
    with torch.no_grad():
        _, tc = tm.prefill(tp, {"tokens": _t(toks)}, tm.init_cache(1, 20),
                           length=11)
    ids = np.array([5, 2, 7], np.int32)
    ja = jm.paged_prefill_write(jm.init_paged_arena(9, 4), jc["layers"],
                                jnp.asarray(ids))
    ta = tm.paged_prefill_write(tm.init_paged_arena(9, 4), tc["layers"],
                                _t(ids))
    for name in ("k", "v"):
        np.testing.assert_allclose(ta[name].numpy(), np.asarray(ja[name]),
                                   atol=ATOL)
    assert ta["k"][:, [0, 1, 3, 4, 6, 8]].abs().sum() == 0


def _serve_both(arch, prompts, gen=6, extras=None, **kw):
    jcfg, tcfg, _, _, jp, tp = _models(arch)
    common = dict(num_slots=2, max_len=32, block_size=4, temperature=0.0,
                  clock="steps")
    common.update(kw)
    extras = extras or [None] * len(prompts)
    jeng = JServingEngine(jcfg, JEngineConfig(**common, execute="xla"),
                          params=jp)
    jout = jeng.run([JRequest(f"r{i}", p, gen, extras=e)
                     for i, (p, e) in enumerate(zip(prompts, extras))])
    teng = ServingEngine(tcfg, EngineConfig(**common), params=tp,
                         device="cpu")
    tout = teng.run([Request(f"r{i}", p, gen, extras=e)
                     for i, (p, e) in enumerate(zip(prompts, extras))])
    assert set(tout) == set(jout)
    for rid in jout:
        assert len(tout[rid]) == gen
        assert np.array_equal(tout[rid], jout[rid]), (rid, tout[rid],
                                                      jout[rid])
    teng.pool.check()
    assert teng.pool.num_free == teng.pool.num_blocks
    assert all(r.outcome == "done" for r in teng.requests.values())
    assert teng.kv_layout == jeng.kv_layout
    return jeng, teng


def _prompts(seed=0, lens=(5, 13, 21), vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _key(rec):
    return (rec.m, rec.k, rec.n, rec.block_m, rec.block_n, rec.block_k,
            rec.mode)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b",
                                  "deepseek-v3-671b"])
@pytest.mark.parametrize("buckets", [None, (8, 24)])
def test_dense_engine_matches_reference(arch, buckets):
    """kv_layout="dense" with bucketed prefill: the same greedy tokens as
    the JAX engine, the same prefill buckets and tiles in the registry;
    decode records the same sites and (K, N) at M = num_slots (the
    reference's vmapped trace: M = 1)."""
    jeng, teng = _serve_both(arch, _prompts(), kv_layout="dense",
                             prefill_chunk=None, buckets=buckets)
    assert teng.kv_layout == "dense" and teng.prefill_chunk is None
    want = {"decode"} | {f"prefill:m{jeng.bucket_for(n)}"
                         for n in (5, 13, 21)}
    assert set(teng.registry.scopes()) == set(jeng.registry.scopes()) == want
    assert [teng.bucket_for(n) for n in range(1, 32)] == \
        [jeng.bucket_for(n) for n in range(1, 32)]
    for scope in want:
        ours, theirs = teng.registry.sites(scope), jeng.registry.sites(scope)
        assert set(ours) == set(theirs)
        if scope == "decode":
            assert {s: (r.k, r.n) for s, r in ours.items()} == \
                {s: (r.k, r.n) for s, r in theirs.items()}
            assert {r.m for s, r in ours.items()
                    if not s.startswith("moe.expert")} == {2}
            assert {r.m for s, r in theirs.items()
                    if not s.startswith("moe.expert")} == {1}
        else:
            assert {s: _key(r) for s, r in ours.items()} == \
                {s: _key(r) for s, r in theirs.items()}
    for k in ("decode_steps", "prefill_tokens", "decode_tokens"):
        assert getattr(teng.metrics, k) == getattr(jeng.metrics, k), k


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b",
                                  "deepseek-v3-671b"])
def test_bucketed_paged_engine_matches_reference(arch):
    """kv_layout="paged" with prefill_chunk=None: each bucket is scattered
    into pages, decode runs the paged path; the same tokens, arena rows
    over the live pages and KV-write counters as the JAX engine's."""
    jeng, teng = _serve_both(arch, _prompts(1), kv_layout="paged",
                             prefill_chunk=None, reserve="incremental")
    assert teng.prefill_chunk is None
    for k in ("decode_steps", "prefill_kv_write_rows",
              "prefill_kv_write_rows_padded", "kv_read_tokens"):
        assert getattr(teng.metrics, k) == getattr(jeng.metrics, k), k
    assert teng.pool.peak_in_use == jeng.pool.peak_in_use
    assert set(teng.registry.scopes()) == set(jeng.registry.scopes())


def test_dense_engine_kv_rows_match_reference():
    """Mid-trace, the dense slot caches hold the reference's K/V rows at
    each live slot's length (stall-free trace, one request a slot)."""
    jcfg, tcfg, _, _, jp, tp = _models("llama3.2-1b")
    common = dict(num_slots=2, max_len=32, block_size=4, temperature=0.0,
                  clock="steps", kv_layout="dense", prefill_chunk=None)
    prompts = _prompts(2, (7, 11))
    jeng = JServingEngine(jcfg, JEngineConfig(**common, execute="xla"),
                          params=jp)
    teng = ServingEngine(tcfg, EngineConfig(**common), params=tp,
                         device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(f"r{i}", p, 8))
        teng.submit(Request(f"r{i}", p, 8))
    for _ in range(5):
        jeng.step()
        teng.step()
    jc, tc = jeng._cache, teng._cache
    for slot in range(2):
        n = int(np.asarray(jc["layers"].length)[slot, 0])
        assert (tc["layers"].length[:, slot].numpy() == n).all()
        assert int(tc["pos"][slot]) == int(np.asarray(jc["pos"])[slot])
        np.testing.assert_allclose(
            tc["layers"].k[:, slot, :n].numpy(),
            np.asarray(jc["layers"].k)[slot, :, 0, :n], atol=ATOL)


def test_dense_engine_stalls_and_preempts_like_reference():
    """A pool too small for both requests under incremental reservation:
    the dense layout stalls (rolling a lane back to its snapshot) and
    preempts as the reference's does, with the same tokens."""
    jeng, teng = _serve_both("llama3.2-1b", _prompts(3, (9, 10, 6)), gen=10,
                             kv_layout="dense", prefill_chunk=None,
                             reserve="incremental", num_blocks=7)
    assert teng.metrics.stalls == jeng.metrics.stalls > 0
    assert teng.metrics.preemptions == jeng.metrics.preemptions


def test_engine_layout_refusals_match_reference():
    """What the reference refuses the port refuses: chunked prefill on the
    dense layout or for vlm / encdec, a prefix cache without chunks."""
    for arch, kw in (("llama3.2-1b", dict(kv_layout="dense",
                                          prefill_chunk=8)),
                     ("internvl2-76b", dict(kv_layout="paged",
                                            prefill_chunk=8)),
                     ("seamless-m4t-medium", dict(kv_layout="paged",
                                                  prefill_chunk=8)),
                     ("llama3.2-1b", dict(prefill_chunk=None,
                                          prefix_cache=True))):
        jcfg, tcfg = get_arch(arch).reduced(), tget_arch(arch).reduced()
        with pytest.raises(ValueError):
            JServingEngine(jcfg, JEngineConfig(**kw, execute="xla"))
        with pytest.raises(ValueError):
            ServingEngine(tcfg, EngineConfig(**kw), device="cpu")
    # "auto" keeps the port's meaning: paged for the attention families,
    # chunks of 64 where they stream, buckets for vlm / encdec
    for arch, want in (("llama3.2-1b", ("paged", 64)),
                       ("internvl2-76b", ("paged", None)),
                       ("seamless-m4t-medium", ("paged", None))):
        eng = ServingEngine(tget_arch(arch).reduced(), EngineConfig(),
                            device="cpu")
        assert (eng.kv_layout, eng.prefill_chunk) == want
