"""The vlm (``internvl2-76b``) and encdec (``seamless-m4t-medium``)
families against the JAX reference, on the CPU in f32 at their reduced
presets, from JAX-initialised weights.

- The frontends (the audio projection; the vision projector, GEMM,
  tanh-GELU, GEMM), the bidirectional encoder stack, cross-attention and
  ``cross_attention_kv``; the encoder under the optimized profile runs
  the flash forward (its plain version here), once a layer, against the
  reference's Pallas kernel in interpret mode.
- Both families' engines against the JAX engine with the requests'
  ``patch_embeds`` / ``src_features`` carried across, and their zero
  defaults: paged with bucketed prefill, and the dense layout.

Tolerances: 2e-5 on O(1) activations of one block, 5e-5 on the encoder
stack's output and logits (a few layers of f32 GEMMs summed in other
orders); greedy tokens equal.
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
from repro.models import transformer as jtf
from repro.models.api import build_model as jbuild
from repro.models.mlp import mlp_apply as jmlp
from repro.models.modules import layernorm as jlayernorm
from repro.models.modules import rmsnorm as jrmsnorm
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.kernels import flash_attn
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.modules import layernorm as tlayernorm
from repro_torch.serving import EngineConfig, Request, ServingEngine

ATOL = 2e-5
STACK_ATOL = 5e-5
SRC = 10


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(arch, optimized=False):
    jcfg = get_arch(arch, optimized=optimized).reduced()
    tcfg = tget_arch(arch, optimized=optimized).reduced()
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(_flatten(jp), tcfg, "cpu")


@pytest.mark.parametrize("arch", ["internvl2-76b", "seamless-m4t-medium"])
def test_frontend_matches_reference(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 7, jcfg.frontend.feature_dim)) \
        .astype(np.float32)
    with jdispatch.use(execute="xla"):
        want = jtf._frontend_embed(jp, jnp.asarray(feats), jcfg)
    got = ttf._frontend_embed(tp, _t(feats), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_layernorm_matches_reference():
    rng = np.random.default_rng(1)
    x, s, b = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((3, 5, 16), (16,), (16,)))
    np.testing.assert_allclose(
        tlayernorm(_t(x), _t(s), _t(b)).numpy(),
        np.asarray(jlayernorm(jnp.asarray(x), jnp.asarray(s),
                              jnp.asarray(b))), atol=1e-6)


def _ref_encode(jp, feats, jcfg):
    """The reference's encoder pass, as its ``prefill`` runs it."""
    x = jtf._frontend_embed(jp, feats, jcfg)
    pos = jnp.arange(x.shape[1])[None, :]
    for i in range(jcfg.encoder_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], jp["enc_layers"])
        h = jrmsnorm(x, lp["ln1"], jcfg.norm_eps)
        a, _ = jattn.gqa_self_attention(lp["attn"], h, pos, jcfg,
                                        causal=False)
        x = x + a
        x = x + jmlp(lp["mlp"], jrmsnorm(x, lp["ln2"], jcfg.norm_eps), jcfg)
    return jrmsnorm(x, jp["ln_enc"], jcfg.norm_eps)


@pytest.mark.parametrize("optimized", [False, True])
def test_encoder_and_cross_kv_match_reference(optimized):
    """The encoder stack (blockwise route, or the flash forward once a
    layer under the optimized profile) and each decoder layer's cross K/V;
    cross-attention of a prefill (flash under the optimized profile) and
    of a decode step (the blockwise route)."""
    jcfg, tcfg, jp, tp = _models("seamless-m4t-medium", optimized)
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, SRC, jcfg.frontend.feature_dim)) \
        .astype(np.float32)
    with jdispatch.use(execute="xla"):
        want = _ref_encode(jp, jnp.asarray(feats), jcfg)
    flash_attn.flash_fwd_plain.calls = 0
    with torch.no_grad():
        got = ttf.encode(tp, _t(feats), tcfg)
    assert flash_attn.flash_fwd_plain.calls == (
        tcfg.encoder_layers if optimized else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=STACK_ATOL)
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["cross"])
    tl = {k: v[1] for k, v in tp["layers"]["cross"].items()}
    enc = np.asarray(want)
    with jdispatch.use(execute="xla"):
        jk, jv = jattn.cross_attention_kv(jl, jnp.asarray(enc), jcfg)
    tk, tv = tattn.cross_attention_kv(tl, _t(enc), tcfg)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
    for S in (6, 1):
        x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
        with jdispatch.use(execute="xla"):
            jo = jattn.gqa_cross_attention(jl, jnp.asarray(x), (jk, jv),
                                           jcfg)
        flash_attn.flash_fwd_plain.calls = 0
        with torch.no_grad():
            to = tattn.gqa_cross_attention(tl, _t(x), (tk, tv), tcfg)
        assert flash_attn.flash_fwd_plain.calls == int(optimized and S > 1)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)


def _extras(cfg, rng, n, which):
    """Per-request frontend inputs (``which``: "given" or "default")."""
    if which == "default":
        return [None] * n
    if cfg.family == "vlm":
        shape = (1, cfg.frontend.num_tokens, cfg.frontend.feature_dim)
        name = "patch_embeds"
    else:
        shape = (1, SRC, cfg.frontend.feature_dim)
        name = "src_features"
    return [{name: rng.standard_normal(shape).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["internvl2-76b", "seamless-m4t-medium"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("which", ["given", "default"])
def test_engine_matches_reference(arch, layout, which):
    """Three requests on two slots, bucketed prefill: the same greedy
    tokens as the JAX engine, the pool whole; paged, a vlm request's
    frontend rows are in its pages and an encdec slot's cross K/V are the
    reference's."""
    jcfg, tcfg, jp, tp = _models(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 13, 9)]
    extras = _extras(jcfg, rng, 3, which)
    common = dict(num_slots=2, max_len=32, block_size=4, temperature=0.0,
                  clock="steps", kv_layout=layout, prefill_chunk=None,
                  src_len=SRC if jcfg.family == "encdec" else 0)
    jeng = JServingEngine(jcfg, JEngineConfig(**common, execute="xla"),
                          params=jp)
    teng = ServingEngine(tcfg, EngineConfig(**common), params=tp,
                         device="cpu")
    jreqs = [JRequest(f"r{i}", p, 6, extras=e)
             for i, (p, e) in enumerate(zip(prompts, extras))]
    treqs = [Request(f"r{i}", p, 6, extras=e)
             for i, (p, e) in enumerate(zip(prompts, extras))]
    # two steps in: the first two requests prefilled and decoding
    for r, q in zip(jreqs, treqs):
        jeng.submit(r)
        teng.submit(q)
    for _ in range(3):
        jeng.step()
        teng.step()
    if layout == "paged":
        assert list(teng._kv_rows) == list(np.asarray(jeng._kv_rows))
        for k in teng._state:
            np.testing.assert_allclose(teng._state[k].numpy(),
                                       np.asarray(jeng._state[k]),
                                       atol=ATOL)
    while jeng.step():
        pass
    while teng.step():
        pass
    for q, r in zip(treqs, jreqs):
        assert q.outcome == "done"
        assert q.generated == r.generated, (q.rid, q.generated, r.generated)
    teng.pool.check()
    assert teng.pool.num_free == teng.pool.num_blocks
    assert teng.metrics.prefill_kv_write_rows == \
        jeng.metrics.prefill_kv_write_rows
    assert set(teng.gemm_plan) == set(jeng.gemm_plan)


def test_vlm_reservations_cover_the_frontend_rows():
    """Paged, a vlm request's reservation includes its frontend rows (the
    scheduler's token overhead); dense, they are outside the budget."""
    cfg = tget_arch("internvl2-76b").reduced()
    n_img = cfg.frontend.num_tokens
    paged = ServingEngine(cfg, EngineConfig(max_len=32, block_size=4,
                                            kv_layout="paged"), device="cpu")
    dense = ServingEngine(cfg, EngineConfig(max_len=32, block_size=4,
                                            kv_layout="dense"), device="cpu")
    jpaged = JServingEngine(get_arch("internvl2-76b").reduced(),
                            JEngineConfig(max_len=32, block_size=4,
                                          kv_layout="paged"))
    assert paged.sched.token_overhead == n_img == \
        jpaged.sched.token_overhead
    assert dense.sched.token_overhead == 0
    assert paged.pool.num_blocks == jpaged.pool.num_blocks
    assert dense._cache["layers"].k.shape[2] == 32 + n_img
