"""Recommender parity: the port's copied tile cost model, SaraDispatcher and
block clamp return exactly the reference's configuration for every GEMM
shape the serving engine runs — the reference's ``engine.gemm_sites``
estimate and the per-site projection shapes — for the reduced preset and
full-width llama3.2-1b at M in {1, 8, 512}; and the site registry records
what ran.
"""

import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.core.sara import SaraDispatcher as JDispatcher
from repro.dispatch.executor import _clamped_blocks as j_clamped
from repro.serving.engine import gemm_sites
from repro_torch import dispatch
from repro_torch.core import tpu_costmodel as tcm
from repro_torch.core.hw import DATAFLOW_NAMES
from repro_torch.core.sara import SaraDispatcher
from repro_torch.dispatch.executor import _clamped_blocks


def _shapes(cfg, m):
    d = cfg.d_model
    sites = [(M, K, N) for _, M, K, N in gemm_sites(cfg, m)]
    sites += [(m, d, cfg.q_dim), (m, d, cfg.kv_dim), (m, cfg.q_dim, d),
              (m, d, cfg.d_ff), (m, cfg.d_ff, d), (m, d, cfg.vocab_size)]
    return sites


def _fields(c):
    return (c.class_id, c.block_m, c.block_n, c.block_k, c.mode)


@pytest.mark.parametrize("preset", ["reduced", "full"])
@pytest.mark.parametrize("m", [1, 8, 512])
def test_recommendation_and_clamp_match_reference(preset, m):
    cfg = get_arch("llama3.2-1b")
    if preset == "reduced":
        cfg = cfg.reduced()
    ours, theirs = SaraDispatcher(), JDispatcher()
    shapes = _shapes(cfg, m)
    for M, K, N in shapes:
        a, b = ours.recommend(M, K, N), theirs.recommend(M, K, N)
        assert _fields(a) == _fields(b), (M, K, N)
        assert _clamped_blocks(a, M, K, N) == j_clamped(b, M, K, N)
        assert ours.source_of(M, K, N) == "oracle"
    batch = SaraDispatcher().recommend_batch(shapes)
    assert [_fields(c) for c in batch] == \
        [_fields(theirs.recommend(*s)) for s in shapes]


def test_cost_model_is_the_reference_copy():
    from repro.core import tpu_costmodel as jtcm
    rng = np.random.default_rng(0)
    M, K, N = (rng.integers(1, 20000, 64) for _ in range(3))
    assert len(tcm.TILE_CONFIGS) == len(jtcm.TILE_CONFIGS)
    assert np.array_equal(tcm.tile_cost_seconds(M, K, N),
                          jtcm.tile_cost_seconds(M, K, N))
    assert np.array_equal(tcm.best_tile_config(M, K, N),
                          jtcm.best_tile_config(M, K, N))


def test_cache_info_counts_hits_and_misses():
    d = SaraDispatcher()
    d.recommend(8, 64, 64)
    d.recommend(8, 64, 64)
    d.recommend_batch([(8, 64, 64), (1, 64, 128), (1, 64, 128)])
    assert d.cache_info() == {"hits": 3, "misses": 2, "size": 2}
    assert d.source_info()["oracle"] == 2
    d.cache_clear()
    assert d.cache_info() == {"hits": 0, "misses": 0, "size": 0}
    # adaptnet mode is ported (tests/test_torch_adaptnet_serving.py); with
    # no net installed it answers from the oracle, as the reference does,
    # and an unknown mode raises
    idle = SaraDispatcher(mode="adaptnet")
    assert idle.recommend(8, 64, 64) == d.recommend(8, 64, 64)
    assert idle.source_of(8, 64, 64) == "oracle"
    with pytest.raises(ValueError):
        SaraDispatcher(mode="pallas")


def test_registry_records_what_ran():
    reg = dispatch.SiteRegistry()
    disp = SaraDispatcher()
    x = torch.randn(2, 3, 64)
    w = torch.randn(64, 96)
    with dispatch.use(disp, registry=reg), reg.scope("prefill_chunk"):
        y = dispatch.gemm(x, w, site="layer.attn.q")
    assert y.shape == (2, 3, 96)
    assert torch.allclose(y, x @ w, atol=1e-4)
    rec = reg.sites("prefill_chunk")["layer.attn.q"]
    cfg = disp.recommend(6, 64, 96)
    assert (rec.m, rec.k, rec.n) == (6, 64, 96)
    assert rec.cfg == cfg
    assert rec.executed() == _clamped_blocks(cfg, 6, 64, 96) + (cfg.mode,)
    assert rec.backend == "torch"                # CPU tensors: plain version
    assert reg.plan("prefill_chunk") == {
        "layer.attn.q": f"bm={rec.block_m} bn={rec.block_n} "
                        f"bk={rec.block_k} {DATAFLOW_NAMES[cfg.mode]} @torch"}
    with pytest.raises(ValueError):
        with dispatch.use(execute="kernel"):
            dispatch.gemm(x, w, site="x")        # CPU tensor under "kernel"
    with pytest.raises(ValueError):
        with dispatch.use(execute="xla"):
            pass


# ---------------------------------------------------------------------------
# expert banks and the deepseek-v3 sites
# ---------------------------------------------------------------------------

def _bank_bound(xe, w):
    """The f32 summation bound of each bank's product, as in
    ``test_torch_rsa_gemm``: K * 2^-24 * (|a| @ |b|)."""
    K = xe.shape[-1]
    return K * 2.0 ** -24 * np.einsum(
        "emk,ekn->emn", np.abs(xe).astype(np.float64),
        np.abs(w).astype(np.float64)) + 1e-30


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bank_gemm_matches_reference_experts(mode):
    """An expert bank through the port's ``dispatch.gemm`` (one bank GEMM
    with the mode forced) against the reference's ``_gemm_experts``: its
    vmap of the RSA Pallas kernel (interpret mode) with the same forced
    mode, and its XLA einsum.  Both sides within the f32 summation bound
    of an f64 product; the executed tile and M = prod(lead) * C agree."""
    import jax.numpy as jnp
    from repro import dispatch as jdispatch
    from repro.core.tpu_costmodel import TPUTileConfig as JTile
    from repro.dispatch import SiteRegistry as JRegistry
    from repro_torch.core.tpu_costmodel import TPUTileConfig

    class Forced:
        """The oracle's blocks with the residency mode forced."""
        def __init__(self, inner, cls):
            self.inner, self.cls = inner, cls

        def recommend(self, m, k, n):
            c = self.inner.recommend(m, k, n)
            return self.cls(c.class_id, c.block_m, c.block_n, c.block_k,
                            mode)

    rng = np.random.default_rng(mode)
    B, E, C, K, N = 2, 3, 5, 200, 72          # ragged K and N, lead dim 2
    x = rng.standard_normal((B, E, C, K)).astype(np.float32)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    ref64 = np.einsum("beck,ekn->becn", x.astype(np.float64),
                      w.astype(np.float64))
    xe = np.moveaxis(x, 1, 0).reshape(E, B * C, K)
    bound = np.moveaxis(_bank_bound(xe, w).reshape(E, B, C, N), 0, 1)

    treg = dispatch.SiteRegistry()
    with dispatch.use(Forced(SaraDispatcher(), TPUTileConfig),
                      registry=treg):
        ours = dispatch.gemm(torch.from_numpy(x), torch.from_numpy(w),
                             site="moe.expert.gate").numpy()
    jreg = JRegistry()
    with jdispatch.use(Forced(JDispatcher(), JTile), execute="pallas",
                       registry=jreg, interpret=True):
        pallas = np.asarray(jdispatch.gemm(jnp.asarray(x), jnp.asarray(w),
                                           site="moe.expert.gate"))
    with jdispatch.use(execute="xla"):
        einsum = np.asarray(jdispatch.gemm(jnp.asarray(x), jnp.asarray(w),
                                           site="moe.expert.gate"))
    assert ours.shape == pallas.shape == (B, E, C, N)
    for got in (ours, pallas, einsum):
        assert (np.abs(got - ref64) <= bound).all()
    t = treg.sites()["moe.expert.gate"]
    j = jreg.sites()["moe.expert.gate"]
    assert (t.m, t.k, t.n) == (j.m, j.k, j.n) == (B * C, K, N)
    assert t.executed() == (j.block_m, j.block_n, j.block_k, j.mode)
    assert t.mode == mode and t.backend == "torch"


def test_bank_gemm_reads_head_bank_views():
    """The MLA head banks are strided views of W_UK / W_UV: the bank GEMM
    reads them in place and equals the einsum the reference's absorption
    stands for."""
    rng = np.random.default_rng(4)
    S, C, H, d, r = 2, 3, 4, 16, 8
    w_uk = torch.from_numpy(rng.standard_normal((r, H * d))
                            .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((S, C, H, d)).astype(np.float32))
    wk = w_uk.reshape(r, H, d).permute(1, 2, 0)          # (H, d, r) view
    assert not wk.is_contiguous()
    out = dispatch.gemm(q.movedim(-2, -3), wk, site="layer.mla.q_absorb")
    want = torch.einsum("schd,rhd->schr", q, w_uk.reshape(r, H, d))
    assert torch.allclose(out.movedim(-3, -2), want, atol=1e-5)


def test_backend_pin_runs_the_plain_product():
    reg = dispatch.SiteRegistry()
    x, w = torch.randn(2, 3, 8), torch.randn(8, 16)
    with dispatch.use(registry=reg):
        y = dispatch.gemm(x, w, site="moe.router", backend="torch")
    assert torch.equal(y, torch.matmul(x, w))
    assert reg.sites()["moe.router"].backend == "torch"
    with pytest.raises(ValueError):
        dispatch.gemm(x, w, site="x", backend="xla")
    with pytest.raises(ValueError):
        dispatch.gemm(torch.randn(2, 5, 8), torch.randn(3, 8, 4), site="x")


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_registry_matches_reference_deepseek(step):
    """One reduced deepseek-v3 prefill or decode step records the same
    (site, M, K, N, executed tile) in both packages, banks included."""
    import jax
    import jax.numpy as jnp
    from repro import dispatch as jdispatch
    from repro.checkpoint.manager import _flatten
    from repro.dispatch import SiteRegistry as JRegistry
    from repro.models.api import build_model as jbuild
    from repro_torch.checkpoint import params_from_numpy
    from repro_torch.configs.registry import get_arch as tget_arch
    from repro_torch.models.api import build_model as tbuild

    torch.set_num_threads(2)
    jcfg = get_arch("deepseek-v3-671b").reduced()
    tcfg = tget_arch("deepseek-v3-671b").reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(_flatten(jparams), tcfg, "cpu")
    S, C, W, bs = 2, 6, 3, 4
    tables = np.arange(S * W, dtype=np.int32).reshape(S, W)
    kv = np.array([0, 2], np.int32)
    rng = np.random.default_rng(0)
    if step == "prefill":
        toks = rng.integers(0, 512, (S, C)).astype(np.int32)
        lens = np.array([6, 4], np.int32)
    else:
        toks = rng.integers(0, 512, (S, 1)).astype(np.int32)
        lens = np.ones(S, np.int32)
    jreg, treg = JRegistry(), dispatch.SiteRegistry()
    with jdispatch.use(JDispatcher(), execute="xla", registry=jreg):
        ja = jm.init_paged_arena(S * W + 1, bs)
        args = [jnp.asarray(a) for a in (toks,)] + [ja] + \
            [jnp.asarray(a) for a in (tables, kv, lens)]
        if step == "prefill":
            jm.paged_prefill_step(jparams, *args)
        else:
            jm.paged_decode_step(jparams, args[0], {}, *args[1:])
    with torch.no_grad(), dispatch.use(SaraDispatcher(), registry=treg):
        ta = tm.init_paged_arena(S * W + 1, bs)
        targs = [torch.from_numpy(toks), ta] + \
            [torch.from_numpy(a) for a in (tables, kv, lens)]
        if step == "prefill":
            tm.paged_prefill_step(tparams, *targs)
        else:
            tm.paged_decode_step(tparams, *targs)

    def key(rec):
        return (rec.m, rec.k, rec.n, rec.block_m, rec.block_n, rec.block_k,
                rec.mode)

    theirs = {s: key(r) for s, r in jreg.sites().items()}
    ours = {s: key(r) for s, r in treg.sites().items()}
    assert ours == theirs
    assert {"moe.expert.gate", "moe.expert.up", "moe.expert.down",
            "layer.mla.q_absorb", "layer.mla.v_mix", "moe.router",
            "layer.mlp.gate"} <= set(ours)


# ---------------------------------------------------------------------------
# the GEMM gradient (training)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tied", [False, True], ids=["w", "embed.T"])
def test_gemm_gradient_matches_pallas_vjp(monkeypatch, tied):
    """dx and dw of a 2-D GEMM through the port's ``_Gemm2d`` against
    ``jax.grad`` through the reference's custom VJP (``_pallas_gemm2d``,
    the RSA Pallas kernel in interpret mode): the same gradients within
    the f32 summation bound of an f64 product, and each gradient GEMM run
    with the reference's own recommended tile, dx as (M, N, K) and dw as
    (K, M, N).  ``tied`` passes w as the transposed view of a row-major
    (N, K) table, as the tied unembedding passes ``embed.T``."""
    import jax
    import jax.numpy as jnp
    from repro import dispatch as jdispatch
    from repro_torch.dispatch import executor

    rng = np.random.default_rng(7)
    M, K, N = 40, 200, 72
    x = rng.standard_normal((2, M // 2, K)).astype(np.float32)
    stored = rng.standard_normal((N, K) if tied else (K, N)).astype(
        np.float32)
    w = stored.T if tied else stored
    dy = np.cos(x.reshape(M, K).astype(np.float64) @ w.astype(np.float64))

    def f(x, w):
        return jnp.sum(jnp.sin(jdispatch.gemm(x, w, site="loss.unembed")))

    with jdispatch.use(JDispatcher(), execute="pallas", interpret=True):
        jx, jw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    ran = []
    real = executor._run
    monkeypatch.setattr(executor, "_run", lambda a, b, tile, *r:
                        ran.append((tuple(a.shape), tile)) or
                        real(a, b, tile, *r))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(stored).requires_grad_(True)
    tw = ts.t() if tied else ts
    with dispatch.use(SaraDispatcher()):
        torch.sin(dispatch.gemm(tx, tw, site="loss.unembed")).sum().backward()
    gw = ts.grad.t() if tied else ts.grad
    # bound: the summed dimension times 2^-24 times |dy| @ |operand|,
    # doubled because each package's dy = cos(y) carries its forward's own
    # f32 rounding of y
    x2 = np.abs(x.reshape(M, K)).astype(np.float64)
    bx = N * 2.0 ** -24 * (np.abs(dy) @ np.abs(w.T)) + 1e-30
    bw = M * 2.0 ** -24 * (x2.T @ np.abs(dy)) + 1e-30
    dx64 = dy @ w.T.astype(np.float64)
    dw64 = x.reshape(M, K).T.astype(np.float64) @ dy
    for got, want, ref, bound in ((tx.grad.numpy().reshape(M, K),
                                   np.asarray(jx).reshape(M, K), dx64, bx),
                                  (gw.numpy(), np.asarray(jw), dw64, bw)):
        assert (np.abs(got - ref) <= 2 * bound).all()
        assert (np.abs(want - ref) <= 2 * bound).all()
    disp = JDispatcher()
    tiles = {shape: tile for shape, tile in ran}
    for shape, (m, k, n) in (((M, K), (M, K, N)), ((M, N), (M, N, K)),
                             ((K, M), (K, M, N))):
        c = disp.recommend(m, k, n)
        assert tiles[shape] == j_clamped(c, m, k, n) + (c.mode,), shape
    assert len(ran) == 3


def test_gemm_gradient_keeps_the_forward_policy():
    """The backward runs on the backend and tiles resolved in the forward,
    even outside the ``dispatch.use`` block, for a 2-D GEMM and a bank
    GEMM alike (its dx and dw are bank products too); the registry
    records the forward site only."""
    reg = dispatch.SiteRegistry()
    x = torch.randn(6, 64, requires_grad=True)
    w = torch.randn(64, 96, requires_grad=True)
    with dispatch.use(registry=reg, execute="torch"), reg.scope("train"):
        y = dispatch.gemm(x, w, site="layer.mlp.up")
    assert reg.records == 1
    with dispatch.use(execute="kernel"):   # would raise on CPU tensors
        y.sum().backward()
    assert torch.allclose(x.grad, torch.ones(6, 96) @ w.detach().t(),
                          atol=1e-4)
    assert torch.allclose(w.grad, x.detach().t() @ torch.ones(6, 96),
                          atol=1e-4)
    assert reg.records == 1 and list(reg.sites("train")) == ["layer.mlp.up"]
    xb = torch.randn(2, 3, 5, 8, requires_grad=True)
    wb = torch.randn(3, 8, 4, requires_grad=True)
    with dispatch.use(registry=reg, execute="torch"), reg.scope("train"):
        yb = dispatch.gemm(xb, wb, site="moe.expert.up")
    with dispatch.use(execute="kernel"):
        yb.sum().backward()
    ones = torch.ones(2, 3, 5, 4)
    assert torch.allclose(xb.grad, ones @ wb.detach().transpose(1, 2),
                          atol=1e-4)
    assert torch.allclose(wb.grad, torch.einsum("becm,becn->emn",
                                                xb.detach(), ones),
                          atol=1e-4)
    assert reg.records == 2 and list(reg.sites("train")) == [
        "layer.mlp.up", "moe.expert.up"]
