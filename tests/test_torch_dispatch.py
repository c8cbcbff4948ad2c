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
    with pytest.raises(ValueError):
        SaraDispatcher(mode="adaptnet")


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
