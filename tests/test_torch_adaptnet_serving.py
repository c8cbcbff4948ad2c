"""Adaptnet-mode dispatch and serving: the port's SaraDispatcher, trainer
CLI pieces and engine against the JAX package's.

- A logbucket net trained and saved by the reference loads in the port;
  for every GEMM site of llama3.2-1b, deepseek-v3-671b and rwkv6-1.6b, at
  full and reduced width and at every M of ``DECODE_MS + PREFILL_MS``, the
  port recommends the same class from the same source (exact: the host
  twin ``logits_np`` is the same numpy code on the same arrays).
- ``recommend_batch`` equals scalar ``recommend`` on the net's shapes,
  with the same hit and miss counts, and the reference's batch on all
  (its oracle sweep's tie-break depends on the batch); the cache flushes
  on a mode or params change; shapes past the net's range fall back to
  the oracle; a net saved by the port loads in the reference.
- The engines (reduced llama3.2-1b, paged, chunk 8, both layouts set
  explicitly because "auto" differs): under ``dispatcher_mode="adaptnet"``
  with a net of ``max_dim=256`` the greedy tokens, every (scope, site)'s
  executed tile and source, and the ``rec_*`` counts equal the JAX
  engine's; under a low ``defrag_threshold`` the tokens and the defrag
  counts do.
- Path A (``launch/selfadaptive_gemm.py``) at a small size: each layer's
  ADAPTNETX logits against the reference's Pallas kernel (interpret) on
  the same params (1e-5) and the pick against the host twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch as jget_arch
from repro.core import sara as JS
from repro.kernels.adaptnetx import adaptnetx_pallas
from repro.launch import train_adaptnet as JT
from repro.models.api import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.core import sara as S
from repro_torch.core import tpu_costmodel as tcm
from repro_torch.launch import train_adaptnet as T
from repro_torch.serving import EngineConfig, Request, ServingEngine
from repro_torch.serving.engine import gemm_sites

ARCHS = ("llama3.2-1b", "deepseek-v3-671b", "rwkv6-1.6b")
NET_MAX_DIM = 1 << 14        # lm_head columns (vocab > 2^14) fall back


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ref_net(tmp_path_factory):
    """A small logbucket net trained and saved by the reference."""
    shapes = JT.serving_gemm_shapes(ARCHS)
    params, info = JT.train_serving_adaptnet(
        8000, 2, shapes=shapes, max_dim=NET_MAX_DIM, num_buckets=64,
        site_frac=0.5, seed=0, log=False)
    out = str(tmp_path_factory.mktemp("ref_adaptnet"))
    JT.save_adaptnet(out, params, info)
    return out, info


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_gemm_shapes_match_reference(arch, reduced):
    ours = T.serving_gemm_shapes((arch,), reduced=reduced)
    assert ours == JT.serving_gemm_shapes((arch,), reduced=reduced) and ours


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatcher_recommends_as_reference(ref_net, arch, reduced):
    out, info = ref_net
    ours = S.SaraDispatcher.from_checkpoint(out)
    theirs = JS.SaraDispatcher.from_checkpoint(out)
    assert ours.mode == "adaptnet" and "bucket_edges" in ours.adaptnet_params
    params, meta = S.load_adaptnet(out)
    assert meta == info
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    sources = set()
    for m in T.DECODE_MS + T.PREFILL_MS:
        for _, M, K, N in gemm_sites(cfg, m):
            a, b = ours.recommend(M, K, N), theirs.recommend(M, K, N)
            assert a.class_id == b.class_id, (arch, M, K, N)
            src = ours.source_of(M, K, N)
            assert src == theirs.source_of(M, K, N)
            assert (src == "oracle_fallback") == (max(M, K, N) >
                                                  NET_MAX_DIM)
            sources.add(src)
    assert ours.source_info() == theirs.source_info()
    assert ours.cache_info() == theirs.cache_info()
    assert "adaptnet" in sources
    if not reduced:
        assert "oracle_fallback" in sources      # the lm_head columns


def test_recommend_batch_equals_scalar(ref_net):
    """One net forward for the batch's in-range shapes picks what the
    scalar calls pick, with the same hit, miss and source counts; every
    pick equals the reference's batch and scalar picks.  The batch's
    oracle sweep (the fallback shapes) normalises its grid tie-break over
    the whole batch in both packages (``best_tile_config``'s
    ``grid / grid.max()``), so on a near-tie it may pick another class
    than a scalar call; there the port is held to the reference."""
    out, _ = ref_net
    rng = np.random.default_rng(4)
    shapes = [tuple(int(x) for x in s) for s in np.concatenate([
        rng.integers(1, NET_MAX_DIM + 1, (40, 3)),
        rng.integers(1, 3 * NET_MAX_DIM, (8, 3)),
        [(8, 2048, 128256), (8, 2048, 128256), (64, 2048, 3072)]])]
    shapes += shapes[:5]                       # in-batch duplicates
    scalar = S.SaraDispatcher.from_checkpoint(out)
    batch = S.SaraDispatcher.from_checkpoint(out)
    ref_scalar = JS.SaraDispatcher.from_checkpoint(out)
    ref_batch = JS.SaraDispatcher.from_checkpoint(out)
    want = [scalar.recommend(*s).class_id for s in shapes]
    got = [c.class_id for c in batch.recommend_batch(shapes)]
    assert want == [ref_scalar.recommend(*s).class_id for s in shapes]
    assert got == [c.class_id for c in ref_batch.recommend_batch(shapes)]
    srcs = [batch.source_of(*s) for s in shapes]
    assert srcs == [scalar.source_of(*s) for s in shapes]
    assert srcs.count("adaptnet") >= 40 and "oracle_fallback" in srcs
    for g, w, src in zip(got, want, srcs):
        if src == "adaptnet":
            assert g == w
    assert batch.cache_info() == scalar.cache_info() == \
        ref_batch.cache_info()
    assert batch.source_info() == scalar.source_info() == \
        ref_batch.source_info()
    # a second pass is all hits
    batch.recommend_batch(shapes)
    assert batch.cache_info()["hits"] == scalar.cache_info()["hits"] + \
        len(shapes)


def test_cache_flushes_on_mode_or_params_change(ref_net):
    out, _ = ref_net
    d = S.SaraDispatcher.from_checkpoint(out)
    d.recommend(64, 2048, 8192)
    assert d.cache_info()["size"] == 1 and d.source_info()["adaptnet"] == 1
    d.mode = "oracle"
    assert d.cache_info() == {"hits": 0, "misses": 0, "size": 0}
    d.recommend(64, 2048, 8192)
    assert d.source_of(64, 2048, 8192) == "oracle"
    assert d.source_info() == {"adaptnet": 0, "oracle": 1,
                               "oracle_fallback": 0}
    d.mode = "adaptnet"
    d.recommend(64, 2048, 8192)
    params = dict(d.adaptnet_params)
    d.adaptnet_params = params              # a new object flushes
    assert d.cache_info()["size"] == 0
    d.recommend(64, 2048, 8192)
    d.adaptnet_params = params              # the same object does not
    assert d.cache_info()["size"] == 1
    with pytest.raises(ValueError, match="mode"):
        S.SaraDispatcher(mode="pallas")


def test_out_of_range_shapes_fall_back_to_oracle(ref_net):
    out, _ = ref_net
    d = S.SaraDispatcher.from_checkpoint(out)
    oracle = S.SaraDispatcher()
    for shape in ((8, 2048, 128256), (NET_MAX_DIM + 1, 64, 64),
                  (1, NET_MAX_DIM + 1, 1)):
        assert not d.in_trained_range(*shape)
        assert d.recommend(*shape) == oracle.recommend(*shape)
        assert d.source_of(*shape) == "oracle_fallback"
    assert d.in_trained_range(NET_MAX_DIM, 1, NET_MAX_DIM)
    # raw params cover dims up to 10^4 only
    gen = torch.Generator()
    gen.manual_seed(0)
    from repro_torch.core import adaptnet as A
    raw = A.init_params(gen, A.AdaptNetConfig(num_classes=135))
    d = S.SaraDispatcher(mode="adaptnet", adaptnet_params=raw)
    d.recommend(10_000, 10_000, 10_000)
    d.recommend(10_001, 8, 8)
    assert d.source_info() == {"adaptnet": 1, "oracle": 0,
                               "oracle_fallback": 1}
    # an oracle-mode dispatcher never consults the net
    assert not S.SaraDispatcher(mode="oracle",
                                adaptnet_params=raw).in_trained_range(1, 1, 1)


def test_port_saved_net_loads_in_reference(tmp_path):
    """The port's CLI trains and saves; the reference's loader reads the
    same leaves and its dispatcher recommends what the port's does."""
    out = str(tmp_path / "net")
    T.main(["--samples", "3000", "--epochs", "1", "--max-dim", "4096",
            "--buckets", "32", "--out", out, "--device", "cpu", "--quiet"])
    ours, ometa = S.load_adaptnet(out)
    theirs, tmeta = JS.load_adaptnet(out)
    assert ometa == tmeta and set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        assert np.array_equal(ours[k], theirs[k]), k
    a = S.SaraDispatcher.from_checkpoint(out)
    b = JS.SaraDispatcher.from_checkpoint(out)
    for shape in T.serving_gemm_shapes(("llama3.2-1b",), reduced=True):
        assert a.recommend(*shape).class_id == b.recommend(*shape).class_id
        assert a.source_of(*shape) == b.source_of(*shape)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

COMMON = dict(num_slots=2, max_len=32, block_size=4, prefill_chunk=8,
              temperature=0.0, clock="steps", kv_layout="paged")
PROMPTS = (5, 13, 21)
GEN = 6


@pytest.fixture(scope="module")
def llama():
    jcfg = jget_arch("llama3.2-1b").reduced()
    tcfg = get_arch("llama3.2-1b").reduced()
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_numpy(_flatten(jparams), tcfg,
                                                  "cpu")


def _prompts(vocab, lengths=PROMPTS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _serve_both(llama, prompts, **kw):
    jcfg, jparams, tcfg, tparams = llama
    common = dict(COMMON, **kw)
    jeng = JServingEngine(jcfg, JEngineConfig(**common, execute="xla"),
                          params=jparams)
    jout = jeng.run([JRequest(f"r{i}", p, GEN) for i, p in
                     enumerate(prompts)])
    teng = ServingEngine(tcfg, EngineConfig(**common), params=tparams,
                         device="cpu")
    tout = teng.run([Request(f"r{i}", p, GEN) for i, p in
                     enumerate(prompts)])
    assert set(tout) == set(jout)
    for rid in jout:
        assert len(tout[rid]) == GEN
        assert np.array_equal(tout[rid], jout[rid]), (rid, tout[rid],
                                                      jout[rid])
    teng.pool.check()
    assert teng.pool.num_free == teng.pool.num_blocks
    return jeng, teng


def _records(eng):
    return {(scope, name): rec for scope in eng.registry.scopes()
            for name, rec in eng.registry.sites(scope).items()}


@pytest.fixture(scope="module")
def small_net(llama, tmp_path_factory):
    """The reference trains on its oracle engine's executed shapes with
    max_dim 256, as ``tests/test_adaptnet_serving.py`` does: the unembed
    column (N = 512) falls back to the oracle."""
    jcfg, jparams, _, _ = llama
    jeng = JServingEngine(jcfg, JEngineConfig(**COMMON, execute="xla"),
                          params=jparams)
    jeng.run([JRequest(f"r{i}", p, GEN) for i, p in
              enumerate(_prompts(jcfg.vocab_size))])
    shapes = sorted({(r.m, r.k, r.n) for r in _records(jeng).values()})
    params, info = JT.train_serving_adaptnet(
        12_000, 8, shapes=shapes, max_dim=256, num_buckets=64,
        site_frac=0.9, seed=0, log=False)
    out = str(tmp_path_factory.mktemp("adaptnet") / "ckpt")
    JT.save_adaptnet(out, params, info)
    return out


def test_adaptnet_engine_matches_reference_engine(llama, small_net):
    jcfg = llama[0]
    jeng, teng = _serve_both(llama, _prompts(jcfg.vocab_size),
                             dispatcher_mode="adaptnet",
                             adaptnet_dir=small_net)
    assert teng.dispatcher.mode == "adaptnet"
    ours, theirs = _records(teng), _records(jeng)
    assert set(ours) == set(theirs) and ours
    for key, rec in theirs.items():
        assert ours[key].executed() == rec.executed(), key
        assert ours[key].source == rec.source, key
        assert (ours[key].m, ours[key].k, ours[key].n) == \
            (rec.m, rec.k, rec.n), key
    s, js = teng.summary(), jeng.summary()
    for k in ("rec_adaptnet_sites", "rec_oracle_sites", "rec_fallback_sites"):
        assert s[k] == js[k], k
    assert s["rec_adaptnet_sites"] > 0 and s["rec_fallback_sites"] > 0
    assert s["rec_oracle_sites"] == 0
    oob = [k for k, r in ours.items() if max(r.m, r.k, r.n) > 256]
    assert oob and all(ours[k].source == "oracle_fallback" for k in oob)
    assert s["rec_fallback_sites"] == len(oob)
    assert teng.dispatcher.source_info() == jeng.dispatcher.source_info()


def test_adaptnet_mode_requires_checkpoint_dir(llama):
    tcfg = llama[2]
    with pytest.raises(ValueError, match="adaptnet_dir"):
        ServingEngine(tcfg, EngineConfig(**COMMON,
                                         dispatcher_mode="adaptnet"),
                      device="cpu")
    with pytest.raises(ValueError, match="dispatcher_mode"):
        ServingEngine(tcfg, EngineConfig(**COMMON, dispatcher_mode="pallas"),
                      device="cpu")


@pytest.mark.parametrize("threshold", [0.0, -1.0])
def test_auto_defrag_matches_reference_engine(llama, threshold):
    """Prompts that straddle pages on 2 slots leave holes as requests
    retire; a low threshold compacts the pool between steps in both
    engines alike."""
    prompts = _prompts(llama[0].vocab_size, lengths=(9, 14, 11, 6), seed=13)
    jeng, teng = _serve_both(llama, prompts, defrag_threshold=threshold)
    s, js = teng.summary(), jeng.summary()
    assert s["kv_defrag_auto"] == js["kv_defrag_auto"] > 0
    assert s["kv_defrag_block_moves"] == js["kv_defrag_block_moves"]
    assert s["kv_fragmentation"] == js["kv_fragmentation"]
    if threshold < 0:
        assert s["kv_defrag_auto"] == teng.steps


def test_defrag_off_by_default(llama):
    prompts = _prompts(llama[0].vocab_size, lengths=(9, 14, 11, 6), seed=13)
    _, teng = _serve_both(llama, prompts)
    s = teng.summary()
    assert s["kv_defrag_auto"] == 0 and s["kv_defrag_block_moves"] == 0


# ---------------------------------------------------------------------------
# path A: the self-adaptive GEMM loop, small
# ---------------------------------------------------------------------------

def test_selfadaptive_gemm_loop_matches_reference_kernel():
    from repro_torch.launch.selfadaptive_gemm import run
    res = run(n_samples=3000, epochs=1, layers=3, device="cpu", log=False)
    p = {k: jnp.asarray(v.numpy()) for k, v in res["params"].items()}
    assert set(p) == {"emb_m", "emb_k", "emb_n", "w1", "b1", "w2", "b2"}
    assert 0.0 <= res["accuracy"] <= 1.0 and res["geomean_rel_time"] >= 1.0
    assert [r["name"] for r in res["layers"]] == ["G1", "G2", "G3"]
    for r in res["layers"]:
        want = np.asarray(adaptnetx_pallas(
            jnp.asarray(r["ids"].numpy()), p["emb_m"], p["emb_k"],
            p["emb_n"], p["w1"], p["b1"], p["w2"], p["b2"], interpret=True))
        got = r["logits"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        top2 = np.sort(got)[-2:]
        assert r["cid"] == r["host_cid"] or \
            top2[1] - top2[0] <= 2e-5 * (1 + np.abs(got).max())
        assert r["cfg"] == tcm.TILE_CONFIGS[r["cid"]]
        assert r["ms"] is None                 # no device time on the CPU
        a, b = r["a"].double(), r["b"].double()
        np.testing.assert_allclose(r["out"].double().numpy(),
                                   (a @ b).numpy(), rtol=0,
                                   atol=r["K"] * 2 ** -22 *
                                   (a.abs() @ b.abs()).max().item())
