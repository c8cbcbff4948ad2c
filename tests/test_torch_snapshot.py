"""Engine snapshot and restore in the port, and across the packages.

- kill and resume: serve part of a trace, snapshot, drop the engine,
  restore into a fresh one and finish; every request's tokens equal the
  uninterrupted run's (and the JAX engine's on the same weights), on the
  page arena (reduced llama3.2-1b, with and without the prefix cache, by
  hand and every N steps through ``snapshot_every``) and on the dense
  slot state (reduced rwkv6) and the dense KV caches of an attention
  family (reduced llama3.2-1b, bucketed prefill) and of the hybrid
  (reduced zamba2: Mamba states and the shared block's K/V), and on the
  page arena of an encdec model (reduced seamless-m4t-medium: bucketed
  prefill, its cross K/V dense per slot, each request's source
  features), greedy;
  with temperature > 0 the saved ``torch.Generator`` state makes the
  resumed samples the uninterrupted run's too;
- a snapshot the JAX engine wrote (paged llama, dense rwkv6, dense llama,
  paged encdec, dense zamba2) restores in the port and ends with the JAX engine's
  greedy tokens, and the port
  writes its leaves under the reference's keys (apart from the sampling
  state: the reference's ``rng_key``, the port's ``rng_state``);
- a bf16 arena comes back bit for bit;
- the refusals: an engine that is not fresh, a config or arch mismatch,
  no directory.

Tolerance: none; tokens and leaves are compared exactly.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.models.api import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.serving import EngineConfig, Request, ServingEngine

PAGED = dict(num_slots=2, max_len=31, block_size=8, temperature=0.0,
             kv_layout="paged", prefill_chunk=8, max_prefills_per_step=2)
DENSE = dict(num_slots=2, max_len=24, temperature=0.0, kv_layout="dense",
             prefill_chunk=None, max_prefills_per_step=2)
SRC = 6
ENCDEC = dict(num_slots=2, max_len=24, block_size=4, temperature=0.0,
              kv_layout="paged", prefill_chunk=None, src_len=SRC,
              max_prefills_per_step=2)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


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


@pytest.fixture(scope="module")
def seamless():
    return _pair("seamless-m4t-medium")


@pytest.fixture(scope="module")
def zamba():
    return _pair("zamba2-7b")


def _reqs(cls, vocab, n=4, gen=6, plen=12, seed=3, shared=0, src_feat=0):
    """``src_feat`` > 0: each request carries (1, SRC, src_feat) source
    features (encdec)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, shared).astype(np.int32)
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, plen).astype(np.int32)
        p[:shared] = head
        extras = ({"src_features": rng.standard_normal(
            (1, SRC, src_feat)).astype(np.float32)} if src_feat else None)
        out.append(cls(f"r{i}", p, gen, extras=extras))
    return out


def _engine(pair, ecfg, **kw):
    _, _, tcfg, tp = pair
    return ServingEngine(tcfg, EngineConfig(**ecfg, **kw), params=tp,
                         device="cpu")


def _jengine(pair, ecfg, **kw):
    jcfg, jp, _, _ = pair
    return JServingEngine(jcfg, JEngineConfig(**ecfg, **kw, execute="xla"),
                          params=jp)


def _drain(eng):
    while eng.step():
        pass


def _kill_and_resume(pair, ecfg, tmp_path, kill_at, reqs_kw=None, **kw):
    """(uninterrupted tokens, resumed tokens, resumed engine)."""
    vocab = pair[2].vocab_size
    reqs_kw = reqs_kw or {}
    base = _engine(pair, ecfg, **kw).run(_reqs(Request, vocab, **reqs_kw))
    victim = _engine(pair, ecfg, **kw)
    for r in _reqs(Request, vocab, **reqs_kw):
        victim.submit(r)
    for _ in range(kill_at):
        victim.step()
    assert victim.snapshot(str(tmp_path)) == kill_at
    # mid-trace on purpose: some lanes admitted, some requests unfinished
    assert any(r.slot >= 0 for r in victim.requests.values())
    assert any(not r.outcome for r in victim.requests.values())
    del victim
    resumed = _engine(pair, ecfg, **kw)
    assert resumed.restore(str(tmp_path)) == kill_at
    _drain(resumed)
    got = {r.rid: np.asarray(r.generated, np.int32)
           for r in resumed.requests.values()}
    assert got and all(r.outcome == "done"
                       for r in resumed.requests.values())
    for rid, toks in got.items():
        np.testing.assert_array_equal(toks, base[rid])
    assert resumed.summary()["engine_restores"] == 1
    assert resumed.req_spans.closed == len(got)
    assert resumed.req_spans.open_requests() == {}
    if resumed.prefix_cache is not None:
        resumed.prefix_cache.clear()
    resumed.pool.check()
    assert resumed.pool.num_free == resumed.pool.num_blocks
    return base, got, resumed


def test_kill_and_resume_paged(llama, tmp_path):
    base, _, _ = _kill_and_resume(llama, PAGED, tmp_path, kill_at=4)
    jout = _jengine(llama, PAGED).run(_reqs(JRequest, 512))
    for rid in jout:
        np.testing.assert_array_equal(base[rid], jout[rid])


def test_kill_and_resume_paged_prefix_cache(llama, tmp_path):
    """Four prompts opening with one 16-token run: the victim's trie,
    pins and shared pages come back, and later admissions still hit."""
    _, _, eng = _kill_and_resume(llama, PAGED, tmp_path, kill_at=3,
                                 reqs_kw=dict(plen=20, shared=16),
                                 prefix_cache=True)
    assert eng.prefix_cache.hits >= 1


def test_restored_prefix_cache_serves_hits(llama, tmp_path):
    ecfg = dict(PAGED, prefix_cache=True)
    shared = np.random.default_rng(11).integers(0, 512, 16).astype(np.int32)
    donor = _engine(llama, ecfg)
    want = donor.run([Request("donor", shared, 5)])["donor"]
    assert donor.prefix_cache.num_entries == 2
    donor.snapshot(str(tmp_path))
    resumed = _engine(llama, ecfg)
    resumed.restore(str(tmp_path))
    assert resumed.prefix_cache.num_entries == 2
    res = resumed.run([Request("again", shared, 5)])
    assert resumed.prefix_cache.hits >= 1
    assert resumed.metrics.cache_hit_tokens >= 15
    np.testing.assert_array_equal(res["again"], want)


def test_kill_and_resume_dense(rwkv, tmp_path):
    base, _, _ = _kill_and_resume(rwkv, DENSE, tmp_path, kill_at=3,
                                  reqs_kw=dict(n=3, gen=5))
    jout = _jengine(rwkv, DENSE).run(_reqs(JRequest, rwkv[0].vocab_size,
                                           n=3, gen=5))
    for rid in jout:
        np.testing.assert_array_equal(base[rid], jout[rid])


def test_kill_and_resume_dense_attention(llama, tmp_path):
    """The dense layout of an attention family: the per-slot KV caches and
    their lengths cross the snapshot in the reference's slot-major
    layout."""
    base, _, _ = _kill_and_resume(llama, DENSE, tmp_path, kill_at=3,
                                  reqs_kw=dict(n=3, gen=5))
    jout = _jengine(llama, DENSE).run(_reqs(JRequest, 512, n=3, gen=5))
    for rid in jout:
        np.testing.assert_array_equal(base[rid], jout[rid])


def test_kill_and_resume_dense_hybrid(zamba, tmp_path):
    """A hybrid engine (reduced zamba2): each slot's Mamba states and its
    shared attention block's K/V rows and lengths (``cache/attn``) cross
    the snapshot in the reference's slot-major layout."""
    base, _, eng = _kill_and_resume(zamba, DENSE, tmp_path, kill_at=3,
                                    reqs_kw=dict(n=3, gen=5))
    assert set(eng._cache) == {"pos", "layers", "attn"}
    jout = _jengine(zamba, DENSE).run(_reqs(JRequest, 512, n=3, gen=5))
    for rid in jout:
        np.testing.assert_array_equal(base[rid], jout[rid])


def test_kill_and_resume_paged_encdec(seamless, tmp_path):
    """A paged encdec engine: the arena, the slots' dense cross K/V and
    each live request's source features come back."""
    feat = seamless[2].frontend.feature_dim
    kw = dict(n=3, gen=5, src_feat=feat)
    base, _, _ = _kill_and_resume(seamless, ENCDEC, tmp_path, kill_at=3,
                                  reqs_kw=kw)
    jout = _jengine(seamless, ENCDEC).run(_reqs(JRequest, 512, **kw))
    for rid in jout:
        np.testing.assert_array_equal(base[rid], jout[rid])


def test_kill_and_resume_sampled(llama, tmp_path):
    """temperature > 0: the saved generator state continues the draws."""
    _kill_and_resume(llama, dict(PAGED, temperature=0.8, top_k=40),
                     tmp_path, kill_at=5)


def test_auto_snapshot_kill_and_resume(llama, tmp_path):
    base = _engine(llama, PAGED).run(_reqs(Request, 512))
    auto = dict(PAGED, snapshot_dir=str(tmp_path), snapshot_every=2)
    victim = _engine(llama, auto)
    for r in _reqs(Request, 512):
        victim.submit(r)
    for _ in range(5):                       # snapshots land at steps 2, 4
        victim.step()
    assert victim.summary()["engine_snapshots"] == 2
    del victim
    resumed = _engine(llama, auto)
    assert resumed.restore() == 4            # the latest one
    _drain(resumed)
    for r in resumed.requests.values():
        assert r.outcome == "done"
        np.testing.assert_array_equal(np.asarray(r.generated, np.int32),
                                      base[r.rid])


def _keys(directory):
    step = sorted(Path(directory).glob("step_*"))[-1]
    m = json.loads((step / "manifest.json").read_text())
    return set(m["keys"]), m["metadata"]


@pytest.mark.parametrize("arch,ecfg,kill", [("llama", PAGED, 4),
                                            ("rwkv", DENSE, 3)])
def test_jax_snapshot_restores_in_port(arch, ecfg, kill, llama, rwkv,
                                       tmp_path):
    pair = {"llama": llama, "rwkv": rwkv}[arch]
    vocab = pair[0].vocab_size
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jeng = _jengine(pair, ecfg)
    for r in _reqs(JRequest, vocab, n=3):
        jeng.submit(r)
    for _ in range(kill):
        jeng.step()
    jeng.snapshot(str(jdir))
    _drain(jeng)
    want = {r.rid: list(r.generated) for r in jeng.requests.values()}

    teng = _engine(pair, ecfg)
    assert teng.restore(str(jdir)) == kill
    _drain(teng)
    got = {r.rid: list(r.generated) for r in teng.requests.values()}
    assert got == want

    # the port writes the reference's keys, its sampling state aside
    port = _engine(pair, ecfg)
    for r in _reqs(Request, vocab, n=3):
        port.submit(r)
    for _ in range(kill):
        port.step()
    port.snapshot(str(tdir))
    (jk, jm), (tk, tm) = _keys(jdir), _keys(tdir)
    assert jk - {"rng_key"} == tk - {"rng_state"}
    assert jm["engine"] == tm["engine"] and jm["pool"] == tm["pool"]
    assert jm["requests"] == tm["requests"]


@pytest.mark.parametrize("arch,ecfg,kill", [("llama", DENSE, 3),
                                            ("seamless", ENCDEC, 3),
                                            ("zamba", DENSE, 3)])
def test_jax_snapshot_restores_in_port_attention_layouts(
        arch, ecfg, kill, llama, seamless, zamba, tmp_path):
    """A JAX snapshot of a dense llama engine (its per-slot KV caches), of
    a paged encdec engine (its cross K/V state, the requests' source
    features) and of a dense hybrid engine (its Mamba states and shared
    attention K/V) restores in the port and ends with the JAX engine's
    tokens; the port writes the same keys, its sampling state aside."""
    pair = {"llama": llama, "seamless": seamless, "zamba": zamba}[arch]
    kw = dict(n=3, gen=5,
              src_feat=pair[2].frontend.feature_dim if arch == "seamless"
              else 0)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jeng = _jengine(pair, ecfg)
    for r in _reqs(JRequest, 512, **kw):
        jeng.submit(r)
    for _ in range(kill):
        jeng.step()
    jeng.snapshot(str(jdir))
    _drain(jeng)
    want = {r.rid: list(r.generated) for r in jeng.requests.values()}
    teng = _engine(pair, ecfg)
    assert teng.restore(str(jdir)) == kill
    _drain(teng)
    assert {r.rid: list(r.generated) for r in teng.requests.values()} == want
    port = _engine(pair, ecfg)
    for r in _reqs(Request, 512, **kw):
        port.submit(r)
    for _ in range(kill):
        port.step()
    port.snapshot(str(tdir))
    (jk, jm), (tk, tm) = _keys(jdir), _keys(tdir)
    assert jk - {"rng_key"} == tk - {"rng_state"}
    assert jm["engine"] == tm["engine"] and jm["pool"] == tm["pool"]


def test_bf16_arena_bit_for_bit(tmp_path):
    cfg = dataclasses.replace(tget_arch("llama3.2-1b").reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    eng = ServingEngine(cfg, EngineConfig(**PAGED), device="cpu")
    for r in _reqs(Request, cfg.vocab_size):
        eng.submit(r)
    for _ in range(4):
        eng.step()
    eng.snapshot(str(tmp_path))
    fresh = ServingEngine(cfg, EngineConfig(**PAGED), params=eng.params,
                          device="cpu")
    fresh.restore(str(tmp_path))
    for name, leaf in eng.arena.leaves.items():
        assert leaf.dtype == torch.bfloat16
        assert torch.equal(leaf.view(torch.int16),
                           fresh.arena.leaves[name].view(torch.int16))
    _drain(eng)
    _drain(fresh)
    for rid, r in eng.requests.items():
        assert fresh.requests[rid].generated == r.generated


def test_restore_refusals(llama, rwkv, tmp_path):
    eng = _engine(llama, PAGED)
    for r in _reqs(Request, 512):
        eng.submit(r)
    eng.step()
    eng.snapshot(str(tmp_path))
    with pytest.raises(ValueError, match="fresh"):
        eng.restore(str(tmp_path))
    with pytest.raises(ValueError, match="max_len"):
        _engine(llama, dict(PAGED, max_len=39)).restore(str(tmp_path))
    with pytest.raises(ValueError, match="prefill_chunk"):
        _engine(llama, dict(PAGED, prefill_chunk=4)).restore(str(tmp_path))
    with pytest.raises(ValueError, match="arch"):
        _engine(rwkv, DENSE).restore(str(tmp_path))
    with pytest.raises(ValueError, match="directory"):
        _engine(llama, PAGED).snapshot()
    with pytest.raises(ValueError, match="directory"):
        _engine(llama, PAGED).restore()
