"""Engine parity: the port's ServingEngine and the reference's serve the
same requests from the same weights (JAX-initialised reduced llama3.2-1b
carried across with ``params_from_numpy``), both with the paged KV layout,
chunked prefill (chunk 8) and greedy decoding on the step clock, and must
emit identical tokens for every request.  The reference is pinned to its
XLA paths (``execute="xla"``, the default paged impl off-TPU); the port
runs its plain versions, as it does for CPU tensors.  Prompts straddle
chunk and page boundaries, and two slots for three requests make the third
wait for a retirement (continuous batching).
"""

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

PROMPTS = (5, 13, 21)
GEN = 6


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid=f"r{i}", prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=GEN) for i, n in enumerate(PROMPTS)]


def test_greedy_tokens_match_reference_engine():
    jcfg = get_arch("llama3.2-1b").reduced()
    tcfg = tget_arch("llama3.2-1b").reduced()
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(_flatten(jparams), tcfg, "cpu")
    common = dict(num_slots=2, max_len=32, block_size=4, prefill_chunk=8,
                  temperature=0.0, clock="steps", kv_layout="paged")

    jeng = JServingEngine(jcfg, JEngineConfig(**common, execute="xla"),
                          params=jparams)
    jout = jeng.run(_requests(JRequest, jcfg.vocab_size))

    teng = ServingEngine(tcfg, EngineConfig(**common), params=tparams,
                         device="cpu")
    tout = teng.run(_requests(Request, tcfg.vocab_size))

    assert set(tout) == set(jout)
    for rid in jout:
        assert len(tout[rid]) == GEN
        assert np.array_equal(tout[rid], jout[rid]), (rid, tout[rid],
                                                      jout[rid])
    # leak-free pool, every request done, the plan recorded every site
    teng.pool.check()
    assert teng.pool.num_free == teng.pool.num_blocks
    assert all(r.outcome == "done" for r in teng.requests.values())
    assert set(teng.gemm_plan) == {
        "layer.attn.q", "layer.attn.k", "layer.attn.v", "layer.attn.out",
        "layer.mlp.gate", "layer.mlp.up", "layer.mlp.down", "unembed"}
    s = teng.summary()
    assert s["completed"] == len(PROMPTS)
    assert s["decode_steps"] == jeng.summary()["decode_steps"]
    assert s["gemm_kernel_sites"] == 0 and s["gemm_torch_sites"] > 0
    assert 0.0 < s["sara_cache_hit_rate"] <= 1.0


@pytest.fixture(scope="module")
def deepseek():
    """Reduced deepseek-v3 (one dense MLA layer, then one MoE layer with 8
    experts padded to 16), JAX-initialised, in both packages."""
    jcfg = get_arch("deepseek-v3-671b").reduced()
    tcfg = tget_arch("deepseek-v3-671b").reduced()
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_numpy(_flatten(jparams), tcfg,
                                                  "cpu")


def _serve_both(deepseek, prompts, **kw):
    jcfg, jparams, tcfg, tparams = deepseek
    common = dict(num_slots=2, max_len=32, block_size=4, prefill_chunk=8,
                  temperature=0.0, clock="steps", kv_layout="paged")
    common.update(kw)
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
    return jeng, teng


def test_greedy_tokens_match_reference_engine_deepseek(deepseek):
    """The MLA + MoE path: the same requests as the llama test, identical
    tokens; every site of both stacks recorded, the router pinned."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in PROMPTS]
    jeng, teng = _serve_both(deepseek, prompts)
    teng.pool.check()
    assert teng.pool.num_free == teng.pool.num_blocks
    assert all(r.outcome == "done" for r in teng.requests.values())
    assert {"layer.mla.q_down", "layer.mla.q_up", "layer.mla.kv_down",
            "layer.mla.q_absorb", "layer.mla.v_mix", "layer.mla.out",
            "layer.mlp.gate", "layer.mlp.up", "layer.mlp.down",
            "moe.router", "moe.expert.gate", "moe.expert.up",
            "moe.expert.down", "moe.shared.gate", "moe.shared.up",
            "moe.shared.down", "unembed"} == set(teng.gemm_plan)
    assert teng.summary()["decode_steps"] == jeng.summary()["decode_steps"]


def test_prefix_cache_matches_reference_engine_deepseek(deepseek):
    """The prefix cache on the latent arena: three identical 16-token
    prompts on one slot hit the trie, resume inside the last shared page
    and copy it on write, as the JAX engine does; cascade decode is refused
    for MLA, as in the reference."""
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 512, 16).astype(np.int32)
    jeng, teng = _serve_both(deepseek, [prompt.copy() for _ in range(3)],
                             num_slots=1, num_blocks=8, prefix_cache=True)
    assert teng.prefix_cache.hits == jeng.prefix_cache.hits == 2
    assert teng.pool.cow_copies == jeng.pool.cow_copies >= 2
    assert teng.metrics.cache_hit_tokens == jeng.metrics.cache_hit_tokens
    teng.prefix_cache.clear()
    teng.pool.check()
    assert teng.pool.num_free == teng.pool.num_blocks
    _, _, tcfg, tparams = deepseek
    with pytest.raises(ValueError, match="GQA-only"):
        ServingEngine(tcfg, EngineConfig(prefix_cache=True,
                                         shared_prefix_decode=True),
                      params=tparams, device="cpu")


@pytest.fixture(scope="module")
def rwkv():
    """Reduced rwkv6 (2 layers, d = 64, f32), JAX-initialised, in both
    packages."""
    jparams = jbuild(get_arch("rwkv6-1.6b").reduced()).init(
        jax.random.PRNGKey(0))
    return jparams, params_from_numpy(
        _flatten(jparams), tget_arch("rwkv6-1.6b").reduced(), "cpu")


@pytest.mark.parametrize("impl,reserve", [("pallas", "full"),
                                          ("xla", "full"),
                                          ("pallas", "incremental")])
def test_greedy_tokens_match_reference_engine_rwkv(rwkv, impl, reserve):
    """The dense slot layout of the recurrent family: exact-length prefill
    per admission and one decode of every slot per step, on both WKV
    routes.  Four requests on two slots; with ``reserve="incremental"``
    and a 10-page pool a lane stalls (its state rolls back to the
    snapshot) and one request is preempted and re-prefilled, in both
    engines alike.  The pool ends whole."""
    jparams, tparams = rwkv
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (5, 13, 21, 9)]
    common = dict(num_slots=2, max_len=32, block_size=4, temperature=0.0,
                  clock="steps", kv_layout="auto", prefill_chunk=None,
                  reserve=reserve,
                  num_blocks=10 if reserve == "incremental" else None)
    jcfg = get_arch("rwkv6-1.6b").reduced().replace(ssm_impl=impl)
    tcfg = tget_arch("rwkv6-1.6b").reduced().replace(ssm_impl=impl)
    jeng = JServingEngine(jcfg, JEngineConfig(**common, execute="xla"),
                          params=jparams)
    jout = jeng.run([JRequest(f"r{i}", p, GEN) for i, p in
                     enumerate(prompts)])
    teng = ServingEngine(tcfg, EngineConfig(**common), params=tparams,
                         device="cpu")
    tout = teng.run([Request(f"r{i}", p, GEN) for i, p in
                     enumerate(prompts)])
    assert teng.kv_layout == "dense"
    assert set(tout) == set(jout)
    for rid in jout:
        assert len(tout[rid]) == GEN
        assert np.array_equal(tout[rid], jout[rid]), (rid, tout[rid],
                                                      jout[rid])
    assert all(r.outcome == "done" for r in teng.requests.values())
    for name in ("stalls", "preemptions", "decode_steps"):
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name)
    if reserve == "incremental":
        assert teng.metrics.stalls > 0 and teng.metrics.preemptions > 0
    teng.pool.check()
    assert teng.pool.num_free == teng.pool.num_blocks
    assert teng.summary()["kv_read_tokens_dense_per_step"] == 0


def test_default_config_picks_layout_and_chunk_by_family(rwkv):
    """``EngineConfig()`` serves each family the way it is ported: the
    attention families paged with 64-token chunks (or the max length,
    when shorter), the recurrent ones dense with whole-prompt prefill."""
    _, tparams = rwkv
    llama = ServingEngine(tget_arch("llama3.2-1b").reduced(),
                          EngineConfig(max_len=96), device="cpu")
    assert (llama.kv_layout, llama.prefill_chunk) == ("paged", 64)
    short = ServingEngine(tget_arch("llama3.2-1b").reduced(),
                          EngineConfig(max_len=40), device="cpu")
    assert short.prefill_chunk == 40
    rw = ServingEngine(tget_arch("rwkv6-1.6b").reduced(), EngineConfig(),
                       params=tparams, device="cpu")
    assert (rw.kv_layout, rw.prefill_chunk) == ("dense", None)
    with pytest.raises(ValueError, match="prefill_chunk must be"):
        ServingEngine(tget_arch("llama3.2-1b").reduced(),
                      EngineConfig(prefill_chunk="whole"), device="cpu")


def test_rwkv_engine_refuses_what_the_reference_refuses(rwkv):
    """A recurrent family cannot page, the dense layout has no chunked
    prefill, and a prefix cache needs chunked prefill, as in the
    reference; an attention family on the dense layout refuses chunked
    prefill, as in the reference."""
    _, tparams = rwkv
    tcfg = tget_arch("rwkv6-1.6b").reduced()
    for kw, match in ((dict(kv_layout="paged", prefill_chunk=8), "dense"),
                      (dict(kv_layout="auto", prefill_chunk=8),
                       "kv_layout='paged'"),
                      (dict(kv_layout="auto", prefill_chunk=None,
                            prefix_cache=True), "prefix_cache")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(tcfg, EngineConfig(**kw), params=tparams,
                          device="cpu")
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        ServingEngine(tget_arch("llama3.2-1b").reduced(),
                      EngineConfig(kv_layout="dense", prefill_chunk=8),
                      device="cpu")
    from repro_torch.models.api import build_model
    with pytest.raises(ValueError, match="paged KV arena"):
        build_model(tcfg, device="cpu").init_paged_arena(4, 4)
