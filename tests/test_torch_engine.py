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
