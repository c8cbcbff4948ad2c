"""The registry's other paged GQA archs against the JAX reference, on the
CPU in f32 at their reduced presets: ``qwen2-moe-a2.7b`` (GQA with q/k/v
biases, MoE with a shared expert), ``gemma-2b`` (MQA, GeGLU, tied),
``deepseek-coder-33b`` and ``command-r-plus-104b`` (GQA).

- Every registered config, and the optimized profile, equals the
  reference's field for field; a JAX-initialised tree of every arch loads
  leaf for leaf through ``checkpoint.params_from_numpy``.
- One ragged chunk-prefill step and one decode step through the paged
  arena: logits and arena rows as the reference's (1e-4 on O(1) logits
  after two layers of f32 GEMMs, 1e-5 on the rows, the trash page aside,
  as in test_torch_model.py).
- The engines, paged with chunked prefill: the same greedy tokens as the
  JAX engine's, every site recorded.
- ``train_adaptnet.DEFAULT_ARCHS`` is the reference's, and so are its
  serving shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.checkpoint.manager import _flatten
from repro.configs import registry as jregistry
from repro.configs.registry import get_arch
from repro.launch import train_adaptnet as JT
from repro.models.api import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import registry as tregistry
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.launch import train_adaptnet as T
from repro_torch.models.api import build_model as tbuild
from repro_torch.serving import EngineConfig, Request, ServingEngine

ARCHS = ("qwen2-moe-a2.7b", "gemma-2b", "deepseek-coder-33b",
         "command-r-plus-104b")
BS, C, W = 4, 5, 4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("arch", sorted(tregistry.REGISTRY))
def test_config_and_checkpoint_match_reference(arch):
    """The config, its reduced preset and its optimized profile equal the
    reference's; the reduced JAX tree loads leaf for leaf, and the port's
    own init has the same leaves."""
    for opt in (False, True):
        assert dataclasses.asdict(tget_arch(arch, optimized=opt)) == \
            dataclasses.asdict(get_arch(arch, optimized=opt))
    assert dataclasses.asdict(tget_arch(arch).reduced()) == \
        dataclasses.asdict(get_arch(arch).reduced())
    cfg = tget_arch(arch).reduced()
    flat = _flatten(jbuild(get_arch(arch).reduced())
                    .init(jax.random.PRNGKey(0)))
    params = params_from_numpy(flat, cfg, "cpu")
    own = tbuild(cfg, device="cpu").init(0)

    def leaves(tree, pre=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(leaves(v, f"{pre}{k}/"))
            else:
                out[pre + k] = v
        return out

    got, mine = leaves(params), leaves(own)
    assert set(got) == set(flat) == set(mine)
    for k, a in flat.items():
        assert np.array_equal(got[k].numpy(), np.asarray(a)), k
        assert mine[k].shape == got[k].shape and \
            mine[k].dtype == got[k].dtype, k


def test_registry_is_the_reference_registry_but_the_hybrid():
    """The port's registry and optimized profile are the reference's,
    the hybrid ``zamba2-7b`` included."""
    assert set(tregistry.REGISTRY) == set(jregistry.REGISTRY)
    assert "zamba2-7b" in tregistry.REGISTRY
    assert tregistry.OPTIMIZED_OVERRIDES == jregistry.OPTIMIZED_OVERRIDES


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg, tcfg = get_arch(request.param).reduced(), \
        tget_arch(request.param).reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    if jcfg.use_bias:
        # the reference draws zero biases; give them values so that the
        # test sees them
        rng = np.random.default_rng(1)
        attn = dict(jparams["layers"]["attn"])
        for b in ("bq", "bk", "bv"):
            attn[b] = jnp.asarray(0.1 * rng.standard_normal(attn[b].shape),
                                  attn[b].dtype)
        jparams = dict(jparams, layers=dict(jparams["layers"], attn=attn))
    return jm, jparams, tm, params_from_numpy(_flatten(jparams), tcfg,
                                              "cpu")


def test_prefill_then_decode_logits_and_arena(models):
    jm, jparams, tm, tparams = models
    cfg = tm.cfg
    rng = np.random.default_rng(0)
    S = 3
    NB = S * W + 1
    tables = np.arange(S * W, dtype=np.int32).reshape(S, W)
    tables[2] = tables[2, 0]                       # dead columns
    kv0 = np.zeros(S, np.int32)
    chunk = np.array([5, 3, 0], np.int32)          # ragged + empty lane
    toks = rng.integers(0, cfg.vocab_size, (S, C)).astype(np.int32)
    with jdispatch.use(execute="xla"):
        ja = jm.init_paged_arena(NB, BS)
        jl, ja = jm.paged_prefill_step(jparams, jnp.asarray(toks), ja,
                                       jnp.asarray(tables), jnp.asarray(kv0),
                                       jnp.asarray(chunk))
    ta = tm.init_paged_arena(NB, BS)
    with torch.no_grad():
        tl, ta = tm.paged_prefill_step(tparams, torch.from_numpy(toks), ta,
                                       torch.from_numpy(tables),
                                       torch.from_numpy(kv0),
                                       torch.from_numpy(chunk))
    live = [0, 1]
    assert np.abs(tl.numpy()[live] - np.asarray(jl)[live]).max() < 1e-4
    for name in ("k", "v"):
        diff = np.abs(ta[name].numpy()[:, :-1] - np.asarray(ja[name])[:, :-1])
        assert diff.max() < 1e-5

    nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    wm = np.array([1, 1, 0], np.int32)
    with jdispatch.use(execute="xla"):
        jd, ja = jm.paged_decode_step(jparams, jnp.asarray(nxt), {}, ja,
                                      jnp.asarray(tables), jnp.asarray(chunk),
                                      jnp.asarray(wm))
    with torch.no_grad():
        td, ta = tm.paged_decode_step(tparams, torch.from_numpy(nxt), ta,
                                      torch.from_numpy(tables),
                                      torch.from_numpy(chunk),
                                      torch.from_numpy(wm))
    assert np.abs(td.numpy()[live] - np.asarray(jd)[live]).max() < 1e-4
    for name in ("k", "v"):
        diff = np.abs(ta[name].numpy()[:, :-1] - np.asarray(ja[name])[:, :-1])
        assert diff.max() < 1e-5


def test_greedy_tokens_match_reference_engine(models):
    """Paged with chunked prefill (chunk 8, pages of 4), three prompts on
    two slots: the same greedy tokens as the JAX engine; every site of the
    arch recorded (the router pinned to the plain product)."""
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 13, 21)]
    common = dict(num_slots=2, max_len=32, block_size=4, prefill_chunk=8,
                  temperature=0.0, clock="steps", kv_layout="paged")
    jeng = JServingEngine(jm.cfg, JEngineConfig(**common, execute="xla"),
                          params=jparams)
    jout = jeng.run([JRequest(f"r{i}", p, 6) for i, p in enumerate(prompts)])
    teng = ServingEngine(tm.cfg, EngineConfig(**common), params=tparams,
                         device="cpu")
    tout = teng.run([Request(f"r{i}", p, 6) for i, p in enumerate(prompts)])
    assert set(tout) == set(jout)
    for rid in jout:
        assert np.array_equal(tout[rid], jout[rid]), (rid, tout[rid],
                                                      jout[rid])
    teng.pool.check()
    assert teng.pool.num_free == teng.pool.num_blocks
    assert set(teng.gemm_plan) == set(jeng.gemm_plan)
    if tm.cfg.moe is not None:
        assert teng.gemm_plan["moe.router"].endswith("@torch")
    assert teng.summary()["decode_steps"] == jeng.summary()["decode_steps"]


def test_default_archs_are_the_references():
    assert T.DEFAULT_ARCHS == JT.DEFAULT_ARCHS
    assert T.serving_gemm_shapes() == JT.serving_gemm_shapes()
