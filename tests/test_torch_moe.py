"""MoE parity: the port's ``moe_apply`` (router, sort-based dispatch, the
three expert-bank GEMMs through ``dispatch.gemm``, combine, shared expert)
against the reference's ``repro.models.moe.moe_apply`` from the same
JAX-initialised weights and the same numpy inputs.

Two cases: the reduced ``deepseek-v3-671b`` config (8 experts padded to
16, top-2, capacity factor 4: no token is dropped) and the same config
with the capacity factor lowered to 0.5 on 24-token rows, where each
expert has 4 slots for an average of 6 claims and the stable sort decides
which claims are dropped.  The top-k expert ids and the kept mask must be
identical (the router is f32 on both sides and pinned to the plain
product), the drop fraction must equal the reference's, and the output
must agree to 1e-5 (f32 GEMMs summed in different orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.configs.registry import get_arch
from repro.models import moe as jmoe
from repro_torch import dispatch
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.models import moe as tmoe

ARCH = "deepseek-v3-671b"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cfgs(capacity_factor=None):
    jcfg, tcfg = get_arch(ARCH).reduced(), tget_arch(ARCH).reduced()
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _reference_routing(params, x, cfg):
    """The reference's routing decision, step for step as in
    ``repro.models.moe.moe_apply``: (top_idx (B, S, k), keep (B, S*k) in
    sorted order)."""
    m = cfg.moe
    E_pad = params["router"].shape[-1]
    B, S, _ = x.shape
    C = jmoe.row_capacity(S, cfg)
    logits = jnp.einsum("bsd,de->bse", x, params["router"])
    logits = jnp.where(jnp.arange(E_pad)[None, None, :] < m.num_experts,
                       logits, -1e30)
    _, top_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                               m.experts_per_token)
    keeps = []
    for b in range(B):
        flat_e = top_idx[b].reshape(-1)
        se = flat_e[jnp.argsort(flat_e, stable=True)]
        pos = jnp.arange(flat_e.shape[0]) - jnp.searchsorted(se, se,
                                                             side="left")
        keeps.append(np.asarray(pos < C))
    return np.asarray(top_idx), np.stack(keeps)


@pytest.mark.parametrize("capacity_factor,B,S", [(None, 3, 5), (0.5, 2, 24)])
def test_moe_apply_matches_reference(capacity_factor, B, S):
    jcfg, tcfg = _cfgs(capacity_factor)
    jp = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)
    tp = _to_torch(jp)
    assert tp["router"].dtype == torch.float32
    assert tuple(tp["w_gate"].shape) == (tmoe.padded_num_experts(tcfg),
                                         tcfg.d_model, tcfg.moe.d_ff_expert)
    assert tmoe.padded_num_experts(tcfg) == 16
    assert tmoe.row_capacity(S, tcfg) == jmoe.row_capacity(S, jcfg)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)

    with jdispatch.use(execute="xla"):
        jy, aux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    j_top, j_keep = _reference_routing(jp, jnp.asarray(x), jcfg)

    reg = dispatch.SiteRegistry()
    with torch.no_grad(), dispatch.use(registry=reg):
        ty = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
        t_top, _ = tmoe.route(tp, torch.from_numpy(x), tcfg)
        _, _, _, t_keep = tmoe.dispatch_plan(
            t_top, tp["router"].shape[-1], tmoe.row_capacity(S, tcfg))

    assert np.array_equal(t_top.numpy(), j_top)
    assert np.array_equal(t_keep.numpy(), j_keep)
    drop = 1.0 - t_keep.float().mean().item()
    assert drop == pytest.approx(float(aux["moe_drop_frac"]), abs=1e-7)
    if capacity_factor is None:
        assert drop == 0.0
    else:
        assert drop > 0.1                      # the case really drops
    assert np.abs(ty.numpy() - np.asarray(jy)).max() < 1e-5
    # the router is pinned to the plain product, the banks are bank GEMMs
    sites = reg.sites()
    assert sites["moe.router"].backend == "torch"
    E_pad, C = 16, tmoe.row_capacity(S, tcfg)
    assert (sites["moe.expert.gate"].m, sites["moe.expert.gate"].k,
            sites["moe.expert.gate"].n) == (B * C, tcfg.d_model,
                                            tcfg.moe.d_ff_expert)
    assert sites["moe.expert.down"].n == tcfg.d_model
    assert {"moe.shared.gate", "moe.shared.up", "moe.shared.down"} <= \
        set(sites)
    assert E_pad == tp["router"].shape[-1]


def test_init_moe_draws_banks_expert_by_expert():
    """Random init on the port's side: shapes, dtypes, and the per-expert
    draws give every expert its own weights."""
    _, tcfg = _cfgs()
    tcfg = tcfg.replace(param_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, tcfg, lead=(2,))
    assert p["router"].dtype == torch.float32
    assert p["w_up"].dtype == torch.bfloat16
    assert tuple(p["w_down"].shape) == (2, 16, tcfg.moe.d_ff_expert,
                                        tcfg.d_model)
    assert not torch.equal(p["w_up"][0, 0], p["w_up"][0, 1])
    assert not torch.equal(p["w_up"][0, 0], p["w_up"][1, 0])
