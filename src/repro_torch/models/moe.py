"""Mixture-of-Experts feed-forward: the serving half of
``repro/models/moe.py``.

Routing is per row (one batch row: a lane's chunk at prefill, its one
token at decode) and sort-based, in the reference's order of operations:

- the f32 router GEMM, pinned to the plain product (``backend="torch"``,
  the reference's ``backend="xla"``) so the top-k decision does not depend
  on the execution mode; padding experts are set to -1e30 before the
  softmax;
- top-k of the probabilities, renormalised;
- a stable sort of the (token, choice) pairs by expert; pair i of a row
  lands at ``pos = i - searchsorted(se, se, left)`` of its expert and is
  kept when ``pos < C`` (``C = row_capacity``); dropped pairs go to one
  extra discard slot;
- the (B, E_pad, C, d) buffer through the three expert-bank GEMMs
  (``dispatch.gemm`` with a 3-D weight: one bank launch each);
- the combine: each kept pair's row gathered back, scaled by its gate and
  scatter-added onto its token;
- the shared experts, a dense gated MLP on every token, added on top.

Every expert's whole capacity buffer is computed, empty slots included, as
in the reference.  With ``with_aux`` (training) ``moe_apply`` also returns
the reference's aux metrics (:func:`moe_aux`): the Switch load-balance
loss and the router z-loss over the real experts, and the share of
(token, choice) pairs dropped past capacity.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch import dispatch
from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import (activation, dense, dense_init,
                                        dtype_of)
from repro_torch.parallel import tp as tp_mod

Params = Dict[str, Any]


def padded_num_experts(cfg: ArchConfig, ep_axis: int = 16) -> int:
    """Routed experts padded up to a multiple of ``ep_axis`` (the
    reference's expert-parallel axis); the router never picks padding."""
    e = cfg.moe.num_experts
    return int(math.ceil(e / ep_axis) * ep_axis)


def row_capacity(seq: int, cfg: ArchConfig) -> int:
    """Slots per expert for one row of ``seq`` tokens (at least 4)."""
    m = cfg.moe
    cap = int(math.ceil(seq * m.experts_per_token / m.num_experts
                        * m.capacity_factor))
    return max(cap, 4)


def _bank_init(gen: torch.Generator, lead, E: int, d_in: int, d_out: int,
               dt: str, scale=None) -> torch.Tensor:
    """An (*lead, E, d_in, d_out) expert bank drawn one expert at a time:
    ``dense_init`` draws f32, and a full-width bank at once would hold
    ~15 GB of f32 temporaries."""
    w = torch.empty(tuple(lead) + (E, d_in, d_out), dtype=dtype_of(dt),
                    device=gen.device)
    if w.is_meta:                    # Model.init_abstract: nothing to draw
        return w
    flat = w.view((-1, d_in, d_out))
    for i in range(flat.shape[0]):
        flat[i] = dense_init(gen, (d_in, d_out), dt, scale=scale)
    return w


def init_moe(gen: torch.Generator, cfg: ArchConfig, lead=(),
             ep_axis: int = 16) -> Params:
    """``lead`` prepends stacking axes (the layer axis) to every leaf."""
    m = cfg.moe
    dt = cfg.param_dtype
    E = padded_num_experts(cfg, ep_axis)
    d, f = cfg.d_model, m.d_ff_expert
    lead = tuple(lead)
    p = {
        "router": dense_init(gen, lead + (d, E), "float32", scale=0.02),
        "w_gate": _bank_init(gen, lead, E, d, f, dt),
        "w_up": _bank_init(gen, lead, E, d, f, dt),
        "w_down": _bank_init(gen, lead, E, f, d, dt,
                             scale=1.0 / (f ** 0.5 *
                                          (2 * cfg.num_layers) ** 0.5)),
    }
    if m.num_shared_experts > 0:
        fs = f * m.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, lead + (d, fs), dt),
            "w_up": dense_init(gen, lead + (d, fs), dt),
            # f32 whatever param_dtype is, as the reference draws it
            "w_down": dense_init(gen, lead + (fs, d), "float32",
                                 scale=1.0 / (fs ** 0.5 *
                                              (2 * cfg.num_layers) ** 0.5)),
        }
    return p


def router_logits(params: Params, x: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """f32 router logits (B, S, E_pad) of x (B, S, d), padding experts
    set to -1e30."""
    E_pad = params["router"].shape[-1]
    logits = dispatch.gemm(x.float(), params["router"].float(),
                           site="moe.router", backend="torch")
    pad = torch.arange(E_pad, device=x.device) >= cfg.moe.num_experts
    return logits.masked_fill(pad, -1e30)


def router_probs(params: Params, x: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """f32 routing probabilities (B, S, E_pad) of x (B, S, d); padding
    experts get exactly 0."""
    return torch.softmax(router_logits(params, x, cfg), dim=-1)


def gates(probs: torch.Tensor, top_idx: torch.Tensor) -> torch.Tensor:
    """The chosen experts' probabilities, renormalised over the top-k."""
    g = torch.gather(probs, -1, top_idx)
    return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)


def top_k(probs: torch.Tensor, cfg: ArchConfig):
    """(top_idx (B, S, k) int64, gate_vals (B, S, k) f32 renormalised)."""
    top_idx = torch.topk(probs, cfg.moe.experts_per_token, dim=-1).indices
    return top_idx, gates(probs, top_idx)


def route(params: Params, x: torch.Tensor, cfg: ArchConfig):
    """The router's decision for x (B, S, d): (top_idx (B, S, k) int64,
    gate_vals (B, S, k) f32 renormalised)."""
    return top_k(router_probs(params, x, cfg), cfg)


def moe_aux(logits: torch.Tensor, probs: torch.Tensor, top_idx: torch.Tensor,
            keep: torch.Tensor, cfg: ArchConfig,
            batch_sum=None) -> Dict[str, torch.Tensor]:
    """The reference's aux metrics over the real experts E: the Switch
    load-balance loss E * sum_e f_e p_e (f_e the share of tokens whose
    top-1 is e, p_e the mean probability of e), the z-loss mean(logsumexp
    (logits)^2), and the share of (token, choice) pairs dropped past
    capacity.

    ``batch_sum`` (a sharded step whose ranks hold other rows of the
    batch) sums a tensor over those ranks: each metric is then this
    rank's partial term over the global counts, and the terms sum over
    the ranks to the metric of the whole batch (the cross-entropy's
    pattern): f_e from the summed top-1 counts over the global token count
    N (it has no gradient), E * sum_e f_e * (this rank's sum of p_e) / N,
    this rank's sum of logsumexp^2 over N, and its dropped pairs over the
    global pair count.  Capacity is per row, so no drop depends on the
    other ranks' rows."""
    E = cfg.moe.num_experts
    top1 = torch.nn.functional.one_hot(top_idx[..., 0], probs.shape[-1])
    if batch_sum is None:
        me = probs[..., :E].reshape(-1, E).mean(0)
        fe = top1[..., :E].reshape(-1, E).float().mean(0)
        return {"moe_lb_loss": E * (me * fe).sum(),
                "moe_z_loss": torch.logsumexp(logits,
                                              dim=-1).square().mean(),
                "moe_drop_frac": 1.0 - keep.float().mean()}
    dev = probs.device
    p_sum = probs[..., :E].reshape(-1, E).sum(0)
    n = batch_sum(torch.tensor(float(top_idx[..., 0].numel()), device=dev))
    fe = batch_sum(top1[..., :E].reshape(-1, E).float().sum(0)) / n
    pairs = batch_sum(torch.tensor(float(keep.numel()), device=dev))
    return {"moe_lb_loss": E * (fe * p_sum).sum() / n,
            "moe_z_loss": torch.logsumexp(logits,
                                          dim=-1).square().sum() / n,
            "moe_drop_frac": (~keep).float().sum() / pairs}


def dispatch_plan(top_idx: torch.Tensor, E_pad: int, C: int):
    """Sort-based dispatch of each row's (token, choice) pairs, (B, S*k)
    each: dest (slot in the row's flat E_pad*C buffer, E_pad*C when
    dropped), st (source token), order (the stable sort by expert, to
    carry the gates along) and keep (pos < C)."""
    B, S, k = top_idx.shape
    flat_e = top_idx.reshape(B, S * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order).contiguous()
    st = order // k                 # flat pair i is token i // k
    pos = torch.arange(S * k, device=top_idx.device)[None, :] - \
        torch.searchsorted(se, se, side="left")
    keep = pos < C
    dest = torch.where(keep, se * C + pos, torch.full_like(se, E_pad * C))
    return dest, st, order, keep


def moe_apply(params: Params, x: torch.Tensor, cfg: ArchConfig, *,
              with_aux: bool = False, batch_sum=None):
    """x: (B, S, d) -> (B, S, d), or with ``with_aux`` ((B, S, d), the
    aux metrics of :func:`moe_aux`, with its ``batch_sum``).  Without it
    the decision comes from :func:`route` (which a caller may stand in
    for); with it the router's logits are kept for the aux losses.

    Under Megatron ``tp`` the expert banks hold this rank's E_pad / m
    experts (EP over ``model``): the replicated router decides over all
    E_pad experts as on one device, the buffer holds the slots of this
    rank's experts only, and the combine's partial sum goes through
    ``reduce_out`` (with the shared experts' partial sum, where they are
    column / row parallel too).  x and the gates enter the rank's
    experts through ``copy_in``."""
    m = cfg.moe
    cdt = dtype_of(cfg.compute_dtype)
    B, S, d = x.shape
    E_pad = params["router"].shape[-1]
    E_loc = params["w_gate"].shape[-3]
    tp = tp_mod.local(cfg, E_loc, E_pad)
    k = m.experts_per_token
    C = row_capacity(S, cfg)
    dev = x.device

    if with_aux:
        logits = router_logits(params, x, cfg)
        probs = torch.softmax(logits, dim=-1)
        top_idx, gate_vals = top_k(probs, cfg)
    else:
        top_idx, gate_vals = route(params, x, cfg)
    dest, st, order, keep = dispatch_plan(top_idx, E_pad, C)
    sg = torch.gather(gate_vals.reshape(B, S * k), 1, order)
    xe, mine = x, keep
    if tp is not None:
        # this rank's experts' slots; every other pair is dropped here
        lo = tp.rank * E_loc * C
        mine = keep & (dest >= lo) & (dest < lo + E_loc * C)
        dest = torch.where(mine, dest - lo, torch.full_like(dest,
                                                            E_loc * C))
        xe, sg = tp_mod.copy_in(x, tp), tp_mod.copy_in(sg, tp)

    # scatter each kept pair's row into its expert slot; dropped pairs add
    # zero rows to the extra slot at E_loc * C
    slots = E_loc * C + 1
    rows_b = torch.arange(B, device=dev)[:, None]
    src = xe.to(cdt)[rows_b, st] * mine[..., None].to(cdt)     # (B, S*k, d)
    buf = torch.zeros((B * slots, d), dtype=cdt, device=dev)
    buf.index_add_(0, (dest + rows_b * slots).reshape(-1),
                   src.reshape(-1, d))
    buf = buf.view(B, slots, d)[:, :-1].reshape(B, E_loc, C, d)

    act = activation(cfg.mlp_activation)
    g = dispatch.gemm(buf, params["w_gate"].to(cdt), site="moe.expert.gate")
    u = dispatch.gemm(buf, params["w_up"].to(cdt), site="moe.expert.up")
    out_buf = dispatch.gemm(act(g) * u, params["w_down"].to(cdt),
                            site="moe.expert.down")             # (B,E,C,d)

    flat = out_buf.reshape(B, E_loc * C, d)
    gathered = flat[rows_b, torch.clamp(dest, max=E_loc * C - 1)]
    contrib = gathered * (sg * mine)[..., None].to(cdt)
    y = torch.zeros((B * S, d), dtype=cdt, device=dev)
    y.index_add_(0, (st + rows_b * S).reshape(-1), contrib.reshape(-1, d))
    y = y.view(B, S, d)

    if "shared" in params:
        sp = params["shared"]
        tps = tp_mod.local(cfg, sp["w_gate"].shape[-1],
                           m.d_ff_expert * m.num_shared_experts)
        xs = xe if tps is not None and tp is not None else \
            tp_mod.copy_in(x, tps)
        gs = act(dense(xs, sp["w_gate"], None, cdt, site="moe.shared.gate"))
        us = dense(xs, sp["w_up"], None, cdt, site="moe.shared.up")
        ys = dense(gs * us, sp["w_down"], None, cdt, site="moe.shared.down")
        if tps is not None and tp is not None:
            y = tp_mod.reduce_out(y + ys, tp)   # one reduce for both sums
        else:
            y = tp_mod.reduce_out(y, tp) + tp_mod.reduce_out(ys, tps)
    else:
        y = tp_mod.reduce_out(y, tp)
    if with_aux:
        return y.to(x.dtype), moe_aux(logits, probs, top_idx, keep, cfg,
                                      batch_sum)
    return y.to(x.dtype)
