"""The recurrent blocks of ``repro/models/ssm.py``: RWKV6 (Finch, time mix
and channel mix) and Mamba2 (the SSD scan).

Prefill runs the WKV recurrence as a chunked scan over the whole prompt;
decode is the same scan on one token (a chunk of 1) from the carried
state, so the per-slot state is O(1) in sequence length.  The route is
``cfg.ssm_impl``: ``"pallas"`` (the optimized profile) calls
``kernels/ops.wkv_attention`` -- the hand-written CUDA kernel on the card,
its plain version on the CPU; its backward recomputes through the plain
scan -- and ``"xla"`` runs ``_wkv_chunked``, the reference's einsum scan,
in torch.  On a mesh each rank holds its own rows (the sharded step lays
them out), so the reference's per-shard ``_wkv_pallas_sharded`` is that
one call on each rank.

Dtypes follow the reference step for step: the five token-shift mixes and
every GEMM run in the compute dtype; the log decay ``-exp(clip(dec, -12,
1))`` is exponentiated in the compute dtype, then cast to f32; the WKV
operands and state are f32; the per-head groupnorm runs in f32 with
``var + 64e-5``.

Mamba2 has no Pallas kernel in the reference (its SSD scan is einsums in a
``lax.scan``), so it is plain torch here too, apart from its two GEMMs
(``ssm.in_proj``, ``ssm.out_proj``), which go through the SARA dispatch
layer.  Its f32 islands are the reference's: ``dt``, the log decay, the
scan and its state, the gated RMSNorm.  A chunk is ``min(chunk, S)``
rows, so a decode step is one 1-row chunk.

Under Megatron ``tp`` over a ``model`` axis of m ranks (``parallel/tp.py``,
the training step only) each block computes on this rank's H / m heads,
read from its leaves' shapes (``sharding.tp_use`` says which leaf is a
block, which is used in part, which whole):

- RWKV6's time mix: x enters through one ``copy_in`` before the token
  shift and the five mixes, so the mixes and the decay LoRA-in
  (``w_decay_a``, whole on every rank) carry each rank's heads' share of
  their gradients (their leaves are summed over ``model``); r / k / v /
  g and the decay LoRA-out are column blocks, the WKV scan and group norm
  run on the rank's heads, ``w_o``'s row block goes through
  ``reduce_out``.  The channel mix is an MLP over d_ff: ``w_ck``'s
  columns behind a ``copy_in`` of its mixed input, ``w_cv``'s rows
  through ``reduce_out``; the gate ``w_cr`` is whole, and every rank
  computes it (it gates the summed ``vv``, so no collective is added).
- Mamba2: x through ``copy_in``, then the GEMM over the rank's columns of
  the packed ``w_in`` (its heads' z, x and dt, and all of B and C, which
  every head reads: n_groups = 1); the conv over its x channels and B /
  C; the SSD scan on its heads with B and C whole; the gated RMSNorm's
  mean of squares over all d_inner columns through ``reduce_out`` then
  ``copy_in`` (each rank's columns consume it, so each rank's gradient of
  it is partial and is summed); ``w_out``'s row block through
  ``reduce_out``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.linear_attn import wkv_scan
from repro_torch.models.modules import dense, dense_init, draw_kw, dtype_of
from repro_torch.parallel import tp as tp_mod

Params = Dict[str, Any]


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: the previous token's features.  x: (B, S, d); prev:
    (B, d), the features of the token before x[:, 0]."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _chunk(x: torch.Tensor, lc: int) -> Tuple[torch.Tensor, int, int]:
    """(B, S, ...) -> (B, n, lc, ...) with zero padding; returns (x, n, S)."""
    B, S = x.shape[0], x.shape[1]
    n = -(-S // lc)
    pad = n * lc - S
    if pad:
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
    return x.reshape((B, n, lc) + tuple(x.shape[2:])), n, S


class RWKVState(NamedTuple):
    wkv: torch.Tensor       # (B, H, K, V) f32
    shift_t: torch.Tensor   # (B, d) time-mix shift
    shift_c: torch.Tensor   # (B, d) channel-mix shift


def rwkv_num_heads(cfg: ArchConfig) -> int:
    return cfg.d_model // cfg.ssm.head_dim


def rwkv_heads(blk: Params, cfg: ArchConfig) -> int:
    """The heads a (layer-stacked) RWKV6 block's leaves hold: all of them,
    or this rank's under Megatron ``tp`` (``w_r``'s column block)."""
    return blk["w_r"].shape[-1] // cfg.ssm.head_dim


def init_rwkv_block(gen: torch.Generator, cfg: ArchConfig,
                    lead: Tuple[int, ...] = ()) -> Params:
    """One RWKV6 block's leaves (with ``lead`` stacked in front), the
    reference's shapes and constants, drawn from ``gen``."""
    d, dt = cfg.d_model, cfg.param_dtype
    H, K = rwkv_num_heads(cfg), cfg.ssm.head_dim
    lora = max(32, d // 32)
    kw = dict(dtype=dtype_of(dt), device=gen.device)

    def full(shape, value):
        return torch.full(lead + shape, value, **kw)

    def w(d_in, d_out, scale=None):
        return dense_init(gen, lead + (d_in, d_out), dt, scale=scale)

    out_scale = 1.0 / (d ** 0.5 * (2 * cfg.num_layers) ** 0.5)
    return {
        **{m: full((d,), 0.5) for m in ("mu_r", "mu_k", "mu_v", "mu_w",
                                        "mu_g")},
        "w_r": w(d, d), "w_k": w(d, d), "w_v": w(d, d), "w_g": w(d, d),
        "w_o": w(d, d, out_scale),
        # data-dependent decay LoRA head: d -> lora -> d
        "w_decay_a": w(d, lora),
        "w_decay_b": w(lora, d, 0.01),
        "decay_base": full((d,), -6.0),     # w = exp(-exp(.)) ~ 0.9975
        "bonus_u": full((H, K), 0.0),
        "ln_scale": full((H, K), 1.0),      # per-head groupnorm
        "ln_bias": full((H, K), 0.0),
        # channel mix
        "mu_ck": full((d,), 0.5), "mu_cr": full((d,), 0.5),
        "w_ck": w(d, cfg.d_ff),
        "w_cv": w(cfg.d_ff, d,
                  1.0 / (cfg.d_ff ** 0.5 * (2 * cfg.num_layers) ** 0.5)),
        "w_cr": w(d, d),
    }


def _wkv_chunked(r, k, v, logw, u, state0, lc: int):
    """The reference's chunked einsum scan (``ssm_impl="xla"``).  r, k:
    (B, S, H, K); v: (B, S, H, V); logw: (B, S, H, K); u: (H, K); state0:
    (B, H, K, V).  Returns (out (B, S, H, V), state (B, H, K, V)).  Padded
    rows are zeros (k = 0 adds nothing, logw = 0 keeps the state), as the
    reference's masks make them."""
    B, S, H, K = r.shape
    lc = min(lc, S)
    rc, kc, vc, wc = (_chunk(t, lc)[0].flatten(1, 2)
                      for t in (r, k, v, logw))
    out, state = wkv_scan(rc, kc, vc, wc, u[None], state0, lc)
    return out[:, :S], state


def rwkv_block_apply(params: Params, x: torch.Tensor, cfg: ArchConfig,
                     state: RWKVState) -> Tuple[torch.Tensor, RWKVState]:
    """Full RWKV6 block (time mix + channel mix); the caller adds the
    pre-norm residual.  x: (B, S, d) normalised input.  Returns (y,
    new state)."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S, d = x.shape
    K = cfg.ssm.head_dim
    H = rwkv_heads(params, cfg)
    dl = H * K                       # this rank's columns of d
    tp = tp_mod.local(cfg, dl, d)
    tpc = tp_mod.local(cfg, params["w_ck"].shape[-1], cfg.d_ff)
    x = x.to(cdt)
    xt = tp_mod.copy_in(x, tp)
    xx = _shift(xt, state.shift_t.to(cdt))

    def mix(mu):
        return xt + (xx - xt) * params[mu].to(cdt)

    def proj(h, w, site):
        return dense(h, params[w], None, cdt, site=site)

    r = proj(mix("mu_r"), "w_r", "ssm.r").reshape(B, S, H, K)
    k = proj(mix("mu_k"), "w_k", "ssm.k").reshape(B, S, H, K)
    v = proj(mix("mu_v"), "w_v", "ssm.v").reshape(B, S, H, K)
    g = F.silu(proj(mix("mu_g"), "w_g", "ssm.g"))

    # data-dependent decay (log space, always <= -exp(-12) < 0)
    lora = torch.tanh(proj(mix("mu_w"), "w_decay_a", "ssm.decay_a"))
    dec = proj(lora, "w_decay_b", "ssm.decay_b") + \
        tp_mod.cols(params["decay_base"], dl, tp).to(cdt)
    logw = -torch.exp(torch.clamp(dec, -12.0, 1.0)).float()
    logw = logw.reshape(B, S, H, K)

    wkv_args = (r.float(), k.float(), v.float(), logw,
                tp_mod.rows(params["bonus_u"], H, tp).float(),
                state.wkv.float())
    if cfg.ssm_impl == "pallas":
        out, wkv_state = ops.wkv_attention(*wkv_args,
                                           chunk=min(cfg.ssm.chunk, S))
    else:
        out, wkv_state = _wkv_chunked(*wkv_args, cfg.ssm.chunk)

    # per-head groupnorm
    mu = out.mean(dim=-1, keepdim=True)
    var = out.var(dim=-1, keepdim=True, unbiased=False)
    out = (out - mu) * torch.rsqrt(var + 64e-5)
    out = out * tp_mod.rows(params["ln_scale"], H, tp).float() + \
        tp_mod.rows(params["ln_bias"], H, tp).float()
    out = out.reshape(B, S, dl).to(cdt) * g
    y_time = tp_mod.reduce_out(proj(out, "w_o", "ssm.out"), tp)

    # channel mix, on the residual stream
    xc = x + y_time
    xxc = _shift(xc, state.shift_c.to(cdt))
    xck = tp_mod.copy_in(xc + (xxc - xc) * params["mu_ck"].to(cdt), tpc)
    xcr = xc + (xxc - xc) * params["mu_cr"].to(cdt)
    kk = torch.square(F.relu(proj(xck, "w_ck", "ssm.channel_k")))
    vv = tp_mod.reduce_out(proj(kk, "w_cv", "ssm.channel_v"), tpc)
    rr = torch.sigmoid(proj(xcr, "w_cr", "ssm.channel_r"))
    y = y_time + rr * vv

    new_state = RWKVState(wkv=wkv_state.to(state.wkv.dtype),
                          shift_t=x[:, -1, :].to(state.shift_t.dtype),
                          shift_c=xc[:, -1, :].to(state.shift_c.dtype))
    return y.to(x.dtype), new_state


def init_rwkv_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                    device, lead: Tuple[int, ...] = (),
                    heads: Optional[int] = None) -> RWKVState:
    """A zero state for ``batch`` sequences (``lead`` stacked in front)
    over ``heads`` heads (default all; ``rwkv_heads`` of the block's
    leaves under Megatron ``tp``)."""
    H, K = heads or rwkv_num_heads(cfg), cfg.ssm.head_dim
    return RWKVState(
        wkv=torch.zeros(lead + (batch, H, K, K), dtype=torch.float32,
                        device=device),
        shift_t=torch.zeros(lead + (batch, cfg.d_model), dtype=dtype,
                            device=device),
        shift_c=torch.zeros(lead + (batch, cfg.d_model), dtype=dtype,
                            device=device))


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

class MambaState(NamedTuple):
    ssm: torch.Tensor       # (B, H, P, N) f32
    conv: torch.Tensor      # (B, W - 1, conv_channels)


def mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads H, head dim P, state dim N)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = s.num_heads or d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.state_dim


def mamba_heads(blk: Params, cfg: ArchConfig) -> int:
    """The heads a (layer-stacked) Mamba2 block's leaves hold: all of
    them, or this rank's under Megatron ``tp`` (``w_out``'s row block)."""
    return blk["w_out"].shape[-2] // cfg.ssm.head_dim


def _rank_cols(t: torch.Tensor, spans) -> torch.Tensor:
    """``t``'s last-dim columns of the (start, length) ``spans``, in
    order."""
    return torch.cat([t[..., a:a + n] for a, n in spans], dim=-1)


def init_mamba_block(gen: torch.Generator, cfg: ArchConfig,
                     lead: Tuple[int, ...] = ()) -> Params:
    """One Mamba2 block's leaves (with ``lead`` stacked in front), the
    reference's shapes and constants, drawn from ``gen``."""
    d, dt = cfg.d_model, cfg.param_dtype
    d_inner, H, P, N = mamba_dims(cfg)
    conv_ch = d_inner + 2 * N       # x ++ B ++ C  (n_groups = 1)
    kw = dict(dtype=dtype_of(dt), device=gen.device)
    conv_w = torch.randn(lead + (cfg.ssm.conv_width, conv_ch),
                         **draw_kw(gen)) * 0.1
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=gen.device))
    return {
        "w_in": dense_init(gen, lead + (d, 2 * d_inner + 2 * N + H), dt),
        "conv_w": conv_w.to(kw["dtype"]),
        "conv_b": torch.zeros(lead + (conv_ch,), **kw),
        "A_log": a_log.to(kw["dtype"]).expand(lead + (H,)).clone(),
        "dt_bias": torch.full(lead + (H,), -2.0, **kw),
        "D": torch.ones(lead + (H,), **kw),
        "norm_scale": torch.zeros(lead + (d_inner,), **kw),
        "w_out": dense_init(gen, lead + (d_inner, d), dt,
                            scale=1.0 / (d_inner ** 0.5 *
                                         (2 * cfg.num_layers) ** 0.5)),
    }


def _ssd_step(h, xb, bb, cb, csb, tri):
    """One chunk of the SSD scan, f32: xb (B, lc, H, P) dt-scaled inputs,
    bb / cb (B, lc, N), csb (B, lc, H) the inclusive cumsum of the chunk's
    log decays, h (B, H, P, N) the state at the chunk's start.  Returns
    (the state after it, y (B, lc, H, P))."""
    # inter: y_t = C_t . h decayed through token t (inclusive)
    # saralint: ok[dispatch-escape] SSD recurrence readout against the running state, all activations
    y = torch.einsum("bln,bhpn->blhp", cb, h) * torch.exp(csb)[..., None]
    # intra: y_t += sum_{j<=t} exp(cs_t - cs_j) (C_t . B_j) x_j
    diff = csb[:, :, None] - csb[:, None, :, :]       # (B, t, j, H)
    diff = torch.where(tri[None, :, :, None], diff,
                       torch.full_like(diff, -1e30))
    # saralint: ok[dispatch-escape] intra-chunk C.B interaction, all activations
    G = torch.einsum("btn,bjn->btj", cb, bb)
    M = G[..., None] * torch.exp(diff)                # (B, t, j, H)
    # saralint: ok[dispatch-escape] intra-chunk mix against inputs, all activations
    y = y + torch.einsum("btjh,bjhp->bthp", M, xb)
    # state: h' = exp(asum) h + sum_j exp(asum - cs_j) x_j B_j^T
    asum = csb[:, -1]                                 # (B, H)
    dec = torch.exp(asum[:, None] - csb)              # (B, lc, H)
    h = (torch.exp(asum)[:, :, None, None] * h
         # saralint: ok[dispatch-escape] SSD state update (input x B outer product), all activations
         + torch.einsum("blhp,bln->bhpn", xb * dec[..., None], bb))
    return h, y


def _ssd_chunked(xh, Bm, Cm, loga, state0, lc: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunked SSD scan, f32.  xh (B, S, H, P) dt-scaled
    inputs; Bm, Cm (B, S, N); loga (B, S, H) <= 0; state0 (B, H, P, N).
    Chunks of ``min(lc, S)`` rows; the padded rows of a ragged last chunk
    are masked out of the inputs and decays, as the reference masks them.
    With a gradient to take, each chunk step is checkpointed (recomputed
    in the backward pass), as the reference's ``jax.checkpoint(step)``.
    Returns (y (B, S, H, P), final state)."""
    B, S, H, P = xh.shape
    lc = min(lc, S)
    xc, n, S0 = _chunk(xh, lc)
    bc, cc, ac = (_chunk(t, lc)[0] for t in (Bm, Cm, loga))
    if n * lc != S0:
        valid = (torch.arange(n * lc, device=xh.device) < S0).reshape(
            1, n, lc).to(xc.dtype)
        xc = xc * valid[..., None, None]
        ac = ac * valid[..., None]
    cs = torch.cumsum(ac, dim=2)                      # (B, n, lc, H)
    tri = torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                device=xh.device))
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xh, Bm, Cm, loga, state0))
    h, ys = state0, []
    for i in range(n):
        args = (h, xc[:, i], bc[:, i], cc[:, i], cs[:, i], tri)
        h, y = (checkpoint(_ssd_step, *args, use_reentrant=False) if remat
                else _ssd_step(*args))
        ys.append(y)
    y = torch.stack(ys, 1).reshape(B, n * lc, H, P)[:, :S0]
    return y, h


def mamba_block_apply(params: Params, x: torch.Tensor, cfg: ArchConfig,
                      state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """The Mamba2 block; the caller adds the pre-norm residual.  x (B, S,
    d) normalised input.  Returns (y, new state)."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    d_inner, _, P, N = mamba_dims(cfg)
    W = cfg.ssm.conv_width
    H = mamba_heads(params, cfg)
    di = H * P                       # this rank's columns of d_inner
    tp = tp_mod.local(cfg, di, d_inner)
    x = tp_mod.copy_in(x.to(cdt), tp)
    w_in, conv_w, conv_b = params["w_in"], params["conv_w"], params["conv_b"]
    if tp is not None:
        # the rank's columns of the packed [z | x | B | C | dt], and of the
        # conv's [x | B | C] channels
        lo = tp.rank * di
        w_in = _rank_cols(w_in, ((lo, di), (d_inner + lo, di),
                                 (2 * d_inner, 2 * N),
                                 (2 * d_inner + 2 * N + tp.rank * H, H)))
        conv_w, conv_b = (_rank_cols(t, ((lo, di), (d_inner, 2 * N)))
                          for t in (conv_w, conv_b))

    zxbcdt = dense(x, w_in, None, cdt, site="ssm.in_proj")
    z, xBC, dt_raw = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)

    # causal depthwise conv over (x ++ B ++ C), from the carried rows
    conv_in = torch.cat([state.conv.to(cdt), xBC], dim=1)
    new_conv = conv_in[:, -(W - 1):, :] if W > 1 else state.conv
    wts = conv_w.to(cdt)
    acc = conv_in[:, 0:S, :] * wts[0]
    for i in range(1, W):
        acc = acc + conv_in[:, i:i + S, :] * wts[i]
    xBC = F.silu(acc + conv_b.to(cdt))

    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    dt_h = F.softplus(dt_raw.float() + tp_mod.rows(
        params["dt_bias"], H, tp).float())                         # (B,S,H)
    loga = -torch.exp(tp_mod.rows(params["A_log"], H, tp).float()) * dt_h
    xh = xs.float() * dt_h[..., None]
    y, new_ssm = _ssd_chunked(xh, Bm.float(), Cm.float(), loga,
                              state.ssm.float(), cfg.ssm.chunk)
    y = y + tp_mod.rows(params["D"], H, tp).float()[:, None] * xs.float()
    y = y.reshape(B, S, di).to(cdt)

    # normalized gating (mamba2): rmsnorm(y) * silu(z), the mean over all
    # d_inner columns (every rank's)
    y32 = y.float()
    if tp is None:
        var = y32.square().mean(dim=-1, keepdim=True)
    else:
        var = tp_mod.copy_in(tp_mod.reduce_out(
            y32.square().sum(dim=-1, keepdim=True), tp), tp) / d_inner
    y = (y32 * torch.rsqrt(var + cfg.norm_eps) *
         (1.0 + tp_mod.cols(params["norm_scale"], di, tp).float())).to(cdt)
    y = y * F.silu(z)
    out = tp_mod.reduce_out(
        dense(y, params["w_out"], None, cdt, site="ssm.out_proj"), tp)
    return out.to(x.dtype), MambaState(ssm=new_ssm.to(state.ssm.dtype),
                                       conv=new_conv.to(state.conv.dtype))


def init_mamba_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device, lead: Tuple[int, ...] = (),
                     heads: Optional[int] = None) -> MambaState:
    """A zero state for ``batch`` sequences (``lead`` stacked in front)
    over ``heads`` heads and their conv channels (default all;
    ``mamba_heads`` of the block's leaves under Megatron ``tp``)."""
    _, H, P, N = mamba_dims(cfg)
    H = heads or H
    conv_ch = H * P + 2 * N
    return MambaState(
        ssm=torch.zeros(lead + (batch, H, P, N), dtype=torch.float32,
                        device=device),
        conv=torch.zeros(lead + (batch, cfg.ssm.conv_width - 1, conv_ch),
                         dtype=dtype, device=device))
