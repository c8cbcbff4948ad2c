"""RWKV6 (Finch) blocks: time mix and channel mix, the RWKV half of
``repro/models/ssm.py`` (Mamba2 waits for the zamba2 slice).

Prefill runs the WKV recurrence as a chunked scan over the whole prompt;
decode is the same scan on one token (a chunk of 1) from the carried
state, so the per-slot state is O(1) in sequence length.  The route is
``cfg.ssm_impl``: ``"pallas"`` (the optimized profile) calls
``kernels/ops.wkv_attention`` -- the hand-written CUDA kernel on the card,
its plain version on the CPU -- and ``"xla"`` runs ``_wkv_chunked``, the
reference's einsum scan, in torch.  One device has no mesh, so the
reference's per-shard ``_wkv_pallas_sharded`` is that one call.

Dtypes follow the reference step for step: the five token-shift mixes and
every GEMM run in the compute dtype; the log decay ``-exp(clip(dec, -12,
1))`` is exponentiated in the compute dtype, then cast to f32; the WKV
operands and state are f32; the per-head groupnorm runs in f32 with
``var + 64e-5``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.linear_attn import wkv_scan
from repro_torch.models.modules import dense, dense_init, dtype_of

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
    H, K = rwkv_num_heads(cfg), cfg.ssm.head_dim
    x = x.to(cdt)
    xx = _shift(x, state.shift_t.to(cdt))

    def mix(mu):
        return x + (xx - x) * params[mu].to(cdt)

    def proj(h, w, site):
        return dense(h, params[w], None, cdt, site=site)

    r = proj(mix("mu_r"), "w_r", "ssm.r").reshape(B, S, H, K)
    k = proj(mix("mu_k"), "w_k", "ssm.k").reshape(B, S, H, K)
    v = proj(mix("mu_v"), "w_v", "ssm.v").reshape(B, S, H, K)
    g = F.silu(proj(mix("mu_g"), "w_g", "ssm.g"))

    # data-dependent decay (log space, always <= -exp(-12) < 0)
    lora = torch.tanh(proj(mix("mu_w"), "w_decay_a", "ssm.decay_a"))
    dec = proj(lora, "w_decay_b", "ssm.decay_b") + \
        params["decay_base"].to(cdt)
    logw = -torch.exp(torch.clamp(dec, -12.0, 1.0)).float()
    logw = logw.reshape(B, S, H, K)

    wkv_args = (r.float(), k.float(), v.float(), logw,
                params["bonus_u"].float(), state.wkv.float())
    if cfg.ssm_impl == "pallas":
        out, wkv_state = ops.wkv_attention(*wkv_args,
                                           chunk=min(cfg.ssm.chunk, S))
    else:
        out, wkv_state = _wkv_chunked(*wkv_args, cfg.ssm.chunk)

    # per-head groupnorm
    mu = out.mean(dim=-1, keepdim=True)
    var = out.var(dim=-1, keepdim=True, unbiased=False)
    out = (out - mu) * torch.rsqrt(var + 64e-5)
    out = out * params["ln_scale"].float() + params["ln_bias"].float()
    out = out.reshape(B, S, d).to(cdt) * g
    y_time = proj(out, "w_o", "ssm.out")

    # channel mix, on the residual stream
    xc = x + y_time
    xxc = _shift(xc, state.shift_c.to(cdt))
    xck = xc + (xxc - xc) * params["mu_ck"].to(cdt)
    xcr = xc + (xxc - xc) * params["mu_cr"].to(cdt)
    kk = torch.square(F.relu(proj(xck, "w_ck", "ssm.channel_k")))
    vv = proj(kk, "w_cv", "ssm.channel_v")
    rr = torch.sigmoid(proj(xcr, "w_cr", "ssm.channel_r"))
    y = y_time + rr * vv

    new_state = RWKVState(wkv=wkv_state.to(state.wkv.dtype),
                          shift_t=x[:, -1, :].to(state.shift_t.dtype),
                          shift_c=xc[:, -1, :].to(state.shift_c.dtype))
    return y.to(x.dtype), new_state


def init_rwkv_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                    device, lead: Tuple[int, ...] = ()) -> RWKVState:
    """A zero state for ``batch`` sequences (``lead`` stacked in front)."""
    H, K = rwkv_num_heads(cfg), cfg.ssm.head_dim
    return RWKVState(
        wkv=torch.zeros(lead + (batch, H, K, K), dtype=torch.float32,
                        device=device),
        shift_t=torch.zeros(lead + (batch, cfg.d_model), dtype=dtype,
                            device=device),
        shift_c=torch.zeros(lead + (batch, cfg.d_model), dtype=dtype,
                            device=device))
