"""Chunked linear attention with a data-dependent decay (the RWKV6 WKV
recurrence): per (batch, head),

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T

with log decays ``logw`` = log w_t <= 0, in the chunked closed form.

``wkv_bshk_cuda`` / ``linear_attn_cuda`` launch the two entry points of
``csrc/linear_attn.cu`` (replacing
``repro/kernels/linear_attn.py::linear_attn_bshk_pallas`` and
``::linear_attn_pallas``); each counts the launches that returned no error
in its ``.launches`` (an empty problem launches nothing and counts
nothing).  ``wkv_bshk_plain`` / ``linear_attn_plain`` are the plain
PyTorch versions, used for CPU tensors and as what the kernels are held
against on the card.  Both repeat the TPU kernels' arithmetic chunk by
chunk (``_kernel_bshk`` and ``_kernel``): with cs the inclusive cumsum of
the chunk's log decays per key column and cs_prev = cs - logw,

    o     = (r * exp(cs_prev)) @ h                        inter-chunk
          + A @ v,  A[t, j] = sum_k r[t,k] k[j,k] exp(cs_prev[t,k] - cs[j,k]), j < t
          + (sum_k r[t,k] u[k] k[t,k]) v[t]               bonus diagonal
    h    <- exp(wsum) h + (k * exp(wsum - cs))^T @ v,     wsum = cs[-1]

every exponent <= 0 (the masked (t, j) pairs are never exponentiated).
The state and all arithmetic are f32; o comes back in r's dtype.

Layouts are the reference's.  ``wkv_bshk_*``: r, k, logw (B, S, H, K), v
(B, S, H, V), u (H, K), state0 (B, H, K, V) f32 -> (o (B, S, H, V), final
state (B, H, K, V) f32).  ``linear_attn_*``: r, k, logw (BH, S, K), v (BH,
S, V), u (BH, K), zero initial state, no state out -> o (BH, S, V).  S must
be a multiple of ``chunk``; ``kernels/ops.py`` pads with zero rows (k = 0
adds nothing, logw = 0 keeps the state).
"""

from __future__ import annotations

from typing import Tuple

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 64                   # the largest K, V and chunk the kernel holds


def wkv_scan(r, k, v, logw, u, h, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan on f32 (B, S, H, K|V) operands with S a multiple of
    ``chunk``, per-(b, h) bonus u (B|1, H, K) and state h (B, H, K, V):
    returns (o f32, final state).  Shared by both plain versions and by
    ``models/ssm.py::_wkv_chunked``; counts nothing."""
    B, S, H, K = r.shape
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    outs = []
    for c0 in range(0, S, chunk):
        rows = slice(c0, c0 + chunk)
        rc, kc, vc, lw = r[:, rows], k[:, rows], v[:, rows], logw[:, rows]
        cs = torch.cumsum(lw, dim=1)                       # (B, lc, H, K)
        cs_prev = cs - lw
        o = torch.einsum("bthk,bhkv->bthv", rc * torch.exp(cs_prev), h)
        diff = cs_prev[:, :, None] - cs[:, None]           # (B, t, j, H, K)
        diff = torch.where(tri[None, :, :, None, None], diff,
                           torch.full_like(diff, -1e30))
        A = torch.einsum("bthk,bjhk,btjhk->bthj", rc, kc, torch.exp(diff))
        o = o + torch.einsum("bthj,bjhv->bthv", A, vc)
        o = o + (rc * u[:, None] * kc).sum(-1, keepdim=True) * vc
        outs.append(o)
        wsum = cs[:, -1]                                   # (B, H, K)
        kdec = kc * torch.exp(wsum[:, None] - cs)
        h = torch.exp(wsum)[..., None] * h + \
            torch.einsum("blhk,blhv->bhkv", kdec, vc)
    return torch.cat(outs, dim=1), h


def wkv_bshk_plain(r, k, v, logw, u, state0, *, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (B, S, H, K) WKV scan with carried state (plain version of
    ``linear_attn_bshk_pallas``).  Returns (o in r's dtype, final state
    f32)."""
    wkv_bshk_plain.calls += 1
    f = [t.float() for t in (r, k, v, logw)]
    o, sf = wkv_scan(*f, u.float()[None], state0.float(), chunk)
    return o.to(r.dtype), sf


wkv_bshk_plain.calls = 0


def linear_attn_plain(r, k, v, logw, u, *, chunk: int) -> torch.Tensor:
    """The (BH, S, K) scan from a zero state, u per row (plain version of
    ``linear_attn_pallas``).  Returns o (BH, S, V) in r's dtype."""
    linear_attn_plain.calls += 1
    BH, K, V = r.shape[0], r.shape[-1], v.shape[-1]
    f = [t.float()[:, :, None] for t in (r, k, v, logw)]
    h0 = torch.zeros((BH, 1, K, V), dtype=torch.float32, device=r.device)
    o, _ = wkv_scan(*f, u.float()[:, None], h0, chunk)
    return o[:, :, 0].to(r.dtype)


linear_attn_plain.calls = 0


def _check(r, k, v, logw, u, chunk: int, state0=None) -> None:
    """Validate what the kernel takes: one CUDA device, f32 or bf16
    operands of one dtype (the state f32), contiguous, S a multiple of a
    chunk in [1, 64], K and V at most 64."""
    ts = (r, k, v, logw, u) + ((state0,) if state0 is not None else ())
    if not all(t.is_cuda and t.device == r.device for t in ts):
        raise ValueError("the WKV kernel needs every tensor on r's CUDA "
                         "device")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype
                                     for t in (k, v, logw, u)):
        raise ValueError(f"unsupported dtypes r {r.dtype}, k {k.dtype}, v "
                         f"{v.dtype}, logw {logw.dtype}, u {u.dtype}")
    if state0 is not None and state0.dtype != torch.float32:
        raise ValueError(f"state0 must be float32, got {state0.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the WKV kernel needs contiguous tensors")
    if k.shape != r.shape or logw.shape != r.shape or \
            v.shape[:-1] != r.shape[:-1]:
        raise ValueError(f"shape mismatch r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}")
    K, V, S = r.shape[-1], v.shape[-1], r.shape[1]
    if not (1 <= K <= MAX_DIM and 1 <= V <= MAX_DIM):
        raise ValueError(f"the WKV kernel holds K, V <= {MAX_DIM}, got K={K}"
                         f" V={V}")
    if not 1 <= chunk <= MAX_DIM or S % chunk:
        raise ValueError(f"chunk must be in [1, {MAX_DIM}] and divide S, got "
                         f"chunk={chunk} S={S}")


def wkv_bshk_cuda(r, k, v, logw, u, state0, *, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, final state) through the CUDA WKV kernel, (B, S, H, K) layout."""
    from repro_torch.kernels import _build
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, K), got {tuple(r.shape)}")
    _check(r, k, v, logw, u, chunk, state0)
    B, S, H, K = r.shape
    V = v.shape[-1]
    if u.shape != (H, K) or state0.shape != (B, H, K, V):
        raise ValueError(f"u {tuple(u.shape)} / state0 "
                         f"{tuple(state0.shape)} do not match "
                         f"(H, K) = {(H, K)}, (B, H, K, V) = {(B, H, K, V)}")
    o = torch.empty(v.shape, dtype=r.dtype, device=r.device)
    if B * H == 0 or S == 0:
        return o, state0.clone()
    sf = torch.empty_like(state0)
    err = _build.library("linear_attn").wkv_bshk_launch(
        _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        logw.data_ptr(), u.data_ptr(), state0.data_ptr(), o.data_ptr(),
        sf.data_ptr(), B, S, H, K, V, chunk,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "WKV scan")
    wkv_bshk_cuda.launches += 1
    wkv_bshk_cuda.launches_by_chunk[chunk] = \
        wkv_bshk_cuda.launches_by_chunk.get(chunk, 0) + 1
    return o, sf


wkv_bshk_cuda.launches = 0           # kernel launches that returned no error
wkv_bshk_cuda.launches_by_chunk = {}  # the same, per chunk (1: decode)


def linear_attn_cuda(r, k, v, logw, u, *, chunk: int) -> torch.Tensor:
    """o through the CUDA kernel, (BH, S, K) layout, zero initial state."""
    from repro_torch.kernels import _build
    if r.dim() != 3:
        raise ValueError(f"r must be (BH, S, K), got {tuple(r.shape)}")
    _check(r, k, v, logw, u, chunk)
    BH, S, K = r.shape
    if u.shape != (BH, K):
        raise ValueError(f"u {tuple(u.shape)} does not match (BH, K) = "
                         f"{(BH, K)}")
    o = torch.empty(v.shape, dtype=r.dtype, device=r.device)
    if BH == 0 or S == 0:
        return o
    err = _build.library("linear_attn").linear_attn_launch(
        _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        logw.data_ptr(), u.data_ptr(), o.data_ptr(), BH, S, K, v.shape[-1],
        chunk, torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "linear attention")
    linear_attn_cuda.launches += 1
    return o


linear_attn_cuda.launches = 0
