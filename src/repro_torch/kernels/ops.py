"""Public wrappers of the hand-written kernels.

Each wrapper runs its CUDA kernel or its plain PyTorch version as the
active dispatch policy resolves for the operands (``dispatch.context``:
``"auto"`` = kernel for CUDA tensors, plain for CPU tensors; pin one with
``dispatch.use(execute="kernel"|"torch")``).  There is no fallback: a CUDA
tensor under ``"kernel"`` launches the kernel or raises.  The kernel
functions count their own launches (``launch_counts``), so a run can show
that it went through the kernels.  Unlike the reference's ``ops``, nothing
here pads operands to block multiples: the kernels mask ragged edges (the
plain flash attention pads, as the reference does).  The two linear
attention scans pad S to a multiple of the chunk with zero rows, as the
reference's wrappers do.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.adaptnetx import (OPERANDS, adaptnetx_cuda,
                                           adaptnetx_plain)
from repro_torch.kernels.flash_attn import (
    flash_dkv_cuda, flash_dkv_plain, flash_dq_cuda, flash_dq_plain,
    flash_fwd_cuda, flash_fwd_plain)
from repro_torch.kernels.linear_attn import (
    linear_attn_cuda, linear_attn_plain, wkv_bshk_cuda, wkv_bshk_plain,
    wkv_scan)
from repro_torch.kernels.paged_attn import (
    merge_softmax_states, paged_decode_lse_plain, paged_decode_plain,
    paged_decode_cuda, paged_decode_lse_cuda, paged_prefill_plain,
    paged_prefill_cuda, paged_prefix_cuda, shared_paged_attention_plain,
    paged_prefix_plain)
from repro_torch.kernels.paged_mla import (
    paged_mla_decode_plain, paged_mla_decode_cuda,
    paged_mla_prefill_plain, paged_mla_prefill_cuda)
from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda, rsa_gemm_plain


def _backend(t: torch.Tensor) -> str:
    from repro_torch.dispatch.context import active
    return active().backend(t)


def rsa_gemm(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
             block_n: int = 128, block_k: int = 256, mode: int = 0,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N), or a bank (E, M, K) @ (E, K, N) in one launch, with
    SARA-configurable tiling; arbitrary shapes.  ``block_m``/``block_n`` do
    not change the result (see ``kernels/rsa_gemm.py``); ``block_k`` and
    ``mode`` do."""
    if _backend(a) == "torch":
        return rsa_gemm_plain(a, b, block_k=block_k, mode=mode,
                              out_dtype=out_dtype)
    return rsa_gemm_cuda(a, b, block_k=block_k, mode=mode,
                         out_dtype=out_dtype)


def paged_attention(q, k_arena, v_arena, tables, lengths, *,
                    logit_cap: float = 0.0) -> torch.Tensor:
    """Paged decode (GQA/MQA): each lane attends only to the KV pages its
    block table names.  q: (S, H, hd) one query token per lane; returns
    (S, H, hd_v); lanes with length 0 yield zeros."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if _backend(q) == "torch":
        return paged_decode_plain(q, k_arena, v_arena, tables, lengths,
                                  scale=scale, logit_cap=logit_cap)
    return paged_decode_cuda(q.contiguous(), k_arena, v_arena, tables,
                             lengths, scale=scale, logit_cap=logit_cap)


def paged_prefill_attention(q, k_arena, v_arena, tables, starts, lengths, *,
                            logit_cap: float = 0.0) -> torch.Tensor:
    """Chunked paged prefill (GQA/MQA): each lane's prompt chunk attends
    causally through its block table to every page written so far,
    including the chunk's own rows.  q: (S, C, H, hd); starts: (S,) int32
    absolute position of chunk row 0; lengths: (S,) int32 valid tokens
    including the chunk.  Returns (S, C, H, hd_v); rows past a lane's
    chunk are garbage the caller discards, lanes of length 0 yield
    zeros."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if _backend(q) == "torch":
        return paged_prefill_plain(
            q, k_arena, v_arena, tables, starts, lengths, scale=scale,
            logit_cap=logit_cap)
    return paged_prefill_cuda(q.contiguous(), k_arena, v_arena, tables,
                              starts, lengths, scale=scale,
                              logit_cap=logit_cap)


def shared_paged_attention(q, k_arena, v_arena, unique_tables, unique_lens,
                           prefix_pages, prefix_lens, *,
                           logit_cap: float = 0.0) -> torch.Tensor:
    """Cascade decode for shared prefixes: each lane attends over its
    shared-prefix rows (``prefix_pages``, read once for every sharing lane)
    and its unique suffix rows (``unique_tables``), as ``paged_attention``
    over the concatenated page lists would.

    q: (S, H, hd) one query token per lane; prefix_pages: (P,) int32 pages
    every sharing lane's table starts with (tail-padded with the last id);
    prefix_lens: (S,) int32 prefix rows lane s attends (0 = not in the
    group); unique_tables: (S, W) int32 each lane's pages past the prefix
    (non-members keep their whole table); unique_lens: (S,) int32 valid
    suffix rows.  Returns (S, H, hd_v); lanes empty in both phases yield
    zeros.  The plain version rebuilds each lane's table and runs one
    softmax (bitwise the plain decode at equal width); the kernels run the
    two phases and merge their softmax states, as the reference's Pallas
    path does."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if _backend(q) == "torch":
        return shared_paged_attention_plain(
            q, k_arena, v_arena, unique_tables, unique_lens, prefix_pages,
            prefix_lens, scale=scale, logit_cap=logit_cap)
    q = q.contiguous()
    o_p, m_p, l_p = paged_prefix_cuda(q, k_arena, v_arena, prefix_pages,
                                      prefix_lens, scale=scale,
                                      logit_cap=logit_cap)
    o_u, m_u, l_u = paged_decode_lse_cuda(q, k_arena, v_arena,
                                          unique_tables, unique_lens,
                                          scale=scale, logit_cap=logit_cap)
    o, _, _ = merge_softmax_states(o_p, m_p, l_p, o_u, m_u, l_u)
    return o.to(q.dtype)


def mla_paged_attention(q_abs, q_rope, ckv_arena, krope_arena, tables,
                        lengths, *, qk_dim: int) -> torch.Tensor:
    """Paged decode for absorbed MLA: attend in the compressed latent space
    through the block table.  q_abs (S, H, r) pre-absorbed queries, q_rope
    (S, H, rd); ckv_arena (NB, bs, r), krope_arena (NB, bs, rd).
    ``qk_dim`` is the full per-head query-key dim (nope + rope) that sets
    the softmax scale.  Returns the latent mix o_lat (S, H, r); lanes of
    length 0 yield zeros."""
    scale = 1.0 / (qk_dim ** 0.5)
    if _backend(q_abs) == "torch":
        return paged_mla_decode_plain(q_abs, q_rope, ckv_arena,
                                      krope_arena, tables, lengths,
                                      scale=scale)
    return paged_mla_decode_cuda(q_abs.contiguous(), q_rope.contiguous(),
                                 ckv_arena, krope_arena, tables, lengths,
                                 scale=scale)


def mla_paged_prefill_attention(q_abs, q_rope, ckv_arena, krope_arena,
                                tables, starts, lengths, *,
                                qk_dim: int) -> torch.Tensor:
    """Chunked paged prefill for absorbed MLA, causal within the chunk;
    shapes as :func:`paged_prefill_attention` with q_abs (S, C, H, r) and
    q_rope (S, C, H, rd).  Returns o_lat (S, C, H, r)."""
    scale = 1.0 / (qk_dim ** 0.5)
    if _backend(q_abs) == "torch":
        return paged_mla_prefill_plain(
            q_abs, q_rope, ckv_arena, krope_arena, tables, starts, lengths,
            scale=scale)
    return paged_mla_prefill_cuda(q_abs.contiguous(), q_rope.contiguous(),
                                  ckv_arena, krope_arena, tables, starts,
                                  lengths, scale=scale)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its two backward kernels, the counterpart of
    the reference's custom VJP (``flash_attention_pallas``).  The forward
    saves (q, k, v, o, lse); the backward computes delta = rowsum(do * o)
    as a torch op, as the reference does outside its kernels, then runs
    dq and dk/dv on the backend the forward ran on."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, backend):
        scale = 1.0 / (q.shape[-1] ** 0.5)
        if backend == "torch":
            o, lse = flash_fwd_plain(q, k, v, causal=causal, scale=scale,
                                     bq=block_q, bk=block_k)
        else:
            o, lse = flash_fwd_cuda(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, block_q, block_k, backend)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, bq, bk, backend = ctx.args
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        if backend == "torch":
            blocks = dict(causal=causal, scale=scale, bq=bq, bk=bk)
            dq = flash_dq_plain(q, k, v, do, lse, delta, **blocks)
            dk, dv = flash_dkv_plain(q, k, v, do, lse, delta, **blocks)
        else:
            dq = flash_dq_cuda(q, k, v, do, lse, delta, causal=causal,
                               scale=scale)
            dk, dv = flash_dkv_cuda(q, k, v, do, lse, delta, causal=causal,
                                    scale=scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """Flash attention with arbitrary Sq/Skv, differentiable (hand-written
    backward kernels).  q: (B, Sq, H, hd); k: (B, Skv, KVH, hd); v: (B,
    Skv, KVH, hd_v) -> (B, Sq, H, hd_v); scale hd**-0.5.  ``block_q`` /
    ``block_k`` are the reference's blocks, clamped to the lengths as
    there: the plain version computes in those blocks, the kernels in
    their own tiles."""
    bq = min(block_q, max(q.shape[1], 1))
    bk = min(block_k, max(k.shape[1], 1))
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, bq, bk,
                                 _backend(q))


def _pad_rows(chunk: int, *ts):
    """Each tensor zero-padded along dim 1 to a multiple of ``chunk``."""
    pad = -ts[0].shape[1] % chunk
    if not pad:
        return ts
    return tuple(torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in ts)


def _wkv_scan_padded(r, k, v, logw, u, state0, chunk: int):
    """The plain chunked scan (``models/ssm.py::_wkv_chunked``'s) on the
    wrapper's operands, S padded to a multiple of ``chunk``: (o in r's
    dtype, final state f32).  Autograd differentiates it."""
    S = r.shape[1]
    rr, kk, vv, ww = (t.float() for t in _pad_rows(chunk, r, k, v, logw))
    o, sf = wkv_scan(rr, kk, vv, ww, u.float()[None], state0.float(), chunk)
    return o[:, :S].to(r.dtype), sf


class _WKV(torch.autograd.Function):
    """The WKV kernel (its plain version for CPU tensors) forward; the
    backward recomputes through the plain chunked scan and differentiates
    that, as the reference's ``custom_vjp`` (``_wkv_vjp_bwd``) re-runs
    ``_wkv_chunked`` under ``jax.vjp``."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0, chunk, backend):
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, logw, u, state0)
        S = r.shape[1]
        rr, kk, vv, ww = _pad_rows(chunk, r, k, v, logw)
        if backend == "torch":
            o, sf = wkv_bshk_plain(rr, kk, vv, ww, u, state0, chunk=chunk)
        else:
            o, sf = wkv_bshk_cuda(*(t.contiguous() for t in (
                rr, kk, vv, ww, u, state0)), chunk=chunk)
        return o[:, :S], sf

    @staticmethod
    def backward(ctx, do, dsf):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = _wkv_scan_padded(*ins, ctx.chunk)
        grads = torch.autograd.grad(outs, ins, (do, dsf), allow_unused=True)
        return (*grads, None, None)


def wkv_attention(r, k, v, logw, u, state0, chunk: int = 64
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 chunked linear attention with carried state, differentiable.
    r, k, logw: (B, S, H, K); v: (B, S, H, V); u: (H, K); state0: (B, H,
    K, V) f32 -> (o (B, S, H, V) in r's dtype, final state (B, H, K, V)
    f32).  S is padded to a multiple of ``chunk`` with zero rows, which
    leave the state as it is.  The forward runs the kernel (or its plain
    version); the gradient recomputes through the plain scan."""
    return _WKV.apply(r, k, v, logw, u, state0, chunk, _backend(r))



def linear_attn(r, k, v, logw, u, chunk: int = 64) -> torch.Tensor:
    """Chunked linear attention from a zero state.  r, k, logw: (BH, S, K);
    v: (BH, S, V); u: (BH, K) -> (BH, S, V) in r's dtype; S is padded to a
    multiple of ``chunk``."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, logw, u)):
        raise NotImplementedError("linear_attn is forward only in the port: "
                                  "no model path takes its gradient")
    S = r.shape[1]
    rr, kk, vv, ww = _pad_rows(chunk, r, k, v, logw)
    if _backend(r) == "torch":
        o = linear_attn_plain(rr, kk, vv, ww, u, chunk=chunk)
    else:
        o = linear_attn_cuda(*(t.contiguous() for t in (rr, kk, vv, ww, u)),
                             chunk=chunk)
    return o[:, :S]


def adaptnetx_recommend(ids, params: Dict[str, torch.Tensor]
                        ) -> torch.Tensor:
    """Fused ADAPTNET queries on a raw-encoding net (``core/adaptnet.py``):
    ids (3,) -> (C,) f32 logits, as the reference's wrapper, or a batch
    (B, 3) -> (B, C).  ``w1, b1, w2, b2`` are cast to f32 as the
    reference's kernel call casts them, and the tables too (a no-op for
    the f32 nets ``core/adaptnet.py`` makes); ids move to the params'
    device.  The argmax is left to the caller."""
    w1 = params["w1"]
    q = torch.as_tensor(ids, device=w1.device)
    if q.shape[-1:] != (3,) or q.dim() > 2:
        raise ValueError(f"ids must be (3,) or (B, 3), got {tuple(q.shape)}")
    q2 = q.reshape(-1, 3).to(torch.int32).contiguous()
    t = [params[k].float().contiguous() for k in OPERANDS]
    fn = adaptnetx_plain if _backend(w1) == "torch" else adaptnetx_cuda
    out = fn(q2, *t)
    return out[0] if q.dim() == 1 else out


def launch_counts() -> Dict[str, int]:
    """Kernel launches, and calls of the plain versions, since the last
    ``reset_counts``."""
    return {"rsa_gemm": rsa_gemm_cuda.launches,
            "paged_decode": paged_decode_cuda.launches,
            "paged_prefill": paged_prefill_cuda.launches,
            "paged_decode_lse": paged_decode_lse_cuda.launches,
            "paged_prefix": paged_prefix_cuda.launches,
            "paged_mla_decode": paged_mla_decode_cuda.launches,
            "paged_mla_prefill": paged_mla_prefill_cuda.launches,
            "flash_fwd": flash_fwd_cuda.launches,
            "flash_dq": flash_dq_cuda.launches,
            "flash_dkv": flash_dkv_cuda.launches,
            "wkv_bshk": wkv_bshk_cuda.launches,
            "linear_attn": linear_attn_cuda.launches,
            "adaptnetx": adaptnetx_cuda.launches,
            "plain_calls": rsa_gemm_plain.calls + paged_decode_plain.calls
            + paged_prefill_plain.calls
            + paged_decode_lse_plain.calls
            + paged_prefix_plain.calls
            + paged_mla_decode_plain.calls
            + paged_mla_prefill_plain.calls
            + flash_fwd_plain.calls + flash_dq_plain.calls
            + flash_dkv_plain.calls + wkv_bshk_plain.calls
            + linear_attn_plain.calls + adaptnetx_plain.calls}


def reset_counts() -> None:
    """Zero every launch and plain-call counter."""
    rsa_gemm_cuda.launches = 0
    rsa_gemm_cuda.launches_by_key = {}
    paged_decode_cuda.launches = 0
    paged_prefill_cuda.launches = 0
    paged_decode_lse_cuda.launches = 0
    paged_prefix_cuda.launches = 0
    paged_mla_decode_cuda.launches = 0
    paged_mla_prefill_cuda.launches = 0
    flash_fwd_cuda.launches = 0
    flash_dq_cuda.launches = 0
    flash_dkv_cuda.launches = 0
    wkv_bshk_cuda.launches = 0
    wkv_bshk_cuda.launches_by_chunk = {}
    linear_attn_cuda.launches = 0
    adaptnetx_cuda.launches = 0
    rsa_gemm_plain.calls = 0
    paged_decode_plain.calls = 0
    paged_prefill_plain.calls = 0
    paged_decode_lse_plain.calls = 0
    paged_prefix_plain.calls = 0
    paged_mla_decode_plain.calls = 0
    paged_mla_prefill_plain.calls = 0
    flash_fwd_plain.calls = 0
    flash_dq_plain.calls = 0
    flash_dkv_plain.calls = 0
    wkv_bshk_plain.calls = 0
    linear_attn_plain.calls = 0
    adaptnetx_plain.calls = 0
