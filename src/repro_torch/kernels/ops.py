"""Public wrappers of the hand-written kernels.

Each wrapper runs its CUDA kernel or its plain PyTorch version as the
active dispatch policy resolves for the operands (``dispatch.context``:
``"auto"`` = kernel for CUDA tensors, plain for CPU tensors; pin one with
``dispatch.use(execute="kernel"|"torch")``).  There is no fallback: a CUDA
tensor under ``"kernel"`` launches the kernel or raises.  The kernel
functions count their own launches (``launch_counts``), so a run can show
that it went through the kernels.  Unlike the reference's ``ops``, nothing
here pads operands to block multiples: the kernels mask ragged edges.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.paged_attn import (paged_attention_plain,
                                            paged_decode_cuda,
                                            paged_prefill_attention_plain,
                                            paged_prefill_cuda)
from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda, rsa_gemm_plain


def _backend(t: torch.Tensor) -> str:
    from repro_torch.dispatch.context import active
    return active().backend(t)


def rsa_gemm(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
             block_n: int = 128, block_k: int = 256, mode: int = 0,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) with SARA-configurable tiling; arbitrary shapes.
    ``block_m``/``block_n`` do not change the result (see
    ``kernels/rsa_gemm.py``); ``block_k`` and ``mode`` do."""
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
        return paged_attention_plain(q, k_arena, v_arena, tables, lengths,
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
        return paged_prefill_attention_plain(
            q, k_arena, v_arena, tables, starts, lengths, scale=scale,
            logit_cap=logit_cap)
    return paged_prefill_cuda(q.contiguous(), k_arena, v_arena, tables,
                              starts, lengths, scale=scale,
                              logit_cap=logit_cap)


def launch_counts() -> Dict[str, int]:
    """Kernel launches, and calls of the plain versions, since the last
    ``reset_counts``."""
    return {"rsa_gemm": rsa_gemm_cuda.launches,
            "paged_decode": paged_decode_cuda.launches,
            "paged_prefill": paged_prefill_cuda.launches,
            "plain_calls": rsa_gemm_plain.calls + paged_attention_plain.calls
            + paged_prefill_attention_plain.calls}


def reset_counts() -> None:
    """Zero every launch and plain-call counter."""
    rsa_gemm_cuda.launches = 0
    rsa_gemm_cuda.launches_by_key = {}
    paged_decode_cuda.launches = 0
    paged_prefill_cuda.launches = 0
    rsa_gemm_plain.calls = 0
    paged_attention_plain.calls = 0
    paged_prefill_attention_plain.calls = 0
