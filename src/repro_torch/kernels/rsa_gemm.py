"""RSA GEMM: the reconfigurable-tiling GEMM every model projection runs.

``rsa_gemm_cuda`` launches ``csrc/rsa_gemm.cu`` (replaces
``repro/kernels/rsa_gemm.py::rsa_gemm_pallas``) and counts each launch
that returned no error in ``rsa_gemm_cuda.launches`` (an empty product
launches nothing and counts nothing); ``rsa_gemm_plain`` is its
plain PyTorch version, used for CPU tensors and as the reference the
kernel is held against on the card.  Both compute the residency mode's
rounding, which is part of the function:

  OS: the whole K accumulates in f32 and is cast to the output type once.
  WS, IS: each ``block_k`` chunk of K, ascending, is multiplied in f32,
      cast to the output type and added to the output in the output type
      (``_kernel_psum``).  In f32 this equals OS up to summation order; in
      bf16 it shows whenever K > block_k.

``b`` is either a row-major (K, N) matrix or the transpose of a row-major
(N, K) one (``w.t()``, as the tied unembedding passes ``embed.t()``); the
kernel reads either in place.  Neither version pads: the kernel masks the
ragged edges.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.hw import IS, OS, WS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BLOCK_K = 2048             # the largest block_k the kernel's slabs hold


def rsa_gemm_plain(a: torch.Tensor, b: torch.Tensor, *, block_k: int,
                   mode: int, out_dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """(M, K) @ (K, N) with the mode's rounding, in plain PyTorch."""
    rsa_gemm_plain.calls += 1
    out_dtype = out_dtype or a.dtype
    if mode not in (OS, WS, IS):
        raise ValueError(f"unknown mode {mode}")
    af, bf = a.float(), b.float()
    if mode == OS:
        return (af @ bf).to(out_dtype)
    K = a.shape[1]
    out = None
    for k0 in range(0, max(K, 1), block_k):
        prod = (af[:, k0:k0 + block_k] @ bf[k0:k0 + block_k]).to(out_dtype)
        out = prod if out is None else out + prod
    return out


rsa_gemm_plain.calls = 0


def _b_layout(b: torch.Tensor):
    """(b_trans, leading dim) of B as the kernel reads it, or raise."""
    if b.stride(1) == 1:
        return 0, b.stride(0)
    if b.stride(0) == 1:
        return 1, b.stride(1)     # b is the transpose of a row-major (N, K)
    raise ValueError(f"B must be row-major or the transpose of a row-major "
                     f"matrix, got strides {b.stride()}")


def rsa_gemm_cuda(a: torch.Tensor, b: torch.Tensor, *, block_k: int,
                  mode: int, out_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """Launch the CUDA RSA GEMM on PyTorch's current stream."""
    from repro_torch.kernels import _build
    out_dtype = out_dtype or a.dtype
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("rsa_gemm_cuda needs both operands on one CUDA "
                         "device")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES or \
            out_dtype not in _DTYPES or (a.dtype, out_dtype) == \
            (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtypes {a.dtype} x {b.dtype} -> "
                         f"{out_dtype}")
    if mode not in (OS, WS, IS):
        raise ValueError(f"unknown mode {mode}")
    if block_k % 32 or not 0 < block_k <= MAX_BLOCK_K:
        raise ValueError(f"block_k {block_k} must be a multiple of 32 in "
                         f"(0, {MAX_BLOCK_K}]")
    if a.stride(1) != 1:
        raise ValueError(f"A must be row-major, got strides {a.stride()}")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    b_trans, ldb = _b_layout(b)
    vec = 16 // a.element_size()
    vec_a = int(a.data_ptr() % 16 == 0 and a.stride(0) % vec == 0)
    vec_b = int(b.data_ptr() % 16 == 0 and ldb % vec == 0)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    lib = _build.library("rsa_gemm")
    err = lib.rsa_gemm_launch(
        mode, _DTYPES[a.dtype], _DTYPES[out_dtype], b_trans, a.data_ptr(),
        a.stride(0), b.data_ptr(), ldb, out.data_ptr(), M, N, K, block_k,
        sms, vec_a, vec_b, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, f"rsa_gemm {M}x{K}x{N} mode={mode}")
    rsa_gemm_cuda.launches += 1
    key = (M, K, N, mode)
    rsa_gemm_cuda.launches_by_key[key] = \
        rsa_gemm_cuda.launches_by_key.get(key, 0) + 1
    return out


rsa_gemm_cuda.launches = 0          # kernel launches that returned no error
rsa_gemm_cuda.launches_by_key = {}  # the same, per (M, K, N, mode)
