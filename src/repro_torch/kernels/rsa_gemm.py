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
(N, K) one (``w.t()``, as the tied unembedding passes ``embed.t()``), and
``a`` either a row-major (M, K) matrix or the transpose of a row-major
(K, M) one (the weight gradient ``x.t() @ dy``); the kernel reads each in
place.  Neither version pads: the kernel masks the
ragged edges.

Expert banks: with 3-D operands, a (E, M, K) and b (E, K, N), both
versions compute the E products (E, M, N), each with the 2-D arithmetic
above; the kernel runs the whole bank in one launch (the reference's
``vmap`` of the Pallas kernel over the bank) and counts one launch.  Each
``b[e]`` may be any of the 2-D layouts above, at any bank stride, so the
MLA head banks are read as views of W_UK / W_UV.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.hw import IS, OS, WS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BLOCK_K = 2048             # the largest block_k the kernel's slabs hold
_PLAIN_BANK_ELEMS = 1 << 28    # f32 weight elements one plain bank pass holds


def _plain_product(a, b, block_k: int, mode: int, out_dtype):
    af, bf = a.float(), b.float()
    if mode == OS:
        return (af @ bf).to(out_dtype)
    K = a.shape[-1]
    out = None
    for k0 in range(0, max(K, 1), block_k):
        prod = (af[..., k0:k0 + block_k] @ bf[..., k0:k0 + block_k, :]) \
            .to(out_dtype)
        out = prod if out is None else out + prod
    return out


def rsa_gemm_plain(a: torch.Tensor, b: torch.Tensor, *, block_k: int,
                   mode: int, out_dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """(M, K) @ (K, N), or a bank (E, M, K) @ (E, K, N), with the mode's
    rounding, in plain PyTorch.  A bank runs in groups of banks whose f32
    weights stay below ``_PLAIN_BANK_ELEMS`` elements (a full-width expert
    bank in f32 would be 15 GB)."""
    rsa_gemm_plain.calls += 1
    out_dtype = out_dtype or a.dtype
    if mode not in (OS, WS, IS):
        raise ValueError(f"unknown mode {mode}")
    if a.dim() == 2:
        return _plain_product(a, b, block_k, mode, out_dtype)
    E = a.shape[0]
    per = max(1, _PLAIN_BANK_ELEMS // max(1, b[0].numel()))
    if per >= E:
        return _plain_product(a, b, block_k, mode, out_dtype)
    return torch.cat([_plain_product(a[e:e + per], b[e:e + per], block_k,
                                     mode, out_dtype)
                      for e in range(0, E, per)])


rsa_gemm_plain.calls = 0


def _layout(x: torch.Tensor, name: str):
    """(transposed, leading dim) of a 2-D operand as the kernel reads it,
    or raise."""
    if x.stride(1) == 1:
        return 0, x.stride(0)
    if x.stride(0) == 1:
        return 1, x.stride(1)     # the transpose of a row-major matrix
    raise ValueError(f"{name} must be row-major or the transpose of a "
                     f"row-major matrix, got strides {x.stride()}")


def rsa_gemm_cuda(a: torch.Tensor, b: torch.Tensor, *, block_k: int,
                  mode: int, out_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """Launch the CUDA RSA GEMM on PyTorch's current stream: one 2-D
    product, or one launch for a whole bank (3-D operands)."""
    from repro_torch.kernels import _build
    out_dtype = out_dtype or a.dtype
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("rsa_gemm_cuda needs both operands on one CUDA "
                         "device")
    bank = a.dim() == 3
    if a.dim() not in (2, 3) or b.dim() != a.dim() or \
            a.shape[-1] != b.shape[-2] or (bank and a.shape[0] != b.shape[0]):
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
    E = a.shape[0] if bank else 1
    if E > 65535:
        raise ValueError(f"a bank holds at most 65535 GEMMs, got {E}")
    M, K = a.shape[-2:]
    N = b.shape[-1]
    out = torch.empty(((E,) if bank else ()) + (M, N), dtype=out_dtype,
                      device=a.device)
    if E == 0 or M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    a_trans, lda = _layout(a[0] if bank else a, "A")
    b_trans, ldb = _layout(b[0] if bank else b, "B")
    sa, sb = (a.stride(0), b.stride(0)) if bank else (0, 0)
    vec = 16 // a.element_size()
    vec_a = int(a.data_ptr() % 16 == 0 and lda % vec == 0 and sa % vec == 0)
    vec_b = int(b.data_ptr() % 16 == 0 and ldb % vec == 0 and sb % vec == 0)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    key = ((E,) if bank else ()) + (M, K, N, mode)
    lib = _build.library("rsa_gemm")
    err = lib.rsa_gemm_launch(
        mode, _DTYPES[a.dtype], _DTYPES[out_dtype], a_trans, b_trans,
        a.data_ptr(),
        lda, b.data_ptr(), ldb, out.data_ptr(), M, N, K, block_k,
        sms, vec_a, vec_b, E, sa, sb, M * N,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, f"rsa_gemm {'x'.join(map(str, key[:-1]))} "
                      f"mode={mode}")
    rsa_gemm_cuda.launches += 1
    rsa_gemm_cuda.launches_by_key[key] = \
        rsa_gemm_cuda.launches_by_key.get(key, 0) + 1
    return out


rsa_gemm_cuda.launches = 0          # kernel launches that returned no error
rsa_gemm_cuda.launches_by_key = {}  # the same, per ([E,] M, K, N, mode)
