"""The GEMM executor: recommendation -> executed kernel.

``gemm(x, w, site=...)`` is the single seam every dense GEMM in the
model stack goes through.  It asks the active dispatcher for the (M, K, N)
tile configuration, clamps the blocks exactly as the reference does
(``repro/dispatch/executor.py::_clamped_blocks``, so the executed tile
equals the reference's), records the executed configuration in the active
``SiteRegistry`` under the current scope, and runs ``kernels/ops.rsa_gemm``
with the blocks and residency mode (OS/WS/IS): the CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors or under
``execute="torch"``.

``w`` may be a transposed view of a row-major (N, K) matrix (the tied
unembedding ``embed.T``); the kernel reads it in place, with no copy.
Expert banks and the gradient GEMMs of the reference's custom VJP are
not in this slice: serving needs neither.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

ALIGN = 128                    # the reference's block clamp granularity


def _round_up(n: int, mult: int) -> int:
    return max(mult, ((int(n) + mult - 1) // mult) * mult)


def _clamped_blocks(cfg, m: int, k: int, n: int) -> Tuple[int, int, int]:
    """Shrink recommended blocks that exceed the 128-aligned operand extent
    (pure padding waste); never grows a block past the recommendation."""
    return (min(cfg.block_m, _round_up(m, ALIGN)),
            min(cfg.block_n, _round_up(n, ALIGN)),
            min(cfg.block_k, _round_up(k, ALIGN)))


def _resolved_tile(policy, m: int, k: int, n: int):
    """(recommended cfg, executed (bm, bn, bk, mode)) for an (m,k,n) GEMM."""
    cfg = policy.dispatcher.recommend(m, k, n)
    return cfg, _clamped_blocks(cfg, m, k, n) + (cfg.mode,)


def gemm(x: torch.Tensor, w: torch.Tensor, *, site: str = "dense",
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Self-adaptive GEMM: (..., M', K) @ (K, N) -> (..., M', N), with
    M = prod of the leading dims.  ``out_dtype`` (default ``x.dtype``)
    lets bf16 operands produce f32 output with f32 accumulation — the
    same arithmetic as casting both operands to f32 first, since a
    product of two bf16 values is exact in f32."""
    from repro_torch.dispatch.context import active
    from repro_torch.kernels import ops

    if w.dim() != 2:
        raise ValueError(f"gemm weight must be 2D, got {tuple(w.shape)}")
    policy = active()
    M = x.numel() // x.shape[-1] if x.dim() > 1 else 1
    K, N = int(x.shape[-1]), int(w.shape[-1])
    if int(w.shape[0]) != K:
        raise ValueError(f"gemm shape mismatch: x {tuple(x.shape)} @ "
                         f"w {tuple(w.shape)}")
    cfg, tile = _resolved_tile(policy, M, K, N)
    backend = policy.backend(x)
    if policy.registry is not None:
        src = getattr(policy.dispatcher, "source_of", None)
        policy.registry.record(site, M, K, N, cfg, *tile, backend,
                               src(M, K, N) if src is not None else "oracle")
    out = ops.rsa_gemm(x.reshape(M, K), w, block_m=tile[0],
                       block_n=tile[1], block_k=tile[2], mode=tile[3],
                       out_dtype=out_dtype)
    return out.reshape(tuple(x.shape[:-1]) + (N,))
