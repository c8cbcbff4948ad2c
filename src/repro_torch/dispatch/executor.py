"""The GEMM executor: recommendation -> executed kernel.

``gemm(x, w, site=...)`` is the single seam every dense GEMM in the
model stack goes through.  It asks the active dispatcher for the (M, K, N)
tile configuration, clamps the blocks exactly as the reference does
(``repro/dispatch/executor.py::_clamped_blocks``, so the recommended tile
equals the reference's), records it in the active ``SiteRegistry`` under
the current scope, and runs the RSA GEMM with its ``block_k`` and
residency mode (OS/WS/IS), the two inputs the function depends on: the
CUDA kernel for CUDA tensors, the plain PyTorch version for CPU tensors or
under ``execute="torch"``.  The kernel's launch records in the same
``SiteRecord`` the plan it ran (tile, swap, split-K, walk, block_k), so
the registry holds both.

``w`` may be a transposed view of a row-major (N, K) matrix (the tied
unembedding ``embed.T``); the kernel reads it in place, with no copy.

A 2-D GEMM whose operands need a gradient runs through ``_Gemm2d``, the
counterpart of the reference's custom VJP (``_pallas_gemm2d``): its
backward runs dx = dy @ w^T and dw = x^T @ dy through the same RSA GEMM,
each with its own recommended tile, resolved in the forward (as the
reference resolves them at trace time) and kept with the backend, so a
backward that runs outside the ``dispatch.use`` block still follows the
forward's policy.  The registry records the forward site only; what the
backward's two launches ran is added to its record as ``dx`` and ``dw``.

Expert banks (``w`` of shape (E, K, N) against ``x`` (..., E, C, K)) are
recommended at M = rows per bank GEMM and run as ONE bank launch of the
RSA kernel, the counterpart of the reference's ``vmap`` of the Pallas
kernel over the bank (``repro/dispatch/executor.py::_gemm_experts``).
``backend="torch"`` pins a site to the plain product (``torch.matmul``),
the counterpart of the reference's ``backend="xla"``: the MoE router uses
it so that its top-k decision does not depend on the execution mode.  A
bank GEMM whose operands need a gradient raises: MoE/MLA training is
queued (ROADMAP queue 1).
"""

from __future__ import annotations

import math
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


def _record(policy, site: str, M: int, K: int, N: int, backend: str):
    """Resolve and record the (M, K, N) site; returns the recommended tile
    and the record (None without a registry)."""
    cfg, tile = _resolved_tile(policy, M, K, N)
    rec = None
    if policy.registry is not None:
        src = getattr(policy.dispatcher, "source_of", None)
        rec = policy.registry.record(
            site, M, K, N, cfg, *tile, backend,
            src(M, K, N) if src is not None else "oracle")
    return tile, rec


def _run(a, b, tile, backend: str, out_dtype, rec=None, role: str = "fwd"):
    """One RSA GEMM on ``backend``: the CUDA kernel or its plain version.
    The kernel's launch records what it ran in ``rec.ran[role]``."""
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda, rsa_gemm_plain
    if backend == "torch":
        return rsa_gemm_plain(a, b, block_k=tile[2], mode=tile[3],
                              out_dtype=out_dtype)
    on_launch = None if rec is None else \
        (lambda ran: rec.ran.__setitem__(role, ran))
    return rsa_gemm_cuda(a, b, block_k=tile[2], mode=tile[3],
                         out_dtype=out_dtype, on_launch=on_launch)


class _Gemm2d(torch.autograd.Function):
    """(M, K) @ (K, N) through the RSA GEMM, differentiable: dx and dw run
    through the same kernel, each with its own tile, cast to the operands'
    types as the reference's ``_pallas_gemm2d_bwd`` does."""

    @staticmethod
    def forward(ctx, x2, w, tile, dx_tile, dw_tile, backend, out_dtype, rec):
        ctx.save_for_backward(x2, w)
        ctx.args = (dx_tile, dw_tile, backend, rec)
        return _run(x2, w, tile, backend, out_dtype, rec)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        dx_tile, dw_tile, backend, rec = ctx.args
        dy = dy.contiguous()
        a, b = x2, w
        if dy.dtype != x2.dtype:   # f32 output of bf16 operands
            a, b = x2.float(), w.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _run(dy, b.t(), dx_tile, backend, None, rec,
                      "dx").to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = _run(a.t(), dy, dw_tile, backend, None, rec,
                      "dw").to(w.dtype)
        return dx, dw, None, None, None, None, None, None


def gemm(x: torch.Tensor, w: torch.Tensor, *, site: str = "dense",
         out_dtype: Optional[torch.dtype] = None,
         backend: Optional[str] = None) -> torch.Tensor:
    """Self-adaptive GEMM.

    w 2-D: (..., M', K) @ (K, N) -> (..., M', N), M = prod of the leading
    dims.  w 3-D: expert bank, x (..., E, C, K) @ w (E, K, N) ->
    (..., E, C, N), one GEMM per bank member, recommended at M =
    prod(...) * C and run as one bank launch.

    ``out_dtype`` (default ``x.dtype``) lets bf16 operands produce f32
    output with f32 accumulation — the same arithmetic as casting both
    operands to f32 first, since a product of two bf16 values is exact in
    f32.  ``backend="torch"`` pins the site to the plain product
    (``torch.matmul``) whatever the policy."""
    from repro_torch.dispatch.context import active

    if backend not in (None, "torch"):
        raise ValueError(f"backend must be None or 'torch', got {backend!r}")
    policy = active()
    pinned = backend == "torch"
    exec_backend = "torch" if pinned else policy.backend(x)
    if w.dim() == 3:
        return _gemm_bank(x, w, site, policy, exec_backend, pinned,
                          out_dtype)
    if w.dim() != 2:
        raise ValueError(f"gemm weight must be 2D or 3D (expert bank), got "
                         f"{tuple(w.shape)}")
    M = x.numel() // x.shape[-1] if x.dim() > 1 else 1
    K, N = int(x.shape[-1]), int(w.shape[-1])
    if int(w.shape[0]) != K:
        raise ValueError(f"gemm shape mismatch: x {tuple(x.shape)} @ "
                         f"w {tuple(w.shape)}")
    tile, rec = _record(policy, site, M, K, N, exec_backend)
    x2 = x.reshape(M, K)
    if pinned:
        out = torch.matmul(x2, w).to(out_dtype or x2.dtype)
    elif torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
        # the gradient GEMMs' own recommendations: dx is an (M, N) x (N, K)
        # GEMM, dw a (K, M) x (M, N) one
        _, dx_tile = _resolved_tile(policy, M, N, K)
        _, dw_tile = _resolved_tile(policy, K, M, N)
        out = _Gemm2d.apply(x2, w, tile, dx_tile, dw_tile, exec_backend,
                            out_dtype, rec)
    else:
        out = _run(x2, w, tile, exec_backend, out_dtype, rec)
    return out.reshape(tuple(x.shape[:-1]) + (N,))


def _gemm_bank(x, w, site: str, policy, exec_backend: str, pinned: bool,
               out_dtype):
    """x (..., E, C, K) @ w (E, K, N) -> (..., E, C, N): the bank's rows
    gathered to (E, M, K) (a copy unless the leading dims are 1), one bank
    GEMM, the result moved back."""
    E, K, N = (int(s) for s in w.shape)
    if x.dim() < 3 or int(x.shape[-3]) != E or int(x.shape[-1]) != K:
        raise ValueError(f"expert gemm shape mismatch: x {tuple(x.shape)} "
                         f"vs w {tuple(w.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "the gradient of a bank GEMM (MoE/MLA training) is not ported "
            "yet (ROADMAP queue 1)")
    C = int(x.shape[-2])
    lead = tuple(x.shape[:-3])
    B = math.prod(lead)
    M = B * C                                # rows per bank GEMM
    tile, rec = _record(policy, site, M, K, N, exec_backend)
    xe = x.reshape(B, E, C, K).transpose(0, 1).reshape(E, M, K)
    xe = xe.contiguous()
    out = torch.matmul(xe, w).to(out_dtype or xe.dtype) if pinned else \
        _run(xe, w, tile, exec_backend, out_dtype, rec)         # (E, M, N)
    out = out.reshape(E, B, C, N).transpose(0, 1)
    return out.reshape(lead + (E, C, N))
