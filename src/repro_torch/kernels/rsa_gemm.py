"""RSA GEMM: the reconfigurable-tiling GEMM every model projection runs.

``rsa_gemm_cuda`` launches a hand-written kernel (replaces
``repro/kernels/rsa_gemm.py::rsa_gemm_pallas``) and counts each launch
that returned no error in ``rsa_gemm_cuda.launches`` (an empty product
launches nothing and counts nothing); ``rsa_gemm_plain`` is its
plain PyTorch version, used for CPU tensors and as the reference the
kernel is held against on the card.  Both compute the residency mode's
rounding, which is part of the function:

  OS: the whole K accumulates in f32 and is cast to the output type once
      (``csrc/rsa_gemm.cu``).
  WS, IS: each ``block_k`` chunk of K, ascending, is multiplied in f32,
      cast to the output type and added to the output in the output type
      (``_kernel_psum``).  In f32 this equals OS up to summation order; in
      bf16 it shows whenever K > block_k.

WS and IS are one function, so they are one kernel (``csrc/rsa_psum.cu``):
one CTA owns an output tile, keeps the chunk's f32 sum in registers and
the running output-type sum on chip, and writes C once; the mode only
orders the walk over tiles, and the two modes' outputs are bitwise equal.
Which tile, whether the operands swap roles (M <= 32: the weight on
wgmma's 64-row side) and how K is split when the tiles fill at most half
the card is
:func:`_psum_plan`, a function of the shape, ``block_k``, dtype and SM
count, never of the mode.  A split lies inside one ``block_k`` chunk; the
last CTA of a tile to arrive sums the splits' f32 partials (from a
workspace allocated here) in a fixed order, so the result is deterministic
and each GEMM is still one launch.  ``block_k`` sets the rounding only:
the WS/IS kernel holds no block_k slab in shared memory.

``b`` is either a row-major (K, N) matrix or the transpose of a row-major
(N, K) one (``w.t()``, as the tied unembedding passes ``embed.t()``), and
``a`` either a row-major (M, K) matrix or the transpose of a row-major
(K, M) one (the weight gradient ``x.t() @ dy``); the kernels read each in
place.  Neither version pads: the kernels mask the
ragged edges.

Expert banks: with 3-D operands, a (E, M, K) and b (E, K, N), both
versions compute the E products (E, M, N), each with the 2-D arithmetic
above; the kernel runs the whole bank in one launch (the reference's
``vmap`` of the Pallas kernel over the bank) and counts one launch.  Each
``b[e]`` may be any of the 2-D layouts above, at any bank stride, so the
MLA head banks are read as views of W_UK / W_UV.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core.hw import IS, OS, WS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the largest block_k a call may ask for: the reference's bound, kept for
# every mode; it no longer bounds a shared-memory slab (WS/IS close their
# chunks on chip, OS ignores block_k)
MAX_BLOCK_K = 2048
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


class PsumPlan(NamedTuple):
    """How ``csrc/rsa_psum.cu`` runs one WS/IS GEMM."""
    tile: int       # bf16: the n side of wgmma's tile (8, 32, 64, 128);
                    # f32: the CTA tile's rows (32 or 128; x 16384/rows)
    swap: bool      # bf16: B's N on wgmma's 64-row side, A's M on its n
    tiles: int      # output tiles, over the whole bank
    nsplit: int     # 1, or chunks * pieces splits of K
    pieces: int     # splits per block_k chunk
    piece: int      # k of one split (a multiple of 64)
    tile_elems: int  # f32 elements of one split's partial tile

    @property
    def ctas(self) -> int:
        return self.tiles * self.nsplit

    @property
    def ws_elems(self) -> int:
        return self.tiles * self.nsplit * self.tile_elems if \
            self.nsplit > 1 else 0


_MIN_PIECE = 256             # k of the smallest split: four bf16 stages
_WS_SHARE = 0.5              # workspace bytes at most this share of the
_WS_CAP = 64 * 2 ** 20       # operands' bytes, and at most 64 MiB
_FIXUP_CAP = 512 * 2 ** 10   # partial bytes one CTA sums for one tile
_SWAP_MAX_M = 32             # bf16 GEMMs up to this M swap the operands


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def _psum_plan(E: int, M: int, K: int, N: int, block_k: int,
               dtype: torch.dtype, num_sms: int, a_trans: bool = False, *,
               swap: Optional[bool] = None,
               split: Optional[bool] = None) -> PsumPlan:
    """The WS/IS kernel's tile, operand roles and split-K for one GEMM.

    bf16: M <= ``_SWAP_MAX_M`` swaps the operands (the weight streams
    once, the M rows are wgmma's n of 8 or 32; an A^T n side needs a whole
    64-wide panel, so 64); larger M keeps a 128 x 128 tile, or 128 x 64
    where 128 x 128 tiles would not cover the SMs.  f32: a 128 x 128 tile,
    or 32 x 512 for M <= 32.  When the tiles fill at most half the SMs,
    each block_k chunk is cut into ``pieces`` splits of ``piece`` k (a
    multiple of 64, at least ``_MIN_PIECE``), as many as aim at two CTAs
    per SM while the f32 partials stay within ``_WS_SHARE`` of the
    operands' bytes and ``_WS_CAP``, and the partials one CTA sums for a
    tile within ``_FIXUP_CAP`` (that sum runs on one SM).  A grid over half
    the card is not split: there the partials' traffic and the serial
    fix-up cost more than the idle SMs.  ``launch/bench_gemm.py`` times
    these choices against the ones they rejected (PERF.md, PR 17).

    ``swap`` and ``split`` override the two rules (bf16 only for
    ``swap``; ``split=True`` ignores the half-card rule and the caps) for
    that comparison.  The mode is not an input: WS and IS run the same
    plan and so the same arithmetic."""
    if dtype == torch.bfloat16:
        swap = M <= _SWAP_MAX_M if swap is None else swap
        if swap:
            tile = 64 if a_trans else 8 if M <= 8 else 32 if M <= 32 \
                else 64 if M <= 64 else 128
            tiles = E * _cdiv(N, 128) * _cdiv(M, tile)
        else:
            tile = 128 if E * _cdiv(M, 128) * _cdiv(N, 128) >= num_sms \
                else 64
            tiles = E * _cdiv(M, 128) * _cdiv(N, tile)
        tile_elems, size = 128 * tile, 2
    else:
        swap = False
        tile = 32 if M <= 32 else 128
        tiles = E * _cdiv(M, tile) * _cdiv(N, 16384 // tile)
        tile_elems, size = 16384, 4
    one = PsumPlan(tile, swap, tiles, 1, 1, 0, tile_elems)
    if split is False or (split is None and 2 * tiles > num_sms):
        return one
    chunks = _cdiv(K, block_k)
    span = min(block_k, K)
    cap = min(_WS_CAP, _WS_SHARE * E * (M * K + K * N) * size)
    for pieces in range(max(1, _cdiv(_cdiv(2 * num_sms, tiles), chunks)),
                        0, -1):
        piece = max(_MIN_PIECE, _cdiv(_cdiv(span, pieces), 64) * 64)
        pieces = _cdiv(span, piece)
        nsplit = chunks * pieces
        if nsplit <= 1:
            return one
        plan = PsumPlan(tile, swap, tiles, nsplit, pieces, piece, tile_elems)
        if split or (plan.ws_elems * 4 <= cap and
                     nsplit * tile_elems * 4 <= _FIXUP_CAP):
            return plan
    return one


_TICKETS: Dict[torch.device, torch.Tensor] = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 ticket per output tile, kept per device: every split
    launch leaves them zero again (the last CTA of a tile resets its
    ticket), so they are zeroed once, when the buffer grows."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096, 2 * (0 if t is None else t.numel())),
                        dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


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
                  mode: int, out_dtype: Optional[torch.dtype] = None,
                  plan: Optional[PsumPlan] = None) -> torch.Tensor:
    """Launch the CUDA RSA GEMM on PyTorch's current stream: one 2-D
    product, or one launch for a whole bank (3-D operands).  WS/IS run
    ``_psum_plan``'s plan unless ``plan`` gives another (to time it)."""
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
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    key = ((E,) if bank else ()) + (M, K, N, mode)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if mode == OS:
        vec = 16 // a.element_size()
        vec_a = int(a.data_ptr() % 16 == 0 and lda % vec == 0 and
                    sa % vec == 0)
        vec_b = int(b.data_ptr() % 16 == 0 and ldb % vec == 0 and
                    sb % vec == 0)
        err = _build.library("rsa_gemm").rsa_gemm_launch(
            mode, _DTYPES[a.dtype], _DTYPES[out_dtype], a_trans, b_trans,
            a.data_ptr(), lda, b.data_ptr(), ldb, out.data_ptr(), M, N, K,
            block_k, sms, vec_a, vec_b, E, sa, sb, M * N, stream)
    else:
        plan = plan or _psum_plan(E, M, K, N, block_k, a.dtype, sms,
                                  bool(a_trans))
        ws = torch.empty(plan.ws_elems, dtype=torch.float32,
                         device=a.device) if plan.nsplit > 1 else None
        tickets = _tickets(a.device, plan.tiles) if plan.nsplit > 1 \
            else None
        err = _build.library("rsa_psum").rsa_psum_launch(
            mode, _DTYPES[a.dtype], _DTYPES[out_dtype], a_trans, b_trans,
            a.data_ptr(), lda, sa, b.data_ptr(), ldb, sb, out.data_ptr(),
            M * N, E, M, N, K, block_k, plan.tile, int(plan.swap),
            plan.nsplit, plan.pieces, plan.piece,
            None if ws is None else ws.data_ptr(),
            None if tickets is None else tickets.data_ptr(), stream)
    _build.check(err, f"rsa_gemm {'x'.join(map(str, key[:-1]))} "
                      f"mode={mode}")
    rsa_gemm_cuda.launches += 1
    rsa_gemm_cuda.launches_by_key[key] = \
        rsa_gemm_cuda.launches_by_key.get(key, 0) + 1
    return out


rsa_gemm_cuda.launches = 0          # kernel launches that returned no error
rsa_gemm_cuda.launches_by_key = {}  # the same, per ([E,] M, K, N, mode)
