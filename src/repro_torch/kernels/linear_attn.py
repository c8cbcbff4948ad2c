"""Chunked linear attention with a data-dependent decay (the RWKV6 WKV
recurrence): per (batch, head),

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T

with log decays ``logw`` = log w_t <= 0, in the chunked closed form.

``wkv_bshk_cuda`` / ``linear_attn_cuda`` launch the two entry points of
``csrc/linear_attn.cu`` (replacing
``repro/kernels/linear_attn.py::linear_attn_bshk_pallas`` and
``::linear_attn_pallas``) under ``_wkv_plan``'s plan: chunk 1 runs the
one-pass decode kernel; a longer chunk runs every chunk's intra part at
once, chains the state in chunk order, and adds each chunk's inter part.
Each call counts one launch in its ``.launches``, however many kernels
the plan runs (an empty problem launches nothing and counts nothing).
``wkv_bshk_plain`` / ``linear_attn_plain`` are the plain PyTorch versions,
used for CPU tensors and as what the kernels are held against on the card.
Both repeat the TPU kernels' arithmetic chunk by chunk (``_kernel_bshk``
and ``_kernel``): with cs the inclusive cumsum of the chunk's log decays
per key column and cs_prev = cs - logw,

    o     = (r * exp(cs_prev)) @ h                        inter-chunk
          + A @ v,  A[t, j] = sum_k r[t,k] k[j,k] exp(cs_prev[t,k] - cs[j,k]), j < t
          + (sum_k r[t,k] u[k] k[t,k]) v[t]               bonus diagonal
    h    <- exp(wsum) h + (k * exp(wsum - cs))^T @ v,     wsum = cs[-1]

every exponent <= 0 (the masked (t, j) pairs are never exponentiated).
The state and all arithmetic are f32; o comes back in r's dtype.
``wkv_scan_parallel`` is the plain twin of the kernel's decomposition
(every chunk's intra part at once, A factorised across 16-row
sub-chunks, the chain in order, then the inter part).

Layouts are the reference's.  ``wkv_bshk_*``: r, k, logw (B, S, H, K), v
(B, S, H, V), u (H, K), state0 (B, H, K, V) f32 -> (o (B, S, H, V), final
state (B, H, K, V) f32).  ``linear_attn_*``: r, k, logw (BH, S, K), v (BH,
S, V), u (BH, K), zero initial state, no state out -> o (BH, S, V).  S must
be a multiple of ``chunk``; ``kernels/ops.py`` pads with zero rows (k = 0
adds nothing, logw = 0 keeps the state).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.rsa_gemm import _cdiv

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 64                   # the largest K, V and chunk the kernel holds
SUB = 16                       # rows of a sub-chunk of the factorised A


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


def _decay_block(rc, kc, cs, cp) -> torch.Tensor:
    """A (B, n, H, t, j) of every chunk at once, zero on and above the
    diagonal, as the intra kernel forms it: directly inside each 16-row
    sub-chunk and, across it, factorised at the sub-chunk's boundary row
    bnd as (r exp(cs_prev - cs[bnd-1])) . (k exp(cs[bnd-1] - cs)), both
    exponents <= 0."""
    lc = rc.shape[2]
    t = torch.arange(lc, device=rc.device)
    keep = (t[None, :] < t[:, None]) & \
        ((t[:, None] // SUB) == (t[None, :] // SUB))      # j < t, one sub-chunk
    diff = cp[:, :, :, None] - cs[:, :, None]             # (B, n, t, j, H, K)
    diff = torch.where(keep[None, None, :, :, None, None], diff,
                       torch.full_like(diff, -1e30))
    A = torch.einsum("bnthk,bnjhk,bntjhk->bnhtj", rc, kc, torch.exp(diff))
    for bnd in range(SUB, lc, SUB):
        rows = slice(bnd, min(bnd + SUB, lc))
        ref = cs[:, :, bnd - 1:bnd]
        rt = rc[:, :, rows] * torch.exp(cp[:, :, rows] - ref)
        kt = kc[:, :, :bnd] * torch.exp(ref - cs[:, :, :bnd])
        A[..., rows, :bnd] = torch.einsum("bnthk,bnjhk->bnhtj", rt, kt)
    return A


def wkv_scan_parallel(r, k, v, logw, u, h, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of the CUDA kernel's chunked variant, on
    ``wkv_scan``'s arguments: every chunk's intra part at once (cumsum, A
    factorised across 16-row sub-chunks, the bonus diagonal, A @ v, the
    state increment dS_c = (k exp(wsum - cs))^T v and the decay
    exp(wsum_c)); the chain h_c = exp(wsum_c) h_{c-1} + dS_c in chunk
    order, as ``wkv_scan`` rounds it; then each chunk's inter part (r
    exp(cs_prev)) @ h_{c-1}.  Returns (o f32, final state);
    counts nothing."""
    B, S, H, K = r.shape
    V, n = v.shape[-1], S // chunk

    def chunks(x):
        return x.reshape(B, n, chunk, H, x.shape[-1])
    rc, kc, vc, lw = map(chunks, (r, k, v, logw))
    cs = torch.cumsum(lw, dim=2)                          # (B, n, lc, H, K)
    cp = cs - lw
    wsum = cs[:, :, -1]                                   # (B, n, H, K)
    A = _decay_block(rc, kc, cs, cp)
    diag = (rc * u[:, None, None] * kc).sum(-1, keepdim=True)
    o = torch.einsum("bnhtj,bnjhv->bnthv", A, vc) + diag * vc
    ds = torch.einsum("bnthk,bnthv->bnhkv",
                      kc * torch.exp(wsum[:, :, None] - cs), vc)
    dec = torch.exp(wsum)[..., None]                      # (B, n, H, K, 1)
    hprev = []
    for c in range(n):                                    # the chain, in order
        hprev.append(h)
        h = dec[:, c] * h + ds[:, c]
    o = o + torch.einsum("bnthk,bnhkv->bnthv", rc * torch.exp(cp),
                         torch.stack(hprev, 1))
    return o.reshape(B, S, H, V), h


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
    _limits(r.shape[-1], v.shape[-1], chunk, r.shape[1])


class WkvPlan(NamedTuple):
    """How ``csrc/linear_attn.cu`` runs one call.  ``decode`` (chunk 1):
    one CTA per (b, h, tile of 32 state columns).  ``chunked``: the intra
    kernel (one CTA per (b, h, chunk)), the chain (``fold``: inside the
    inter kernel; ``launch``: a kernel of one CTA per (b, h, 16 state
    columns)), and the inter kernel (one CTA per (b, h, chunk, V tile))."""
    variant: str    # "chunked" or "decode"
    chain: str      # "fold" or "launch" ("" for decode)
    vt: int         # state columns a CTA of the inter or decode kernel
    vsplit: int     # V tiles: ceil(V / vt)
    n: int          # chunks
    ctas: int       # CTAs of the inter kernel (decode: of its one kernel)
    ws_elems: int   # f32 workspace elements (0 for decode)


_FOLD_MAX = 5                  # chunks the inter CTAs fold the chain over;
                               # past it the chain runs in its own kernel
                               # (launch/bench_wkv.py at B = 1, H = 32:
                               # folding 2-10% faster to n = 5, launching
                               # 3-4% faster from n = 6, 18% at n = 16)
DECODE_VT = 32                 # state columns of a decode CTA


def _limits(K: int, V: int, chunk: int, S: int) -> None:
    """Raise where the kernel does not hold the widths or the chunk."""
    if not (1 <= K <= MAX_DIM and 1 <= V <= MAX_DIM):
        raise ValueError(f"the WKV kernel holds K, V <= {MAX_DIM}, got K={K}"
                         f" V={V}")
    if not 1 <= chunk <= MAX_DIM or S % chunk:
        raise ValueError(f"chunk must be in [1, {MAX_DIM}] and divide S, got "
                         f"chunk={chunk} S={S}")


@functools.lru_cache(maxsize=4096)
def _wkv_plan(B: int, S: int, H: int, K: int, V: int, chunk: int,
              num_sms: int = 132, *, variant: Optional[str] = None,
              chain: Optional[str] = None, vt: Optional[int] = None
              ) -> WkvPlan:
    """The WKV kernel's plan for one call of B x H heads over S rows in
    chunks of ``chunk``.

    Chunk 1 takes the decode kernel (32 state columns a CTA).  A longer
    chunk takes the chunked variant: its inter kernel holds V (rounded up
    to 4) whole, or halves it where the B * H * n CTAs of whole tiles
    fill at most half the SMs (``launch/bench_wkv.py`` at B = 1, H = 32:
    halving 4-5% faster at n = 1, 2, whole 1-5% faster from n = 3); the
    inter CTAs fold the chain while n <= 5, and a kernel of its own walks
    it beyond.  ``variant``, ``chain`` and ``vt`` (a
    multiple of 4 up to V) force the chunked variant's choices
    (``launch/bench_wkv.py``, ``chip_smoke.py`` and the card tests run
    each).  Raises where the kernel does not hold the widths, the chunk or
    the forced plan."""
    _limits(K, V, chunk, S)
    n = S // chunk
    variant = variant or ("decode" if chunk == 1 else "chunked")
    if variant == "decode":
        if chunk != 1 or chain or vt not in (None, DECODE_VT):
            raise ValueError(f"the decode kernel runs chunk 1 alone, "
                             f"{DECODE_VT} columns a CTA")
        vsplit = _cdiv(V, DECODE_VT)
        return WkvPlan("decode", "", DECODE_VT, vsplit, n, B * H * vsplit, 0)
    if variant != "chunked":
        raise ValueError(f"unknown WKV variant {variant!r}")
    V4 = _cdiv(V, 4) * 4
    if vt is None:
        vt = V4 // 2 if V4 % 8 == 0 and 2 * B * H * n <= num_sms else V4
    elif vt % 4 or not 4 <= vt <= V4:
        raise ValueError(f"a V tile is a multiple of 4 up to {V4}, not {vt}")
    chain = chain or ("fold" if n <= _FOLD_MAX else "launch")
    if chain not in ("fold", "launch"):
        raise ValueError(f"the chain is folded or launched, not {chain!r}")
    vsplit, bhn = _cdiv(V, vt), B * H * n
    ws = B * S * H * V + bhn * (chunk * K + K * V + K) + \
        (bhn * K * V if chain == "launch" else 0)
    return WkvPlan("chunked", chain, vt, vsplit, n, bhn * vsplit, ws)


def _sms(t) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _launch(fn, what, plan, tensors, dims, chunk, ref):
    """One call of a WKV entry point under ``plan``, with its workspace;
    raises on a launch error."""
    from repro_torch.kernels import _build
    ws = torch.empty(plan.ws_elems, dtype=torch.float32, device=ref.device) \
        if plan.ws_elems else None
    err = getattr(_build.library("linear_attn"), fn)(
        _DTYPES[ref.dtype], *(t.data_ptr() for t in tensors), *dims, chunk,
        int(plan.variant == "decode"), int(plan.chain == "launch"),
        plan.vt, None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(ref.device).cuda_stream)
    _build.check(err, what)


def _check_plan(plan: WkvPlan, B: int, S: int, H: int, K: int, V: int,
                chunk: int) -> None:
    """Raise unless ``plan`` is the plan its own choices give at these
    dimensions (so its workspace size is theirs), before any launch."""
    try:
        same = plan == _wkv_plan(B, S, H, K, V, chunk, variant=plan.variant,
                                 chain=plan.chain or None, vt=plan.vt)
    except ValueError:
        same = False
    if not same:
        raise ValueError(f"plan {plan} is not one for (B, S, H, K, V) = "
                         f"{(B, S, H, K, V)}, chunk={chunk}")


def wkv_bshk_cuda(r, k, v, logw, u, state0, *, chunk: int,
                  plan: Optional[WkvPlan] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, final state) through the CUDA WKV kernel, (B, S, H, K) layout,
    under ``_wkv_plan``'s plan unless ``plan`` gives another."""
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
    plan = plan or _wkv_plan(B, S, H, K, V, chunk, _sms(r))
    _check_plan(plan, B, S, H, K, V, chunk)
    sf = torch.empty_like(state0)
    _launch("wkv_bshk_launch", "WKV scan", plan,
            (r, k, v, logw, u, state0, o, sf), (B, S, H, K, V), chunk, r)
    wkv_bshk_cuda.launches += 1
    wkv_bshk_cuda.launches_by_chunk[chunk] = \
        wkv_bshk_cuda.launches_by_chunk.get(chunk, 0) + 1
    return o, sf


wkv_bshk_cuda.launches = 0           # calls whose launches returned no error
wkv_bshk_cuda.launches_by_chunk = {}  # the same, per chunk (1: decode)


def linear_attn_cuda(r, k, v, logw, u, *, chunk: int,
                     plan: Optional[WkvPlan] = None) -> torch.Tensor:
    """o through the CUDA kernel, (BH, S, K) layout, zero initial state,
    under ``_wkv_plan``'s plan (H = 1) unless ``plan`` gives another."""
    if r.dim() != 3:
        raise ValueError(f"r must be (BH, S, K), got {tuple(r.shape)}")
    _check(r, k, v, logw, u, chunk)
    BH, S, K = r.shape
    V = v.shape[-1]
    if u.shape != (BH, K):
        raise ValueError(f"u {tuple(u.shape)} does not match (BH, K) = "
                         f"{(BH, K)}")
    o = torch.empty(v.shape, dtype=r.dtype, device=r.device)
    if BH == 0 or S == 0:
        return o
    plan = plan or _wkv_plan(BH, S, 1, K, V, chunk, _sms(r))
    _check_plan(plan, BH, S, 1, K, V, chunk)
    _launch("linear_attn_launch", "linear attention", plan,
            (r, k, v, logw, u, o), (BH, S, K, V), chunk, r)
    linear_attn_cuda.launches += 1
    return o


linear_attn_cuda.launches = 0  # calls whose launches returned no error
