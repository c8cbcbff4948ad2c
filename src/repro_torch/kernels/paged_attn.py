"""Paged GQA attention over a physically paged KV arena: decode + prefill.

``paged_decode_cuda`` / ``paged_prefill_cuda`` launch
``csrc/paged_attn.cu`` (replacing
``repro/kernels/paged_attn.py::paged_gqa_decode_pallas`` and
``::paged_gqa_prefill_pallas``); each counts the launches that returned
no error in its ``.launches`` (an empty batch launches nothing and counts
nothing).  The plain PyTorch versions port the
reference's masked-dense oracles (``repro/kernels/ref.py::paged_gather``,
``paged_attention_ref``, ``paged_prefill_attention_ref``): gather every
lane's pages through its block table, run one masked f32 softmax, zero
the lanes of length 0.  They serve CPU tensors and are what the kernels
are held against on the card.

Arena (NB, bs, KVH, hd); tables (S, W) int32 page ids in logical order,
dead columns repeating the last live id; lengths (S,) int32 valid rows
(including a prefill chunk's own rows, written before the call).
"""

from __future__ import annotations

import torch

NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_gather(arena: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Linearize paged KV: arena (NB, bs, *feat) gathered through per-lane
    block tables (S, W) -> logical rows (S, W*bs, *feat)."""
    g = arena[tables.long()]                      # (S, W, bs, *feat)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) +
                     tuple(g.shape[3:]))


def paged_attention_plain(q, k_arena, v_arena, tables, lengths, *,
                          scale: float, logit_cap: float = 0.0):
    """Masked-dense decode attention over gathered pages (f32 softmax).

    q: (S, H, hd) one query per lane.  Returns (S, H, hd_v) in q's dtype;
    lanes of length 0 yield zeros."""
    paged_attention_plain.calls += 1
    S, H, hd = q.shape
    KVH = k_arena.shape[2]
    G = H // KVH
    k = paged_gather(k_arena, tables).float()          # (S, L, KVH, hd)
    v = paged_gather(v_arena, tables).float()
    qf = q.float().reshape(S, KVH, G, hd)
    s = torch.einsum("shgd,slhd->shgl", qf, k) * scale
    if logit_cap > 0.0:
        s = torch.tanh(s / logit_cap) * logit_cap
    lengths = lengths.to(q.device).long()
    mask = torch.arange(k.shape[1], device=q.device)[None, :] < \
        lengths[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("shgl,slhd->shgd", p, v)
    o = torch.where((lengths > 0)[:, None, None, None], o,
                    torch.zeros_like(o))
    return o.reshape(S, H, v.shape[-1]).to(q.dtype)


paged_attention_plain.calls = 0


def paged_prefill_attention_plain(q, k_arena, v_arena, tables, starts,
                                  lengths, *, scale: float,
                                  logit_cap: float = 0.0):
    """Chunked-prefill attention over gathered pages (f32 softmax).

    q: (S, C, H, hd) one prompt chunk per lane; chunk row r attends
    causally to arena columns ``<= starts + r`` (and ``< lengths``).
    Returns (S, C, H, hd_v); lanes of length 0 yield zeros."""
    paged_prefill_attention_plain.calls += 1
    S, C, H, hd = q.shape
    KVH = k_arena.shape[2]
    G = H // KVH
    k = paged_gather(k_arena, tables).float()          # (S, L, KVH, hd)
    v = paged_gather(v_arena, tables).float()
    qf = q.float().reshape(S, C, KVH, G, hd)
    s = torch.einsum("schgd,slhd->shgcl", qf, k) * scale
    if logit_cap > 0.0:
        s = torch.tanh(s / logit_cap) * logit_cap
    dev = q.device
    lengths = lengths.to(dev).long()
    starts = starts.to(dev).long()
    col = torch.arange(k.shape[1], device=dev)
    qpos = starts[:, None] + torch.arange(C, device=dev)[None, :]  # (S, C)
    mask = (col[None, None, :] < lengths[:, None, None]) & \
           (col[None, None, :] <= qpos[:, :, None])            # (S, C, L)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("shgcl,slhd->schgd", p, v)
    o = torch.where((lengths > 0)[:, None, None, None, None], o,
                    torch.zeros_like(o))
    return o.reshape(S, C, H, v.shape[-1]).to(q.dtype)


paged_prefill_attention_plain.calls = 0


def _check(q, k_arena, v_arena, tables, lengths, starts=None):
    """Validate what the kernels take; returns (KVH, G, hd, hd_v, NB, bs, W)."""
    if not all(t.is_cuda and t.device == q.device
               for t in (q, k_arena, v_arena, tables, lengths)):
        raise ValueError("paged attention kernels need every tensor on "
                         "q's CUDA device")
    if q.dtype not in _DTYPES or k_arena.dtype != q.dtype or \
            v_arena.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes q {q.dtype}, arenas "
                         f"{k_arena.dtype}/{v_arena.dtype}")
    ints = (tables, lengths) + ((starts,) if starts is not None else ())
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError("tables, lengths and starts must be int32")
    if not all(t.is_contiguous() for t in (q, k_arena, v_arena) + ints):
        raise ValueError("paged attention kernels need contiguous tensors")
    NB, bs, KVH, hd = k_arena.shape
    hd_v = v_arena.shape[-1]
    if v_arena.shape[:3] != k_arena.shape[:3] or q.shape[-1] != hd or \
            q.shape[-2] % KVH:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} vs arenas "
                         f"{tuple(k_arena.shape)}/{tuple(v_arena.shape)}")
    S = q.shape[0]
    if tables.dim() != 2 or tables.shape[0] != S or \
            lengths.shape != (S,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {S} lanes")
    return KVH, q.shape[-2] // KVH, hd, hd_v, NB, bs, tables.shape[1]


def paged_decode_cuda(q, k_arena, v_arena, tables, lengths, *,
                      scale: float, logit_cap: float = 0.0):
    """q (S, H, hd) -> (S, H, hd_v) through the CUDA decode kernel."""
    from repro_torch.kernels import _build
    KVH, G, hd, hd_v, NB, bs, W = _check(q, k_arena, v_arena, tables,
                                         lengths)
    S = q.shape[0]
    out = torch.empty((S, KVH * G, hd_v), dtype=q.dtype, device=q.device)
    if S == 0:
        return out
    err = _build.library("paged_attn").paged_decode_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_arena.data_ptr(),
        v_arena.data_ptr(), out.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), S, KVH, G, hd, hd_v, NB, bs, W, scale,
        logit_cap, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged decode attention")
    paged_decode_cuda.launches += 1
    return out


paged_decode_cuda.launches = 0      # kernel launches that returned no error


def paged_prefill_cuda(q, k_arena, v_arena, tables, starts, lengths, *,
                       scale: float, logit_cap: float = 0.0):
    """q (S, C, H, hd) -> (S, C, H, hd_v) through the CUDA prefill
    kernel."""
    from repro_torch.kernels import _build
    KVH, G, hd, hd_v, NB, bs, W = _check(q, k_arena, v_arena, tables,
                                         lengths, starts)
    S, C = q.shape[0], q.shape[1]
    if starts.shape != (S,):
        raise ValueError(f"starts {tuple(starts.shape)} does not match "
                         f"{S} lanes")
    if 32 * hd_v > 128 * 16:
        raise ValueError(f"the prefill kernel holds hd_v <= 64, got {hd_v}")
    out = torch.empty((S, C, KVH * G, hd_v), dtype=q.dtype, device=q.device)
    if S == 0 or C == 0:
        return out
    err = _build.library("paged_attn").paged_prefill_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_arena.data_ptr(),
        v_arena.data_ptr(), out.data_ptr(), tables.data_ptr(),
        starts.data_ptr(), lengths.data_ptr(), S, C, KVH, G, hd, hd_v, NB,
        bs, W, scale, logit_cap,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged prefill attention")
    paged_prefill_cuda.launches += 1
    return out


paged_prefill_cuda.launches = 0     # kernel launches that returned no error
