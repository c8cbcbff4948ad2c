"""Paged absorbed-MLA attention over the latent arena: decode and chunked
prefill.

``paged_mla_decode_cuda`` / ``paged_mla_prefill_cuda`` launch
``csrc/paged_mla.cu`` (replacing
``repro/kernels/paged_attn.py::paged_mla_decode_pallas`` and
``::paged_mla_prefill_pallas``); each counts the launches that returned no
error in its ``.launches`` (an empty problem launches nothing and counts
nothing).  The plain PyTorch versions port the reference's masked-dense
oracles (``repro/kernels/ref.py::paged_mla_attention_ref`` and
``::paged_mla_prefill_attention_ref``): gather every lane's latent pages
through its block table, score ``q_abs . c_kv + q_rope . k_rope`` in f32,
one masked softmax, ``p @ c_kv``, zeros for a lane of length 0.  They
serve CPU tensors and are what the kernels are held against on the card.

Arenas: ckv (NB, bs, r) and krope (NB, bs, rd), shared by every head of a
lane; tables (S, W) int32 page ids in logical order, dead columns
repeating the last live id; lengths (S,) int32 valid rows (including a
prefill chunk's own rows, written before the call).  The output is the
latent mix (..., H, r) in q's dtype; the caller applies W_UV and W_O.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attn import NEG, paged_gather

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_RANK = 512                 # the largest r the kernel's accumulators hold


def _mla_scores(qa, qr, ckv, krope, scale: float):
    """f32 scores (..., L) of pre-absorbed queries qa (S, ..., r) / qr
    (S, ..., rd) against gathered latent rows ckv (S, L, r) / krope
    (S, L, rd)."""
    S, L = ckv.shape[0], ckv.shape[1]
    qa2 = qa.float().reshape(S, -1, qa.shape[-1])
    qr2 = qr.float().reshape(S, -1, qr.shape[-1])
    s = (torch.einsum("snr,slr->snl", qa2, ckv) +
         torch.einsum("snd,sld->snl", qr2, krope)) * scale
    return s.reshape(tuple(qa.shape[:-1]) + (L,))


def paged_mla_attention_plain(q_abs, q_rope, ckv_arena, krope_arena, tables,
                              lengths, *, scale: float):
    """Absorbed-MLA decode over gathered latent pages (f32 softmax).

    q_abs: (S, H, r); q_rope: (S, H, rd).  Returns o_lat (S, H, r) in
    q_abs's dtype; lanes of length 0 yield zeros."""
    paged_mla_attention_plain.calls += 1
    dev = q_abs.device
    ckv = paged_gather(ckv_arena, tables).float()              # (S, L, r)
    krope = paged_gather(krope_arena, tables).float()
    s = _mla_scores(q_abs, q_rope, ckv, krope, scale)          # (S, H, L)
    lengths = lengths.to(dev).long()
    mask = torch.arange(ckv.shape[1], device=dev)[None, :] < lengths[:, None]
    s = torch.where(mask[:, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("shl,slr->shr", p, ckv)
    o = torch.where((lengths > 0)[:, None, None], o, torch.zeros_like(o))
    return o.to(q_abs.dtype)


paged_mla_attention_plain.calls = 0


def paged_mla_prefill_attention_plain(q_abs, q_rope, ckv_arena, krope_arena,
                                      tables, starts, lengths, *,
                                      scale: float):
    """Absorbed-MLA chunked prefill over gathered latent pages (f32
    softmax).

    q_abs: (S, C, H, r); q_rope: (S, C, H, rd); chunk row c attends
    causally to arena columns ``<= starts + c`` (and ``< lengths``).
    Returns o_lat (S, C, H, r); lanes of length 0 yield zeros."""
    paged_mla_prefill_attention_plain.calls += 1
    dev = q_abs.device
    C = q_abs.shape[1]
    ckv = paged_gather(ckv_arena, tables).float()              # (S, L, r)
    krope = paged_gather(krope_arena, tables).float()
    s = _mla_scores(q_abs, q_rope, ckv, krope, scale)          # (S, C, H, L)
    lengths = lengths.to(dev).long()
    starts = starts.to(dev).long()
    col = torch.arange(ckv.shape[1], device=dev)
    qpos = starts[:, None] + torch.arange(C, device=dev)[None, :]  # (S, C)
    mask = (col[None, None, :] < lengths[:, None, None]) & \
           (col[None, None, :] <= qpos[:, :, None])            # (S, C, L)
    s = torch.where(mask[:, :, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("schl,slr->schr", p, ckv)
    o = torch.where((lengths > 0)[:, None, None, None], o,
                    torch.zeros_like(o))
    return o.to(q_abs.dtype)


paged_mla_prefill_attention_plain.calls = 0


def _check(q_abs, q_rope, ckv_arena, krope_arena, tables, lengths,
           starts=None):
    """Validate what the kernels take; returns (H, r, rd, NB, bs, W)."""
    ts = (q_abs, q_rope, ckv_arena, krope_arena, tables, lengths) + \
        ((starts,) if starts is not None else ())
    if not all(t.is_cuda and t.device == q_abs.device for t in ts):
        raise ValueError("paged MLA kernels need every tensor on q_abs's "
                         "CUDA device")
    if q_abs.dtype not in _DTYPES or any(
            t.dtype != q_abs.dtype for t in (q_rope, ckv_arena, krope_arena)):
        raise ValueError(f"unsupported dtypes q_abs {q_abs.dtype}, q_rope "
                         f"{q_rope.dtype}, arenas {ckv_arena.dtype}/"
                         f"{krope_arena.dtype}")
    ints = (tables, lengths) + ((starts,) if starts is not None else ())
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError("tables, lengths and starts must be int32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged MLA kernels need contiguous tensors")
    if ckv_arena.dim() != 3 or krope_arena.dim() != 3:
        raise ValueError(f"latent arenas must be (NB, bs, r) / (NB, bs, rd), "
                         f"got {tuple(ckv_arena.shape)} / "
                         f"{tuple(krope_arena.shape)}")
    NB, bs, r = ckv_arena.shape
    rd = krope_arena.shape[-1]
    if krope_arena.shape[:2] != (NB, bs) or q_abs.shape[-1] != r or \
            q_rope.shape[-1] != rd or q_rope.shape[:-1] != q_abs.shape[:-1]:
        raise ValueError(f"shape mismatch q_abs {tuple(q_abs.shape)} / q_rope "
                         f"{tuple(q_rope.shape)} vs arenas "
                         f"{tuple(ckv_arena.shape)} / "
                         f"{tuple(krope_arena.shape)}")
    if r > MAX_RANK:
        raise ValueError(f"the MLA kernels hold r <= {MAX_RANK}, got {r}")
    S = q_abs.shape[0]
    if tables.dim() != 2 or tables.shape[0] != S or lengths.shape != (S,) \
            or (starts is not None and starts.shape != (S,)):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {S} lanes")
    return q_abs.shape[-2], r, rd, NB, bs, tables.shape[1]


def paged_mla_decode_cuda(q_abs, q_rope, ckv_arena, krope_arena, tables,
                          lengths, *, scale: float):
    """q_abs (S, H, r), q_rope (S, H, rd) -> o_lat (S, H, r) through the
    CUDA MLA decode kernel."""
    from repro_torch.kernels import _build
    if q_abs.dim() != 3:
        raise ValueError(f"q_abs must be (S, H, r), got {tuple(q_abs.shape)}")
    H, r, rd, NB, bs, W = _check(q_abs, q_rope, ckv_arena, krope_arena,
                                 tables, lengths)
    S = q_abs.shape[0]
    out = torch.empty_like(q_abs)
    if S == 0 or H == 0:
        return out
    err = _build.library("paged_mla").paged_mla_decode_launch(
        _DTYPES[q_abs.dtype], q_abs.data_ptr(), q_rope.data_ptr(),
        ckv_arena.data_ptr(), krope_arena.data_ptr(), out.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), S, H, r, rd, NB, bs, W, scale,
        torch.cuda.current_stream(q_abs.device).cuda_stream)
    _build.check(err, "paged MLA decode attention")
    paged_mla_decode_cuda.launches += 1
    return out


paged_mla_decode_cuda.launches = 0  # kernel launches that returned no error


def paged_mla_prefill_cuda(q_abs, q_rope, ckv_arena, krope_arena, tables,
                           starts, lengths, *, scale: float):
    """q_abs (S, C, H, r), q_rope (S, C, H, rd) -> o_lat (S, C, H, r)
    through the CUDA MLA prefill kernel."""
    from repro_torch.kernels import _build
    if q_abs.dim() != 4:
        raise ValueError(f"q_abs must be (S, C, H, r), got "
                         f"{tuple(q_abs.shape)}")
    H, r, rd, NB, bs, W = _check(q_abs, q_rope, ckv_arena, krope_arena,
                                 tables, lengths, starts)
    S, C = q_abs.shape[0], q_abs.shape[1]
    out = torch.empty_like(q_abs)
    if S == 0 or C == 0 or H == 0:
        return out
    err = _build.library("paged_mla").paged_mla_prefill_launch(
        _DTYPES[q_abs.dtype], q_abs.data_ptr(), q_rope.data_ptr(),
        ckv_arena.data_ptr(), krope_arena.data_ptr(), out.data_ptr(),
        tables.data_ptr(), starts.data_ptr(), lengths.data_ptr(), S, C, H, r,
        rd, NB, bs, W, scale,
        torch.cuda.current_stream(q_abs.device).cuda_stream)
    _build.check(err, "paged MLA prefill attention")
    paged_mla_prefill_cuda.launches += 1
    return out


paged_mla_prefill_cuda.launches = 0  # kernel launches that returned no error
