"""ADAPTNETX — one fused ADAPTNET query: the (M, K, N) ids pick one row of
each embedding table, and ``relu(x @ w1 + b1) @ w2 + b2`` gives the
tile-class logits (the raw encoding of ``core/adaptnet.py``).  The argmax
is left to the caller, so tests can check the whole distribution.

``adaptnetx_cuda`` launches ``csrc/adaptnetx.cu`` (replacing
``repro/kernels/adaptnetx.py::adaptnetx_pallas``), one CTA per query, and
counts the launches that returned no error in ``.launches`` (an empty
batch launches nothing and counts nothing).  ``adaptnetx_plain`` is the
plain PyTorch version, used for CPU tensors and as what the kernel is
held against on the card.

Both take ids (B, 3) int32 (a query per row) and f32 tables: emb_m, emb_k,
emb_n (rows, E), w1 (3E, H), b1 (H,), w2 (H, C), b2 (C,), and return (B, C)
f32 logits.  Each id is clamped to [0, rows - 1] of its table, as JAX's
gather and the reference's ``np.clip`` do.
"""

from __future__ import annotations

import torch

MAX_E = 64                     # the kernel holds 3E <= 192 inputs
MAX_H = 1024                   # and H <= 1024 hidden units
# a raw-encoding net's leaves, in the kernel's operand order
OPERANDS = ("emb_m", "emb_k", "emb_n", "w1", "b1", "w2", "b2")


def adaptnetx_plain(ids, emb_m, emb_k, emb_n, w1, b1, w2, b2
                    ) -> torch.Tensor:
    """(B, C) f32 logits of the B queries in ``ids`` (B, 3)."""
    adaptnetx_plain.calls += 1
    x = torch.cat([t[ids[:, i].long().clamp(0, t.shape[0] - 1)]
                   for i, t in enumerate((emb_m, emb_k, emb_n))], dim=-1)
    h = torch.relu(x.float() @ w1.float() + b1.float())
    return h @ w2.float() + b2.float()


adaptnetx_plain.calls = 0


def adaptnetx_cuda(ids, emb_m, emb_k, emb_n, w1, b1, w2, b2
                   ) -> torch.Tensor:
    """(B, C) f32 logits through the CUDA kernel.  Every operand must be a
    contiguous CUDA tensor on one card, ids int32, the rest f32."""
    from repro_torch.kernels import _build
    tables = (emb_m, emb_k, emb_n, w1, b1, w2, b2)
    if ids.dim() != 2 or ids.shape[1] != 3:
        raise ValueError(f"ids must be (B, 3), got {tuple(ids.shape)}")
    if ids.dtype != torch.int32 or any(t.dtype != torch.float32
                                       for t in tables):
        raise ValueError("ADAPTNETX takes int32 ids and f32 tables")
    dev = ids.device
    if not ids.is_cuda or any(t.device != dev for t in tables):
        raise ValueError("ADAPTNETX needs every operand on one CUDA card")
    if not all(t.is_contiguous() for t in (ids,) + tables):
        raise ValueError("ADAPTNETX needs contiguous operands")
    E = emb_m.shape[1]
    H, C = w2.shape
    if emb_k.shape[1] != E or emb_n.shape[1] != E or \
            w1.shape != (3 * E, H) or b1.shape != (H,) or b2.shape != (C,):
        raise ValueError(
            f"shape mismatch: emb {tuple(emb_m.shape)} / "
            f"{tuple(emb_k.shape)} / {tuple(emb_n.shape)}, w1 "
            f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)},"
            f" b2 {tuple(b2.shape)}")
    if not (1 <= E <= MAX_E and 1 <= H <= MAX_H and C >= 1) or \
            min(emb_m.shape[0], emb_k.shape[0], emb_n.shape[0]) < 1:
        raise ValueError(f"the ADAPTNETX kernel holds E <= {MAX_E}, H <= "
                         f"{MAX_H}, C >= 1 and non-empty tables; got E={E} "
                         f"H={H} C={C}")
    B = ids.shape[0]
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    err = _build.library("adaptnetx").adaptnetx_launch(
        ids.data_ptr(), emb_m.data_ptr(), emb_k.data_ptr(), emb_n.data_ptr(),
        emb_m.shape[0], emb_k.shape[0], emb_n.shape[0], E, w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), H, C, out.data_ptr(), B,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ADAPTNETX")
    adaptnetx_cuda.launches += 1
    return out


adaptnetx_cuda.launches = 0          # kernel launches that returned no error
