"""Megatron tensor parallelism over the mesh's ``model`` axis: the
reference's ``tp_strategy="tp"`` rules (``parallel/sharding.py``) run as
each rank's computation on its own block of heads, FFN hidden columns,
experts and vocab rows.

The two conjugate ops, each an ``autograd.Function`` over the ``model``
axis's group of the ambient ``DeviceMesh`` (``parallel/hints.py``):

- ``copy_in``: the identity forward, an all-reduce of the gradient
  backward.  A replicated activation goes through it before a rank's
  block consumes it (x before a column-parallel GEMM), so that its
  gradient, and every replicated leaf's behind it, is the whole one on
  every rank;
- ``reduce_out``: an all-reduce forward, the identity backward.  A rank's
  partial sum goes through it where Megatron all-reduces (after a
  row-parallel GEMM, after a rank's experts).

A replicated leaf a rank uses in part is cut to its block by ``cols``
(the last dim: a bias, a column-parallel input's per-column leaf) or
``rows`` (the first dim: a recurrent block's per-head leaf).

The vocab-parallel pieces: ``vocab_embed`` (ids outside the rank's rows
zeroed, then ``reduce_out``) and ``vocab_ce`` (the row max an all-reduce
MAX, detached; the sum of exponentials and the gold logit, masked to the
rank's rows, through ``reduce_out``).

Every op is the identity, and runs no collective, where :func:`context`
is None: no mesh, ``cfg.tp_strategy != "tp"``, or a ``model`` axis of one
rank.  The model reads from a leaf's own shape whether it holds a block
(:func:`local`), so serving and the one-device step never reach a
collective.  The collectives are ``torch.distributed``'s eager calls
(the functional ones end both ranks with SIGSEGV over gloo on CUDA
tensors), each counted in ``sharding.METER``; a failed one raises and
ends its rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel.sharding import METER


class TP(NamedTuple):
    """This rank's place on the ``model`` axis."""
    group: object
    rank: int
    size: int


def context(cfg: ArchConfig) -> Optional[TP]:
    """The ``model`` axis of the ambient mesh under ``tp_strategy="tp"``,
    or None (no mesh, another strategy, an axis of one rank)."""
    from repro_torch.parallel.hints import current_mesh
    from repro_torch.parallel.sharding import axis_sizes, coordinate
    mesh = current_mesh()
    if mesh is None or cfg.tp_strategy != "tp":
        return None
    size = axis_sizes(mesh).get("model", 1)
    if size == 1:
        return None
    return TP(mesh.get_group("model"), coordinate(mesh)["model"], size)


def local(cfg: ArchConfig, held: int, whole: int) -> Optional[TP]:
    """:func:`context` where a leaf holds ``held`` of ``whole`` units (its
    block of heads, columns, experts or rows), else None (the leaf was
    gathered whole and every rank computes on all of it)."""
    if held == whole:
        return None
    tp = context(cfg)
    if tp is None or held * tp.size != whole:
        raise ValueError(f"a block of {held} of {whole} units outside a "
                         f"model axis that cuts it")
    return tp


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        METER.collective(g)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        METER.collective(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    return x if tp is None else _CopyIn.apply(x, tp.group)


def reduce_out(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    return x if tp is None else _ReduceOut.apply(x, tp.group)


def cols(t: Optional[torch.Tensor], n: int, tp: Optional[TP]):
    """This rank's ``n`` of a replicated leaf's last-dim entries (a bias
    of a column-parallel GEMM); the leaf itself where it has ``n``."""
    if t is None or t.shape[-1] == n:
        return t
    return t[..., tp.rank * n:(tp.rank + 1) * n]


def rows(t: torch.Tensor, n: int, tp: Optional[TP]) -> torch.Tensor:
    """This rank's ``n`` of a replicated leaf's first-dim entries (a
    per-head leaf of a recurrent block: RWKV6's bonus and group norm,
    Mamba2's A, dt bias and D); the leaf itself where it has ``n``."""
    if t.shape[0] == n:
        return t
    return t[tp.rank * n:(tp.rank + 1) * n]


def kv_for_heads(t: torch.Tensor, num_heads: int, num_kv_heads: int,
                 tp: Optional[TP]) -> torch.Tensor:
    """(B, S, KVH_local, hd) K or V for this rank's block of the
    ``num_heads`` query heads: ``t`` itself where it holds a block of
    kv heads; where it holds all ``num_kv_heads`` (gathered, as the kv
    heads do not divide the axis), the one kv head the rank's heads share,
    or one a query head (query head h uses kv head h // G)."""
    if tp is None or t.shape[2] != num_kv_heads:
        return t
    h = num_heads // tp.size
    g = num_heads // num_kv_heads
    lo = tp.rank * h
    if g % h == 0:
        return t[:, :, lo // g:lo // g + 1]
    idx = torch.arange(lo, lo + h, device=t.device) // g
    return t.index_select(2, idx)


def vocab_embed(embed: torch.Tensor, ids: torch.Tensor,
                tp: TP) -> torch.Tensor:
    """Rows of the vocab-parallel table: this rank's block (V / m, d)
    gives the rows of the ids it holds and zeros for the others; the sum
    over the axis is the lookup."""
    n = embed.shape[0]
    rel = ids.long() - tp.rank * n
    mine = (rel >= 0) & (rel < n)
    x = embed[torch.where(mine, rel, torch.zeros_like(rel))]
    return reduce_out(x * mine[..., None].to(x.dtype), tp)


def vocab_ce(logits: torch.Tensor, labels: torch.Tensor,
             tp: TP) -> torch.Tensor:
    """Per-row cross-entropy (logsumexp - gold) from this rank's f32
    logits over its block of the vocab (..., V / m)."""
    n = logits.shape[-1]
    mx = logits.detach().amax(dim=-1)
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=tp.group)
    METER.collective(mx)
    se = reduce_out(torch.exp(logits - mx[..., None]).sum(dim=-1), tp)
    rel = labels.long() - tp.rank * n
    mine = (rel >= 0) & (rel < n)
    gold = torch.gather(logits, -1, torch.where(
        mine, rel, torch.zeros_like(rel))[..., None])[..., 0]
    gold = reduce_out(gold * mine.to(gold.dtype), tp)
    return torch.log(se) + mx - gold
