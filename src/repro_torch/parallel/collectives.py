"""Distributed-optimization collectives: int8-compressed gradient
reduction — the port of ``repro/parallel/collectives.py`` on
``torch.distributed`` (NCCL on CUDA tensors, gloo on CPU ones).

``quantized_psum`` moves 1 B an element each way where a bf16 ring
all-reduce moves 2 (an f32 one 4):

  1. agree on a global scale:      all-reduce MAX of |x|      (scalar)
  2. quantize to int8, keeping the error-feedback residual
  3. all_to_all_single of the int8 shards         (1 B/elem on the wire)
  4. dequantize + reduce locally in f32
  5. re-quantize the reduced shard (a second MAX agrees its scale)
  6. all_gather_into_tensor of the int8 shards    (1 B/elem)

The residual is returned to the caller, to add to the next step's
gradient (ZeRO-style error feedback).  Where the reference runs inside
``shard_map`` over a named axis, this runs on every rank of ``group``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def _quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _scale(t: torch.Tensor, group) -> torch.Tensor:
    amax = torch.max(torch.abs(t))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return torch.clamp(amax, min=1e-20) / 127.0


def quantized_psum(x: torch.Tensor, group=None, axis_size: int = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum ``x`` over the ranks of ``group`` (``axis_size`` of them) with
    the int8 wire format; flattened and zero-padded to a multiple of
    ``axis_size``, as the reference pads.  Returns (the sum in f32, this
    rank's error-feedback residual), both of ``x``'s shape."""
    if axis_size is None:
        axis_size = dist.get_world_size(group)
    orig_shape = x.shape
    x = x.to(torch.float32).reshape(-1)
    n = x.numel()
    pad = (-n) % axis_size
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))

    scale = _scale(x, group)
    q = _quant(x, scale)
    err = x - _dequant(q, scale)                       # error feedback

    # reduce-scatter in int8: all_to_all my shards, reduce locally in f32
    qs = torch.empty_like(q)
    dist.all_to_all_single(qs, q, group=group)
    # qs: (axis_size, chunk) — one int8 shard from each peer
    local_sum = torch.sum(_dequant(qs.view(axis_size, -1), scale), dim=0)

    # re-quantize the reduced shard and all-gather it
    scale2 = _scale(local_sum, group)
    q2 = _quant(local_sum, scale2)
    gathered = torch.empty(axis_size * q2.numel(), dtype=torch.int8,
                           device=q2.device)
    # torch 2.13 renames all_gather_into_tensor (and warns on the old
    # name); the card's older torch has only the old one
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(gathered, q2, group=group)
    out = _dequant(gathered, scale2)[:n].reshape(orig_shape)
    return out, err[:n].reshape(orig_shape)


def quantized_psum_tree(grads, group=None, axis_size: int = None):
    """``quantized_psum`` on every leaf of nested dicts (in sorted-key
    order on every rank); returns (summed tree, residual tree), each leaf
    in its input's dtype."""
    if isinstance(grads, dict):
        outs, errs = {}, {}
        for k in sorted(grads):
            outs[k], errs[k] = quantized_psum_tree(grads[k], group,
                                                   axis_size)
        return ({k: outs[k] for k in grads}, {k: errs[k] for k in grads})
    o, e = quantized_psum(grads, group, axis_size)
    return o.to(grads.dtype), e.to(grads.dtype)
