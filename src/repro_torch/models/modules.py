"""Parameter/module primitives as plain functions on tensors.

Params are nested dicts of tensors, shaped as the reference's pytrees
(per-layer leaves stacked on a leading layer axis), so a checkpoint of
either package maps key for key onto the other.  Initializers draw from an
explicit ``torch.Generator`` on the generator's device; they cannot
reproduce ``jax.random``'s numbers, so tests carry weights across through
``repro_torch.checkpoint`` instead.  Given a :class:`MetaGenerator` they
build the same tree on the meta device: shapes and dtypes, nothing drawn
or allocated (``Model.init_abstract``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return DTYPES[name]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

class MetaGenerator:
    """Stands in for an initializer's ``torch.Generator`` on the meta
    device, which has no generator of its own: the initializers read its
    ``device`` and draw nothing (:func:`draw_kw`)."""
    device = torch.device("meta")


def draw_kw(gen) -> dict:
    """The ``generator`` and ``device`` arguments of a draw from ``gen``;
    on the meta device only the device."""
    if gen.device.type == "meta":
        return {"device": gen.device}
    return {"generator": gen, "device": gen.device}


def truncated_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (inverse-CDF sampling), f32."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(shape, **draw_kw(gen)) * (hi - lo) + lo
    return torch.erfinv(u) * math.sqrt(2)


def dense_init(gen: torch.Generator, shape, dtype: str = "float32", *,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (fan-in) init of a (..., d_in, d_out) weight."""
    std = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    return (truncated_normal(gen, shape) * std).to(dtype_of(dtype))


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: str = "float32") -> torch.Tensor:
    w = torch.randn((vocab, d), **draw_kw(gen))
    return (w * (1.0 / math.sqrt(d))).to(dtype_of(dtype))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          compute_dtype: torch.dtype = torch.float32, *,
          site: str = "dense") -> torch.Tensor:
    """Every dense GEMM site goes through the SARA dispatch layer, which
    resolves its (M, K, N) -> tile config through the active dispatcher
    and runs the RSA GEMM kernel (repro_torch/dispatch).  ``site`` is the
    name recorded in the site registry.

    The reference casts both operands to ``compute_dtype``.  For bf16
    operands and an f32 compute type (the LM head) the port instead asks
    the GEMM for f32 output from the bf16 operands: the same arithmetic
    (a bf16 x bf16 product is exact in f32, and the sum is f32 either
    way) without copying the unembedding to f32 on every step."""
    from repro_torch import dispatch
    if compute_dtype == torch.float32 and x.dtype == w.dtype == \
            torch.bfloat16:
        y = dispatch.gemm(x, w, site=site, out_dtype=torch.float32)
    else:
        y = dispatch.gemm(x.to(compute_dtype), w.to(compute_dtype),
                          site=site)
    if b is not None:
        y = y + b.to(compute_dtype)
    return y


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in f32 (the population variance), result in x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name}")


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return logits
    return torch.tanh(logits / cap) * cap


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, heads, head_dim); positions: broadcastable to (..., S).
    Angles and rotation in f32, result in x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs     # (...,S,1,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x32 = x.float()
    x1, x2 = x32[..., :hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def tensors(tree):
    """The tensors of a tree of dicts, lists, tuples and NamedTuples (the
    reference's ``jax.tree_util.tree_leaves``, its ``None`` leaves
    dropped)."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def param_count(tree) -> int:
    return sum(int(t.numel()) for t in tensors(tree))


def param_bytes(tree) -> int:
    return sum(int(t.numel()) * t.element_size() for t in tensors(tree))
