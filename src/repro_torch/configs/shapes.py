"""The input-shape set and its abstract inputs — the port of
``repro/configs/shapes.py`` (``SHAPES``, ``LONG_CONTEXT_OK`` and
``shape_applicable`` copied as they are).

Every (architecture x shape) cell is defined by one of these shapes:

  train_4k     seq_len=4096    global_batch=256   -> the train step
  prefill_32k  seq_len=32768   global_batch=32    -> prefill
  decode_32k   seq_len=32768   global_batch=128   -> one decode step
                                                     (1 new token, 32K cache)
  long_500k    seq_len=524288  global_batch=1     -> one decode step; only
                                                     for sub-quadratic archs

The global batches are a 256-chip pod's.  One card runs a slice of a
shape: ``batch`` sequences of its length (``input_specs(..., batch=)``),
and a record names the batch it ran.

``input_specs`` and ``cache_specs`` return the model's inputs and its
dense cache as tensors on the meta device (shapes and dtypes, nothing
allocated) unless another device is named, matching the batch dicts the
model consumes.  The cache differs from the reference's in one leaf by
design: ``pos`` holds one int64 position a sequence, (B,), where the
reference keeps one int32 scalar for the batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import dtype_of


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# sub-quadratic (state-space) archs that can run long_500k
LONG_CONTEXT_OK = ("rwkv6-1.6b", "zamba2-7b")


def shape_applicable(cfg: ArchConfig, shape_name: str) -> bool:
    if shape_name in cfg.skip_shapes:
        return False
    if shape_name == "long_500k":
        return cfg.name in LONG_CONTEXT_OK or cfg.family in ("ssm", "hybrid")
    return True


def skip_reason(arch: str) -> str:
    """Why a cell that :func:`shape_applicable` rejects is skipped: the
    reference dry-run's text (``repro/launch/dryrun.py``)."""
    return ("long_500k needs sub-quadratic attention; "
            f"{arch} is full-attention (DESIGN.md §4)")


def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                batch: Optional[int] = None,
                device="meta") -> Dict[str, Any]:
    """The model inputs of this cell at ``batch`` sequences (the shape's
    global batch unless given), as empty tensors on ``device``.

    train  -> {"tokens": (B, S+1)} (+frontend features)
    prefill-> {"tokens": (B, S)}   (+frontend features)
    decode -> {"tokens": (B, 1)}   (the cache comes from cache_specs())
    """
    B = shape.global_batch if batch is None else int(batch)
    S = shape.seq_len
    n = {"train": S + 1, "prefill": S}.get(shape.kind, 1)
    specs: Dict[str, Any] = {"tokens": _empty((B, n), torch.int32, device)}
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.family == "vlm" and shape.kind != "decode":
        n_img = cfg.frontend.num_tokens
        specs["patch_embeds"] = _empty((B, n_img, cfg.frontend.feature_dim),
                                       cdt, device)
        # image tokens count against the sequence budget
        specs["tokens"] = _empty((B, n - n_img), torch.int32, device)
    if cfg.family == "encdec" and shape.kind != "decode":
        specs["src_features"] = _empty((B, S, cfg.frontend.feature_dim),
                                       cdt, device)
    return specs


def cache_specs(cfg: ArchConfig, shape: ShapeSpec,
                batch: Optional[int] = None, device="meta") -> Any:
    """``models/serving.py::init_cache`` of this cell on ``device``: a
    cache of ``seq_len`` rows a sequence (and as many cross rows for an
    encdec model)."""
    from repro_torch.models import serving
    B = shape.global_batch if batch is None else int(batch)
    S = shape.seq_len
    src = S if cfg.family == "encdec" else 0
    return serving.init_cache(cfg, B, torch.device(device), S, src)
