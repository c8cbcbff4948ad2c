"""Weights carried across from the reference's checkpoints.

``repro/checkpoint/manager.py`` writes one directory per step,
``step_<8 digits>/{manifest.json, data.npz}``, with every leaf under its
``/``-joined tree path (``layers/attn/wq`` is the (L, d, q_dim) stack of
every layer's query weight).  :func:`load_checkpoint` reads that layout
with numpy alone, and :func:`params_from_numpy` turns the flat leaves into
the port's parameter dict for a config, so both packages can run on the
same weights.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import dtype_of
from repro_torch.models.moe import padded_num_experts
from repro_torch.models.transformer import _is_moe_layer, num_dense_layers


def _steps(directory: Path):
    return sorted(int(p.name.split("_")[1]) for p in directory.glob("step_*")
                  if (p / "manifest.json").exists())


def load_checkpoint(directory, step: Optional[int] = None
                    ) -> Tuple[int, Dict[str, np.ndarray], dict]:
    """(step, {path: array}, metadata) of the latest (or given) step.
    Leaves the manifest records as bfloat16 (which numpy stores as raw
    2-byte records) come back as uint16 bit patterns; the manifest's
    dtypes say which, and :func:`params_from_numpy` reinterprets them."""
    d = Path(directory)
    steps = _steps(d)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {d}")
        step = steps[-1]
    sd = d / f"step_{step:08d}"
    manifest = json.loads((sd / "manifest.json").read_text())
    flat = {}
    with np.load(sd / "data.npz") as data:
        for k in data.files:
            a = data[k]
            if manifest["dtypes"].get(k) == "bfloat16":
                a = a.view(np.uint16)
            flat[k] = a
    return step, flat, manifest.get("metadata", {})


def _stack_shapes(prefix: str, n: int, cfg: ArchConfig,
                  moe: bool) -> Dict[str, tuple]:
    """Leaves of a stack of n decoder layers under ``prefix``."""
    d, H = cfg.d_model, cfg.num_heads
    shapes = {f"{prefix}/ln1": (n, d), f"{prefix}/ln2": (n, d)}
    a = f"{prefix}/attn"
    if cfg.attention_type == "mla":
        m = cfg.mla
        shapes.update({
            f"{a}/w_dq": (n, d, m.q_lora_rank),
            f"{a}/q_norm": (n, m.q_lora_rank),
            f"{a}/w_uq": (n, m.q_lora_rank,
                          H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
            f"{a}/w_dkv": (n, d, m.kv_lora_rank + m.qk_rope_head_dim),
            f"{a}/kv_norm": (n, m.kv_lora_rank),
            f"{a}/w_uk": (n, m.kv_lora_rank, H * m.qk_nope_head_dim),
            f"{a}/w_uv": (n, m.kv_lora_rank, H * m.v_head_dim),
            f"{a}/wo": (n, H * m.v_head_dim, d)})
    else:
        shapes.update({f"{a}/wq": (n, d, cfg.q_dim),
                       f"{a}/wk": (n, d, cfg.kv_dim),
                       f"{a}/wv": (n, d, cfg.kv_dim),
                       f"{a}/wo": (n, cfg.q_dim, d)})
        if cfg.use_bias:
            shapes.update({f"{a}/bq": (n, cfg.q_dim),
                           f"{a}/bk": (n, cfg.kv_dim),
                           f"{a}/bv": (n, cfg.kv_dim)})
    if moe:
        mo = cfg.moe
        E, f = padded_num_experts(cfg), mo.d_ff_expert
        fs = f * mo.num_shared_experts
        shapes.update({f"{prefix}/moe/router": (n, d, E),
                       f"{prefix}/moe/w_gate": (n, E, d, f),
                       f"{prefix}/moe/w_up": (n, E, d, f),
                       f"{prefix}/moe/w_down": (n, E, f, d)})
        if fs:
            shapes.update({f"{prefix}/moe/shared/w_gate": (n, d, fs),
                           f"{prefix}/moe/shared/w_up": (n, d, fs),
                           f"{prefix}/moe/shared/w_down": (n, fs, d)})
    else:
        shapes.update({f"{prefix}/mlp/w_gate": (n, d, cfg.d_ff),
                       f"{prefix}/mlp/w_up": (n, d, cfg.d_ff),
                       f"{prefix}/mlp/w_down": (n, cfg.d_ff, d)})
    return shapes


def _expected_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    L, d = cfg.num_layers, cfg.d_model
    nd = num_dense_layers(cfg)
    shapes = {"embed": (cfg.vocab_size, d), "ln_f": (d,)}
    if nd:
        shapes.update(_stack_shapes("dense_layers", nd, cfg, moe=False))
    shapes.update(_stack_shapes("layers", L - nd, cfg,
                                moe=_is_moe_layer(cfg, nd)))
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, cfg.vocab_size)
    return shapes


# leaves the reference draws in f32 whatever ``param_dtype`` is (its
# init_moe gives the router and the shared expert's w_down no dtype)
F32_LEAVES = ("moe/router", "moe/shared/w_down")


def _leaf_dtype(key: str, cfg: ArchConfig) -> torch.dtype:
    if key.endswith(F32_LEAVES):
        return torch.float32
    return dtype_of(cfg.param_dtype)


def _to_tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    if a.dtype == np.uint16 or a.dtype.kind == "V" or \
            a.dtype.name == "bfloat16":
        # bfloat16 bit patterns (raw or ml_dtypes): reinterpret, no rounding
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def params_from_numpy(flat: Dict[str, np.ndarray], cfg: ArchConfig,
                      device) -> Dict:
    """The port's parameter dict from the reference's flat leaves for a
    served ``cfg`` (dense GQA, or MoE with MLA), in ``cfg.param_dtype``
    (``F32_LEAVES`` in f32, as the reference draws them) on ``device``.
    Raises on a missing, unexpected or misshapen leaf."""
    want = _expected_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"checkpoint leaves do not match {cfg.name}: "
                       f"missing {missing}, unexpected {extra}")
    params: Dict = {}
    for key, shape in want.items():
        a = flat[key]
        if tuple(a.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(a.shape)} != {shape}")
        node = params
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = _to_tensor(a, _leaf_dtype(key, cfg), device)
    return params
