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


def _expected_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    L, d = cfg.num_layers, cfg.d_model
    shapes = {
        "embed": (cfg.vocab_size, d),
        "ln_f": (d,),
        "layers/ln1": (L, d),
        "layers/ln2": (L, d),
        "layers/attn/wq": (L, d, cfg.q_dim),
        "layers/attn/wk": (L, d, cfg.kv_dim),
        "layers/attn/wv": (L, d, cfg.kv_dim),
        "layers/attn/wo": (L, cfg.q_dim, d),
        "layers/mlp/w_gate": (L, d, cfg.d_ff),
        "layers/mlp/w_up": (L, d, cfg.d_ff),
        "layers/mlp/w_down": (L, cfg.d_ff, d),
    }
    if cfg.use_bias:
        shapes.update({"layers/attn/bq": (L, cfg.q_dim),
                       "layers/attn/bk": (L, cfg.kv_dim),
                       "layers/attn/bv": (L, cfg.kv_dim)})
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, cfg.vocab_size)
    return shapes


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
    dense GQA ``cfg``, in ``cfg.param_dtype`` on ``device``.  Raises on a
    missing, unexpected or misshapen leaf."""
    want = _expected_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"checkpoint leaves do not match {cfg.name}: "
                       f"missing {missing}, unexpected {extra}")
    dt = dtype_of(cfg.param_dtype)
    params: Dict = {}
    for key, shape in want.items():
        a = flat[key]
        if tuple(a.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(a.shape)} != {shape}")
        node = params
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = _to_tensor(a, dt, device)
    return params
