"""Gated feed-forward (SwiGLU / GeGLU) blocks."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import activation, dense, dense_init, dtype_of

Params = Dict[str, Any]


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, cfg: ArchConfig,
             lead=()) -> Params:
    """``lead`` prepends stacking axes (the layer axis) to every leaf."""
    dt = cfg.param_dtype
    lead = tuple(lead)
    return {
        "w_gate": dense_init(gen, lead + (d_model, d_ff), dt),
        "w_up": dense_init(gen, lead + (d_model, d_ff), dt),
        "w_down": dense_init(gen, lead + (d_ff, d_model), dt,
                             scale=1.0 / (d_ff ** 0.5 *
                                          (2 * cfg.num_layers) ** 0.5)),
    }


def mlp_apply(params: Params, x: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    act = activation(cfg.mlp_activation)
    g = act(dense(x, params["w_gate"], None, cdt, site="layer.mlp.gate"))
    u = dense(x, params["w_up"], None, cdt, site="layer.mlp.up")
    return dense(g * u, params["w_down"], None, cdt, site="layer.mlp.down")
