"""AdamW, a cosine schedule and global-norm clipping on nested dicts of
tensors — the port of ``repro/optim/adamw.py`` with its f32 arithmetic.

Optimizer state is ``AdamWState(step, m, v)``: the step an int32 scalar,
the moments dicts shaped like the parameters in ``state_dtype``.  Every
function returns new tensors and leaves its inputs as they were, as the
reference's pure functions do, but ``AdamW.update_``: the same numbers a
leaf at a time, written into the parameters' and the state's tensors,
as the reference's sharded step donates them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import torch

from repro_torch.models.modules import dtype_of


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts and named tuples (an
    ``AdamWState``) of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves in the reference's order (dict keys sorted, as jax's)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _scaled(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (x.float() * scale).to(x.dtype)


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """``tree`` scaled to at most ``max_norm``; ``norm`` is the tree's
    global norm where the caller has it (a sharded step's, over every
    rank's blocks)."""
    norm = global_norm(tree) if norm is None else norm
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: _scaled(x, scale), tree), norm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> Callable:
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(1.0, warmup)
        t = torch.clamp((step - warmup) / max(1.0, total - warmup), 0, 1)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                         (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


class AdamW:
    def __init__(self, lr: Union[Callable, float] = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 state_dtype: str = "float32"):
        self.lr = lr if callable(lr) else \
            (lambda _: torch.tensor(lr, dtype=torch.float32))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.state_dtype = dtype_of(state_dtype)

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.state_dtype,
                               device=p.device)
        device = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, norm=None
               ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        """One AdamW step; elementwise but for the clip, whose global norm
        a sharded step passes in (``norm``) for its local blocks."""
        step = state.step + 1
        grads, gnorm = clip_by_global_norm(grads, self.clip_norm, norm)
        m_new = tree_map(lambda g, m: self._ema(self.b1, m, g.float()),
                         grads, state.m)
        v_new = tree_map(lambda g, v: self._ema(
            self.b2, v, torch.square(g.float())), grads, state.v)
        lr, bc1, bc2 = self._schedule(step)
        updates = tree_map(lambda p, m, v: self._delta(p, m, v, lr, bc1, bc2),
                           params, m_new, v_new)
        return updates, AdamWState(step=step, m=m_new, v=v_new), \
            {"grad_norm": gnorm, "lr": lr}

    @torch.no_grad()
    def update_(self, grads: List[torch.Tensor], state: AdamWState, params,
                norm: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``update`` and ``apply_updates`` one leaf at a time, each result
        written into ``params``' and ``state``'s own tensors (their step
        too): every number is theirs, and the step holds no second copy of
        the parameters, the moments or the gradients.  ``grads`` are the
        leaves' gradients in ``tree_leaves`` order, each dropped from the
        list once its leaf is updated; ``norm`` their global norm.
        Returns ``update``'s metrics."""
        step = state.step + 1
        scale = _clip_scale(norm, self.clip_norm)
        lr, bc1, bc2 = self._schedule(step)
        for i, (p, m, v) in enumerate(zip(tree_leaves(params),
                                          tree_leaves(state.m),
                                          tree_leaves(state.v))):
            g = _scaled(grads[i], scale)
            grads[i] = None
            m.copy_(self._ema(self.b1, m, g.float()))
            v.copy_(self._ema(self.b2, v, torch.square(g.float())))
            del g
            p.add_(self._delta(p, m, v, lr, bc1, bc2))
        state.step.copy_(step)
        return {"grad_norm": norm, "lr": lr}

    def _ema(self, b: float, s: torch.Tensor, x: torch.Tensor
             ) -> torch.Tensor:
        return (b * s.float() + (1 - b) * x).to(self.state_dtype)

    def _schedule(self, step: torch.Tensor):
        """(lr, the two bias corrections) at ``step``, the step's number
        counted from 1."""
        lr = self.lr(step).to(step.device)
        f32 = dict(dtype=torch.float32, device=step.device)
        bc1 = 1 - torch.tensor(self.b1, **f32) ** step.float()
        bc2 = 1 - torch.tensor(self.b2, **f32) ** step.float()
        return lr, bc1, bc2

    def _delta(self, p, m, v, lr, bc1, bc2) -> torch.Tensor:
        d = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + self.eps)
        if p.dim() >= 2:     # decoupled weight decay on matrices only
            d = d + self.weight_decay * p.float()
        return (-lr * d).to(p.dtype)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def sgd_momentum(lr: float = 0.1, momentum: float = 0.9):
    """Tiny SGD with momentum (the reference's helper for the ADAPTNET
    trainers and tests): its state is an ``AdamWState`` with ``v=None``."""

    class SGD:
        def init(self, params):
            device = tree_leaves(params)[0].device
            return AdamWState(
                step=torch.zeros((), dtype=torch.int32, device=device),
                m=tree_map(torch.zeros_like, params), v=None)

        @torch.no_grad()
        def update(self, grads, state, params):
            m = tree_map(lambda g, m_: momentum * m_ + g, grads, state.m)
            updates = tree_map(lambda m_: -lr * m_, m)
            return updates, AdamWState(state.step + 1, m, None), {}

    return SGD()
