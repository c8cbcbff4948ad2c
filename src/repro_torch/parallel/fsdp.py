"""The sharded train step's per-layer gather: FSDP / ZeRO-3 as the
reference's GSPMD runs it, a layer at a time inside the remat'd scan
body.

A rank holds its block of every parameter (``parallel/sharding.py``).
The sharded step (``launch/steps.py``) gathers the leaves used outside
the layer stacks whole, once a step, and sets a ``Plan`` for the leaves
of the stacks (``STACKS``): the training loops of
``models/transformer.py`` take each stack's per-layer slices of the
rank's blocks once (``layer_slices``: one ``unbind`` a leaf, so autograd
assembles each stacked gradient once) and gather a layer's leaves inside
its remat'd body (``gather_layer``).  The gather is an autograd function:
its forward is ``sharding.gather_leaf`` of the slice to the leaf's
gather spec, its backward ``sharding.reduce_leaf`` of the layer's
gradient over the leaf's batch axes (the reduce-scatter onto the rank's
block).  Under ``cfg.remat`` a layer's gathered leaves live while the
layer runs and again while its backward recomputes it; without remat
the layer's GEMMs save them for the backward, and every layer stays
gathered until its backward has run.

A stacked leaf whose spec cuts its stack axis is gathered whole, as the
leaves outside the stacks are.  Every rank gathers the same layers in
the same order, forward, recomputed and backward, since the order is
the graph's, and no collective depends on a rank's data.

The plan is ambient, as the mesh is (``parallel/hints.py``): with none
(serving, the one-device step) ``gather_layer`` gives the layer as it
is, so those take the same slices and the same numbers.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.parallel import sharding as sh

# the stacked (layer-leading) subtrees the training loops walk
STACKS = ("dense_layers", "layers", "enc_layers")


class Plan(NamedTuple):
    """The leaves gathered a layer at a time: each one's path, its
    layer's gather spec (the leaf's, the stack entry dropped) and the
    mesh axes its gradient sums over."""
    mesh: Any
    specs: Dict[str, sh.P]
    over: Dict[str, Tuple[str, ...]]


def plan(gather_specs, over: Dict[str, Tuple[str, ...]], mesh) -> Plan:
    """The plan of a parameter tree's gather specs (``over``: each path's
    batch axes): every leaf of a stack whose spec leaves its stack axis
    whole."""
    specs = {}
    for path, spec in sh._flat_with_path(gather_specs):
        if path.split("/")[0] in STACKS and (not spec or spec[0] is None):
            specs[path] = sh.P(*spec[1:])
    return Plan(mesh, specs, {p: over[p] for p in specs})


_PLAN: Optional[Plan] = None


@contextlib.contextmanager
def use_plan(p: Optional[Plan]):
    global _PLAN
    prev = _PLAN
    _PLAN = p
    try:
        yield
    finally:
        _PLAN = prev


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, spec, over, mesh):
        ctx.spec, ctx.over, ctx.mesh = spec, over, mesh
        full = sh.gather_leaf(block, spec, mesh)
        return block.view_as(block) if full is block else full

    @staticmethod
    def backward(ctx, g):
        return sh.reduce_leaf(g, ctx.spec, ctx.mesh, ctx.over), None, None, \
            None


def layer_slices(stack) -> List[Dict[str, Any]]:
    """The per-layer parameter trees of a stacked subtree, each leaf cut
    once (``unbind``: views, with one backward that assembles the stacked
    gradient, where indexing a layer would build a zero-filled gradient of
    the whole stack for each)."""
    cut = sh._map_with_path(lambda _, v: v.unbind(0), stack)
    n = len(next(sh._flat_with_path(cut))[1])
    return [sh._map_with_path(lambda _, v, i=i: v[i], cut) for i in range(n)]


def gather_layer(lp, name: str):
    """Layer ``lp`` of the stack ``name`` with each leaf of the plan
    gathered (its gradient reduce-scattered in the backward); ``lp`` as
    it is with no plan."""
    p = _PLAN
    if p is None:
        return lp
    return sh._map_with_path(
        lambda path, v: _Gather.apply(v, p.specs[path], p.over[path], p.mesh)
        if path in p.specs else v, lp, f"{name}/")
