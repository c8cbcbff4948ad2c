"""Sharding rules for params, optimizer state, caches and batches, and the
local blocks they give each rank — the port of
``repro/parallel/sharding.py`` on ``torch.distributed``.

Strategy (the reference's DESIGN.md §5, rules copied as they are):
  - TP (Megatron-style) over the `model` axis: attention heads / FFN hidden /
    experts (EP) / vocab.
  - FSDP (ZeRO-3) over the `data` axis (and over `pod`×`data` on the
    multi-pod mesh): the *other* big dimension of every matrix.
  - Optimizer state inherits the parameter sharding.
  - KV caches: batch over `data`(×`pod`), kv-heads over `model` when the head
    count divides the axis (MQA kv=1 replicates over `model` — documented).
  - SSM states: batch over `data`, ssm-heads over `model`.

Rules are matched on the parameter path suffix; any dim whose size does not
divide its assigned axis falls back to replication on that dim.

The port has no ``jax.sharding.PartitionSpec``: a spec is a ``P``, a tuple
with one entry a dim (None, an axis name, or a tuple of axis names, the
first the major one), equal entry for entry to the reference's.  A mesh is
a ``torch.distributed`` ``DeviceMesh`` (``launch/mesh.py``) or any object
with the reference tests' ``axis_names`` and ``devices`` (the rules read
only the axis sizes).  Where the reference turns specs into
``NamedSharding``s (``to_named``) and lets XLA place the blocks,
``to_placements`` gives each spec's ``DeviceMesh`` placements (a
``Shard`` or ``Replicate`` a mesh axis), and torch's DTensor places the
blocks: ``shard_leaf`` cuts a full tensor to this rank's block of a spec,
``gather_leaf`` all-gathers the blocks back to the full tensor, and
``reduce_leaf`` sums a full-shaped gradient over the ranks that hold
other rows of the batch and keeps this rank's block (a reduce-scatter),
each collective on the ``DeviceMesh``'s group of one axis.  ``METER``
counts the bytes a rank hands to its collectives and the gathered
leaves it holds at once.  Under
Megatron ``tp`` over a ``model`` axis of more than one rank, ``tp_use``
says which leaves a rank computes on its ``model`` block of (gathered
over the other axes only, ``without_model``), which it uses in part and
which whole (``launch/steps.py``'s sharded step, ``parallel/tp.py``).
"""

from __future__ import annotations

import re
import threading
import weakref
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("data", "model"),)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


# ---------------------------------------------------------------------------
# the mesh's axes
# ---------------------------------------------------------------------------

def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> Tuple[int, ...]:
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return tuple(int(s) for s in mesh.mesh.shape)
    return tuple(int(s) for s in mesh.devices.shape)


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(axis_names(mesh), mesh_shape(mesh)))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= _axis_size(mesh, a)
        return n
    return mesh_shape(mesh)[axis_names(mesh).index(axis)]


def fsdp_axes(mesh):
    """FSDP shards over pod×data when a pod axis exists."""
    return ("pod", "data") if "pod" in axis_names(mesh) else "data"


def batch_axes(mesh):
    return ("pod", "data") if "pod" in axis_names(mesh) else "data"


# (path-suffix regex, spec builder).  `F` = fsdp axes, "model" = TP axis.
# Specs are written WITHOUT the leading scan axis; a leading stack dim is
# detected from rank and prepended as None.
def _param_rules(F):
    return [
        # embeddings / unembeddings
        (r"embed$",          lambda: P("model", F)),
        (r"unembed$",        lambda: P(F, "model")),
        # attention
        (r"attn/wq$",        lambda: P(F, "model")),
        (r"attn/wk$",        lambda: P(F, "model")),
        (r"attn/wv$",        lambda: P(F, "model")),
        (r"attn/wo$",        lambda: P("model", F)),
        (r"cross/w[qkv]$",   lambda: P(F, "model")),
        (r"cross/wo$",       lambda: P("model", F)),
        # MLA
        (r"attn/w_dq$",      lambda: P(F, None)),
        (r"attn/w_uq$",      lambda: P(None, "model")),
        (r"attn/w_dkv$",     lambda: P(F, None)),
        (r"attn/w_uk$",      lambda: P(None, "model")),
        (r"attn/w_uv$",      lambda: P(None, "model")),
        # dense MLP
        (r"mlp/w_gate$",     lambda: P(F, "model")),
        (r"mlp/w_up$",       lambda: P(F, "model")),
        (r"mlp/w_down$",     lambda: P("model", F)),
        # MoE (EP over model)
        (r"moe/router$",     lambda: P(F, None)),
        (r"moe/w_gate$",     lambda: P("model", F, None)),
        (r"moe/w_up$",       lambda: P("model", F, None)),
        (r"moe/w_down$",     lambda: P("model", None, F)),
        (r"shared/w_gate$",  lambda: P(F, "model")),
        (r"shared/w_up$",    lambda: P(F, "model")),
        (r"shared/w_down$",  lambda: P("model", F)),
        # RWKV6
        (r"blk/w_[rkvg]$",   lambda: P(F, "model")),
        (r"blk/w_o$",        lambda: P("model", F)),
        (r"blk/w_ck$",       lambda: P(F, "model")),
        (r"blk/w_cv$",       lambda: P("model", F)),
        (r"blk/w_cr$",       lambda: P(F, "model")),
        (r"blk/w_decay_a$",  lambda: P(F, None)),
        (r"blk/w_decay_b$",  lambda: P(None, "model")),
        # Mamba2
        (r"blk/w_in$",       lambda: P(F, "model")),
        (r"blk/w_out$",      lambda: P("model", F)),
        # frontends
        (r"frontend/proj1?$", lambda: P(F, "model")),
        (r"frontend/proj2$", lambda: P("model", F)),
    ]


def _flat_with_path(tree, prefix: str = ""):
    """(path, leaf) over nested dicts and named tuples (fields by name),
    keyed as the reference's ``_path_str`` keys a jax tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not isinstance(tree, P):
        items = zip(tree._fields, tree)
    else:
        yield prefix[:-1], tree
        return
    for k, v in items:
        yield from _flat_with_path(v, f"{prefix}{k}/")


def _map_with_path(fn, tree, prefix: str = ""):
    """``tree``'s structure with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not isinstance(tree, P):
        return type(tree)(*(_map_with_path(fn, v, f"{prefix}{k}/")
                            for k, v in zip(tree._fields, tree)))
    return fn(prefix[:-1], tree)


def _fits(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Replicate any dim whose size doesn't divide its axis."""
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is not None and dim % _axis_size(mesh, axis) == 0:
            out.append(axis)
        else:
            out.append(None)
    return P(*out)


def param_specs(params_aval: Any, cfg: ArchConfig, mesh) -> Any:
    """Spec tree matching the parameter tree (leaves may be meta tensors).

    tp_strategy="tp" (default): Megatron TP over `model` + FSDP over `data`.
    tp_strategy="dp_all": no tensor parallelism — pure ZeRO-3: every >=2-D
    parameter shards its largest non-stack dim over data x model (the batch
    also runs over both axes).  "dp_all_noep" ZeRO-shards the expert banks
    too, where "dp_all" keeps them expert-parallel over `model`."""
    F = fsdp_axes(mesh)
    if cfg.tp_strategy in ("dp_all", "dp_all_noep"):
        Fall = (F if isinstance(F, tuple) else (F,)) + ("model",)
        ep_rules = [] if cfg.tp_strategy == "dp_all_noep" else \
            [(pat, b) for pat, b in _param_rules(F)
             if pat.startswith(r"moe/")]

        def spec_dp(ps, leaf):
            shape = tuple(leaf.shape)
            if len(shape) < 2:
                return P()
            # MoE expert banks keep EP over `model` (tokens all-to-all to
            # the expert shards); ZeRO-gathering every expert per layer
            # would cost E/top_k more gather traffic than EP's dispatch.
            spec = None
            for pat, builder in ep_rules:
                if re.search(pat, ps):
                    spec = builder()
                    if len(shape) == len(spec) + 1:
                        spec = P(*((None,) + tuple(spec)))
                    elif len(shape) != len(spec):
                        spec = None
                    break
            if spec is None:
                big = max(range(len(shape)), key=lambda d: shape[d])
                sp = [None] * len(shape)
                sp[big] = Fall
                spec = P(*sp)
            return _fits(spec, shape, mesh)
        return _map_with_path(spec_dp, params_aval)

    rules = _param_rules(F)

    def spec_tp(ps, leaf):
        shape = tuple(leaf.shape)
        spec = None
        for pat, builder in rules:
            if re.search(pat, ps):
                spec = builder()
                break
        if spec is None:
            spec = P()                       # norms, biases, scalars: replicate
        else:
            # prepend None for a leading stack (layer) axis
            if len(shape) == len(spec) + 1:
                spec = P(*((None,) + tuple(spec)))
            elif len(shape) != len(spec):
                spec = P()
        return _fits(spec, shape, mesh)
    return _map_with_path(spec_tp, params_aval)


def tp_use(params_aval: Any, cfg: ArchConfig, mesh) -> Any:
    """How the sharded step uses each leaf's ``model`` block, a tree of
    the parameter tree's structure:

    - ``"local"``: the rank computes on its block (whole heads, hidden
      columns, experts or vocab rows), gathered over the other axes only;
      its gradient is the block's, reduced over the batch axes;
    - ``"part"``: gathered over ``model`` too (or replicated), and the rank
      uses only a part of it (K/V whose kv heads do not divide the axis;
      the replicated q/k/v biases; the untied unembedding's vocab
      columns): each rank's gradient is partial, and
      is summed over ``model`` as well before it is cut to the block;
    - ``"whole"``: gathered, and used whole on every rank with a gradient
      that is already equal on every ``model`` rank (the norms, the
      router, MLA's down projections; every leaf outside ``tp`` or on a
      ``model`` axis of one rank).

    Attention is head-parallel where the heads divide the axis; else it
    runs whole on every rank, as the reference's flash ``shard_map``
    falls back to replicated heads.  So are the recurrent blocks
    (``models/ssm.py``), over their H heads (RWKV6: d / K; Mamba2:
    d_inner / P), as the reference's WKV ``shard_map`` places them: where
    H divides the axis, RWKV6's r / k / v / g / o and decay-LoRA-out
    blocks and Mamba2's ``w_out`` rows are local, and the replicated
    leaves the rank's heads read from ("part") are its token-shift mixes
    and decay LoRA-in (x enters the time mix through one copy-in, so
    their gradients are each rank's heads' share), its decay base,
    bonus and group norm, and all of Mamba2's others: the packed
    ``w_in`` (the rank's z / x / dt columns and every rank's B / C),
    the conv over its x channels and B / C, A, dt bias, D and the gated
    norm's scale.  RWKV6's channel mix is an MLP over d_ff (``w_ck`` /
    ``w_cv`` local where d_ff divides), its ``w_cr`` and mixes whole;
    where H does not divide the axis, every time-mix (RWKV6) or every
    (Mamba2) ``blk`` leaf is whole."""
    model = axis_sizes(mesh).get("model", 1)
    if cfg.tp_strategy != "tp" or model == 1:
        return _map_with_path(lambda *_: "whole", params_aval)
    from repro_torch.models.moe import padded_num_experts
    kv = "part" if cfg.num_heads % model == 0 else "whole"
    vocab = "part" if cfg.vocab_size % model == 0 else "whole"
    mo = cfg.moe
    # (path-suffix regex, the units a block must hold whole, the use
    # where the axis does not divide them).  The untied unembedding's
    # rule cuts its d rows over `model` (the reference's `embed$` rule
    # matches it first), so it is gathered and each rank uses its
    # vocab columns
    rules = [
        (r"(^|/)embed$", cfg.vocab_size, "whole"),
        (r"(^|/)unembed$", 0, vocab),
        (r"(attn|cross)/w[qo]$|attn/w_u[qkv]$", cfg.num_heads, "whole"),
        (r"(attn|cross)/w[kv]$", cfg.num_kv_heads, kv),
        (r"(attn|cross)/b[qkv]$", 0, kv),
        (r"mlp/w_(gate|up|down)$", cfg.d_ff, "whole"),
        (r"moe/w_(gate|up|down)$", mo and padded_num_experts(cfg), "whole"),
        (r"shared/w_(gate|up|down)$",
         mo and mo.d_ff_expert * mo.num_shared_experts, "whole"),
        (r"frontend/proj[12]$", cfg.d_model, "whole"),
    ]
    if cfg.family == "ssm":
        from repro_torch.models.ssm import rwkv_num_heads
        heads = rwkv_num_heads(cfg)
        rules += [
            (r"blk/w_([rkvgo]|decay_b)$", heads, "whole"),
            (r"blk/(mu_[rkvwg]|w_decay_a|decay_base|bonus_u|ln_scale"
             r"|ln_bias)$", 0, "part" if heads % model == 0 else "whole"),
            (r"blk/w_c[kv]$", cfg.d_ff, "whole"),
        ]
    elif cfg.family == "hybrid":
        from repro_torch.models.ssm import mamba_dims
        heads = mamba_dims(cfg)[1]
        rules += [
            (r"blk/w_out$", heads, "whole"),
            (r"blk/(w_in|conv_w|conv_b|A_log|dt_bias|D|norm_scale)$", 0,
             "part" if heads % model == 0 else "whole"),
        ]

    def use(ps, _):
        for pat, units, other in rules:
            if re.search(pat, ps):
                return "local" if units and units % model == 0 else other
        return "whole"
    return _map_with_path(use, params_aval)


def without_model(spec: P) -> P:
    """``spec`` with the ``model`` axis taken out of every entry (the
    layout of a block that stays cut over ``model``)."""
    out = []
    for e in spec:
        axes = tuple(a for a in _entry_axes(e) if a != "model")
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return P(*out)


def _batch_entry(mesh, cfg: Optional[ArchConfig]):
    B_axes = batch_axes(mesh)
    if cfg is not None and cfg.tp_strategy.startswith("dp_all"):
        B_axes = (B_axes if isinstance(B_axes, tuple) else (B_axes,)) \
            + ("model",)
    return B_axes


def batch_specs(batch_aval: Any, mesh, cfg: Optional[ArchConfig] = None
                ) -> Any:
    """Shard the batch dim over pod×data (replicate if indivisible, e.g. B=1).
    Under tp_strategy="dp_all" the batch also shards over `model`."""
    B_axes = _batch_entry(mesh, cfg)

    def spec(_, leaf):
        s = P(*((B_axes,) + (None,) * (len(leaf.shape) - 1)))
        return _fits(s, tuple(leaf.shape), mesh)
    return _map_with_path(spec, batch_aval)


def cache_specs_tree(cache_aval: Any, cfg: ArchConfig, mesh) -> Any:
    """Shard decode caches: (L, B, S, heads, ...) -> B on data, heads on model."""
    B_axes = batch_axes(mesh)

    def spec_of(ps, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        if ps.endswith("pos") or ndim == 0:
            return P()
        if ps.endswith("length"):
            return _fits(P(None), shape, mesh)
        if ndim >= 4:
            # (L, B, S, KVH[, hd]) or states (L, B, H, ...)
            if "wkv" in ps or ("ssm" in ps and "layers" in ps):
                spec = P(None, B_axes, "model")
            elif ndim == 5:
                spec = P(None, B_axes, None, "model", None)
            else:
                spec = P(None, B_axes, None, None)
        elif ndim == 3:
            spec = P(None, B_axes, None)
        elif ndim == 2:
            spec = P(None, B_axes)
        else:
            spec = P(None)
        return _fits(spec, shape, mesh)
    return _map_with_path(spec_of, cache_aval)


def to_placements(specs: Any, mesh) -> Any:
    """The reference's ``to_named``: each spec of a tree as the placements
    of ``mesh``, one a mesh axis in the mesh's order: ``Shard(d)`` where
    the spec shards tensor dim d over the axis, else ``Replicate()`` (a
    dim over two axes is ``Shard(d)`` on both, the first the major)."""
    from torch.distributed.tensor import Replicate, Shard

    def place(_, spec):
        return tuple(next((Shard(d) for d, e in enumerate(spec)
                           if a in _entry_axes(e)), Replicate())
                     for a in axis_names(mesh))
    return _map_with_path(place, specs)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: P, mesh) -> Tuple[str, ...]:
    """The mesh axes a spec shards over, in the mesh's order."""
    used = {a for e in spec for a in _entry_axes(e)}
    return tuple(a for a in axis_names(mesh) if a in used)


def coordinate(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of a ``DeviceMesh``."""
    return dict(zip(axis_names(mesh), mesh.get_coordinate()))


# ---------------------------------------------------------------------------
# local blocks: what the reference's NamedShardings place.  DTensor cuts
# them; the collectives run one a mesh axis on the DeviceMesh's own group
# of that axis, through torch.distributed's eager calls (DTensor's
# functional collectives end both ranks with SIGSEGV over gloo on CUDA
# tensors, the layout that puts two ranks on one card)
# ---------------------------------------------------------------------------

def _placements(spec: P, mesh):
    """``to_placements`` of one spec, ``Replicate()`` on an axis of one
    rank (the same block, and no collective over that axis)."""
    from torch.distributed.tensor import Replicate
    sizes = axis_sizes(mesh)
    return tuple(p if sizes[a] > 1 else Replicate()
                 for a, p in zip(axis_names(mesh), to_placements(spec, mesh)))


def _sharded_axes(spec: P, mesh):
    """(axis, its group, its size, the tensor dim it cuts or None) for
    every axis of more than one rank, in the mesh's order."""
    from torch.distributed.tensor import Shard
    out = []
    for a, p in zip(axis_names(mesh), _placements(spec, mesh)):
        if axis_sizes(mesh)[a] > 1:
            out.append((a, mesh.get_group(a), axis_sizes(mesh)[a],
                        p.dim if isinstance(p, Shard) else None))
    return out


def shard_leaf(full: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``full`` (the same on every rank) under
    ``spec``: cut locally, no collective; a copy that owns its storage."""
    from torch.distributed.tensor import distribute_tensor
    local = distribute_tensor(full, mesh, _placements(spec, mesh),
                              src_data_rank=None).to_local()
    return local.clone(memory_format=torch.contiguous_format)


class Meter:
    """What a rank's collectives move and what its gathers hold:
    ``moved``, the bytes it hands to collectives (each all-gather's
    output, each reduce-scatter's input, each all-reduce's tensor); and
    ``live``, the bytes of the tensors ``gather_leaf`` gathered whose
    storage is still alive (a weakref finaliser on the storage, so that a
    view or a detached alias that autograd or checkpoint keeps counts),
    with ``high`` its high-water mark since ``reset``."""

    def __init__(self):
        # reentrant: a finaliser may run on a thread that holds it
        self._lock = threading.RLock()
        self.moved = self.live = self.high = 0

    def reset(self) -> None:
        with self._lock:
            self.moved, self.high = 0, self.live

    def collective(self, t: torch.Tensor) -> None:
        with self._lock:
            self.moved += t.numel() * t.element_size()

    def gathered(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        n = storage.nbytes()
        with self._lock:
            self.live += n
            self.high = max(self.high, self.live)
        weakref.finalize(storage, self._free, n)

    def _free(self, n: int) -> None:
        with self._lock:
            self.live -= n


METER = Meter()


def gather_leaf(local: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full tensor of a leaf held as blocks under ``spec``: an
    all-gather a sharded axis, the last (minor) axis first (``local``
    itself where no axis of more than one rank cuts it)."""
    import torch.distributed as dist
    t = local
    for _, group, n, d in reversed(_sharded_axes(spec, mesh)):
        if d is None:
            continue
        part = t.movedim(d, 0).contiguous()
        out = torch.empty((n * part.shape[0],) + tuple(part.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, part, group=group)
        METER.collective(out)
        t = out.movedim(0, d)
    if t is not local:
        METER.gathered(t)
    return t


def reduce_leaf(grad: torch.Tensor, spec: P, mesh,
                over: Tuple[str, ...]) -> torch.Tensor:
    """This rank's block under ``spec`` of the sum of ``grad`` (full-shaped,
    one on every rank) over the ranks that differ from it on ``over`` only
    (those that hold other rows of the batch), the first (major) axis
    first: a reduce-scatter on an axis in both, an all-reduce on one in
    ``over`` alone, a local cut on one in ``spec`` alone.  ``grad`` is
    left as it was, and the block owns its storage (no view keeps the
    full gradient alive)."""
    import torch.distributed as dist
    coords = coordinate(mesh)
    t, owned = grad, False
    for a, group, n, d in _sharded_axes(spec, mesh):
        if a in over and d is None:
            t = t.contiguous() if owned else \
                t.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(t, group=group)
            METER.collective(t)
            owned = True
        elif a in over:
            part = t.movedim(d, 0).contiguous()
            out = torch.empty((part.shape[0] // n,) + tuple(part.shape[1:]),
                              dtype=t.dtype, device=t.device)
            dist.reduce_scatter_tensor(out, part, group=group)
            METER.collective(part)
            t, owned = out.movedim(0, d), True
        elif d is not None:
            t, owned = t.chunk(n, dim=d)[coords[a]], False
    return t.contiguous() if owned else \
        t.clone(memory_format=torch.contiguous_format)


def sum_over(t: torch.Tensor, mesh, over: Tuple[str, ...]) -> torch.Tensor:
    """``t`` summed over the ranks that differ from this one on ``over``
    (an all-reduce a mesh axis; ``t`` itself where those are this rank
    alone)."""
    import torch.distributed as dist
    for a in axis_names(mesh):
        if a in over and axis_sizes(mesh)[a] > 1:
            t = t.clone()
            dist.all_reduce(t, group=mesh.get_group(a))
            METER.collective(t)
    return t


def counted_here(spec: P, mesh) -> bool:
    """Whether this rank counts its block of a leaf in a sum over ranks:
    the block is replicated over the axes the spec does not shard, and
    the rank at coordinate 0 on each of them counts it."""
    used = set(spec_axes(spec, mesh))
    return all(c == 0 for a, c in coordinate(mesh).items() if a not in used)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def shard_tree(tree, specs, mesh):
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda t, s: shard_leaf(t, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh):
    """Every leaf gathered to full, in the tree's sorted-key order on
    every rank (the order the collectives must agree on)."""
    order = [p for p, _ in sorted(_flat_with_path(tree))]
    flat = dict(_flat_with_path(tree))
    flat_s = dict(_flat_with_path(specs))
    full = {p: gather_leaf(flat[p], flat_s[p], mesh) for p in order}
    return _map_with_path(lambda p, _: full[p], tree)


def batch_shard_axes(global_batch: int, cfg: ArchConfig, mesh
                     ) -> Tuple[str, ...]:
    """The axes ``batch_specs`` shards a global batch's rows over, in the
    mesh's order: none where the batch does not divide them (every rank
    then holds every row)."""
    return _entry_axes(_fits(P(_batch_entry(mesh, cfg)), (global_batch,),
                             mesh)[0])


def local_batch_rows(global_batch: int, cfg: ArchConfig, mesh
                     ) -> Tuple[int, int, Tuple[str, ...]]:
    """(first row, rows, axes) of this rank's rows of a global batch under
    ``batch_specs``, the axes ``batch_shard_axes``'."""
    axes = batch_shard_axes(global_batch, cfg, mesh)
    sizes, coords = axis_sizes(mesh), coordinate(mesh)
    idx, n = 0, 1                 # mixed radix, the first axis the major
    for a in axes:
        idx, n = idx * sizes[a] + coords[a], n * sizes[a]
    rows = global_batch // n
    return idx * rows, rows, axes
