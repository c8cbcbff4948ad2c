"""Step builders: the train step (on one device, or sharded over a mesh),
the steps of a shape cell, and the model-FLOPs and compulsory-bytes
estimates — the port of ``repro/launch/steps.py``.

The train step takes the value and gradient of ``Model.loss`` with
autograd (every GEMM's dx/dw, each expert bank's dx/dw and the
flash-attention backward run through the hand-written kernels under the
active dispatch policy), then runs ``AdamW.update`` and
``apply_updates`` (on one device; a sharded step ``AdamW.update_``).  A
batch is ``{"tokens": (B, S + 1)}``, with ``"patch_embeds"`` (vlm) or
``"src_features"`` (encdec) passed through to the loss.

Over a mesh (``build_train_step(..., mesh=, global_batch=)``) each rank
holds the block of every parameter and of its AdamW moments that
``param_specs`` gives it and its rows of the global batch
(``batch_specs``).  Under ``dp_all*``, and under ``tp`` on a ``model``
axis of one rank, the step is FSDP / ZeRO-3 as the reference's GSPMD
runs it.  It gathers the leaves used outside the layer stacks whole
(the embedding, which tied is also the loss's unembedding, the untied
unembedding, the final norms, a frontend, zamba2's shared block), once
a step, in sorted order; the training loops take each stack's per-layer
slices of the rank's blocks once and gather a layer inside its remat'd
body (``parallel/fsdp.py``), so that a rank holds one gathered layer in
the forward and one again while the backward recomputes it, and the
layer's gradient is reduce-scattered onto the rank's block in the
backward.  Without ``cfg.remat`` the layers' GEMMs save their gathered
weights for the backward, and the saving is gone, as in the reference.
After the backward each whole leaf's gradient is reduced onto its block
(all-reduced where it is replicated), the clip's norm is taken over
every rank's distinct blocks, and AdamW runs a leaf at a time, writing
the new moments and parameters into the tensors the step was given and
dropping each gradient block as it goes (``AdamW.update_``).  So a rank
holds its blocks, their moments and their gradients, the whole leaves
with their gradients, and about one gathered layer, never the whole
tree; the step consumes its arguments and returns them updated, as the
reference's ``donate_argnums=(0, 1)`` does, and the loss's arithmetic
and every number are the whole-tree step's.  Under ``tp`` on a
``model`` axis of m > 1 ranks it is Megatron tensor parallelism as well
(``parallel/tp.py``): a leaf whose ``model`` block holds whole heads,
FFN hidden columns, experts or vocab rows is gathered over the other
axes only, and the rank computes on its block, all-reducing over
``model`` where Megatron does; every other leaf is gathered whole (a
layer's a layer at a time).  The recurrent blocks compute on a rank's
heads (``models/ssm.py``).  Each gradient is reduced by
``sharding.tp_use``: a block's over the batch axes, a leaf that a rank
uses only in part (K/V whose kv heads do not divide m, the q/k/v biases,
the untied unembedding's vocab columns, the recurrent blocks' per-head
and packed leaves) over ``model`` too.

``build_cell`` is the counterpart of the reference's ``lower_for_cell``:
where the reference lowers a cell's step against abstract inputs, it
builds the step with concrete seeded inputs on the device, ready to run
and time (``launch/profile.py``).  ``ShapeSpec`` lives in
``configs/shapes.py`` and is re-exported here.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import dispatch
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec, cache_specs, input_specs
from repro_torch.models.api import Model, build_model
from repro_torch.models.moe import padded_num_experts
from repro_torch.models.modules import (dtype_of, param_bytes,
                                       param_count, tensors)
from repro_torch.optim.adamw import AdamW, apply_updates, tree_map

__all__ = ["ShapeSpec", "Cell", "build_cell", "build_serve_parts",
           "build_train_step", "fill_cache", "make_optimizer",
           "model_flops_estimate", "model_min_bytes_estimate"]


@contextlib.contextmanager
def _dispatch_ctx(scope: str, execute: str = "auto",
                  registry: Optional[dispatch.SiteRegistry] = None):
    reg = registry if registry is not None else dispatch.default_registry()
    with dispatch.use(execute=execute, registry=reg), reg.scope(scope):
        yield reg


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the "useful work" numerator of a model-FLOPs share)
# ---------------------------------------------------------------------------

def _paths(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _matmul_param_count(cfg: ArchConfig, params) -> Tuple[float, float]:
    """(N_total_matmul, N_active_matmul): params participating in matmuls.

    Token-embedding gathers are excluded (untied); a tied table is counted
    once (it runs as the unembed matmul).  MoE expert banks are scaled by
    top-k/E for the active count.
    """
    total = 0.0
    routed = 0.0
    for ps, leaf in _paths(params):
        n = float(leaf.numel())
        if ps.endswith("embed") and not cfg.tie_embeddings:
            continue
        if "moe/w_" in ps or ("moe" in ps and ps.split("/")[-1].startswith("w_")
                              and "shared" not in ps):
            routed += n
        total += n
    active = total
    if cfg.moe is not None and routed > 0:
        frac = cfg.moe.experts_per_token / padded_num_experts(cfg)
        active = total - routed + routed * frac
    return total, active


def _attention_flops(cfg: ArchConfig, B: int, S: int, kind: str,
                     S_src: Optional[int] = None) -> float:
    """Score+value matmul FLOPs (not covered by 6ND).  MLA counts its
    expanded attention (qk_nope + qk_rope scores, v_head_dim values); an
    encdec model its bidirectional encoder over ``S_src`` frames and each
    decoder layer's S x S_src cross attention (``S_src`` defaults to S,
    the reference's assumption)."""
    S_src = S if S_src is None else S_src
    H, hd = cfg.num_heads, cfg.head_dim
    if cfg.attention_type == "none":
        return 0.0
    if cfg.attention_type == "mla":
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        per_pair = 2 * H * (qk + m.v_head_dim)
    else:
        per_pair = 4 * H * hd
    n_attn_layers = cfg.num_layers
    if cfg.shared_attn_every:
        n_attn_layers = cfg.num_layers // cfg.shared_attn_every
    if kind == "decode":
        fwd = per_pair * B * S * n_attn_layers
        if cfg.encoder_layers:
            fwd += per_pair * B * S_src * cfg.num_layers    # cross-attn
        return fwd
    pairs = B * S * S / 2                                   # causal self
    fwd = per_pair * pairs * n_attn_layers
    if cfg.encoder_layers:
        fwd += per_pair * B * S_src * S_src * cfg.encoder_layers  # encoder
        fwd += per_pair * B * S * S_src * cfg.num_layers    # cross: S x S_src
    return 3 * fwd if kind == "train" else fwd


def _ssm_flops(cfg: ArchConfig, B: int, S: int, kind: str) -> float:
    """Chunked-scan FLOPs of SSM blocks (not covered by 6ND)."""
    if cfg.ssm is None:
        return 0.0
    s = cfg.ssm
    n_ssm = cfg.num_layers
    if cfg.shared_attn_every:                 # hybrid: attn slots replace SSM
        n_ssm -= cfg.num_layers // cfg.shared_attn_every
    if s.kind == "mamba2":
        d_inner = s.expand * cfg.d_model
        H, P, N = (s.num_heads or d_inner // s.head_dim), s.head_dim, s.state_dim
        lc = s.chunk
        if kind == "decode":
            per_tok = 4.0 * N * H * P
        else:
            per_tok = 2.0 * lc * N + 2.0 * lc * H * P + 4.0 * N * H * P
    else:                                              # rwkv6
        d = cfg.d_model
        hd = s.head_dim
        lc = s.chunk
        if kind == "decode":
            per_tok = 4.0 * hd * d
        else:
            per_tok = 4.0 * hd * d + 2.0 * lc * d
    tokens = B * (1 if kind == "decode" else S)
    fwd = per_tok * tokens * n_ssm
    return 3.0 * fwd if kind == "train" else fwd


def model_flops_estimate(cfg: ArchConfig, params, shape: ShapeSpec,
                         src_len: Optional[int] = None) -> float:
    """6*N_active*D (train) / 2*N_active*D (inference) + attention/SSM
    FLOPs.  ``src_len``: the frontend's rows where they are not the
    reference's assumed ``seq_len``: an encdec model's source frames (its
    encoder's and frontend's parameters then count over B x src_len rows,
    its attention as :func:`_attention_flops` says), a vlm model's image
    rows (the decoder then runs over seq_len + src_len rows, the projector
    over src_len)."""
    _, n_active = _matmul_param_count(cfg, params)
    B, S = shape.global_batch, shape.seq_len
    tokens = B * (1 if shape.kind == "decode" else S)
    per = 6.0 if shape.kind == "train" else 2.0
    base = per * n_active * tokens
    if src_len is not None and shape.kind != "decode" and \
            cfg.family in ("encdec", "vlm"):
        front = sum(float(v.numel()) for k, v in _paths(params)
                    if k.split("/")[0] in ("enc_layers", "frontend"))
        dec_rows = tokens + (B * src_len if cfg.family == "vlm" else 0)
        base = per * ((n_active - front) * dec_rows + front * B * src_len)
        if cfg.family == "vlm":
            S += src_len
    return (base + _attention_flops(cfg, B, S, shape.kind, src_len)
            + _ssm_flops(cfg, B, S, shape.kind))


def model_min_bytes_estimate(cfg: ArchConfig, params, shape: ShapeSpec
                             ) -> float:
    """Compulsory HBM traffic per step, in bytes, at ``shape.global_batch``
    sequences — the floor of the roofline's memory term.

    train   : params fwd-read + bwd-read + update-write (param dtype)
              + grads write+read + AdamW m,v read+write (opt dtype)
              + one residual checkpoint per layer write (fwd) + read (bwd)
    prefill : params read once + KV-cache write + embeddings/logits touch
    decode  : params read once + KV-cache read (+1-token write, negligible)

    ``params`` may be abstract (``Model.init_abstract``).  The cache is
    ``cache_specs``' on the meta device; a cache that cannot be built
    raises, where the reference passes over one."""
    p_bytes = float(param_bytes(params))
    p_count = float(param_count(params))
    B, S = shape.global_batch, shape.seq_len
    act_b = dtype_of(cfg.compute_dtype).itemsize
    L = cfg.num_layers + cfg.encoder_layers
    d = cfg.d_model

    if shape.kind == "train":
        ob = dtype_of(cfg.opt_state_dtype).itemsize
        traffic = p_bytes * 3.0            # fwd read, bwd read, update write
        traffic += p_bytes * 2.0           # grads: write (bwd) + read (opt)
        traffic += p_count * ob * 4.0      # m, v: read + write each
        traffic += 2.0 * B * S * d * L * act_b   # residual ckpt: write + read
        return traffic

    cache_bytes = float(param_bytes(cache_specs(cfg, shape)))
    if shape.kind == "prefill":
        return p_bytes + cache_bytes + 2.0 * B * S * d * act_b
    # decode: whole cache is read once per emitted token
    return p_bytes + cache_bytes


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def make_optimizer(cfg: ArchConfig, lr: float = 3e-4) -> AdamW:
    return AdamW(lr=lr, state_dtype=cfg.opt_state_dtype)


def build_train_step(cfg: ArchConfig, lr: float = 3e-4,
                     device: Optional[str] = None, mesh=None,
                     global_batch: Optional[int] = None):
    """(model, train_step, optimizer); ``train_step(params, opt_state,
    batch) -> (params, opt_state, metrics)`` returns new tensors and
    leaves its arguments as they were.

    With a ``mesh``, (model, train_step, optimizer, (param specs,
    optimizer-state specs)): the step takes this rank's blocks
    (``parallel.sharding.shard_tree``) and its rows of a ``global_batch``
    (``local_batch_rows``), as the module docstring says, and consumes
    them: it writes the update into the blocks and the moments it was
    given and returns those same tensors (the reference's
    ``donate_argnums=(0, 1)``), so a caller that needs the old values
    keeps its own copy."""
    model: Model = build_model(cfg, device)
    opt = make_optimizer(cfg, lr)
    if mesh is not None:
        if global_batch is None:
            raise ValueError("a sharded train step needs the global batch")
        step, specs = _sharded_train_step(model, opt, mesh, global_batch)
        return model, step, opt, specs

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            loss, metrics = model.loss(leaves, batch)
            loss.backward()
        grads = tree_map(lambda p: p.grad, leaves)
        del leaves
        updates, opt_state, opt_metrics = opt.update(grads, opt_state,
                                                     params)
        del grads
        params = apply_updates(params, updates)
        metrics = {**{k: v.detach() for k, v in metrics.items()},
                   **opt_metrics, "loss": loss.detach()}
        return params, opt_state, metrics

    return model, train_step, opt


def _sharded_train_step(model: Model, opt: AdamW, mesh, global_batch: int):
    import torch.distributed as dist

    from repro_torch.models.transformer import AUX_KEYS
    from repro_torch.optim.adamw import AdamWState, tree_leaves
    from repro_torch.parallel import fsdp
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.hints import use_mesh

    cfg = model.cfg
    abstract = model.init_abstract()
    p_specs = sh.param_specs(abstract, cfg, mesh)
    o_specs = AdamWState(step=sh.P(), m=p_specs, v=p_specs)
    _, _, over = sh.local_batch_rows(global_batch, cfg, mesh)
    spec_leaves = tree_leaves(p_specs)
    # how each leaf's model block is used (all "whole" outside tp over a
    # model axis > 1): a block computed on locally stays cut over model
    use = dict(sh._flat_with_path(sh.tp_use(abstract, cfg, mesh)))
    g_specs = sh._map_with_path(
        lambda p, s: sh.without_model(s) if use[p] == "local" else s,
        p_specs)
    flat_g = dict(sh._flat_with_path(g_specs))
    over_of = {"local": over, "whole": over, "part": over + ("model",)}
    over_at = {p: over_of[u] for p, u in use.items()}
    # the layer stacks' leaves go a layer at a time, inside the remat'd
    # bodies; the others are gathered whole
    plan = fsdp.plan(g_specs, over_at, mesh)
    # the sums over the ranks that hold other rows (none: nothing to sum,
    # and the loss's arithmetic stays the one-device step's)
    count_fn = (lambda cnt: sh.sum_over(cnt, mesh, over)) if over else None

    def leaf(path, block):
        if path in plan.specs:
            return block.detach().requires_grad_(True)
        full = sh.gather_leaf(block, flat_g[path], mesh)
        # a gathered leaf is the loss's own (the meter sees its life)
        return (full.detach() if full is block else full).requires_grad_(
            True)

    def train_step(params, opt_state, batch):
        flat = dict(sh._flat_with_path(params))
        leaves = {p: leaf(p, flat[p]) for p in sorted(flat)}
        with torch.enable_grad(), use_mesh(mesh), fsdp.use_plan(plan):
            loss, metrics = model.loss(
                sh._map_with_path(lambda p, _: leaves[p], params), batch,
                count_fn=count_fn)
            loss.backward()
        # the graph goes with the loss; the stacks' gradients arrived as
        # blocks, each whole leaf's is reduced onto its block, and the
        # full leaf and its gradient go
        loss = loss.detach()
        metrics = {k: v.detach() for k, v in metrics.items()}
        grads = {}
        for path in sorted(flat):
            g = leaves.pop(path).grad
            grads[path] = g if path in plan.specs else sh.reduce_leaf(
                g, flat_g[path], mesh, over_at[path])
            del g
        grads = tree_leaves(sh._map_with_path(lambda p, _: grads[p],
                                              params))
        # the clip's norm: each distinct block counted once, summed over
        # every rank; it needs every block before any leaf is updated
        sq = sum(torch.sum(torch.square(g.float())) if
                 sh.counted_here(s, mesh) else
                 torch.zeros((), device=g.device)
                 for g, s in zip(grads, spec_leaves))
        dist.all_reduce(sq)
        sh.METER.collective(sq)
        opt_metrics = opt.update_(grads, opt_state, params, torch.sqrt(sq))
        # the cross-entropy, the aux metrics and the loss, each rank's sum
        # over the global count, summed over the ranks that hold other rows
        out = dict(metrics, loss=loss)
        for k in ("ce_loss", "loss") + AUX_KEYS:
            if k in out:
                out[k] = sh.sum_over(out[k], mesh, over)
        out = {**out, **opt_metrics, "loss": out["loss"]}
        return params, opt_state, out

    return train_step, (p_specs, o_specs)


# ---------------------------------------------------------------------------
# serve steps and whole cells
# ---------------------------------------------------------------------------

def build_serve_parts(cfg: ArchConfig, shape: ShapeSpec,
                      device: Optional[str] = None):
    """(model, abstract params, abstract cache) of a serve cell: the
    reference's parts without their shardings (a cell's step runs on one
    device; ``parallel.sharding.param_specs`` / ``cache_specs_tree`` give
    them for a mesh)."""
    model = build_model(cfg, device)
    return model, model.init_abstract(), cache_specs(cfg, shape)


@dataclass
class Cell:
    """One cell's step, built: ``fn()`` runs it once and leaves its
    inputs as they were, so it can be called again."""
    model: Model
    params: Any
    fn: Callable[[], Any]


def _seeded_inputs(cfg: ArchConfig, specs: Dict[str, Any], seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """Concrete inputs in ``specs``' shapes and dtypes: uniform tokens and
    standard-normal frontend features from a numpy generator."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, t in specs.items():
        if t.dtype == torch.int32:
            a = rng.integers(0, cfg.vocab_size, tuple(t.shape)).astype(
                np.int32)
        else:
            a = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        out[k] = torch.from_numpy(a).to(device=device, dtype=t.dtype)
    return out


def fill_cache(cache, rows: int, seed: int) -> None:
    """Fill a dense cache in place as if ``rows`` tokens had run: every
    floating leaf (K/V rows, cross K/V, recurrent states) standard normal
    from a generator seeded with ``seed``, every integer leaf (``pos``,
    the KV lengths) ``rows``.  Drawn one slice of the leading axis at a
    time, so the f32 draw of a bf16 leaf stays one layer's size."""
    gen = None
    for t in tensors(cache):
        if not t.is_floating_point():
            t.fill_(rows)
            continue
        if gen is None:
            gen = torch.Generator(device=t.device)
            gen.manual_seed(int(seed))
        for sl in (t if t.dim() > 1 else [t]):
            sl.copy_(torch.randn(sl.shape, generator=gen, device=t.device))


def build_cell(cfg: ArchConfig, shape: ShapeSpec, batch: int = 1,
               device: Optional[str] = None, seed: int = 0,
               lr: float = 3e-4) -> Cell:
    """The step of one (arch x shape) cell at ``batch`` sequences of the
    shape's length, with weights and inputs from ``seed`` on ``device``
    (the counterpart of the reference's ``lower_for_cell``):

    - train: ``build_train_step``'s step on (params, AdamW state, batch);
    - prefill: ``model.prefill`` of the prompts on a fresh cache of
      ``seq_len`` rows (GQA attends over the prompt's rows, the flash
      forward under ``attn_impl="pallas"``);
    - decode: one ``decode_step`` against a cache already filled to
      ``seq_len - 1`` rows with seeded values (the reference lowers
      against a full-capacity cache; no prefill runs to get there)."""
    specs = input_specs(cfg, shape, batch)
    S = shape.seq_len
    if shape.kind == "train":
        model, step, opt = build_train_step(cfg, lr, device)
        params = model.init(seed)
        opt_state = opt.init(params)
        data = _seeded_inputs(cfg, specs, seed + 1, model.device)
        return Cell(model, params, lambda: step(params, opt_state, data))
    model = build_model(cfg, device)
    params = model.init(seed)
    cache = model.init_cache(batch, S,
                             src_len=S if cfg.family == "encdec" else 0)
    if shape.kind == "prefill":
        data = _seeded_inputs(cfg, specs, seed + 1, model.device)

        def prefill():
            with torch.no_grad():
                return model.prefill(params, data, cache)
        return Cell(model, params, prefill)
    fill_cache(cache, S - 1, seed + 2)
    tokens = _seeded_inputs(cfg, specs, seed + 1, model.device)["tokens"]

    def decode():
        with torch.no_grad():
            return model.decode_step(params, tokens, cache)
    return Cell(model, params, decode)
