"""Pre-norm decoders (``repro/models/transformer.py``): parameters, the
layer bodies over a dense cache and over the paged arena, for the served
attention families (dense GQA; MoE with GQA, q/k/v biases and shared
experts, or with absorbed MLA and a leading stack of dense-MLP layers;
vlm, a vision-patch projector before a GQA decoder; encdec, a
bidirectional encoder over audio-frame features and a decoder with
cross-attention in every layer), the RWKV6 stack of the ssm family
(``_scan_rwkv``), the hybrid family's layout (zamba2: groups of Mamba2
blocks, each followed by one weight-shared attention + MLP block, then a
remainder of Mamba2 blocks), and the training forward pass and loss of
every one of them (the MoE layers' aux losses included; MLA through its
expanded full-sequence path).

Per-layer leaves are stacked on a leading layer axis, as in the reference
(``layers/attn/wq`` is (L, d, q_dim)); a layer's parameters are views of
those stacks.  A model with leading dense layers keeps them in a second
stack, ``dense_layers``, an encdec model its encoder in ``enc_layers``,
and a hybrid model its Mamba2 blocks in ``layers`` (stacked over the
Mamba slots) and its one shared block, unstacked, in ``shared_attn``, as
the reference does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (KVCache, cross_attention_kv,
                                          gqa_cross_attention,
                                          gqa_paged_decode,
                                          gqa_paged_prefill,
                                          gqa_paged_shared_decode,
                                          gqa_self_attention, init_gqa,
                                          init_mla, mla_paged_decode,
                                          mla_paged_prefill,
                                          mla_self_attention)
from repro_torch.models.mlp import init_mlp, mlp_apply
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.modules import (dense, dense_init, dtype_of,
                                        embed_init, rmsnorm)
from repro_torch.models.ssm import (MambaState, RWKVState,
                                    init_mamba_block, init_mamba_state,
                                    init_rwkv_block, init_rwkv_state,
                                    mamba_block_apply, mamba_heads,
                                    rwkv_block_apply, rwkv_heads)
from repro_torch.parallel import fsdp
from repro_torch.parallel import tp as tp_mod

Params = Dict[str, Any]


# the (family, attention) pairs the port serves, and those it trains
SERVED = (("dense", "gqa"), ("moe", "gqa"), ("moe", "mla"), ("vlm", "gqa"),
          ("encdec", "gqa"), ("ssm", "none"), ("hybrid", "gqa"))
TRAINED = SERVED
# the SSM block each recurrent family runs
SSM_KINDS = {"ssm": "rwkv6", "hybrid": "mamba2"}

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


def _check_family(cfg: ArchConfig) -> None:
    if (cfg.family, cfg.attention_type) not in SERVED:
        raise ValueError(f"the port serves {SERVED} (family, attention) "
                         f"decoders only, got family {cfg.family!r} / "
                         f"{cfg.attention_type!r}")
    if cfg.moe is not None and cfg.moe_every != 1:
        raise NotImplementedError("moe_every != 1 (stacks must be "
                                  "homogeneous)")
    kind = SSM_KINDS.get(cfg.family)
    if kind is not None and cfg.ssm.kind != kind:
        raise ValueError(f"the port's {cfg.family} family runs {kind} "
                         f"blocks, got {cfg.ssm.kind!r}")


def check_trained_family(cfg: ArchConfig) -> None:
    """Training (forward, loss, logits) is ported for every served (family,
    attention) pair: dense GQA, MoE with GQA or MLA (the aux losses, each
    expert bank's gradient as two bank launches, MLA through its expanded
    full-sequence path at hd 192 / hd_v 128), vlm (the patch projector's
    rows before the text), encdec (the bidirectional encoder and each
    layer's cross attention), the RWKV6 ssm family and the zamba2 hybrid.
    Full-sequence attention runs through the flash kernels
    (``attn_impl="pallas"``) or the blockwise route (``"xla"``), which
    autograd differentiates; the WKV scan through its kernel
    (``ssm_impl="pallas"``, the backward recomputed through the plain scan)
    or the plain scan; Mamba2's SSD scan is plain torch.  Anything else
    raises."""
    if (cfg.family, cfg.attention_type) not in TRAINED:
        raise NotImplementedError(
            f"the port trains {TRAINED} (family, attention) decoders only, "
            f"got {cfg.family!r} / {cfg.attention_type!r}")


def _is_moe_layer(cfg: ArchConfig, layer_idx: int) -> bool:
    if cfg.moe is None:
        return False
    if layer_idx < cfg.first_dense_layers:
        return False
    return (layer_idx - cfg.first_dense_layers) % cfg.moe_every == 0


def num_dense_layers(cfg: ArchConfig) -> int:
    """Leading layers kept in the ``dense_layers`` stack (MoE models only)."""
    return cfg.first_dense_layers if cfg.moe is not None else 0


def _init_stack(gen: torch.Generator, cfg: ArchConfig, n: int,
                moe: bool, cross: bool = False) -> Params:
    """n stacked decoder layers: attention (GQA or MLA) and MoE or MLP,
    with ``cross`` a cross-attention block and its norm as well."""
    zeros = dict(dtype=dtype_of(cfg.param_dtype), device=gen.device)
    d = cfg.d_model
    init_attn = init_mla if cfg.attention_type == "mla" else init_gqa
    p = {"ln1": torch.zeros((n, d), **zeros),
         "ln2": torch.zeros((n, d), **zeros),
         "attn": init_attn(gen, cfg, lead=(n,))}
    if moe:
        p["moe"] = init_moe(gen, cfg, lead=(n,))
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg, lead=(n,))
    if cross:
        p["ln_cross"] = torch.zeros((n, d), **zeros)
        p["cross"] = init_gqa(gen, cfg, lead=(n,))
    return p


def init_encoder_stack(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """The encdec encoder's ``cfg.encoder_layers`` stacked layers (the
    reference's ``init_encoder_layer``): GQA self-attention and a gated
    MLP, each behind an RMSNorm."""
    n, d = cfg.encoder_layers, cfg.d_model
    zeros = dict(dtype=dtype_of(cfg.param_dtype), device=gen.device)
    return {"ln1": torch.zeros((n, d), **zeros),
            "ln2": torch.zeros((n, d), **zeros),
            "attn": init_gqa(gen, cfg, lead=(n,)),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg, lead=(n,))}


def init_frontend(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """The modality frontend's projection: ``proj`` for audio frames, the
    2-layer ``proj1`` / ``proj2`` projector for vision patches."""
    fd, d, dt = cfg.frontend.feature_dim, cfg.d_model, cfg.param_dtype
    if cfg.frontend.kind == "audio_frames":
        return {"proj": dense_init(gen, (fd, d), dt)}
    return {"proj1": dense_init(gen, (fd, d), dt),
            "proj2": dense_init(gen, (d, d), dt)}


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random parameters for a served model, drawn from ``gen`` on
    ``gen.device``."""
    _check_family(cfg)
    dt = cfg.param_dtype
    L, d = cfg.num_layers, cfg.d_model
    zeros = dict(dtype=dtype_of(dt), device=gen.device)
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, d, dt),
        "ln_f": torch.zeros((d,), **zeros),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (d, cfg.vocab_size), dt)
    if cfg.frontend.kind in ("audio_frames", "vision_patches"):
        p["frontend"] = init_frontend(gen, cfg)
    if cfg.family == "ssm":
        p["layers"] = {"ln1": torch.zeros((L, d), **zeros),
                       "blk": init_rwkv_block(gen, cfg, lead=(L,))}
        return p
    if cfg.family == "hybrid":
        n_m = hybrid_layout(cfg)[0]
        p["layers"] = {"ln1": torch.zeros((n_m, d), **zeros),
                       "blk": init_mamba_block(gen, cfg, lead=(n_m,))}
        p["shared_attn"] = layer_params(_init_stack(gen, cfg, 1, moe=False),
                                        0)
        return p
    if cfg.family == "encdec":
        p["enc_layers"] = init_encoder_stack(gen, cfg)
        p["layers"] = _init_stack(gen, cfg, L, moe=False, cross=True)
        p["ln_enc"] = torch.zeros((d,), **zeros)
        return p
    nd = num_dense_layers(cfg)
    if nd:
        p["dense_layers"] = _init_stack(gen, cfg, nd, moe=False)
    p["layers"] = _init_stack(gen, cfg, L - nd, moe=_is_moe_layer(cfg, nd))
    return p


def hybrid_layout(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(Mamba layers, groups, Mamba layers a group, remainder): every
    ``shared_attn_every``-th of the ``num_layers`` slots is the shared
    attention block, the rest are Mamba2 blocks; the slots past the last
    whole group are the remainder's Mamba blocks."""
    k = cfg.shared_attn_every
    n_groups = cfg.num_layers // k
    per_group = k - 1
    rem = cfg.num_layers - n_groups * k
    return n_groups * per_group + rem, n_groups, per_group, rem


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _embed(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The token rows; vocab-parallel where the table is this rank's
    block of rows (Megatron ``tp``)."""
    e = params["embed"]
    tp = tp_mod.local(cfg, e.shape[0], cfg.vocab_size)
    if tp is not None:
        return tp_mod.vocab_embed(e, tokens, tp).to(
            dtype_of(cfg.compute_dtype))
    return e[tokens.long()].to(dtype_of(cfg.compute_dtype))


def _frontend_embed(params, feats: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    """Frontend features (B, n, feature_dim) projected into d_model: one
    GEMM for audio frames, GEMM, tanh-GELU, GEMM for vision patches."""
    cdt = dtype_of(cfg.compute_dtype)
    fe = params["frontend"]
    if cfg.frontend.kind == "audio_frames":
        return dense(feats, fe["proj"], None, cdt, site="frontend.proj")
    # Megatron tp: proj1's columns and proj2's rows of this rank's block
    tp = tp_mod.local(cfg, fe["proj1"].shape[-1], cfg.d_model)
    h = dense(tp_mod.copy_in(feats, tp), fe["proj1"], None, cdt,
              site="frontend.proj1")
    return tp_mod.reduce_out(dense(
        torch.nn.functional.gelu(h, approximate="tanh"), fe["proj2"], None,
        cdt, site="frontend.proj2"), tp)


def encode(params: Params, feats: torch.Tensor, cfg: ArchConfig,
           train: bool = False) -> torch.Tensor:
    """The encdec encoder over source features (B, S_src, feature_dim):
    the audio projection, the bidirectional layer stack (full-sequence
    self-attention from position 0: the flash kernels under
    ``attn_impl="pallas"``), the final RMSNorm; ``train`` puts each layer
    under ``_remat``, as the reference's training ``enc_body`` (a sharded
    step's gather of the layer inside it, ``parallel/fsdp.py``).  Returns
    (B, S_src, d)."""
    x = _frontend_embed(params, feats, cfg)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]

    def layer(lp, x):
        lp = fsdp.gather_layer(lp, "enc_layers")
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _ = gqa_self_attention(lp["attn"], h, pos, cfg, causal=False)
        x = x + a.to(x.dtype)
        h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return x + mlp_apply(lp["mlp"], h2, cfg).to(x.dtype)

    body = _remat(layer, cfg) if train else layer
    for lp in fsdp.layer_slices(params["enc_layers"]):
        x = body(lp, x)
    return rmsnorm(x, params["ln_enc"], cfg.norm_eps)


def _unembed_weight(params, cfg: ArchConfig) -> torch.Tensor:
    """(d, V): the tied embedding's transposed view (no copy), or the
    untied unembedding."""
    if cfg.tie_embeddings:
        return params["embed"].t()
    return params["unembed"]


def _cross(p: Params, x, enc_kv, cfg: ArchConfig) -> torch.Tensor:
    """The decoder layer's cross-attention block, added to x (none without
    ``enc_kv``)."""
    if enc_kv is None:
        return x
    hc = rmsnorm(x, p["ln_cross"], cfg.norm_eps)
    return x + gqa_cross_attention(p["cross"], hc, enc_kv, cfg).to(x.dtype)


def _ffn(p: Params, x, cfg: ArchConfig, with_aux: bool = False,
         batch_sum=None):
    """The layer's feed-forward half, added to x: MoE or the dense MLP.
    With ``with_aux``, (x, the MoE layer's aux metrics or zeros; see
    ``moe_aux`` for ``batch_sum``)."""
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    aux = _zero_aux(x.device)
    if "moe" in p:
        f = moe_apply(p["moe"], h2, cfg, with_aux=with_aux,
                      batch_sum=batch_sum)
        if with_aux:
            f, aux = f
    else:
        f = mlp_apply(p["mlp"], h2, cfg)
    x = x + f.to(x.dtype)
    return (x, aux) if with_aux else x


def decoder_layer_apply(p: Params, x, positions, cfg: ArchConfig, *,
                        cache=None, update_cache: bool = False,
                        enc_kv=None, fresh: bool = False, batch_sum=None):
    """One decoder layer over x (B, S, d): over a full sequence with no
    cache (training), or over a dense KV cache (prefill, decode; written
    in place), with the cross-attention block when ``enc_kv`` is given.
    ``fresh``: the cache holds no row yet (GQA attends over the new rows
    alone; see ``gqa_self_attention``).
    Returns (x, the layer's new cache or None, aux): a MoE layer's aux
    metrics over a full sequence (``batch_sum``: see ``moe_aux``), zeros
    for a dense layer and over a cache (serving, which drops them)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.attention_type == "mla":
        a, new_cache = mla_self_attention(p["attn"], h, positions, cfg,
                                          cache=cache,
                                          update_cache=update_cache)
    else:
        a, new_cache = gqa_self_attention(p["attn"], h, positions, cfg,
                                          cache=cache,
                                          update_cache=update_cache,
                                          fresh=fresh)
    x = _cross(p, x + a.to(x.dtype), enc_kv, cfg)
    if cache is None:
        x, aux = _ffn(p, x, cfg, with_aux=True, batch_sum=batch_sum)
        return x, None, aux
    return _ffn(p, x, cfg), new_cache, _zero_aux(x.device)


def paged_decoder_layer_apply(p: Params, x, positions, cfg: ArchConfig, *,
                              k_arena, v_arena, block_tables, kv_lens,
                              write_mask, enc_kv=None) -> torch.Tensor:
    """One decoder layer's batched single-token decode through the paged KV
    arena (see models/attention.py::gqa_paged_decode for the arena
    contract; the arena is written in place).  With MLA, k_arena/v_arena
    are the latent (c_kv, k_rope) pages; ``enc_kv`` (an encdec decoder's
    cross K/V, dense per lane) adds the cross-attention block.
    Returns x."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    paged = dict(block_tables=block_tables, kv_lens=kv_lens,
                 write_mask=write_mask)
    if cfg.attention_type == "mla":
        a = mla_paged_decode(p["attn"], h, positions, cfg, ckv_arena=k_arena,
                             krope_arena=v_arena, **paged)
    else:
        a = gqa_paged_decode(p["attn"], h, positions, cfg, k_arena=k_arena,
                             v_arena=v_arena, **paged)
    return _ffn(p, _cross(p, x + a.to(x.dtype), enc_kv, cfg), cfg)


def paged_shared_decoder_layer_apply(p: Params, x, positions,
                                     cfg: ArchConfig, *, k_arena, v_arena,
                                     block_tables, kv_lens, write_mask,
                                     prefix_pages, prefix_lens,
                                     unique_tables, unique_lens
                                     ) -> torch.Tensor:
    """Cascade-decode twin of :func:`paged_decoder_layer_apply`: attention
    over a shared page prefix runs once per step for every lane in the
    sharing group (models/attention.py::gqa_paged_shared_decode).  GQA
    only: absorbed MLA keeps the plain paged path, as in the reference.
    Returns x."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a = gqa_paged_shared_decode(
        p["attn"], h, positions, cfg, k_arena=k_arena, v_arena=v_arena,
        block_tables=block_tables, kv_lens=kv_lens, write_mask=write_mask,
        prefix_pages=prefix_pages, prefix_lens=prefix_lens,
        unique_tables=unique_tables, unique_lens=unique_lens)
    return _ffn(p, x + a.to(x.dtype), cfg)


def paged_prefill_layer_apply(p: Params, x, positions, cfg: ArchConfig, *,
                              k_arena, v_arena, block_tables, kv_lens,
                              chunk_lens) -> torch.Tensor:
    """One decoder layer's chunked-prefill pass through the paged KV arena
    (see models/attention.py::gqa_paged_prefill; the arena is written in
    place).  Returns x."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    paged = dict(block_tables=block_tables, kv_lens=kv_lens,
                 chunk_lens=chunk_lens)
    if cfg.attention_type == "mla":
        a = mla_paged_prefill(p["attn"], h, positions, cfg,
                              ckv_arena=k_arena, krope_arena=v_arena, **paged)
    else:
        a = gqa_paged_prefill(p["attn"], h, positions, cfg, k_arena=k_arena,
                              v_arena=v_arena, **paged)
    return _ffn(p, x + a.to(x.dtype), cfg)


def _scan_rwkv(params: Params, x, cfg: ArchConfig,
               states: RWKVState) -> Tuple[torch.Tensor, RWKVState]:
    """The RWKV6 layer loop (the reference's ``lax.scan``): each layer's
    pre-norm block from its slice of the layer-stacked ``states``.
    Returns (x, the new states stacked again)."""
    new = []
    for i in range(params["layers"]["ln1"].shape[0]):
        lp = layer_params(params["layers"], i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        y, st = rwkv_block_apply(lp["blk"], h, cfg,
                                 RWKVState(*(t[i] for t in states)))
        x = x + y.to(x.dtype)
        new.append(st)
    return x, RWKVState(*(torch.stack(f) for f in zip(*new)))


def _mamba_layer(lp: Params, x, cfg: ArchConfig, st: MambaState):
    """One pre-norm Mamba2 layer: (x + block(rmsnorm(x)), new state)."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    y, st = mamba_block_apply(lp["blk"], h, cfg, st)
    return x + y.to(x.dtype), st


def _scan_mamba_span(layers: Params, lo: int, hi: int, x, cfg: ArchConfig,
                     states: MambaState) -> Tuple[torch.Tensor,
                                                  List[MambaState]]:
    """Mamba layers lo..hi-1 of the stacked ``layers``, each from its slice
    of the layer-stacked ``states``.  Returns (x, their new states)."""
    new = []
    for i in range(lo, hi):
        x, st = _mamba_layer(layer_params(layers, i), x, cfg,
                             MambaState(*(t[i] for t in states)))
        new.append(st)
    return x, new


def run_hybrid_stack(params: Params, x, positions, cfg: ArchConfig,
                     states: MambaState, attn: KVCache
                     ) -> Tuple[torch.Tensor, MambaState, KVCache]:
    """The hybrid stack over x from a cache (the reference's
    ``_run_hybrid_stack``): each group's Mamba span from its states, then
    the shared attention + MLP block over the group's own slice of the
    ``n_groups``-stacked KV cache (written in place); then the remainder.
    Returns (x, the new Mamba states stacked again, the KV cache with the
    new lengths)."""
    n_m, n_groups, per_group, rem = hybrid_layout(cfg)
    lp, shared = params["layers"], params["shared_attn"]
    new: List[MambaState] = []
    lengths = []
    for g in range(n_groups):
        x, st = _scan_mamba_span(lp, g * per_group, (g + 1) * per_group, x,
                                 cfg, states)
        new += st
        x, c, _ = decoder_layer_apply(
            shared, x, positions, cfg,
            cache=KVCache(attn.k[g], attn.v[g], attn.length[g]))
        lengths.append(c.length)
    x, st = _scan_mamba_span(lp, n_m - rem, n_m, x, cfg, states)
    new += st
    return (x, MambaState(*(torch.stack(f) for f in zip(*new))),
            KVCache(attn.k, attn.v, torch.stack(lengths)))


# ---------------------------------------------------------------------------
# training forward pass (no cache) and loss
# ---------------------------------------------------------------------------

def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), device=device) for k in AUX_KEYS}


def _remat(fn, cfg: ArchConfig):
    """``fn`` checkpointed (its activations recomputed in the backward
    pass) under ``cfg.remat``, as the reference's ``_maybe_remat``.  Its
    arguments are a layer's slices of the rank's blocks, and a sharded
    step gathers the layer inside ``fn`` (``parallel/fsdp.py``), so that
    checkpoint keeps no gathered leaf alive.  A recomputed region runs its
    collectives again (the layer's gathers; Megatron ``tp``'s
    all-reduces): every rank recomputes the same regions in the same
    order, and no collective depends on a rank's data."""
    if not cfg.remat:
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _decoder_stack(params: Params, x, positions, cfg: ArchConfig,
                   enc_out=None, batch_sum=None):
    """The layer loop of the reference's ``_scan_decoder`` (the
    ``dense_layers`` stack first), each layer under ``_remat``, the aux
    metrics summed over the layers (``batch_sum``: see ``moe_aux``); with
    ``enc_out`` (encdec) each layer first projects its cross K/V from it,
    inside its remat, as the reference's ``dec_body``.  Returns (x,
    aux)."""
    def layer(lp, h, enc, name):
        lp = fsdp.gather_layer(lp, name)
        enc_kv = None if enc is None else cross_attention_kv(lp["cross"],
                                                             enc, cfg)
        h, _, a = decoder_layer_apply(lp, h, positions, cfg, enc_kv=enc_kv,
                                      batch_sum=batch_sum)
        return h, a

    body = _remat(layer, cfg)
    aux = _zero_aux(x.device)
    for name in ("dense_layers", "layers"):
        if name not in params:
            continue
        for lp in fsdp.layer_slices(params[name]):
            x, a = body(lp, x, enc_out, name)
            aux = {k: aux[k] + a[k] for k in AUX_KEYS}
    return x, aux


def _rwkv_stack(params: Params, x, cfg: ArchConfig):
    """The RWKV6 layers from zero states (the reference's training
    ``_scan_rwkv``; over the heads the leaves hold, a rank's under
    Megatron ``tp``), each layer under ``_remat``."""
    def layer(lp, h):
        lp = fsdp.gather_layer(lp, "layers")
        zero = init_rwkv_state(cfg, h.shape[0], h.dtype, h.device,
                               heads=rwkv_heads(lp["blk"], cfg))
        return h + rwkv_block_apply(lp["blk"], rmsnorm(
            h, lp["ln1"], cfg.norm_eps), cfg, zero)[0].to(h.dtype)

    body = _remat(layer, cfg)
    for lp in fsdp.layer_slices(params["layers"]):
        x = body(lp, x)
    return x


def _hybrid_stack(params: Params, x, positions, cfg: ArchConfig):
    """The reference's training ``_hybrid_forward`` from zero states and no
    cache (over the heads the leaves hold, a rank's under Megatron
    ``tp``): each group (its Mamba span, then the shared block) under
    ``_remat``, then each remainder layer under it.  A sharded step
    gathers a group's layers inside its remat (the slices are taken
    outside), so a group's recompute holds its ``per_group`` layers."""
    n_m, n_groups, per_group, rem = hybrid_layout(cfg)
    slices, shared = fsdp.layer_slices(params["layers"]), params["shared_attn"]

    def mamba(lp, h):
        lp = fsdp.gather_layer(lp, "layers")
        zero = init_mamba_state(cfg, h.shape[0], h.dtype, h.device,
                                heads=mamba_heads(lp["blk"], cfg))
        return _mamba_layer(lp, h, cfg, zero)[0]

    def group(h, g):
        for lp in slices[g * per_group:(g + 1) * per_group]:
            h = mamba(lp, h)
        return decoder_layer_apply(shared, h, positions, cfg)[0]

    group = _remat(group, cfg)
    for g in range(n_groups):
        x = group(x, g)
    layer = _remat(mamba, cfg)
    for lp in slices[n_m - rem:]:
        x = layer(lp, x)
    return x


def forward(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ArchConfig, batch_sum=None
            ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Training/eval forward (no cache).  ``batch["tokens"]`` (B, S + 1);
    vlm also takes ``batch["patch_embeds"]`` (B, n_img, feature_dim),
    projected and prepended to the text (predictions over the text only),
    and encdec ``batch["src_features"]`` (B, S_src, feature_dim), run
    through the encoder (each layer under remat) for every decoder layer's
    cross attention.  ``batch_sum``: a MoE layer's aux metrics as this
    rank's terms of the whole batch's (see ``moe_aux``).  Returns (hidden
    (B, S, d) after the final norm, aux, loss mask (B, S)); logits are not
    materialised here."""
    check_trained_family(cfg)
    tokens = batch["tokens"]
    x = _embed(params, tokens[:, :-1], cfg)
    n_img = 0
    aux = _zero_aux(x.device)
    if cfg.family == "vlm":
        img = _frontend_embed(params, batch["patch_embeds"], cfg)
        n_img = img.shape[1]
        x = torch.cat([img, x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if cfg.family == "ssm":
        x = _rwkv_stack(params, x, cfg)
    elif cfg.family == "hybrid":
        x = _hybrid_stack(params, x, positions, cfg)
    else:
        enc_out = encode(params, batch["src_features"], cfg, train=True) \
            if cfg.family == "encdec" else None
        x, aux = _decoder_stack(params, x, positions, cfg, enc_out,
                                batch_sum)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)[:, n_img:]
    mask = torch.ones(tuple(tokens[:, 1:].shape), dtype=torch.float32,
                      device=x.device)
    return x, aux, mask


def _chunk_loss(h, y, m, w, tp=None):
    logits = dense(h, w, None, torch.float32, site="loss.unembed")
    if tp is not None:                  # this rank's block of the vocab
        return (tp_mod.vocab_ce(logits, y, tp) * m).sum(), m.sum()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    return ((lse - gold) * m).sum(), m.sum()


def chunked_ce_loss(params: Params, hidden, labels, mask,
                    cfg: ArchConfig, count_fn=None) -> torch.Tensor:
    """Sequence-chunked cross-entropy: the (B, S, V) logits are never
    materialised at once, and each chunk's logits are recomputed in the
    backward pass (checkpointed, as the reference's ``jax.checkpoint``).
    hidden (B, S, d); labels (B, S) int; mask (B, S).  ``count_fn`` maps
    the mask's count to the denominator: a sharded step's rank divides its
    own sum by the count over every rank's rows, so that the ranks'
    gradients sum to the one-device gradient.  Under Megatron ``tp`` the
    cross-entropy is vocab-parallel: each rank's logits over its block of
    the vocab (the tied table's block of rows, or its columns of the
    gathered unembedding), the hidden state through ``copy_in``."""
    w = _unembed_weight(params, cfg)
    tp = tp_mod.context(cfg)
    if tp is not None and cfg.vocab_size % tp.size == 0:
        w = tp_mod.cols(w, cfg.vocab_size // tp.size, tp)
        hidden = tp_mod.copy_in(hidden, tp)
    else:
        tp = None
    B, S, _ = hidden.shape
    c = min(cfg.loss_chunk, S)
    n = -(-S // c)
    pad = n * c - S
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for i in range(n):
        rows = slice(i * c, (i + 1) * c)
        l, k = checkpoint(_chunk_loss, hidden[:, rows], labels[:, rows],
                          mask[:, rows], w, tp, use_reentrant=False)
        tot = tot + l
        cnt = cnt + k
    if count_fn is not None:
        cnt = count_fn(cnt.detach())
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params: Params, batch, cfg: ArchConfig,
            moe_loss_weight: float = 0.01, z_loss_weight: float = 1e-4,
            count_fn=None):
    """(total loss, metrics) as the reference's ``loss_fn``: the
    cross-entropy (its denominator through ``count_fn``, as
    :func:`chunked_ce_loss` says), plus the weighted load-balance and z
    losses of a MoE model (``count_fn`` sums them over the ranks that
    hold other rows, as ``moe_aux``'s ``batch_sum``)."""
    hidden, aux, mask = forward(params, batch, cfg, count_fn)
    labels = batch["tokens"][:, 1:]
    loss = chunked_ce_loss(params, hidden, labels, mask, cfg, count_fn)
    total = loss
    if cfg.moe is not None:
        total = total + moe_loss_weight * aux["moe_lb_loss"] + \
            z_loss_weight * aux["moe_z_loss"]
    return total, {"ce_loss": loss, **aux}


def logits(params: Params, batch, cfg: ArchConfig) -> torch.Tensor:
    """Full (B, S, V) f32 logits, for small-scale evaluation and tests."""
    hidden, _, _ = forward(params, batch, cfg)
    return dense(hidden, _unembed_weight(params, cfg), None, torch.float32,
                 site="unembed")
