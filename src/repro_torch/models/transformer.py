"""Pre-norm decoders (``repro/models/transformer.py``): parameters, the
layer bodies over a dense cache and over the paged arena, for the served
attention families (dense GQA; MoE with GQA, q/k/v biases and shared
experts, or with absorbed MLA and a leading stack of dense-MLP layers;
vlm, a vision-patch projector before a GQA decoder; encdec, a
bidirectional encoder over audio-frame features and a decoder with
cross-attention in every layer), the RWKV6 stack of the ssm family
(``_scan_rwkv``), and the training forward pass and loss of the dense GQA
family.

Per-layer leaves are stacked on a leading layer axis, as in the reference
(``layers/attn/wq`` is (L, d, q_dim)); a layer's parameters are views of
those stacks.  A model with leading dense layers keeps them in a second
stack, ``dense_layers``, and an encdec model its encoder in
``enc_layers``, as the reference does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (gqa_cross_attention,
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
from repro_torch.models.ssm import (RWKVState, init_rwkv_block,
                                    rwkv_block_apply)

Params = Dict[str, Any]


# the (family, attention) pairs the port serves, and those it trains
SERVED = (("dense", "gqa"), ("moe", "gqa"), ("moe", "mla"), ("vlm", "gqa"),
          ("encdec", "gqa"), ("ssm", "none"))
TRAINED = (("dense", "gqa"),)

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


def _check_family(cfg: ArchConfig) -> None:
    if (cfg.family, cfg.attention_type) not in SERVED:
        raise ValueError(f"the port serves {SERVED} (family, attention) "
                         f"decoders only, got family {cfg.family!r} / "
                         f"{cfg.attention_type!r}")
    if cfg.moe is not None and cfg.moe_every != 1:
        raise NotImplementedError("moe_every != 1 (stacks must be "
                                  "homogeneous)")
    if cfg.family == "ssm" and cfg.ssm.kind != "rwkv6":
        raise ValueError(f"the port's ssm family is RWKV6, got "
                         f"{cfg.ssm.kind!r}")


def check_trained_family(cfg: ArchConfig) -> None:
    """Training (forward, loss, logits) is ported for dense GQA only, with
    full-sequence attention through the flash kernels (``attn_impl=
    "pallas"``) or the blockwise route (``"xla"``), which autograd
    differentiates."""
    if (cfg.family, cfg.attention_type) not in TRAINED:
        raise NotImplementedError(
            f"the port trains {TRAINED} (family, attention) decoders only, "
            f"got {cfg.family!r} / {cfg.attention_type!r} (ROADMAP queue 1)")


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


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _embed(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))


def _frontend_embed(params, feats: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    """Frontend features (B, n, feature_dim) projected into d_model: one
    GEMM for audio frames, GEMM, tanh-GELU, GEMM for vision patches."""
    cdt = dtype_of(cfg.compute_dtype)
    fe = params["frontend"]
    if cfg.frontend.kind == "audio_frames":
        return dense(feats, fe["proj"], None, cdt, site="frontend.proj")
    h = dense(feats, fe["proj1"], None, cdt, site="frontend.proj1")
    return dense(torch.nn.functional.gelu(h, approximate="tanh"),
                 fe["proj2"], None, cdt, site="frontend.proj2")


def encode(params: Params, feats: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    """The encdec encoder over source features (B, S_src, feature_dim):
    the audio projection, the bidirectional layer stack (full-sequence
    self-attention from position 0: the flash kernels under
    ``attn_impl="pallas"``), the final RMSNorm.  Returns (B, S_src, d)."""
    x = _frontend_embed(params, feats, cfg)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    enc = params["enc_layers"]
    for i in range(enc["ln1"].shape[0]):
        lp = layer_params(enc, i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _ = gqa_self_attention(lp["attn"], h, pos, cfg, causal=False)
        x = x + a.to(x.dtype)
        h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h2, cfg).to(x.dtype)
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


def _ffn(p: Params, x, cfg: ArchConfig) -> torch.Tensor:
    """The layer's feed-forward half, added to x: MoE or the dense MLP."""
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    f = moe_apply(p["moe"], h2, cfg) if "moe" in p else \
        mlp_apply(p["mlp"], h2, cfg)
    return x + f.to(x.dtype)


def decoder_layer_apply(p: Params, x, positions, cfg: ArchConfig, *,
                        cache=None, update_cache: bool = False,
                        enc_kv=None):
    """One decoder layer over x (B, S, d): over a full sequence with no
    cache (training), or over a dense KV cache (prefill, decode; written
    in place), with the cross-attention block when ``enc_kv`` is given.
    Returns (x, the layer's new cache or None, aux); the port's MoE
    computes no aux losses, so aux is zeros as for a dense layer."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.attention_type == "mla":
        a, new_cache = mla_self_attention(p["attn"], h, positions, cfg,
                                          cache=cache,
                                          update_cache=update_cache)
    else:
        a, new_cache = gqa_self_attention(p["attn"], h, positions, cfg,
                                          cache=cache,
                                          update_cache=update_cache)
    x = _cross(p, x + a.to(x.dtype), enc_kv, cfg)
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


# ---------------------------------------------------------------------------
# training forward pass (no cache) and loss
# ---------------------------------------------------------------------------

def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), device=device) for k in AUX_KEYS}


def _decoder_stack(params: Params, x, positions, cfg: ArchConfig):
    """The layer loop of the reference's ``_scan_decoder``; with
    ``cfg.remat`` each layer is checkpointed (its activations recomputed
    in the backward pass), as ``_maybe_remat`` does."""
    def body(layer_p, h):
        return decoder_layer_apply(layer_p, h, positions, cfg)[0]

    for i in range(params["layers"]["ln1"].shape[0]):
        lp = layer_params(params["layers"], i)
        x = checkpoint(body, lp, x, use_reentrant=False) if cfg.remat \
            else body(lp, x)
    return x


def forward(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ArchConfig) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Training/eval forward (no cache) of a dense decoder.  Returns
    (hidden (B, S, d) after the final norm, aux, loss mask (B, S)), with S
    = tokens.shape[1] - 1; logits are not materialised here."""
    check_trained_family(cfg)
    tokens = batch["tokens"]
    x = _embed(params, tokens[:, :-1], cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _decoder_stack(params, x, positions, cfg)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    mask = torch.ones(tuple(tokens[:, 1:].shape), dtype=torch.float32,
                      device=x.device)
    return x, _zero_aux(x.device), mask


def _chunk_loss(h, y, m, w):
    logits = dense(h, w, None, torch.float32, site="loss.unembed")
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    return ((lse - gold) * m).sum(), m.sum()


def chunked_ce_loss(params: Params, hidden, labels, mask,
                    cfg: ArchConfig) -> torch.Tensor:
    """Sequence-chunked cross-entropy: the (B, S, V) logits are never
    materialised at once, and each chunk's logits are recomputed in the
    backward pass (checkpointed, as the reference's ``jax.checkpoint``).
    hidden (B, S, d); labels (B, S) int; mask (B, S)."""
    w = _unembed_weight(params, cfg)
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
                          mask[:, rows], w, use_reentrant=False)
        tot = tot + l
        cnt = cnt + k
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params: Params, batch, cfg: ArchConfig):
    """(total loss, metrics) as the reference's ``loss_fn`` (a dense model
    adds no MoE terms)."""
    hidden, aux, mask = forward(params, batch, cfg)
    labels = batch["tokens"][:, 1:]
    loss = chunked_ce_loss(params, hidden, labels, mask, cfg)
    return loss, {"ce_loss": loss, **aux}


def logits(params: Params, batch, cfg: ArchConfig) -> torch.Tensor:
    """Full (B, S, V) f32 logits, for small-scale evaluation and tests."""
    hidden, _, _ = forward(params, batch, cfg)
    return dense(hidden, _unembed_weight(params, cfg), None, torch.float32,
                 site="unembed")
