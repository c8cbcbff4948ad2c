"""ServingEngine: continuous-batching inference over the port's model stack.

Two layouts of ``repro/serving/engine.py``, chosen by the model's family
(``kv_layout="auto"``): the paged layout with chunked prefill for the
attention families, and the dense slot layout for the recurrent ones.

The paged, chunked-prefill path (dense GQA, MoE/MLA):

* ``num_slots`` fixed decode lanes share one physical KV page arena
  ``(layers, num_blocks + 1, block_size, KVH, hd)`` (with MLA, the latent
  rows: c_kv ``(..., r)`` and k_rope ``(..., rd)``) bound to a
  ``KVBlockPool``; the trailing page is the write-discard scratch that
  masked rows land in.
* Prefill is chunked and paged: every step runs ONE ragged batch over all
  mid-prefill lanes, each contributing up to ``prefill_chunk`` of its
  remaining context; chunk K/V rows are written straight into the lane's
  pages and attention runs through ``kernels/ops.paged_prefill_attention``.
  TTFT is stamped when a lane's final chunk lands.
* Decode runs ONE batched ``paged_decode_step`` over the fully-prefilled
  lanes through per-slot block tables (``kernels/ops.paged_attention``);
  the table width is the max live page count rounded up to a power of two,
  as in the reference.
* Every GEMM goes through the SARA dispatch layer with this engine's
  dispatcher, execution mode and site registry; ``gemm_plan`` is read back
  from the registry (each site's recommendation and, on the kernel
  backend, the plan the card ran), ``plan_changes`` counts steps whose
  recommendation differs from the previous one and ``ran_plan_changes``
  steps whose plan on the card does: a real reconfiguration.
* ``prefix_cache`` (serving/prefix_cache.py): admission maps each prompt's
  longest cached page prefix into the new table (refcounted), prefill
  streams only the suffix, a chunk that would write into a shared or
  pinned page copies it first (``_cow_chunk_pages``), and a prompt whose
  final chunk lands pins its full pages into the trie.
* ``shared_prefix_decode`` (cascade decode): on a step where two or more
  decode lanes' tables open with the same physical pages, attention runs
  as a shared-prefix phase over those pages (read once for the group) and
  a per-lane unique phase, merged by softmax state
  (``Model.paged_shared_decode_step``).  GQA only: with MLA it raises, as
  in the reference.
* ``spec_draft`` (speculative decoding, serving/spec_decode.py): each
  decode step drafts up to ``spec_k`` tokens a lane with a draft model
  (``"self"`` or a registry arch) in its own page pool and arena, verifies
  every lane's pending token plus drafts in ONE target pass through the
  chunked-prefill kernel (``Model.paged_verify_step``, C = spec_k + 1
  rows a lane) and commits the longest agreeing prefix plus one corrected
  token.  Greedy only; the tokens equal plain greedy decode's.

The dense slot layout (recurrent families: RWKV6), whole-prompt prefill:

* One stacked per-slot state cache (``Model.init_cache(num_slots)``);
  nothing is paged (the state is O(1) in sequence length), but the
  ``KVBlockPool`` still meters each request's tokens, so
  ``reserve="incremental"`` can stall a lane.
* Each admitted request prefills alone at its exact length (a recurrent
  state integrates every token, so nothing is padded) from a fresh batch-1
  state, under registry scope ``prefill:m{n}``; the result is copied into
  its slot (``_slot_restore``).
* Each step decodes EVERY slot in one batched call under scope
  ``"decode"``, as the reference's ``vmap`` over slots does: free lanes
  compute too (admission overwrites their state), and a stalled lane rolls
  back to the snapshot taken before the step (``_slot_snapshot``).  The
  port batches the lanes, so the decode GEMMs record M = num_slots where
  the reference's vmapped trace records M = 1.

``EngineConfig.dispatcher_mode`` selects the recommendation source:
``"oracle"`` (exhaustive tile-space search) or ``"adaptnet"`` (a trained
ADAPTNET-TPU loaded from ``adaptnet_dir``, with the oracle as the
fallback for shapes outside its trained range); ``dispatch_stats`` counts
the executed sites each source decided.  ``defrag_threshold`` compacts
the page pool after any step that leaves ``pool.fragmentation()`` above
it (``kv_defrag_auto`` counts those steps).

Parts of the reference engine that are not ported (the dense KV layout of
the attention families and their bucketed prefill, the chaos harness, the
sanitizer, snapshots, span tracing) raise ``ValueError`` when their config
field is set; nothing is ignored.  ``run()`` ends with the reference's
teardown audit (no table survives, the only pins are the prefix trie's;
with ``spec_draft`` the draft pool is checked and must be empty,
``kv_draft_leaked_blocks``) on every run, where the reference audits only
under ``sanitize``.

The clock is either ``"wall"`` (live serving; every step ends in a device
synchronisation) or ``"steps"`` (virtual time in engine-step units —
deterministic, used by tests).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import dispatch
from repro_torch.configs.base import ArchConfig
from repro_torch.core.sara import SaraDispatcher
from repro_torch.dispatch import SiteRegistry
from repro_torch.models.serving import PAGED_FAMILIES
from repro_torch.serving.kv_pool import KVArena, KVBlockPool, PoolError
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import ContinuousScheduler, Request
from repro_torch.serving.spec_decode import (SpecDecoder, accept_tokens,
                                             resolve_draft)


def sample_logits(gen: torch.Generator, logits: torch.Tensor,
                  temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64.  temperature<=0 is greedy argmax (the
    first maximal index, as ``jnp.argmax``); top_k>0 masks everything
    below the k-th logit before sampling from ``gen``."""
    if temperature <= 0.0:
        return torch.argmax(logits, -1)
    logits = logits.float() / temperature
    if top_k > 0:
        thresh = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < thresh,
                             torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def gemm_sites(cfg: ArchConfig, m_tokens: int
               ) -> List[Tuple[str, int, int, int]]:
    """The (M, K, N) of each distinct GEMM the model runs on ``m_tokens``
    rows this step (MoE expert GEMMs use the expected routed-row count):
    an analytic estimate, used for the prefill FLOPs a cache hit saves."""
    m = max(int(m_tokens), 1)
    d = cfg.d_model
    sites: List[Tuple[str, int, int, int]] = []
    if cfg.attention_type == "gqa":
        sites += [("attn_qkv", m, d, cfg.q_dim + 2 * cfg.kv_dim),
                  ("attn_out", m, cfg.q_dim, d)]
    elif cfg.attention_type == "mla":
        a = cfg.mla
        sites += [("mla_down", m, d,
                   a.q_lora_rank + a.kv_lora_rank + a.qk_rope_head_dim),
                  ("mla_out", m, cfg.num_heads * a.v_head_dim, d)]
    if cfg.moe is not None:
        sites += [("moe_expert",
                   max(m * cfg.moe.experts_per_token, 1), d,
                   2 * cfg.moe.d_ff_expert),
                  ("moe_router", m, d, cfg.moe.num_experts)]
    else:
        sites += [("mlp_up", m, d, 2 * cfg.d_ff),
                  ("mlp_down", m, cfg.d_ff, d)]
    if cfg.ssm is not None:
        sites += [("ssm_proj", m, d, 2 * cfg.ssm.expand * d)]
    sites += [("lm_head", m, d, cfg.vocab_size)]
    return sites


@dataclass
class EngineConfig:
    """Serving-engine knobs (the fields of the reference's EngineConfig).

    Fields of features this port does not have stay here so that setting
    one raises instead of being silently ignored."""

    num_slots: int = 4
    max_len: int = 96                 # per-slot token capacity (prompt+gen+1)
    block_size: int = 16              # KV pool page size (tokens)
    num_blocks: Optional[int] = None  # KV budget; None = full slot capacity
    max_prefills_per_step: int = 1    # admissions per engine step
    reserve: str = "full"             # "full" | "incremental"
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    eos_id: Optional[int] = None
    clock: str = "steps"              # "steps" | "wall"
    execute: str = "auto"             # "auto" | "kernel" | "torch"
    preempt_budget: int = 3           # preempt/readmit cycles before failing
    # "auto": 64 paged, whole-prompt dense; None: the reference's bucketed
    # prefill (paged: not ported) or whole-prompt (dense); an int: chunked
    prefill_chunk: Union[int, str, None] = "auto"
    kv_layout: str = "auto"           # "paged" | "dense" | "auto" (by family)
    prefix_cache: bool = False        # cross-request prefix cache
    shared_prefix_decode: bool = False  # cascade decode (needs prefix_cache)
    dispatcher_mode: str = "oracle"   # tile source: "oracle" | "adaptnet"
    adaptnet_dir: Optional[str] = None  # trained ADAPTNET-TPU checkpoint dir
    # auto-defrag: compact the pool after any step that leaves
    # fragmentation() above this threshold (None = manual defrag() only)
    defrag_threshold: Optional[float] = None
    # speculative decoding: a registry arch or "self" drafts spec_k tokens
    # a lane and step, verified by one (spec_k + 1)-row target pass; needs
    # chunked prefill and greedy decoding.  spec_draft_blocks is the draft
    # pool's page budget (None: the target pool's)
    spec_draft: Optional[str] = None
    spec_k: int = 4
    spec_draft_blocks: Optional[int] = None
    # not ported — setting any of these raises
    buckets: Optional[Sequence[int]] = None
    sanitize: bool = False
    chaos: Optional[object] = None
    snapshot_dir: Optional[str] = None
    trace: bool = False


PAGED_PREFILL_CHUNK = 64   # the paged families' chunk under "auto"


def _check_ported(e: EngineConfig) -> None:
    unported = {
        "chaos": e.chaos is not None,
        "sanitize": e.sanitize,
        "snapshot_dir": e.snapshot_dir is not None,
        "trace": e.trace,
        "buckets (bucketed prefill)": e.buckets is not None,
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise ValueError(f"not ported to the PyTorch engine: {bad}")
    if e.shared_prefix_decode and not e.prefix_cache:
        raise ValueError("shared_prefix_decode needs prefix_cache: shared "
                         "page runs only arise from cache-hit admissions")
    if e.kv_layout not in ("paged", "dense", "auto"):
        raise ValueError(f"unknown kv_layout {e.kv_layout!r}")
    if e.prefill_chunk not in (None, "auto") and (
            not isinstance(e.prefill_chunk, int) or e.prefill_chunk < 1):
        raise ValueError(f"prefill_chunk must be 'auto', None or an int >= "
                         f"1, got {e.prefill_chunk!r}")
    if e.clock not in ("steps", "wall"):
        raise ValueError(f"unknown clock {e.clock!r}")
    if e.execute not in dispatch.EXECUTE_MODES:
        raise ValueError(f"execute must be one of {dispatch.EXECUTE_MODES}")


def _resolve_layout(cfg: ArchConfig, e: EngineConfig
                    ) -> Tuple[str, Optional[int]]:
    """The engine's KV layout and prefill chunk.  ``"auto"`` is paged for
    the attention families and dense for the recurrent ones, and a
    recurrent family cannot page, as in the reference.  The port serves
    the attention families paged with chunked prefill (``prefill_chunk``
    "auto": 64; None, the reference's bucketed prefill, is not ported) and
    the recurrent ones dense with whole-prompt prefill (chunk None), and
    raises for the other combinations."""
    layout, chunk = e.kv_layout, e.prefill_chunk
    if layout == "auto":
        layout = "paged" if cfg.family in PAGED_FAMILIES else "dense"
    if layout == "paged" and cfg.family not in PAGED_FAMILIES:
        raise ValueError(
            f"family {cfg.family!r} keeps recurrent state in the dense slot "
            f"layout; kv_layout='paged' supports {PAGED_FAMILIES}")
    if layout == "dense" and cfg.family in PAGED_FAMILIES:
        raise ValueError("the dense KV layout of the attention families is "
                         "not ported (ROADMAP.md queue 1 item 10): serve "
                         "them with kv_layout='paged'")
    if layout == "paged":
        if chunk is None:
            raise ValueError("bucketed prefill is not ported: set "
                             "prefill_chunk")
        return layout, PAGED_PREFILL_CHUNK if chunk == "auto" else chunk
    if chunk not in (None, "auto"):
        raise ValueError("prefill_chunk streams prompts directly into KV "
                         "pages; it requires kv_layout='paged' (recurrent "
                         "families prefill whole prompts: prefill_chunk="
                         "None)")
    if e.prefix_cache:
        raise ValueError("prefix_cache requires chunked prefill: a cache hit "
                         "admits a request mid-prompt, and only the chunked "
                         "prefill path can resume from a per-lane offset")
    return layout, None


class ServingEngine:
    """Continuous-batching inference engine over the port's model stack.

    Construct with an ``ArchConfig`` (what model), an ``EngineConfig``
    (how to serve it) and a ``device`` (CUDA unless the caller names
    another; CUDA missing raises); ``submit()`` requests and drive
    ``step()`` until it returns False, or use ``run()`` for a whole
    request set.  Telemetry comes out of ``summary()`` / ``metrics`` /
    ``dispatch_stats()`` and the per-site tile plan (recommended, and
    what ran) out of ``gemm_plan``."""

    def __init__(self, cfg: ArchConfig, engine: EngineConfig = None,
                 params=None, dispatcher: Optional[SaraDispatcher] = None,
                 device: Optional[str] = None):
        from repro_torch.models.api import build_model

        self.cfg = cfg
        self.ecfg = e = engine or EngineConfig()
        _check_ported(e)
        if e.shared_prefix_decode and cfg.attention_type == "mla":
            raise ValueError("shared_prefix_decode is GQA-only (absorbed MLA "
                             "keeps the plain paged decode)")
        self.model = build_model(cfg, device)
        self.device = self.model.device
        self.params = params if params is not None \
            else self.model.init(e.seed)
        if self.params["embed"].device != self.device:
            raise ValueError(f"params live on {self.params['embed'].device}, "
                             f"the engine on {self.device}")
        self.dispatcher = dispatcher if dispatcher is not None \
            else self._build_dispatcher(e)
        self.metrics = ServingMetrics()
        self.kv_layout, chunk = _resolve_layout(cfg, e)
        # no prompt exceeds max_len, so a larger chunk would only pad the
        # batch with dead query rows the kernel still computes
        self.prefill_chunk = (min(chunk, e.max_len) if chunk is not None
                              else None)
        self._max_blocks_per_slot = -(-e.max_len // e.block_size)
        num_blocks = (e.num_blocks if e.num_blocks is not None
                      else e.num_slots * self._max_blocks_per_slot)
        self.pool = KVBlockPool(num_blocks, e.block_size)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.pool) if e.prefix_cache else None)
        self.sched = ContinuousScheduler(
            e.num_slots, self.pool,
            max_prefills_per_step=e.max_prefills_per_step, reserve=e.reserve,
            prefill_chunk=self.prefill_chunk, prefix_cache=self.prefix_cache,
            metrics=self.metrics)
        # analytic per-token prefill cost (2*M*K*N over every GEMM site at
        # M=1, layer sites times the stack depth): what each cache-hit
        # token avoids recomputing; feeds metrics.prefill_flops_saved
        self._flops_per_token = float(sum(
            2 * m * k * n * (1 if name == "lm_head" else cfg.num_layers)
            for name, m, k, n in gemm_sites(cfg, 1)))
        # cascade decode telemetry: steps that ran the two-phase attention,
        # and the sharing-group lanes summed over those steps
        self.shared_prefix_steps = 0
        self.shared_prefix_lanes = 0
        self._leak_audit: Dict[str, int] = {}
        self.requests: Dict[str, Request] = {}
        self.arena: Optional[KVArena] = None
        self._cache = None
        if self.kv_layout == "paged":
            self.arena = KVArena(
                self.model.init_paged_arena(num_blocks + 1, e.block_size),
                e.block_size)
            self.pool.bind_arena(self.arena)
        else:
            # stacked per-slot states: the slot is the batch axis
            self._cache = self.model.init_cache(e.num_slots)
        self.spec: Optional[SpecDecoder] = None
        if e.spec_draft is not None:
            if self.prefill_chunk is None:
                raise ValueError(
                    "spec_draft requires prefill_chunk: the verify pass IS "
                    "the ragged chunked-prefill kernel (spec_k + 1 rows "
                    "per lane through block tables), and this layout "
                    "resolved to no chunk")
            if e.temperature > 0.0:
                raise ValueError(
                    "spec_draft requires greedy decoding (temperature <= "
                    "0): the accept rule compares drafts against the "
                    "verify argmax, which is only the sampling rule when "
                    "greedy")
            if e.shared_prefix_decode:
                raise ValueError(
                    "spec_draft is incompatible with shared_prefix_decode: "
                    "the verify chunk replaces the decode step the "
                    "cascade would group")
            if e.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            draft_cfg, draft_params = resolve_draft(
                cfg, self.params, e.spec_draft, e.seed)
            self.spec = SpecDecoder(
                draft_cfg, draft_params, num_slots=e.num_slots,
                block_size=e.block_size,
                num_blocks=(e.spec_draft_blocks
                            if e.spec_draft_blocks is not None
                            else num_blocks),
                max_blocks_per_slot=self._max_blocks_per_slot,
                chunk=self.prefill_chunk, spec_k=e.spec_k)
        self._kv_rows = np.zeros((e.num_slots,), np.int32)
        self._last_tok = np.zeros((e.num_slots, 1), np.int32)
        # what one masked-dense decode step would stream: every slot's full
        # capacity (the paged win the metrics report; recurrent-state
        # families have no KV rows)
        self._dense_kv_rows = (e.num_slots * e.max_len
                               if cfg.attention_type != "none" else 0)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(e.seed + 1)
        self._vtime = 0.0
        self._t0 = time.time()
        self.registry = SiteRegistry()
        # site -> the recommendation and what the card ran (describe())
        self.gemm_plan: Dict[str, str] = {}
        self.plan_changes = 0            # steps whose recommendation changed
        self.ran_plan_changes = 0        # steps whose plan on the card changed
        self._rec_plan: Dict[str, str] = {}
        self._ran_plan: Dict[str, object] = {}
        self.steps = 0
        self.defrag_auto = 0             # steps that ended in an auto-defrag

    @staticmethod
    def _build_dispatcher(ecfg: EngineConfig) -> SaraDispatcher:
        if ecfg.dispatcher_mode == "adaptnet":
            if not ecfg.adaptnet_dir:
                raise ValueError(
                    "dispatcher_mode='adaptnet' needs adaptnet_dir: a "
                    "checkpoint saved by `python -m repro_torch.launch."
                    "train_adaptnet --out <dir>`")
            return SaraDispatcher.from_checkpoint(ecfg.adaptnet_dir)
        if ecfg.dispatcher_mode != "oracle":
            raise ValueError(f"unknown dispatcher_mode "
                             f"{ecfg.dispatcher_mode!r}")
        return SaraDispatcher()

    # -- time -----------------------------------------------------------------
    def now(self) -> float:
        if self.ecfg.clock == "steps":
            return self._vtime
        return time.time() - self._t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- SARA dispatch --------------------------------------------------------
    @contextlib.contextmanager
    def _dispatch_scope(self, scope: str):
        """Install this engine's dispatch policy + registry scope around a
        model call: every GEMM site records its executed configuration
        under ``scope``."""
        with dispatch.use(self.dispatcher, execute=self.ecfg.execute,
                          registry=self.registry), \
                self.registry.scope(scope):
            yield

    def _dispatch(self, scope: str) -> None:
        """Adopt the plan of ``scope``: count a change of recommendation
        and, apart, a change of what the card ran."""
        sites = self.registry.sites(scope)
        rec = {n: r.recommendation() for n, r in sites.items()}
        ran = {n: r.ran_plan() for n, r in sites.items()}
        if rec != self._rec_plan:
            self.plan_changes += 1       # another recommendation
            self._rec_plan = rec
        if ran != self._ran_plan:
            self.ran_plan_changes += 1   # a real reconfiguration on the card
            self._ran_plan = ran
        self.gemm_plan = {n: r.describe() for n, r in sites.items()}

    # -- dense slot layout (recurrent families) ------------------------------
    def bucket_for(self, n: int) -> int:
        """The prefill shape of an n-token prompt: n itself on the dense
        layout, which only recurrent families run (their state integrates
        every input token, so nothing may be padded).  The bucketed
        prefill of attention families is not ported."""
        if self.kv_layout == "dense":
            return n
        raise NotImplementedError("bucketed prefill of attention families "
                                  "is not ported (ROADMAP.md queue 1 item "
                                  "10)")

    def _slot_snapshot(self, slot: int):
        """A copy of one slot's state, as a batch-1 cache (the layer-stacked
        state leaves carry the slot on dim 1)."""
        c = self._cache
        return {"pos": c["pos"][slot:slot + 1].clone(),
                "layers": type(c["layers"])(*(t[:, slot:slot + 1].clone()
                                              for t in c["layers"]))}

    def _slot_restore(self, slot: int, one) -> None:
        """Write a batch-1 cache (a snapshot, or a fresh prefill's state)
        into one slot of the stacked cache, in place."""
        c = self._cache
        c["pos"][slot] = one["pos"][0]
        for t, o in zip(c["layers"], one["layers"]):
            t[:, slot] = o[:, 0]

    def _do_prefill(self, req: Request) -> None:
        """Prefill one admitted request at its exact length from a fresh
        batch-1 state, copy the state into its slot and sample its first
        token."""
        e = self.ecfg
        context = req.context()
        n = int(context.shape[0])
        scope = f"prefill:m{self.bucket_for(n)}"
        toks = self._tensor(np.asarray(context, np.int32)[None])
        t0 = time.time()
        with torch.no_grad(), self._dispatch_scope(scope):
            logits, new = self.model.prefill(self.params, {"tokens": toks},
                                             self.model.init_cache(1))
        self._sync()
        dt = time.time() - t0
        self._dispatch(scope)
        self.metrics.on_prefill(n, dt)
        self._slot_restore(req.slot, new)
        req.prefill_pos = n
        req.prefilling = False
        tok = int(sample_logits(self._gen, logits, e.temperature,
                                e.top_k).cpu()[0])
        req.generated.append(tok)
        self._last_tok[req.slot, 0] = tok
        self._first_token(req)

    def _decode_dense(self):
        """One batched decode over every slot of the state cache.  Returns
        (logits (S, V) on the device, seconds, KV rows streamed)."""
        t0 = time.time()
        with torch.no_grad(), self._dispatch_scope("decode"):
            logits, self._cache = self.model.decode_step(
                self.params, self._tensor(self._last_tok), self._cache)
        self._sync()
        return logits, time.time() - t0, self._dense_kv_rows

    # -- request lifecycle ----------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.prompt_len < 1:
            raise ValueError(f"request {req.rid}: prompt must be non-empty")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be "
                             ">= 1 (prefill always yields the first token)")
        need = req.prompt_len + req.max_new_tokens + 1
        if need > self.ecfg.max_len:
            raise ValueError(f"request {req.rid} needs {need} tokens > "
                             f"max_len {self.ecfg.max_len}")
        if self.pool.blocks_for(need) > self.pool.num_blocks:
            raise ValueError(
                f"request {req.rid} needs {self.pool.blocks_for(need)} KV "
                f"blocks > pool total {self.pool.num_blocks}; it could never "
                "be admitted")
        if req.eos_id is None:
            req.eos_id = self.ecfg.eos_id
        self.sched.submit(req)
        self.requests[req.rid] = req

    def _first_token(self, req: Request) -> None:
        if req.t_first_token < 0:
            req.t_first_token = self.now()
            self.metrics.on_first_token(req.arrival_time, req.t_first_token)

    def _do_chunk_prefills(self) -> None:
        """One chunked-prefill step over every mid-prefill lane (a ragged
        batch: lanes with nothing to stream, or whose page extension
        stalled, ride along with a zero chunk — their rows write to the
        trash page and their logits row is ignored).  A lane whose final
        chunk lands here samples its first token."""
        e = self.ecfg
        C, S = self.prefill_chunk, e.num_slots
        lanes = {s: r for s, r in self.sched.active.items() if r.prefilling}
        if not lanes:
            return
        toks = np.zeros((S, C), np.int32)
        chunk = np.zeros((S,), np.int32)
        for slot, req in sorted(lanes.items()):
            n = min(C, req.context_len - req.prefill_pos)
            # the coming chunk writes n KV rows: the block table must cover
            # them (a failed extension stalls the lane until pages free up)
            if not self.sched.grow(req, req.prefill_pos + n):
                self.metrics.stalls += 1
                continue
            if not self._cow_chunk_pages(req, req.prefill_pos, n):
                self.metrics.stalls += 1
                continue
            ctx = req.context()
            toks[slot, :n] = ctx[req.prefill_pos:req.prefill_pos + n]
            chunk[slot] = n
        if not chunk.any():
            return                       # every prefilling lane stalled
        kv = np.where(chunk > 0, self._kv_rows, 0).astype(np.int32)
        # fixed table width: a chunk attends over its lane's whole prefix
        # anyway, and the kernel never reads a dead column
        width = self._max_blocks_per_slot
        rids = [lanes[s].rid if chunk[s] > 0 else None for s in range(S)]
        tables = self.pool.dense_block_table(rids, width)

        t0 = time.time()
        with torch.no_grad(), self._dispatch_scope("prefill_chunk"):
            logits, _ = self.model.paged_prefill_step(
                self.params, self._tensor(toks), self.arena.leaves,
                self._tensor(tables), self._tensor(kv), self._tensor(chunk))
        self._sync()
        dt = time.time() - t0
        self._dispatch("prefill_chunk")

        total = int(chunk.sum())
        self.metrics.on_prefill(total, dt, kv_write_rows=total)
        sampled = None
        if any(chunk[s] and r.prefill_pos + chunk[s] >= r.context_len
               for s, r in lanes.items()):
            sampled = sample_logits(self._gen, logits, e.temperature,
                                    e.top_k).cpu().numpy()
        for slot, req in sorted(lanes.items()):
            n = int(chunk[slot])
            if n == 0:
                continue
            req.prefill_pos += n
            self._kv_rows[slot] += n
            if req.prefill_pos < req.context_len:
                continue                 # more chunks to stream next step
            req.prefilling = False
            if self.prefix_cache is not None:
                # index the finished prompt's fully covered pages; decode
                # only appends rows >= prompt_len, so their content is
                # frozen from here on and pinning is safe.  Spans already
                # cached keep their existing page.
                nfull = req.prompt_len // e.block_size
                if nfull:
                    self.prefix_cache.insert(
                        req.prompt, self.pool.table(req.rid).blocks[:nfull])
            tok = int(sampled[slot])
            req.generated.append(tok)
            self._last_tok[slot, 0] = tok
            self._first_token(req)
            if req.done():
                self._retire(req)

    def _cow_chunk_pages(self, req: Request, pos: int, n: int) -> bool:
        """Copy-on-write gate for the pages the coming chunk writes (rows
        ``[pos, pos + n)``).  A cache-hit lane's first recomputed token can
        land inside a shared or pinned page (the minus-one resume offset,
        or a readmitted lane re-streaming over pages it donated to the
        cache), and writing through the arena would corrupt every other
        owner, so each target page is made private first.  A copy that
        cannot get a free page evicts cache entries; if the pool is still
        dry the lane stalls exactly like a failed ``grow()``."""
        if self.prefix_cache is None or n <= 0:
            return True
        bs = self.ecfg.block_size
        for pi in range(pos // bs, (pos + n - 1) // bs + 1):
            while True:
                try:
                    self.pool.ensure_writable(req.rid, pi)
                    break
                except PoolError:
                    # ensure_writable raises only when the free list is
                    # empty; any successful eviction guarantees progress
                    if self.prefix_cache.evict(1) == 0:
                        req.stalled = True
                        return False
        req.stalled = False
        return True

    def _retire(self, req: Request) -> None:
        slot = req.slot
        self.sched.retire(req, self.now())
        req.outcome = "done"
        self.metrics.on_retire(req.arrival_time, req.t_admit, req.t_done,
                               in_deadline=not req.expired_at(req.t_done))
        if self.spec is not None:
            self.spec.release(req.rid)
        self._kv_rows[slot] = 0          # pages already back in the free list

    def _finish(self, req: Request, outcome: str, reason: str = "") -> None:
        """Terminal-failure bookkeeping (deadline/cancel sweep, preempt
        budget exhausted)."""
        slot = req.slot
        if not req.outcome:
            self.sched.finish(req, outcome, self.now(), reason=reason)
        self.metrics.on_finish(req.outcome)
        if self.spec is not None:
            self.spec.release(req.rid)
        if slot >= 0:
            self._last_tok[slot, 0] = 0
            self._kv_rows[slot] = 0

    def _preempt_newest(self) -> None:
        """Every lane is stalled: preempt the newest request (recompute on
        readmit) so the rest can make progress — or fail it once its
        preemption budget is spent, so it cannot cycle forever."""
        victim = max(self.sched.active.values(), key=lambda r: r.t_admit)
        victim.preempt_count += 1
        if victim.preempt_count > self.ecfg.preempt_budget:
            self._finish(victim, "failed",
                         reason=f"preemption budget "
                                f"({self.ecfg.preempt_budget}) exhausted")
            return
        slot = victim.slot
        self.sched.preempt(victim)
        self.metrics.preemptions += 1
        if self.spec is not None:
            self.spec.release(victim.rid)
        self._last_tok[slot, 0] = 0
        self._kv_rows[slot] = 0

    # -- main loop ------------------------------------------------------------
    def step(self) -> bool:
        """One engine step: admissions, one ragged chunk batch over every
        mid-prefill lane, then one batched decode over the fully-prefilled
        lanes.  Returns False when there is nothing left to do."""
        if self.sched.idle():
            return False
        self._step_body()
        thr = self.ecfg.defrag_threshold
        if thr is not None and self.pool.fragmentation() > thr:
            self.defrag_auto += 1
            self.defrag()
        self._vtime += 1.0
        self.steps += 1
        return True

    def _step_body(self) -> None:
        plan = self.sched.plan(self.now())
        for req in plan.finished:
            self._finish(req, req.outcome)
        for req in plan.prefills:
            # reset lane bookkeeping on every admission: chunked prefill
            # extends the row count with `+=` from whatever is here.  Cache
            # hits resume at the cached offset (prefill_pos), misses at 0.
            self._kv_rows[req.slot] = req.prefill_pos
            if req.cached_prefix_tokens:
                self.metrics.on_cache_hit(req.cached_prefix_tokens,
                                          req.cached_pages,
                                          self._flops_per_token)
        if self.kv_layout == "paged":
            self._do_chunk_prefills()
        else:
            for req in [r for _, r in sorted(self.sched.active.items())
                        if r.prefilling]:
                self._do_prefill(req)
                if req.done():
                    self._retire(req)

        # a request can finish at prefill and chunked lanes may still be
        # mid-prefill, so re-check the planned decode slots
        active = {s: self.sched.active[s] for s in plan.decode_slots
                  if s in self.sched.active
                  and not self.sched.active[s].prefilling}
        if active and self.spec is not None:
            self._spec_decode_step(active)
        elif active:
            # decide stalls BEFORE decoding: the coming step writes the KV
            # of each lane's pending token; a stalled dense lane keeps a
            # snapshot of its state to roll back to
            snaps = {}
            for slot, req in active.items():
                if not self.sched.grow(req,
                                       req.prompt_len + len(req.generated)):
                    self.metrics.stalls += 1
                    if self.kv_layout == "dense":
                        snaps[slot] = self._slot_snapshot(slot)
            if self.kv_layout == "paged":
                logits, dt, kv_read = self._decode_paged(active)
            else:
                logits, dt, kv_read = self._decode_dense()
            self._dispatch("decode")
            sampled = sample_logits(self._gen, logits, self.ecfg.temperature,
                                    self.ecfg.top_k).cpu().numpy()
            committed = 0
            for slot, req in sorted(active.items()):
                if req.stalled:
                    # replays once the pool can cover it: paged lanes wrote
                    # nothing (trash page), dense lanes roll back
                    if slot in snaps:
                        self._slot_restore(slot, snaps[slot])
                    continue
                req.generated.append(int(sampled[slot]))
                self._last_tok[slot, 0] = req.generated[-1]
                self._kv_rows[slot] += 1
                committed += 1
                self._first_token(req)
                if req.done():
                    self._retire(req)
            self.metrics.on_decode_step(
                len(active), self.ecfg.num_slots, committed, dt,
                kv_read_tokens=kv_read,
                kv_read_tokens_dense=self._dense_kv_rows)
        # every live lane stalled: preempt the newest request
        if self.sched.active and \
                all(r.stalled for r in self.sched.active.values()):
            self._preempt_newest()

    def _decode_paged(self, active: Dict[int, Request]):
        """One batched decode over every lane through the page arena.
        Returns (logits (S, V) on the device, seconds, KV rows streamed)."""
        e = self.ecfg
        S = e.num_slots
        wm = np.zeros((S,), np.int32)
        for slot, req in active.items():
            wm[slot] = 0 if req.stalled else 1
        # lanes outside the decode set contribute no pages: length 0
        kv = np.where([s in active for s in range(S)],
                      self._kv_rows, 0).astype(np.int32)
        need = [self.pool.blocks_for(int(kv[s]) + int(wm[s]))
                for s in range(S)]
        width = KVBlockPool.table_width(max(need), self._max_blocks_per_slot)
        rids = [active[s].rid if s in active else None for s in range(S)]
        tables = self.pool.dense_block_table(rids, width)
        group = (self._shared_prefix_group(active, kv, wm)
                 if e.shared_prefix_decode else None)
        t0 = time.time()
        with torch.no_grad(), self._dispatch_scope("decode"):
            args = [self._tensor(a) for a in (self._last_tok, tables, kv, wm)]
            if group is not None:
                prefix_pages, prefix_lens, utables, ulens, kv_read, _ = group
                self.shared_prefix_steps += 1
                self.shared_prefix_lanes += int((prefix_lens > 0).sum())
                logits, _ = self.model.paged_shared_decode_step(
                    self.params, args[0], self.arena.leaves, *args[1:],
                    *[self._tensor(a) for a in (prefix_pages, prefix_lens,
                                                utables, ulens)])
            else:
                kv_read = e.block_size * sum(need)
                logits, _ = self.model.paged_decode_step(
                    self.params, args[0], self.arena.leaves, *args[1:])
        self._sync()
        return logits, time.time() - t0, kv_read

    def _spec_decode_step(self, active: Dict[int, Request]) -> None:
        """One speculative step over the fully-prefilled lanes: draft up to
        ``spec_k`` tokens a lane (draft model, own page arena), verify
        every lane's pending token plus drafts with ONE target pass
        through the ragged chunked-prefill kernel (C = spec_k + 1 rows a
        lane), and commit the longest draft prefix the verify argmax
        agrees with plus one corrected or bonus token.  Rejected drafts
        roll back by not advancing the lanes' lengths: the rows they wrote
        (in both arenas) lie past the new length inside reserved pages and
        are overwritten in place next step, copy-on-write gated below
        where target pages are shared with the prefix cache."""
        e = self.ecfg
        S, K = e.num_slots, e.spec_k
        # the per-lane quota: the bonus token always commits one, so never
        # draft past the remaining budget; reserve verify rows [L-1,
        # L-1+k] up front, degrading k -> 0 before stalling
        quota: Dict[int, int] = {}
        for slot, req in sorted(active.items()):
            L = req.prompt_len + len(req.generated)
            k = max(0, min(K, req.max_new_tokens - len(req.generated) - 1))
            if not self.sched.grow(req, L + k):
                k = 0
                if not self.sched.grow(req, L):
                    self.metrics.stalls += 1
            quota[slot] = k
        for slot, req in sorted(active.items()):
            if req.stalled:
                continue                 # writes nothing: no fork needed
            L = req.prompt_len + len(req.generated)
            if not self._cow_chunk_pages(req, L - 1, quota[slot] + 1):
                self.metrics.stalls += 1

        draft_lanes = {s: (r, quota[s]) for s, r in active.items()
                       if not r.stalled and quota[s] > 0}
        drafts: Dict[int, List[int]] = {}
        preempts = 0
        dt_draft = 0.0
        if draft_lanes:
            t0 = time.time()
            with self._dispatch_scope("spec_draft"):
                drafts, preempts = self.spec.draft(draft_lanes)
            dt_draft = time.time() - t0

        # verify: one ragged chunk batch at a fixed width.  Row 0 is the
        # pending token (what plain decode would run), rows 1..k the
        # drafts; stalled lanes ride along with chunk 0 (their rows land
        # in the trash page, their logits are ignored)
        C = K + 1
        toks = np.zeros((S, C), np.int32)
        clens = np.zeros((S,), np.int32)
        for slot, req in sorted(active.items()):
            if req.stalled:
                continue
            d = drafts.get(slot, [])
            toks[slot, 0] = self._last_tok[slot, 0]
            toks[slot, 1:1 + len(d)] = d
            clens[slot] = 1 + len(d)
        kv = np.where(clens > 0, self._kv_rows, 0).astype(np.int32)
        rids = [active[s].rid if s in active and clens[s] > 0 else None
                for s in range(S)]
        tables = self.pool.dense_block_table(rids, self._max_blocks_per_slot)
        kv_read = e.block_size * sum(
            self.pool.blocks_for(int(kv[s]) + int(clens[s]))
            for s in range(S))
        t0 = time.time()
        with torch.no_grad(), self._dispatch_scope("spec_verify"):
            logits, _ = self.model.paged_verify_step(
                self.params, self._tensor(toks), self.arena.leaves,
                self._tensor(tables), self._tensor(kv), self._tensor(clens))
        self._sync()
        dt = time.time() - t0
        self._dispatch("spec_verify")
        # greedy verify picks (S, C), on the device (the first maximal
        # index, as np.argmax); only the ints come to the host
        argm = torch.argmax(logits, -1).cpu().numpy()

        committed = accepted = bonus = drafted = live = 0
        for slot, req in sorted(active.items()):
            if req.stalled:
                continue                 # replays the pending token
            live += 1
            d = drafts.get(slot, [])
            drafted += len(d)
            a, commit = accept_tokens(d, argm[slot, :len(d) + 1])
            c = 0
            for t in commit:             # EOS or the budget can cut it
                req.generated.append(int(t))
                c += 1
                if req.done():
                    break
            accepted += min(a, c)
            bonus += c - min(a, c)
            committed += c
            self._kv_rows[slot] += c
            self._last_tok[slot, 0] = req.generated[-1]
            self.spec.commit(req.rid, int(self._kv_rows[slot]))
            self._first_token(req)
            if req.done():
                self._retire(req)
        self.metrics.on_spec_step(live, drafted, accepted, bonus, preempts)
        self.metrics.on_decode_step(
            len(active), e.num_slots, committed, dt + dt_draft,
            kv_read_tokens=kv_read,
            kv_read_tokens_dense=self._dense_kv_rows)

    def _shared_prefix_group(self, active: Dict[int, Request],
                             kv: np.ndarray, wm: np.ndarray):
        """Detect the hottest shared page run among the decode lanes: the
        largest group (>= 2 lanes) whose block tables begin with the same
        physical pages, with >= 1 fully written common page.  Returns the
        cascade operands ``(prefix_pages, prefix_lens, unique_tables,
        unique_lens, kv_read_rows, n_prefix_pages)``, padded to
        power-of-two widths like the plain decode tables, or ``None`` when
        no group exists this step."""
        e = self.ecfg
        S, bs = e.num_slots, e.block_size
        blocks = {s: self.pool.table(r.rid).blocks
                  for s, r in active.items()}
        groups: Dict[int, List[int]] = {}
        for s, b in blocks.items():
            # only fully written pages can sit in the shared phase (it
            # reads whole pages), so a lane needs >= bs committed rows
            if b and int(kv[s]) >= bs:
                groups.setdefault(b[0], []).append(s)
        if not groups:
            return None
        best = max(groups.values(), key=len)
        if len(best) < 2:
            return None
        # longest common physical prefix, capped at each member's fully
        # written pages: the pending token's row stays in the unique phase
        # (it is written this very step)
        P = min(min(int(kv[s]) // bs for s in best),
                min(len(blocks[s]) for s in best))
        first = blocks[best[0]]
        i = 0
        while i < P and all(blocks[s][i] == first[i] for s in best[1:]):
            i += 1
        P = i
        if P < 1:
            return None
        members = set(best)
        prefix_lens = np.zeros((S,), np.int32)
        ulens = np.zeros((S,), np.int32)
        for s in active:
            attn = int(kv[s]) + int(wm[s])
            if s in members:
                prefix_lens[s] = P * bs
                ulens[s] = attn - P * bs
            else:
                ulens[s] = attn
        uneed = max(self.pool.blocks_for(int(n)) for n in ulens)
        uw = KVBlockPool.table_width(max(uneed, 1),
                                     self._max_blocks_per_slot)
        utables = np.zeros((S, uw), np.int32)
        for s in active:
            off = P if s in members else 0
            b = blocks[s][off:off + uw]
            if b:
                utables[s, :len(b)] = b
                utables[s, len(b):] = b[-1]
        pw = KVBlockPool.table_width(P, self._max_blocks_per_slot)
        prefix_pages = np.full((pw,), first[P - 1], np.int32)
        prefix_pages[:P] = first[:P]
        # the P shared pages are read once for the whole group instead of
        # once per member lane
        kv_read = bs * (P + sum(self.pool.blocks_for(int(n))
                                for n in ulens))
        return prefix_pages, prefix_lens, utables, ulens, kv_read, P

    def run(self, requests: Sequence[Request]) -> Dict[str, np.ndarray]:
        """Serve a request set to completion; returns {rid: generated}.
        An invalid request is recorded as ``rejected`` and skipped."""
        if self.steps == 0:
            # the wall clock starts with serving, not with model set-up
            self._t0 = time.time()
        for r in requests:
            try:
                self.submit(r)
            except (ValueError, PoolError):
                r.outcome = "rejected"
                self.requests[r.rid] = r
                self.metrics.on_finish("rejected")
        while self.step():
            pass
        # every request drained: no table may survive and the only pins
        # left are the prefix trie's (``prefix_cache.clear()`` returns the
        # pool to whole)
        self._leak_audit = self.pool.audit_leaks(
            self.prefix_cache.pages() if self.prefix_cache is not None
            else ())
        if self.spec is not None:
            # draft pages leave with their target request, so a drained
            # engine leaves the draft pool empty too
            self.spec.check()
            self._leak_audit["kv_draft_leaked_blocks"] = \
                self.spec.live_pages()
        return {r.rid: np.asarray(r.generated, np.int32) for r in requests}

    def dispatch_stats(self) -> Dict[str, int]:
        """Executed-GEMM dispatch telemetry (registry-backed)."""
        backends: Dict[str, int] = {}
        sources: Dict[str, int] = {}
        for scope in self.registry.scopes():
            for b, c in self.registry.backends(scope).items():
                backends[b] = backends.get(b, 0) + c
            for s, c in self.registry.sources(scope).items():
                sources[s] = sources.get(s, 0) + c
        return {"gemm_plan_changes": self.plan_changes,
                "gemm_ran_plan_changes": self.ran_plan_changes,
                "gemm_sites_executed": len(self.gemm_plan),
                "gemm_traced_scopes": len(self.registry.scopes()),
                "gemm_kernel_sites": backends.get("kernel", 0),
                "gemm_torch_sites": backends.get("torch", 0),
                "rec_adaptnet_sites": sources.get("adaptnet", 0),
                "rec_oracle_sites": sources.get("oracle", 0),
                "rec_fallback_sites": sources.get("oracle_fallback", 0)}

    def defrag(self) -> int:
        """Compact live KV pages to the front of the arena between steps:
        the pool rewrites every block table and (paged layout) mirrors the
        move map into page storage.  Returns the number of pages moved;
        the next step reads the remapped tables."""
        return len(self.pool.defrag())

    def summary(self) -> Dict[str, float]:
        s = self.metrics.summary(self.dispatcher.cache_info(),
                                 dispatch=self.dispatch_stats())
        s["kv_layout"] = self.kv_layout
        s["kv_peak_blocks"] = self.pool.peak_in_use
        s["kv_fragmentation"] = self.pool.fragmentation()
        s["kv_defrag_block_moves"] = self.pool.defrag_moves
        s["kv_defrag_auto"] = self.defrag_auto
        s["engine_steps"] = self.steps
        s["kv_shared_pages"] = self.pool.shared_pages
        s["kv_cow_copies"] = self.pool.cow_copies
        if self.prefix_cache is not None:
            s.update(self.prefix_cache.stats())
        s["shared_prefix_steps"] = self.shared_prefix_steps
        s["shared_prefix_lanes"] = self.shared_prefix_lanes
        s.update(self._leak_audit)
        return s
