"""ServingEngine: continuous-batching inference over the port's model stack.

The paged, chunked-prefill path of ``repro/serving/engine.py``:

* ``num_slots`` fixed decode lanes share one physical KV page arena
  ``(layers, num_blocks + 1, block_size, KVH, hd)`` bound to a
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
  from the registry and ``plan_changes`` counts steps whose executed plan
  differs from the previous one.

Parts of the reference engine that are not ported (the dense KV layout,
bucketed prefill, prefix cache, cascade decode, speculative decoding, the
chaos harness, the sanitizer, snapshots, span tracing, ADAPTNET dispatch)
raise ``ValueError`` when their config field is set; nothing is ignored.

The clock is either ``"wall"`` (live serving; every step ends in a device
synchronisation) or ``"steps"`` (virtual time in engine-step units —
deterministic, used by tests).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import dispatch
from repro_torch.configs.base import ArchConfig
from repro_torch.core.sara import SaraDispatcher
from repro_torch.dispatch import SiteRegistry
from repro_torch.serving.kv_pool import KVArena, KVBlockPool, PoolError
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.scheduler import ContinuousScheduler, Request


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
    prefill_chunk: Optional[int] = 64
    kv_layout: str = "paged"          # "paged" ("auto" resolves to it)
    # not ported — setting any of these raises
    dispatcher_mode: str = "oracle"
    adaptnet_dir: Optional[str] = None
    buckets: Optional[Sequence[int]] = None
    prefix_cache: bool = False
    shared_prefix_decode: bool = False
    spec_draft: Optional[str] = None
    sanitize: bool = False
    chaos: Optional[object] = None
    snapshot_dir: Optional[str] = None
    trace: bool = False


def _check_ported(e: EngineConfig) -> None:
    unported = {
        "prefix_cache": e.prefix_cache,
        "shared_prefix_decode": e.shared_prefix_decode,
        "spec_draft": e.spec_draft is not None,
        "chaos": e.chaos is not None,
        "sanitize": e.sanitize,
        "snapshot_dir": e.snapshot_dir is not None,
        "trace": e.trace,
        "buckets (bucketed prefill)": e.buckets is not None,
        "adaptnet_dir": e.adaptnet_dir is not None,
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise ValueError(f"not ported to the PyTorch engine: {bad}")
    if e.kv_layout not in ("paged", "auto"):
        raise ValueError(f"kv_layout {e.kv_layout!r} is not ported (the "
                         "engine serves the paged layout only)")
    if e.prefill_chunk is None:
        raise ValueError("bucketed prefill is not ported: set prefill_chunk")
    if e.prefill_chunk < 1:
        raise ValueError("prefill_chunk must be >= 1")
    if e.dispatcher_mode != "oracle":
        raise ValueError(f"dispatcher_mode {e.dispatcher_mode!r} is not "
                         "ported (only 'oracle')")
    if e.clock not in ("steps", "wall"):
        raise ValueError(f"unknown clock {e.clock!r}")
    if e.execute not in dispatch.EXECUTE_MODES:
        raise ValueError(f"execute must be one of {dispatch.EXECUTE_MODES}")


class ServingEngine:
    """Continuous-batching inference engine over the port's model stack.

    Construct with an ``ArchConfig`` (what model), an ``EngineConfig``
    (how to serve it) and a ``device`` (CUDA unless the caller names
    another; CUDA missing raises); ``submit()`` requests and drive
    ``step()`` until it returns False, or use ``run()`` for a whole
    request set.  Telemetry comes out of ``summary()`` / ``metrics`` /
    ``dispatch_stats()`` and the executed per-site tile plan out of
    ``gemm_plan``."""

    def __init__(self, cfg: ArchConfig, engine: EngineConfig = None,
                 params=None, dispatcher: Optional[SaraDispatcher] = None,
                 device: Optional[str] = None):
        from repro_torch.models.api import build_model

        self.cfg = cfg
        self.ecfg = e = engine or EngineConfig()
        _check_ported(e)
        self.model = build_model(cfg, device)
        self.device = self.model.device
        self.params = params if params is not None \
            else self.model.init(e.seed)
        if self.params["embed"].device != self.device:
            raise ValueError(f"params live on {self.params['embed'].device}, "
                             f"the engine on {self.device}")
        self.dispatcher = dispatcher if dispatcher is not None \
            else SaraDispatcher()
        self.metrics = ServingMetrics()
        self.kv_layout = "paged"
        # no prompt exceeds max_len, so a larger chunk would only pad the
        # batch with dead query rows the kernel still computes
        self.prefill_chunk = min(e.prefill_chunk, e.max_len)
        self._max_blocks_per_slot = -(-e.max_len // e.block_size)
        num_blocks = (e.num_blocks if e.num_blocks is not None
                      else e.num_slots * self._max_blocks_per_slot)
        self.pool = KVBlockPool(num_blocks, e.block_size)
        self.sched = ContinuousScheduler(
            e.num_slots, self.pool,
            max_prefills_per_step=e.max_prefills_per_step, reserve=e.reserve,
            prefill_chunk=self.prefill_chunk, metrics=self.metrics)
        self.requests: Dict[str, Request] = {}
        self.arena = KVArena(
            self.model.init_paged_arena(num_blocks + 1, e.block_size),
            e.block_size)
        self.pool.bind_arena(self.arena)
        self._kv_rows = np.zeros((e.num_slots,), np.int32)
        self._last_tok = np.zeros((e.num_slots, 1), np.int32)
        # what one masked-dense decode step would stream: every slot's full
        # capacity (the paged win the metrics report)
        self._dense_kv_rows = e.num_slots * e.max_len
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(e.seed + 1)
        self._vtime = 0.0
        self._t0 = time.time()
        self.registry = SiteRegistry()
        self.gemm_plan: Dict[str, str] = {}
        self.plan_changes = 0
        self.steps = 0

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
        """Adopt the executed plan of ``scope``."""
        plan = self.registry.plan(scope)
        if plan != self.gemm_plan:
            self.plan_changes += 1       # a real reconfiguration
            self.gemm_plan = plan

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
            tok = int(sampled[slot])
            req.generated.append(tok)
            self._last_tok[slot, 0] = tok
            self._first_token(req)
            if req.done():
                self._retire(req)

    def _retire(self, req: Request) -> None:
        slot = req.slot
        self.sched.retire(req, self.now())
        req.outcome = "done"
        self.metrics.on_retire(req.arrival_time, req.t_admit, req.t_done,
                               in_deadline=not req.expired_at(req.t_done))
        self._kv_rows[slot] = 0          # pages already back in the free list

    def _finish(self, req: Request, outcome: str, reason: str = "") -> None:
        """Terminal-failure bookkeeping (deadline/cancel sweep, preempt
        budget exhausted)."""
        slot = req.slot
        if not req.outcome:
            self.sched.finish(req, outcome, self.now(), reason=reason)
        self.metrics.on_finish(req.outcome)
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
        self._vtime += 1.0
        self.steps += 1
        return True

    def _step_body(self) -> None:
        plan = self.sched.plan(self.now())
        for req in plan.finished:
            self._finish(req, req.outcome)
        for req in plan.prefills:
            # reset lane bookkeeping on every admission: chunked prefill
            # extends the row count with `+=` from whatever is here
            self._kv_rows[req.slot] = req.prefill_pos
        self._do_chunk_prefills()

        # a request can finish at prefill and chunked lanes may still be
        # mid-prefill, so re-check the planned decode slots
        active = {s: self.sched.active[s] for s in plan.decode_slots
                  if s in self.sched.active
                  and not self.sched.active[s].prefilling}
        if active:
            # decide stalls BEFORE decoding: the coming step writes the KV
            # of each lane's pending token
            for slot, req in active.items():
                if not self.sched.grow(req,
                                       req.prompt_len + len(req.generated)):
                    self.metrics.stalls += 1
            logits, dt, kv_read = self._decode_paged(active)
            self._dispatch("decode")
            sampled = sample_logits(self._gen, logits, self.ecfg.temperature,
                                    self.ecfg.top_k).cpu().numpy()
            committed = 0
            for slot, req in sorted(active.items()):
                if req.stalled:
                    continue             # replays once the pool can cover it
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
        kv_read = e.block_size * sum(need)
        t0 = time.time()
        with torch.no_grad(), self._dispatch_scope("decode"):
            logits, _ = self.model.paged_decode_step(
                self.params, self._tensor(self._last_tok), self.arena.leaves,
                self._tensor(tables), self._tensor(kv), self._tensor(wm))
        self._sync()
        return logits, time.time() - t0, kv_read

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
        return {r.rid: np.asarray(r.generated, np.int32) for r in requests}

    def dispatch_stats(self) -> Dict[str, int]:
        """Executed-GEMM dispatch telemetry (registry-backed)."""
        backends: Dict[str, int] = {}
        for scope in self.registry.scopes():
            for b, c in self.registry.backends(scope).items():
                backends[b] = backends.get(b, 0) + c
        return {"gemm_plan_changes": self.plan_changes,
                "gemm_sites_executed": len(self.gemm_plan),
                "gemm_traced_scopes": len(self.registry.scopes()),
                "gemm_kernel_sites": backends.get("kernel", 0),
                "gemm_torch_sites": backends.get("torch", 0),
                "rec_oracle_sites": sum(
                    self.registry.sources(s).get("oracle", 0)
                    for s in self.registry.scopes())}

    def summary(self) -> Dict[str, float]:
        s = self.metrics.summary(self.dispatcher.cache_info(),
                                 dispatch=self.dispatch_stats())
        s["kv_layout"] = self.kv_layout
        s["kv_peak_blocks"] = self.pool.peak_in_use
        s["engine_steps"] = self.steps
        return s
