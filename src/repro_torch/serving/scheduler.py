"""Continuous-batching request scheduler.

Wave-based serving (``launch/serve.py::serve_waves``) admits a whole batch,
decodes until the *longest* member finishes, then starts over — short
requests pad out the wave and the array idles, the serving-side analogue of
the shape-diversity/utilization problem SARA targets.  This scheduler
instead re-plans every decode step: finished requests retire immediately,
their KV blocks return to the pool, and queued requests are admitted into
the freed slots mid-flight.

The engine owns the model math; the scheduler owns admission:

  submit()  enqueue a Request (FCFS by arrival time)
  plan(now) -> StepPlan: which queued requests to prefill into which free
              slots this step (bounded by ``max_prefills_per_step`` and the
              KV pool budget), plus the set of slots to decode
  grow()    per-token block-table extension (incremental mode)
  retire()  free the slot + every KV block of a finished request

Admission control: ``reserve="full"`` reserves blocks for the worst case
(prompt + max_new + 1) at admit time, so a decode can never OOM;
``reserve="incremental"`` admits on prompt-size blocks only and extends
block-by-block during decode — denser packing, and a slot whose extension
fails simply stalls (skips sampling) until another request retires.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.kv_pool import KVBlockPool, PoolError


@dataclass
class Request:
    """One serving request: immutable inputs + engine-owned runtime state.

    ``prompt`` is the (prompt_len,) int32 token array; ``extras`` carries
    per-request model inputs for the non-text families (vlm patch embeds,
    encdec source features) at batch size 1.  The engine mutates the
    runtime fields; callers should treat them as read-only telemetry.
    """

    rid: str
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int
    arrival_time: float = 0.0
    eos_id: Optional[int] = None
    extras: Optional[Dict] = None       # per-request vlm/encdec inputs (B=1)
    # completion deadline in seconds after ``arrival_time`` (engine-clock
    # units: wall seconds or virtual steps).  The scheduler expires a
    # queued request once the deadline passes, and sheds it at admission
    # when the rolling-TTFT estimate says the deadline cannot be met.
    deadline_s: Optional[float] = None

    # runtime state (engine-owned)
    generated: List[int] = field(default_factory=list)
    slot: int = -1
    stalled: bool = False
    # terminal outcome ("" while live): done | failed | expired | shed |
    # cancelled | rejected — see serving/faults.py
    outcome: str = ""
    # preempt/readmit cycles consumed (engine fails the request when it
    # exceeds EngineConfig.preempt_budget — the livelock guard)
    preempt_count: int = 0
    cancel_requested: bool = False
    # prefill phase: ``prefilling`` is set at admission and cleared when the
    # prefill completes (bucketed: same step; chunked: after the final
    # chunk); ``prefill_pos`` counts context tokens already streamed into
    # the cache during the current prefill
    prefilling: bool = False
    prefill_pos: int = 0
    # prefix-cache telemetry: tokens / pages the current admission mapped
    # from the cache instead of recomputing (reset on preempt)
    cached_prefix_tokens: int = 0
    cached_pages: int = 0
    t_admit: float = -1.0
    t_first_token: float = -1.0
    t_done: float = -1.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def context_len(self) -> int:
        """Tokens a (re-)prefill must cover: prompt plus anything already
        generated before a preemption."""
        return self.prompt_len + len(self.generated)

    def context(self) -> np.ndarray:
        """The (context_len,) token array a (re-)prefill streams — the
        recompute-on-readmit contract shared by the bucketed and chunked
        prefill paths."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and len(self.generated) > 0
                and self.generated[-1] == self.eos_id)

    def cancel(self) -> None:
        """Revoke the request.  Takes effect at the next scheduling pass:
        queued or active, the request leaves the system with outcome
        ``cancelled`` and its pages return to the pool."""
        self.cancel_requested = True

    def expired_at(self, now: float) -> bool:
        """Deadline already missed at engine time ``now`` (always False
        without a deadline, or before the request has even arrived)."""
        return (self.deadline_s is not None
                and self.arrival_time <= now
                and now - self.arrival_time > self.deadline_s)


@dataclass
class StepPlan:
    prefills: List[Request]             # admitted this step (slot assigned)
    decode_slots: List[int]             # slots active after the prefills
    # requests the scheduling pass terminated (expired / shed /
    # cancelled) — the engine finishes their metrics/obs bookkeeping
    finished: List[Request] = field(default_factory=list)


class ContinuousScheduler:
    """Admission control for the serving engine: maps queued requests to
    decode slots and meters their KV pages through the shared
    :class:`~repro.serving.kv_pool.KVBlockPool`.

    ``prefill_chunk`` (when the engine streams prompts in chunks) makes
    incremental-mode page reservations *chunk-incremental*: admission
    reserves only the first chunk's pages and each later chunk extends the
    table via :meth:`grow`, so a request preempted mid-prefill frees
    exactly the pages it has written — not a full-prompt reservation it
    never used.  Full-prompt reservation at admission (the pre-chunking
    behaviour) assumed the whole prompt lands in pages the same step it is
    admitted."""

    def __init__(self, num_slots: int, pool: KVBlockPool,
                 max_prefills_per_step: int = 1, reserve: str = "full",
                 token_overhead: int = 0,
                 prefill_chunk: Optional[int] = None,
                 tracker=None, prefix_cache=None, metrics=None):
        if reserve not in ("full", "incremental"):
            raise ValueError(reserve)
        self.num_slots = num_slots
        self.pool = pool
        # request-lifecycle span tracker (repro.obs.RequestTracker): the
        # scheduler owns the admit/preempt/retire transitions, so it is
        # the layer that stamps them into the trace
        self.tracker = tracker
        self.max_prefills_per_step = max_prefills_per_step
        self.reserve = reserve
        # extra KV rows every request's block table must also cover beyond
        # its text tokens — the vlm frontend's per-slot rows when the paged
        # arena stores them in pool pages (0 under the dense layout, where
        # that overhead lives outside the metered budget)
        self.token_overhead = token_overhead
        self.prefill_chunk = prefill_chunk
        # optional PrefixCache (serving/prefix_cache.py): admission matches
        # each prompt's longest cached prefix, shares those pages into the
        # new table, and reserves pool blocks only for the suffix
        self.prefix_cache = prefix_cache
        # optional ServingMetrics: the rolling-TTFT window feeds the
        # load-shedding estimate, and plan() counts cache-miss fallbacks
        self.metrics = metrics
        self.waiting: deque = deque()
        self.active: Dict[int, Request] = {}
        self._free_slots = list(range(num_slots - 1, -1, -1))

    # -- queue ----------------------------------------------------------------
    def submit(self, req: Request) -> None:
        # a request whose admission-time reservation exceeds the whole
        # pool can never be admitted: plan() would break on it (FCFS)
        # forever — reject up front instead of livelocking the queue
        # head.  The floor follows the reservation policy: full mode
        # reserves worst-case (prompt + max_new + 1) at admit time, so
        # that whole footprint must fit; incremental modes only ever
        # need the prompt's pages live at once to finish a prefill.
        if self.reserve == "full":
            floor_tokens = (self.token_overhead + req.prompt_len
                            + req.max_new_tokens + 1)
            what = "worst-case reservation"
        else:
            floor_tokens = self.token_overhead + req.prompt_len
            what = "prompt"
        floor = self.pool.blocks_for(floor_tokens)
        if floor > self.pool.num_blocks:
            raise PoolError(
                f"request {req.rid}: {what} needs {floor} blocks, pool has "
                f"{self.pool.num_blocks} — can never be admitted")
        self.waiting.append(req)
        if self.tracker is not None:
            self.tracker.on_submit(req.rid, prompt_len=req.prompt_len,
                                   max_new=req.max_new_tokens)

    def pending(self) -> int:
        return len(self.waiting)

    def idle(self) -> bool:
        return not self.waiting and not self.active

    # -- planning -------------------------------------------------------------
    def _reservation(self, req: Request, cached_tokens: int = 0) -> int:
        if self.reserve == "full":
            return self.token_overhead + req.prompt_len + req.max_new_tokens + 1
        if self.prefill_chunk:
            # chunk-incremental: admission covers only the first chunk's
            # rows (+ the per-request overhead); every later chunk and
            # decoded token extends through grow(), so mid-prefill
            # preemption frees exactly what was written.  A cache hit
            # starts the first chunk at the cached offset, so the
            # reservation covers the shared pages plus one chunk.
            return self.token_overhead + min(cached_tokens + self.prefill_chunk,
                                             req.context_len)
        return self.token_overhead + req.context_len + 1

    def _match_prefix(self, req: Request):
        """(pages, cached_offset) for the head-of-queue request: the
        longest cached prefix's pages and the context position prefill
        resumes from.  The offset is capped at ``prompt_len - 1`` so at
        least one suffix token is always recomputed — the final chunk must
        emit first-token logits even when the cache covers the whole
        prompt (the write into that last shared page is what exercises
        copy-on-write)."""
        if self.prefix_cache is None or not self.prefill_chunk:
            return [], 0
        pages = self.prefix_cache.match(req.prompt)
        if not pages:
            return [], 0
        offset = min(len(pages) * self.pool.block_size, req.prompt_len - 1)
        return pages, offset

    def plan(self, now: float = float("inf")) -> StepPlan:
        """Terminate cancelled/expired requests, shed admissions that can
        no longer meet their deadline, then admit up to
        ``max_prefills_per_step`` arrived requests into free slots, KV
        budget permitting, then decode every active slot.  (``now`` =
        inf, the no-clock default, disables the deadline machinery —
        there is no time to judge a deadline against.)"""
        finished: List[Request] = []
        timed = np.isfinite(now)
        # cancellation reaches active lanes too: their slot and pages
        # free here, before admission can use them
        for req in [r for r in self.active.values() if r.cancel_requested]:
            self.finish(req, "cancelled", now)
            finished.append(req)
        for req in [r for r in self.waiting
                    if r.cancel_requested or (timed and r.expired_at(now))]:
            self.finish(req, "cancelled" if req.cancel_requested
                        else "expired", now)
            finished.append(req)
        prefills: List[Request] = []
        while (len(prefills) < self.max_prefills_per_step
               and self._free_slots and self.waiting
               and self.waiting[0].arrival_time <= now):
            req = self.waiting[0]
            # load shedding: when the live TTFT estimate already exceeds
            # the head's remaining deadline budget, admitting it would
            # only burn pool pages on a doomed request — drop it now,
            # with its own terminal outcome so callers can retry later
            if timed and req.deadline_s is not None \
                    and self.metrics is not None:
                est = self.metrics.ttft_estimate()
                if est is not None and \
                        (now - req.arrival_time) + est > req.deadline_s:
                    self.waiting.popleft()
                    self.finish(req, "shed", now)
                    finished.append(req)
                    continue
            pages, offset = self._match_prefix(req)
            reservation = self._reservation(req, cached_tokens=offset)
            need_new = self.pool.blocks_for(reservation) - len(pages)
            if need_new > self.pool.num_free:
                # pool pressure: reclaim LRU unpinned cache entries before
                # giving up on the queue head.  The matched pages are
                # excluded — no table references them yet (pin-only), so
                # eviction of their trie descendants would otherwise
                # expose them as evictable leaves and share() below would
                # hit a dead page.
                if self.prefix_cache is not None:
                    self.prefix_cache.evict(need_new - self.pool.num_free,
                                            exclude=pages)
                if need_new > self.pool.num_free and pages:
                    # still short while protecting the hit: give the hit
                    # up and retry as a cache miss, which makes the
                    # matched pages themselves reclaimable
                    pages, offset = [], 0
                    reservation = self._reservation(req, cached_tokens=0)
                    need_new = self.pool.blocks_for(reservation)
                    if need_new > self.pool.num_free:
                        self.prefix_cache.evict(
                            need_new - self.pool.num_free)
                    self._count_fallback(req)
                if need_new > self.pool.num_free:
                    break                # FCFS: don't starve the head
            self.waiting.popleft()
            req.slot = self._free_slots.pop()
            req.t_admit = now if now != float("inf") else req.arrival_time
            req.prefilling = True
            if pages:
                # map the cached prefix pages, then reserve the suffix
                self.pool.share(req.rid, pages)
                self.pool.extend(req.rid, max(
                    reservation, len(pages) * self.pool.block_size))
                req.prefill_pos = offset
                req.cached_prefix_tokens = offset
                req.cached_pages = len(pages)
            else:
                self.pool.alloc(req.rid, reservation)
                req.prefill_pos = 0
                req.cached_prefix_tokens = 0
                req.cached_pages = 0
            if self.prefix_cache is not None and self.prefill_chunk:
                self.prefix_cache.record_lookup(len(pages))
            self.active[req.slot] = req
            prefills.append(req)
            if self.tracker is not None:
                self.tracker.on_admit(req.rid, slot=req.slot)
        return StepPlan(prefills, sorted(self.active), finished)

    def _count_fallback(self, req: Request) -> None:
        """A matched prefix was abandoned under pool pressure and the
        admission retried as a cache miss.  Count it: each fallback
        silently re-prefills tokens the cache had, so a storm of these
        erases the prefix-cache win while hit-rate still looks healthy."""
        if self.metrics is not None:
            self.metrics.prefix_cache_fallbacks += 1
        if self.tracker is not None:
            rec = self.tracker.rec
            rec.count("prefix_cache_fallbacks", 1)
            rec.instant("arena", "prefix_cache_fallback", track="arena",
                        rid=req.rid)

    # -- per-token growth (incremental mode) ----------------------------------
    def grow(self, req: Request, total_tokens: int) -> bool:
        """Ensure the request's block table covers ``total_tokens`` (plus
        the per-request ``token_overhead``); returns False (stall) when the
        pool cannot extend."""
        total_tokens += self.token_overhead
        table = self.pool.table(req.rid)
        if table.capacity(self.pool.block_size) >= total_tokens:
            table.num_tokens = max(table.num_tokens, total_tokens)
            req.stalled = False
            return True
        need = self.pool.blocks_for(total_tokens) - len(table.blocks)
        if need > self.pool.num_free and self.prefix_cache is not None:
            self.prefix_cache.evict(need - self.pool.num_free)
        try:
            self.pool.extend(req.rid, total_tokens)
            req.stalled = False
            return True
        except PoolError:
            req.stalled = True
            return False

    # -- retirement -----------------------------------------------------------
    def retire(self, req: Request, now: float = 0.0) -> None:
        del self.active[req.slot]
        self.pool.free(req.rid)
        self._free_slots.append(req.slot)
        req.t_done = now
        req.slot = -1
        if self.tracker is not None:
            self.tracker.on_retire(req.rid, tokens=len(req.generated))

    def finish(self, req: Request, outcome: str, now: float = 0.0,
               reason: str = "") -> None:
        """Terminally remove a request on a *failure* outcome (``failed``
        / ``expired`` / ``shed`` / ``cancelled``), queued or active:
        free its slot and pages and close its span with the outcome.
        ``retire`` remains the normal-completion path; engine-side
        bookkeeping (outcome counters, lane arrays) is the caller's job."""
        if req.slot >= 0 and self.active.get(req.slot) is req:
            del self.active[req.slot]
            self._free_slots.append(req.slot)
        else:
            try:
                self.waiting.remove(req)
            except ValueError:
                pass                    # already off the queue (shed path)
        if req.rid in self.pool.live_requests():
            self.pool.free(req.rid)
        req.slot = -1
        req.stalled = False
        req.prefilling = False
        req.outcome = outcome
        req.t_done = now if np.isfinite(now) else req.arrival_time
        if self.tracker is not None:
            self.tracker.on_finish(req.rid, outcome=outcome, reason=reason)

    # -- preemption -----------------------------------------------------------
    def preempt(self, req: Request) -> None:
        """Evict an admitted-but-unfinished request: free its slot and KV
        blocks and requeue it at the head (recompute-on-readmit).  Unlike
        ``retire`` this resets the lifecycle fields admission/stalling
        stamped — a preempted request is NOT done, so ``t_done`` must stay
        unset until a real retirement records it (metrics would otherwise
        inherit a stale completion time)."""
        del self.active[req.slot]
        self.pool.free(req.rid)
        self._free_slots.append(req.slot)
        req.slot = -1
        req.stalled = False
        req.prefilling = False       # recompute-on-readmit streams anew
        req.prefill_pos = 0
        req.cached_prefix_tokens = 0
        req.cached_pages = 0
        req.t_done = -1.0
        self.waiting.appendleft(req)
        if self.tracker is not None:
            self.tracker.on_preempt(req.rid, tokens=len(req.generated))
