"""Low-overhead event tracing for the serving stack (the port's copy of
``repro/obs/trace.py``: the recorder, the event record and the closed
taxonomy are the reference's; ``JitWatch`` is rebuilt for eager PyTorch).

The :class:`TraceRecorder` is the single sink every layer reports into:

  * **counters** (monotonic) and **gauges** (last-value) are always on —
    a dict update per call, cheap enough for the hot loop regardless of
    whether span recording is enabled;
  * **events** (Perfetto-style slices and instants) land in a bounded
    ring buffer only when ``spans`` is enabled (``EngineConfig.trace`` /
    ``--trace-out``), so a production engine with tracing off pays one
    branch per would-be event.

Every event carries a *category* from :data:`CATEGORIES`:

  ``request``   per-request lifecycle spans (queue / active / prefill
                chunks / first token) — see ``obs/spans.py``
  ``step``      engine-step timeline with phase breakdown (schedule /
                prefill / decode / sample / sync)
  ``dispatch``  GEMM-site resolution at trace time (site, (M,K,N), chosen
                tile, recommendation source, analytic cost) plus per-call
                wall time of each traced scope
  ``compile``   a watched model call met an argument signature it had not
                seen (the port's stand-in for a jit retrace; see
                :class:`JitWatch`) — the raw signal behind width-bucket /
                shape-diversity retrace storms
  ``arena``     KV block pool traffic (reserve / grow / free / defrag)
  ``fault``     chaos-harness injections and step-level containment
                (``serving/faults.py``) — absent from healthy runs, so
                trace validation requires only :data:`REQUIRED_CATEGORIES`

Timestamps are wall seconds relative to recorder construction
(``time.perf_counter`` — monotonic, so step-phase slices never overlap or
run backwards even if the system clock steps).  ``obs/export.py`` turns
the buffer into Chrome/Perfetto trace-event JSON and structured JSONL.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from torch.utils._pytree import tree_leaves

CATEGORIES = ("request", "step", "dispatch", "compile", "arena", "fault")

# The categories every healthy serve trace must contain.  "fault" events
# only exist when chaos injection or step-level containment actually
# fired, so the trace gates (tests, chip_smoke.py) require this subset,
# not CATEGORIES.
REQUIRED_CATEGORIES = ("request", "step", "dispatch", "compile", "arena")

# The closed taxonomy of step-timeline phases and metric series, the
# reference's names unchanged.  Export validation (obs/export.py)
# enforces CATEGORIES at runtime; tests/test_torch_obs.py holds every
# recorder call site of the port to all four tuples, so a typo'd literal
# fails a test instead of silently creating an orphan series.
STEP_PHASES = ("schedule", "prefill", "prefill_chunk", "decode",
               "paged_decode", "spec_draft", "spec_verify", "sample",
               "sync")

COUNTERS = ("jit_compiles", "dispatch_records", "kv_defrag_auto",
            "shared_prefix_steps", "prefix_cache_inserted_pages",
            "prefix_cache_evicted_pages", "kv_sanitize_checks",
            "kv_poison_hits", "kv_generation_faults",
            # fault tolerance (serving/faults.py + the engine's step
            # error boundary): injections, containments, engine-level
            # step retries, terminal request outcomes, snapshots
            "faults_injected", "faults_contained", "engine_step_retries",
            "preempt_budget_exhausted", "prefix_cache_fallbacks",
            "requests_failed", "requests_expired", "requests_shed",
            "requests_cancelled", "requests_rejected",
            "engine_snapshots", "engine_restores",
            # speculative decoding (serving/spec_decode.py): verify
            # steps taken, draft tokens proposed/accepted, bonus tokens
            # committed from the verify argmax, draft-pool preemptions
            "spec_steps", "spec_drafted_tokens", "spec_accepted_tokens",
            "spec_bonus_tokens", "spec_draft_preempts")

GAUGES = ("kv_pages_in_use", "kv_fragmentation", "slot_occupancy",
          "decode_table_width", "shared_prefix_lanes",
          "spec_accepted_per_step")

# Perfetto phase codes used by the export ("X" complete slice with a
# duration, "i" instant, "C" counter sample)
PH_SLICE, PH_INSTANT, PH_COUNTER = "X", "i", "C"


class TraceError(RuntimeError):
    """A lifecycle invariant was violated (e.g. a span closed twice)."""


@dataclass
class TraceEvent:
    """One trace event.  ``ts``/``dur`` are seconds on the recorder's
    monotonic clock; ``track`` names the Perfetto row the event renders
    on (the export maps tracks to tids)."""

    cat: str
    name: str
    ph: str = PH_INSTANT
    ts: float = 0.0
    dur: float = 0.0
    track: str = "engine"
    args: Dict[str, Any] = field(default_factory=dict)


class _Span:
    """Context manager measuring one slice; created by ``TraceRecorder.span``."""

    __slots__ = ("_rec", "_ev")

    def __init__(self, rec: "TraceRecorder", ev: Optional[TraceEvent]):
        self._rec = rec
        self._ev = ev

    def __enter__(self) -> "_Span":
        if self._ev is not None:
            self._ev.ts = self._rec.now()
        return self

    def __exit__(self, *exc) -> None:
        if self._ev is not None:
            self._ev.dur = self._rec.now() - self._ev.ts
            self._rec._append(self._ev)


class TraceRecorder:
    """Ring-buffered event sink + always-on counters/gauges.

    ``capacity`` bounds the event buffer (oldest events drop first;
    ``dropped`` counts them so an export can say it is a suffix).  With
    ``spans=False`` (the default in production) ``emit``/``span``/
    ``instant`` are no-ops and only counters/gauges accrue.
    """

    def __init__(self, capacity: int = 65536, spans: bool = False):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.spans = spans
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        # per-scope wall-clock accumulation for the dispatch layer: the
        # measured-runtime side of profile-calibrated dispatch
        self.scope_wall: Dict[str, List[float]] = {}   # scope -> [calls, s]
        self.dropped = 0
        self._events: deque = deque(maxlen=capacity)
        self._t0 = time.perf_counter()
        # JitWatch's stand-in for a jit trace: None outside every watched
        # call, else whether the innermost one met a new argument signature
        # (a jit would trace it); ``traced`` holds the dispatch sites that
        # call has recorded (see dispatch/registry.py)
        self.tracing: Optional[bool] = None
        self.traced: set = set()

    # -- clock ---------------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter() - self._t0

    # -- always-on telemetry -------------------------------------------------
    def count(self, name: str, delta: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta

    def gauge(self, name: str, value: float, track: str = "gauges") -> None:
        """Record a sampled value; also emits a Perfetto counter event when
        span recording is on (one counter row per gauge name)."""
        self.gauges[name] = value
        if self.spans:
            self._append(TraceEvent("step", name, PH_COUNTER, self.now(),
                                    0.0, track, {"value": value}))

    def add_scope_wall(self, scope: str, seconds: float) -> None:
        """Attribute one traced-scope call's wall time (always on — this is
        the per-site measured timing profile-calibrated dispatch needs)."""
        cell = self.scope_wall.setdefault(scope, [0, 0.0])
        cell[0] += 1
        cell[1] += seconds

    # -- events (span recording) ---------------------------------------------
    def _append(self, ev: TraceEvent) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    def emit(self, cat: str, name: str, ph: str = PH_INSTANT,
             ts: Optional[float] = None, dur: float = 0.0,
             track: str = "engine", **args) -> None:
        if not self.spans:
            return
        self._append(TraceEvent(cat, name, ph,
                                self.now() if ts is None else ts,
                                dur, track, args))

    def instant(self, cat: str, name: str, track: str = "engine",
                **args) -> None:
        self.emit(cat, name, PH_INSTANT, track=track, **args)

    def slice(self, cat: str, name: str, ts: float, dur: float,
              track: str = "engine", **args) -> None:
        """A completed slice whose endpoints were measured by the caller."""
        self.emit(cat, name, PH_SLICE, ts=ts, dur=dur, track=track, **args)

    def span(self, cat: str, name: str, track: str = "engine",
             **args) -> _Span:
        """``with rec.span("step", "decode"): ...`` — measures the block's
        wall time and emits one slice (no-op when spans are off)."""
        if not self.spans:
            return _Span(self, None)
        return _Span(self, TraceEvent(cat, name, PH_SLICE, 0.0, 0.0,
                                      track, args))

    # -- read-back -----------------------------------------------------------
    def events(self, cat: Optional[str] = None) -> List[TraceEvent]:
        if cat is None:
            return list(self._events)
        return [e for e in self._events if e.cat == cat]

    def __len__(self) -> int:
        return len(self._events)

    def __iter__(self) -> Iterator[TraceEvent]:
        return iter(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.counters.clear()
        self.gauges.clear()
        self.scope_wall.clear()
        self.dropped = 0


class JitWatch:
    """Wrap a model call and emit a ``compile`` event whenever a call meets
    an argument signature it has not seen: the port runs eagerly and has
    no jit cache to probe, so it keeps the reference's own fallback, the
    set of distinct argument signatures (the shape and dtype of every
    tensor leaf, walked with ``torch.utils._pytree``).  A new signature is
    where the reference's jit traces and compiles, so the names, the
    ``compile:<fn>`` events and the ``jit_compiles`` /
    ``jit_compiles.<fn>`` counters count the same calls.

    The one-time ``nvcc`` build of the CUDA kernels
    (``kernels/_build.py``) is not a compile event: it happens once per
    machine, at the first kernel call of the process, before any engine
    exists, and its seconds are ``_build.build_seconds``.

    While a call with a new signature runs, ``rec.tracing`` is True (False
    for a signature already seen), so the site registry emits its
    ``dispatch`` events exactly where the reference records them: at
    trace time, once a site.  The ``jit_compiles`` counter is always on;
    the event (with the call's tensor shapes) lands in the buffer only
    when span recording is enabled.
    """

    def __init__(self, fn, name: str, rec: TraceRecorder):
        self.fn = fn
        self.name = name
        self.rec = rec
        self._sigs: set = set()

    @staticmethod
    def _shapes(args: Tuple[Any, ...], limit: int = 8) -> List[str]:
        """Compact shape summary of the call's tensor leaves (first
        ``limit`` distinct shapes — enough to identify the retrace)."""
        out: List[str] = []
        for leaf in tree_leaves(args):
            s = getattr(leaf, "shape", None)
            if s is None:
                continue
            d = "x".join(str(int(x)) for x in s) or "scalar"
            if d not in out:
                out.append(d)
                if len(out) >= limit:
                    break
        return out

    def __call__(self, *args):
        sig = tuple((tuple(a.shape) if hasattr(a, "shape") else None,
                     str(getattr(a, "dtype", type(a))))
                    for a in tree_leaves(args))
        new = sig not in self._sigs
        self._sigs.add(sig)
        rec = self.rec
        outer = (rec.tracing, rec.traced)
        rec.tracing, rec.traced = new, set()
        t0 = time.perf_counter()
        try:
            out = self.fn(*args)
        finally:
            rec.tracing, rec.traced = outer
        if new:
            dur = time.perf_counter() - t0
            rec.count("jit_compiles")
            rec.count(f"jit_compiles.{self.name}")
            rec.emit("compile", f"compile:{self.name}", PH_SLICE,
                     ts=rec.now() - dur, dur=dur, track="compile",
                     fn=self.name, shapes=self._shapes(args),
                     cache_entries=len(self._sigs))
        return out
