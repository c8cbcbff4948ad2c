"""Request-lifecycle span tracking with close-exactly-once invariants
(the port's copy of ``repro/obs/spans.py``).

A request's life is a tree of spans on its own trace track
(``req:<rid>``):

    request ─┬─ queue      submit -> admit           (re-opens on preempt)
             ├─ active     admit -> retire | preempt
             │    ├─ prefill_chunk  (one slice per streamed chunk)
             │    └─ first_token    (instant)
             └─ ... (queue/active repeat per preempt -> readmit cycle)

The tracker is a small state machine (``queued`` -> ``active`` ->
``done``, with ``active`` -> ``queued`` on preemption) that makes the
close-exactly-once invariant structural: the root span closes exactly once, at
retirement, no matter how many preempt/readmit cycles happened in
between; closing twice or transitioning illegally raises
:class:`~repro_torch.obs.trace.TraceError` instead of silently corrupting the
trace.  State bookkeeping is always on (it is a dict update per
transition); the emitted slices obey the recorder's ``spans`` toggle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.obs.trace import PH_SLICE, TraceError, TraceRecorder
from repro_torch.obs.trace import TraceEvent

QUEUED, ACTIVE, DONE = "queued", "active", "done"


@dataclass
class _ReqState:
    state: str
    t_root: float          # root span open (submit)
    t_phase: float         # current queue/active span open
    preempts: int = 0
    chunks: int = 0


class RequestTracker:
    """Per-request lifecycle spans recorded by the engine/scheduler."""

    def __init__(self, rec: TraceRecorder):
        self.rec = rec
        self._live: Dict[str, _ReqState] = {}
        self.closed = 0                     # root spans closed (== retires)

    # -- helpers -------------------------------------------------------------
    def _track(self, rid: str) -> str:
        return f"req:{rid}"

    def _need(self, rid: str, *states: str) -> _ReqState:
        st = self._live.get(rid)
        if st is None:
            raise TraceError(f"request {rid}: no open span "
                             "(submit was never tracked, or already retired)")
        if st.state not in states:
            raise TraceError(f"request {rid}: invalid transition from "
                             f"{st.state!r} (expected one of {states})")
        return st

    def open_requests(self) -> Dict[str, str]:
        """rid -> state for every request whose root span is still open."""
        return {rid: st.state for rid, st in self._live.items()}

    # -- transitions ---------------------------------------------------------
    def on_submit(self, rid: str, **args) -> None:
        if rid in self._live:
            raise TraceError(f"request {rid}: submitted twice")
        now = self.rec.now()
        self._live[rid] = _ReqState(QUEUED, now, now)
        self.rec.instant("request", "submit", self._track(rid), rid=rid,
                         **args)

    def on_admit(self, rid: str, slot: int = -1, **args) -> None:
        st = self._need(rid, QUEUED)
        now = self.rec.now()
        self.rec.slice("request", "queue", st.t_phase, now - st.t_phase,
                       self._track(rid), rid=rid, readmit=st.preempts > 0)
        st.state, st.t_phase = ACTIVE, now
        self.rec.instant("request", "admit", self._track(rid), rid=rid,
                         slot=slot, **args)

    def on_prefill_chunk(self, rid: str, tokens: int, dur: float,
                         **args) -> None:
        st = self._need(rid, ACTIVE)
        st.chunks += 1
        self.rec.slice("request", "prefill_chunk", self.rec.now() - dur,
                       dur, self._track(rid), rid=rid, tokens=tokens, **args)

    def on_cache_hit(self, rid: str, **args) -> None:
        """Prefix-cache hit at admission: the request's first ``tokens``
        context tokens were mapped from cached pages instead of
        prefilled."""
        self._need(rid, ACTIVE)
        self.rec.instant("request", "cache_hit", self._track(rid),
                         rid=rid, **args)

    def on_first_token(self, rid: str, **args) -> None:
        self._need(rid, ACTIVE)
        self.rec.instant("request", "first_token", self._track(rid),
                         rid=rid, **args)

    def on_preempt(self, rid: str, **args) -> None:
        """Active -> queued: close the active span (outcome=preempt) and
        re-open the queue span — the root stays open across the cycle."""
        st = self._need(rid, ACTIVE)
        now = self.rec.now()
        st.preempts += 1
        self.rec.slice("request", "active", st.t_phase, now - st.t_phase,
                       self._track(rid), rid=rid, outcome="preempt", **args)
        st.state, st.t_phase = QUEUED, now

    def on_retire(self, rid: str, **args) -> None:
        """Close the active span and the root — exactly once per request."""
        st = self._need(rid, ACTIVE)
        now = self.rec.now()
        self.rec.slice("request", "active", st.t_phase, now - st.t_phase,
                       self._track(rid), rid=rid, outcome="retire")
        self.rec.slice("request", "request", st.t_root, now - st.t_root,
                       self._track(rid), rid=rid, preempts=st.preempts,
                       chunks=st.chunks, **args)
        del self._live[rid]
        self.closed += 1

    def on_finish(self, rid: str, outcome: str, reason: str = "",
                  **args) -> None:
        """Terminal-failure closure (failed / expired / shed / cancelled):
        close whatever phase span is open — ``queue`` for a request that
        never got a slot, ``active`` for one that did — then the root,
        exactly once, mirroring ``on_retire``'s invariant for the failure
        outcomes the fault boundary and deadline sweep produce."""
        st = self._need(rid, QUEUED, ACTIVE)
        now = self.rec.now()
        phase = "active" if st.state == ACTIVE else "queue"
        self.rec.slice("request", phase, st.t_phase, now - st.t_phase,
                       self._track(rid), rid=rid, outcome=outcome)
        self.rec.instant("request", outcome, self._track(rid), rid=rid,
                         reason=reason)
        self.rec.slice("request", "request", st.t_root, now - st.t_root,
                       self._track(rid), rid=rid, outcome=outcome,
                       preempts=st.preempts, chunks=st.chunks, **args)
        del self._live[rid]
        self.closed += 1


class StepTimeline:
    """Engine-step timeline: one root slice per step on the ``engine``
    track with sequential child phases (schedule / prefill / decode /
    sample / sync).  Phases are measured with the recorder's monotonic
    clock inside a single thread, so per-step phase slices are
    monotonic and non-overlapping by construction."""

    def __init__(self, rec: TraceRecorder):
        self.rec = rec
        self.steps = 0
        self._open: Optional[float] = None

    def begin(self) -> int:
        if self._open is not None:
            raise TraceError("step span already open")
        self._open = self.rec.now()
        return self.steps

    def phase(self, name: str, **args):
        """``with tl.phase("decode"): ...`` — one child slice."""
        if self._open is None:
            raise TraceError("phase() outside an open step")
        return self.rec.span("step", name, track="engine", step=self.steps,
                             **args)

    def end(self, **args) -> None:
        if self._open is None:
            raise TraceError("step span not open")
        now = self.rec.now()
        if self.rec.spans:
            # root emitted after its children; the export sorts by ts so
            # Perfetto still nests the phases underneath it
            self.rec._append(TraceEvent(
                "step", "engine_step", PH_SLICE, self._open,
                now - self._open, "engine", {"step": self.steps, **args}))
        self._open = None
        self.steps += 1
