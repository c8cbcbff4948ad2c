"""Trace export: Chrome/Perfetto trace-event JSON + structured JSONL.

``to_chrome_trace`` renders a :class:`~repro_torch.obs.trace.TraceRecorder`
buffer in the Chrome trace-event format (the JSON flavour Perfetto and
``chrome://tracing`` both load: open https://ui.perfetto.dev and drop
the file on it).  The port's copy of ``repro/obs/export.py``; the
functions are the reference's line for line.  Conventions:

  * one process (pid 1, named "serving"); each distinct event ``track``
    becomes a tid with a ``thread_name`` metadata record, so request
    tracks (``req:<rid>``), the engine-step timeline, dispatch, compile
    and arena rows render as separate labelled rows;
  * slice events are complete ("X") with microsecond ``ts``/``dur``;
    gauges are counter ("C") events and render as value tracks;
  * the recorder's always-on counters ride along in a trailing metadata
    event so a trace file is self-describing even without the JSONL.

``write_jsonl`` emits the same events one JSON object per line — the
grep/pandas-friendly form — with a leading ``meta`` line carrying
counters, gauges and per-scope wall times.

``validate_trace`` is the schema gate the tests and ``chip_smoke.py``
run: structural checks plus the cross-event invariants (per-step phase
slices monotonic and non-overlapping).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.obs.trace import (CATEGORIES, PH_COUNTER, PH_INSTANT, PH_SLICE,
                             TraceEvent, TraceRecorder)

PID = 1


def _tid_map(events: Iterable[TraceEvent]) -> Dict[str, int]:
    tids: Dict[str, int] = {}
    for ev in events:
        if ev.track not in tids:
            tids[ev.track] = len(tids)
    return tids


def to_chrome_trace(rec: TraceRecorder,
                    meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Render the recorder as a Chrome trace-event JSON object."""
    events = sorted(rec.events(), key=lambda e: e.ts)
    tids = _tid_map(events)
    out: List[Dict[str, Any]] = [
        {"ph": "M", "pid": PID, "tid": 0, "name": "process_name",
         "args": {"name": "serving"}}]
    for track, tid in tids.items():
        out.append({"ph": "M", "pid": PID, "tid": tid,
                    "name": "thread_name", "args": {"name": track}})
    for ev in events:
        rec_json: Dict[str, Any] = {
            "ph": ev.ph, "pid": PID, "tid": tids[ev.track],
            "cat": ev.cat, "name": ev.name,
            "ts": round(ev.ts * 1e6, 3), "args": dict(ev.args)}
        if ev.ph == PH_SLICE:
            rec_json["dur"] = round(ev.dur * 1e6, 3)
        elif ev.ph == PH_INSTANT:
            rec_json["s"] = "t"            # thread-scoped instant
        out.append(rec_json)
    return {"traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"counters": dict(rec.counters),
                          "gauges": dict(rec.gauges),
                          "scope_wall_s": {k: {"calls": v[0],
                                               "seconds": v[1]}
                                           for k, v in rec.scope_wall.items()},
                          "dropped_events": rec.dropped,
                          **(meta or {})}}


def write_chrome_trace(path: str, rec: TraceRecorder,
                       meta: Optional[Dict[str, Any]] = None) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(rec, meta), f)


def write_jsonl(path: str, rec: TraceRecorder,
                meta: Optional[Dict[str, Any]] = None) -> None:
    """One JSON object per line: a ``meta`` record (counters / gauges /
    per-scope wall time), then every buffered event in ts order."""
    with open(path, "w") as f:
        head = {"record": "meta", "counters": dict(rec.counters),
                "gauges": dict(rec.gauges),
                "scope_wall_s": {k: {"calls": v[0], "seconds": v[1]}
                                 for k, v in rec.scope_wall.items()},
                "dropped_events": rec.dropped, **(meta or {})}
        f.write(json.dumps(head) + "\n")
        for ev in sorted(rec.events(), key=lambda e: e.ts):
            f.write(json.dumps({
                "record": "event", "cat": ev.cat, "name": ev.name,
                "ph": ev.ph, "ts": ev.ts, "dur": ev.dur,
                "track": ev.track, "args": ev.args}) + "\n")


# ---------------------------------------------------------------------------
# schema validation (tests + chip_smoke.py)
# ---------------------------------------------------------------------------

_VALID_PH = {PH_SLICE, PH_INSTANT, PH_COUNTER, "M"}


def validate_trace(doc: Any,
                   require_categories: Iterable[str] = ()) -> List[str]:
    """Validate a loaded Chrome trace-event document against the event
    schema.  Returns a list of problems (empty = valid).  Checks:

      * top-level shape (``traceEvents`` list of dicts);
      * every event has ph/pid/tid/name, a known phase code, a known
        category (for non-metadata events), numeric non-negative ts, and
        a ``dur`` on complete slices;
      * per (tid, step) the ``step``-category phase slices are monotonic
        and non-overlapping (each phase starts at-or-after the previous
        phase's end) and sit inside their ``engine_step`` root;
      * each category in ``require_categories`` appears at least once.
    """
    errs: List[str] = []
    if not isinstance(doc, dict) or \
            not isinstance(doc.get("traceEvents"), list):
        return ["top level must be {'traceEvents': [...]}"]
    seen_cats: set = set()
    # (tid, step) -> list of (ts, dur, name) child phases + root extent
    phases: Dict[Any, List] = {}
    roots: Dict[Any, Any] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errs.append(f"event {i}: unknown phase code {ph!r}")
            continue
        if ph == "M":
            continue
        for k in ("pid", "tid", "name"):
            if k not in ev:
                errs.append(f"event {i}: missing {k!r}")
        cat = ev.get("cat")
        if cat not in CATEGORIES:
            errs.append(f"event {i}: unknown category {cat!r}")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == PH_SLICE and not isinstance(ev.get("dur"), (int, float)):
            errs.append(f"event {i}: slice without dur")
            continue
        seen_cats.add(cat)
        if cat == "step" and ph == PH_SLICE:
            step = (ev.get("args") or {}).get("step")
            key = (ev.get("tid"), step)
            if ev["name"] == "engine_step":
                roots[key] = (ts, ev["dur"])
            else:
                phases.setdefault(key, []).append((ts, ev["dur"],
                                                   ev["name"]))
    for key, ps in phases.items():
        ps.sort()
        end = None
        for ts, dur, name in ps:
            if end is not None and ts < end - 1e-6:
                errs.append(f"step {key[1]}: phase {name!r} overlaps the "
                            f"previous phase (starts {ts} < end {end})")
            end = ts + dur
        root = roots.get(key)
        if root is not None:
            r0, rd = root
            if ps[0][0] < r0 - 1e-6 or end > r0 + rd + 1e-6:
                errs.append(f"step {key[1]}: phases escape the engine_step "
                            "root slice")
    for cat in require_categories:
        if cat not in seen_cats:
            errs.append(f"no {cat!r} events in trace")
    return errs
