"""Serving observability: request-lifecycle spans, engine-step timeline,
dispatch / compile / KV-arena event tracing, Perfetto export (the port's
copy of ``repro/obs``).

  trace    TraceRecorder (ring-buffered events + always-on counters and
           gauges), JitWatch (new-signature detection on model calls)
  spans    RequestTracker (per-request lifecycle state machine with
           close-exactly-once invariants), StepTimeline (per-step phase
           breakdown)
  export   Chrome/Perfetto trace-event JSON + structured JSONL writers
           and the trace schema validator

Everything funnels into one :class:`TraceRecorder` owned by the
``ServingEngine`` (``EngineConfig.trace`` / ``serve.py --trace-out``);
an exported trace opens at https://ui.perfetto.dev.
"""

from repro_torch.obs.export import (to_chrome_trace, validate_trace,
                                    write_chrome_trace, write_jsonl)
from repro_torch.obs.spans import RequestTracker, StepTimeline
from repro_torch.obs.trace import (CATEGORIES, REQUIRED_CATEGORIES,
                                   JitWatch, TraceError, TraceEvent,
                                   TraceRecorder)

__all__ = ["CATEGORIES", "REQUIRED_CATEGORIES", "JitWatch", "TraceError",
           "TraceEvent", "TraceRecorder", "RequestTracker", "StepTimeline",
           "to_chrome_trace", "validate_trace", "write_chrome_trace",
           "write_jsonl"]
