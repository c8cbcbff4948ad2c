"""Continuous-batching serving: page pool, prefix cache, scheduler,
metrics, speculative decoding, engine, and its fault tolerance:

  faults     terminal request outcomes (failed / expired / shed /
             cancelled / rejected), fault attribution for the engine's
             step error boundary, and the seeded chaos harness
             (EngineConfig.chaos)
  snapshot   crash-safe engine snapshot / restore through the checkpoint
             manager (EngineConfig.snapshot_dir)

Every layer reports into the ``repro_torch.obs`` trace recorder the
engine owns; ``EngineConfig.trace`` (``serve --trace-out``) records its
events for a Chrome/Perfetto trace."""

from repro_torch.serving.engine import (EngineConfig, ServingEngine,
                                        sample_logits)
from repro_torch.serving.faults import (OUTCOME_COUNTERS, OUTCOMES,
                                        ChaosConfig, FaultInjector,
                                        attach_rids, fault_rids)
from repro_torch.serving.kv_pool import (KVArena, KVBlockPool, PoolError,
                                         SanitizerError)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import ContinuousScheduler, Request
from repro_torch.serving.spec_decode import (SpecDecoder, accept_tokens,
                                             resolve_draft)

__all__ = ["ChaosConfig", "ContinuousScheduler", "EngineConfig",
           "FaultInjector", "KVArena", "KVBlockPool", "OUTCOMES",
           "OUTCOME_COUNTERS", "PoolError", "PrefixCache", "Request",
           "SanitizerError", "ServingEngine", "ServingMetrics",
           "SpecDecoder", "accept_tokens", "attach_rids", "fault_rids",
           "resolve_draft", "sample_logits"]
