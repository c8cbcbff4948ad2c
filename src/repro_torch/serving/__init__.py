"""Continuous-batching serving: page pool, scheduler, metrics, engine."""

from repro_torch.serving.engine import (EngineConfig, ServingEngine,
                                        sample_logits)
from repro_torch.serving.kv_pool import (KVArena, KVBlockPool, PoolError,
                                         SanitizerError)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.scheduler import ContinuousScheduler, Request

__all__ = ["ContinuousScheduler", "EngineConfig", "KVArena", "KVBlockPool",
           "PoolError", "Request", "SanitizerError", "ServingEngine",
           "ServingMetrics", "sample_logits"]
