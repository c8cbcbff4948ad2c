"""Continuous-batching serving: page pool, prefix cache, scheduler,
metrics, speculative decoding, engine."""

from repro_torch.serving.engine import (EngineConfig, ServingEngine,
                                        sample_logits)
from repro_torch.serving.kv_pool import (KVArena, KVBlockPool, PoolError,
                                         SanitizerError)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import ContinuousScheduler, Request
from repro_torch.serving.spec_decode import (SpecDecoder, accept_tokens,
                                             resolve_draft)

__all__ = ["ContinuousScheduler", "EngineConfig", "KVArena", "KVBlockPool",
           "PoolError", "PrefixCache", "Request", "SanitizerError",
           "ServingEngine", "ServingMetrics", "SpecDecoder", "accept_tokens",
           "resolve_draft", "sample_logits"]
