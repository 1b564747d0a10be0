"""Continuous-batching serving over the diffusion tick: slot pool,
scheduler policies, metrics and the engine."""
from repro_torch.serving.cache_pool import CachePool
from repro_torch.serving.engine import (CommitEvent, CompletedRequest,
                                        EngineConfig, Request, ServingEngine)
from repro_torch.serving.scheduler import (FIFOPolicy, Policy,
                                           ShortestGenFirstPolicy,
                                           SlowFastPolicy, get_policy)

__all__ = ["CachePool", "CommitEvent", "CompletedRequest", "EngineConfig",
           "FIFOPolicy", "Policy", "Request", "ServingEngine",
           "ShortestGenFirstPolicy", "SlowFastPolicy", "get_policy"]
