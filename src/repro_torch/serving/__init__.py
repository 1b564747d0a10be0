"""Continuous-batching serving over the diffusion tick: slot and paged
pools, scheduler policies, metrics and the engine."""
from repro_torch.serving.cache_pool import (CachePool, PagedCachePool,
                                            SpilledSlot)
from repro_torch.serving.engine import (CommitEvent, CompletedRequest,
                                        EngineConfig, Request, ServingEngine)
from repro_torch.serving.scheduler import (FIFOPolicy, Policy,
                                           ShortestGenFirstPolicy,
                                           SlowFastPolicy, get_policy)

__all__ = ["CachePool", "CommitEvent", "CompletedRequest", "EngineConfig",
           "FIFOPolicy", "PagedCachePool", "Policy", "Request",
           "ServingEngine", "ShortestGenFirstPolicy", "SlowFastPolicy",
           "SpilledSlot", "get_policy"]
