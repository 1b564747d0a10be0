"""Online streaming serving frontend of the port: a copy of
src/repro/serving/frontend over the port's engine (docs/streaming_serving.md
describes the JAX original; the wire format is the same).

Layers an asyncio HTTP surface over the continuous-batching engine:
OpenAI-style ``/v1/completions`` with dLLM-native SSE streaming
(``block_committed`` commit sets per tick — tokens unmask out of order
within a block), bounded-queue backpressure keyed off cache-pool
occupancy (429/overloaded + ``max_queue_wait`` shedding), and a
multi-replica router (round-robin / least-loaded) with graceful drain.
"""
from repro_torch.serving.frontend.router import (EngineWorker, Overloaded,
                                                 Router, ShedEvent)
from repro_torch.serving.frontend.server import (ServeFrontend,
                                                 build_frontend,
                                                 serve_forever)

__all__ = [
    "EngineWorker", "Overloaded", "Router", "ShedEvent",
    "ServeFrontend", "build_frontend", "serve_forever",
]
