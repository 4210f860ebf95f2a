"""Continuous-batching serving engine of the port (paged KV cache,
mid-stream joins, prefix sharing, preemption).

    traffic      arrival processes (Poisson / batch, shared-prefix pools)
    request      Request / RequestResult accounting
    paged_kv     PagedKVCache — ref-counted page pool + prefix trie +
                 copy-on-write sharing + free list (host side)
    scheduler    RequestQueue + Scheduler — ragged requests -> fixed slots
    engine       ServeEngine — prefill-on-join (suffix-only on prefix
                 hits), paged decode chunks, preemption/requeue,
                 free-on-finish, per-request latency + J/token accounting
"""
from repro_torch.serving.engine import (ChunkStats, EnergyAwareAdmission,
                                        EngineConfig, EngineReport,
                                        ServeEngine)
from repro_torch.serving.paged_kv import CopySpec, PagedKVCache
from repro_torch.serving.request import Request, RequestResult
from repro_torch.serving.scheduler import RequestQueue, Scheduler
from repro_torch.serving.traffic import batch_trace, poisson_trace

__all__ = [
    "ChunkStats", "EnergyAwareAdmission", "EngineConfig", "EngineReport",
    "ServeEngine", "CopySpec", "PagedKVCache", "Request", "RequestResult",
    "RequestQueue", "Scheduler", "batch_trace", "poisson_trace",
]
