"""Online query-serving tier over the segmented live index (the port of
``repro.serve``, on one card):

  server.py      QueryServer: admission queue + micro-batching into
                 (batch_size, n_terms_budget) batches through
                 ``LiveView.topk``, per-request latency accounting
  snapshot.py    epoch-pinned immutable views + host serialize/restore
                 (the reference's format, readable by either package)
  cache.py       query-result cache keyed (query, k, epoch)
  maintenance.py background sealing and tiered compaction under the
                 write lock
  metrics.py     latency percentiles (p50/p99), QPS, batch fill,
                 registry-backed (see ``repro_torch.obs``)
  mesh.py        MeshServer: micro-batches fan out over sharded segment
                 stacks (or the term-sharded fused engine) at a pinned
                 epoch, with replicated indexes under their own
                 maintenance, epoch handoff, admission control, deadline
                 shedding and per-tenant result-cache partitions; one
                 controller drives the S shards (on one card they run
                 in turn)

Observability primitives (spans, the metrics registry, the maintenance
event log) live in ``repro_torch.obs`` and are re-exported here.
"""
from repro_torch.obs.registry import EventLog, MetricsRegistry
from repro_torch.obs.trace import Span, StageAggregator, Trace, Tracer
from repro_torch.serve.cache import ResultCache, TenantCachePartitions
from repro_torch.serve.maintenance import IndexMaintenance
from repro_torch.serve.mesh import MeshConfig, MeshServer, ShardReplica
from repro_torch.serve.metrics import (LatencyWindow, ServerMetrics,
                                       percentiles)
from repro_torch.serve.server import (QueryServer, Response, ServerConfig,
                                      Ticket)
from repro_torch.serve.snapshot import (load_segmented, pin,
                                        restore_segmented, save_segmented,
                                        serialize_segmented)

__all__ = [
    "QueryServer", "ServerConfig", "Response", "Ticket", "ResultCache",
    "TenantCachePartitions", "IndexMaintenance", "MeshServer",
    "MeshConfig", "ShardReplica", "LatencyWindow",
    "ServerMetrics", "percentiles", "pin", "serialize_segmented",
    "restore_segmented", "save_segmented", "load_segmented",
    "MetricsRegistry", "EventLog", "Span", "Trace", "Tracer",
    "StageAggregator",
]
