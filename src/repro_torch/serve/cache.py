"""Query-result cache keyed on (query signature, k, epoch) (numpy
only: a copy of ``repro.serve.cache``).

The epoch in the key IS the invalidation protocol: any query-visible
mutation of the live index advances its epoch, so entries written at
older epochs can never satisfy a lookup at the current one — stale
results are unreachable by construction, not by a scan-and-evict pass.
``purge_below`` exists only to reclaim their memory eagerly; the LRU
bound would get there anyway.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np


class ResultCache:
    """Bounded LRU of (doc_ids, scores) responses.

    Keys are ``(tuple(padded query row), k, epoch)``; values are
    defensive copies, so a cached response is immutable no matter what
    the caller does with the arrays it gets back.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._store: OrderedDict[tuple, tuple] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    @staticmethod
    def make_key(query_row: np.ndarray, k: int, epoch: int) -> tuple:
        return (tuple(np.asarray(query_row, np.uint32).tolist()),
                int(k), int(epoch))

    def get(self, key: tuple):
        """(doc_ids, scores) copies, or None.  Counts the hit/miss."""
        hit = self._store.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._store.move_to_end(key)
        self.hits += 1
        return hit[0].copy(), hit[1].copy()

    def put(self, key: tuple, doc_ids: np.ndarray,
            scores: np.ndarray) -> None:
        self._store[key] = (np.asarray(doc_ids).copy(),
                            np.asarray(scores).copy())
        self._store.move_to_end(key)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)

    def purge_below(self, epoch: int) -> int:
        """Drop entries pinned to epochs older than ``epoch`` (they are
        already unreachable — keys carry their epoch); returns the
        number reclaimed."""
        stale = [k for k in self._store if k[2] < epoch]
        for k in stale:
            del self._store[k]
        return len(stale)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_counters(self) -> None:
        self.hits = 0
        self.misses = 0


class TenantCachePartitions:
    """Per-tenant ``ResultCache`` partitions: keys are effectively
    ``(tenant, query row, k, epoch)``.

    Each tenant gets its own LRU with its own capacity, so one tenant's
    burst can never evict another's working set — isolation holds by
    construction, not by quota accounting.  The tenant directory itself
    is LRU-bounded (``max_tenants``): an evicted tenant loses its
    partition wholesale and starts cold on return.

    Aggregate ``hits``/``misses`` are tracked here (they survive tenant
    eviction); per-partition counters remain on each ``ResultCache``.
    The object satisfies the stats surface ``ServerMetrics.attach_cache``
    expects (hits, misses, hit_rate, __len__, reset_counters).
    """

    make_key = staticmethod(ResultCache.make_key)

    def __init__(self, capacity_per_tenant: int = 1024,
                 max_tenants: int = 64):
        self.capacity_per_tenant = int(capacity_per_tenant)
        self.max_tenants = int(max_tenants)
        self._parts: OrderedDict[str, ResultCache] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.tenant_evictions = 0

    def __len__(self) -> int:
        return sum(len(p) for p in self._parts.values())

    @property
    def tenants(self) -> list[str]:
        return list(self._parts)

    def partition(self, tenant: str) -> ResultCache:
        """The tenant's partition, created lazily; touching it marks
        the tenant most-recently-used in the directory."""
        part = self._parts.get(tenant)
        if part is None:
            part = ResultCache(self.capacity_per_tenant)
            self._parts[tenant] = part
            while len(self._parts) > self.max_tenants:
                self._parts.popitem(last=False)
                self.tenant_evictions += 1
        self._parts.move_to_end(tenant)
        return part

    def get(self, tenant: str, key: tuple):
        out = self.partition(tenant).get(key)
        if out is None:
            self.misses += 1
        else:
            self.hits += 1
        return out

    def put(self, tenant: str, key: tuple, doc_ids: np.ndarray,
            scores: np.ndarray) -> None:
        self.partition(tenant).put(key, doc_ids, scores)

    def purge_below(self, epoch: int) -> int:
        return sum(p.purge_below(epoch) for p in self._parts.values())

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_counters(self) -> None:
        self.hits = 0
        self.misses = 0
        for p in self._parts.values():
            p.reset_counters()

    def per_tenant(self) -> dict:
        """{tenant: {entries, hits, misses}} for observability."""
        return {t: {"entries": len(p), "hits": p.hits, "misses": p.misses}
                for t, p in self._parts.items()}
