"""Serving metrics: latency percentiles, throughput, batch fill (the
port of ``repro.serve.metrics``).

One percentile implementation for the whole package: ``percentiles``
lives in ``obs.registry`` (whose histograms use it) and is re-exported
here, so a p99 from ``QueryServer.metrics`` and one from a registry
snapshot never disagree on definition (linear-interpolated, numpy
semantics).

``ServerMetrics`` is backed by an ``obs.MetricsRegistry``: the counters
it exposes as attributes (``requests``, ``batches``, ...) are registry
counters, the cache's hit/miss counters are registered as callback
gauges at server init, and the latency window's percentiles are
exported as callback gauges, so ``registry.snapshot()`` is the single
machine-readable export and ``summary()`` is its human-facing
projection.
"""
from __future__ import annotations

import time
import warnings

import numpy as np

from repro_torch.obs.registry import MetricsRegistry, percentiles

__all__ = ["percentiles", "LatencyWindow", "ServerMetrics"]


class LatencyWindow:
    """Per-request latency samples over one serving window.

    ``record`` is called at response time with the request's measured
    latency; QPS is completions over the wall span from the first to
    the last response in the window.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._us: list[float] = []
        self._first: float | None = None
        self._last: float | None = None

    def record(self, latency_us: float) -> None:
        now = time.perf_counter()
        if self._first is None:
            self._first = now
        self._last = now
        self._us.append(float(latency_us))

    @property
    def count(self) -> int:
        return len(self._us)

    def samples_us(self) -> np.ndarray:
        return np.asarray(self._us, np.float64)

    def qps(self) -> float:
        if self.count < 2 or self._last is None or self._first is None:
            return 0.0
        span = self._last - self._first
        if span <= 0:
            return 0.0
        # completions after the first mark the span's throughput
        return (self.count - 1) / span

    def summary(self) -> dict:
        p = percentiles(self._us, (50, 99))
        mean = float(np.mean(self._us)) if self._us else 0.0
        return {"count": self.count, "p50_us": p["p50"],
                "p99_us": p["p99"], "mean_us": mean, "qps": self.qps()}


def _counter_property(name: str):
    """Registry counter exposed as a plain int attribute: ``+= 1`` and
    direct assignment both work, so callers written against the old
    dataclass fields keep working unchanged."""

    def fget(self) -> int:
        return self.registry.counter(name).value

    def fset(self, value: int) -> None:
        c = self.registry.counter(name)
        c.reset()
        c.inc(int(value))

    return property(fget, fset)


class ServerMetrics:
    """QueryServer counters + the latency window, registry-backed.

    ``padded_slots`` counts batch slots filled with padding (a measure
    of micro-batch efficiency: fill = batched_queries /
    (batched_queries + padded_slots)); cache hits bypass batching
    entirely and appear only in ``requests`` and the cache's own
    counters — which are registered here at server init, so
    ``summary()`` is complete without the caller passing the cache.
    """

    _COUNTERS = ("serve_requests", "serve_batches",
                 "serve_batched_queries", "serve_padded_slots",
                 "serve_epochs_served")

    requests = _counter_property("serve_requests")
    batches = _counter_property("serve_batches")
    batched_queries = _counter_property("serve_batched_queries")
    padded_slots = _counter_property("serve_padded_slots")
    epochs_served = _counter_property("serve_epochs_served")

    def __init__(self, registry: MetricsRegistry | None = None,
                 cache=None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.latency = LatencyWindow()
        self.layout_mix: dict = {}
        self._last_epoch: int | None = None
        self._cache = None
        for name in self._COUNTERS:
            self.registry.counter(name)
        self._register("serve_latency_p50_us",
                       lambda: percentiles(self.latency._us)["p50"])
        self._register("serve_latency_p99_us",
                       lambda: percentiles(self.latency._us)["p99"])
        self._register("serve_qps", self.latency.qps)
        self._register("serve_batch_fill", self.batch_fill)
        if cache is not None:
            self.attach_cache(cache)

    def _register(self, name: str, fn) -> None:
        if self.registry.get(name) is None:
            self.registry.register_callback(name, fn)

    def attach_cache(self, cache) -> None:
        """Register the ResultCache counters as callback gauges so the
        snapshot and ``summary()`` carry them unconditionally."""
        self._cache = cache
        self._register("cache_hits", lambda: self._cache.hits)
        self._register("cache_misses", lambda: self._cache.misses)
        self._register("cache_hit_rate", lambda: self._cache.hit_rate)
        self._register("cache_entries", lambda: len(self._cache))

    def observe_epoch(self, epoch: int) -> None:
        if epoch != self._last_epoch:
            self.epochs_served += 1
            self._last_epoch = epoch

    def observe_layout_mix(self, mix: dict) -> None:
        """Record the served stack's per-layout composition (from
        ``LiveView.layout_mix``) — aggregates only, the per-segment
        decision list stays on the view.  Called by the server whenever
        the pinned epoch advances, so the summary always reflects the
        layout mix the LAST served epoch had converged to."""
        self.layout_mix = {k: v for k, v in mix.items()
                           if k != "segments"}

    def record_response(self, latency_us: float) -> None:
        self.requests += 1
        self.latency.record(latency_us)

    def batch_fill(self) -> float:
        total = self.batched_queries + self.padded_slots
        return self.batched_queries / total if total else 0.0

    def reset(self) -> None:
        for name in self._COUNTERS:
            self.registry.counter(name).reset()
        self._last_epoch = None
        self.layout_mix = {}
        self.latency.reset()

    def snapshot(self) -> dict:
        """The registry's stable export (see ``obs.registry``)."""
        return self.registry.snapshot()

    def summary(self, cache=None) -> dict:
        """Human-facing aggregate. The ``cache=`` argument is
        deprecated AND inert: the cache attached at init (or via
        ``attach_cache``) is the only one reported — passing one here
        warns and has no effect.  The parameter survives one more
        release for signature compatibility only."""
        if cache is not None:
            warnings.warn(
                "ServerMetrics.summary(cache=...) is deprecated and "
                "ignored — attach the cache with attach_cache() (the "
                "servers do this at init); the attached cache is "
                "reported unconditionally", DeprecationWarning,
                stacklevel=2)
        src = self._cache
        out = {"requests": self.requests, "batches": self.batches,
               "batch_fill": self.batch_fill(),
               "epochs_served": self.epochs_served,
               "layout_mix": self.layout_mix}
        out.update(self.latency.summary())
        if src is not None:
            out["cache_hit_rate"] = src.hit_rate
            out["cache_hits"] = src.hits
            out["cache_misses"] = src.misses
        return out
