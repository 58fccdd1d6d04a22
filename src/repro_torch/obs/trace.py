"""Query tracing: monotonic-clock spans threaded through the read path
(stdlib only: a copy of ``repro.obs.trace``).

Span taxonomy (serving tier)
----------------------------
Top-level stages partition a request's lifetime with SHARED boundary
timestamps, so per-request stage durations sum EXACTLY to the measured
end-to-end latency:

    queue_wait   submit -> batch pickup
    assemble     batch pickup -> query block filled (attrs: fill,
                 padded slots)
    score        engine dispatch -> candidates on host
    respond      candidates -> response handed to the ticket
    cache_hit    batch pickup -> response, replacing assemble/score/
                 respond on a result-cache hit

Children of ``score`` (``parent="score"``) record where the engine
itself went: one ``segment`` span per sealed segment (size_class,
layout, resolved TuneConfig geometry, analytic candidate/posting
bytes), a ``delta`` span for the mutable tail, a ``merge`` span for
the host candidate merge, and ``shard_fanout``/``shard_sync`` spans on
the distributed scorers.

Tracing is sampled per ticket (``Tracer``); when disabled (the
default) no ``Span``/``Trace`` object is constructed anywhere on the
hot path — the test suite asserts this by making construction raise.
"""
from __future__ import annotations

import threading
import time
from typing import Any


class Span:
    """One timed region. ``t0``/``t1`` are ``time.perf_counter()``
    readings; pass explicit timestamps to share stage boundaries."""

    __slots__ = ("name", "parent", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float | None = None,
                 parent: str | None = None, attrs: dict | None = None):
        self.name = name
        self.parent = parent
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1: float | None = None
        self.attrs = attrs if attrs is not None else {}

    def end(self, t1: float | None = None) -> "Span":
        self.t1 = time.perf_counter() if t1 is None else t1
        return self

    @property
    def duration_us(self) -> float:
        t1 = self.t1 if self.t1 is not None else time.perf_counter()
        return (t1 - self.t0) * 1e6

    def to_dict(self) -> dict:
        d = {"name": self.name, "duration_us": self.duration_us}
        if self.parent is not None:
            d["parent"] = self.parent
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.duration_us:.1f}us"
                + (f", parent={self.parent!r}" if self.parent else "") + ")")


class Trace:
    """Ordered span collection for one sampled request."""

    __slots__ = ("spans",)

    def __init__(self):
        self.spans: list[Span] = []

    def span(self, name: str, t0: float | None = None,
             parent: str | None = None, **attrs) -> Span:
        s = Span(name, t0=t0, parent=parent, attrs=attrs or None)
        self.spans.append(s)
        return s

    def adopt(self, spans: list) -> None:
        """Share spans recorded once per micro-batch (assemble/score
        and their children) with every sampled ticket in the batch."""
        self.spans.extend(spans)

    def stage_durations(self) -> dict:
        """Top-level (parentless) span name -> total duration_us."""
        out: dict[str, float] = {}
        for s in self.spans:
            if s.parent is None:
                out[s.name] = out.get(s.name, 0.0) + s.duration_us
        return out

    def total_us(self) -> float:
        return sum(self.stage_durations().values())

    def to_dict(self) -> dict:
        return {"spans": [s.to_dict() for s in self.spans]}


class Tracer:
    """Per-ticket sampling: every ``sample_every``-th submission gets a
    ``Trace``; ``sample_every == 0`` disables tracing entirely (returns
    None without constructing anything)."""

    def __init__(self, sample_every: int = 0):
        self.sample_every = int(sample_every)
        self._lock = threading.Lock()
        self._n = 0

    @property
    def enabled(self) -> bool:
        return self.sample_every > 0

    def sample(self) -> Trace | None:
        if self.sample_every <= 0:
            return None
        with self._lock:
            self._n += 1
            if self._n % self.sample_every != 0:
                return None
        return Trace()


class StageAggregator:
    """Folds sampled traces' top-level stage durations into registry
    histograms (``serve_stage_<name>_us``), so the per-stage latency
    percentiles travel in the same snapshot as every other metric."""

    def __init__(self, registry=None, prefix: str = "serve_stage_"):
        if registry is None:
            from repro_torch.obs.registry import MetricsRegistry
            registry = MetricsRegistry()
        self.registry = registry
        self.prefix = prefix
        self._lock = threading.Lock()
        self._stages: dict[str, Any] = {}

    def _hist(self, stage: str):
        h = self._stages.get(stage)
        if h is None:
            with self._lock:
                h = self._stages.get(stage)
                if h is None:
                    h = self.registry.histogram(self.prefix + stage + "_us")
                    self._stages[stage] = h
        return h

    def observe(self, stage: str, duration_us: float) -> None:
        self._hist(stage).observe(duration_us)

    def observe_trace(self, trace: Trace) -> None:
        for stage, us in trace.stage_durations().items():
            self.observe(stage, us)

    def summary(self) -> dict:
        """stage name -> histogram snapshot ({count, sum, p50, p99})."""
        with self._lock:
            stages = sorted(self._stages.items())
        out = {}
        for stage, hist in stages:
            snap = hist.snapshot()
            snap.pop("type", None)
            out[stage] = snap
        return out

    def reset(self) -> None:
        with self._lock:
            stages = list(self._stages.values())
        for hist in stages:
            hist.reset()
