"""Unified metrics registry + bounded maintenance event log.

stdlib+numpy: a copy of ``repro.obs.registry``.  One process may hold
several registries plus the module-level ``GLOBAL`` registry that
engine internals increment (routing-pair overflow,
``engine_pair_overflow``, from ``kernels.ops.warn_on_overflow``).

Export contract
---------------
``MetricsRegistry.snapshot()`` returns one stable dict shape::

    {"serve_requests":   {"type": "counter",   "value": 123},
     "cache_hit_rate":   {"type": "gauge",     "value": 0.25},
     "serve_stage_score_us": {"type": "histogram", "count": 10,
                              "sum": 5231.0, "p50": 410.2, "p99": 980.0}}

and both exports round-trip exactly:

* JSON:        ``snapshot_from_json(snapshot_to_json(snap)) == snap``
* Prometheus:  ``parse_prometheus(reg.to_prometheus()) == snap``

Counters are integer-valued, gauges are float-valued, histogram
``count`` is an integer and the rest floats; floats are serialised with
``repr`` so the text format loses no precision.
"""
from __future__ import annotations

import json
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable

import numpy as np

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

# Percentiles exported for histograms. Kept as (q, label) so the
# Prometheus quantile label ("0.5") and the snapshot key ("p50") stay
# in lockstep.
_HIST_QS = ((50.0, "p50"), (99.0, "p99"))


def percentiles(samples, qs=(50, 99)) -> dict:
    """``{"p50": ..., "p99": ...}`` over ``samples``; empty input yields
    zeros rather than NaNs (the reference's ``serve.metrics`` rule)."""
    a = np.asarray(list(samples), np.float64)
    if a.size == 0:
        return {f"p{int(q)}": 0.0 for q in qs}
    return {f"p{int(q)}": float(np.percentile(a, q)) for q in qs}


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} must match {_NAME_RE.pattern} "
            "(underscore-separated, Prometheus-safe)")
    return name


class Counter:
    """Monotonic integer counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = _check_name(name)
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, amount: int = 1) -> None:
        amount = int(amount)
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> int:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def snapshot(self) -> dict:
        return {"type": "counter", "value": int(self._value)}


class Gauge:
    """Point-in-time float value, settable or callback-backed."""

    __slots__ = ("name", "_value", "_fn")

    def __init__(self, name: str, fn: Callable[[], float] | None = None):
        self.name = _check_name(name)
        self._value = 0.0
        self._fn = fn

    def set(self, value: float) -> None:
        if self._fn is not None:
            raise ValueError(f"gauge {self.name} is callback-backed")
        self._value = float(value)

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": float(self.value)}


class Histogram:
    """Bounded-window histogram: total count/sum, percentiles over the
    retained window (``percentiles`` above)."""

    __slots__ = ("name", "_window", "_count", "_sum", "_lock")

    def __init__(self, name: str, window: int = 4096):
        self.name = _check_name(name)
        self._window: deque = deque(maxlen=int(window))
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._window.append(value)
            self._count += 1
            self._sum += value

    @property
    def count(self) -> int:
        return self._count

    def samples(self) -> list:
        with self._lock:
            return list(self._window)

    def reset(self) -> None:
        with self._lock:
            self._window.clear()
            self._count = 0
            self._sum = 0.0

    def snapshot(self) -> dict:
        with self._lock:
            samples = list(self._window)
            count, total = self._count, self._sum
        vals = percentiles(samples, qs=tuple(q for q, _ in _HIST_QS))
        out = {"type": "histogram", "count": int(count), "sum": float(total)}
        for _, label in _HIST_QS:
            out[label] = float(vals[label])
        return out


class MetricsRegistry:
    """Named instruments with get-or-create registration.

    ``counter``/``gauge``/``histogram`` return the existing instrument
    when the name is already registered (type mismatch is an error), so
    independent components can share counters by name alone.
    """

    def __init__(self):
        self._instruments: dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{type(inst).__name__}, not {cls.__name__}")
                return inst
            inst = factory()
            self._instruments[name] = inst
            return inst

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._get_or_create(
            name, Histogram, lambda: Histogram(name, window=window))

    def register_callback(self, name: str, fn: Callable[[], float]) -> Gauge:
        """Register a gauge whose value is read from ``fn`` at snapshot
        time (e.g. cache hit rate, current index epoch)."""
        with self._lock:
            if name in self._instruments:
                raise ValueError(f"metric {name!r} already registered")
            g = Gauge(name, fn=fn)
            self._instruments[name] = g
            return g

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def get(self, name: str):
        return self._instruments.get(name)

    def reset(self) -> None:
        """Reset counters and histograms (callback gauges re-read live
        state and are left alone)."""
        with self._lock:
            insts = list(self._instruments.values())
        for inst in insts:
            if isinstance(inst, (Counter, Histogram)):
                inst.reset()

    def snapshot(self) -> dict:
        with self._lock:
            insts = sorted(self._instruments.items())
        return {name: inst.snapshot() for name, inst in insts}

    def to_prometheus(self) -> str:
        """Prometheus text exposition of ``snapshot()`` (histograms as
        summaries with quantile labels)."""
        lines = []
        for name, snap in self.snapshot().items():
            kind = snap["type"]
            if kind == "counter":
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {snap['value']}")
            elif kind == "gauge":
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {snap['value']!r}")
            else:
                lines.append(f"# TYPE {name} summary")
                for q, label in _HIST_QS:
                    lines.append(
                        f'{name}{{quantile="{q / 100.0!r}"}} '
                        f"{snap[label]!r}")
                lines.append(f"{name}_sum {snap['sum']!r}")
                lines.append(f"{name}_count {snap['count']}")
        return "\n".join(lines) + "\n"


def snapshot_to_json(snapshot: dict) -> str:
    return json.dumps(snapshot, sort_keys=True)


def snapshot_from_json(text: str) -> dict:
    return json.loads(text)


def parse_prometheus(text: str) -> dict:
    """Parse ``to_prometheus()`` output back into the snapshot dict
    shape — the round-trip the export contract promises."""
    out: dict[str, dict] = {}
    types: dict[str, str] = {}
    label_of = {f"{q / 100.0!r}": label for q, label in _HIST_QS}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            m = re.match(r"#\s*TYPE\s+(\S+)\s+(\S+)", line)
            if m:
                types[m.group(1)] = m.group(2)
            continue
        key, _, val = line.rpartition(" ")
        key = key.strip()
        m = re.match(r'^(\S+?)\{quantile="([^"]+)"\}$', key)
        if m:
            name, q = m.groups()
            out.setdefault(name, {"type": "histogram"})
            out[name][label_of.get(q, f"q{q}")] = float(val)
        elif key.endswith("_sum") and types.get(key[:-4]) == "summary":
            out.setdefault(key[:-4], {"type": "histogram"})["sum"] = float(val)
        elif key.endswith("_count") and types.get(key[:-6]) == "summary":
            out.setdefault(key[:-6], {"type": "histogram"})["count"] = \
                int(float(val))
        elif types.get(key) == "counter":
            out[key] = {"type": "counter", "value": int(float(val))}
        else:
            out[key] = {"type": "gauge", "value": float(val)}
    return out


class EventLog:
    """Bounded structured ring of maintenance events.

    Each ``emit(kind, **fields)`` stamps a monotonically increasing
    ``seq`` and a wall-clock ``t_wall``; the ring retains the last
    ``capacity`` events while per-kind counts keep the full history
    countable after eviction.
    """

    def __init__(self, capacity: int = 256):
        self._ring: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._seq = 0
        self._counts: dict[str, int] = {}

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def resize(self, capacity: int) -> None:
        """Rebound the ring to ``capacity`` events, keeping the newest
        retained events (shrinking drops from the oldest end).  Seq and
        per-kind counts are untouched."""
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"event log capacity must be >= 1, "
                             f"got {capacity}")
        with self._lock:
            if capacity == self._ring.maxlen:
                return
            self._ring = deque(self._ring, maxlen=capacity)

    def emit(self, kind: str, **fields) -> dict:
        with self._lock:
            self._seq += 1
            event = {"seq": self._seq, "kind": str(kind),
                     "t_wall": time.time(), **fields}
            self._ring.append(event)
            self._counts[kind] = self._counts.get(kind, 0) + 1
        return event

    def tail(self, n: int | None = None, kind: str | None = None) -> list:
        with self._lock:
            events: Iterable[dict] = list(self._ring)
        if kind is not None:
            events = [e for e in events if e["kind"] == kind]
        else:
            events = list(events)
        if n is not None:
            events = events[-int(n):]
        return events

    def counts(self) -> dict:
        with self._lock:
            return dict(self._counts)

    @property
    def total(self) -> int:
        return self._seq

    def __len__(self) -> int:
        return len(self._ring)


#: Process-global registry for engine-level counters (see
#: ``kernels.ops.warn_on_overflow``).
GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return GLOBAL
