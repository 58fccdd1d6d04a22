"""Observability primitives of the PyTorch/CUDA port (mirrors
``repro.obs``): stdlib and numpy only at import time, so every layer
instruments itself against one registry and one span format.

  registry.py  named counters / gauges / histograms in a
               ``MetricsRegistry`` (JSON and Prometheus snapshots), the
               process-global ``GLOBAL`` registry and the bounded
               ``EventLog`` of index maintenance
  trace.py     query tracing: ``Span``/``Trace`` through the serving
               read path, the sampling ``Tracer`` and the
               ``StageAggregator`` that folds stage durations into
               registry histograms
"""
from repro_torch.obs.registry import (GLOBAL, Counter, EventLog, Gauge,
                                      Histogram, MetricsRegistry,
                                      global_registry, parse_prometheus,
                                      snapshot_from_json, snapshot_to_json)
from repro_torch.obs.trace import Span, StageAggregator, Trace, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "EventLog",
    "GLOBAL", "global_registry", "parse_prometheus", "snapshot_to_json",
    "snapshot_from_json", "Span", "Trace", "Tracer", "StageAggregator",
]
