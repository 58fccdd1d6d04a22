"""Percentiles and spreads: frozen copies of the arithmetic the numbers
are read with."""
from __future__ import annotations

import numpy as np


def percentiles(samples, qs=(50, 99)) -> dict:
    """``{"p50": ..., "p99": ...}`` over ``samples``; empty input yields
    zeros rather than NaNs (a copy of the port's
    ``obs.registry.percentiles``)."""
    a = np.asarray(list(samples), np.float64)
    if a.size == 0:
        return {f"p{int(q)}": 0.0 for q in qs}
    return {f"p{int(q)}": float(np.percentile(a, q)) for q in qs}


def percentile(samples, q: float) -> float | None:
    """The ``q``-th percentile (numpy's linear rule) of ``samples``, where
    ``inf`` marks a sample that never came: it lies above every measured
    one, and a percentile that reaches it is ``inf``.  None for no
    samples."""
    a = np.asarray(list(samples), np.float64)
    if a.size == 0:
        return None
    missing = np.isinf(a)
    if not missing.any():
        return float(np.percentile(a, q))
    top = float(a[~missing].max()) if (~missing).any() else 0.0
    v = float(np.percentile(np.where(missing, 1e300, a), q))
    return v if v <= top else float("inf")

