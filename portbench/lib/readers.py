"""What several per-layer readers share: the traced window's device
activities split by kernel, the window's batches, and the least work of
the batches' fused kernel calls.

``ctx`` is what a reader gets: ``session`` (the load's record of the
window), ``system`` (the deployment, still alive), ``events`` (the
device trace, ``None`` in an untraced run), ``t0``/``t1`` (the traced
window on ``time.perf_counter``'s clock) and ``scoring_tids`` (native ids
of the threads that score queries; empty: every thread).
"""
from __future__ import annotations

import numpy as np

from portbench.lib import layouts, profiling
from portbench.yardstick import kernels, work
from portbench.yardstick.stats import percentiles


def p50(values) -> float | None:
    values = list(values)
    return percentiles(values, (50,))["p50"] if values else None


def in_window(ctx) -> np.ndarray:
    ev = ctx.events
    return (ev.end > ctx.t0) & (ev.start < ctx.t1)


def kernel_mask(ctx, which=kernels.HAND_WRITTEN) -> np.ndarray:
    """Activities whose names hold one of ``which``'s symbols."""
    names, inverse = np.unique(np.asarray(ctx.events.names, object),
                               return_inverse=True)
    hit = np.array([any(sym in n for sym in which.values()) for n in names],
                   bool)
    return hit[inverse] if len(names) else np.zeros(0, bool)


def scoring_mask(ctx) -> np.ndarray:
    """Activities launched by a scoring thread (all where the trace does
    not name the launching thread)."""
    tid = ctx.events.tid
    mine = np.isin(tid, list(ctx.scoring_tids))
    return mine if mine.any() else np.ones(len(tid), bool)


def device_s(ctx, mask) -> float:
    ev = ctx.events
    return float((np.minimum(ev.end, ctx.t1)
                  - np.maximum(ev.start, ctx.t0))[mask].clip(0).sum())


def torch_ops_ms_per_batch(ctx) -> float | None:
    """Device time of every activity that is not a hand-written kernel,
    launched by the scoring path, per scored batch."""
    if ctx.events is None:
        return None
    n = len(ctx.session.batches())
    if n == 0:
        return None
    mask = in_window(ctx) & scoring_mask(ctx) & ~kernel_mask(ctx)
    return device_s(ctx, mask) * 1e3 / n


def idle_pct(ctx) -> float | None:
    if ctx.events is None or ctx.t1 <= ctx.t0:
        return None
    busy = ctx.events.busy_s(ctx.t0, ctx.t1)
    return 100.0 * (1.0 - busy / (ctx.t1 - ctx.t0))


def roofline_pct(ctx, calls) -> float | None:
    """Least time of ``calls`` (the window's fused kernel calls, as
    ``(layout, term ids, kind, tile, k_tile, q, q_real)``) over the
    device time of the fused kernels in the window."""
    if ctx.events is None:
        return None
    total = work.Work()
    for lay, terms, kind, tile, k_tile, q, q_real in calls:
        if kind == "candidates":
            total += work.candidate_call(lay, terms, tile, k_tile, q, q_real)
        else:
            total += work.dense_call(lay, terms, tile, q, q_real)
    mask = in_window(ctx) & kernel_mask(ctx, kernels.FUSED)
    return work.roofline_pct(total, device_s(ctx, mask))


def live_calls(ctx) -> list:
    """The fused calls of the live window's batches: one candidate call
    per HOR or packed segment, one dense call per band of a banded one
    (the server's ``segment`` spans say which segments)."""
    sess = ctx.session
    q = work.padded_q(ctx.system.server.config.batch_size)
    calls = []
    for b in sess.batches():
        hashes = np.concatenate([np.asarray(r, np.uint32) for r in b["rows"]])
        for sp in b["spans"]:
            if sp.name != "segment":
                continue
            a = sp.attrs
            bands = sess.segment_layouts.get(
                (int(a["doc_base"]), a["layout"], int(a["size_class"])))
            if bands is None:
                continue
            kind = "dense" if a["layout"] == "banded" else "candidates"
            for lay in bands:
                calls.append((lay, layouts.term_ids(lay, hashes), kind,
                              work.TILE, work.K_TILE, q, int(b["fill"])))
    return calls


def static_calls(ctx) -> list:
    """One candidate call per scorer call of the static window."""
    lay = layouts.bands(ctx.system.index)[0]
    return [(lay, layouts.term_ids(lay, np.asarray(b["rows"]).reshape(-1)),
             "candidates", work.TILE, work.K_TILE,
             work.padded_q(len(b["rows"])), int(b["fill"]))
            for b in ctx.session.batches()]


def label_gaps(ctx) -> list:
    """The window's idle gaps, summed by what the host was doing at their
    middle: ``[[label, seconds], ...]``, the 10 largest."""
    gaps = ctx.events.gaps(ctx.t0, ctx.t1)
    mid = gaps.mean(axis=1) if len(gaps) else np.zeros(0)
    by_label: dict = {}
    for name, s0, s1 in ctx.session.host_spans():
        by_label.setdefault(name, []).append((s0, s1))
    names = sorted(by_label)
    inside = {n: profiling.covers(profiling.merge(
        *map(np.asarray, zip(*by_label[n]))), mid) for n in names}
    inner = [n for n in ("segment", "delta", "merge") if n in inside]
    if inner and "score" in inside:
        inside["score"] &= ~np.logical_or.reduce([inside[n] for n in inner])
    code = np.zeros(len(mid), np.int64)
    for i, n in enumerate(names):
        code |= inside[n].astype(np.int64) << i
    secs = np.bincount(code, weights=gaps[:, 1] - gaps[:, 0]) \
        if len(mid) else np.zeros(0)
    out = []
    for c in np.flatnonzero(secs):
        label = "+".join(n for i, n in enumerate(names) if c >> i & 1)
        out.append([label or "no host span", float(secs[c])])
    return sorted(out, key=lambda kv: -kv[1])[:10]
