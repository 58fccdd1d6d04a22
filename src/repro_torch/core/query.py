"""Query evaluation — the paper's §3.7 elementary queries over any
layout: the port of ``repro.core.query``.

  q_word : term name -> (term id, df)         [lookup phase]
  q_occ  : term id   -> posting list (doc,tf) [gather phase]
  q_doc  : doc ids   -> (norm, rank)          [doc-metadata phase]

Every layout in ``core/layouts.py`` (PR, OR, COR, HOR, packed, banded)
exposes ``lookup_terms`` / ``term_df`` / ``gather_postings``.  Two
engines rank by tf-idf cosine (+ static-rank blend):

* ``engine="torch"`` — the dense oracle (``score_queries``), over any
  layout: gather every posting, scatter-add into a [B, num_docs]
  accumulator, top-k;
* ``engine="fused"`` — the fused engine (``fused_score_queries``): one
  kernel launch per batch, then either the candidate merge
  (``mode="candidates"``, the default) or, with ``mode="dense"``, the
  dense kernel's [B, num_docs] scores, the scoring tail and a top-k.

The oracle's scatter-add is deterministic on CUDA too: it adds one term
slot at a time (doc ids are unique within a slot, so no ``index_add_``
collides), in the reference's slot-major order.  ``conjunctive_filter``
is the AND-semantics filter of one query over any layout.
"""
from __future__ import annotations

import ctypes
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.layouts import hash_tensor
from repro_torch.distributed.topk import merge_topk_candidates
from repro_torch.kernels.cuda_build import check_tensors, entry, tensors_ok

Tensor = torch.Tensor


class QueryResult(NamedTuple):
    doc_ids: Tensor    # i32[..., k]   (-1 where fewer than k hits)
    scores: Tensor     # f32[..., k]


def idf_plain(df: Tensor, num_docs) -> Tensor:
    """idf = ln(1 + D/df); 0 where the term is absent (df == 0), on df's
    device.  D/df is an f32 division, and ln(1 + x) is XLA's: for x >= 1
    (df <= D) its ``log1p`` is ``log(x + 1)``, so ``log_f32(x + 1)``
    gives the reference's bits.  The plain version of ``idf``'s kernel."""
    x = torch.full(df.shape, float(num_docs),
                   device=df.device) / df.clamp_min(1).float()
    return torch.where(df > 0, log_f32(x + 1.0), 0.0)


def idf(df: Tensor, num_docs) -> Tensor:
    """``idf_plain``'s weights: one launch of ``csrc/query_weights.cu``
    for a CUDA ``df`` (i32), the plain version for a CPU one.  A batch
    holds a few dozen weights, and the plain version's ~250 elementwise
    ops would each be a launch on the card."""
    if not df.is_cuda:
        return idf_plain(df, num_docs)
    out = torch.empty(df.shape, dtype=torch.float32, device=df.device)
    if _launch_weights("query_idf", "df", df, torch.int32, df.numel(),
                       ctypes.c_float(float(num_docs)), out):
        idf.launches += 1
    return out


idf.launches = 0


def _launch_weights(symbol: str, arg_name: str, x: Tensor, dtype, n: int,
                    arg, out: Tensor) -> bool:
    """Check the input ``x`` (contiguous, ``dtype``, on the card;
    ``check_tensors`` names a fault), then call ``csrc/query_weights.cu``'s
    ``<symbol>_launch`` with (x, n, arg, out) on the current stream.
    False when there is nothing to launch (n == 0)."""
    name = "query_weights"
    dev = x.get_device()
    if not tensors_ok(dev, [(x, dtype, x.shape)]):
        check_tensors(name, **{arg_name: (x, dtype, tuple(x.shape))})
    if n == 0:
        return False
    fn = entry(name, _WEIGHTS_ARGTYPES[symbol], f"{symbol}_launch")
    err = fn(x.data_ptr(), n, arg, out.data_ptr(),
             torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"{name}: CUDA launch of {symbol} failed "
                           f"(error {err})")
    return True


# C signatures (csrc/query_weights.cu): df, n, num_docs, out, stream;
# w, rows, width, out, stream
_WEIGHTS_ARGTYPES = {
    "query_idf": [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_void_p, ctypes.c_void_p],
    "query_norm": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]}


# Cephes' logf coefficients (p0..p8, then q1, q2 = ln 2 in two parts) and
# sqrt(1/2), as f32: the constants of XLA's CPU log
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF = 0.707106781186547524
_FLT_MIN = 1.17549435e-38


def log_f32(x: Tensor) -> Tensor:
    """Natural log of f32 ``x``, bit for bit as XLA computes it on the
    CPU (its ``log`` and, for x >= 1, its ``log1p(x - 1)``).

    XLA emits Cephes' ``logf`` (Eigen's ``plog_float``): x = m * 2^e
    with m in [sqrt(1/2), sqrt(2)), then a degree-8 polynomial in
    m - 1 split into three Horner chains, and e * ln 2 added in two
    parts.  Its backend contracts every multiply that feeds one add into
    a fused multiply-add; each is ``fma_f32`` here, and the rest are
    plain f32 ops, so the CPU and the card give the same bits.  x <= 0
    or NaN gives NaN, 0 gives -inf, inf gives inf; a subnormal counts as
    0, as XLA's CPU code flushes it."""
    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)
    x = torch.where(x.abs() < _FLT_MIN, 0.0, x.float())
    bits = x.clamp_min(_FLT_MIN).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    e = ((bits >> 23) - 127).float() + 1.0
    low = m < c(_SQRT_HALF)
    e = e - low.float()
    r = (m - 1.0) + torch.where(low, m, 0.0)                  # m - 1
    r2 = r * r
    r3 = r2 * r
    p = [c(v) for v in _LOG_P]
    y = fma_f32(r, p[0], p[1])
    y1 = fma_f32(r, p[3], p[4])
    y2 = fma_f32(r, p[6], p[7])
    y = fma_f32(y, r, p[2])
    y1 = fma_f32(y1, r, p[5])
    y2 = fma_f32(y2, r, p[8])
    y = fma_f32(y, r3, y1)
    y = fma_f32(y, r3, y2)
    y = fma_f32(y, r3, e * c(_LOG_Q1))
    out = fma_f32(e, c(_LOG_Q2), (r - r2 * 0.5) + y)
    out = torch.where(x > 0, out, float("nan"))
    out = torch.where(x == 0, float("-inf"), out)
    return torch.where(x == float("inf"), float("inf"), out)


def dedup_query_hashes(query_hashes: Tensor) -> Tensor:
    """Zero out repeated term hashes within each query (keep the first),
    so a term in two slots contributes once.  Works on [..., T]; 0
    (empty slot) is never treated as a duplicate."""
    t = query_hashes.shape[-1]
    eq = query_hashes[..., :, None] == query_hashes[..., None, :]
    earlier = torch.ones(t, t, dtype=torch.bool,
                         device=query_hashes.device).tril(-1)
    dup = (eq & earlier).any(dim=-1) & (query_hashes != 0)
    return torch.where(dup, 0, query_hashes)


def fma_f32(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """``a * b + c`` in float32 with ONE rounding, as a fused multiply-add.

    The reference's XLA lowering contracts ``acc + qw * tf`` and
    ``cosine + rank_blend * rank`` into FMAs, and the CUDA kernels use
    ``__fmaf_rn``; this is the same function from plain tensor ops, on
    any device: the f64 product of two f32 values is exact, TwoSum gives
    the f64 sum's exact error, and rounding that sum to odd before the
    final rounding to f32 avoids double rounding (f64 carries more than
    f32's 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).double()
    fix = (err != 0) & even & torch.isfinite(s)
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def query_norm_plain(idf_w: Tensor) -> Tensor:
    """Query norms sqrt(max(sum_t w_t**2, 1e-12)) over the last axis, as
    the reference's XLA lowering computes them on the CPU: the slots are
    summed in slot order, then the square root is rounded correctly
    (through f64, which is exact for an f32 input).  How each square
    joins the sum depends on the width T:

    * T = 1-4 and T >= 9: a chain of fused multiply-adds;
    * T = 5-8: each square rounded on its own, then added.  XLA's
      vectorised row loop deinterleaves the T slots of 8 rows before
      the multiply, and its backend does not contract that multiply
      into the add.

    The T = 5-8 rule holds for the rows XLA's loop vectoriser covers:
    every row at batch sizes such as 4, 8, 16, 32, 64 and 4,096 (the
    serving tier's batch of 8 at 8 slots among them).  Rows it leaves
    to a scalar loop take the FMA chain there: every row at 3, 5-7 or
    9-15 rows, and a few rows of a larger batch, where the count depends
    on how XLA splits the rows among its threads.  Their norms may
    differ from this in the last bit (ROADMAP, queue 3).  The plain
    version of ``query_norm``'s kernel; runs on idf_w's device."""
    t_width = idf_w.shape[-1]
    acc = torch.zeros(idf_w.shape[:-1], dtype=torch.float32,
                      device=idf_w.device)
    for t in range(t_width):
        w = idf_w[..., t]
        acc = acc + w * w if 5 <= t_width <= 8 else fma_f32(w, w, acc)
    return torch.sqrt(acc.clamp_min(1e-12).double()).float()


def query_norm(idf_w: Tensor) -> Tensor:
    """``query_norm_plain``'s norms: one launch of
    ``csrc/query_weights.cu`` for a CUDA ``idf_w`` (f32), the plain
    version for a CPU one."""
    if not idf_w.is_cuda:
        return query_norm_plain(idf_w)
    out = torch.empty(idf_w.shape[:-1], dtype=torch.float32,
                      device=idf_w.device)
    if _launch_weights("query_norm", "idf_w", idf_w, torch.float32,
                       out.numel(), idf_w.shape[-1], out):
        query_norm.launches += 1
    return out


query_norm.launches = 0


def final_scores(scores: Tensor, norm: Tensor, rank: Tensor, qnorm: Tensor,
                 rank_blend: float) -> Tensor:
    """Batched q_doc scoring tail: cosine + static-rank blend; deleted
    (norm == 0) and zero-score docs -> -inf.  scores f32[B, D],
    qnorm f32[B].  The blend is one FMA, as the reference computes it
    (and as the CUDA kernels repeat it)."""
    live = norm > 0
    cosine = scores / (norm.clamp_min(1e-12)[None, :] * qnorm[:, None])
    blend = torch.full_like(rank, rank_blend)[None, :]
    final = fma_f32(blend, rank[None, :], cosine)
    return torch.where(live[None, :] & (scores > 0), final, float("-inf"))


def accumulate_scores(doc_ids: Tensor, weights: Tensor, valid: Tensor,
                      num_docs: int) -> Tensor:
    """Scatter-add posting weights into a dense per-document accumulator.

    doc_ids/weights/valid: [..., T, cap].  Returns f32[..., num_docs].
    Invalid postings go to a trash row (index num_docs) with weight 0.
    One ``index_add_`` per term slot: a slot's doc ids are unique, so
    the adds never collide and land in slot-major order.
    """
    lead = doc_ids.shape[:-2]
    t = doc_ids.shape[-2]
    b = math.prod(lead)
    docs = doc_ids.reshape(b, t, -1)
    w = weights.reshape(b, t, -1)
    ok = valid.reshape(b, t, -1)
    row = (torch.arange(b, device=docs.device) * (num_docs + 1))[:, None]
    acc = torch.zeros(b * (num_docs + 1), dtype=torch.float32,
                      device=docs.device)
    for slot in range(t):
        idx = row + torch.where(ok[:, slot], docs[:, slot], num_docs)
        acc.index_add_(0, idx.reshape(-1),
                       torch.where(ok[:, slot], w[:, slot], 0.0).reshape(-1))
    return acc.view(b, num_docs + 1)[:, :num_docs].reshape(*lead, num_docs)


def accumulate_counts(doc_ids: Tensor, valid: Tensor,
                      num_docs: int) -> Tensor:
    """Exact per-document membership counts, as integers (float32 loses
    integer exactness past 2**24).  doc_ids/valid [..., cap] ->
    i32[num_docs]; integer adds commute, so CUDA's atomics cannot
    change the result."""
    flat = torch.where(valid, doc_ids, num_docs).reshape(-1).long()
    acc = torch.zeros(num_docs + 1, dtype=torch.int32, device=flat.device)
    acc.index_add_(0, flat, valid.reshape(-1).to(torch.int32))
    return acc[:num_docs]


def _top_k(final: Tensor, k: int) -> QueryResult:
    """Dense top-k with the reference's tie order; misses -> (-1, 0)."""
    ids = torch.arange(final.shape[-1], dtype=torch.int32,
                       device=final.device).expand_as(final)
    top_scores, top_docs = merge_topk_candidates(final, ids, k)
    hit = torch.isfinite(top_scores)
    return QueryResult(doc_ids=torch.where(hit, top_docs, -1),
                       scores=torch.where(hit, top_scores, 0.0))


def lookup_query(index: Any, query_hashes: Tensor):
    """q_word for a batch: deduplicated hashes [B, T] -> (term ids,
    -1 where empty or absent; idf weights)."""
    query_hashes = dedup_query_hashes(query_hashes)
    present = query_hashes != 0
    term_ids = torch.where(present, index.lookup_terms(query_hashes), -1)
    df = index.term_df(term_ids)
    return term_ids, idf(df, index.docs.num_docs)


def score_queries(index: Any, query_hashes: Tensor, k: int, cap: int,
                  rank_blend: float = 0.0) -> QueryResult:
    """The dense oracle over a batch: query_hashes i32[B, T] (u32 hash
    bit-views, 0 = empty slot) -> top-k per query.  Lookup -> gather ->
    doc metadata, ranked by cosine(q, d) (+ static-rank blend)."""
    term_ids, idf_t = lookup_query(index, query_hashes)    # q_word
    num_docs = index.docs.num_docs
    d, tf, valid = index.gather_postings(term_ids, cap)     # q_occ
    scores = accumulate_scores(d, tf * idf_t[..., None], valid, num_docs)
    final = final_scores(scores, index.docs.norm, index.docs.rank,
                         query_norm(idf_t), rank_blend)       # q_doc
    return _top_k(final, k)


def score_query(index: Any, query_hashes: Tensor, k: int, cap: int,
                rank_blend: float = 0.0) -> QueryResult:
    """One query (i32[T] hash bit-views) through the dense oracle."""
    r = score_queries(index, query_hashes[None], k, cap, rank_blend)
    return QueryResult(doc_ids=r.doc_ids[0], scores=r.scores[0])


def conjunctive_scores(index: Any, term_ids: Tensor, idf_w: Tensor,
                       needed: int, cap: int) -> tuple[Tensor, int]:
    """AND semantics over one query's term ids i32[T] and weights
    f32[T]: f32[num_docs] scores ``scores / max(norm, 1e-12)`` of the live
    docs that hold at least ``needed`` of the terms, -inf elsewhere, and
    the count of present terms whose posting list is longer than
    ``cap`` (their tails were not read, so matches may be lost)."""
    num_docs = index.docs.num_docs
    df = index.term_df(term_ids)
    d, tf, valid = index.gather_postings(term_ids, cap)
    scores = accumulate_scores(d, tf * idf_w[:, None], valid, num_docs)
    counts = accumulate_counts(d, valid, num_docs)
    truncated = int(((df > cap) & (term_ids >= 0)).sum())
    norm = index.docs.norm
    final = torch.where((counts >= needed) & (norm > 0),
                        scores / norm.clamp_min(1e-12), float("-inf"))
    return final, truncated


def conjunctive_filter(index: Any, query_hashes, k: int,
                       cap: int) -> tuple[QueryResult, dict]:
    """AND semantics for ONE query (u32 hashes [T], numpy or an int32
    bit-view tensor): docs must contain every present query term.

    Duplicate hashes are deduplicated first, so ``needed`` counts unique
    present terms (a term absent from the vocabulary still counts, so
    it matches nothing).  Returns (QueryResult, stats);
    ``stats["truncated_terms"]`` counts present terms whose posting list
    is longer than ``cap``: their tails are not read, so AND matches
    may be lost, and the count is surfaced (and added to the
    ``engine_truncated_terms`` counter) instead of passing silently.
    """
    from repro_torch.kernels import ops
    qh = hash_tensor(query_hashes, index.device)
    needed = int((dedup_query_hashes(qh) != 0).sum())
    term_ids, idf_t = lookup_query(index, qh)
    final, truncated = conjunctive_scores(index, term_ids, idf_t, needed,
                                          cap)
    r = _top_k(final[None], k)
    ops.record_truncated(truncated)
    return (QueryResult(doc_ids=r.doc_ids[0], scores=r.scores[0]),
            {"truncated_terms": truncated})


MODES = ("candidates", "dense")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown fused-engine mode: {mode!r}")


def fused_score_queries(index: Any, query_hashes: Tensor, k: int, cap: int,
                        rank_blend: float = 0.0,
                        max_pairs: int | None = None,
                        mode: str = "candidates", tune: Any = None):
    """Batched evaluation through the fused engine: one kernel launch
    over the batch's shared posting blocks.  ``mode="candidates"``
    reduces each tile to candidates in the kernel and merges them
    (``merge_topk_candidates``); ``mode="dense"`` takes the dense
    kernel's [B, num_docs] scores through the oracle's scoring tail and
    a stable-sort top-k.  Needs a BlockedIndex or PackedCsrIndex.

    Returns (QueryResult, stats); ``stats["pair_overflow"]`` (an int)
    counts routing pairs DROPPED because ``max_pairs`` was undersized —
    also warned and counted (``ops.warn_on_overflow``), never silent.
    ``tune`` is a ``kernels.autotune.TuneConfig``; ``None`` looks up the
    table (the defaults while it is empty).
    """
    from repro_torch.kernels import autotune, ops

    _check_mode(mode)
    if tune is None:
        tune = autotune.lookup(index.device.type, int(index.docs.num_docs),
                               autotune.layout_of(index))
    term_ids, idf_t = lookup_query(index, query_hashes)
    if mode == "dense":
        scores, overflow = ops.fused_batched_scores(
            index, term_ids, idf_t, cap, max_pairs=max_pairs,
            tile=tune.tile, q_pad=tune.q_pad)
        overflow = int(overflow)
        ops.warn_on_overflow(overflow, "fused engine")
        final = final_scores(scores, index.docs.norm, index.docs.rank,
                             query_norm(idf_t), rank_blend)
        return _top_k(final, k), {"pair_overflow": overflow}
    cand_v, cand_i, overflow = ops.fused_batched_topk(
        index, term_ids, idf_t, cap, k, rank_blend=rank_blend,
        max_pairs=max_pairs, tile=tune.tile,
        k_tile=tune.resolve_k_tile(k), q_pad=tune.q_pad,
        reducer=tune.reducer, pairs_per_step=tune.pairs_per_step)
    overflow = int(overflow)
    ops.warn_on_overflow(overflow, "fused engine")
    top_scores, top_docs = merge_topk_candidates(cand_v, cand_i, k)
    hit = torch.isfinite(top_scores)
    result = QueryResult(doc_ids=torch.where(hit, top_docs, -1),
                         scores=torch.where(hit, top_scores, 0.0))
    return result, {"pair_overflow": overflow}


def make_scorer(index: Any, k: int, cap: int | None, rank_blend: float = 0.0,
                engine: str = "torch", max_pairs: int | None = None,
                mode: str = "candidates", return_stats: bool = False,
                tune: Any = None) -> Callable[[Any], QueryResult]:
    """Batched scorer over ``index`` on the index's device.

    ``engine="torch"`` is the dense oracle, over any layout (the
    paper's Table 7 compares PR and OR with either lookup, COR, HOR and
    packed through it); ``engine="fused"`` the fused
    engine (BlockedIndex / PackedCsrIndex only) in ``mode="candidates"``
    or ``"dense"`` — same ranked results, one pass over the routed
    posting blocks.  A ``SegmentedIndex`` goes to its own multi-segment
    path (``SegmentedIndex.topk``; ``cap=None`` reads each segment's
    full lists).  ``tune`` (a ``kernels.autotune.TuneConfig``) fixes the
    fused engine's geometry, for every segment of a ``SegmentedIndex``;
    ``None`` looks up the active tuning table when the scorer is called.
    The scorer takes u32 query hashes [B, T] (numpy, or an int32 bit-view
    tensor) and returns a QueryResult, or (QueryResult, stats) with
    ``return_stats=True``.
    """
    if engine not in ("torch", "fused"):
        raise ValueError(f"unknown engine: {engine!r}")
    _check_mode(mode)
    from repro_torch.core.live_index import SegmentedIndex
    if isinstance(index, SegmentedIndex):
        if max_pairs is not None:
            raise ValueError(
                "max_pairs is not configurable for a SegmentedIndex: each "
                "sealed segment carries its own size-class budget")

        def live_scorer(query_hashes):
            return index.topk(query_hashes, k, cap=cap,
                              rank_blend=rank_blend, engine=engine,
                              mode=mode, return_stats=return_stats,
                              tune=tune)
        return live_scorer
    if engine == "fused":
        from repro_torch.core.layouts import BlockedIndex, PackedCsrIndex
        if not isinstance(index, (BlockedIndex, PackedCsrIndex)):
            raise TypeError(
                f"engine='fused' needs a BlockedIndex or PackedCsrIndex, "
                f"got {type(index).__name__}")

    def scorer(query_hashes):
        qh = hash_tensor(query_hashes, index.device)
        if engine == "fused":
            result, stats = fused_score_queries(
                index, qh, k=k, cap=cap, rank_blend=rank_blend,
                max_pairs=max_pairs, mode=mode, tune=tune)
        else:
            result = score_queries(index, qh, k=k, cap=cap,
                                   rank_blend=rank_blend)
            stats = {"pair_overflow": 0}
        return (result, stats) if return_stats else result
    return scorer


# ---------------------------------------------------------------------------
# adaptive routing budgets (the fused engine's max_pairs, learned online)
# ---------------------------------------------------------------------------


def _pow2_at_least(n: int, floor: int = 8) -> int:
    """Power-of-two budget quantizer: ``layouts.size_class`` at growth 2,
    so budgets and segment size classes quantize alike."""
    from repro_torch.core.layouts import size_class
    return size_class(n, base=floor, growth=2)


class AdaptiveRoutingBudget:
    """Per-``n_terms`` routing-pair budgets learned from the fused
    engine's overflow counter and a rolling window of observed demand.

    A static ``max_pairs`` trades memory and routing work against
    dropped postings: too small and the engine overflows (counted and
    warned, but work is lost), too large and every batch builds and
    sorts routing slots it never fills.  When a batch overflows, its
    true demand is exactly ``budget + overflow`` (the counter reports
    dropped pairs), so one growth step reaches a sufficient budget; a
    rolling window of recent demands lets quiet buckets shrink back.
    Budgets quantize to powers of two.  The reference's rules, unchanged.
    """

    def __init__(self, initial: int = 64, window: int = 64,
                 shrink_ratio: int = 4):
        self.initial = int(initial)
        self.window = int(window)
        self.shrink_ratio = int(shrink_ratio)
        self._budgets: dict[int, int] = {}
        self._demands: dict[int, list] = {}
        self.overflows = 0          # batches that overflowed (telemetry)

    def budget(self, n_terms: int) -> int:
        return self._budgets.setdefault(
            int(n_terms), _pow2_at_least(self.initial))

    def observe(self, n_terms: int, used_budget: int,
                overflow: int) -> None:
        """Record one batch: ``overflow`` pairs were dropped beyond
        ``used_budget``, so the exact demand was their sum."""
        n_terms = int(n_terms)
        demand = int(used_budget) + int(overflow)
        hist = self._demands.setdefault(n_terms, [])
        hist.append(demand)
        del hist[:-self.window]
        cur = self.budget(n_terms)
        if overflow > 0:
            self.overflows += 1
            # one doubling of headroom past the exact demand, so
            # batch-to-batch jitter does not overflow at the next
            # power-of-two boundary
            self._budgets[n_terms] = _pow2_at_least(demand) * 2
        elif (len(hist) >= self.window and
              _pow2_at_least(max(hist)) * self.shrink_ratio <= cur):
            # sustained quiet: shrink toward the sampled demand (one
            # headroom doubling), at most once per window
            self._budgets[n_terms] = _pow2_at_least(max(hist)) * 2


def make_adaptive_scorer(index: Any, k: int, cap: int,
                         budget: AdaptiveRoutingBudget | None = None,
                         **scorer_kw):
    """Fused-engine scorer whose ``max_pairs`` follows the workload.

    Batches are bucketed by their widest query (unique present terms,
    after ``dedup_query_hashes``); each bucket's budget starts small and
    converges through the overflow counter.  One ``make_scorer(...,
    engine="fused", max_pairs=budget, return_stats=True)`` is kept per
    budget, as in the reference (it holds the index and the routing
    arguments; nothing is compiled).  Returns ``fn(query_hashes) ->
    (QueryResult, stats)`` with the budget object on ``fn.budget``.
    """
    budget = budget if budget is not None else AdaptiveRoutingBudget()
    scorers: dict[int, Callable] = {}

    def scorer(query_hashes):
        deduped = dedup_query_hashes(hash_tensor(query_hashes, "cpu"))
        n_terms = max(int((deduped != 0).sum(dim=-1).max()), 1)
        mp = budget.budget(n_terms)
        if mp not in scorers:
            scorers[mp] = make_scorer(index, k=k, cap=cap, engine="fused",
                                      max_pairs=mp, return_stats=True,
                                      **scorer_kw)
        result, stats = scorers[mp](query_hashes)
        budget.observe(n_terms, mp, int(stats["pair_overflow"]))
        return result, stats

    scorer.budget = budget
    return scorer
