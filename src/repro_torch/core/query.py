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

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.layouts import hash_tensor
from repro_torch.distributed.topk import merge_topk_candidates

Tensor = torch.Tensor


class QueryResult(NamedTuple):
    doc_ids: Tensor    # i32[..., k]   (-1 where fewer than k hits)
    scores: Tensor     # f32[..., k]


def idf(df: Tensor, num_docs: int) -> Tensor:
    """idf = ln(1 + D/df); 0 where the term is absent (df == 0)."""
    safe = df.clamp_min(1)
    return torch.where(df > 0, torch.log1p(num_docs / safe.float()), 0.0)


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


def query_norm(idf_w: Tensor) -> Tensor:
    """Query norms sqrt(max(sum_t w_t**2, 1e-12)) over the last axis, as
    the reference's XLA lowering computes them on the CPU for queries of
    up to 4 slots: the slot sum as a chain of fused multiply-adds in slot
    order, then a correctly rounded square root (through f64, which is
    exact for an f32 input).  Wider queries are summed in the same order;
    XLA reduces those in another, so their norms may differ from its in
    the last bit."""
    acc = torch.zeros(idf_w.shape[:-1], dtype=torch.float32,
                      device=idf_w.device)
    for t in range(idf_w.shape[-1]):
        acc = fma_f32(idf_w[..., t], idf_w[..., t], acc)
    return torch.sqrt(acc.clamp_min(1e-12).double()).float()


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
    full lists).  The scorer takes u32 query hashes [B, T] (numpy, or an
    int32 bit-view tensor) and returns a QueryResult, or (QueryResult,
    stats) with ``return_stats=True``.
    """
    if engine not in ("torch", "fused"):
        raise ValueError(f"unknown engine: {engine!r}")
    _check_mode(mode)
    from repro_torch.core.live_index import SegmentedIndex
    if isinstance(index, SegmentedIndex):
        if max_pairs is not None or tune is not None:
            raise ValueError(
                "max_pairs and tune are not configurable for a "
                "SegmentedIndex: each sealed segment carries its own "
                "size-class budget and tuned geometry")

        def live_scorer(query_hashes):
            return index.topk(query_hashes, k, cap=cap,
                              rank_blend=rank_blend, engine=engine,
                              mode=mode, return_stats=return_stats)
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
