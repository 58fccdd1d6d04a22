"""Segmented live index — LSM-style ingest, tombstone deletes, and
multi-segment fused query: the port of ``repro.core.live_index``.

Segment lifecycle (delta -> seal -> compact)
--------------------------------------------

  * DELTA — an append-only, doc-major postings buffer of fixed
    capacity (host numpy).  Ingest batches append here in O(batch) time;
    per-doc postings are kept in ascending unified-term order, the
    per-document accumulation order of the bulk builder's term-major
    sort, which keeps recomputed norms bit-equal to a rebuild.  Queries
    score it from a device mirror of its filled prefix.

  * SEAL — when the delta fills (or ``seal()`` is called) its contents
    become one immutable sealed segment: an HOR ``BlockedIndex``, a
    ``PackedCsrIndex`` or a ``BandedCsrIndex`` over the segment's
    contiguous doc-id range, built on ``device`` and padded to a size
    class (``layouts.size_class`` / ``pad_*_to_class``), as the
    reference pads it.

  * COMPACT — a size-tiered policy (``core/compaction.py``) merges the
    newest run of similarly-sized segments into one, physically dropping
    tombstoned postings.  Doc ids are never reused or renumbered.

Exact-ranking contract
----------------------

Scoring state that depends on the whole corpus is kept globally and
exactly: ``df`` over live documents, the live doc count behind idf, and
tf-idf norms recomputed per mutation with the bulk builder's float64 op
sequence (host numpy, bit-equal to the reference).  Tombstones zero a
doc's norm, which every engine's scoring tail masks.  At any point of an
add/delete/compact schedule the fused engines rank like the gather
oracle over ``bulk_build`` of ``export_live_corpus()``.

Queries: one engine call per sealed segment — the candidate kernel for
an HOR or packed segment, or (``mode="dense"``) the dense kernel and a
per-tile reduction; a banded segment always takes one dense launch per
band, the two partials summed — then the delta scored on its own and
the per-source candidates merged on the host.

The reference keys its jit caches on each segment's size class and
counts their entries (``scorer_cache_sizes``).  Eager PyTorch compiles
nothing per shape and the CUDA kernels take every extent at run time, so
the port has no compilation cache to count.

Epochs and pinned views: every query-visible mutation advances
``epoch``; ``view()`` returns an immutable ``LiveView`` of that epoch
(segment indexes are replaced, never mutated; the delta mirror is
rebuilt on change; the in-place-mutated host state is copied).
"""
from __future__ import annotations

import bisect
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import build as build_mod
from repro_torch.core import compaction, layouts, size_model
from repro_torch.core.build import TokenizedCorpus
from repro_torch.core.layouts import DocTable, PostingsHost
from repro_torch.core.segments import run_ranks
from repro_torch.core.query import (QueryResult, final_scores, idf,
                                   query_norm)
from repro_torch.distributed.topk import merge_topk_candidates_host
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.fused_decode_score import (TILE, default_k_tile,
                                                    extract_tile_candidates)
from repro_torch.obs.registry import EventLog

Tensor = torch.Tensor
LAYOUTS = ("hor", "packed", "banded")


# ---------------------------------------------------------------------------
# query weights and the delta scorers
# ---------------------------------------------------------------------------


def _query_weights(df: Tensor, d_live: float):
    """Global idf weights + query norms: ``query.idf`` and the oracle's
    qnorm over LIVE df (i32[B, T]) and the live doc count, bit for bit
    the reference's ``_query_weights``."""
    w = idf(df, d_live)
    return w, query_norm(w)


def _posting_weights(terms: Tensor, tids: Tensor, idf_w: Tensor) -> Tensor:
    """Per-posting query weight f32[..., P]: each posting's unified term
    id against the query's dedup'd term-id slots (at most one matches).
    tids / idf_w [..., T]."""
    match = ((terms[..., None] == tids[..., None, :])
             & (tids[..., None, :] >= 0) & (terms[..., None] >= 0))
    return torch.where(match, idf_w[..., None, :], 0.0).sum(dim=-1)


def _sum_in_posting_order(contrib: Tensor, doc_of: Tensor,
                          n_docs: int) -> Tensor:
    """acc f32[B, n_docs]: each doc's posting contributions summed in
    posting order, as the reference's sequential scatter-add sums them.
    The delta is doc-major, so a doc's postings are contiguous; only the
    few postings of a doc that match a query term are nonzero, and
    adding 0.0 changes no sum, so round r adds the r-th nonzero posting
    of every doc at once — no two of its adds collide, so the order is
    fixed on CUDA too."""
    acc = torch.zeros(contrib.shape[0], n_docs, dtype=torch.float32,
                      device=contrib.device)
    idx = torch.nonzero((contrib != 0).any(dim=0)).squeeze(1)
    if idx.numel() == 0:
        return acc
    d = doc_of[idx].long()
    rnd = run_ranks(d)
    for r in range(int(rnd.max()) + 1):
        sel = torch.nonzero(rnd == r).squeeze(1)
        acc[:, d[sel]] += contrib[:, idx[sel]]
    return acc


def _delta_candidates(dev: dict, tids: Tensor, idf_w: Tensor, qnorm: Tensor,
                      doc_base: int, *, k_tile: int, tile: int = TILE,
                      rank_blend: float = 0.0):
    """Score the delta (its device mirror ``dev``) for a batch and
    reduce to the per-tile candidate lists the segment engines emit."""
    contrib = dev["tfs"][None, :] * _posting_weights(dev["terms"][None],
                                                     tids, idf_w)
    scores = _sum_in_posting_order(contrib, dev["doc_of"],
                                   dev["norm"].shape[0])
    final = final_scores(scores, dev["norm"], dev["rank"], qnorm, rank_blend)
    vals, ids = extract_tile_candidates(final, tile, k_tile)
    return vals, torch.where(ids >= 0, ids + doc_base, -1)


def _delta_conjunctive(dev: dict, tids: Tensor, idf_w: Tensor, needed: int,
                       doc_base: int, *, k_tile: int, tile: int = TILE):
    """AND-semantics counts + scores over the delta for ONE query
    (tids / idf_w [T]).  The delta is scanned in full (no cap), so it
    never truncates."""
    n_docs = dev["norm"].shape[0]
    w_p = _posting_weights(dev["terms"], tids, idf_w)
    hit = (((dev["terms"][:, None] == tids[None, :]) & (tids[None, :] >= 0))
           .any(dim=1))
    scores = _sum_in_posting_order((dev["tfs"] * w_p)[None], dev["doc_of"],
                                   n_docs)[0]
    counts = torch.zeros(n_docs, dtype=torch.int32, device=tids.device)
    counts.index_add_(0, dev["doc_of"].long(), hit.to(torch.int32))
    norm = dev["norm"]
    final = torch.where((counts >= needed) & (norm > 0),
                        scores / norm.clamp_min(1e-12), float("-inf"))
    vals, ids = extract_tile_candidates(final[None], tile, k_tile)
    return vals[0], torch.where(ids[0] >= 0, ids[0] + doc_base, -1)


def _dedup_np(qh: np.ndarray) -> np.ndarray:
    """Host twin of ``query.dedup_query_hashes`` (keep first, zero rest)."""
    out = qh.copy()
    t = qh.shape[-1]
    eq = qh[..., :, None] == qh[..., None, :]
    earlier = np.tril(np.ones((t, t), bool), k=-1)
    dup = (eq & earlier).any(axis=-1) & (qh != 0)
    out[dup] = 0
    return out


def _lookup_sorted(hash_sorted: np.ndarray, hash_order: np.ndarray,
                   qh: np.ndarray) -> np.ndarray:
    """u32[...] hashes -> unified term ids (i64, -1 absent/empty) via a
    host binary search over the sorted vocabulary."""
    w = len(hash_sorted)
    if w == 0:
        return np.full(qh.shape, -1, np.int64)
    flat = qh.reshape(-1)
    pos = np.searchsorted(hash_sorted, flat)
    posc = np.minimum(pos, w - 1)
    hit = (hash_sorted[posc] == flat) & (flat != 0)
    return np.where(hit, hash_order[posc], -1).reshape(qh.shape)


def _u32(query_hashes) -> np.ndarray:
    """Query hashes (u32 numpy, or an int32 bit-view tensor) as u32."""
    if isinstance(query_hashes, Tensor):
        return query_hashes.cpu().numpy().astype(np.int32).view(np.uint32)
    return np.asarray(query_hashes, np.uint32)


# ---------------------------------------------------------------------------
# stats / delta / segment containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LiveIndexStats:
    """Work and lifecycle counters (all cumulative).  ``postings_merged``
    is the posting-merge work (seal builds + compaction merges); delta
    appends and the norm refresh are counted apart."""
    postings_appended: int = 0
    postings_sealed: int = 0
    postings_compacted: int = 0
    postings_norm_refreshed: int = 0
    docs_added: int = 0
    seals: int = 0
    compactions: int = 0
    deletes: int = 0
    layout_rewrites: int = 0

    @property
    def postings_merged(self) -> int:
        return self.postings_sealed + self.postings_compacted


class _Delta:
    """Fixed-capacity append-only doc-major postings buffer (host side);
    per-doc postings in ascending unified-term order."""

    def __init__(self, doc_cap: int, post_cap: int, doc_base: int):
        self.doc_cap = int(doc_cap)
        self.post_cap = int(post_cap)
        self.doc_base = int(doc_base)
        self.n_docs = 0
        self.n_postings = 0
        self.terms = np.full(self.post_cap, -1, np.int32)
        self.tfs = np.zeros(self.post_cap, np.float32)
        self.doc_of = np.full(self.post_cap, -1, np.int32)
        self.doc_offsets = np.zeros(self.doc_cap + 1, np.int64)

    def append(self, lens: np.ndarray, terms: np.ndarray,
               tfs: np.ndarray) -> None:
        n, p = len(lens), len(terms)
        assert self.n_docs + n <= self.doc_cap
        assert self.n_postings + p <= self.post_cap
        s = self.n_postings
        self.terms[s:s + p] = terms
        self.tfs[s:s + p] = tfs
        self.doc_of[s:s + p] = np.repeat(
            np.arange(self.n_docs, self.n_docs + n, dtype=np.int32), lens)
        off = self.doc_offsets
        off[self.n_docs + 1:self.n_docs + n + 1] = \
            off[self.n_docs] + np.cumsum(lens)
        self.n_docs += n
        self.n_postings += p


@dataclasses.dataclass
class Segment:
    """One immutable sealed run: ``index`` is a size-class-padded index
    over LOCAL doc ids (global id = local + doc_base); the host arrays
    are the (doc, term)-sorted forward canonical used for norm refresh,
    per-doc delete lookups and compaction merges."""
    index: (layouts.BlockedIndex | layouts.PackedCsrIndex
            | layouts.BandedCsrIndex)
    doc_base: int
    doc_span: int              # allocated local id range (may have holes)
    doc_of: np.ndarray         # i32[P] local doc ids, doc-major
    terms: np.ndarray          # i32[P] unified term ids, asc within doc
    tfs: np.ndarray            # f32[P]
    doc_offsets: np.ndarray    # i64[doc_span + 1] forward CSR
    n_postings: int
    size_class: int = 0        # padded doc-span class the build used
    num_terms: int = 0         # distinct terms with postings in this run
    chooser_reason: str = "default"  # how the layout ladder resolved
    band_cut: int = 0          # banded only: packed-band width cut (words)

    @property
    def layout(self) -> str:
        return autotune.layout_of(self.index)

    @property
    def stats(self) -> size_model.SegmentStats:
        """Aggregate shape the layout chooser sees for this run."""
        return size_model.SegmentStats(num_docs=self.doc_span,
                                       num_postings=self.n_postings,
                                       num_terms=self.num_terms)


def _layout_mix(segments) -> dict:
    """Per-layout composition of a sealed stack."""
    mix = {"segments": [], "counts": {}, "docs": {}, "postings": {},
           "reasons": {}}
    for seg in segments:
        lay = seg.layout
        rec = {"doc_base": int(seg.doc_base), "doc_span": int(seg.doc_span),
               "size_class": int(seg.size_class), "layout": lay,
               "n_postings": int(seg.n_postings),
               "chooser_reason": seg.chooser_reason}
        if lay == "banded":
            rec["band_cut"] = int(seg.band_cut)
        mix["segments"].append(rec)
        mix["counts"][lay] = mix["counts"].get(lay, 0) + 1
        mix["docs"][lay] = mix["docs"].get(lay, 0) + int(seg.doc_span)
        mix["postings"][lay] = (mix["postings"].get(lay, 0)
                                + int(seg.n_postings))
        mix["reasons"][seg.chooser_reason] = \
            mix["reasons"].get(seg.chooser_reason, 0) + 1
    return mix


# ---------------------------------------------------------------------------
# epoch-pinned immutable view
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LiveView:
    """An immutable snapshot of the query-visible index state at one
    epoch: answers ``topk`` / ``conjunctive`` as the ``SegmentedIndex``
    did at pin time, and ``export_live_corpus`` gives the matching
    oracle corpus."""
    epoch: int
    segments: tuple            # pinned shallow copies of Segment
    delta_dev: dict            # device mirror of the delta's filled prefix
    delta_terms: np.ndarray    # host delta tail, trimmed copies
    delta_tfs: np.ndarray
    delta_doc_of: np.ndarray
    delta_doc_offsets: np.ndarray   # i64[delta_n_docs + 1]
    delta_doc_base: int
    delta_n_docs: int
    hashes: np.ndarray         # unified vocabulary (replaced on growth)
    hash_sorted: np.ndarray
    hash_order: np.ndarray
    df: np.ndarray             # i64[W] live global df (copy)
    live: np.ndarray           # bool[num_docs] (copy)
    live_docs: int
    num_docs: int
    device: torch.device

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    def layout_mix(self) -> dict:
        return _layout_mix(self.segments)

    # -- query path ---------------------------------------------------------

    def prepare(self, query_hashes):
        """What the engines score a batch with: the dedup'd hashes on the
        device (i32 bit-views), the unified term ids, the GLOBAL idf
        weights over live df and live docs, and the query norms."""
        qh = _dedup_np(_u32(query_hashes))
        tids = _lookup_sorted(self.hash_sorted, self.hash_order, qh)
        if len(self.df):
            df = np.where(tids >= 0, self.df[np.maximum(tids, 0)],
                          0).astype(np.int32)
        else:
            df = np.zeros(qh.shape, np.int32)
        idf_w, qnorm = _query_weights(torch.from_numpy(df).to(self.device),
                                      float(np.float32(self.live_docs)))
        tids_dev = torch.from_numpy(tids.astype(np.int32)).to(self.device)
        return layouts.hash_tensor(qh, self.device), tids_dev, idf_w, qnorm

    def _result(self, mv: np.ndarray, mi: np.ndarray) -> QueryResult:
        hit = np.isfinite(mv)
        ids = np.where(hit, mi, -1).astype(np.int32)
        scores = np.where(hit, mv, 0.0).astype(np.float32)
        return QueryResult(doc_ids=torch.from_numpy(ids).to(self.device),
                           scores=torch.from_numpy(scores).to(self.device))

    def topk(self, query_hashes, k: int, *, cap: int | None = None,
             rank_blend: float = 0.0, engine: str = "fused",
             mode: str = "candidates", return_stats: bool = False,
             tune=None, trace=None):
        """Batched top-k over this view's delta + sealed segments.

        query_hashes u32[B, T] (numpy, or an int32 bit-view tensor).
        ``engine="fused"`` runs each HOR / packed segment through its
        candidate kernel (``mode="candidates"``) or its dense kernel
        (``mode="dense"``); a banded segment takes one dense launch per
        band in either mode (scores add over terms, so per-band
        candidates could not merge).  ``engine="torch"`` is the gather
        oracle.  ``cap`` defaults to each segment's (quantized) full
        posting length.  Kernel geometry resolves per segment from the
        active tuning table (each segment's device type, size class and
        layout), or from ``tune`` (a ``kernels.autotune.TuneConfig``) for
        every segment; the delta scores at the default tile.  ``trace``
        optionally takes an ``obs.trace.Trace``: a ``segment`` child span
        of ``score`` per sealed segment, one for the delta, one for the
        host merge; the results do not change."""
        if engine not in ("fused", "torch"):
            raise ValueError(f"unknown engine: {engine!r}")
        if mode not in ("candidates", "dense"):
            raise ValueError(f"unknown fused-engine mode: {mode!r}")
        qh = _u32(query_hashes)
        if qh.ndim != 2:
            raise ValueError("query_hashes must be [B, T]")
        qh_dev, tids, idf_w, qnorm = self.prepare(qh)
        k_tile = default_k_tile(k)        # delta path: TILE-wide tiles
        vals, ids, overflows = [], [], []
        for seg in self.segments:
            ix = seg.index
            cfg = (tune if tune is not None else autotune.lookup(
                ix.device.type, int(ix.docs.num_docs), seg.layout))
            seg_kt = cfg.resolve_k_tile(k)
            if seg.layout == "banded":
                mp_p, mp_h = ops.banded_pairs_budgets(ix, cfg.tile,
                                                      cfg.pairs_per_step)
                mp = mp_p + mp_h
            else:
                mp = ops.padded_pairs_budget(ix, cfg.tile,
                                             cfg.pairs_per_step)
            c = int(cap) if cap is not None else ix.max_posting_len
            span = None
            if trace is not None:
                span = trace.span(
                    "segment", parent="score", doc_base=int(seg.doc_base),
                    size_class=int(seg.size_class), layout=seg.layout,
                    tile=int(cfg.tile), k_tile=int(seg_kt),
                    reducer=cfg.reducer,
                    pairs_per_step=int(cfg.pairs_per_step),
                    max_pairs=int(mp),
                    candidate_bytes=size_model.candidate_bytes_per_query(
                        int(ix.docs.num_docs), int(cfg.tile), int(seg_kt)),
                    posting_bytes=size_model.est_posting_bytes(
                        seg.stats, seg.layout),
                    **({"band_cut": int(seg.band_cut)}
                       if seg.layout == "banded" else {}))
            if engine == "torch":
                v, g, o = ops.torch_segment_topk(
                    ix, qh_dev, idf_w, seg.doc_base, k_tile=k_tile, cap=c,
                    rank_blend=rank_blend, qnorm=qnorm)
            elif seg.layout == "banded":
                v, g, o = ops.fused_segment_banded_topk(
                    ix, qh_dev, idf_w, seg.doc_base, k_tile=seg_kt,
                    cap_packed=min(c, max(ix.packed.max_posting_len, 1)),
                    cap_hor=min(c, max(ix.hor.max_posting_len, 1)),
                    max_pairs_packed=mp_p, max_pairs_hor=mp_h,
                    rank_blend=rank_blend, tile=cfg.tile, q_pad=cfg.q_pad,
                    qnorm=qnorm)
            elif mode == "dense":
                v, g, o = ops.fused_segment_dense_topk(
                    ix, qh_dev, idf_w, seg.doc_base, k_tile=seg_kt, cap=c,
                    max_pairs=mp, rank_blend=rank_blend, tile=cfg.tile,
                    q_pad=cfg.q_pad, qnorm=qnorm)
            else:
                v, g, o = ops.fused_segment_topk(
                    ix, qh_dev, idf_w, seg.doc_base, k_tile=seg_kt, cap=c,
                    max_pairs=mp, rank_blend=rank_blend, tile=cfg.tile,
                    q_pad=cfg.q_pad, reducer=cfg.reducer,
                    pairs_per_step=cfg.pairs_per_step, qnorm=qnorm)
            # keep device tensors until every segment is dispatched; the
            # host merge copies them back
            vals.append(v)
            ids.append(g)
            overflows.append(o)
            if span is not None:
                span.end()
        dspan = (trace.span("delta", parent="score",
                            postings=int(self.delta_terms.shape[0]),
                            docs=int(self.delta_n_docs), k_tile=int(k_tile))
                 if trace is not None else None)
        dv, dg = _delta_candidates(self.delta_dev, tids, idf_w, qnorm,
                                   self.delta_doc_base, k_tile=k_tile,
                                   rank_blend=rank_blend)
        vals.append(dv)
        ids.append(dg)
        if dspan is not None:
            dspan.end()
        overflow = sum(int(o) for o in overflows)
        if not return_stats:
            ops.warn_on_overflow(overflow, "live-view fused engine")
        result = self._result(*merge_topk_candidates_host(vals, ids, k,
                                                          trace=trace))
        if return_stats:
            return result, {"pair_overflow": overflow}
        return result

    def conjunctive(self, query_hashes, k: int, cap: int):
        """AND semantics over the pinned index for ONE query [T]; the
        ``truncated_terms`` stat sums every segment's cap truncation."""
        qh = _dedup_np(_u32(query_hashes).reshape(1, -1))
        needed = int((qh != 0).sum())
        qh_dev, tids, idf_w, _ = self.prepare(qh)
        k_tile = default_k_tile(k)
        vals, ids, truncated = [], [], 0
        for seg in self.segments:
            v, g, t = ops.torch_segment_conjunctive(
                seg.index, qh_dev[0], idf_w[0], needed, seg.doc_base,
                k_tile=k_tile, cap=int(cap))
            vals.append(v)
            ids.append(g)
            truncated += t
        ops.record_truncated(truncated)
        dv, dg = _delta_conjunctive(self.delta_dev, tids[0], idf_w[0],
                                    needed, self.delta_doc_base,
                                    k_tile=k_tile)
        vals.append(dv)
        ids.append(dg)
        result = self._result(*merge_topk_candidates_host(vals, ids, k))
        return result, {"truncated_terms": truncated}

    # -- oracle support -----------------------------------------------------

    def _owner(self, d: int):
        """Segment position owning global doc id d (None = the delta)."""
        if d >= self.delta_doc_base:
            return None
        bases = [s.doc_base for s in self.segments]
        i = bisect.bisect_right(bases, d) - 1
        seg = self.segments[i]
        assert seg.doc_base <= d < seg.doc_base + seg.doc_span
        return i

    def export_live_corpus(self):
        """The equivalent live corpus at this epoch over the pinned
        vocabulary, plus the ascending global ids of its docs — what a
        parity oracle should ``bulk_build`` against this view."""
        live_ids = np.flatnonzero(self.live)
        doc_term_ids, doc_counts = [], []
        for d in live_ids:
            o = self._owner(int(d))
            if o is None:
                local = int(d) - self.delta_doc_base
                if local >= self.delta_n_docs:
                    t = np.zeros(0, np.int64)
                    tf = np.zeros(0, np.float64)
                else:
                    a, b = (self.delta_doc_offsets[local],
                            self.delta_doc_offsets[local + 1])
                    t = self.delta_terms[a:b]
                    tf = self.delta_tfs[a:b]
            else:
                seg = self.segments[o]
                local = int(d) - seg.doc_base
                a, b = seg.doc_offsets[local], seg.doc_offsets[local + 1]
                t = seg.terms[a:b]
                tf = seg.tfs[a:b]
            doc_term_ids.append(np.asarray(t, np.int64))
            doc_counts.append(np.asarray(tf, np.float64).astype(np.int64))
        tc = TokenizedCorpus(doc_term_ids=doc_term_ids,
                             doc_counts=doc_counts,
                             term_hashes=self.hashes.copy(),
                             num_docs=len(live_ids))
        return tc, live_ids


# ---------------------------------------------------------------------------
# the live index
# ---------------------------------------------------------------------------


class SegmentedIndex:
    """LSM-style live index: mutable delta + sealed segment stack +
    tombstones, queried per segment by the fused engines.  Sealed
    segments live on ``device`` ("cuda" unless the caller asks for the
    CPU); see the module docstring for the lifecycle and contracts."""

    def __init__(self, term_hashes: np.ndarray | None = None, *,
                 delta_doc_capacity: int = 512,
                 delta_posting_capacity: int | None = None,
                 policy: compaction.TieredPolicy | None = None,
                 rank_seed: int = 7, seal_layout: str = "hor",
                 layout_policy: size_model.LayoutCostModel | None = None,
                 event_capacity: int = 256, device="cuda"):
        if seal_layout not in LAYOUTS:
            raise ValueError(f"unknown seal layout: {seal_layout!r}")
        self._device = torch.device(device)
        self._hashes = (np.asarray(term_hashes, np.uint32).copy()
                        if term_hashes is not None
                        else np.zeros(0, np.uint32))
        self._df = np.zeros(len(self._hashes), np.int64)
        self._rebuild_lookup()
        self._live = np.zeros(0, bool)
        self._rank = np.zeros(0, np.float32)
        self._norm = np.zeros(0, np.float32)
        self._live_docs = 0
        self._segments: list[Segment] = []
        post_cap = (int(delta_posting_capacity)
                    if delta_posting_capacity is not None
                    else int(delta_doc_capacity) * 64)
        self._delta = _Delta(delta_doc_capacity, post_cap, 0)
        self._delta_dev: dict | None = None
        self._delta_dirty = True
        self._policy = policy or compaction.TieredPolicy()
        # the reference's numpy rank stream, so ranks stay bit-equal
        self._rng = np.random.default_rng(rank_seed)
        self._seal_layout = seal_layout
        self._layout_policy = layout_policy
        self._epoch = 0
        self._view: LiveView | None = None
        self.stats = LiveIndexStats()
        self.events = EventLog(capacity=int(event_capacity))

    # -- introspection ------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def num_docs(self) -> int:
        """Allocated doc-id space (ids are never reused)."""
        return len(self._live)

    @property
    def live_doc_count(self) -> int:
        return self._live_docs

    @property
    def num_segments(self) -> int:
        return len(self._segments)

    @property
    def num_terms(self) -> int:
        return len(self._hashes)

    @property
    def term_hashes(self) -> np.ndarray:
        return self._hashes

    def live_mask(self) -> np.ndarray:
        return self._live.copy()

    def segment_postings(self) -> list:
        return [s.n_postings for s in self._segments]

    def segments(self) -> list:
        """The sealed stack (ascending doc_base; treat as read-only)."""
        return list(self._segments)

    def layout_mix(self) -> dict:
        return _layout_mix(self._segments)

    @property
    def layout_policy(self) -> size_model.LayoutCostModel | None:
        """The POLICY rung of the seal-layout ladder (``explicit
        seal(layout=...) > layout_policy > seal_layout``)."""
        return self._layout_policy

    @layout_policy.setter
    def layout_policy(self, policy: size_model.LayoutCostModel | None):
        self._layout_policy = policy

    @property
    def delta_postings(self) -> int:
        return self._delta.n_postings

    @property
    def policy(self) -> compaction.TieredPolicy:
        return self._policy

    @property
    def delta_fill(self) -> float:
        """Fill fraction of the delta (docs or postings, whichever is
        closer to capacity)."""
        dl = self._delta
        return max(dl.n_docs / dl.doc_cap, dl.n_postings / dl.post_cap)

    @property
    def epoch(self) -> int:
        """Monotonic counter of query-visible state changes."""
        return self._epoch

    def _bump_epoch(self) -> None:
        self._epoch += 1

    def view(self) -> LiveView:
        """The epoch-pinned immutable view of the current state (cached
        per epoch).  Call it serially with mutators."""
        if self._view is not None and self._view.epoch == self._epoch:
            return self._view
        dl = self._delta
        n_p = dl.n_postings
        self._view = LiveView(
            epoch=self._epoch,
            segments=tuple(dataclasses.replace(s) for s in self._segments),
            delta_dev=self._delta_device(),
            delta_terms=dl.terms[:n_p].copy(),
            delta_tfs=dl.tfs[:n_p].copy(),
            delta_doc_of=dl.doc_of[:n_p].copy(),
            delta_doc_offsets=dl.doc_offsets[:dl.n_docs + 1].copy(),
            delta_doc_base=dl.doc_base, delta_n_docs=dl.n_docs,
            hashes=self._hashes, hash_sorted=self._hash_sorted,
            hash_order=self._hash_order, df=self._df.copy(),
            live=self._live.copy(), live_docs=self._live_docs,
            num_docs=self.num_docs, device=self._device)
        return self._view

    # -- vocabulary ---------------------------------------------------------

    def _rebuild_lookup(self) -> None:
        self._hash_order = np.argsort(self._hashes,
                                      kind="stable").astype(np.int64)
        self._hash_sorted = self._hashes[self._hash_order]

    def lookup_np(self, qh: np.ndarray) -> np.ndarray:
        """u32[...] hashes -> unified term ids (i64, -1 absent/empty)."""
        return _lookup_sorted(self._hash_sorted, self._hash_order, qh)

    # -- mutation: add ------------------------------------------------------

    def add_batch(self, corpus: TokenizedCorpus, *,
                  refresh_norms: bool = True) -> None:
        """Ingest a tokenized batch: unify vocabularies, assign fresh
        ascending doc ids, append to the delta (sealing when full),
        update live df exactly, refresh norms, and let the tiered policy
        compact.  ``refresh_norms=False`` defers the O(live postings)
        norm pass for a streaming build, which must then call
        ``refresh_norms()`` once before serving."""
        t0 = time.perf_counter()
        nd = corpus.num_docs
        merged, remap = build_mod.merge_vocab(
            self._hashes, np.asarray(corpus.term_hashes, np.uint32))
        if len(merged) != len(self._hashes):
            grow = len(merged) - len(self._hashes)
            self._hashes = merged
            self._df = np.concatenate([self._df, np.zeros(grow, np.int64)])
            self._rebuild_lookup()
        if nd == 0:
            return
        lens = np.array([len(x) for x in corpus.doc_term_ids],
                        dtype=np.int64)
        total = int(lens.sum())
        if total:
            flat_terms = remap[
                np.concatenate(corpus.doc_term_ids).astype(np.int64)]
            flat_tfs = np.concatenate(corpus.doc_counts).astype(np.float32)
            doc_idx = np.repeat(np.arange(nd, dtype=np.int64), lens)
            # per-doc ascending UNIFIED term order (norm bit-parity)
            order = np.lexsort((flat_terms, doc_idx))
            flat_terms = flat_terms[order]
            flat_tfs = flat_tfs[order]
        else:
            flat_terms = np.zeros(0, np.int64)
            flat_tfs = np.zeros(0, np.float32)

        self._live = np.concatenate([self._live, np.ones(nd, bool)])
        self._rank = np.concatenate(
            [self._rank, (self._rng.random(nd) * 1e-3).astype(np.float32)])
        self._norm = np.concatenate([self._norm, np.zeros(nd, np.float32)])
        if total:
            self._df += np.bincount(flat_terms, minlength=len(self._hashes))
        self._live_docs += nd
        self.stats.postings_appended += total
        self.stats.docs_added += nd

        doc_starts = np.zeros(nd + 1, np.int64)
        np.cumsum(lens, out=doc_starts[1:])
        d = 0
        while d < nd:
            free_docs = self._delta.doc_cap - self._delta.n_docs
            free_posts = self._delta.post_cap - self._delta.n_postings
            cum = doc_starts[d:] - doc_starts[d]
            m = int(np.searchsorted(cum, free_posts, side="right")) - 1
            m = min(m, free_docs, nd - d)
            if m <= 0:
                if self._delta.n_docs > 0:
                    self._seal_delta()
                    continue
                # one doc larger than the delta's posting capacity: seal
                # it directly as its own segment
                s, e = doc_starts[d], doc_starts[d + 1]
                self._direct_seal(flat_terms[s:e], flat_tfs[s:e])
                d += 1
                continue
            s, e = doc_starts[d], doc_starts[d + m]
            self._delta.append(lens[d:d + m], flat_terms[s:e],
                               flat_tfs[s:e])
            d += m
        self._delta_dirty = True
        if refresh_norms:
            self._refresh_norms()
        self._maybe_compact()
        self._bump_epoch()
        self.events.emit(
            "ingest", epoch=self._epoch, docs=nd, postings=total,
            norms_refreshed=bool(refresh_norms),
            duration_us=(time.perf_counter() - t0) * 1e6)

    def refresh_norms(self) -> None:
        """Recompute every live doc norm from the current global df and
        push the metadata to each segment's DocTable."""
        t0 = time.perf_counter()
        self._refresh_norms()
        self._bump_epoch()
        self.events.emit(
            "norm_refresh", epoch=self._epoch,
            postings=self.stats.postings_norm_refreshed,
            duration_us=(time.perf_counter() - t0) * 1e6)

    def _direct_seal(self, terms: np.ndarray, tfs: np.ndarray) -> None:
        """Seal one oversized doc straight to a segment, bypassing the
        (empty) delta, whose base advances past the doc."""
        assert self._delta.n_docs == 0
        t0 = time.perf_counter()
        base = self._delta.doc_base
        doc_of = np.zeros(len(terms), np.int64)
        seg = self._build_segment(base, 1, doc_of, terms.astype(np.int64),
                                  tfs)
        self._segments.append(seg)
        self.stats.postings_sealed += len(terms)
        self.stats.seals += 1
        self._delta = _Delta(self._delta.doc_cap, self._delta.post_cap,
                             base + 1)
        self._delta_dirty = True
        self._bump_epoch()
        self.events.emit(
            "seal", epoch=self._epoch, doc_base=seg.doc_base,
            docs=seg.doc_span, postings=seg.n_postings,
            size_class=seg.size_class, layout=seg.layout,
            band_cut=seg.band_cut, chooser_reason=seg.chooser_reason,
            direct=True, duration_us=(time.perf_counter() - t0) * 1e6)

    # -- mutation: delete ---------------------------------------------------

    def delete(self, doc_ids) -> None:
        """Tombstone documents: mark dead, decrement live df from the
        forward postings, refresh norms (dead norm -> 0).  Postings stay
        until compaction reclaims them.  Already-dead ids are ignored;
        out-of-range ids raise."""
        ids = np.atleast_1d(np.asarray(doc_ids, np.int64))
        if ids.size == 0:
            return
        if ids.min() < 0 or ids.max() >= self.num_docs:
            raise ValueError(f"doc id out of range [0, {self.num_docs})")
        ids = np.unique(ids)
        ids = ids[self._live[ids]]
        if ids.size == 0:
            return
        for d in ids:
            terms = self._doc_terms(int(d))
            if len(terms):
                self._df[terms.astype(np.int64)] -= 1
        self._live[ids] = False
        self._live_docs -= int(ids.size)
        self.stats.deletes += int(ids.size)
        self._refresh_norms()
        self._bump_epoch()
        self.events.emit("delete", epoch=self._epoch, docs=int(ids.size),
                         live_docs=self._live_docs)

    def _owner(self, d: int):
        """Segment index owning global doc id d, or None for the delta."""
        if d >= self._delta.doc_base:
            return None
        bases = [s.doc_base for s in self._segments]
        i = bisect.bisect_right(bases, d) - 1
        seg = self._segments[i]
        assert seg.doc_base <= d < seg.doc_base + seg.doc_span
        return i

    def _doc_terms(self, d: int) -> np.ndarray:
        o = self._owner(d)
        if o is None:
            dl = self._delta
            local = d - dl.doc_base
            if local >= dl.n_docs:
                return np.zeros(0, np.int32)
            s, e = dl.doc_offsets[local], dl.doc_offsets[local + 1]
            return dl.terms[s:e]
        seg = self._segments[o]
        local = d - seg.doc_base
        s, e = seg.doc_offsets[local], seg.doc_offsets[local + 1]
        return seg.terms[s:e]

    # -- seal / compact -----------------------------------------------------

    def seal(self, layout: str | None = None) -> None:
        """Flush the delta into a sealed segment (no-op when empty);
        ``layout`` ("hor", "packed" or "banded") overrides the ladder for
        this seal."""
        self._seal_delta(layout=layout)

    def _seal_delta(self, layout: str | None = None) -> None:
        dl = self._delta
        if dl.n_docs == 0:
            return
        t0 = time.perf_counter()
        n_p = dl.n_postings
        doc_of = dl.doc_of[:n_p].astype(np.int64)
        terms = dl.terms[:n_p].astype(np.int64)
        tfs = dl.tfs[:n_p].copy()
        live = self._live[doc_of + dl.doc_base]
        if not live.all():
            doc_of, terms, tfs = doc_of[live], terms[live], tfs[live]
        seg = self._build_segment(dl.doc_base, dl.n_docs, doc_of, terms,
                                  tfs, layout=layout)
        self._segments.append(seg)
        self.stats.postings_sealed += n_p
        self.stats.seals += 1
        self._delta = _Delta(dl.doc_cap, dl.post_cap,
                             dl.doc_base + dl.n_docs)
        self._delta_dirty = True
        self._bump_epoch()
        self.events.emit(
            "seal", epoch=self._epoch, doc_base=seg.doc_base,
            docs=seg.doc_span, postings=seg.n_postings,
            size_class=seg.size_class, layout=seg.layout,
            band_cut=seg.band_cut, chooser_reason=seg.chooser_reason,
            duration_us=(time.perf_counter() - t0) * 1e6)

    def _build_segment(self, base: int, span: int, doc_of: np.ndarray,
                       terms: np.ndarray, tfs: np.ndarray,
                       layout: str | None = None,
                       band_cut: int | None = None) -> Segment:
        """Bulk-build one sealed segment over LOCAL doc ids on the index's
        device and pad it to its size class.  ``doc_of``/``terms``/
        ``tfs`` must be (doc, term)-sorted.  The layout resolves through
        the ladder: explicit arg > ``layout_policy`` > ``seal_layout``."""
        w = len(self._hashes)
        d_pad = layouts.size_class(span, base=layouts.ROUTE_TILE)
        order = np.lexsort((doc_of, terms))          # term-major for bulk
        df_seg = (np.bincount(terms, minlength=w) if len(terms)
                  else np.zeros(w, np.int64))
        n_terms_seg = int(np.count_nonzero(df_seg))
        run_stats = size_model.SegmentStats(
            num_docs=int(span), num_postings=len(terms),
            num_terms=n_terms_seg)
        layout, reason = size_model.resolve_layout(
            layout, self._layout_policy, run_stats, self._seal_layout,
            size_class=d_pad, device_type=self._device.type)
        if layout not in LAYOUTS:
            raise ValueError(f"unknown seal layout: {layout!r}")
        # the routing cache is built at the tile width the tuning table
        # picks for this (device, size class, layout)
        route_tile = autotune.lookup(self._device.type, d_pad, layout).tile
        offsets = np.zeros(w + 1, np.int64)
        np.cumsum(df_seg, out=offsets[1:])
        norm_pad = np.zeros(d_pad, np.float32)
        rank_pad = np.zeros(d_pad, np.float32)
        norm_pad[:span] = self._norm[base:base + span]
        rank_pad[:span] = self._rank[base:base + span]
        host = PostingsHost(
            term_hashes=self._hashes, df=df_seg.astype(np.int32),
            offsets=offsets, doc_ids=doc_of[order].astype(np.int32),
            tfs=tfs[order].astype(np.float32), num_docs=d_pad,
            norm=norm_pad, rank=rank_pad)
        w_pad = layouts.size_class(w, base=256)
        cut = 0
        if layout == "banded":
            # lane_quantum=8 prices the cut at the packed lane padding
            # applied below; the REALIZED pre-pad stride is recorded as
            # the cut, so a rebuild with it reproduces the band split
            bix = layouts.build_banded(host, max_band_words=band_cut,
                                       route_tile=route_tile,
                                       lane_quantum=8, device=self._device)
            cut = int(bix.packed.words_per_block)
            p = self._pad_packed(bix.packed, w_pad)
            hx = self._pad_blocked(bix.hor, w_pad)
            # padding rebuilt per-band tensors; re-share the DocTable and
            # the (identical-content) vocabulary tensor across bands
            hx = dataclasses.replace(hx, docs=p.docs,
                                     sorted_hash=p.sorted_hash)
            ix = layouts.BandedCsrIndex(packed=p, hor=hx)
        elif layout == "packed":
            ix = self._pad_packed(layouts.build_packed_csr(
                host, route_tile=route_tile, device=self._device), w_pad)
        else:
            ix = self._pad_blocked(layouts.build_blocked(
                host, route_tile=route_tile, device=self._device), w_pad)
        doc_offsets = np.zeros(span + 1, np.int64)
        np.cumsum(np.bincount(doc_of.astype(np.int64), minlength=span),
                  out=doc_offsets[1:])
        return Segment(index=ix, doc_base=int(base), doc_span=int(span),
                       doc_of=doc_of.astype(np.int32),
                       terms=terms.astype(np.int32),
                       tfs=tfs.astype(np.float32),
                       doc_offsets=doc_offsets, n_postings=len(terms),
                       size_class=int(d_pad), num_terms=n_terms_seg,
                       chooser_reason=reason, band_cut=cut)

    @staticmethod
    def _pad_blocked(ix: layouts.BlockedIndex, w_pad: int):
        mpl_q = layouts.size_class(ix.max_posting_len)
        return layouts.pad_blocked_to_class(
            ix, nb_pad=layouts.size_class(int(ix.block_docs.shape[0])),
            w_pad=w_pad, max_posting_len=mpl_q,
            max_blocks_per_term=mpl_q // layouts.BLOCK,
            route_pairs_max=layouts.size_class(ix.route_pairs_max),
            route_span_max=layouts.size_class(ix.route_span_max, base=8))

    @staticmethod
    def _pad_packed(ix: layouts.PackedCsrIndex, w_pad: int):
        # the word dim pads to the next multiple of 8 words, not to a
        # geometric class: it is streamed on every routed block
        return layouts.pad_packed_to_class(
            ix, nb_pad=layouts.size_class(int(ix.packed.shape[0])),
            w_pad=w_pad,
            max_posting_len=layouts.size_class(ix.max_posting_len),
            words_per_block=-(-ix.words_per_block // 8) * 8,
            route_pairs_max=layouts.size_class(ix.route_pairs_max),
            route_span_max=layouts.size_class(ix.route_span_max, base=8))

    def compact(self, all_segments: bool = False) -> bool:
        """Merge a policy-picked run of adjacent segments into one,
        dropping tombstoned postings (their ids stay dead).
        ``all_segments=True`` merges the whole stack.  Returns True if a
        merge happened."""
        n = len(self._segments)
        if all_segments:
            pick = (0, n) if n >= 1 else None
        else:
            pick = self._policy.pick([s.n_postings for s in self._segments])
        if pick is None:
            return False
        t0 = time.perf_counter()
        lo, hi = pick
        segs = self._segments[lo:hi]
        base = segs[0].doc_base
        span = segs[-1].doc_base + segs[-1].doc_span - base
        parts_d, parts_t, parts_f = [], [], []
        touched = 0
        for s in segs:
            touched += s.n_postings
            if s.n_postings == 0:
                continue
            live = self._live[s.doc_of.astype(np.int64) + s.doc_base]
            parts_d.append(s.doc_of[live].astype(np.int64)
                           + (s.doc_base - base))
            parts_t.append(s.terms[live].astype(np.int64))
            parts_f.append(s.tfs[live])
        if parts_d:
            doc_of = np.concatenate(parts_d)
            terms = np.concatenate(parts_t)
            tfs = np.concatenate(parts_f)
            order = np.lexsort((terms, doc_of))      # doc-major canonical
            doc_of, terms, tfs = doc_of[order], terms[order], tfs[order]
        else:
            doc_of = np.zeros(0, np.int64)
            terms = np.zeros(0, np.int64)
            tfs = np.zeros(0, np.float32)
        seg = self._build_segment(base, span, doc_of, terms, tfs)
        self._segments[lo:hi] = [seg]
        self.stats.postings_compacted += touched
        self.stats.compactions += 1
        self._bump_epoch()
        self.events.emit(
            "compact", epoch=self._epoch, merged=hi - lo,
            doc_base=seg.doc_base, docs=seg.doc_span,
            postings_in=touched, postings_out=seg.n_postings,
            size_class=seg.size_class, layout=seg.layout,
            band_cut=seg.band_cut, chooser_reason=seg.chooser_reason,
            duration_us=(time.perf_counter() - t0) * 1e6)
        return True

    def _maybe_compact(self) -> None:
        while self.compact():
            pass

    def pick_layout_rewrite(self) -> int | None:
        """Position of the oldest sealed segment whose layout disagrees
        with the installed ``layout_policy`` (None when no policy or
        converged)."""
        if self._layout_policy is None:
            return None
        current = [s.layout for s in self._segments]
        wanted = [self._layout_policy.choose(
            s.stats, size_class=s.size_class,
            device_type=self._device.type).layout
            for s in self._segments]
        return compaction.pick_layout_rewrite(current, wanted)

    def rewrite_segment(self, i: int) -> None:
        """Re-seal segment ``i`` in place through the layout ladder,
        dropping its tombstoned postings; doc ids, norms and scores are
        unchanged."""
        seg = self._segments[i]
        t0 = time.perf_counter()
        live = self._live[seg.doc_of.astype(np.int64) + seg.doc_base]
        doc_of = seg.doc_of[live].astype(np.int64)
        terms = seg.terms[live].astype(np.int64)
        tfs = seg.tfs[live]
        new = self._build_segment(seg.doc_base, seg.doc_span, doc_of,
                                  terms, tfs)
        self._segments[i] = new
        self.stats.postings_compacted += seg.n_postings
        self.stats.layout_rewrites += 1
        self._bump_epoch()
        self.events.emit(
            "rewrite", epoch=self._epoch, position=i,
            doc_base=new.doc_base, docs=new.doc_span,
            from_layout=seg.layout, layout=new.layout,
            postings_in=seg.n_postings, postings_out=new.n_postings,
            size_class=new.size_class, band_cut=new.band_cut,
            chooser_reason=new.chooser_reason,
            duration_us=(time.perf_counter() - t0) * 1e6)

    # -- norms / doc metadata ----------------------------------------------

    def _refresh_norms(self) -> None:
        """Recompute every live doc's tf-idf norm with the CURRENT live
        df and doc count: the bulk builder's float64 bincount, so norms
        are bit-equal to a rebuild.  Dead docs get norm 0; live empty
        docs 1e-12."""
        n_alloc = self.num_docs
        w = len(self._df)
        idf64 = (np.log1p(self._live_docs /
                          np.maximum(self._df, 1).astype(np.float64))
                 if w else np.zeros(0))
        norm_sq = np.zeros(n_alloc, np.float64)
        touched = 0
        for seg in self._segments:
            if seg.n_postings == 0:
                continue
            wv = seg.tfs * idf64[seg.terms.astype(np.int64)]
            norm_sq += np.bincount(
                seg.doc_of.astype(np.int64) + seg.doc_base,
                weights=wv * wv, minlength=n_alloc)
            touched += seg.n_postings
        dl = self._delta
        if dl.n_postings:
            wv = (dl.tfs[:dl.n_postings]
                  * idf64[dl.terms[:dl.n_postings].astype(np.int64)])
            norm_sq += np.bincount(
                dl.doc_of[:dl.n_postings].astype(np.int64) + dl.doc_base,
                weights=wv * wv, minlength=n_alloc)
            touched += dl.n_postings
        norm = np.sqrt(norm_sq).astype(np.float32)
        norm[norm == 0] = 1e-12
        norm[~self._live] = 0.0
        self._norm = norm
        self.stats.postings_norm_refreshed += touched
        for seg in self._segments:
            self._push_doc_meta(seg)
        self._delta_dirty = True

    def _push_doc_meta(self, seg: Segment) -> None:
        d_pad = seg.index.docs.num_docs
        norm_pad = np.zeros(d_pad, np.float32)
        norm_pad[:seg.doc_span] = self._norm[
            seg.doc_base:seg.doc_base + seg.doc_span]
        docs = DocTable(norm=torch.from_numpy(norm_pad).to(self._device),
                        rank=seg.index.docs.rank)
        if isinstance(seg.index, layouts.BandedCsrIndex):
            # one DocTable object, shared by both bands (as at build)
            seg.index = layouts.BandedCsrIndex(
                packed=dataclasses.replace(seg.index.packed, docs=docs),
                hor=dataclasses.replace(seg.index.hor, docs=docs))
        else:
            seg.index = dataclasses.replace(seg.index, docs=docs)

    def _delta_device(self) -> dict:
        """Device mirror of the delta's filled prefix (rebuilt, never
        mutated, on change)."""
        if self._delta_dev is None or self._delta_dirty:
            dl = self._delta
            n_p, n_d = dl.n_postings, dl.n_docs
            lo, hi = dl.doc_base, dl.doc_base + n_d

            def dev(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    self._device)
            self._delta_dev = {
                "terms": dev(dl.terms[:n_p]), "tfs": dev(dl.tfs[:n_p]),
                "doc_of": dev(dl.doc_of[:n_p]),
                "norm": dev(self._norm[lo:hi]),
                "rank": dev(self._rank[lo:hi]),
            }
            self._delta_dirty = False
        return self._delta_dev

    # -- queries ------------------------------------------------------------

    def topk(self, query_hashes, k: int, *, cap: int | None = None,
             rank_blend: float = 0.0, engine: str = "fused",
             mode: str = "candidates", return_stats: bool = False,
             tune=None, trace=None):
        """Batched top-k over delta + every sealed segment, evaluated
        against the current epoch's view (see ``LiveView.topk``);
        ``tune`` overrides the active tuning table for every segment."""
        return self.view().topk(query_hashes, k, cap=cap,
                                rank_blend=rank_blend, engine=engine,
                                mode=mode, return_stats=return_stats,
                                tune=tune, trace=trace)

    def conjunctive(self, query_hashes, k: int, cap: int):
        """AND semantics over the whole live index for ONE query [T];
        ``stats["truncated_terms"]`` sums every segment's truncation."""
        return self.view().conjunctive(query_hashes, k, cap)

    # -- import / export ----------------------------------------------------

    @classmethod
    def from_host(cls, host: PostingsHost, **kwargs) -> "SegmentedIndex":
        """Seed a live index from bulk-built postings: one sealed segment
        over [0, num_docs), the host's vocabulary and static ranks, norms
        recomputed (identically) from live df."""
        si = cls(term_hashes=host.term_hashes, **kwargs)
        if host.num_docs == 0:
            return si
        si._live = np.ones(host.num_docs, bool)
        si._rank = host.rank.astype(np.float32).copy()
        si._norm = np.zeros(host.num_docs, np.float32)
        si._df = host.df.astype(np.int64).copy()
        si._live_docs = host.num_docs
        term_of = np.repeat(np.arange(host.num_terms, dtype=np.int64),
                            np.diff(host.offsets))
        doc = host.doc_ids.astype(np.int64)
        order = np.lexsort((term_of, doc))           # doc-major canonical
        seg = si._build_segment(0, host.num_docs, doc[order],
                                term_of[order],
                                host.tfs[order].astype(np.float32))
        si._segments.append(seg)
        si.stats.postings_sealed += seg.n_postings
        si.stats.seals += 1
        si._delta = _Delta(si._delta.doc_cap, si._delta.post_cap,
                           host.num_docs)
        si._refresh_norms()
        si._bump_epoch()
        si.events.emit(
            "seal", epoch=si._epoch, doc_base=0, docs=seg.doc_span,
            postings=seg.n_postings, size_class=seg.size_class,
            layout=seg.layout, band_cut=seg.band_cut,
            chooser_reason=seg.chooser_reason, via="from_host")
        return si

    def _live_triples(self):
        parts_d, parts_t, parts_f = [], [], []
        for seg in self._segments:
            if seg.n_postings == 0:
                continue
            gdoc = seg.doc_of.astype(np.int64) + seg.doc_base
            live = self._live[gdoc]
            parts_d.append(gdoc[live])
            parts_t.append(seg.terms[live].astype(np.int64))
            parts_f.append(seg.tfs[live])
        dl = self._delta
        if dl.n_postings:
            gdoc = dl.doc_of[:dl.n_postings].astype(np.int64) + dl.doc_base
            live = self._live[gdoc]
            parts_d.append(gdoc[live])
            parts_t.append(dl.terms[:dl.n_postings][live].astype(np.int64))
            parts_f.append(dl.tfs[:dl.n_postings][live])
        if not parts_d:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.float32))
        return (np.concatenate(parts_d), np.concatenate(parts_t),
                np.concatenate(parts_f))

    def to_host(self) -> PostingsHost:
        """Export merged live postings as bulk output.  Dead ids export
        as deleted (norm 0) empty docs, and the norms use the allocated
        id count as D; ``export_live_corpus`` gives the exact live-corpus
        reference."""
        gdoc, terms, tfs = self._live_triples()
        host = build_mod._postings_from_triples(
            gdoc, terms, tfs.astype(np.float64), len(self._hashes),
            self.num_docs, self._hashes)
        if not self._live.all():
            norm = host.norm.copy()
            norm[~self._live] = 0.0
            host = dataclasses.replace(host, norm=norm)
        return host

    def export_live_corpus(self):
        """The equivalent live corpus over the unified vocabulary, plus
        the ascending global ids of its docs."""
        return self.view().export_live_corpus()
