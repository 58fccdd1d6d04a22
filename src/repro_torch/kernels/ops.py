"""Engine layer of the fused query path: the port of the fused
engines and the per-segment engines of ``repro.kernels.ops``.

``fused_batched_topk`` routes a whole query batch through ONE candidate
kernel launch (``fused_decode_score.fused_topk_{blocked,packed}``): the
batch's posting blocks are deduplicated into tile-sorted routing pairs,
each read once, scored against a ``[Q, tile]`` accumulator and reduced
to per-tile candidates, so only O(B * n_tiles * k_tile) candidates
reach device memory.  ``fused_batched_scores`` is the dense engine
(``fused_score_{blocked,packed}``): the same routing, f32 [B, num_docs]
scores out.  The index's device decides the implementation: a CUDA
index launches the CUDA kernels, a CPU index runs their plain versions.

The per-segment engines of the live index (``fused_segment_topk``,
``fused_segment_dense_topk``, ``fused_segment_banded_topk`` and the
gather oracles ``torch_segment_topk`` / ``torch_segment_conjunctive``)
return per-tile candidate lists of FINAL scores with GLOBAL doc ids
(segment-local ids shifted by ``doc_base``), merged on the host by
``distributed.topk.merge_topk_candidates_host``.  They score with the
GLOBAL idf weights the live index computes, so a multi-segment ranking
matches a rebuild.  They are plain functions: eager PyTorch compiles
nothing, so the reference's jit-cache keying has no counterpart.

Two side paths of the paper run their own kernels:
``blocked_query_scores`` scores ONE query over a HOR index through the
posting scorer (``posting_score``), and ``unpack_postings`` decodes every
block of a packed index (``packed_postings.unpack_blocks``).

The model kernels have one entry point each, with the reference's
argument order and layouts: ``embedding_bag`` (fixed-arity multi-hot bag
sums), ``pna_multi_agg`` (PNA's mean | min | max | std) and ``attention``
(flash attention, ``[B, H, S, D]``).  There is no ``backend`` argument:
a CUDA tensor launches the kernel, a CPU tensor runs its plain version.
Each carries gradients through a ``torch.autograd.Function`` whose
forward is that kernel or plain version and whose backward is one code
path in torch ops on both devices (``attention_backward``,
``embedding_bag_backward``, ``pna_multi_agg_backward``): the gradient of
the reference's jnp counterpart, as ``jax.grad`` takes it.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.layouts import (BandedCsrIndex, BlockedIndex,
                                      PackedCsrIndex, take_rows)
from repro_torch.core.query import (accumulate_scores, conjunctive_scores,
                                    final_scores, query_norm)
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import segment_multi_agg as _pna
from repro_torch.kernels.flash_attention import (attention_backward,
                                                 flash_attention)
from repro_torch.kernels.packed_postings import unpack_blocks
from repro_torch.kernels.posting_score import build_pairs, posting_score
from repro_torch.kernels.fused_decode_score import (
    Q_PAD, TILE, build_batched_pairs, default_k_tile, extract_tile_candidates,
    fused_score_blocked, fused_score_blocked_plain, fused_score_packed,
    fused_score_packed_plain, fused_topk_blocked, fused_topk_blocked_plain,
    fused_topk_packed, fused_topk_packed_plain)

Tensor = torch.Tensor


def warn_on_overflow(overflow: int, label: str) -> None:
    """Routing overflow is surfaced, never silent: a Python warning and
    the process-global ``engine_pair_overflow`` counter (the caller
    also returns it as a stat)."""
    overflow = int(overflow)
    if overflow > 0:
        from repro_torch.obs.registry import GLOBAL
        GLOBAL.counter("engine_pair_overflow").inc(overflow)
        warnings.warn(f"{label}: routing overflow dropped {overflow} "
                      "(block, tile) pairs — raise max_pairs",
                      RuntimeWarning, stacklevel=2)


def record_truncated(truncated: int) -> None:
    """Count conjunctive cap-truncation into the process-global
    ``engine_truncated_terms`` counter (callers also return it as a
    stat)."""
    if truncated > 0:
        from repro_torch.obs.registry import GLOBAL
        GLOBAL.counter("engine_truncated_terms").inc(int(truncated))


def routing_spans(index: BlockedIndex | PackedCsrIndex, tile: int):
    """(tile_first, tile_count, n_tiles) for ``tile``-wide doc tiles.

    Uses the index's build-time pair-routing cache when ``tile`` matches
    its ``route_tile``; otherwise derives spans from the per-block
    min/max summaries.
    """
    num_docs = index.docs.num_docs
    n_tiles = max(-(-num_docs // tile), 1)
    if tile == index.route_tile and index.tile_first is not None:
        return index.tile_first, index.tile_count, n_tiles
    has = index.block_max >= 0
    t0 = torch.clamp(torch.div(index.block_min, tile, rounding_mode="floor"),
                     0, n_tiles - 1)
    t1 = torch.clamp(torch.div(index.block_max, tile, rounding_mode="floor"),
                     0, n_tiles - 1)
    return (torch.where(has, t0, 0).to(torch.int32),
            torch.where(has, t1 - t0 + 1, 0).to(torch.int32), n_tiles)


def select_query_blocks(index: BlockedIndex, term_ids: Tensor,
                        idf_w: Tensor, max_blocks_per_term: int):
    """One query's selected blocks: (global block ids i32, validity,
    per-block weight f32), each [T * max_blocks_per_term], term-major."""
    safe = term_ids.clamp_min(0).long()
    start = index.block_offsets[safe]
    nb = index.block_offsets[safe + 1] - start
    k = torch.arange(max_blocks_per_term, dtype=torch.int32,
                     device=term_ids.device)
    valid = (k[None, :] < nb[:, None]) & (term_ids >= 0)[:, None]
    sel = torch.where(valid, start[:, None] + k[None, :], 0)
    w = idf_w[:, None].expand(sel.shape)
    return (sel.reshape(-1).to(torch.int32), valid.reshape(-1),
            w.reshape(-1).float())


def blocked_query_scores(index: BlockedIndex, term_ids: Tensor,
                         idf_w: Tensor, max_blocks_per_term: int,
                         max_pairs: int, tile: int = TILE):
    """Dense per-doc scores f32[num_docs] of ONE query (term ids i32[T],
    -1 absent; idf weights f32[T]) through the posting scorer, and the
    routing overflow (a 0-d tensor; warned and counted when nonzero, so
    an undersized ``max_pairs`` is never silent)."""
    sel, valid, w = select_query_blocks(index, term_ids, idf_w,
                                        max_blocks_per_term)
    tfirst, tcount, n_tiles = routing_spans(index, tile)
    pb, pt, pw, overflow = build_pairs(sel, valid, w, tfirst, tcount,
                                       n_tiles, max_pairs)
    warn_on_overflow(int(overflow), "blocked_query_scores")
    return posting_score(index.block_docs, index.block_tfs, pb, pt, pw,
                         index.docs.num_docs, tile), overflow


def unpack_postings(index: PackedCsrIndex) -> Tensor:
    """Decode ALL blocks of a PackedCsrIndex -> doc ids i32[NB, block]."""
    return unpack_blocks(index.packed, index.block_bits, index.block_base,
                         index.block_count, index.block)


def kernel_ready(t: Tensor) -> Tensor:
    """``t`` as the CUDA kernels take it: a CUDA tensor that is not
    contiguous, or does not start on a 16-byte boundary, becomes a fresh
    contiguous copy (its allocation is aligned); anything else is
    returned as it is.  The model entry points pass every input through
    it, so that a view the reference takes is taken here too, while the
    kernel wrappers keep refusing such tensors when called directly."""
    if t.is_cuda and (not t.is_contiguous() or t.data_ptr() % 16):
        return t.clone(memory_format=torch.contiguous_format)
    return t


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, indices, mode):
        ctx.save_for_backward(indices)
        ctx.rows, ctx.mode = table.shape[0], mode
        return _bag.embedding_bag(table, indices, mode)

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        return (_bag.embedding_bag_backward(g, indices, ctx.rows, ctx.mode),
                None, None)


class _PnaMultiAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, nbr, eps):
        ctx.save_for_backward(feats, nbr)
        ctx.eps = eps
        return _pna.pna_multi_agg(feats, nbr, eps)

    @staticmethod
    def backward(ctx, g):
        feats, nbr = ctx.saved_tensors
        return _pna.pna_multi_agg_backward(feats, nbr, g, ctx.eps), None, None


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, do, ctx.causal, ctx.window),
                None, None)


def embedding_bag(table: Tensor, indices: Tensor, mode: str = "sum"
                  ) -> Tensor:
    """Bag sums (or means, ``mode="mean"``): table f32 or bf16 [V, D],
    indices i32[B, H] (-1 = padding) -> [B, D] in the table's dtype
    (``embedding_bag``), from any view of either; differentiable in the
    table."""
    return _EmbeddingBag.apply(kernel_ready(table), kernel_ready(indices),
                               mode)


def pna_multi_agg(feats: Tensor, nbr: Tensor, eps: float = _pna.EPS
                  ) -> Tensor:
    """PNA's mean | min | max | std: feats f32[Nsrc, D], nbr i32[N, K]
    (-1 = padding) -> f32[N, 4D] (``pna_multi_agg``), ``eps`` under
    std's square root, from any view of either; differentiable in
    feats."""
    return _PnaMultiAgg.apply(kernel_ready(feats), kernel_ready(nbr), eps)


def attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
              window: int = 0) -> Tensor:
    """q [B, Hq, S, D], k/v [B, Hkv, S, D] -> [B, Hq, S, D] in q's
    dtype; causal and/or a sliding ``window``, GQA; from any view of
    q, k and v; differentiable in all three."""
    return _Attention.apply(kernel_ready(q), kernel_ready(k),
                            kernel_ready(v), causal, int(window))


def default_max_pairs(index: BlockedIndex | PackedCsrIndex, num_queries: int,
                      num_terms: int, cap: int, tile: int = TILE) -> int:
    """Routing-pair budget for a batch: bounded both by the whole
    index's span sum (``route_pairs_max``) and by candidate-count x
    worst single-block span.  Both bounds are exact at the route tile,
    so overflow is impossible at the default tile."""
    m = max(-(-min(cap, max(index.max_posting_len, 1)) // index.block), 1)
    cands = num_queries * num_terms * m
    span = index.route_span_max
    if tile != index.route_tile:
        span = span * _tile_scale(index, tile) + 1
    return max(min(scaled_pairs_budget(index, tile), cands * max(span, 1)),
               8)


def _tile_scale(index: BlockedIndex | PackedCsrIndex, tile: int) -> int:
    """Tiles of width ``tile`` one route tile's span may split into."""
    return max(-(-index.route_tile // tile), 1)


def scaled_pairs_budget(index: BlockedIndex | PackedCsrIndex,
                        tile: int = TILE) -> int:
    """Whole-index routing-pair bound at an arbitrary tile width:
    ``route_pairs_max`` at the route tile; narrower tiles split each
    block's span into at most ``ceil(route_tile/tile)`` tiles, and the
    +NB term covers straddles either way."""
    if tile == index.route_tile:
        return int(index.route_pairs_max)
    nb = (index.packed.shape[0] if isinstance(index, PackedCsrIndex)
          else index.block_docs.shape[0])
    return max(int(index.route_pairs_max) * _tile_scale(index, tile)
               + int(nb), 8)


def round_up_pairs(max_pairs: int, pairs_per_step: int) -> int:
    """Pair budgets must be a multiple of the kernel's unroll factor."""
    pps = max(int(pairs_per_step), 1)
    return -(-int(max_pairs) // pps) * pps


def widen_pairs_for_step(max_pairs: int, num_docs: int, tile: int,
                         pairs_per_step: int) -> int:
    """Widen a pair budget for run-aligned no-op padding (up to
    ``pps - 1`` per visited tile), then round up."""
    pps = max(int(pairs_per_step), 1)
    if pps > 1:
        n_tiles = max(-(-int(num_docs) // max(int(tile), 1)), 1)
        max_pairs = int(max_pairs) + n_tiles * (pps - 1)
    return round_up_pairs(max_pairs, pps)


def padded_pairs_budget(index: BlockedIndex | PackedCsrIndex,
                        tile: int = TILE, pairs_per_step: int = 1) -> int:
    """``scaled_pairs_budget`` widened for run-aligned padding and
    rounded to the unroll quantum: the budget the per-segment query
    paths use."""
    return widen_pairs_for_step(
        scaled_pairs_budget(index, tile), index.docs.num_docs, tile,
        pairs_per_step)


def expand_block_candidates(block_offsets: Tensor, term_ids: Tensor,
                            idf_w: Tensor, m: int, block: int,
                            cap: int | None = None):
    """Flat candidate (query, term, block) triples for a term batch.

    term_ids i32[B, T] (-1 absent), idf_w f32[B, T].  Returns
    (cand_block, cand_valid, cand_q, cand_w, cand_cap) flattened to
    [B*T*m]; cand_cap is None when ``cap`` is None (read whole blocks).
    """
    b, t = term_ids.shape
    dev = term_ids.device
    safe = term_ids.clamp_min(0).long()
    start = block_offsets[safe]
    nb = block_offsets[safe + 1] - start
    k = torch.arange(m, dtype=torch.int32, device=dev)
    cand_block = (start[..., None] + k).reshape(-1)
    cand_valid = ((k < torch.clamp_max(nb, m)[..., None])
                  & (term_ids >= 0)[..., None]).reshape(-1)
    cand_q = torch.arange(b, dtype=torch.int32, device=dev)[:, None, None] \
        .expand(b, t, m).reshape(-1)
    cand_w = idf_w[..., None].expand(b, t, m).reshape(-1)
    cand_cap = None
    if cap is not None:
        # lanes of the k-th block the posting cap still permits — a cap
        # cutting mid-block truncates the last block, like the oracle
        cand_cap = torch.clamp(cap - k * block, 0, block)[None, None, :] \
            .expand(b, t, m).reshape(-1)
    return cand_block, cand_valid, cand_q, cand_w, cand_cap


def _fanout(index: BlockedIndex | PackedCsrIndex, cap: int) -> int:
    """Posting blocks one term may contribute under ``cap``."""
    m = max(-(-min(cap, max(index.max_posting_len, 1)) // index.block), 1)
    if isinstance(index, BlockedIndex):
        m = min(m, max(index.max_blocks_per_term, 1))
    return m


def _decode_scalars(index: PackedCsrIndex, pb: Tensor):
    """Per-pair (bits, base, count) of the routed packed blocks."""
    pbl = pb.long()
    return tuple(take_rows(t, pbl) for t in (index.block_bits,
                                             index.block_base,
                                             index.block_count))


def _pad_queries(pqw: Tensor, b: int, q_pad: int) -> Tensor:
    """Pad the weight rows' query axis to the accumulator quantum."""
    bp = -(-b // max(q_pad, 1)) * max(q_pad, 1)
    return torch.nn.functional.pad(pqw, (0, bp - b)) if bp != b else pqw


def fused_score_args(index: BlockedIndex | PackedCsrIndex, term_ids: Tensor,
                     idf_w: Tensor, cap: int, max_pairs: int | None = None,
                     tile: int = TILE, q_pad: int = Q_PAD):
    """One batch's routing pairs as the arguments of the layout's dense
    kernel: returns (kernel, plain, args, kwargs, overflow) so that
    ``kernel(*args, **kwargs)`` (or ``plain(...)``) computes the
    f32 [Q, num_docs] scores; arguments as ``fused_topk_args``."""
    b, t = term_ids.shape
    num_docs = index.docs.num_docs
    if max_pairs is None:
        max_pairs = default_max_pairs(index, b, t, cap, tile)
    cand_block, cand_valid, cand_q, cand_w, cand_cap = \
        expand_block_candidates(index.block_offsets, term_ids, idf_w,
                                _fanout(index, cap), index.block, cap)
    tfirst, tcount, n_tiles = routing_spans(index, tile)
    pb, pt, pqw, pcap, overflow = build_batched_pairs(
        cand_block, cand_valid, cand_q, cand_w.float(), tfirst, tcount,
        n_tiles, b, max_pairs, cand_cap=cand_cap)
    pqw = _pad_queries(pqw, b, q_pad)
    kwargs = {"tile": tile}
    if isinstance(index, PackedCsrIndex):
        args = (index.packed, index.block_tfs, pb, pt, pqw, pcap,
                *_decode_scalars(index, pb), num_docs, index.block)
        return (fused_score_packed, fused_score_packed_plain, args, kwargs,
                overflow)
    args = (index.block_docs, index.block_tfs, pb, pt, pqw, pcap, num_docs)
    return fused_score_blocked, fused_score_blocked_plain, args, kwargs, \
        overflow


def fused_batched_scores(index: BlockedIndex | PackedCsrIndex,
                         term_ids: Tensor, idf_w: Tensor, cap: int,
                         max_pairs: int | None = None, tile: int = TILE,
                         q_pad: int = Q_PAD):
    """Dense scores f32[B, num_docs] for a batch of queries in one dense
    kernel launch, plus the routing-overflow count (a 0-d tensor).
    term_ids i32[B, T] (-1 absent), idf_w f32[B, T]; ``cap`` bounds the
    postings read per term at posting granularity."""
    kernel, _, args, kwargs, overflow = fused_score_args(
        index, term_ids, idf_w, cap, max_pairs=max_pairs, tile=tile,
        q_pad=q_pad)
    return kernel(*args, **kwargs)[:term_ids.shape[0]], overflow


def fused_topk_args(index: BlockedIndex | PackedCsrIndex, term_ids: Tensor,
                    idf_w: Tensor, cap: int, k: int, rank_blend: float = 0.0,
                    max_pairs: int | None = None, tile: int = TILE,
                    k_tile: int | None = None, q_pad: int = Q_PAD,
                    pairs_per_step: int = 1, qnorm: Tensor | None = None):
    """One batch's routing pairs and metadata, as the arguments of the
    layout's candidate kernel: returns (kernel, plain, args, kwargs,
    overflow) so that ``kernel(*args, **kwargs)`` (or its plain version
    ``plain(*args, **kwargs)``) computes the candidates; ``overflow`` (a
    0-d tensor) counts routing pairs dropped for want of ``max_pairs``.

    term_ids i32[B, T] (-1 absent), idf_w f32[B, T] per-slot weights;
    ``cap`` bounds postings read per term at posting granularity;
    ``qnorm`` f32[B], ``query_norm(idf_w)``, is computed when not given.
    """
    b, t = term_ids.shape
    num_docs = index.docs.num_docs
    if k_tile is None:
        k_tile = default_k_tile(k, tile)
    k_tile = min(k_tile, tile)
    # per-query norm of the idf weight vector (duplicate slots carry 0
    # after dedup) — the same reduction the oracle's scoring tail does
    if qnorm is None:
        qnorm = query_norm(idf_w)

    block = index.block
    m = _fanout(index, cap)
    if max_pairs is None:
        max_pairs = widen_pairs_for_step(
            default_max_pairs(index, b, t, cap, tile), num_docs, tile,
            pairs_per_step)
    max_pairs = round_up_pairs(max_pairs, pairs_per_step)

    cand_block, cand_valid, cand_q, cand_w, cand_cap = \
        expand_block_candidates(index.block_offsets, term_ids, idf_w,
                                m, block, cap)
    tfirst, tcount, n_tiles = routing_spans(index, tile)
    pb, pt, pqw, pcap, overflow = build_batched_pairs(
        cand_block, cand_valid, cand_q, cand_w.float(), tfirst, tcount,
        n_tiles, b, max_pairs, cand_cap=cand_cap,
        pairs_per_step=pairs_per_step)

    # pad the query batch to the accumulator quantum (padding queries
    # get qnorm 1.0 — their zero accumulator masks them to -inf anyway)
    pqw = _pad_queries(pqw, b, q_pad)
    qnorm = torch.nn.functional.pad(qnorm, (0, pqw.shape[1] - b), value=1.0)

    kwargs = {"rank_blend": rank_blend, "tile": tile}
    docs = index.docs
    if isinstance(index, PackedCsrIndex):
        args = (index.packed, index.block_tfs, pb, pt, pqw, pcap,
                *_decode_scalars(index, pb), docs.norm, docs.rank, qnorm,
                num_docs, block, k_tile)
        return (fused_topk_packed, fused_topk_packed_plain, args, kwargs,
                overflow)
    args = (index.block_docs, index.block_tfs, pb, pt, pqw, pcap, docs.norm,
            docs.rank, qnorm, num_docs, k_tile)
    return fused_topk_blocked, fused_topk_blocked_plain, args, kwargs, overflow


def fused_batched_topk(index: BlockedIndex | PackedCsrIndex,
                       term_ids: Tensor, idf_w: Tensor, cap: int, k: int,
                       rank_blend: float = 0.0,
                       max_pairs: int | None = None, tile: int = TILE,
                       k_tile: int | None = None, q_pad: int = Q_PAD,
                       reducer: str = "successive",
                       pairs_per_step: int = 1, qnorm: Tensor | None = None):
    """The candidate path: per-tile partial top-k inside the fused
    kernel, so the dense [B, num_docs] score array never exists.

    Returns (cand_values f32[B, n_tiles*k_tile],
    cand_ids i32[B, n_tiles*k_tile], overflow 0-d tensor); arguments as
    ``fused_topk_args``.
    """
    kernel, _, args, kwargs, overflow = fused_topk_args(
        index, term_ids, idf_w, cap, k, rank_blend=rank_blend,
        max_pairs=max_pairs, tile=tile, k_tile=k_tile, q_pad=q_pad,
        pairs_per_step=pairs_per_step, qnorm=qnorm)
    vals, ids = kernel(*args, **kwargs, reducer=reducer)
    b = term_ids.shape[0]
    return vals[:b], ids[:b], overflow


# ---------------------------------------------------------------------------
# per-segment engines of the segmented live index (core/live_index.py)
# ---------------------------------------------------------------------------


def _segment_terms(index, query_hashes: Tensor) -> Tensor:
    """Dedup'd query hashes -> this segment's term ids (-1 absent)."""
    return torch.where(query_hashes != 0, index.lookup_terms(query_hashes),
                       -1)


def _global_ids(ids: Tensor, doc_base: int) -> Tensor:
    return torch.where(ids >= 0, ids + int(doc_base), -1)


def _tile_candidates(index, scores: Tensor, idf_w: Tensor, doc_base: int,
                     k_tile: int, rank_blend: float, tile: int,
                     qnorm: Tensor | None):
    """Scoring tail + per-tile candidates of dense accumulated scores;
    ``qnorm`` is ``query_norm(idf_w)``, computed when None."""
    if qnorm is None:
        qnorm = query_norm(idf_w)
    final = final_scores(scores, index.docs.norm, index.docs.rank, qnorm,
                         rank_blend)
    vals, ids = extract_tile_candidates(final, tile, k_tile)
    return vals, _global_ids(ids, doc_base)


def fused_segment_topk(index: BlockedIndex | PackedCsrIndex,
                       query_hashes: Tensor, idf_w: Tensor, doc_base: int, *,
                       k_tile: int, cap: int, max_pairs: int,
                       rank_blend: float = 0.0, tile: int = TILE,
                       q_pad: int = Q_PAD, reducer: str = "successive",
                       pairs_per_step: int = 1, qnorm: Tensor | None = None):
    """Candidate engine over one HOR or packed segment: the candidate
    kernel with in-kernel per-tile top-k (tombstones ride in as norm 0).
    query_hashes i32[B, T] dedup'd hash bit-views, idf_w f32[B, T]
    global weights, qnorm f32[B] their norms (computed when None: the
    live index passes the batch's once for every segment).  Returns
    (vals, global ids, overflow)."""
    vals, ids, overflow = fused_batched_topk(
        index, _segment_terms(index, query_hashes), idf_w, cap, k=k_tile,
        rank_blend=rank_blend, max_pairs=max_pairs, tile=tile,
        k_tile=k_tile, q_pad=q_pad, reducer=reducer,
        pairs_per_step=pairs_per_step, qnorm=qnorm)
    return vals, _global_ids(ids, doc_base), overflow


def fused_segment_dense_topk(index: BlockedIndex | PackedCsrIndex,
                             query_hashes: Tensor, idf_w: Tensor,
                             doc_base: int, *, k_tile: int, cap: int,
                             max_pairs: int, rank_blend: float = 0.0,
                             tile: int = TILE, q_pad: int = Q_PAD,
                             qnorm: Tensor | None = None):
    """Dense engine over one segment: the dense kernel's score rows,
    then the scoring tail and the per-tile candidate reduction (qnorm as
    ``fused_segment_topk``)."""
    scores, overflow = fused_batched_scores(
        index, _segment_terms(index, query_hashes), idf_w, cap,
        max_pairs=max_pairs, tile=tile, q_pad=q_pad)
    vals, gids = _tile_candidates(index, scores, idf_w, doc_base, k_tile,
                                  rank_blend, tile, qnorm)
    return vals, gids, overflow


def banded_pairs_budgets(index: BandedCsrIndex, tile: int = TILE,
                         pairs_per_step: int = 1) -> tuple[int, int]:
    """Per-band pair budgets of a banded segment (each band is its own
    launch with its own pair buffer), floored at 8 for an empty band."""
    return (max(padded_pairs_budget(index.packed, tile, pairs_per_step), 8),
            max(padded_pairs_budget(index.hor, tile, pairs_per_step), 8))


def fused_segment_banded_topk(index: BandedCsrIndex, query_hashes: Tensor,
                              idf_w: Tensor, doc_base: int, *, k_tile: int,
                              cap_packed: int, cap_hor: int,
                              max_pairs_packed: int, max_pairs_hor: int,
                              rank_blend: float = 0.0, tile: int = TILE,
                              q_pad: int = Q_PAD,
                              qnorm: Tensor | None = None):
    """Engine over one banded segment: one dense launch per band (packed
    band, then HOR tail), the partials summed as ``acc_p + acc_h`` — the
    reference's order, so the sum is bit-equal to it — then the scoring
    tail and the per-tile candidates.  A term lives in one band, so a
    doc whose terms all sit in one band gets an exact 0.0 from the
    other.  qnorm as ``fused_segment_topk``."""
    tids = _segment_terms(index.packed, query_hashes)
    acc_p, ov_p = fused_batched_scores(
        index.packed, tids, idf_w, cap_packed, max_pairs=max_pairs_packed,
        tile=tile, q_pad=q_pad)
    acc_h, ov_h = fused_batched_scores(
        index.hor, tids, idf_w, cap_hor, max_pairs=max_pairs_hor,
        tile=tile, q_pad=q_pad)
    vals, gids = _tile_candidates(index, acc_p + acc_h, idf_w, doc_base,
                                  k_tile, rank_blend, tile, qnorm)
    return vals, gids, ov_p + ov_h


def torch_segment_topk(index, query_hashes: Tensor, idf_w: Tensor,
                       doc_base: int, *, k_tile: int, cap: int,
                       rank_blend: float = 0.0, tile: int = TILE,
                       qnorm: Tensor | None = None):
    """Gather oracle over one segment (``jnp_segment_topk``'s
    counterpart): gather + slot-major scatter-add, reduced to the same
    per-tile candidate lists as the fused engines (qnorm as
    ``fused_segment_topk``)."""
    tids = _segment_terms(index, query_hashes)
    d, tf, valid = index.gather_postings(tids, cap)
    scores = accumulate_scores(d, tf * idf_w[..., None], valid,
                               index.docs.num_docs)
    vals, gids = _tile_candidates(index, scores, idf_w, doc_base, k_tile,
                                  rank_blend, tile, qnorm)
    return vals, gids, 0


def torch_segment_conjunctive(index, query_hashes: Tensor, idf_w: Tensor,
                              needed: int, doc_base: int, *, k_tile: int,
                              cap: int, tile: int = TILE):
    """AND-semantics counts + scores over one segment for ONE query
    (query_hashes i32[T]; ``jnp_segment_conjunctive``'s counterpart).
    Returns (vals, global ids, truncated_terms): the terms whose LOCAL
    posting list exceeds ``cap``, which the live index sums over its
    segments."""
    final, truncated = conjunctive_scores(
        index, _segment_terms(index, query_hashes), idf_w, needed, cap)
    vals, ids = extract_tile_candidates(final[None], tile, k_tile)
    return vals[0], _global_ids(ids[0], doc_base), truncated
