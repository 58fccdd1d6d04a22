"""Engine layer of the fused query path: the port of the candidate
engine in ``repro.kernels.ops``.

``fused_batched_topk`` routes a whole query batch through ONE candidate
kernel launch (``fused_decode_score.fused_topk_{blocked,packed}``): the
batch's posting blocks are deduplicated into tile-sorted routing pairs,
each read once, scored against a ``[Q, tile]`` accumulator and reduced
to per-tile candidates, so only O(B * n_tiles * k_tile) candidates
reach device memory.  The index's device decides the implementation:
a CUDA index launches the CUDA kernels, a CPU index runs their plain
versions.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.layouts import BlockedIndex, PackedCsrIndex
from repro_torch.kernels.fused_decode_score import (
    Q_PAD, TILE, build_batched_pairs, default_k_tile, fused_topk_blocked,
    fused_topk_blocked_plain, fused_topk_packed, fused_topk_packed_plain)

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


def default_max_pairs(index: BlockedIndex | PackedCsrIndex, num_queries: int,
                      num_terms: int, cap: int, tile: int = TILE) -> int:
    """Routing-pair budget for a batch: bounded both by the whole
    index's span sum (``route_pairs_max``) and by candidate-count x
    worst single-block span.  Both bounds are exact at the route tile,
    so overflow is impossible at the default tile."""
    m = max(-(-min(cap, max(index.max_posting_len, 1)) // index.block), 1)
    cands = num_queries * num_terms * m
    span = index.route_span_max
    pairs_max = index.route_pairs_max
    if tile != index.route_tile:
        scale = max(-(-index.route_tile // tile), 1)
        nb = (index.packed.shape[0] if isinstance(index, PackedCsrIndex)
              else index.block_docs.shape[0])
        span = span * scale + 1
        pairs_max = pairs_max * scale + nb
    return max(min(pairs_max, cands * max(span, 1)), 8)


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


def fused_topk_args(index: BlockedIndex | PackedCsrIndex, term_ids: Tensor,
                    idf_w: Tensor, cap: int, k: int, rank_blend: float = 0.0,
                    max_pairs: int | None = None, tile: int = TILE,
                    k_tile: int | None = None, q_pad: int = Q_PAD,
                    pairs_per_step: int = 1):
    """One batch's routing pairs and metadata, as the arguments of the
    layout's candidate kernel: returns (kernel, plain, args, kwargs,
    overflow) so that ``kernel(*args, **kwargs)`` (or its plain version
    ``plain(*args, **kwargs)``) computes the candidates; ``overflow`` (a
    0-d tensor) counts routing pairs dropped for want of ``max_pairs``.

    term_ids i32[B, T] (-1 absent), idf_w f32[B, T] per-slot weights;
    ``cap`` bounds postings read per term at posting granularity.
    """
    b, t = term_ids.shape
    num_docs = index.docs.num_docs
    if k_tile is None:
        k_tile = default_k_tile(k, tile)
    k_tile = min(k_tile, tile)
    # per-query norm of the idf weight vector (duplicate slots carry 0
    # after dedup) — the same reduction the oracle's scoring tail does
    qnorm = torch.sqrt(torch.clamp_min((idf_w * idf_w).sum(dim=1), 1e-12))

    block = index.block
    m = max(-(-min(cap, max(index.max_posting_len, 1)) // block), 1)
    if isinstance(index, BlockedIndex):
        m = min(m, max(index.max_blocks_per_term, 1))
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
    bp = -(-b // max(q_pad, 1)) * max(q_pad, 1)
    if bp != b:
        pqw = torch.nn.functional.pad(pqw, (0, bp - b))
        qnorm = torch.nn.functional.pad(qnorm, (0, bp - b), value=1.0)

    kwargs = {"rank_blend": rank_blend, "tile": tile}
    docs = index.docs
    if isinstance(index, PackedCsrIndex):
        pbl = pb.long()
        args = (index.packed, index.block_tfs, pb, pt, pqw, pcap,
                index.block_bits[pbl], index.block_base[pbl],
                index.block_count[pbl], docs.norm, docs.rank, qnorm,
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
                       pairs_per_step: int = 1):
    """The candidate path: per-tile partial top-k inside the fused
    kernel, so the dense [B, num_docs] score array never exists.

    Returns (cand_values f32[B, n_tiles*k_tile],
    cand_ids i32[B, n_tiles*k_tile], overflow 0-d tensor); arguments as
    ``fused_topk_args``.
    """
    kernel, _, args, kwargs, overflow = fused_topk_args(
        index, term_ids, idf_w, cap, k, rank_blend=rank_blend,
        max_pairs=max_pairs, tile=tile, k_tile=k_tile, q_pad=q_pad,
        pairs_per_step=pairs_per_step)
    vals, ids = kernel(*args, **kwargs, reducer=reducer)
    b = term_ids.shape[0]
    return vals[:b], ids[:b], overflow
