"""The least work one call of a fused scoring kernel needs, counted from
the queries' terms and the index's posting layout.

A frozen copy of the arithmetic of ``chip_smoke.kernel_work`` and
``dense_work`` (bytes and operations one call must move and do at
least), with the counts taken from the layout instead of from a
launch's routing arguments: a term's posting blocks are its range of
``block_offsets``, and a block's doc tiles the span its routing cache
(``tile_first``/``tile_count`` at the route tile, else its doc range)
gives.  Each distinct block is read once, each routed (block, tile)
pair's row once, the norm and rank of each visited tile once, the query
norms once, and each candidate (or dense score) written once.  A later
change to how the program routes cannot move this count.

``layout`` is a dict of host arrays of one posting index (or one band of
a banded segment): ``kind`` ("hor" or "packed"), ``block_offsets``
[W+1], ``tile_first`` and ``tile_count`` [NB] at ``route_tile``,
``block_min``/``block_max`` [NB], ``num_docs``, ``block`` (postings a
block), and ``block_bytes`` / ``pair_extra`` (bytes a block and bytes a
routed pair carry beyond its ids and weights).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from portbench.yardstick import peaks

# the geometry the work is priced at: doc tiles of 512, 16 candidates a
# tile for k = 10, query rows padded to a multiple of 8
TILE = 512
K_TILE = 16
Q_PAD = 8


def padded_q(q: int) -> int:
    return -(-int(q) // Q_PAD) * Q_PAD


@dataclasses.dataclass
class Work:
    bytes: float = 0.0
    ops: float = 0.0

    def __iadd__(self, other: "Work") -> "Work":
        self.bytes += other.bytes
        self.ops += other.ops
        return self

    def least_s(self) -> float:
        """The least time this work takes on the card: its bytes at the
        memory's rate or its f32 operations at the CUDA cores' rate,
        whichever is longer."""
        return max(self.bytes / peaks.HBM_BW, self.ops / peaks.PEAK_FLOPS_F32)


def hor_layout(block_offsets, tile_first, tile_count, block_min, block_max,
               num_docs, route_tile, lanes, block=128) -> dict:
    """An HOR band: a block holds ``lanes`` i32 doc ids and f32 tfs."""
    return dict(kind="hor", block_offsets=np.asarray(block_offsets, np.int64),
                tile_first=tile_first, tile_count=tile_count,
                block_min=block_min, block_max=block_max,
                num_docs=int(num_docs), route_tile=int(route_tile),
                block=int(block), block_bytes=lanes * 4 + lanes * 4,
                pair_extra=0)


def packed_layout(block_offsets, tile_first, tile_count, block_min,
                  block_max, num_docs, route_tile, words_per_block, lanes,
                  block=128) -> dict:
    """A packed band: a block holds ``words_per_block`` u32 words of
    packed deltas and ``lanes`` f16 tfs; a routed pair carries its
    block's bit width, base and count (12 bytes)."""
    return dict(kind="packed",
                block_offsets=np.asarray(block_offsets, np.int64),
                tile_first=tile_first, tile_count=tile_count,
                block_min=block_min, block_max=block_max,
                num_docs=int(num_docs), route_tile=int(route_tile),
                block=int(block),
                block_bytes=words_per_block * 4 + lanes * 2, pair_extra=12)


def routed(layout: dict, term_ids, tile: int):
    """(distinct blocks, routed pairs, visited tiles) of the distinct
    ``term_ids`` (this layout's ids; negative ids are absent)."""
    off = layout["block_offsets"]
    terms = np.unique(np.asarray(term_ids, np.int64))
    terms = terms[(terms >= 0) & (terms < len(off) - 1)]
    starts, ends = off[terms], off[terms + 1]
    n = int((ends - starts).sum())
    if n == 0:
        return 0, 0, 0
    blocks = np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)])
    n_tiles = max(-(-layout["num_docs"] // tile), 1)
    if tile == layout["route_tile"] and layout["tile_first"] is not None:
        first = np.asarray(layout["tile_first"])[blocks].astype(np.int64)
        count = np.asarray(layout["tile_count"])[blocks].astype(np.int64)
    else:
        lo = np.asarray(layout["block_min"])[blocks].astype(np.int64)
        hi = np.asarray(layout["block_max"])[blocks].astype(np.int64)
        has = hi >= 0
        t0 = np.clip(lo // tile, 0, n_tiles - 1)
        t1 = np.clip(hi // tile, 0, n_tiles - 1)
        first = np.where(has, t0, 0)
        count = np.where(has, t1 - t0 + 1, 0)
    pairs = int(count.sum())
    edge = (np.bincount(first, minlength=n_tiles + 1)
            - np.bincount(first + count, minlength=n_tiles + 1))
    tiles = int((np.cumsum(edge)[:n_tiles] > 0).sum())
    return n, pairs, tiles


def candidate_call(layout: dict, term_ids, tile: int, k_tile: int, q: int,
                   q_real: int) -> Work:
    """One candidate-kernel call (``fused_topk_*``) over ``q`` query rows
    of which ``q_real`` are real: blocks, pair rows (ids, cap and ``q``
    weights), visited tiles' norm and rank, ``q`` query norms, and
    ``q x n_tiles x k_tile`` candidates (value and id) written; per
    posting lane ``q_real`` multiply-adds, per (query, doc) of a visited
    tile the 5-operation scoring tail and ``k_tile`` compares."""
    blocks, pairs, tiles = routed(layout, term_ids, tile)
    n_tiles = -(-layout["num_docs"] // tile)
    pair_bytes = 4 + 4 + 4 + 4 * q + layout["pair_extra"]
    nbytes = (blocks * layout["block_bytes"] + pairs * pair_bytes
              + tiles * tile * 8 + q * 4 + q * n_tiles * k_tile * 8)
    ops = (blocks * layout["block"] * 2 * q_real
           + q_real * tiles * tile * (5 + k_tile))
    return Work(float(nbytes), float(ops))


def dense_call(layout: dict, term_ids, tile: int, q: int,
               q_real: int) -> Work:
    """One dense-kernel call (``fused_score_*``): blocks, pair rows, and
    the ``q x num_docs`` f32 scores written; per posting lane of a
    routed pair ``q_real`` multiply-adds."""
    blocks, pairs, _ = routed(layout, term_ids, tile)
    pair_bytes = 4 + 4 + 4 + 4 * q + layout["pair_extra"]
    nbytes = (blocks * layout["block_bytes"] + pairs * pair_bytes
              + q * layout["num_docs"] * 4)
    ops = pairs * layout["block"] * 2 * q_real
    return Work(float(nbytes), float(ops))


def roofline_pct(work: Work, device_s: float) -> float | None:
    """The least time of ``work`` as a share (%) of the device time its
    calls took; None when nothing was timed."""
    if device_s <= 0 or work.bytes <= 0:
        return None
    return 100.0 * work.least_s() / device_s
