"""Single-query posting scorer: the port of ``repro.kernels.posting_score``.

The paper's query-evaluation hot path streams posting lists and adds
per-document scores.  Over a ``BlockedIndex`` (HOR: 128-lane blocks with
per-block doc-id min/max), ``build_pairs`` expands a query's selected
blocks into (block, tile, weight) routing pairs sorted by doc tile, and
the scorer adds ``tf * weight`` of each pair's lanes that fall in its
tile into an f32 [num_docs] score vector; tiles no pair visits are 0.

Two implementations of the scorer live here:

* ``posting_score``'s CUDA C++ kernel (``csrc/posting_score.cu``), which a
  CUDA tensor always goes to; there is no fallback;
* ``posting_score_plain``, its plain PyTorch version, the path for CPU
  tensors and the kernel's yardstick on the card.  Round ``r`` adds pair
  ``r`` of every tile's run at once (tiles own disjoint docs and a
  block's doc ids are unique, so no add collides), each lane's
  ``tf * w`` rounded before the add, as the Pallas kernel computes it.

``posting_score.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.segments import run_ranks, take_rows
from repro_torch.kernels.cuda_build import check_tensors, launch
from repro_torch.kernels.fused_decode_score import check_smem, tile_starts

Tensor = torch.Tensor

TILE = 512  # doc-space tile width


def build_pairs(sel_blocks: Tensor, sel_valid: Tensor, sel_w: Tensor,
                tile_first: Tensor, tile_count: Tensor, n_tiles: int,
                max_pairs: int):
    """Expand a query's selected blocks into tile-sorted routing pairs.

    sel_blocks i32[S] global block ids of the query's terms, sel_valid
    bool[S], sel_w f32[S] each block's term weight (idf).  tile_first /
    tile_count i32[NB] are the index's build-time routing cache (block ->
    doc-tile span; ``ops.routing_spans``).  Returns (pair_block,
    pair_tile, pair_w) [max_pairs], sorted by tile (stable), and the
    overflow (a 0-d tensor): the real pairs that did not fit, counted
    exactly.  Padding pairs are tile ``n_tiles`` with block 0 and weight
    0.  Equal to the reference's arrays.
    """
    dev = sel_blocks.device
    s = sel_blocks.shape[0]
    safe = sel_blocks.clamp_min(0).long()
    t0 = take_rows(tile_first, safe).long()
    span = torch.where(sel_valid, take_rows(tile_count, safe), 0).long()
    offs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(span, 0)])
    total = offs[-1]
    p = torch.arange(max_pairs, dtype=torch.int64, device=dev)
    owner = (torch.searchsorted(offs, p, right=True) - 1).clamp(
        0, max(s - 1, 0))
    real = p < total
    tile_id = take_rows(t0, owner) + (p - offs[owner])
    pair_block = torch.where(real, take_rows(safe, owner), 0)
    pair_tile = torch.where(real, tile_id, n_tiles)
    pair_w = torch.where(real, take_rows(sel_w, owner), 0.0)
    order = torch.argsort(pair_tile, stable=True)
    overflow = (total - max_pairs).clamp_min(0)
    return (pair_block[order].to(torch.int32),
            pair_tile[order].to(torch.int32),
            pair_w[order].to(torch.float32), overflow)


def posting_score_plain(block_docs: Tensor, block_tfs: Tensor,
                        pair_block: Tensor, pair_tile: Tensor,
                        pair_w: Tensor, num_docs: int,
                        tile: int = TILE) -> Tensor:
    """Plain PyTorch version of the posting scorer: f32[num_docs]."""
    n_tiles = -(-num_docs // tile)
    dev = block_docs.device
    acc = torch.zeros((n_tiles + 1) * tile, dtype=torch.float32, device=dev)
    end = torch.tensor([n_tiles], dtype=pair_tile.dtype, device=dev)
    n_real = int(torch.searchsorted(pair_tile, end))
    if n_real == 0:
        return acc[:num_docs]
    pt = pair_tile[:n_real].long()
    pb = pair_block[:n_real].long()
    docs = block_docs[pb].long()
    w = block_tfs[pb] * pair_w[:n_real, None]
    local = docs - pt[:, None] * tile
    inb = (docs >= 0) & (local >= 0) & (local < tile)
    rnd = run_ranks(pt)
    for r in range(int(rnd.max()) + 1):
        sel = torch.nonzero(rnd == r).squeeze(1)
        ok = inb[sel]
        rows = docs[sel][ok]
        acc[rows] = acc[rows] + w[sel][ok]
    return acc[:num_docs]


_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature (csrc/posting_score.cu): docs, tfs, block, pair_block,
# pair_w, tile_start, out, n_tiles, num_docs, tile, stream
_ARGTYPES = [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P]


def _launch_posting_score_cuda(block_docs, block_tfs, pair_block, pair_tile,
                               pair_w, num_docs: int, tile: int) -> Tensor:
    """Check every tensor the kernel reads, then launch it."""
    name = "posting_score"
    check_smem(name, 1, tile)
    nb, block = block_docs.shape[0], block_docs.shape[-1]
    np_ = pair_block.shape[0]
    check_tensors(name, block_docs=(block_docs, torch.int32, (nb, block)),
                  block_tfs=(block_tfs, torch.float32, (nb, block)),
                  pair_block=(pair_block, torch.int32, (np_,)),
                  pair_tile=(pair_tile, torch.int32, (np_,)),
                  pair_w=(pair_w, torch.float32, (np_,)))
    n_tiles = -(-num_docs // tile)
    out = torch.empty(num_docs, dtype=torch.float32,
                      device=block_docs.device)
    if n_tiles == 0:
        return out
    launch(name, _ARGTYPES, (block_docs, block_tfs, block, pair_block,
                             pair_w, tile_starts(pair_tile, n_tiles), out,
                             n_tiles, num_docs, tile), block_docs.device)
    return out


def posting_score(block_docs: Tensor, block_tfs: Tensor, pair_block: Tensor,
                  pair_tile: Tensor, pair_w: Tensor, num_docs: int,
                  tile: int = TILE) -> Tensor:
    """Dense scores of one query (replaces ``posting_score_pallas``).

    block_docs i32[NB, B] (-1 padding), block_tfs f32[NB, B]: the index's
    posting blocks, read in place.  pair_* [NP]: (block, tile, weight)
    routing pairs sorted by tile, padding pairs at tile ``n_tiles`` with
    weight 0 (``build_pairs``).  Returns f32[num_docs], 0.0 in tiles no
    pair visits.  CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if not block_docs.is_cuda:
        return posting_score_plain(block_docs, block_tfs, pair_block,
                                   pair_tile, pair_w, num_docs, tile)
    out = _launch_posting_score_cuda(block_docs, block_tfs, pair_block,
                                     pair_tile, pair_w, num_docs, tile)
    posting_score.launches += 1
    return out


posting_score.launches = 0
