"""Fused batched decode-and-score: the port of
``repro.kernels.fused_decode_score``, its candidate kernels and its dense
kernels.

The engine walks tile-sorted, batch-deduplicated routing pairs
``(block, tile)``: each pair reads ONE posting block (raw HOR ids and
f32 tfs, or delta+bit-packed u32 words and f16 tfs decoded on the fly),
adds ``qw[q] * tf`` into a ``[Q, tile]`` accumulator, and on the tile's
last pair applies the scoring tail (``core.query.final_scores``) and
emits ``k_tile`` (value, global doc id) candidates per query (value
descending, lowest id on ties, id -1 where not finite).  Tiles no pair
visits come out as (-inf, -1).  A pure ``merge_topk_candidates`` over
the tile-major lists then equals the dense oracle's top-k.  The dense
kernels (``fused_score_{blocked,packed}``) stop at the accumulator and
return f32 [Q, num_docs] scores, 0.0 in tiles no pair visits (the
reference's ``_finish``).

Two implementations of each kernel live here:

* the CUDA C++ kernel (``csrc/fused_{topk,score}_{blocked,packed}.cu``),
  which a CUDA tensor always goes to — there is no fallback;
* its plain PyTorch version (``fused_{topk,score}_{blocked,packed}
  _plain``), the path for CPU tensors and the kernel's yardstick on the
  card.  It adds the pairs in the kernel's order without colliding
  atomics: round ``r``
  updates pair ``r`` of every tile's run at once (tiles own disjoint
  docs and a block's doc ids are unique), with the same fused
  multiply-adds (``core.query.fma_f32``), so both agree to the bit.

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.layouts import take_rows, unpack_words
from repro_torch.core.segments import run_ranks
from repro_torch.core.query import final_scores, fma_f32
from repro_torch.kernels.cuda_build import check_tensors, launch

Tensor = torch.Tensor

TILE = 512   # doc-space tile width
Q_PAD = 8    # query-batch padding quantum
K_PAD = 8    # candidate-count padding quantum (per-tile k_tile)
BLOCK = 128  # posting block width == CUDA threads per CTA
REDUCERS = ("successive", "bitonic")
NEG_INF = float("-inf")


def default_k_tile(k: int, tile: int = TILE, k_pad: int = K_PAD) -> int:
    """Per-tile candidate count: >= min(k, tile) (exactness floor),
    rounded up to the ``k_pad`` quantum, never wider than the tile."""
    k_pad = max(int(k_pad), 1)
    return min(tile, max(k_pad, -(-max(k, 1) // k_pad) * k_pad))


def _check_k_tile(k_tile: int, tile: int) -> None:
    """Reject geometry the per-tile reduction cannot satisfy."""
    if k_tile > tile:
        raise ValueError(
            f"k_tile={k_tile} > tile={tile}: a {tile}-wide doc tile "
            f"cannot emit {k_tile} candidates — clamp with "
            "default_k_tile(k, tile)")
    if k_tile < 1:
        raise ValueError(f"k_tile must be >= 1, got {k_tile}")


def _check_reducer(reducer: str, cuda: bool) -> None:
    """Both reducers define the same strict order (value descending,
    lowest lane first), so the plain path computes either; the CUDA
    kernel implements successive maxima only."""
    if reducer not in REDUCERS:
        raise ValueError(f"unknown reducer {reducer!r}; expected {REDUCERS}")
    if cuda and reducer != "successive":
        raise NotImplementedError(
            f"reducer={reducer!r} has no CUDA kernel yet (ROADMAP queue 2, "
            "item 4: the bitonic tile reducer); use reducer='successive'")


def _doc_tiles(norm: Tensor, rank: Tensor, n_tiles: int, tile: int):
    """Pad per-doc metadata to the tile grid (+ a zero trash tile for
    padding pairs; norm 0 there marks every lane deleted)."""
    pad = (n_tiles + 1) * tile - norm.shape[0]
    nt = torch.nn.functional.pad(norm.float(), (0, pad))
    rt = torch.nn.functional.pad(rank.float(), (0, pad))
    return nt.view(n_tiles + 1, tile), rt.view(n_tiles + 1, tile)


def _tile_topk(final: Tensor, base: Tensor, k_tile: int, tile: int):
    """``k_tile`` successive maxima of each ``tile``-wide row of
    ``final`` [..., tile]; ``base`` [...] is the global id of lane 0.

    Tie-break: lowest lane first (the ``jax.lax.top_k`` order the
    candidate merge relies on).  Non-finite maxima get id -1.  Returns
    (values, ids) [..., k_tile]."""
    work = final.clone()
    lane = torch.arange(tile, device=final.device, dtype=torch.int32)
    vals, ids = [], []
    for _ in range(k_tile):
        m = work.max(dim=-1).values
        am = torch.where(work == m[..., None], lane, tile).min(dim=-1).values
        ids.append(torch.where(torch.isfinite(m), base + am, -1))
        vals.append(m)
        work.scatter_(-1, am[..., None].long().clamp_max(tile - 1), NEG_INF)
    return torch.stack(vals, -1), torch.stack(ids, -1).to(torch.int32)


def _finish_candidates(vals: Tensor, ids: Tensor, pair_tile: Tensor,
                       n_tiles: int, k_tile: int):
    """Mask never-visited tiles to (-inf, -1) and flatten the per-tile
    lists [n_tiles+1, Q, k_tile] tile-major to [Q, n_tiles * k_tile]."""
    visited = torch.zeros(n_tiles + 1, dtype=torch.bool, device=vals.device)
    visited[pair_tile.long()] = True
    vals = torch.where(visited[:, None, None], vals, NEG_INF)
    ids = torch.where(visited[:, None, None], ids, -1)
    q = vals.shape[1]
    return (vals[:n_tiles].permute(1, 0, 2).reshape(q, n_tiles * k_tile),
            ids[:n_tiles].permute(1, 0, 2).reshape(q, n_tiles * k_tile))


def extract_tile_candidates(final: Tensor, tile: int, k_tile: int):
    """Per-tile candidates of a dense FINAL score array f32[B, num_docs]
    (-inf = not a hit), by a stable descending sort of each tile: the
    same tile-major (values, ids) lists as the kernels."""
    b, nd = final.shape
    n_tiles = max(-(-nd // tile), 1)
    f = torch.nn.functional.pad(final, (0, n_tiles * tile - nd),
                                value=NEG_INF).view(b, n_tiles, tile)
    v, idx = torch.sort(f, dim=-1, descending=True, stable=True)
    v, idx = v[..., :k_tile], idx[..., :k_tile]
    base = torch.arange(n_tiles, device=final.device)[None, :, None] * tile
    gids = torch.where(torch.isfinite(v), idx + base, -1).to(torch.int32)
    return v.reshape(b, n_tiles * k_tile), gids.reshape(b, n_tiles * k_tile)


# ---------------------------------------------------------------------------
# plain PyTorch versions of the candidate kernels
# ---------------------------------------------------------------------------


def _real_pairs(pair_tile: Tensor, n_tiles: int) -> int:
    """Pairs routed to the trash tile (id ``n_tiles``) sort last and add
    only zero weights to lanes no candidate reads: the plain versions
    load and add the first ``_real_pairs`` pairs only."""
    end = torch.tensor([n_tiles], dtype=pair_tile.dtype,
                       device=pair_tile.device)
    return int(torch.searchsorted(pair_tile, end))


def _accumulate_pairs(docs: Tensor, tfs: Tensor, pair_tile: Tensor,
                      pair_qw: Tensor, pair_cap: Tensor, n_tiles: int,
                      tile: int) -> Tensor:
    """acc f32[n_tiles+1, Q, tile]: each pair's lanes that fall in its
    tile and below its cap add ``qw[q] * tf`` (one FMA), in pair order.
    ``docs`` and ``tfs`` [n, 128] are the loaded blocks of the first
    ``n`` pairs (``_real_pairs``).  Round ``r`` updates the r-th pair of
    every tile's run at once: no two of its doc slots collide, so the
    sums stay in pair order."""
    q = pair_qw.shape[1]
    n_real = docs.shape[0]
    dev = docs.device
    acc = torch.zeros((n_tiles + 1) * tile, q, dtype=torch.float32,
                      device=dev)
    if n_real == 0:
        return acc.view(n_tiles + 1, tile, q).permute(0, 2, 1)
    pt = pair_tile[:n_real].long()
    docs, tfs = docs.long(), tfs.float()
    qw, cap = pair_qw[:n_real], pair_cap[:n_real]
    rnd = run_ranks(pt)
    lane = torch.arange(docs.shape[1], device=dev)
    local = docs - pt[:, None] * tile
    inb = ((docs >= 0) & (local >= 0) & (local < tile)
           & (lane[None, :] < cap[:, None]))
    for r in range(int(rnd.max()) + 1):
        sel = torch.nonzero(rnd == r).squeeze(1)
        ok = inb[sel]
        rows = docs[sel][ok]
        qw_r = qw[sel][:, None, :].expand(-1, ok.shape[1], -1)[ok]
        acc[rows] = fma_f32(qw_r, tfs[sel][ok][:, None], acc[rows])
    return acc.view(n_tiles + 1, tile, q).permute(0, 2, 1)


def _candidates_from_acc(acc: Tensor, pair_tile: Tensor, norm: Tensor,
                         rank: Tensor, qnorm: Tensor, n_tiles: int,
                         tile: int, k_tile: int, rank_blend: float):
    """Scoring tail + successive-maxima reduction of every tile."""
    q = acc.shape[1]
    norm_t, rank_t = _doc_tiles(norm, rank, n_tiles, tile)
    dense = acc.permute(1, 0, 2).reshape(q, (n_tiles + 1) * tile)
    final = final_scores(dense, norm_t.reshape(-1), rank_t.reshape(-1),
                         qnorm, rank_blend).view(q, n_tiles + 1, tile)
    base = (torch.arange(n_tiles + 1, device=acc.device,
                         dtype=torch.int32) * tile)[None, :]
    vals, ids = _tile_topk(final, base.expand(q, -1), k_tile, tile)
    return _finish_candidates(vals.permute(1, 0, 2), ids.permute(1, 0, 2),
                              pair_tile, n_tiles, k_tile)


def _blocked_acc(block_docs, block_tfs, pair_block, pair_tile, pair_qw,
                 pair_cap, n_tiles: int, tile: int) -> Tensor:
    """The accumulator of HOR blocks: the routed blocks read in place."""
    pb = pair_block[:_real_pairs(pair_tile, n_tiles)].long()
    return _accumulate_pairs(block_docs[pb], block_tfs[pb], pair_tile,
                             pair_qw, pair_cap, n_tiles, tile)


def _packed_acc(packed, block_tfs, pair_block, pair_tile, pair_qw, pair_cap,
                pair_bits, pair_base, pair_count, block: int, n_tiles: int,
                tile: int) -> Tensor:
    """The accumulator of packed blocks: the routed blocks decoded
    (``core.layouts.unpack_words``), then as HOR."""
    n_real = _real_pairs(pair_tile, n_tiles)
    pb = pair_block[:n_real].long()
    docs = unpack_words(packed[pb], pair_bits[:n_real], pair_base[:n_real],
                        pair_count[:n_real], block)
    return _accumulate_pairs(docs, block_tfs[pb], pair_tile, pair_qw,
                             pair_cap, n_tiles, tile)


def _dense_from_acc(acc: Tensor, num_docs: int) -> Tensor:
    """[n_tiles+1, Q, tile] accumulator -> f32[Q, num_docs]: the pad tile
    is dropped, and tiles no pair visited hold 0.0 (``_finish``)."""
    q = acc.shape[1]
    return acc[:-1].permute(1, 0, 2).reshape(q, -1)[:, :num_docs].contiguous()


def _n_tiles(num_docs: int, tile: int) -> int:
    return max(-(-num_docs // tile), 1)


def fused_topk_blocked_plain(block_docs, block_tfs, pair_block, pair_tile,
                             pair_qw, pair_cap, norm, rank, qnorm,
                             num_docs: int, k_tile: int,
                             rank_blend: float = 0.0, tile: int = TILE):
    """Plain PyTorch version of the HOR candidate kernel."""
    n_tiles = _n_tiles(num_docs, tile)
    acc = _blocked_acc(block_docs, block_tfs, pair_block, pair_tile,
                       pair_qw, pair_cap, n_tiles, tile)
    return _candidates_from_acc(acc, pair_tile, norm, rank, qnorm, n_tiles,
                                tile, k_tile, rank_blend)


def fused_topk_packed_plain(packed, block_tfs, pair_block, pair_tile,
                            pair_qw, pair_cap, pair_bits, pair_base,
                            pair_count, norm, rank, qnorm, num_docs: int,
                            block: int, k_tile: int,
                            rank_blend: float = 0.0, tile: int = TILE):
    """Plain PyTorch version of the packed candidate kernel."""
    n_tiles = _n_tiles(num_docs, tile)
    acc = _packed_acc(packed, block_tfs, pair_block, pair_tile, pair_qw,
                      pair_cap, pair_bits, pair_base, pair_count, block,
                      n_tiles, tile)
    return _candidates_from_acc(acc, pair_tile, norm, rank, qnorm, n_tiles,
                                tile, k_tile, rank_blend)


def fused_score_blocked_plain(block_docs, block_tfs, pair_block, pair_tile,
                              pair_qw, pair_cap, num_docs: int,
                              tile: int = TILE):
    """Plain PyTorch version of the HOR dense kernel."""
    acc = _blocked_acc(block_docs, block_tfs, pair_block, pair_tile,
                       pair_qw, pair_cap, _n_tiles(num_docs, tile), tile)
    return _dense_from_acc(acc, num_docs)


def fused_score_packed_plain(packed, block_tfs, pair_block, pair_tile,
                             pair_qw, pair_cap, pair_bits, pair_base,
                             pair_count, num_docs: int, block: int,
                             tile: int = TILE):
    """Plain PyTorch version of the packed dense kernel."""
    acc = _packed_acc(packed, block_tfs, pair_block, pair_tile, pair_qw,
                      pair_cap, pair_bits, pair_base, pair_count, block,
                      _n_tiles(num_docs, tile), tile)
    return _dense_from_acc(acc, num_docs)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures (csrc/fused_topk_{blocked,packed}.cu): layout-specific
# block pointers, then pair_cap, pair_qw, [packed: bits, base, count,
# wpb], tile_start, norm, rank, qnorm, out_vals, out_ids, n_tiles,
# num_docs, q, tile, k_tile, rank_blend, stream
# csrc/fused_score_{blocked,packed}.cu take the same head, then
# tile_start, out, n_tiles, num_docs, q, tile, stream
_TAIL = [_P] * 6 + [_I] * 5 + [_F, _P]
_DENSE_TAIL = [_P] * 2 + [_I] * 4 + [_P]
_ARGTYPES = {
    "fused_topk_blocked": [_P] * 3 + [_P, _P] + _TAIL,
    "fused_topk_packed": [_P] * 3 + [_P, _P] + [_P] * 3 + [_I] + _TAIL,
    "fused_score_blocked": [_P] * 3 + [_P, _P] + _DENSE_TAIL,
    "fused_score_packed": [_P] * 3 + [_P, _P] + [_P] * 3 + [_I]
    + _DENSE_TAIL,
}


def tile_starts(pair_tile: Tensor, n_tiles: int) -> Tensor:
    """CTA t walks pairs [tile_start[t], tile_start[t+1])."""
    bounds = torch.arange(n_tiles + 1, dtype=torch.int32,
                          device=pair_tile.device)
    return torch.searchsorted(pair_tile, bounds).to(torch.int32)


def check_smem(name: str, q: int, tile: int) -> None:
    if q * tile * 4 > 227 * 1024:
        raise ValueError(f"{name}: Q={q} x tile={tile} f32 accumulator "
                         "exceeds a CTA's 227 KB of shared memory")


def _launch(name, blocks, pair_tile, pair_qw, pair_cap, decode, norm, rank,
            qnorm, num_docs, tile, k_tile, rank_blend):
    """Allocate the candidate outputs and launch kernel ``name``;
    ``blocks`` / ``decode`` are its layout-specific tensors and ints."""
    q = pair_qw.shape[1]
    n_tiles = _n_tiles(num_docs, tile)
    check_smem(name, q, tile)
    vals = torch.empty((q, n_tiles * k_tile), dtype=torch.float32,
                       device=pair_qw.device)
    ids = torch.empty((q, n_tiles * k_tile), dtype=torch.int32,
                      device=pair_qw.device)
    tile_start = tile_starts(pair_tile, n_tiles)
    launch(name, _ARGTYPES[name],
           (*blocks, pair_cap, pair_qw, *decode, tile_start, norm, rank,
            qnorm, vals, ids, n_tiles, num_docs, q, tile, k_tile,
            rank_blend), pair_qw.device)
    return vals, ids


def _launch_dense(name, blocks, pair_tile, pair_qw, pair_cap, decode,
                  num_docs, tile):
    """Allocate f32[Q, num_docs] and launch dense kernel ``name``: every
    element is written (zeros in unvisited tiles)."""
    q = pair_qw.shape[1]
    n_tiles = _n_tiles(num_docs, tile)
    check_smem(name, q, tile)
    out = torch.empty((q, num_docs), dtype=torch.float32,
                      device=pair_qw.device)
    tile_start = tile_starts(pair_tile, n_tiles)
    launch(name, _ARGTYPES[name],
           (*blocks, pair_cap, pair_qw, *decode, tile_start, out, n_tiles,
            num_docs, q, tile), pair_qw.device)
    return out


def _pair_checks(pair_block, pair_tile, pair_qw, pair_cap):
    """Shape/dtype specs of the arrays every launcher takes."""
    i32, f32 = torch.int32, torch.float32
    np_, q = pair_qw.shape
    return dict(pair_block=(pair_block, i32, (np_,)),
                pair_tile=(pair_tile, i32, (np_,)),
                pair_qw=(pair_qw, f32, (np_, q)),
                pair_cap=(pair_cap, i32, (np_,)))


def _launch_blocked_cuda(block_docs, block_tfs, pair_block, pair_tile,
                         pair_qw, pair_cap, norm, rank, qnorm, num_docs,
                         k_tile, rank_blend, tile):
    name = "fused_topk_blocked"
    i32, f32 = torch.int32, torch.float32
    nb, q = block_docs.shape[0], pair_qw.shape[1]
    check_tensors(name, block_docs=(block_docs, i32, (nb, BLOCK)),
                  block_tfs=(block_tfs, f32, (nb, BLOCK)),
                  **_pair_checks(pair_block, pair_tile, pair_qw, pair_cap),
                  norm=(norm, f32, (num_docs,)), rank=(rank, f32, (num_docs,)),
                  qnorm=(qnorm, f32, (q,)))
    return _launch(name, (block_docs, block_tfs, pair_block), pair_tile,
                   pair_qw, pair_cap, (), norm, rank, qnorm, num_docs, tile,
                   k_tile, rank_blend)


def _launch_packed_cuda(packed, block_tfs, pair_block, pair_tile, pair_qw,
                        pair_cap, pair_bits, pair_base, pair_count, norm,
                        rank, qnorm, num_docs, k_tile, rank_blend, tile):
    name = "fused_topk_packed"
    i32, f32 = torch.int32, torch.float32
    (nb, wpb), (np_, q) = packed.shape, pair_qw.shape
    check_tensors(name, packed=(packed, i32, (nb, max(wpb, 1))),
                  block_tfs=(block_tfs, torch.float16, (nb, BLOCK)),
                  **_pair_checks(pair_block, pair_tile, pair_qw, pair_cap),
                  pair_bits=(pair_bits, i32, (np_,)),
                  pair_base=(pair_base, i32, (np_,)),
                  pair_count=(pair_count, i32, (np_,)),
                  norm=(norm, f32, (num_docs,)), rank=(rank, f32, (num_docs,)),
                  qnorm=(qnorm, f32, (q,)))
    return _launch(name, (packed, block_tfs, pair_block), pair_tile, pair_qw,
                   pair_cap, (pair_bits, pair_base, pair_count,
                              packed.shape[1]),
                   norm, rank, qnorm, num_docs, tile, k_tile, rank_blend)


def _launch_score_blocked_cuda(block_docs, block_tfs, pair_block, pair_tile,
                               pair_qw, pair_cap, num_docs, tile):
    name = "fused_score_blocked"
    nb = block_docs.shape[0]
    check_tensors(name, block_docs=(block_docs, torch.int32, (nb, BLOCK)),
                  block_tfs=(block_tfs, torch.float32, (nb, BLOCK)),
                  **_pair_checks(pair_block, pair_tile, pair_qw, pair_cap))
    return _launch_dense(name, (block_docs, block_tfs, pair_block),
                         pair_tile, pair_qw, pair_cap, (), num_docs, tile)


def _launch_score_packed_cuda(packed, block_tfs, pair_block, pair_tile,
                              pair_qw, pair_cap, pair_bits, pair_base,
                              pair_count, num_docs, tile):
    name = "fused_score_packed"
    i32 = torch.int32
    nb, wpb = packed.shape
    np_ = pair_qw.shape[0]
    check_tensors(name, packed=(packed, i32, (nb, max(wpb, 1))),
                  block_tfs=(block_tfs, torch.float16, (nb, BLOCK)),
                  **_pair_checks(pair_block, pair_tile, pair_qw, pair_cap),
                  pair_bits=(pair_bits, i32, (np_,)),
                  pair_base=(pair_base, i32, (np_,)),
                  pair_count=(pair_count, i32, (np_,)))
    return _launch_dense(name, (packed, block_tfs, pair_block), pair_tile,
                         pair_qw, pair_cap,
                         (pair_bits, pair_base, pair_count, wpb), num_docs,
                         tile)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------


def fused_topk_blocked(block_docs, block_tfs, pair_block, pair_tile,
                       pair_qw, pair_cap, norm, rank, qnorm, num_docs: int,
                       k_tile: int, rank_blend: float = 0.0,
                       tile: int = TILE, reducer: str = "successive"):
    """HOR candidate path (replaces ``fused_topk_blocked_pallas``).

    block_docs i32[NB, 128], block_tfs f32[NB, 128] read in place;
    pair_* [NP] tile-sorted routing, pair_qw f32[NP, Q] per-query weight
    rows (Q padded to a multiple of 8), pair_cap i32[NP] per-pair valid
    lane count; norm/rank f32[num_docs]; qnorm f32[Q] (padding queries
    carry 1.0).  Returns (values f32[Q, n_tiles*k_tile], ids i32[same])
    tile-major candidate lists of FINAL scores.  CUDA tensors launch the
    kernel; CPU tensors take the plain version.  Run-aligned pair arrays
    (``build_batched_pairs(..., pairs_per_step=n)``) need no flag: both
    walk each tile's run whole, and the padding pairs add nothing."""
    _check_k_tile(k_tile, tile)
    _check_reducer(reducer, block_docs.is_cuda)
    if not block_docs.is_cuda:
        return fused_topk_blocked_plain(
            block_docs, block_tfs, pair_block, pair_tile, pair_qw, pair_cap,
            norm, rank, qnorm, num_docs, k_tile, rank_blend, tile)
    out = _launch_blocked_cuda(block_docs, block_tfs, pair_block, pair_tile,
                               pair_qw, pair_cap, norm, rank, qnorm,
                               num_docs, k_tile, rank_blend, tile)
    fused_topk_blocked.launches += 1
    return out


def fused_topk_packed(packed, block_tfs, pair_block, pair_tile, pair_qw,
                      pair_cap, pair_bits, pair_base, pair_count, norm, rank,
                      qnorm, num_docs: int, block: int, k_tile: int,
                      rank_blend: float = 0.0, tile: int = TILE,
                      reducer: str = "successive"):
    """Packed candidate path (replaces ``fused_topk_packed_pallas``):
    packed i32[NB, Wpb] (u32 bit-views) + f16 tfs stay compressed and
    are decoded per routed pair; per-pair (bits, base, count) decode
    scalars.  Otherwise as ``fused_topk_blocked``."""
    _check_k_tile(k_tile, tile)
    _check_reducer(reducer, packed.is_cuda)
    if not packed.is_cuda:
        return fused_topk_packed_plain(
            packed, block_tfs, pair_block, pair_tile, pair_qw, pair_cap,
            pair_bits, pair_base, pair_count, norm, rank, qnorm, num_docs,
            block, k_tile, rank_blend, tile)
    if block != BLOCK:
        raise ValueError(f"fused_topk_packed: block={block}, the CUDA "
                         f"kernel decodes {BLOCK}-lane blocks")
    out = _launch_packed_cuda(packed, block_tfs, pair_block, pair_tile,
                              pair_qw, pair_cap, pair_bits, pair_base,
                              pair_count, norm, rank, qnorm, num_docs,
                              k_tile, rank_blend, tile)
    fused_topk_packed.launches += 1
    return out


def fused_score_blocked(block_docs, block_tfs, pair_block, pair_tile,
                        pair_qw, pair_cap, num_docs: int, tile: int = TILE):
    """HOR dense path (replaces ``fused_score_blocked_pallas``):
    block_docs i32[NB, 128], block_tfs f32[NB, 128] read in place;
    pair_* [NP] tile-sorted routing, pair_qw f32[NP, Q] weight rows,
    pair_cap i32[NP] valid lanes per pair.  Returns f32[Q, num_docs]
    accumulated scores, 0.0 in tiles no pair visits.  CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    if not block_docs.is_cuda:
        return fused_score_blocked_plain(block_docs, block_tfs, pair_block,
                                         pair_tile, pair_qw, pair_cap,
                                         num_docs, tile)
    out = _launch_score_blocked_cuda(block_docs, block_tfs, pair_block,
                                     pair_tile, pair_qw, pair_cap, num_docs,
                                     tile)
    fused_score_blocked.launches += 1
    return out


def fused_score_packed(packed, block_tfs, pair_block, pair_tile, pair_qw,
                       pair_cap, pair_bits, pair_base, pair_count,
                       num_docs: int, block: int, tile: int = TILE):
    """Packed dense path (replaces ``fused_score_packed_pallas``): packed
    i32[NB, Wpb] (u32 bit-views) + f16 tfs decoded per routed pair from
    the per-pair (bits, base, count).  Otherwise as
    ``fused_score_blocked``."""
    if not packed.is_cuda:
        return fused_score_packed_plain(packed, block_tfs, pair_block,
                                        pair_tile, pair_qw, pair_cap,
                                        pair_bits, pair_base, pair_count,
                                        num_docs, block, tile)
    if block != BLOCK:
        raise ValueError(f"fused_score_packed: block={block}, the CUDA "
                         f"kernel decodes {BLOCK}-lane blocks")
    out = _launch_score_packed_cuda(packed, block_tfs, pair_block, pair_tile,
                                    pair_qw, pair_cap, pair_bits, pair_base,
                                    pair_count, num_docs, tile)
    fused_score_packed.launches += 1
    return out


fused_topk_blocked.launches = 0
fused_topk_packed.launches = 0
fused_score_blocked.launches = 0
fused_score_packed.launches = 0


# ---------------------------------------------------------------------------
# routing pairs
# ---------------------------------------------------------------------------


def build_batched_pairs(cand_block: Tensor, cand_valid: Tensor,
                        cand_q: Tensor, cand_w: Tensor, tile_first: Tensor,
                        tile_count: Tensor, n_tiles: int, num_queries: int,
                        max_pairs: int, cand_cap: Tensor | None = None,
                        pairs_per_step: int = 1):
    """Batch candidates -> deduplicated tile-sorted routing pairs.

    cand_* [S]: one entry per (query, term, block) candidate; cand_w is
    the query's idf weight for that block's term, cand_cap (optional)
    the lanes of the block the posting ``cap`` permits.  Blocks selected
    by several queries collapse to ONE pair per tile with a weight ROW
    over the batch (each (block, query) is set at most once: duplicate
    term hashes are dedup'd upstream).  Returns (pair_block [NP],
    pair_tile [NP], pair_qw f32[NP, Q], pair_cap [NP], overflow) with
    NP == max_pairs, equal to the reference's arrays; overflow (a 0-d
    tensor) counts pairs dropped because ``max_pairs`` was too small.

    ``pairs_per_step > 1`` run-aligns the pairs: each tile's run is
    padded with no-op pairs (qw 0, cap 0) to a multiple of it.

    On CUDA the index scatters are deterministic: every real slot is
    written once, and duplicate writes land only in a dropped trash slot.
    """
    dev = cand_block.device
    i32 = torch.int32
    s = cand_block.shape[0]
    sentinel = 2**30
    key = torch.where(cand_valid, cand_block.to(i32), sentinel).to(i32)
    order = torch.argsort(key, stable=True)
    k_s = key[order]
    q_s = cand_q[order].long()
    w_s = cand_w[order].float()
    valid_s = k_s < sentinel
    uniq = valid_s.clone()
    uniq[1:] &= k_s[1:] != k_s[:-1]
    uid = torch.cumsum(uniq.to(i32), 0, dtype=i32) - 1
    total_u = uid[-1] + 1
    scat = torch.where(valid_s, uid, s).long()
    ublock = torch.zeros(s + 1, dtype=i32, device=dev)
    ublock.scatter_(0, torch.where(uniq, uid, s).long(), k_s)
    ublock = ublock[:s]
    qw = torch.zeros(s + 1, num_queries, dtype=torch.float32, device=dev)
    qw.index_put_((scat, q_s), w_s, accumulate=True)
    if cand_cap is None:
        ucap = torch.full((s + 1,), 2**31 - 1, dtype=i32, device=dev)
    else:
        # a block is owned by one term, so every candidate referencing it
        # carries the same cap
        ucap = torch.zeros(s + 1, dtype=i32, device=dev)
        ucap.scatter_reduce_(0, scat, cand_cap[order].to(i32), reduce="amax")
    uvalid = torch.arange(s, dtype=i32, device=dev) < total_u

    # expand unique blocks to their (build-time cached) tile spans
    t0 = take_rows(tile_first, ublock.long())
    cnt = torch.where(uvalid, take_rows(tile_count, ublock.long()),
                      0).to(i32)
    offs = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                      torch.cumsum(cnt, 0, dtype=i32)])
    total = offs[-1]
    p = torch.arange(max_pairs, dtype=i32, device=dev)
    owner = (torch.searchsorted(offs, p, right=True) - 1).clamp(
        0, max(s - 1, 0))
    real = p < total
    pair_block = torch.where(real, ublock[owner], 0).to(i32)
    pair_tile = torch.where(real, t0[owner] + (p - offs[owner]),
                            n_tiles).to(i32)
    # non-real pairs all carry tile n_tiles and already sit last, in
    # order: only the real prefix needs the stable tile sort
    n_real = min(int(total), max_pairs)
    tile_order = torch.cat([
        torch.argsort(pair_tile[:n_real], stable=True),
        torch.arange(n_real, max_pairs, device=dev)])
    pair_qw = qw[owner[tile_order]] * real[tile_order][:, None]
    pair_cap = ucap[owner[tile_order]]
    overflow = (total - max_pairs).clamp_min(0)
    pair_block = pair_block[tile_order]
    pair_tile = pair_tile[tile_order]
    if pairs_per_step <= 1:
        return pair_block, pair_tile, pair_qw, pair_cap, overflow

    pps = int(pairs_per_step)
    if max_pairs % pps:
        raise ValueError(
            f"max_pairs={max_pairs} must be a multiple of "
            f"pairs_per_step={pps}")
    # Re-scatter each real pair to its run-aligned slot: runs of equal
    # tile get padded to a multiple of pps, consecutive runs stay
    # contiguous, so every run start lands on a step boundary.
    real_s = pair_tile < n_tiles
    start = torch.searchsorted(pair_tile, pair_tile).to(i32)
    end = torch.searchsorted(pair_tile, pair_tile, right=True).to(i32)
    rnk = p - start
    runlen = end - start
    extra = (-(-runlen // pps)) * pps - runlen      # pad of my run
    cum = torch.cumsum(torch.where((rnk == 0) & real_s, extra, 0), 0,
                       dtype=i32)
    pad_before = cum - torch.where(real_s, extra, 0)  # pads of EARLIER runs
    new_pos = torch.where(real_s, start + pad_before + rnk, max_pairs)
    overflow = overflow + (real_s & (new_pos >= max_pairs)).sum().to(i32)
    slot = new_pos.clamp_max(max_pairs).long()      # max_pairs: dropped

    def place(x, fill):
        out = torch.full((max_pairs + 1,) + x.shape[1:], fill,
                         dtype=x.dtype, device=dev)
        out[slot] = x
        return out[:max_pairs]

    nt = place(pair_tile, -1)
    # Padding slots inherit their run's tile (forward fill keeps the
    # sequence sorted); a fully empty prefix falls through to the trash
    # tile.
    nt = torch.cummax(nt, 0).values
    nt = torch.where(nt < 0, n_tiles, nt).to(i32)
    return (place(pair_block, 0), nt, place(pair_qw, 0.0),
            place(pair_cap, 0), overflow)
