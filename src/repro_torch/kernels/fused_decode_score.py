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

A candidate kernel reduces each tile by one of the reference's two
reducers (``REDUCERS``): ``"successive"`` (``_tile_topk``: k_tile
successive maxima) or ``"bitonic"`` (``_tile_topk_bitonic``: a bitonic
sort of the whole tile, then its first k_tile columns).  Both tie +0.0
and -0.0 and go by lane, and give the same ids; their value bits differ
only at signed zeros, where successive maxima write the row's maximum
(+0.0 above -0.0, as XLA's max orders them) and the sort moves each
lane's own bits.  At a row holding a NaN they part: successive maxima
find the maximum NaN every step and write (NaN, -1) in every slot, the
network's output depends on where the NaN sits.  So each reducer is
held to its own reference counterpart.  On the card both epilogues
select each row's best by the same keys (``csrc/fused_score.cuh``) and
write by their own value rule; a bitonic CTA holding a NaN runs the
network.

Two implementations of each kernel live here:

* the CUDA C++ kernel (``csrc/fused_{topk,score}_{blocked,packed}.cu``,
  six entry points over one walk, ``csrc/fused_score.cuh``, with a
  dense epilogue or one of two candidate epilogues, one per reducer),
  which a CUDA tensor always goes to — there is no fallback;
* its plain PyTorch version (``fused_{topk,score}_{blocked,packed}
  _plain``), the path for CPU tensors and the kernel's yardstick on the
  card.  It adds the pairs in the kernel's order without colliding
  atomics: round ``r``
  updates pair ``r`` of every tile's run at once (tiles own disjoint
  docs and a block's doc ids are unique), with the same fused
  multiply-adds (``core.query.fma_f32``), so both agree to the bit.

Each wrapper counts its kernel launches in ``<wrapper>.launches``; a
candidate wrapper counts its bitonic launches apart, in
``<wrapper>.launches_bitonic``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.layouts import take_rows, unpack_words
from repro_torch.core.segments import run_ranks
from repro_torch.core.query import final_scores, fma_f32
from repro_torch.kernels.cuda_build import check_tensors, entry, tensors_ok

Tensor = torch.Tensor

TILE = 512   # doc-space tile width
Q_PAD = 8    # query-batch padding quantum
K_PAD = 8    # candidate-count padding quantum (per-tile k_tile)
BLOCK = 128  # posting block width
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


def _check_reducer(reducer: str, tile: int) -> None:
    """Reject a reducer the candidate kernels do not have, and the
    bitonic reducer at a tile that is not a power of two."""
    if reducer not in REDUCERS:
        raise ValueError(f"unknown reducer {reducer!r}; expected {REDUCERS}")
    if reducer == "bitonic" and (tile < 1 or tile & (tile - 1)):
        raise ValueError(f"bitonic reducer needs a power-of-two tile, "
                         f"got {tile}")


def _doc_tiles(norm: Tensor, rank: Tensor, n_tiles: int, tile: int):
    """Pad per-doc metadata to the tile grid (+ a zero trash tile for
    padding pairs; norm 0 there marks every lane deleted)."""
    pad = (n_tiles + 1) * tile - norm.shape[0]
    nt = torch.nn.functional.pad(norm.float(), (0, pad))
    rt = torch.nn.functional.pad(rank.float(), (0, pad))
    return nt.view(n_tiles + 1, tile), rt.view(n_tiles + 1, tile)


def _row_max(work: Tensor) -> Tensor:
    """Each row's maximum, +0.0 where the row's largest values are zeros
    of both signs: XLA's max orders -0.0 below +0.0, torch's takes
    either."""
    m = work.max(dim=-1).values
    pos_zero = ((work == 0) & ~torch.signbit(work)).any(dim=-1)
    return torch.where((m == 0) & pos_zero, torch.zeros_like(m), m)


def _tile_topk(final: Tensor, base: Tensor, k_tile: int, tile: int):
    """``k_tile`` successive maxima of each ``tile``-wide row of
    ``final`` [..., tile]; ``base`` [...] is the global id of lane 0.

    Tie-break: lowest lane first (the ``jax.lax.top_k`` order the
    candidate merge relies on); +0.0 and -0.0 tie, and the value
    written is the row's maximum (``_row_max``).  Non-finite maxima get
    id -1.  A row holding a NaN has the maximum NaN, which no lane
    equals, so no lane is spent: (NaN, -1) in every slot.  Returns
    (values, ids) [..., k_tile]."""
    work = final.clone()
    lane = torch.arange(tile, device=final.device, dtype=torch.int32)
    vals, ids = [], []
    for _ in range(k_tile):
        m = _row_max(work)
        am = torch.where(work == m[..., None], lane, tile).min(dim=-1).values
        ids.append(torch.where(torch.isfinite(m), base + am, -1))
        vals.append(m)
        at = am[..., None].long().clamp_max(tile - 1)
        work.scatter_(-1, at, torch.where(am[..., None] < tile, NEG_INF,
                                          work.gather(-1, at)))
    return torch.stack(vals, -1), torch.stack(ids, -1).to(torch.int32)


def _swap_stride(x: Tensor, j: int) -> Tensor:
    """Each lane's partner ``lane ^ j`` along the last axis (``j`` a
    power of two dividing the width): the pair axis of a reshape,
    reversed."""
    shape = x.shape
    y = x.reshape(*shape[:-1], shape[-1] // (2 * j), 2, j)
    return y.flip(-2).reshape(shape)


def _tile_topk_bitonic(final: Tensor, base: Tensor, k_tile: int, tile: int):
    """Bitonic sort of each ``tile``-wide row of ``final`` [..., tile]
    by (value descending, lane ascending), then its first ``k_tile``
    columns: the reference's ``_tile_topk_bitonic``, stage by stage.

    Each stage keeps, at every lane, itself or its partner ``lane ^
    stride`` by float comparisons (so +0.0 and -0.0 tie and go by lane),
    and only moves values, never recomputes them.  Non-finite survivors
    get id -1.  ``base`` [...] is the global id of lane 0.  Returns
    (values, ids) [..., k_tile]."""
    _check_reducer("bitonic", tile)
    lane = torch.arange(tile, device=final.device, dtype=torch.int32)
    v, l = final, lane.expand(final.shape)
    size = 2
    while size <= tile:
        stride = size // 2
        while stride >= 1:
            pv, pl = _swap_stride(v, stride), _swap_stride(l, stride)
            lo = (lane & stride) == 0          # low element of its pair
            desc = (lane & size) == 0          # block direction this stage
            # self precedes partner in (value desc, lane asc) order
            first = (v > pv) | ((v == pv) & (l < pl))
            keep = torch.where(lo == desc, first, ~first)
            v = torch.where(keep, v, pv)
            l = torch.where(keep, l, pl)
            stride //= 2
        size *= 2
    vals = v[..., :k_tile]
    ids = torch.where(torch.isfinite(vals), base[..., None] + l[..., :k_tile],
                      -1)
    return vals, ids.to(torch.int32)


def _tile_reduce(final: Tensor, base: Tensor, k_tile: int, tile: int,
                 reducer: str):
    """The reducer dispatch of the candidate kernels' plain versions."""
    if reducer == "bitonic":
        return _tile_topk_bitonic(final, base, k_tile, tile)
    if reducer == "successive":
        return _tile_topk(final, base, k_tile, tile)
    raise ValueError(f"unknown reducer {reducer!r}; expected {REDUCERS}")


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
                         tile: int, k_tile: int, rank_blend: float,
                         reducer: str = "successive"):
    """Scoring tail + ``reducer``'s reduction of every tile."""
    q = acc.shape[1]
    norm_t, rank_t = _doc_tiles(norm, rank, n_tiles, tile)
    dense = acc.permute(1, 0, 2).reshape(q, (n_tiles + 1) * tile)
    final = final_scores(dense, norm_t.reshape(-1), rank_t.reshape(-1),
                         qnorm, rank_blend).view(q, n_tiles + 1, tile)
    base = (torch.arange(n_tiles + 1, device=acc.device,
                         dtype=torch.int32) * tile)[None, :]
    vals, ids = _tile_reduce(final, base.expand(q, -1), k_tile, tile,
                             reducer)
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
                             rank_blend: float = 0.0, tile: int = TILE,
                             reducer: str = "successive"):
    """Plain PyTorch version of the HOR candidate kernel."""
    _check_k_tile(k_tile, tile)
    _check_reducer(reducer, tile)
    n_tiles = _n_tiles(num_docs, tile)
    acc = _blocked_acc(block_docs, block_tfs, pair_block, pair_tile,
                       pair_qw, pair_cap, n_tiles, tile)
    return _candidates_from_acc(acc, pair_tile, norm, rank, qnorm, n_tiles,
                                tile, k_tile, rank_blend, reducer)


def fused_topk_packed_plain(packed, block_tfs, pair_block, pair_tile,
                            pair_qw, pair_cap, pair_bits, pair_base,
                            pair_count, norm, rank, qnorm, num_docs: int,
                            block: int, k_tile: int,
                            rank_blend: float = 0.0, tile: int = TILE,
                            reducer: str = "successive"):
    """Plain PyTorch version of the packed candidate kernel."""
    _check_k_tile(k_tile, tile)
    _check_reducer(reducer, tile)
    n_tiles = _n_tiles(num_docs, tile)
    acc = _packed_acc(packed, block_tfs, pair_block, pair_tile, pair_qw,
                      pair_cap, pair_bits, pair_base, pair_count, block,
                      n_tiles, tile)
    return _candidates_from_acc(acc, pair_tile, norm, rank, qnorm, n_tiles,
                                tile, k_tile, rank_blend, reducer)


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
# C signatures (csrc/fused_{topk,score}_{blocked,packed}.cu): the layout's
# blocks (blocked: docs, tfs; packed: words, tfs, wpb), the pairs
# (pair_block, pair_tile, pair_cap, pair_qw, and packed: pair_bits,
# pair_base, pair_count), n_pairs, the outputs (dense: out; candidates:
# norm, rank, qnorm, vals, ids), n_tiles, num_docs, q, tile, (candidates:
# k_tile, rank_blend), stream
_DENSE_TAIL = [_I, _P] + [_I] * 4 + [_P]
_TOPK_TAIL = [_I] + [_P] * 5 + [_I] * 5 + [_F, _P]
_ARGTYPES = {
    "fused_topk_blocked": [_P] * 6 + _TOPK_TAIL,
    "fused_topk_packed": [_P, _P, _I] + [_P] * 7 + _TOPK_TAIL,
    "fused_score_blocked": [_P] * 6 + _DENSE_TAIL,
    "fused_score_packed": [_P, _P, _I] + [_P] * 7 + _DENSE_TAIL,
}


SMEM_LIMIT = 227 * 1024     # a CTA's shared memory on sm_90
_CHUNK = 16                 # fused_score.cuh: kChunk, pairs per stage


def _round16(n: int) -> int:
    return (n + 15) & ~15


def fused_smem_bytes(name: str, q: int, tile: int, wpb: int = 0,
                     reducer: str = "successive") -> int:
    """Dynamic shared memory of fused kernel ``name`` per CTA, as
    ``fused_score.cuh``'s ``Plan`` lays it out: the f32 [q, tile]
    accumulator, two lane maps, three metadata buffers, two block rings,
    the packed blocks' decoded tfs, and for the bitonic epilogue the
    u16 [q, tile] lane array."""
    packed = name.endswith("_packed")
    slot = _round16(wpb * 4) + BLOCK * 2 if packed else BLOCK * 8
    meta_ints = 5 if packed else 2
    return (_round16(q * tile * 4) + 2 * _round16(_CHUNK * tile)
            + 3 * _round16(_CHUNK * (meta_ints + q) * 4) + 2 * _CHUNK * slot
            + (_CHUNK * BLOCK * 4 if packed else 0)
            + (_round16(q * tile * 2) if reducer == "bitonic" else 0))


def check_smem(name: str, q: int, tile: int, wpb: int | None = None,
               reducer: str = "successive") -> None:
    """Refuse a geometry whose CTA does not fit in shared memory, by
    name: the f32 [q, tile] accumulator alone (``wpb=None``, the posting
    scorer), or a fused kernel's whole plan (``fused_smem_bytes``)."""
    if wpb is None:
        if q * tile * 4 > SMEM_LIMIT:
            raise ValueError(f"{name}: Q={q} x tile={tile} f32 accumulator "
                             "exceeds a CTA's 227 KB of shared memory")
        return
    need = fused_smem_bytes(name, q, tile, wpb, reducer)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{name}: Q={q} x tile={tile} (reducer={reducer!r}"
            + (f", {wpb} words per block" if name.endswith("_packed")
               else "")
            + f") needs {need} B of shared memory per CTA, more than "
            "the 227 KB a CTA has")


def _checked_device(name, specs, tile, wpb=0, reducer="successive") -> int:
    """Kernel ``name``'s tensors checked in one pass (``specs``, by name:
    contiguous, dtype, shape, one CUDA device), and its geometry against
    shared memory; their device index.  On a failure ``check_tensors``
    names the tensor at fault."""
    dev = specs["pair_qw"][0].get_device()
    if not tensors_ok(dev, specs.values()):
        check_tensors(name, **specs)
        raise ValueError(f"{name}: tensors on different devices")
    check_smem(name, specs["pair_qw"][0].shape[1], tile, wpb, reducer)
    return dev


def _launch(name, dev, blocks, pairs, outs, num_docs, tile, extra=(),
            symbol=None):
    """Call kernel ``name``'s entry point (``symbol``, by default
    ``<name>_launch``) on PyTorch's raw stream: one device launch.
    ``blocks`` are its layout's pointers and ints, ``pairs`` its pair
    arrays, ``outs`` the tensors after ``n_pairs`` (a candidate kernel's
    doc metadata, then the outputs), ``extra`` the numbers after
    ``tile``.  The entry point is called directly, not through
    ``cuda_build.launch``'s loop over its arguments: a call's host time
    is most of a small launch's."""
    np_, q = pairs[3].shape
    err = entry(name, _ARGTYPES[name], symbol)(
        *blocks, *(t.data_ptr() for t in pairs), np_,
        *(t.data_ptr() for t in outs), _n_tiles(num_docs, tile), num_docs, q,
        tile, *extra, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (error {err})")


def _pair_specs(pair_qw):
    """(N, Q) of ``pair_qw``, or (0, 0) when it is not 2-D, so that
    ``check_tensors`` reports its shape."""
    return tuple(pair_qw.shape) if pair_qw.dim() == 2 else (0, 0)


def _blocked_specs(block_docs, block_tfs, pair_block, pair_tile, pair_qw,
                   pair_cap):
    """The HOR kernels' (tensor, dtype, shape) checks, by name."""
    i32, f32 = torch.int32, torch.float32
    nb = block_docs.shape[0] if block_docs.dim() else 0
    np_, q = _pair_specs(pair_qw)
    return dict(block_docs=(block_docs, i32, (nb, BLOCK)),
                block_tfs=(block_tfs, f32, (nb, BLOCK)),
                pair_block=(pair_block, i32, (np_,)),
                pair_tile=(pair_tile, i32, (np_,)),
                pair_cap=(pair_cap, i32, (np_,)),
                pair_qw=(pair_qw, f32, (np_, q)))


def _packed_specs(packed, block_tfs, pair_block, pair_tile, pair_qw,
                  pair_cap, pair_bits, pair_base, pair_count):
    """The packed kernels' (tensor, dtype, shape) checks, by name."""
    i32 = torch.int32
    nb, wpb = tuple(packed.shape) if packed.dim() == 2 else (0, 0)
    np_, q = _pair_specs(pair_qw)
    return dict(packed=(packed, i32, (nb, max(wpb, 1))),
                block_tfs=(block_tfs, torch.float16, (nb, BLOCK)),
                pair_block=(pair_block, i32, (np_,)),
                pair_tile=(pair_tile, i32, (np_,)),
                pair_cap=(pair_cap, i32, (np_,)),
                pair_qw=(pair_qw, torch.float32, (np_, q)),
                pair_bits=(pair_bits, i32, (np_,)),
                pair_base=(pair_base, i32, (np_,)),
                pair_count=(pair_count, i32, (np_,)))


def _launch_topk(name, specs, blocks, pairs, norm, rank, qnorm, num_docs,
                 k_tile, rank_blend, tile, reducer, wpb=0):
    """A candidate kernel's launch, by ``reducer``'s epilogue (the
    bitonic one has entry points of its own, ``<name>_bitonic_launch``):
    the doc metadata checked with the rest, then the tile-major
    candidate lists allocated (every element is written, (-inf, -1) in
    unvisited tiles)."""
    f32 = torch.float32
    q = _pair_specs(specs["pair_qw"][0])[1]
    dev = _checked_device(name, dict(
        specs, norm=(norm, f32, (num_docs,)), rank=(rank, f32, (num_docs,)),
        qnorm=(qnorm, f32, (q,))), tile, wpb, reducer)
    n = _n_tiles(num_docs, tile) * k_tile
    vals = torch.empty((q, n), dtype=f32, device=norm.device)
    ids = torch.empty((q, n), dtype=torch.int32, device=norm.device)
    _launch(name, dev, blocks, pairs, (norm, rank, qnorm, vals, ids),
            num_docs, tile, (k_tile, rank_blend),
            f"{name}_bitonic_launch" if reducer == "bitonic" else None)
    return vals, ids


def _launch_dense(name, specs, blocks, pairs, num_docs, tile, wpb=0):
    """A dense kernel's launch into a new f32[Q, num_docs] (every element
    is written, zeros in unvisited tiles)."""
    dev = _checked_device(name, specs, tile, wpb)
    pair_qw = specs["pair_qw"][0]
    out = torch.empty((pair_qw.shape[1], num_docs), dtype=torch.float32,
                      device=pair_qw.device)
    _launch(name, dev, blocks, pairs, (out,), num_docs, tile)
    return out


def _wpb(packed) -> int:
    return packed.shape[1] if packed.dim() == 2 else 0


def _launch_blocked_cuda(block_docs, block_tfs, pair_block, pair_tile,
                         pair_qw, pair_cap, norm, rank, qnorm, num_docs,
                         k_tile, rank_blend, tile, reducer="successive"):
    return _launch_topk(
        "fused_topk_blocked",
        _blocked_specs(block_docs, block_tfs, pair_block, pair_tile, pair_qw,
                       pair_cap),
        (block_docs.data_ptr(), block_tfs.data_ptr()),
        (pair_block, pair_tile, pair_cap, pair_qw), norm, rank, qnorm,
        num_docs, k_tile, rank_blend, tile, reducer)


def _launch_packed_cuda(packed, block_tfs, pair_block, pair_tile, pair_qw,
                        pair_cap, pair_bits, pair_base, pair_count, norm,
                        rank, qnorm, num_docs, k_tile, rank_blend, tile,
                        reducer="successive"):
    return _launch_topk(
        "fused_topk_packed",
        _packed_specs(packed, block_tfs, pair_block, pair_tile, pair_qw,
                      pair_cap, pair_bits, pair_base, pair_count),
        (packed.data_ptr(), block_tfs.data_ptr(), _wpb(packed)),
        (pair_block, pair_tile, pair_cap, pair_qw, pair_bits, pair_base,
         pair_count), norm, rank, qnorm, num_docs, k_tile, rank_blend, tile,
        reducer, _wpb(packed))


def _launch_score_blocked_cuda(block_docs, block_tfs, pair_block, pair_tile,
                               pair_qw, pair_cap, num_docs, tile):
    return _launch_dense(
        "fused_score_blocked",
        _blocked_specs(block_docs, block_tfs, pair_block, pair_tile, pair_qw,
                       pair_cap),
        (block_docs.data_ptr(), block_tfs.data_ptr()),
        (pair_block, pair_tile, pair_cap, pair_qw), num_docs, tile)


def _launch_score_packed_cuda(packed, block_tfs, pair_block, pair_tile,
                              pair_qw, pair_cap, pair_bits, pair_base,
                              pair_count, num_docs, tile):
    return _launch_dense(
        "fused_score_packed",
        _packed_specs(packed, block_tfs, pair_block, pair_tile, pair_qw,
                      pair_cap, pair_bits, pair_base, pair_count),
        (packed.data_ptr(), block_tfs.data_ptr(), _wpb(packed)),
        (pair_block, pair_tile, pair_cap, pair_qw, pair_bits, pair_base,
         pair_count), num_docs, tile, _wpb(packed))


def occupancy(name: str, q: int, tile: int = TILE, wpb: int = 0,
              reducer: str = "successive") -> tuple[int, int]:
    """(CTAs per SM, dynamic shared memory bytes per CTA) of fused kernel
    ``name`` at Q = ``q`` (and, packed, ``wpb`` words per block; a
    candidate kernel by ``reducer``'s epilogue), as the CUDA runtime
    computes them on the current card.  A geometry that does not fit
    raises ``check_smem``'s ``ValueError``."""
    check_smem(name, q, tile, wpb, reducer)
    smem = ctypes.c_int(0)
    args = ((wpb,) if name.endswith("_packed") else ()) + (
        q, tile, ctypes.byref(smem))
    tag = "_bitonic" if reducer == "bitonic" else ""
    ctas = entry(name, [_I] * (len(args) - 1)
                 + [ctypes.POINTER(ctypes.c_int)],
                 f"{name}{tag}_occupancy")(*args)
    if ctas < 0:
        raise RuntimeError(f"{name}: occupancy query failed (error "
                           f"{-ctas})")
    return ctas, smem.value


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
    tile-major candidate lists of FINAL scores, each tile reduced by
    ``reducer`` ("successive" or "bitonic", whose launches count in
    ``launches_bitonic``).  CUDA tensors launch the kernel; CPU tensors
    take the plain version.  Run-aligned pair arrays
    (``build_batched_pairs(..., pairs_per_step=n)``) need no flag: both
    walk each tile's run whole, and the padding pairs add nothing."""
    _check_k_tile(k_tile, tile)
    _check_reducer(reducer, tile)
    if not block_docs.is_cuda:
        return fused_topk_blocked_plain(
            block_docs, block_tfs, pair_block, pair_tile, pair_qw, pair_cap,
            norm, rank, qnorm, num_docs, k_tile, rank_blend, tile, reducer)
    out = _launch_blocked_cuda(block_docs, block_tfs, pair_block, pair_tile,
                               pair_qw, pair_cap, norm, rank, qnorm,
                               num_docs, k_tile, rank_blend, tile, reducer)
    if reducer == "bitonic":
        fused_topk_blocked.launches_bitonic += 1
    else:
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
    _check_reducer(reducer, tile)
    if not packed.is_cuda:
        return fused_topk_packed_plain(
            packed, block_tfs, pair_block, pair_tile, pair_qw, pair_cap,
            pair_bits, pair_base, pair_count, norm, rank, qnorm, num_docs,
            block, k_tile, rank_blend, tile, reducer)
    if block != BLOCK:
        raise ValueError(f"fused_topk_packed: block={block}, the CUDA "
                         f"kernel decodes {BLOCK}-lane blocks")
    out = _launch_packed_cuda(packed, block_tfs, pair_block, pair_tile,
                              pair_qw, pair_cap, pair_bits, pair_base,
                              pair_count, norm, rank, qnorm, num_docs,
                              k_tile, rank_blend, tile, reducer)
    if reducer == "bitonic":
        fused_topk_packed.launches_bitonic += 1
    else:
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
fused_topk_blocked.launches_bitonic = 0
fused_topk_packed.launches_bitonic = 0
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
    padded with no-op pairs (qw 0, cap 0) to a multiple of it.  The
    arrays then end with the last run (NP its aligned end, at most
    max_pairs, at least pairs_per_step): the reference fills the slots
    past it with no-op pairs of the last run's tile, which a kernel
    would walk as that tile's run.

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
    # only the real prefix moves: the other pairs would all land in the
    # dropped slot, one address written max_pairs - n_real times
    pt_r = pair_tile[:n_real]
    start = torch.searchsorted(pt_r, pt_r).to(i32)
    end = torch.searchsorted(pt_r, pt_r, right=True).to(i32)
    rnk = p[:n_real] - start
    runlen = end - start
    extra = (-(-runlen // pps)) * pps - runlen      # pad of my run
    cum = torch.cumsum(torch.where(rnk == 0, extra, 0), 0, dtype=i32)
    pad_before = cum - extra                        # pads of EARLIER runs
    new_pos = start + pad_before + rnk              # ascending
    overflow = overflow + (new_pos >= max_pairs).sum().to(i32)
    # the runs end at the last real pair's slot, aligned up
    n_end = int(new_pos[-1]) + 1 if n_real else 0
    n_end = min(-(-n_end // pps) * pps, max_pairs)
    size = max(n_end, pps)
    slot = new_pos.clamp_max(size).long()           # size: dropped

    def place(x, fill):
        out = torch.full((size + 1,) + x.shape[1:], fill, dtype=x.dtype,
                         device=dev)
        out[slot] = x[:n_real]
        return out[:size]

    nt = place(pair_tile, -1)
    # Padding slots inherit their run's tile (a forward fill keeps the
    # sequence sorted); with no real pair, the slots fall through to the
    # trash tile.
    nt = torch.cummax(nt, 0).values
    nt = torch.where(nt < 0, n_tiles, nt).to(i32)
    return (place(pair_block, 0), nt, place(pair_qw, 0.0),
            place(pair_cap, 0), overflow)
