"""Segment / ragged primitives: the port of ``repro.core.segments``.

A ragged collection of variable-length lists (posting lists, a direct
index's per-document term lists, adjacency lists, embedding bags) is
stored as ONE contiguous values array plus an ``offsets`` array, i.e.
CSR:

* ``offsets``: int32[num_segments + 1], non-decreasing, ``offsets[0] ==
  0``, ``offsets[-1] ==`` total valid entries;
* ``segment_ids``: int32[capacity] expansion of offsets; entries past
  the valid range point at ``num_segments`` (a trash row).

The reductions keep ``jax.ops.segment_*``'s semantics, on any device:

* a segment id outside ``[0, num_segments)`` (the trash row, a
  sampler's pad edge, a negative id) is dropped;
* an empty segment's max is -inf and its min +inf;
* min and max order -0.0 below +0.0, as XLA does, and a NaN entry
  makes its segment's min and max NaN;
* sums add each segment's entries in a fixed order, so that a sum (and
  every gradient through one) repeats bit for bit: on the CPU in entry
  order (XLA's scatter order there), on CUDA by ``ordered_segment_sum``
  (the entries stably sorted by segment, then each segment reduced in
  one pass), never by atomics;
* ``segment_std`` is the jitted reference's arithmetic (see there).

``sorted_ids`` is accepted and has no effect: it is only a hint to XLA.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

Tensor = torch.Tensor


def take_rows(t: Tensor, idx: Tensor) -> Tensor:
    """``t[idx]``, where an empty ``t`` (the band of an unpadded banded
    index that holds no term, an index with no postings) reads as zeros:
    none of its rows is ever valid, and the reference's clamped gathers
    read it without error."""
    if t.shape[0] == 0:
        return t.new_zeros(idx.shape + t.shape[1:])
    return t[idx]


def lengths_to_offsets(lengths: Tensor) -> Tensor:
    """int32[num_segments] -> int32[num_segments + 1] exclusive prefix
    sum."""
    zero = torch.zeros(1, dtype=torch.int32, device=lengths.device)
    return torch.cat([zero, torch.cumsum(lengths.to(torch.int32), 0,
                                         dtype=torch.int32)])


def offsets_to_lengths(offsets: Tensor) -> Tensor:
    return (offsets[1:] - offsets[:-1]).to(torch.int32)


def offsets_to_segment_ids(offsets: Tensor, capacity: int) -> Tensor:
    """Expand CSR offsets into a per-entry segment id vector; positions at
    or past ``offsets[-1]`` (padding) get id ``num_segments``."""
    num_segments = offsets.shape[0] - 1
    pos = torch.arange(capacity, dtype=offsets.dtype, device=offsets.device)
    ids = torch.searchsorted(offsets.contiguous(), pos, right=True) - 1
    return torch.where(pos < offsets[-1], ids, num_segments).to(torch.int32)


def segment_ids_to_offsets(segment_ids: Tensor, num_segments: int
                           ) -> Tensor:
    """Inverse of the above for sorted segment ids (padding id ==
    ``num_segments``).  As ``jnp.bincount(..., length=n)``: a negative id
    counts in segment 0, and an id past ``num_segments`` is dropped."""
    ids = segment_ids.long().clamp_min(0)
    ids = torch.where(ids > num_segments, num_segments + 1, ids)
    counts = torch.bincount(ids, minlength=num_segments + 2)
    return lengths_to_offsets(counts[:num_segments])


# ---------------------------------------------------------------------------
# segment reductions
# ---------------------------------------------------------------------------


def _trash_ids(segment_ids: Tensor, num_segments: int) -> Tensor:
    """int64 ids with every id outside [0, num_segments) sent to the
    trash row ``num_segments`` (no host read, so no sync on the card)."""
    ids = segment_ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, num_segments)


def ordered_segment_sum(data: Tensor, ids: Tensor, n: int) -> Tensor:
    """Sums of ``data``'s rows by ``ids`` (int64 in [0, n)) into ``[n,
    ...]`` in a fixed order on any device: the entries stably sorted by
    id, then each segment reduced in one pass (``torch.segment_reduce``,
    which on the CPU adds a segment's entries one after another in entry
    order, as ``index_add_`` does there).  No atomics, so the bits
    repeat from run to run."""
    order = torch.sort(ids, stable=True).indices
    lengths = torch.bincount(ids, minlength=n)
    return torch.segment_reduce(data[order], "sum", lengths=lengths,
                                unsafe=True)


def segment_sum(data: Tensor, segment_ids: Tensor, num_segments: int,
                sorted_ids: bool = True) -> Tensor:
    ids = _trash_ids(segment_ids, num_segments)
    if data.is_cuda:
        return ordered_segment_sum(data, ids, num_segments + 1)[
            :num_segments]
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_add_(0, ids, data)[:num_segments]


def _order_keys(x: Tensor, nan_key: int = 0x7FFFFFFF) -> Tensor:
    """int32 keys of f32 values, in XLA's order: -0.0 below +0.0; every
    NaN (either sign) gets ``nan_key``: INT32_MAX wins a max, INT32_MIN
    a min, as XLA's NaN-propagating min and max do."""
    bits = x.float().contiguous().view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.where(torch.isnan(x), nan_key, keys)


def _from_keys(keys: Tensor) -> Tensor:
    return torch.where(keys < 0, keys ^ 0x7FFFFFFF, keys).view(torch.float32)


def _segment_extreme(data: Tensor, segment_ids: Tensor, num_segments: int,
                     reduce: str, empty: float) -> Tensor:
    """Max or min over each segment of f32 keys (so that signed zeros
    order as XLA orders them, and a NaN wins); ``empty`` for a segment
    with no entry.  The keys of a NaN map back to a NaN."""
    ids = _trash_ids(segment_ids, num_segments)
    shape = (num_segments + 1,) + tuple(data.shape[1:])
    init = torch.full(shape, empty, dtype=torch.float32, device=data.device)
    idx = ids.view((-1,) + (1,) * (data.dim() - 1)).expand(data.shape)
    nan_key = 0x7FFFFFFF if reduce == "amax" else -0x80000000
    keys = _order_keys(init).scatter_reduce(
        0, idx, _order_keys(data, nan_key), reduce, include_self=True)
    return _from_keys(keys)[:num_segments].to(data.dtype)


def segment_max(data: Tensor, segment_ids: Tensor, num_segments: int,
                sorted_ids: bool = True) -> Tensor:
    return _segment_extreme(data, segment_ids, num_segments, "amax",
                            float("-inf"))


def segment_min(data: Tensor, segment_ids: Tensor, num_segments: int,
                sorted_ids: bool = True) -> Tensor:
    return _segment_extreme(data, segment_ids, num_segments, "amin",
                            float("inf"))


def segment_mean(data: Tensor, segment_ids: Tensor, num_segments: int,
                 sorted_ids: bool = True) -> Tensor:
    total = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(data.shape[:1], dtype=data.dtype, device=data.device)
    count = segment_sum(ones, segment_ids, num_segments).clamp_min(1)
    return total / count.view((-1,) + (1,) * (data.dim() - 1))


class _FmaVar(torch.autograd.Function):
    """``mean_sq - mean * mean`` with one rounding (an FMA), the value as
    ``core.query.fma_f32`` computes it, the gradient as for the
    unfused expression."""

    @staticmethod
    def forward(ctx, mean, mean_sq):
        from repro_torch.core.query import fma_f32   # query imports us
        ctx.save_for_backward(mean)
        return fma_f32(-mean, mean, mean_sq)

    @staticmethod
    def backward(ctx, g):
        (mean,) = ctx.saved_tensors
        return -g * mean + -g * mean, g


def segment_std(data: Tensor, segment_ids: Tensor, num_segments: int,
                sorted_ids: bool = True, eps: float = 1e-5) -> Tensor:
    """Per-segment standard deviation (PNA's 'std' aggregator), as the
    reference computes it under ``jax.jit`` on the CPU, its one caller's
    setting (``gnn._pna_layer``): XLA's loop contracts ``mean_sq - mean
    * mean`` into an FMA, except where the whole input is one entry (XLA
    then fuses the scatters into one loop that does not contract);
    ``max(var, 0)`` keeps a NaN and splits its gradient at 0 as
    ``jnp.maximum`` does; the square root is correctly rounded (torch's
    f32 CPU ``sqrt`` is not always)."""
    mean = segment_mean(data, segment_ids, num_segments)
    mean_sq = segment_mean(data * data, segment_ids, num_segments)
    if data.shape[0] == 1:
        var = mean_sq - mean * mean
    else:
        var = _FmaVar.apply(mean, mean_sq)
    var = torch.maximum(var, torch.zeros_like(var))
    return torch.sqrt((var + eps).double()).to(data.dtype)


def jax_take(x: Tensor, idx: Tensor) -> Tensor:
    """``x[idx]`` along axis 0 as a JAX gather reads it: a negative index
    counts from the end, then every index is clamped into range."""
    n = x.shape[0]
    i = idx.long()
    return x[torch.where(i < 0, i + n, i).clamp(0, max(n - 1, 0))]


def segment_softmax(logits: Tensor, segment_ids: Tensor, num_segments: int,
                    sorted_ids: bool = True) -> Tensor:
    """Softmax within each segment (GAT-style edge softmax).  An entry
    outside every segment reads a clamped segment's max and denominator,
    as the reference's gathers do."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    exp = torch.exp(logits - jax_take(seg_max, segment_ids))
    denom = segment_sum(exp, segment_ids, num_segments).clamp_min(1e-30)
    return exp / jax_take(denom, segment_ids)


def run_ranks(keys: Tensor) -> Tensor:
    """Rank of each entry within its run of equal consecutive ``keys``
    (0 at a run's start), as int64.  The plain kernel versions add the
    entries of rank r in round r: no two adds of a round share a run."""
    pos = torch.arange(keys.shape[0], device=keys.device)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    return pos - torch.cummax(torch.where(first, pos, 0), 0).values


def gather_segments(values: Tensor, offsets: Tensor, segments: Tensor,
                    capacity: int, fill=0) -> tuple[Tensor, Tensor]:
    """Fetch each segment's entries into a ``[..., capacity]`` buffer.

    ``segments`` int[...] are segment ids (in range).  Returns (buffer
    [..., capacity, *values.shape[1:]], valid [..., capacity]): the q_occ
    primitive, one contiguous slab per segment in the CSR layout.
    """
    seg = segments.long()
    start = offsets[seg].long()
    length = offsets[seg + 1].long() - start
    k = torch.arange(capacity, device=values.device)
    valid = k < length[..., None]
    idx = torch.where(valid, start[..., None] + k, 0)
    buf = take_rows(values, idx)
    mask = valid.view(valid.shape + (1,) * (values.dim() - 1))
    return torch.where(mask, buf, fill), valid


def gather_segment(values: Tensor, offsets: Tensor, segment, capacity: int,
                   fill=0) -> tuple[Tensor, Tensor]:
    """One segment's entries into a [capacity] buffer: (buffer, valid)."""
    seg = torch.as_tensor(segment, device=values.device)
    return gather_segments(values, offsets, seg, capacity, fill)


# ---------------------------------------------------------------------------
# embedding bag: the recsys primitive, same layout math as the paper
# ---------------------------------------------------------------------------


def _jax_take_fill(table: Tensor, indices: Tensor) -> Tensor:
    """``jnp.take(table, indices, axis=0)`` in its default mode: a
    negative index in range counts from the end, and an index out of
    range reads a row of NaN."""
    n = table.shape[0]
    i = indices.long()
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    rows = table[i.clamp(0, max(n - 1, 0))]
    return torch.where(ok.view((-1,) + (1,) * (table.dim() - 1)), rows,
                       float("nan"))


def embedding_bag(table: Tensor, indices: Tensor, offsets: Tensor,
                  mode: str = "sum", weights: Tensor | None = None
                  ) -> Tensor:
    """EmbeddingBag over ragged bags: ``indices`` int32[total] bag
    members, ``offsets`` int32[bags + 1].  The paper's ORIF layout of a
    multi-valued attribute: bags are packed contiguously, the bag id is
    never stored.  Modes "sum", "mean" and "max" (a bag with no member
    gives 0); ``weights`` [total] scale each member's row."""
    num_bags = offsets.shape[0] - 1
    seg = offsets_to_segment_ids(offsets, indices.shape[0])
    rows = _jax_take_fill(table, indices)
    if weights is not None:
        rows = rows * weights[:, None]
    if mode == "sum":
        return segment_sum(rows, seg, num_bags)
    if mode == "mean":
        return segment_mean(rows, seg, num_bags)
    if mode == "max":
        out = segment_max(rows, seg, num_bags)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# host-side builders (numpy; used by index construction & data pipelines)
# ---------------------------------------------------------------------------


def pack_ragged_np(lists: Sequence[np.ndarray], pad_to: int | None = None,
                   dtype=np.int32) -> tuple[np.ndarray, np.ndarray]:
    """Pack a python list of 1-D arrays into (values, offsets)."""
    lengths = np.array([len(x) for x in lists], dtype=np.int64)
    offsets = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    total = int(offsets[-1])
    cap = total if pad_to is None else int(pad_to)
    if cap < total:
        raise ValueError(f"pad_to={cap} < total={total}")
    values = np.zeros(cap, dtype=dtype)
    if lists:
        values[:total] = np.concatenate(lists) if total else values[:0]
    return values, offsets.astype(np.int32)
