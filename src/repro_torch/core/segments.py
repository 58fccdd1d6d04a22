"""Segment / ragged primitives: the part of ``repro.core.segments`` the
index layouts need.

A ragged collection of variable-length lists (posting lists, a direct
index's per-document term lists) is stored as ONE contiguous values
array plus an ``offsets`` array, i.e. CSR:

* ``offsets``: int32[num_segments + 1], non-decreasing, ``offsets[0] ==
  0``, ``offsets[-1] ==`` total valid entries;
* ``segment_ids``: int32[capacity] expansion of offsets; entries past
  the valid range point at ``num_segments`` (a trash row).
"""
from __future__ import annotations

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


def offsets_to_segment_ids(offsets: Tensor, capacity: int) -> Tensor:
    """Expand CSR offsets into a per-entry segment id vector; positions at
    or past ``offsets[-1]`` (padding) get id ``num_segments``."""
    num_segments = offsets.shape[0] - 1
    pos = torch.arange(capacity, dtype=offsets.dtype, device=offsets.device)
    ids = torch.searchsorted(offsets.contiguous(), pos, right=True) - 1
    return torch.where(pos < offsets[-1], ids, num_segments).to(torch.int32)


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
