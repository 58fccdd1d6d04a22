"""Distributed top-k merge: the port of ``repro.distributed.topk``.

Each source (a doc tile of the fused engine, a shard, a segment) keeps a
local candidate list; the global answer is the top-k of the
concatenated lists.  Ties break on the EARLIEST candidate, like
``jax.lax.top_k``: with sources ordered by ascending doc id, that is the
lowest doc id, bit-identical to a dense top-k.  Every top-k here is a
stable descending sort — never ``torch.topk``, whose tie order differs.

The sharded merges (``local_topk_merge``, ``local_candidate_merge``,
``sharded_topk``) take the shards' tensors and the ``shmap.Mesh`` where
the reference's take an axis name inside ``shard_map``: the all-gather
is ``shmap.all_gather``, a concatenation in shard order on the mesh's
first device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.distributed import shmap

Tensor = torch.Tensor


def merge_topk_candidates(values: Tensor, ids: Tensor, k: int
                          ) -> tuple[Tensor, Tensor]:
    """Top-k merge of candidate (value, id) lists on the last axis.

    values f32[..., C], ids i32[..., C].  Pads with -inf / -1 when
    C < k, so ``k`` may exceed the candidate count.
    """
    c = values.shape[-1]
    if c < k:
        values = torch.nn.functional.pad(values, (0, k - c),
                                         value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, k - c), value=-1)
    v, pos = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], torch.gather(ids, -1, pos[..., :k])


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype)


def merge_topk_candidates_host(values, ids, k: int, trace=None):
    """numpy twin of ``merge_topk_candidates`` for host-side merges:
    ``values`` / ``ids`` are lists of per-source candidate arrays or
    tensors ``[..., C_i]`` (ragged last axes allowed), concatenated in
    source order.  The segmented live index merges its per-segment
    candidates here.

    ``trace`` optionally records a ``"merge"`` child span (of
    ``"score"``); it covers the device-to-host copy of every source's
    candidates, which is where the host waits for the device."""
    span = None
    if trace is not None:
        span = trace.span(
            "merge", parent="score", sources=len(values),
            candidates=int(sum(x.shape[-1] for x in ids)))
    v = np.concatenate([_host(x, np.float32) for x in values], axis=-1)
    i = np.concatenate([_host(x, np.int32) for x in ids], axis=-1)
    c = v.shape[-1]
    if c < k:
        pad = [(0, 0)] * (v.ndim - 1) + [(0, k - c)]
        v = np.pad(v, pad, constant_values=-np.inf)
        i = np.pad(i, pad, constant_values=-1)
    order = np.argsort(-v, axis=-1, kind="stable")[..., :k]
    out = (np.take_along_axis(v, order, axis=-1),
           np.take_along_axis(i, order, axis=-1))
    if span is not None:
        span.end()
    return out


def canonicalize_candidates(values: Tensor, ids: Tensor
                            ) -> tuple[Tensor, Tensor]:
    """Sort candidate lists by ascending doc id on the last axis (a
    stable sort), so a merge of sources that interleave doc ranges (the
    mixed-layout groups of a segment stack) still breaks exact ties on
    the lowest doc id.  Invalid candidates (id -1, value -inf) sort to
    the front, where they only tie other -inf entries."""
    order = torch.argsort(ids, dim=-1, stable=True)
    return (torch.gather(values, -1, order), torch.gather(ids, -1, order))


def local_topk(scores: Tensor, k: int, shard_offset
               ) -> tuple[Tensor, Tensor]:
    """One shard's half of ``local_topk_merge``: scores f32[local_n] ->
    its top min(k, local_n) (values, global ids = local + offset),
    padded with -inf / -1 to k."""
    local_n = scores.shape[-1]
    kl = min(k, local_n)
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    v = v[..., :kl]
    gids = (i[..., :kl] + shard_offset).to(torch.int32)
    if kl < k:
        v = torch.nn.functional.pad(v, (0, k - kl), value=float("-inf"))
        gids = torch.nn.functional.pad(gids, (0, k - kl), value=-1)
    return v, gids


def local_topk_merge(scores: Sequence[Tensor], k: int, mesh: shmap.Mesh,
                     shard_offset: Sequence) -> tuple[Tensor, Tensor]:
    """Each shard's scores f32[local_n] -> global (values, ids)[k].

    ``shard_offset[s]``: the global id of shard s's first row.  ``k``
    may exceed a shard's local length: the local top-k is clamped to it
    and padded before the all-gather merge."""
    parts = [local_topk(x, k, off) for x, off in zip(scores, shard_offset)]
    return local_candidate_merge([v for v, _ in parts],
                                 [i for _, i in parts], k, mesh)


def local_candidate_merge(values: Sequence[Tensor], ids: Sequence[Tensor],
                          k: int, mesh: shmap.Mesh
                          ) -> tuple[Tensor, Tensor]:
    """Merge the shards' candidate lists to a global top-k: the thin
    tier over any per-shard candidate extraction (a dense local top-k or
    the fused engine's per-tile candidates)."""
    return merge_topk_candidates(shmap.all_gather(mesh, values),
                                 shmap.all_gather(mesh, ids), k)


def sharded_topk(mesh: shmap.Mesh, axis: str):
    """A distributed top-k over a score vector split in S equal
    contiguous shards along ``axis`` (the reference's default
    ``P(axis)``; it takes no other spec).

    Returns make(k) -> fn(scores f32[N]) -> (values f32[k], global ids
    i32[k]); N must be a multiple of the shard count, as a ``P(axis)``
    sharding requires."""
    n_shards = mesh.shape[axis]

    def make(k: int):
        def fn(scores: Tensor):
            flat = scores.reshape(-1)
            if flat.shape[0] % n_shards:
                raise ValueError(f"{flat.shape[0]} scores do not split "
                                 f"into {n_shards} equal shards")
            local_n = flat.shape[0] // n_shards
            chunks = [flat[s * local_n:(s + 1) * local_n].to(dev)
                      for s, dev in enumerate(mesh.devices)]
            return local_topk_merge(chunks, k, mesh,
                                    [s * local_n for s in range(n_shards)])
        return fn

    return make
