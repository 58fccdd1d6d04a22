"""Top-k merge of candidate lists: the single-process core of
``repro.distributed.topk``.

Each source (a doc tile of the fused engine, later a shard or a
segment) keeps a local candidate list; the global answer is the top-k of
the concatenated lists.  Ties break on the EARLIEST candidate, like
``jax.lax.top_k``: with sources ordered by ascending doc id, that is the
lowest doc id, bit-identical to a dense top-k.  The merge is a stable
descending sort — never ``torch.topk``, whose tie order differs.
"""
from __future__ import annotations

import numpy as np
import torch

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
