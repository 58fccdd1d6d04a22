"""Fixed-arity multi-hot EmbeddingBag: the port of
``repro.kernels.embedding_bag`` (and of ``ref_embedding_bag``'s sum).

A bag of H ids (``indices`` i32[B, H], -1 = padding) sums its H rows of
``table`` [V, D].  The sum runs in slot order ``h = 0..H-1`` in the
TABLE's dtype, as the Pallas kernel's accumulator does: each add is
computed in f32 and rounded to the table's dtype (for a bf16 table, one
rounding per slot).  A padding slot adds +0.0, so a bag of padding only
sums to +0.0.

* ``embedding_bag``'s CUDA C++ kernel (``csrc/embedding_bag.cu``), which
  a CUDA tensor always goes to; there is no fallback;
* ``embedding_bag_plain``, its plain PyTorch version, the path for CPU
  tensors and the kernel's yardstick on the card.

``embedding_bag.launches`` counts the kernel's launches.  ``padded_rows``
and ``field_ids`` lay out xDeepFM's fused field table as
``repro.models.recsys`` does (rows padded to ``ROW_PAD``, field ``f``'s
ids offset by ``f * field_vocab``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_build import check_ids, check_tensors, launch

Tensor = torch.Tensor

ROW_PAD = 512      # fused embedding tables pad their rows to this multiple
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the kernel's table types


def padded_rows(n: int) -> int:
    """Rows of a fused table holding ``n`` ids, padded to ``ROW_PAD``."""
    return -(-n // ROW_PAD) * ROW_PAD


def field_ids(sparse: Tensor, field_vocab: int) -> Tensor:
    """Per-field ids i32[B, F] (or [B, F, H] multi-hot) -> rows of the
    fused table: field ``f``'s ids shifted by ``f * field_vocab``."""
    f = sparse.shape[1]
    off = torch.arange(f, dtype=torch.int32, device=sparse.device)
    off = off * field_vocab
    return sparse + (off[None, :] if sparse.dim() == 2 else off[None, :, None])


def embedding_bag_plain(table: Tensor, indices: Tensor) -> Tensor:
    """Plain PyTorch version of the bag sum: [B, D] in the table's dtype,
    the slots added in order, each add rounded to the table's dtype."""
    acc = torch.zeros((indices.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for h in range(indices.shape[1]):
        ids = indices[:, h]
        rows = table[ids.clamp_min(0).long()]
        rows = torch.where((ids >= 0)[:, None], rows, 0.0)
        acc = (acc.float() + rows.float()).to(table.dtype)
    return acc


_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature (csrc/embedding_bag.cu): table, indices, out, bags, hot, dim,
# dtype code, stream
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _P]


def _launch_embedding_bag_cuda(table: Tensor, indices: Tensor) -> Tensor:
    """Check both tensors and the ids' range, then launch the kernel."""
    name = "embedding_bag"
    if table.dtype not in DTYPES:
        raise ValueError(f"{name}: table is {table.dtype}, the kernel takes "
                         f"{sorted(map(str, DTYPES))}")
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"{name}: table [V, D] and indices [B, H] needed, "
                         f"got {tuple(table.shape)} and "
                         f"{tuple(indices.shape)}")
    bags, hot = indices.shape
    check_ids(name, "indices", indices, table.shape[0])
    check_tensors(name, table=(table, table.dtype, tuple(table.shape)),
                  indices=(indices, torch.int32, (bags, hot)))
    out = torch.empty((bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel():
        launch(name, _ARGTYPES, (table, indices, out, bags, hot,
                                 table.shape[1], DTYPES[table.dtype]),
               table.device)
    return out


def embedding_bag(table: Tensor, indices: Tensor) -> Tensor:
    """Bag sums (replaces ``embedding_bag_pallas``): table f32 or bf16
    [V, D], indices i32[B, H] (-1 = padding) -> [B, D] in the table's
    dtype.  Any B.  CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if not table.is_cuda:
        return embedding_bag_plain(table, indices)
    out = _launch_embedding_bag_cuda(table, indices)
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
