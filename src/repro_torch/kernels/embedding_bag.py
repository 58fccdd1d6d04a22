"""Fixed-arity multi-hot EmbeddingBag: the port of
``repro.kernels.embedding_bag`` (and of ``ref_embedding_bag``'s sum).

A bag of H ids (``indices`` i32[B, H], -1 = padding) sums its H rows of
``table`` [V, D].  The sum runs in slot order ``h = 0..H-1`` in the
TABLE's dtype, as the Pallas kernel's accumulator does: each add is
computed in f32 and rounded to the table's dtype (for a bf16 table, one
rounding per slot).  A padding slot adds +0.0, so a bag of padding only
sums to +0.0.

* ``embedding_bag``'s CUDA C++ kernel (``csrc/embedding_bag.cu``), which
  a CUDA tensor always goes to; there is no fallback.  It refuses an id
  past the table itself: the thread that reads one prints it and traps
  before reading the row, so the launch fails and the next synchronising
  call raises.  Nothing on the launch path synchronises with the device.
  The refusal changed form, not reach: the launcher used to read
  ``indices.max()`` back (a sync before every launch) and raise a
  ``ValueError``; host tensors are still refused that way, by
  ``check_ids``;
* ``embedding_bag_plain``, its plain PyTorch version, the path for CPU
  tensors and the kernel's yardstick on the card.

``mode="mean"`` (``ref_embedding_bag``'s mean) divides the bag sum by
``max(valid slots, 1)`` in the table's dtype: the kernel's sum on the
card, the plain sum on the CPU; the kernel itself only sums.

``embedding_bag.launches`` counts the kernel's launches.  ``padded_rows``
and ``field_ids`` lay out xDeepFM's fused field table as
``repro.models.recsys`` does (rows padded to ``ROW_PAD``, field ``f``'s
ids offset by ``f * field_vocab``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_build import (check_ids, check_tensors, entry,
                                            tensors_ok)

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


MODES = ("sum", "mean")


def _bag_mean(total: Tensor, indices: Tensor) -> Tensor:
    """A bag sum over ``max(valid slots, 1)``, in the sum's dtype."""
    n = (indices >= 0).sum(dim=1, keepdim=True).to(total.dtype)
    return total / n.clamp_min(1.0)


def embedding_bag_plain(table: Tensor, indices: Tensor,
                        mode: str = "sum") -> Tensor:
    """Plain PyTorch version of the bag sum: [B, D] in the table's dtype,
    the slots added in order, each add rounded to the table's dtype;
    ``mode="mean"`` divides it by the bag's valid slots."""
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode {mode!r}, not one of {MODES}")
    acc = torch.zeros((indices.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for h in range(indices.shape[1]):
        ids = indices[:, h]
        rows = table[ids.clamp_min(0).long()]
        rows = torch.where((ids >= 0)[:, None], rows, 0.0)
        acc = (acc.float() + rows.float()).to(table.dtype)
    return _bag_mean(acc, indices) if mode == "mean" else acc


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature (csrc/embedding_bag.cu): table, indices, out, bags, hot, dim,
# rows, dtype code, stream
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _L, _I, _P]
# output elements the kernel indexes with 32-bit ints, less a CTA's reach
OUT_LIMIT = 2**31 - 2**15


def _refuse(name: str, table: Tensor, indices: Tensor) -> None:
    """Raise the error that names what the kernel would misread; a
    host tensor's ids are checked against the table too."""
    if table.dtype not in DTYPES:
        raise ValueError(f"{name}: table is {table.dtype}, the kernel takes "
                         f"{sorted(map(str, DTYPES))}")
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"{name}: table [V, D] and indices [B, H] needed, "
                         f"got {tuple(table.shape)} and "
                         f"{tuple(indices.shape)}")
    if not indices.is_cuda:
        check_ids(name, "indices", indices, table.shape[0])
    check_tensors(name, table=(table, table.dtype, tuple(table.shape)),
                  indices=(indices, torch.int32, tuple(indices.shape)))
    raise ValueError(f"{name}: table and indices refused")


def _launch_embedding_bag_cuda(table: Tensor, indices: Tensor) -> Tensor:
    """Check both tensors in one pass, then launch the kernel, which
    checks the ids' range itself (nothing here synchronises); on a
    mismatch ``_refuse`` names the fault."""
    name = "embedding_bag"
    dev = table.get_device()
    if not (table.dtype in DTYPES and table.dim() == 2
            and indices.dim() == 2 and tensors_ok(dev, (
                (table, table.dtype, table.shape),
                (indices, torch.int32, indices.shape)))):
        _refuse(name, table, indices)
    (rows, dim), (bags, hot) = table.shape, indices.shape
    if bags * dim >= OUT_LIMIT:
        raise ValueError(f"{name}: a [{bags}, {dim}] output reaches "
                         f"2^31 - 2^15 elements, past the kernel's 32-bit "
                         f"indexing; split the batch")
    out = torch.empty((bags, dim), dtype=table.dtype, device=table.device)
    if out.numel():
        err = entry(name, _ARGTYPES)(
            table.data_ptr(), indices.data_ptr(), out.data_ptr(), bags, hot,
            dim, rows, DTYPES[table.dtype],
            torch._C._cuda_getCurrentRawStream(dev))
        if err:
            raise RuntimeError(f"{name}: CUDA launch failed (error {err})")
    return out


def embedding_bag(table: Tensor, indices: Tensor, mode: str = "sum"
                  ) -> Tensor:
    """Bag sums (replaces ``embedding_bag_pallas``), or means with
    ``mode="mean"``: table f32 or bf16 [V, D], indices i32[B, H] (-1 =
    padding) -> [B, D] in the table's dtype.  On the card, B x D stays
    below ``OUT_LIMIT`` (a larger batch is refused with a
    ``ValueError``).  CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    if not table.is_cuda:
        return embedding_bag_plain(table, indices, mode)
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode {mode!r}, not one of {MODES}")
    out = _launch_embedding_bag_cuda(table, indices)
    embedding_bag.launches += 1
    return _bag_mean(out, indices) if mode == "mean" else out


embedding_bag.launches = 0
