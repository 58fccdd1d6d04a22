"""Fused PNA multi-aggregator: the port of
``repro.kernels.segment_multi_agg`` (and of ``ref_pna_multi_agg``).

Each node of ``nbr`` i32[N, K] (-1 = padding) aggregates its neighbours'
rows of ``feats`` f32[Nsrc, D] four ways, [mean | min | max | std], in
ONE pass over the neighbour list: f32[N, 4D].  The arithmetic is the
Pallas kernel's, as XLA runs it on the CPU (checked against it in
interpret mode): per valid neighbour, in list order, ``s += row``,
``ssq = fma(row, row, ssq)`` (XLA contracts ``ssq + row * row``),
``cnt += 1`` and min/max with -0.0 below +0.0; then ``n = max(cnt, 1)``,
``mean = s / n``, ``var = max(fma(-mean, mean, ssq / n), 0)`` (contracted
too), ``std = sqrt(var + eps)`` correctly rounded (torch's CPU ``sqrt``
is not always); a node with no valid neighbour gets 0 for min and max.

* ``pna_multi_agg``'s CUDA C++ kernel (``csrc/pna_multi_agg.cu``), which
  a CUDA tensor always goes to; there is no fallback.  It refuses a
  neighbour past the feature table itself: the lanes that read the list
  print the id and trap before any of its rows is read, so the launch
  fails and the next synchronising call raises.  Nothing on the launch
  path synchronises with the device.  The refusal changed form, not
  reach: the launcher used to read ``nbr.max()`` back (a sync before
  every launch) and raise a ``ValueError``; host tensors are still
  refused that way, by ``check_ids``;
* ``pna_multi_agg_plain``, its plain PyTorch version, the path for CPU
  tensors and the kernel's yardstick on the card, run in node chunks
  of ``CHUNK_BYTES`` of ``[chunk, K, D]`` neighbour rows, each slot over
  only the rows that still hold a neighbour there or past it.

``eps`` (default ``EPS``, the reference kernel's default) reaches the
kernel as a C ``float``: Python's 1e-5 rounds to the literal ``1e-5f``, so
the default gives the bits of the constant it replaced.

``pna_multi_agg.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.query import fma_f32
from repro_torch.kernels.cuda_build import (check_ids, check_tensors, entry,
                                            tensors_ok)

Tensor = torch.Tensor

CHUNK_BYTES = 1 << 30    # K x D neighbour rows of a node chunk, in bytes
EPS = 1e-5               # under std's square root, by default


def _agg_chunk(feats: Tensor, nbr: Tensor, eps: float) -> Tensor:
    """The aggregation of a chunk of nodes, slot by slot.  The rows are
    taken longest list first (by their last valid slot), so that slot h
    touches only the prefix of rows that still have a slot at h or past
    it; each row's adds are the same, in list order."""
    n, k = nbr.shape
    d = feats.shape[1]
    valid = nbr >= 0
    slot = torch.arange(k, device=nbr.device)
    last = torch.where(valid, slot, -1).amax(1) if k else \
        torch.full((n,), -1, device=nbr.device)
    order = torch.argsort(last, descending=True, stable=True)
    nbr, valid = nbr[order], valid[order]
    rows = (last[None, :] >= slot[:, None]).sum(1).tolist()   # per slot
    s = torch.zeros((n, d), dtype=torch.float32, device=feats.device)
    ssq = torch.zeros_like(s)
    mn = torch.full_like(s, float("inf"))
    mx = torch.full_like(s, float("-inf"))
    cnt = torch.zeros((n, 1), dtype=torch.float32, device=feats.device)
    for h, m in enumerate(rows):
        ok = valid[:m, h:h + 1]
        row = feats[nbr[:m, h].clamp_min(0).long()]
        s[:m] = torch.where(ok, s[:m] + row, s[:m])
        ssq[:m] = torch.where(ok, fma_f32(row, row, ssq[:m]), ssq[:m])
        take_mn = (row < mn[:m]) | ((row == mn[:m]) & torch.signbit(row))
        take_mx = (row > mx[:m]) | ((row == mx[:m]) & ~torch.signbit(row))
        mn[:m] = torch.where(ok & take_mn, row, mn[:m])
        mx[:m] = torch.where(ok & take_mx, row, mx[:m])
        cnt[:m] += ok.float()
    nn = cnt.clamp_min(1.0)
    mean = s / nn
    var = fma_f32(-mean, mean, ssq / nn).clamp_min(0.0)
    std = torch.sqrt((var + eps).double()).float()   # correctly rounded
    mn = torch.where(torch.isfinite(mn), mn, 0.0)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    out = torch.empty((n, 4 * d), dtype=torch.float32, device=feats.device)
    out[order] = torch.cat([mean, mn, mx, std], dim=1)
    return out


def pna_multi_agg_plain(feats: Tensor, nbr: Tensor,
                        eps: float = EPS) -> Tensor:
    """Plain PyTorch version of the aggregator: f32[N, 4D]."""
    n, k = nbr.shape
    per_node = max(k * feats.shape[1] * 4, 1)
    chunk = max(CHUNK_BYTES // per_node, 1)
    return torch.cat([_agg_chunk(feats, nbr[i:i + chunk], eps)
                      for i in range(0, n, chunk)] or
                     [feats.new_zeros((0, 4 * feats.shape[1]))])


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C signature (csrc/pna_multi_agg.cu): feats, nbr, out, nodes, k, dim,
# rows, eps, stream
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _L, _F, _P]


def _refuse(name: str, feats: Tensor, nbr: Tensor) -> None:
    """Raise the error that names what the kernel would misread; a
    host tensor's neighbours are checked against the table too."""
    if feats.dim() != 2 or nbr.dim() != 2:
        raise ValueError(f"{name}: feats [Nsrc, D] and nbr [N, K] needed, "
                         f"got {tuple(feats.shape)} and {tuple(nbr.shape)}")
    if not nbr.is_cuda:
        check_ids(name, "nbr", nbr, feats.shape[0])
    check_tensors(name, feats=(feats, torch.float32, tuple(feats.shape)),
                  nbr=(nbr, torch.int32, tuple(nbr.shape)))
    raise ValueError(f"{name}: feats and nbr refused")


def _launch_pna_cuda(feats: Tensor, nbr: Tensor, eps: float = EPS
                     ) -> Tensor:
    """Check both tensors in one pass, then launch the kernel, which
    checks the neighbours' range itself (nothing here synchronises); on
    a mismatch ``_refuse`` names the fault."""
    name = "pna_multi_agg"
    dev = feats.get_device()
    if not (feats.dim() == 2 and nbr.dim() == 2 and tensors_ok(dev, (
            (feats, torch.float32, feats.shape),
            (nbr, torch.int32, nbr.shape)))):
        _refuse(name, feats, nbr)
    (rows, d), (n, k) = feats.shape, nbr.shape
    out = torch.empty((n, 4 * d), dtype=torch.float32, device=feats.device)
    if out.numel():
        err = entry(name, _ARGTYPES)(
            feats.data_ptr(), nbr.data_ptr(), out.data_ptr(), n, k, d, rows,
            eps, torch._C._cuda_getCurrentRawStream(dev))
        if err:
            raise RuntimeError(f"{name}: CUDA launch failed (error {err})")
    return out


def pna_multi_agg(feats: Tensor, nbr: Tensor, eps: float = EPS) -> Tensor:
    """PNA's mean | min | max | std (replaces ``pna_multi_agg_pallas``):
    feats f32[Nsrc, D], nbr i32[N, K] (-1 = padding) -> f32[N, 4D], with
    ``eps`` under std's square root.  Any N.  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if not feats.is_cuda:
        return pna_multi_agg_plain(feats, nbr, eps)
    out = _launch_pna_cuda(feats, nbr, eps)
    pna_multi_agg.launches += 1
    return out


pna_multi_agg.launches = 0
