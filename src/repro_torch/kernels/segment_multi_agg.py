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
too), ``std = sqrt(var + EPS)`` correctly rounded (torch's CPU ``sqrt``
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
  whose ``[chunk, K, D]`` gather stays under ``CHUNK_BYTES``.

``pna_multi_agg.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.query import fma_f32
from repro_torch.kernels.cuda_build import (check_ids, check_tensors, entry,
                                            tensors_ok)

Tensor = torch.Tensor

CHUNK_BYTES = 1 << 30    # the plain version's gather per node chunk
EPS = 1e-5               # under std's square root (the kernel's kEps)


def _agg_chunk(feats: Tensor, nbr: Tensor) -> Tensor:
    n, k = nbr.shape
    d = feats.shape[1]
    x = feats[nbr.clamp_min(0).long()]                    # [n, K, D]
    valid = nbr >= 0
    s = torch.zeros((n, d), dtype=torch.float32, device=feats.device)
    ssq = torch.zeros_like(s)
    mn = torch.full_like(s, float("inf"))
    mx = torch.full_like(s, float("-inf"))
    cnt = torch.zeros((n, 1), dtype=torch.float32, device=feats.device)
    for h in range(k):
        ok = valid[:, h:h + 1]
        row = x[:, h]
        s = torch.where(ok, s + row, s)
        ssq = torch.where(ok, fma_f32(row, row, ssq), ssq)
        take_mn = (row < mn) | ((row == mn) & torch.signbit(row))
        take_mx = (row > mx) | ((row == mx) & ~torch.signbit(row))
        mn = torch.where(ok & take_mn, row, mn)
        mx = torch.where(ok & take_mx, row, mx)
        cnt = cnt + ok.float()
    nn = cnt.clamp_min(1.0)
    mean = s / nn
    var = fma_f32(-mean, mean, ssq / nn).clamp_min(0.0)
    std = torch.sqrt((var + EPS).double()).float()   # correctly rounded
    mn = torch.where(torch.isfinite(mn), mn, 0.0)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    return torch.cat([mean, mn, mx, std], dim=1)


def pna_multi_agg_plain(feats: Tensor, nbr: Tensor) -> Tensor:
    """Plain PyTorch version of the aggregator: f32[N, 4D]."""
    n, k = nbr.shape
    per_node = max(k * feats.shape[1] * 4, 1)
    chunk = max(CHUNK_BYTES // per_node, 1)
    return torch.cat([_agg_chunk(feats, nbr[i:i + chunk])
                      for i in range(0, n, chunk)] or
                     [feats.new_zeros((0, 4 * feats.shape[1]))])


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature (csrc/pna_multi_agg.cu): feats, nbr, out, nodes, k, dim,
# rows, stream
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _L, _P]


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


def _launch_pna_cuda(feats: Tensor, nbr: Tensor) -> Tensor:
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
            torch._C._cuda_getCurrentRawStream(dev))
        if err:
            raise RuntimeError(f"{name}: CUDA launch failed (error {err})")
    return out


def pna_multi_agg(feats: Tensor, nbr: Tensor) -> Tensor:
    """PNA's mean | min | max | std (replaces ``pna_multi_agg_pallas``):
    feats f32[Nsrc, D], nbr i32[N, K] (-1 = padding) -> f32[N, 4D].  Any
    N.  CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if not feats.is_cuda:
        return pna_multi_agg_plain(feats, nbr)
    out = _launch_pna_cuda(feats, nbr)
    pna_multi_agg.launches += 1
    return out


pna_multi_agg.launches = 0
