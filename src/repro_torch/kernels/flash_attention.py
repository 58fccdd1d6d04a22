"""Flash attention (causal and/or sliding window, GQA): the port of
``repro.kernels.flash_attention`` (and of ``ref_attention``).

q [B, Hq, S, D], k/v [B, Hkv, S, D] with Hq a multiple of Hkv -> [B,
Hq, S, D] in q's dtype.  Causal attention keeps keys ``kpos <= qpos``; a
``window`` > 0 keeps ``kpos > qpos - window``; the logits are scaled by
``D ** -0.5``.

* ``flash_attention``'s CUDA C++ kernels (``csrc/flash_attention.cu``):
  an online softmax over 64-key tiles in f32, the Pallas kernel's
  arithmetic (masked logits -1e30, their p zeroed, ``acc / max(l,
  1e-30)``), GQA through the KV-head index, for D in ``HEAD_DIMS``.  bf16
  runs on the tensor cores (``wgmma``, K and V streamed by TMA through an
  ``mbarrier`` ring; p split into two bf16 halves for the second product),
  f32 on the tensor cores too, as 3xTF32 (``mma.sync``: every operand
  split into a TF32 hi and lo, three products each; K and V through a
  ``cp.async`` ring).  A CUDA tensor always goes to them; there is no
  fallback;
* ``flash_attention_plain``, its plain PyTorch version, the path for CPU
  tensors and the kernel's yardstick on the card: the reference's
  ``ref_attention`` (K and V repeated over the group, masked logits
  -inf, softmax, NaN set to 0) in the inputs' dtype, run in query chunks
  whose ``[B, Hq, chunk, S]`` logits stay under ``CHUNK_BYTES``.

The two agree within the reference's own tolerances (2e-4 in f32, 3e-2
in bf16), not to the bit: the kernel's ``expf`` and its order of adds
differ from a softmax over whole rows.  ``flash_attention.launches``
counts the kernel's launches.

``attention_backward`` is the gradient that ``kernels.ops.attention``'s
autograd Function gives on both devices, in torch ops (the reference has
no backward kernel: it trains through XLA's autodiff of
``models.attention.chunked_attention``).  It is that function's
gradient, recomputed one query chunk at a time: no ``S x S`` matrix is
kept.  The kernel itself refuses an input that requires grad.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.cuda_build import (check_tensors, entry, launch,
                                            refuse_grad)

Tensor = torch.Tensor

HEAD_DIMS = (16, 32, 64, 128, 256)     # head widths the kernel is built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK_BYTES = 1 << 29    # the plain version's f32 logits per query chunk


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor,
                          causal: bool = True, window: int = 0) -> Tensor:
    """Plain PyTorch version (the reference's ``ref_attention``)."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    kpos = torch.arange(s, device=q.device)
    chunk = max(1, min(s, CHUNK_BYTES // max(b * hq * s * 4, 1)))
    out = []
    for c0 in range(0, s, chunk):
        qc = q[:, :, c0:c0 + chunk]
        logits = torch.einsum("bhqd,bhkd->bhqk", qc, kk) * d ** -0.5
        qpos = torch.arange(c0, c0 + qc.shape[2], device=q.device)[:, None]
        mask = torch.ones((qc.shape[2], s), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos
        if window > 0:
            mask &= kpos[None, :] > qpos - window
        p = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
        p = torch.where(torch.isnan(p), 0.0, p)
        out.append(torch.einsum("bhqk,bhkd->bhqd", p, vv))
    return torch.cat(out, dim=2)


NEG_INF = -1e30          # the reference's mask value (models.attention)
CHUNK_Q = 512            # query rows a backward chunk recomputes at once


def attention_backward(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
                       causal: bool = True, window: int = 0):
    """(dq, dk, dv) of the reference's ``chunked_attention`` at q [B, Hq,
    S, D], k [B, Hkv, S, D], v [B, Hkv, S, Dv] for the output gradient
    ``do``, in torch ops on any device.  Each chunk of ``CHUNK_Q`` query
    rows has its forward recomputed as that function computes it (f32
    scores scaled by ``D ** -0.5``, masked to ``NEG_INF``, softmax, p
    cast to v's dtype, then PV) over the keys the chunk can see, and
    differentiated by autograd; dk and dv add up over the chunks in
    f32."""
    b, hq, s, d = q.shape
    hkv, dv_w = k.shape[1], v.shape[-1]
    group = hq // hkv
    chunk = min(CHUNK_Q, s) or 1
    if s % chunk:
        chunk = math.gcd(chunk, s)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    with torch.enable_grad():
        for c0 in range(0, s, chunk):
            # keys no query of the chunk sees get no gradient: skip them
            k0 = max(c0 - window + 1, 0) if window > 0 else 0
            k1 = min(c0 + chunk, s) if causal else s
            n = k1 - k0
            qc = q[:, :, c0:c0 + chunk].detach().requires_grad_()
            kc = k[:, :, k0:k1].detach().float().requires_grad_()
            vc = v[:, :, k0:k1].detach().requires_grad_()
            scores = (qc.reshape(b, hkv, group, chunk, d).float()
                      @ kc.reshape(b, hkv, 1, n, d).transpose(-1, -2)
                      ) * d ** -0.5
            qpos = torch.arange(c0, c0 + chunk, device=q.device)[:, None]
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            m = torch.ones((chunk, n), dtype=torch.bool, device=q.device)
            if causal:
                m &= kpos <= qpos
            if window > 0:
                m &= kpos > qpos - window
            p = torch.softmax(torch.where(m, scores, NEG_INF), dim=-1)
            oc = (p.to(v.dtype) @ vc.reshape(b, hkv, 1, n, dv_w)).reshape(
                b, hq, chunk, dv_w)
            gq, gk, gv = torch.autograd.grad(
                oc, (qc, kc, vc), do[:, :, c0:c0 + chunk])
            dq[:, :, c0:c0 + chunk] = gq
            dk[:, :, k0:k1] += gk
            dv[:, :, k0:k1] += gv.float()
    return dq, dk.to(k.dtype), dv.to(v.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature (csrc/flash_attention.cu): q, k, v, o, b, hq, hkv, s, d,
# causal, window, dtype code, stream
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]


def kernel_shape(d: int, dtype: torch.dtype) -> tuple[int, int]:
    """(dynamic shared memory in bytes, threads) per CTA of the kernel
    that takes head width ``d`` and ``dtype``, as the card runs it."""
    smem, threads = ctypes.c_int(), ctypes.c_int()
    fn = entry("flash_attention", [_I, _I, ctypes.POINTER(_I),
                                   ctypes.POINTER(_I)],
               "flash_attention_shape")
    if fn(d, DTYPES[dtype], ctypes.byref(smem), ctypes.byref(threads)):
        raise ValueError(f"flash_attention: no kernel for D={d}, {dtype}")
    return smem.value, threads.value


def _launch_flash_cuda(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                       window: int) -> Tensor:
    """Check the three tensors, the head width and the head counts, then
    launch the kernel."""
    name = "flash_attention"
    refuse_grad(name, q, k, v)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q [B, Hq, S, D] and k/v [B, Hkv, S, D] "
                         f"needed, got {tuple(q.shape)}, {tuple(k.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if q.dtype not in DTYPES:
        raise ValueError(f"{name}: q is {q.dtype}, the kernel takes "
                         f"{sorted(map(str, DTYPES))}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head width {d}, the kernel is built for "
                         f"{HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{name}: Hq={hq} is not a multiple of Hkv={hkv}")
    check_tensors(name, q=(q, q.dtype, (b, hq, s, d)),
                  k=(k, q.dtype, (b, hkv, s, d)),
                  v=(v, q.dtype, (b, hkv, s, d)))
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte "
                             "boundary (vector loads and TMA need it)")
    out = torch.empty_like(q)
    if out.numel():
        launch(name, _ARGTYPES, (q, k, v, out, b, hq, hkv, s, d,
                                 int(causal), int(window), DTYPES[q.dtype]),
               q.device)
    return out


def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                    window: int = 0) -> Tensor:
    """Attention (replaces ``flash_attention_pallas``): q [B, Hq, S, D],
    k/v [B, Hkv, S, D] -> [B, Hq, S, D] in q's dtype.  Any S.  CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal, window)
    out = _launch_flash_cuda(q, k, v, causal, window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
