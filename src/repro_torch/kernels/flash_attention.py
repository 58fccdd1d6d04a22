"""Flash attention (causal and/or sliding window, GQA): the port of
``repro.kernels.flash_attention`` (and of ``ref_attention``).

q [B, Hq, S, D], k/v [B, Hkv, S, D] with Hq a multiple of Hkv -> [B,
Hq, S, D] in q's dtype.  Causal attention keeps keys ``kpos <= qpos``; a
``window`` > 0 keeps ``kpos > qpos - window``; the logits are scaled by
``D ** -0.5``.

* ``flash_attention``'s CUDA C++ kernel (``csrc/flash_attention.cu``):
  an online softmax over 64-key tiles in f32, the Pallas kernel's
  arithmetic (masked logits -1e30, their p zeroed, ``acc / max(l,
  1e-30)``), GQA through the KV-head index, for D in ``HEAD_DIMS`` and
  f32 or bf16; a CUDA tensor always goes to it; there is no fallback;
* ``flash_attention_plain``, its plain PyTorch version, the path for CPU
  tensors and the kernel's yardstick on the card: the reference's
  ``ref_attention`` (K and V repeated over the group, masked logits
  -inf, softmax, NaN set to 0) in the inputs' dtype, run in query chunks
  whose ``[B, Hq, chunk, S]`` logits stay under ``CHUNK_BYTES``.

The two agree within the reference's own tolerances (2e-4 in f32, 3e-2
in bf16), not to the bit: the kernel's ``expf`` and its order of adds
differ from a softmax over whole rows.  ``flash_attention.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_build import check_tensors, launch

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


_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature (csrc/flash_attention.cu): q, k, v, o, b, hq, hkv, s, d,
# causal, window, dtype code, stream
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]


def _launch_flash_cuda(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                       window: int) -> Tensor:
    """Check the three tensors, the head width and the head counts, then
    launch the kernel."""
    name = "flash_attention"
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
