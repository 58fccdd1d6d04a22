"""Attention variants: the port of ``repro.models.attention``.

``chunked_attention`` (train/prefill) has two paths, chosen by a shape
rule:

  * on CUDA tensors with ``Dk == Dv`` (GQA at every LM config: head
    widths 16, 128 and 256) it is ``kernels.ops.attention``, the
    hand-written flash kernel (``csrc/flash_attention.cu``, the port of
    ``flash_attention_pallas``, which the reference names as the fast
    path validated against the same semantics).  A shape the kernel is
    not built for raises there; nothing falls back;
  * otherwise the plain chunked version, the reference's arithmetic:
    query chunks, f32 scores over every key, masked to ``NEG_INF``,
    softmax, p cast to v's dtype, then PV.  MLA's prefill
    (``Dk = nope + rope`` against ``Dv``) always takes it, on the card
    too, and launches no kernel; CPU tensors take it.

The window is a Python int per layer: the reference's traced per-layer
scalar exists only for its ``lax.scan`` over layers.

``decode_attention`` runs one new token against a [B, Hkv, S, D] cache
in plain torch (the flash kernel needs as many queries as keys); its
scores are f32 products of the cache's own dtype, as the reference's
``preferred_element_type=float32``.

MLA (DeepSeek-V2 / MiniCPM3): latent-compressed KV.  Prefill expands the
latent; decode uses the absorbed form, scoring directly against the
latent cache, so the cache holds (kv_lora + rope) values per token
instead of 2·H·D.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, cast, dense_init, rms_norm

Tensor = torch.Tensor

NEG_INF = -1e30


def _mask(qpos: Tensor, kpos: Tensor, causal: bool, window: int) -> Tensor:
    """bool [..., Sq, Sk]: key ``kp`` is visible from query ``qp``."""
    qp = qpos[..., :, None]
    kp = kpos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=qpos.device)
    if causal:
        m &= kp <= qp
    if window > 0:
        m &= kp > qp - window
    return m


def uses_kernel(q: Tensor, k: Tensor, v: Tensor) -> bool:
    """The shape rule of ``chunked_attention``: CUDA tensors whose key
    and value widths agree go to the flash kernel."""
    return q.is_cuda and k.shape[-1] == v.shape[-1]


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *,
                      causal: bool = True, window: int = 0,
                      chunk: int = 512) -> Tensor:
    """q [B,Hq,S,Dk], k [B,Hkv,S,Dk], v [B,Hkv,S,Dv] -> [B,Hq,S,Dv].

    GQA via head groups; Dk may differ from Dv (MLA), which the plain
    path takes.
    """
    if uses_kernel(q, k, v):
        return ops.attention(q, k, v, causal=causal, window=int(window))
    return chunked_attention_plain(q, k, v, causal=causal, window=window,
                                   chunk=chunk)


def chunked_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                            causal: bool = True, window: int = 0,
                            chunk: int = 512) -> Tensor:
    """The plain path of ``chunked_attention`` on any device: the
    reference's arithmetic, query chunk by query chunk."""
    b, hq, s, d = q.shape
    dv = v.shape[-1]
    hkv = k.shape[1]
    group = hq // hkv
    scale = d ** -0.5
    chunk = min(chunk, s)
    if s % chunk:
        chunk = math.gcd(chunk, s)   # the reference's rule for odd lengths
    kpos = torch.arange(s, dtype=torch.int32, device=q.device)
    kg = k.reshape(b, hkv, 1, s, d).float()
    vg = v.reshape(b, hkv, 1, s, dv)
    outs = []
    for c0 in range(0, s, chunk):
        qpos = torch.arange(c0, c0 + chunk, dtype=torch.int32,
                            device=q.device)
        qcg = q[:, :, c0:c0 + chunk].reshape(b, hkv, group, chunk, d)
        scores = (qcg.float() @ kg.transpose(-1, -2)) * scale
        m = _mask(qpos, kpos, causal, int(window))
        scores = torch.where(m, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        outs.append((p.to(v.dtype) @ vg).reshape(b, hq, chunk, dv))
    return torch.cat(outs, dim=2)


def decode_scores(qg: Tensor, k_cache: Tensor) -> Tensor:
    """f32 scores ``[B, Hkv, G, S]`` of grouped queries ``[B, Hkv, G, D]``
    against a cache ``[B, Hkv, S, D]``: the operands' products are exact
    in f32 and accumulate in f32 (a bf16 matmul would round the scores
    to bf16)."""
    return qg.float() @ k_cache.float().transpose(-1, -2)


def decode_valid(kpos: Tensor, cache_len: Tensor, window: int) -> Tensor:
    """bool [B, S]: keys at positions ``<= cache_len`` and, with a
    window, ``> cache_len - window``."""
    valid = kpos[None, :] <= cache_len[:, None]
    if window > 0:
        valid &= kpos[None, :] > cache_len[:, None] - window
    return valid


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     cache_len: Tensor, *, window: int = 0) -> Tensor:
    """q [B,Hq,1,D] vs cache [B,Hkv,S,D]; keys at positions <= cache_len
    (and, with a window, > cache_len - window)."""
    b, hq, _, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = d ** -0.5
    qg = q.reshape(b, hkv, group, d)
    scores = decode_scores(qg, k_cache) * scale
    kpos = torch.arange(s, dtype=torch.int32, device=q.device)
    valid = decode_valid(kpos, cache_len, int(window))
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = p.to(v_cache.dtype) @ v_cache
    return out.reshape(b, hq, 1, d)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


class MlaDims(NamedTuple):
    n_heads: int
    q_lora: int
    kv_lora: int
    nope: int
    rope: int
    v_dim: int


def init_mla(gen: torch.Generator, d_model: int, dims: MlaDims) -> dict:
    h, nope, rope, vd = dims.n_heads, dims.nope, dims.rope, dims.v_dim
    zeros = dict(dtype=torch.float32, device=gen.device)
    return {
        "w_dq": dense_init(gen, d_model, dims.q_lora),
        "q_norm": torch.zeros((dims.q_lora,), **zeros),
        "w_uq": dense_init(gen, dims.q_lora, h * (nope + rope)),
        "w_dkv": dense_init(gen, d_model, dims.kv_lora),
        "kv_norm": torch.zeros((dims.kv_lora,), **zeros),
        "w_ukv": dense_init(gen, dims.kv_lora, h * (nope + vd)),
        "w_kr": dense_init(gen, d_model, rope),
        "w_o": dense_init(gen, h * vd, d_model),
    }


def mla_qkv(params: dict, x: Tensor, positions: Tensor, dims: MlaDims,
            rope_base: float, dtype=torch.bfloat16):
    """Expanded (prefill/train) projections.

    Returns q [B,H,S,nope+rope], k [B,H,S,nope+rope], v [B,H,S,vd],
    plus the latent (c_kv, k_rope) pair for cache writing.
    """
    b, s, _ = x.shape
    h, nope, rope, vd = dims.n_heads, dims.nope, dims.rope, dims.v_dim
    xg = cast(x, dtype)
    cq = rms_norm(xg @ cast(params["w_dq"], dtype), params["q_norm"])
    q = (cq @ cast(params["w_uq"], dtype)).reshape(b, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope.transpose(1, 2), positions[:, None, :],
                        rope_base).transpose(1, 2)
    q = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)

    c_kv = rms_norm(xg @ cast(params["w_dkv"], dtype), params["kv_norm"])
    kv = (c_kv @ cast(params["w_ukv"], dtype)).reshape(b, s, h, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k_rope = apply_rope((xg @ cast(params["w_kr"], dtype))[:, None, :, :],
                        positions[:, None, :], rope_base)  # [B,1,S,rope]
    k = torch.cat([k_nope.transpose(1, 2),
                   k_rope.expand(b, h, s, rope)], dim=-1)
    return q, k, v.transpose(1, 2), c_kv, k_rope[:, 0]


def mla_decode(params: dict, x: Tensor, c_cache: Tensor, kr_cache: Tensor,
               cache_len: Tensor, dims: MlaDims, rope_base: float,
               dtype=torch.bfloat16) -> Tensor:
    """Absorbed-form decode: score against the LATENT cache directly.

    x [B,1,d_model]; c_cache [B,S,kv_lora]; kr_cache [B,S,rope].
    Cache already contains this step's latent at position cache_len.
    """
    b = x.shape[0]
    h, nope, rope, vd = dims.n_heads, dims.nope, dims.rope, dims.v_dim
    kv_lora = dims.kv_lora
    s = c_cache.shape[1]
    scale = (nope + rope) ** -0.5

    xg = cast(x, dtype)
    cq = rms_norm(xg @ cast(params["w_dq"], dtype), params["q_norm"])
    q = (cq @ cast(params["w_uq"], dtype)).reshape(b, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope[:, :, None, :], cache_len[:, None, None],
                        rope_base)[:, :, 0, :]

    w_ukv = params["w_ukv"].reshape(kv_lora, h, nope + vd)
    w_uk = cast(w_ukv[..., :nope], dtype)               # [kv_lora, H, nope]
    w_uv = cast(w_ukv[..., nope:], dtype)               # [kv_lora, H, vd]

    # absorb: q_eff[b,h,c] = sum_n q_nope[b,h,n] * w_uk[c,h,n]
    q_eff = torch.einsum("bhn,chn->bhc", q_nope, w_uk)
    # f32 products of the operands' dtype, accumulated in f32
    scores = decode_scores(q_eff, c_cache)
    scores = scores + decode_scores(q_rope, kr_cache)
    scores = scores * scale
    kpos = torch.arange(s, dtype=torch.int32, device=x.device)
    valid = decode_valid(kpos, cache_len, 0)
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    lat = p.to(c_cache.dtype) @ c_cache                 # [B, H, kv_lora]
    out = torch.einsum("bhc,chv->bhv", lat, w_uv).reshape(b, 1, h * vd)
    return (out @ cast(params["w_o"], dtype)).to(x.dtype)
