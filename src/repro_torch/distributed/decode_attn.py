"""Explicit split-K (flash-decoding style) distributed decode attention:
the port of ``repro.distributed.decode_attn``.

Each shard of the mesh computes attention over its slice of the cache's
sequence axis with a local max and sum; the combine is log-sum-exp
merging: ``shmap.pmax`` of the shards' maxima, each shard's numerator
and denominator rescaled by ``exp(m - max)``, then ``shmap.psum`` of
both in shard order.  The wire cost is O(B·H·D) per step whatever the
sequence length.  On one card the S shard programs run in turn.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import shmap
from repro_torch.distributed.shmap import Mesh
from repro_torch.models import attention

Tensor = torch.Tensor


def _local_partial(q: Tensor, k_loc: Tensor, v_loc: Tensor, kpos: Tensor,
                   cache_len: Tensor, window: int):
    """Per-shard partial attention in f32: returns (m, num, den)."""
    b, hq, _, d = q.shape
    hkv = k_loc.shape[1]
    group = hq // hkv
    scale = d ** -0.5
    qg = q.reshape(b, hkv, group, d)
    s = attention.decode_scores(qg, k_loc) * scale
    valid = attention.decode_valid(kpos, cache_len, window)[:, None, None, :]
    s = torch.where(valid, s, attention.NEG_INF)
    m = s.amax(dim=-1)                                       # [b,hkv,g]
    p = torch.exp(s - m[..., None])
    p = torch.where(valid, p, 0.0)
    den = p.sum(dim=-1)                                      # [b,hkv,g]
    num = p @ v_loc.float()                                  # [b,hkv,g,d]
    return m, num, den


def splitk_decode_attention(mesh: Mesh, axis: str):
    """Build fn(q [B,Hq,1,D], k_cache/v_cache [B,Hkv,S,D] split over the
    mesh's shards along S, cache_len int[B], window) -> [B,Hq,1,D] on
    the mesh's first device.  S must be a multiple of the shard count,
    as the reference's sharding requires."""
    n = mesh.size
    shmap.check_axis(mesh, axis, n)

    def fn(q, k_cache, v_cache, cache_len, window: int = 0):
        seq = k_cache.shape[2]
        if seq % n:
            raise ValueError(f"cache length {seq} does not split over "
                             f"{n} shards of axis {axis!r}")
        local = seq // n
        per_shard = [(k_cache[:, :, s * local:(s + 1) * local].to(dev),
                      v_cache[:, :, s * local:(s + 1) * local].to(dev))
                     for s, dev in enumerate(mesh.devices)]

        def partial(idx, kv, qq, cl):
            kpos = idx * local + torch.arange(local, dtype=torch.int32,
                                              device=qq.device)
            return _local_partial(qq, *kv, kpos, cl, int(window))

        parts = shmap.run(mesh, partial, per_shard, q, cache_len)
        g_m = shmap.pmax(mesh, [m for m, _, _ in parts])
        nums, dens = [], []
        for (m, num, den), dev in zip(parts, mesh.devices):
            corr = torch.exp(m - g_m.to(dev))
            nums.append(num * corr[..., None])
            dens.append(den * corr)
        g_num = shmap.psum(mesh, nums)
        g_den = shmap.psum(mesh, dens)
        out = g_num / g_den.clamp_min(1e-30)[..., None]
        b, hkv, group, d = out.shape
        return out.reshape(b, hkv * group, 1, d)

    return fn
