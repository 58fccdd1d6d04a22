"""Unified decoder-only transformer for the five LM archs: the port of
``repro.models.transformer`` (the serving path and the training loss).

One config-driven implementation provides:
  * GQA attention (+ optional per-head qk RMS-norm)      — qwen3, gemma3
  * interleaved local(sliding-window):global layers       — gemma3 (5:1),
    with per-layer RoPE bases (10k local / 1M global)       mixtral (SWA)
  * MLA latent attention (expanded prefill, absorbed decode) — minicpm3
  * mixture-of-experts SwiGLU FFN (top-k, capacity + drop) — mixtral
  * params stacked over layers under the reference's tree names, run by
    a Python loop over the layer index; chunked softmax-CE loss.

Entry points: ``loss_fn`` (tokens + labels -> mean CE, differentiable),
``prefill`` (tokens -> last-position logits + KV cache) and
``decode_step`` (one token against the cache), as functions of a plain
dict of tensors or as methods of the ``Transformer`` module.  Prefill
attention on CUDA tensors runs the flash kernel once per GQA layer
(``models.attention.chunked_attention``); decode never launches it.

Differences from the reference, by design:
  * ``init_params`` draws from a ``torch.Generator`` (or a seed) on
    ``device`` in place of a PRNG key: the reference's shapes, scales
    and dtypes, other values;
  * ``batch_axes``, ``tp_axis`` and ``decode_unroll`` steer only XLA
    and GSPMD in the reference; they are accepted and have no effect.
    ``remat`` recomputes each layer in the backward pass where autograd
    records the forward (``torch.utils.checkpoint``, the counterpart of
    the reference's ``jax.checkpoint`` of its layer body), and the loss
    recomputes each chunk's logits as the reference's checkpointed
    chunk does: the same values, less memory;
  * ``decode_step`` writes the new token's K/V into the cache tensors it
    is given and returns them (the reference returns new arrays).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import MlaDims
from repro_torch.models.layers import (apply_rope, cast, embed_init, normal,
                                       rms_norm)
from repro_torch.core import tree as _tree

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    # dispatch groups: capacity is per group, and every dispatch op stays
    # inside its group (GShard); used only where it divides the tokens
    groups: int = 1


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    attn: str = "gqa"                 # "gqa" | "mla"
    mla: MlaDims | None = None
    qk_norm: bool = False
    rope_base: float = 10_000.0
    rope_base_local: float | None = None   # local layers (gemma3: 10k)
    window: int = 0                   # sliding window (0 = full attention)
    global_every: int = 0             # every Nth layer is global (gemma3: 6)
    moe: MoeConfig | None = None
    post_norm: bool = False           # sandwich norms (gemma3)
    embed_scale: float | None = None  # sqrt(d) for gemma, 12 for minicpm3
    residual_scale: float = 1.0       # minicpm3 depth-scaled residuals
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    chunk_q: int = 512
    loss_chunk: int = 2048
    remat: bool = True                # recompute each layer in backward
    # ring (window-sized) decode cache: valid when EVERY layer is
    # windowed (mixtral SWA).  RoPE is baked into K at write time, so
    # ``slot = pos % window`` needs no remapping.
    ring_cache: bool = False
    decode_unroll: bool = False       # XLA only: no effect here
    batch_axes: tuple = ()            # GSPMD only: no effect here
    tp_axis: str = ""                 # GSPMD only: no effect here
    residual_dtype: Any = torch.float32

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim

    def layer_is_global(self) -> list[bool]:
        """Which layers use full (global) attention, one bool a layer."""
        if self.window <= 0:
            return [True] * self.n_layers
        if self.global_every <= 0:
            return [False] * self.n_layers          # all windowed
        return [(i + 1) % self.global_every == 0
                for i in range(self.n_layers)]

    def param_count(self, params=None) -> int:
        if params is None:
            return 0
        return sum(int(x.numel()) for x in tree_leaves(params))


# the leaves of a nested dict / list / tuple, and ``fn`` over them, in
# JAX's leaf order (``core.tree``)
tree_leaves = _tree.leaves
tree_map = _tree.map


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def generator(seed_or_gen, device="cuda") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed_or_gen``,
    or the generator itself.  A CUDA device without a card raises."""
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init on cuda needs a CUDA device")
    return torch.Generator(device=dev).manual_seed(int(seed_or_gen))


def _dense(gen, lead: tuple, d_in: int, d_out: int) -> Tensor:
    """``dense_init`` stacked over ``lead``: N(0, 1/d_in) [*lead, in, out]."""
    return normal(gen, (*lead, d_in, d_out), 1.0 / math.sqrt(d_in))


def init_params(gen, cfg: TransformerConfig, device="cuda") -> dict:
    """f32 master params, stacked over layers under the reference's tree
    names.  ``gen``: a ``torch.Generator`` (its device is used) or a
    seed for one on ``device``."""
    gen = generator(gen, device)
    zeros = dict(dtype=torch.float32, device=gen.device)
    L, d = cfg.n_layers, cfg.d_model
    p: dict = {"embed": embed_init(gen, cfg.vocab, d)}

    if cfg.attn == "mla":
        if cfg.mla is None:
            raise ValueError("attn='mla' needs cfg.mla")
        m = cfg.mla
        h, nope, rope, vd = m.n_heads, m.nope, m.rope, m.v_dim
        p["attn"] = {
            "w_dq": _dense(gen, (L,), d, m.q_lora),
            "q_norm": torch.zeros((L, m.q_lora), **zeros),
            "w_uq": _dense(gen, (L,), m.q_lora, h * (nope + rope)),
            "w_dkv": _dense(gen, (L,), d, m.kv_lora),
            "kv_norm": torch.zeros((L, m.kv_lora), **zeros),
            "w_ukv": _dense(gen, (L,), m.kv_lora, h * (nope + vd)),
            "w_kr": _dense(gen, (L,), d, rope),
            "w_o": _dense(gen, (L,), h * vd, d),
        }
    else:
        hd = cfg.head_dim
        p["attn"] = {
            "wq": _dense(gen, (L,), d, cfg.n_heads * hd),
            "wk": _dense(gen, (L,), d, cfg.n_kv_heads * hd),
            "wv": _dense(gen, (L,), d, cfg.n_kv_heads * hd),
            "wo": _dense(gen, (L,), cfg.n_heads * hd, d),
        }
        if cfg.qk_norm:
            p["attn"]["q_gamma"] = torch.zeros((L, hd), **zeros)
            p["attn"]["k_gamma"] = torch.zeros((L, hd), **zeros)

    if cfg.moe is None:
        p["mlp"] = {"w_gate": _dense(gen, (L,), d, cfg.d_ff),
                    "w_up": _dense(gen, (L,), d, cfg.d_ff),
                    "w_down": _dense(gen, (L,), cfg.d_ff, d)}
    else:
        e = cfg.moe.n_experts
        p["mlp"] = {"router": _dense(gen, (L,), d, e),
                    "w_gate": _dense(gen, (L, e), d, cfg.d_ff),
                    "w_up": _dense(gen, (L, e), d, cfg.d_ff),
                    "w_down": _dense(gen, (L, e), cfg.d_ff, d)}

    p["pre_attn_norm"] = torch.zeros((L, d), **zeros)
    p["pre_mlp_norm"] = torch.zeros((L, d), **zeros)
    if cfg.post_norm:
        p["post_attn_norm"] = torch.zeros((L, d), **zeros)
        p["post_mlp_norm"] = torch.zeros((L, d), **zeros)
    p["final_norm"] = torch.zeros((d,), **zeros)
    if not cfg.tie_embeddings:
        p["lm_head"] = _dense(gen, (), d, cfg.vocab)
    return p


# ---------------------------------------------------------------------------
# weights and caches carried across from the reference (numpy)
# ---------------------------------------------------------------------------


def tensor_from_numpy(arr, device="cuda") -> Tensor:
    """One array (a numpy array, or anything ``np.asarray`` takes) as a
    tensor on ``device``.  bfloat16 arrays (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses) travel by their uint16 bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr.view(np.uint16)))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(tree, device="cuda") -> dict:
    """The reference's param tree (its arrays through ``np.asarray``) as
    the port's: the same names and nesting, tensors on ``device``."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def cache_from_numpy(cache, device="cuda") -> tuple:
    """A reference cache (``(k, v)`` or MLA's ``(c_kv, k_rope)``) as the
    port's tuple of tensors on ``device``."""
    return tuple(tensor_from_numpy(a, device) for a in cache)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _gqa_qkv(prm: dict, x: Tensor, positions: Tensor, rope_base: float,
             cfg: TransformerConfig):
    b, s, _ = x.shape
    hd = cfg.head_dim
    xg = cast(x, cfg.dtype)
    q = (xg @ cast(prm["wq"], cfg.dtype)).reshape(b, s, cfg.n_heads, hd)
    k = (xg @ cast(prm["wk"], cfg.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (xg @ cast(prm["wv"], cfg.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, prm["q_gamma"])
        k = rms_norm(k, prm["k_gamma"])
    q = apply_rope(q.transpose(1, 2), positions[:, None, :], rope_base)
    k = apply_rope(k.transpose(1, 2), positions[:, None, :], rope_base)
    return q, k, v.transpose(1, 2)


def top_k_stable(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """(values, indices) of the ``k`` largest along the last axis, ties
    lowest index first (``jax.lax.top_k``'s order; ``torch.topk`` has
    none): a stable descending sort."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _moe_groups(n: int, moe: MoeConfig) -> int:
    """The dispatch's group count: ``moe.groups`` where it divides the
    ``n`` tokens, else one group."""
    return moe.groups if moe.groups > 0 and n % moe.groups == 0 else 1


def router_logits(prm: dict, x: Tensor, moe: MoeConfig, dtype) -> Tensor:
    """f32 router logits [G, N/G, E] of tokens x [N, d], as ``_moe_ffn``
    computes them: the product in ``dtype``, rounded to it, widened."""
    n, d = x.shape
    g = _moe_groups(n, moe)
    xg = cast(x, dtype).reshape(g, n // g, d)
    return torch.einsum("gnd,de->gne", xg,
                        cast(prm["router"], dtype)).float()


def _moe_ffn(prm: dict, x: Tensor, moe: MoeConfig, dtype,
             dropless: bool = False) -> Tensor:
    """Capacity-based top-k MoE with grouped (GShard) dispatch.

    x [N, d] tokens, reshaped [G, N/G, d]; capacity is per group.  Each
    token's k choices take slot ``expert * cap + rank`` (rank = its
    order among the group's tokens routed to that expert); a choice past
    capacity is dropped into one sink slot ``E * cap``, whose sum is
    discarded.  Kept slots are unique, so the scatter-add of the tokens
    gives each kept slot one token.  ``dropless`` (decode): every expert
    can hold every token.
    """
    n, d = x.shape
    e, k = moe.n_experts, moe.top_k
    g = _moe_groups(n, moe)
    ng = n // g
    cap = ng if dropless else max(int(moe.capacity_factor * ng * k / e), 1)
    xg = cast(x, dtype).reshape(g, ng, d)

    logits = router_logits(prm, x, moe, dtype)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_e = top_k_stable(probs, k)                  # [G, ng, k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # per-(group, expert) ranks via slot-sequential cumsum (no sort)
    prev = torch.zeros((g, 1, e), dtype=torch.float32, device=x.device)
    ranks = []
    for j in range(k):
        oh = F.one_hot(gate_e[..., j], e).float()
        pos = torch.cumsum(oh, dim=1) - oh + prev             # [G, ng, e]
        ranks.append((oh * pos).sum(-1))                     # [G, ng]
        prev = prev + oh.sum(dim=1, keepdim=True)
    rank = torch.stack(ranks, dim=-1).to(torch.int64)        # [G, ng, k]

    keep = rank < cap
    slot = torch.where(keep, gate_e * cap + rank, e * cap)   # [G, ng, k]

    rows = e * cap + 1
    updates = xg[:, :, None, :] * keep[..., None].to(dtype)
    flat_slot = (slot + rows * torch.arange(g, device=x.device)[:, None,
                                                                 None])
    buf = torch.zeros((g * rows, d), dtype=dtype, device=x.device)
    buf.index_add_(0, flat_slot.reshape(-1), updates.reshape(-1, d))
    buf = buf.reshape(g, rows, d)[:, :e * cap].reshape(g, e, cap, d)

    gg = torch.einsum("gecd,edf->gecf", buf, cast(prm["w_gate"], dtype))
    uu = torch.einsum("gecd,edf->gecf", buf, cast(prm["w_up"], dtype))
    hh = F.silu(gg.float()).to(dtype) * uu
    out = torch.einsum("gecf,efd->gecd", hh, cast(prm["w_down"], dtype))
    out = out.reshape(g, e * cap, d)

    safe = slot.clamp_max(e * cap - 1)
    gathered = out[torch.arange(g, device=x.device)[:, None, None], safe]
    gathered = gathered * keep[..., None].to(dtype)          # [G, ng, k, d]
    combined = (gathered * gate_w[..., None].to(dtype)).sum(dim=2)
    return combined.reshape(n, d).to(x.dtype)


def _dense_ffn(prm: dict, x: Tensor, dtype) -> Tensor:
    xg = cast(x, dtype)
    g = xg @ cast(prm["w_gate"], dtype)
    u = xg @ cast(prm["w_up"], dtype)
    h = F.silu(g.float()).to(dtype) * u
    return (h @ cast(prm["w_down"], dtype)).to(x.dtype)


def _layer_rope_window(cfg: TransformerConfig, is_global: bool):
    """(rope base, window) of a global or a local layer."""
    if is_global:
        return cfg.rope_base, 0
    return cfg.rope_base_local or cfg.rope_base, cfg.window


def _layer_fwd(cfg: TransformerConfig, x: Tensor, layer_params: dict,
               is_global: bool, positions: Tensor, want_cache: bool):
    """One transformer block (train/prefill).  x [B,S,d] -> (x, cache)."""
    b, s, d = x.shape
    rope_base, window = _layer_rope_window(cfg, is_global)

    h = rms_norm(x, layer_params["pre_attn_norm"])
    cache = None
    if cfg.attn == "mla":
        q, kk, vv, c_kv, k_rope = attn_lib.mla_qkv(
            layer_params["attn"], h, positions, cfg.mla, cfg.rope_base,
            cfg.dtype)
        o = attn_lib.chunked_attention(q, kk, vv, causal=True, window=0,
                                       chunk=cfg.chunk_q)
        o = o.transpose(1, 2).reshape(b, s, -1)
        o = (cast(o, cfg.dtype) @
             cast(layer_params["attn"]["w_o"], cfg.dtype)).to(x.dtype)
        if want_cache:
            cache = (c_kv, k_rope)
    else:
        q, kk, vv = _gqa_qkv(layer_params["attn"], h, positions, rope_base,
                             cfg)
        o = attn_lib.chunked_attention(q, kk, vv, causal=True, window=window,
                                       chunk=cfg.chunk_q)
        o = o.transpose(1, 2).reshape(b, s, -1)
        o = (cast(o, cfg.dtype) @
             cast(layer_params["attn"]["wo"], cfg.dtype)).to(x.dtype)
        if want_cache:
            cache = (kk, vv)
    if cfg.post_norm:
        o = rms_norm(o, layer_params["post_attn_norm"])
    x = x + cfg.residual_scale * o

    h = rms_norm(x, layer_params["pre_mlp_norm"])
    if cfg.moe is not None:
        f = _moe_ffn(layer_params["mlp"], h.reshape(b * s, d), cfg.moe,
                     cfg.dtype).reshape(b, s, d)
    else:
        f = _dense_ffn(layer_params["mlp"], h, cfg.dtype)
    if cfg.post_norm:
        f = rms_norm(f, layer_params["post_mlp_norm"])
    x = x + cfg.residual_scale * f
    return x, cache


_LAYER_KEYS = ("attn", "mlp", "pre_attn_norm", "pre_mlp_norm",
               "post_attn_norm", "post_mlp_norm")


def _layer_params(params: dict, cfg: TransformerConfig, i: int) -> dict:
    """Layer ``i``'s slice of the stacked per-layer params (views), by a
    plain walk of the nested dicts: a decode step takes it once a
    layer."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]

    keys = _LAYER_KEYS if cfg.post_norm else _LAYER_KEYS[:4]
    return {k: take(params[k]) for k in keys}


def _embed(params: dict, cfg: TransformerConfig, tokens: Tensor) -> Tensor:
    """The token rows in the model dtype, times ``embed_scale`` rounded
    to the model dtype first (the reference multiplies by
    ``jnp.asarray(embed_scale, dtype)``: sqrt(2560) is a bf16 value),
    then in the residual dtype.  The rows are gathered before the cast,
    which is the same elementwise cast of fewer values."""
    x = cast(params["embed"][tokens], cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.full((), cfg.embed_scale, dtype=cfg.dtype,
                           device=x.device)
    return x.to(cfg.residual_dtype)


def _cache_buffers(cfg: TransformerConfig, b: int, s: int, device):
    """Empty stacked prefill caches ``[L, ...]`` in the model dtype."""
    if cfg.attn == "mla":
        shapes = ((cfg.n_layers, b, s, cfg.mla.kv_lora),
                  (cfg.n_layers, b, s, cfg.mla.rope))
    else:
        shapes = ((cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim),) * 2
    return tuple(torch.empty(sh, dtype=cfg.dtype, device=device)
                 for sh in shapes)


def backbone(params: dict, cfg: TransformerConfig, tokens: Tensor,
             want_cache: bool = False):
    """tokens int[B,S] -> hidden [B,S,d] (+ the stacked cache
    ``[L, ...]`` in the model dtype if requested, else None)."""
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    caches = _cache_buffers(cfg, b, s, x.device) if want_cache else None
    remat = cfg.remat and not want_cache and torch.is_grad_enabled()
    for i, is_global in enumerate(cfg.layer_is_global()):
        if remat:
            x, cache = checkpoint(_layer_fwd, cfg, x,
                                  _layer_params(params, cfg, i), is_global,
                                  positions, False, use_reentrant=False)
            continue
        x, cache = _layer_fwd(cfg, x, _layer_params(params, cfg, i),
                              is_global, positions, want_cache)
        if want_cache:
            for buf, part in zip(caches, cache):
                buf[i] = part
    x = rms_norm(x, params["final_norm"])
    return x, caches


# ---------------------------------------------------------------------------
# losses / entry points
# ---------------------------------------------------------------------------


def _logits_matrix(params: dict, cfg: TransformerConfig) -> Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _xent_chunk(hc: Tensor, w_cast: Tensor, tc: Tensor, dtype) -> Tensor:
    """Summed CE of one seq chunk: f32 logits of the ``dtype`` product."""
    logits = (cast(hc, dtype) @ w_cast).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return (lse - gold).sum()


def chunked_xent(h: Tensor, w_out: Tensor, targets: Tensor, chunk: int,
                 dtype) -> Tensor:
    """Mean CE without materializing [B,S,V]: a loop over seq chunks,
    each recomputed in the backward pass where autograd records it (the
    reference checkpoints its chunk too)."""
    b, s, d = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = math.gcd(chunk, s)   # the reference's rule for odd lengths
    w_cast = cast(w_out, dtype)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        args = (h[:, c0:c0 + chunk], w_cast, targets[:, c0:c0 + chunk],
                dtype)
        if torch.is_grad_enabled() and (h.requires_grad or
                                        w_cast.requires_grad):
            tot = tot + checkpoint(_xent_chunk, *args, use_reentrant=False)
        else:
            tot = tot + _xent_chunk(*args)
    return tot / (b * s)


def loss_fn(params: dict, cfg: TransformerConfig, batch: dict) -> Tensor:
    """batch: tokens int[B,S], labels int[B,S] -> scalar CE."""
    h, _ = backbone(params, cfg, batch["tokens"], want_cache=False)
    return chunked_xent(h, _logits_matrix(params, cfg), batch["labels"],
                        cfg.loss_chunk, cfg.dtype)


class PrefillResult(NamedTuple):
    logits: Tensor      # [B, V] at the last position, f32
    cache: Any          # stacked per-layer cache
    cache_len: Tensor   # int32[B]


def _logits(params: dict, cfg: TransformerConfig, h: Tensor) -> Tensor:
    """f32 logits of hidden rows [B, d]: the bf16 product rounded to the
    model dtype first, as the reference computes them."""
    return (cast(h, cfg.dtype) @
            cast(_logits_matrix(params, cfg), cfg.dtype)).float()


def prefill(params: dict, cfg: TransformerConfig, tokens: Tensor
            ) -> PrefillResult:
    h, caches = backbone(params, cfg, tokens, want_cache=True)
    b, s = tokens.shape
    # next write position is s: pad the cache (pad_cache) before decoding.
    cache_len = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return PrefillResult(logits=_logits(params, cfg, h[:, -1, :]),
                         cache=caches, cache_len=cache_len)


def pad_cache(cache, max_len: int, cfg: TransformerConfig):
    """Grow a prefill cache [L,B,...,S,...] to ``max_len`` slots for
    decode (zeros after the prefill's positions)."""
    def grow(x, axis):
        pad = [0, 0] * (x.ndim - 1 - axis) + [0, max_len - x.shape[axis]]
        return F.pad(x, pad)
    if cfg.attn == "mla":
        c, kr = cache
        return (grow(c, 2), grow(kr, 2))            # [L,B,S,dim]
    k, v = cache
    return (grow(k, 3), grow(v, 3))                 # [L,B,Hkv,S,hd]


def cache_slots(cfg: TransformerConfig, seq: int) -> int:
    if cfg.ring_cache and cfg.window > 0 and cfg.global_every == 0:
        return min(seq, cfg.window)
    return seq


def init_cache(cfg: TransformerConfig, batch: int, seq: int,
               device="cuda") -> Any:
    """Zeroed decode cache (stacked over layers) on ``device``."""
    seq = cache_slots(cfg, seq)
    if cfg.attn == "mla":
        c = torch.zeros((cfg.n_layers, batch, seq, cfg.mla.kv_lora),
                        dtype=cfg.dtype, device=device)
        kr = torch.zeros((cfg.n_layers, batch, seq, cfg.mla.rope),
                         dtype=cfg.dtype, device=device)
        return (c, kr)
    k = torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads, seq,
                     cfg.head_dim), dtype=cfg.dtype, device=device)
    return (k, torch.zeros_like(k))


def decode_step(params: dict, cfg: TransformerConfig, cache: Any,
                tokens: Tensor, cache_len: Tensor):
    """One decode step.  tokens int[B,1]; cache holds ``seq`` slots;
    the new token's K/V is written at position ``cache_len``, into the
    cache tensors given (a ring cache at ``cache_len % slots``).

    Returns (logits [B,V], cache, cache_len + 1).
    """
    x = _embed(params, cfg, tokens[:, 0])[:, None, :]
    for i, is_global in enumerate(cfg.layer_is_global()):
        layer_cache = tuple(c[i] for c in cache)
        x = _decode_layer(cfg, x, _layer_params(params, cfg, i), is_global,
                          layer_cache, cache_len)
    x = rms_norm(x, params["final_norm"])
    return _logits(params, cfg, x[:, 0]), cache, cache_len + 1


def _decode_layer(cfg: TransformerConfig, x: Tensor, lp: dict,
                  is_global: bool, layer_cache, cache_len: Tensor):
    b = x.shape[0]
    rope_base, window = _layer_rope_window(cfg, is_global)
    bidx = torch.arange(b, device=x.device)
    pos = cache_len.long()

    h = rms_norm(x, lp["pre_attn_norm"])
    if cfg.attn == "mla":
        c_cache, kr_cache = layer_cache
        xg = cast(h[:, 0:1, :], cfg.dtype)
        c_new = rms_norm(xg @ cast(lp["attn"]["w_dkv"], cfg.dtype),
                         lp["attn"]["kv_norm"])
        kr_new = apply_rope(xg @ cast(lp["attn"]["w_kr"], cfg.dtype),
                            cache_len[:, None], cfg.rope_base)
        c_cache[bidx, pos] = c_new[:, 0].to(c_cache.dtype)
        kr_cache[bidx, pos] = kr_new[:, 0].to(kr_cache.dtype)
        o = attn_lib.mla_decode(lp["attn"], h, c_cache, kr_cache, cache_len,
                                cfg.mla, cfg.rope_base, cfg.dtype)
    else:
        k_cache, v_cache = layer_cache                    # [B,Hkv,S,hd]
        n_slots = k_cache.shape[2]
        ring = cfg.ring_cache and cfg.window > 0 and cfg.global_every == 0
        hd = cfg.head_dim
        xg = cast(h, cfg.dtype)
        q = (xg @ cast(lp["attn"]["wq"], cfg.dtype)
             ).reshape(b, 1, cfg.n_heads, hd)
        kk = (xg @ cast(lp["attn"]["wk"], cfg.dtype)
              ).reshape(b, 1, cfg.n_kv_heads, hd)
        vv = (xg @ cast(lp["attn"]["wv"], cfg.dtype)
              ).reshape(b, 1, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rms_norm(q, lp["attn"]["q_gamma"])
            kk = rms_norm(kk, lp["attn"]["k_gamma"])
        q = apply_rope(q.transpose(1, 2), cache_len[:, None, None],
                       rope_base)
        kk = apply_rope(kk.transpose(1, 2), cache_len[:, None, None],
                        rope_base)
        vv = vv.transpose(1, 2)
        slot = pos % n_slots if ring else pos
        k_cache[bidx, :, slot, :] = kk[:, :, 0, :].to(k_cache.dtype)
        v_cache[bidx, :, slot, :] = vv[:, :, 0, :].to(v_cache.dtype)
        # a ring cache holds exactly the window: plain validity masking
        # (slots <= tokens seen); a full cache uses the positional window
        o = attn_lib.decode_attention(q, k_cache, v_cache, cache_len,
                                      window=0 if ring else window)
        o = o.reshape(b, 1, -1)
        o = (cast(o, cfg.dtype) @ cast(lp["attn"]["wo"], cfg.dtype)
             ).to(x.dtype)
    if cfg.post_norm:
        o = rms_norm(o, lp["post_attn_norm"])
    x = x + cfg.residual_scale * o

    h = rms_norm(x, lp["pre_mlp_norm"])
    if cfg.moe is not None:
        f = _moe_ffn(lp["mlp"], h.reshape(b, -1), cfg.moe, cfg.dtype,
                     dropless=True).reshape(b, 1, -1)
    else:
        f = _dense_ffn(lp["mlp"], h, cfg.dtype)
    if cfg.post_norm:
        f = rms_norm(f, lp["post_mlp_norm"])
    return x + cfg.residual_scale * f


# ---------------------------------------------------------------------------
# module wrapper
# ---------------------------------------------------------------------------


class Transformer(nn.Module):
    """The model as an ``nn.Module``: the stacked tensors of
    ``init_params`` (or of ``params``) registered as parameters under
    the reference's names (``embed``, ``attn.wq``, ``mlp.w_gate``,
    ``pre_attn_norm``, ...), with ``prefill`` / ``decode_step`` /
    ``init_cache`` methods.  A serving module: its parameters need no
    gradient."""

    def __init__(self, cfg: TransformerConfig, params: dict | None = None,
                 seed=0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(seed, cfg, device)
        for name, value in params.items():
            if isinstance(value, dict):
                self.add_module(name, nn.ParameterDict(
                    {k: nn.Parameter(t, requires_grad=False)
                     for k, t in value.items()}))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def params(self) -> dict:
        """The parameters as the functions' plain dict (the same
        tensors)."""
        out = {}
        for name, child in self.named_children():
            out[name] = {k: t for k, t in child.items()}
        for name, t in self.named_parameters(recurse=False):
            out[name] = t
        return out

    @torch.no_grad()
    def prefill(self, tokens: Tensor) -> PrefillResult:
        return prefill(self.params(), self.cfg, tokens)

    @torch.no_grad()
    def decode_step(self, cache, tokens: Tensor, cache_len: Tensor):
        return decode_step(self.params(), self.cfg, cache, tokens,
                           cache_len)
