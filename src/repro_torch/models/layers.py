"""Shared neural building blocks: the port of ``repro.models.layers``.

Conventions, as the reference's:
  * params are nested dicts of tensors; ``init_*`` builds them from an
    explicit ``torch.Generator`` (in place of a PRNG key) on the
    generator's device, and the apply functions are pure;
  * master params are f32; matmuls run in a compute dtype (bf16 on the
    card) through ``cast`` at the use sites, and norms and rotary
    embeddings compute in f32 and cast back.

Initial values follow the reference's shapes, scales and dtypes, not its
random draws.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def normal(gen: torch.Generator, shape, scale: float,
           dtype=torch.float32) -> Tensor:
    """``scale`` times a standard normal draw of ``shape`` from ``gen``,
    on ``gen``'s device."""
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=dtype) * scale


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, dtype=torch.float32) -> Tensor:
    s = scale if scale is not None else (1.0 / math.sqrt(d_in))
    return normal(gen, (d_in, d_out), s, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> Tensor:
    return normal(gen, (vocab, d), 0.02, dtype)


def cast(x: Tensor, dtype) -> Tensor:
    return x.to(dtype) if x.dtype != dtype else x


def rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-6) -> Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + gamma)`` in f32, cast back."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def layer_norm(x: Tensor, gamma: Tensor, beta: Tensor,
               eps: float = 1e-6) -> Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * gamma.float() + beta.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, base: float, device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(base), exps)      # [D/2], f32


def apply_rope(x: Tensor, positions: Tensor, base: float = 10_000.0
               ) -> Tensor:
    """x [..., S, D] (D even), positions [..., S] -> rotated x: the
    rotate-half form (the first and second halves of D are the pairs),
    in f32, cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, base, x.device)                      # [D/2]
    angles = positions[..., None].float() * freqs              # [..., S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int) -> dict:
    return {"w_gate": dense_init(gen, d_model, d_ff),
            "w_up": dense_init(gen, d_model, d_ff),
            "w_down": dense_init(gen, d_ff, d_model)}


def swiglu(params: dict, x: Tensor, dtype=torch.bfloat16) -> Tensor:
    xg = cast(x, dtype)
    g = xg @ cast(params["w_gate"], dtype)
    u = xg @ cast(params["w_up"], dtype)
    h = F.silu(g.float()).to(dtype) * u
    return (h @ cast(params["w_down"], dtype)).to(x.dtype)


def init_mlp(gen: torch.Generator, sizes: Sequence[int],
             bias: bool = True) -> dict:
    layers = []
    for i in range(len(sizes) - 1):
        layer = {"w": dense_init(gen, sizes[i], sizes[i + 1])}
        if bias:
            layer["b"] = torch.zeros((sizes[i + 1],), dtype=torch.float32,
                                     device=gen.device)
        layers.append(layer)
    return {"layers": layers}


def mlp(params: dict, x: Tensor, act=torch.relu, final_act: bool = False,
        dtype=torch.float32) -> Tensor:
    n = len(params["layers"])
    h = cast(x, dtype)
    for i, layer in enumerate(params["layers"]):
        h = h @ cast(layer["w"], dtype)
        if "b" in layer:
            h = h + cast(layer["b"], dtype)
        if i < n - 1 or final_act:
            h = act(h)
    return h


# ---------------------------------------------------------------------------
# GRU / AUGRU (DIEN)
# ---------------------------------------------------------------------------


def init_gru(gen: torch.Generator, d_in: int, d_hidden: int) -> dict:
    return {"w_x": dense_init(gen, d_in, 3 * d_hidden),
            "w_h": dense_init(gen, d_hidden, 3 * d_hidden),
            "b": torch.zeros((3 * d_hidden,), dtype=torch.float32,
                             device=gen.device)}


def gru_cell(params: dict, h: Tensor, x: Tensor,
             att: Tensor | None = None) -> Tensor:
    """One GRU step; ``att`` (AUGRU) scales the update gate (DIEN §4.3)."""
    d = h.shape[-1]
    gates = x @ params["w_x"][:, :2 * d] + h @ params["w_h"][:, :2 * d] + \
        params["b"][:2 * d]
    r, z = gates.chunk(2, dim=-1)
    r = torch.sigmoid(r)
    z = torch.sigmoid(z)
    # candidate: n = tanh(W_nx x + (r * h) W_nh + b_n)
    n = torch.tanh(x @ params["w_x"][:, 2 * d:] +
                   (r * h) @ params["w_h"][:, 2 * d:] + params["b"][2 * d:])
    if att is not None:
        z = z * att[..., None]
    return (1.0 - z) * n + z * h


def gru_scan(params: dict, xs: Tensor, h0: Tensor,
             atts: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """xs [B, S, d_in] -> (final h [B, d], all h [B, S, d])."""
    h, hs = h0, []
    for t in range(xs.shape[1]):
        h = gru_cell(params, h, xs[:, t],
                     None if atts is None else atts[:, t])
        hs.append(h)
    return h, torch.stack(hs, dim=1)
