"""PNA (Principal Neighbourhood Aggregation, arXiv:2004.05718): the port
of ``repro.models.gnn``.

Message passing runs on the paper's CSR insight: the adjacency IS a
posting list (node -> its in-edges' slab), and aggregation is the same
gather + reduce as query evaluation.  Three regimes, one forward:
full-batch (cora, ogbn-products), a sampled minibatch (reddit, from the
neighbour sampler of ``train.data``) and batched small graphs
(molecules, a disjoint union with a per-graph readout).

Aggregators mean / min / max / std, scalers identity / amplification /
attenuation.  The four aggregations of a layer are ONE call of
``kernels.ops.pna_multi_agg`` over the layer's edge messages: the CUDA
kernel on the card, its plain version on the CPU.  ``forward`` builds
the kernel's neighbour lists once (``build_edges``): the in-range edges
stably sorted by destination, so each node's adds run in edge order
(XLA's scatter order), and ``nbr`` [N, K] listing each node's message
rows (-1 pads), K the largest in-degree (one host read).

The reference's semantics, kept:
  * a pad edge (dst outside [0, N), e.g. src == dst == N) is dropped by
    every aggregation and by the degree; an in-range edge whose src is
    not reads the row a JAX gather would (a negative index from the end,
    then clamped);
  * relu gives +0.0 for -0.0 (``jax.nn.relu``), since the kernel's min
    and max order zeros by sign.

Differences from the reference, by design:
  * ``init_params`` draws from a ``torch.Generator`` (or a seed) on
    ``device``: the reference's shapes, scales and tree, other values;
  * messages are computed in edge chunks of ``EDGE_CHUNK`` (the
    reference concatenates ``[h[src], h[dst]]`` for every edge at once:
    37 GB at ogbn-products) and freed before the post-transform, which
    runs in node chunks of ``NODE_CHUNK``; each row's product is the
    same arithmetic;
  * the loss functions give values only (the reference's ``jax.checkpoint``
    and ``scan`` steer only its backward pass and compile size).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import segments
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init
from repro_torch.models.transformer import generator

Tensor = torch.Tensor

EDGE_CHUNK = 1 << 21      # edges whose messages are computed at once
NODE_CHUNK = 1 << 18      # nodes whose post-transform is computed at once


@dataclasses.dataclass(frozen=True)
class PnaConfig:
    name: str
    n_layers: int = 4
    d_hidden: int = 75
    d_feat: int = 1433
    n_classes: int = 16
    delta: float = 2.5          # avg log-degree normalizer (PNA eq. 5)
    eps: float = 1e-5
    # aggregators fixed: mean/min/max/std; scalers: id/amp/atten (x12)


N_AGG = 4
N_SCAL = 3


def init_params(gen, cfg: PnaConfig, device="cuda") -> dict:
    """The reference's tree: ``enc``, ``layers`` stacked over a leading
    depth axis, ``out``.  ``gen``: a ``torch.Generator`` (its device is
    used) or a seed for one on ``device``."""
    gen = generator(gen, device)
    d, L = cfg.d_hidden, cfg.n_layers
    zeros = dict(dtype=torch.float32, device=gen.device)

    def stacked(d_in, d_out):
        return torch.stack([dense_init(gen, d_in, d_out) for _ in range(L)])

    return {
        "enc": dense_init(gen, cfg.d_feat, d),
        "layers": {
            # message MLP on (h_src || h_dst)
            "w_pre": stacked(2 * d, d),
            "b_pre": torch.zeros((L, d), **zeros),
            # post-aggregation transform on (h || 12 aggregated channels)
            "w_post": stacked((N_AGG * N_SCAL + 1) * d, d),
            "b_post": torch.zeros((L, d), **zeros),
        },
        "out": dense_init(gen, d, cfg.n_classes),
    }


class Edges(NamedTuple):
    """A graph's in-range edges, ready for the PNA kernel: ``src`` and
    ``dst`` int32[E'] stably sorted by ``dst``, ``nbr`` int32[N, K] (row
    n lists node n's positions in that order, -1 pads), ``deg`` f32[N]
    (in-degree over in-range edges)."""
    src: Tensor
    dst: Tensor
    nbr: Tensor
    deg: Tensor


def build_edges(src: Tensor, dst: Tensor, num_nodes: int) -> Edges:
    """Drop every edge whose dst lies outside [0, N), sort the rest by
    dst (stable: each node keeps its edges in edge order), and list each
    node's edges in that order: one host read, of (kept edges, K)."""
    n = num_nodes
    dst = dst.long()
    ok = (dst >= 0) & (dst < n)
    key = torch.where(ok, dst, n)
    _, order = torch.sort(key, stable=True)
    counts = torch.bincount(key, minlength=n + 1)[:n]
    kept, k = (int(v) for v in torch.stack(
        [counts.sum(), counts.max() if n else counts.sum()]).tolist())
    order = order[:kept]
    s = src.long()[order]
    s = torch.where(s < 0, s + n, s).clamp(0, max(n - 1, 0))  # JAX's gather
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(k, device=dst.device)
    nbr = torch.where(slot[None, :] < counts[:, None],
                      starts[:, None] + slot[None, :], -1)
    return Edges(s.to(torch.int32), dst[order].to(torch.int32),
                 nbr.to(torch.int32), counts.float())


def relu(x: Tensor) -> Tensor:
    """``jax.nn.relu``: max(x, 0) with -0.0 -> +0.0, in place."""
    return torch.relu_(x).add_(0.0)


def messages(lp: dict, h: Tensor, edges: Edges) -> Tensor:
    """relu([h[src] || h[dst]] @ w_pre + b_pre) for every kept edge, in
    ``edges``' order: f32[E', d], computed EDGE_CHUNK edges at a time."""
    e = edges.src.shape[0]
    m = torch.empty((e, lp["w_pre"].shape[1]), dtype=h.dtype,
                    device=h.device)
    for i in range(0, e, EDGE_CHUNK):
        s = edges.src[i:i + EDGE_CHUNK].long()
        t = edges.dst[i:i + EDGE_CHUNK].long()
        m_in = torch.cat([h[s], h[t]], dim=-1)
        torch.matmul(m_in, lp["w_pre"], out=m[i:i + EDGE_CHUNK])
        del m_in
        m[i:i + EDGE_CHUNK] += lp["b_pre"]
    return relu(m)


def _post(lp: dict, h: Tensor, agg: Tensor, deg: Tensor, delta: float
          ) -> Tensor:
    logd = torch.log1p(deg)[:, None]
    s_amp = logd / delta
    s_att = delta / logd.clamp_min(1e-3)
    scaled = torch.cat([agg, agg * s_amp, agg * s_att], dim=-1)
    upd = torch.cat([h, scaled], dim=-1) @ lp["w_post"] + lp["b_post"]
    return h + relu(upd)                                       # residual


def _pna_layer(lp: dict, h: Tensor, src: Tensor, dst: Tensor, deg: Tensor,
               num_nodes: int, delta: float, eps: float,
               edges: Edges | None = None) -> Tensor:
    """One PNA layer over an edge list (padding edges: src == dst == N).
    ``edges`` (from ``build_edges`` over the same src / dst) saves
    building the neighbour lists again."""
    if edges is None:
        edges = build_edges(src, dst, num_nodes)
    m = messages(lp, h, edges)                                  # [E', d]
    agg = ops.pna_multi_agg(m, edges.nbr, eps=eps)              # [N, 4d]
    del m
    return torch.cat([_post(lp, h[i:i + NODE_CHUNK], agg[i:i + NODE_CHUNK],
                            deg[i:i + NODE_CHUNK], delta)
                      for i in range(0, num_nodes, NODE_CHUNK)]
                     or [h[:0]])


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``layers``."""
    return {k: v[i] for k, v in params["layers"].items()}


def forward(params: dict, cfg: PnaConfig, feats: Tensor, src: Tensor,
            dst: Tensor, num_nodes: int) -> Tensor:
    """feats [N, F], edge lists [E] (pad edges point at node N) -> [N, d]."""
    h = feats @ params["enc"]
    edges = build_edges(src, dst, num_nodes)
    for i in range(params["layers"]["w_pre"].shape[0]):
        h = _pna_layer(layer_params(params, i), h, src, dst, edges.deg,
                       num_nodes, cfg.delta, cfg.eps, edges)
    return h


def node_logits(params: dict, cfg: PnaConfig, feats: Tensor, src: Tensor,
                dst: Tensor, num_nodes: int) -> Tensor:
    return forward(params, cfg, feats, src, dst, num_nodes) @ params["out"]


def node_loss(params: dict, cfg: PnaConfig, batch: dict) -> Tensor:
    """Node classification CE over ``mask``-ed nodes (the value).

    batch: feats [N,F], src/dst [E], labels i32[N], mask bool[N].
    """
    n = batch["feats"].shape[0]
    logits = node_logits(params, cfg, batch["feats"], batch["src"],
                         batch["dst"], n)
    logp = F.log_softmax(logits, dim=-1)
    gold = logp.gather(-1, batch["labels"].long()[:, None])[:, 0]
    m = batch["mask"].float()
    return -(gold * m).sum() / m.sum().clamp_min(1.0)


def graph_loss(params: dict, cfg: PnaConfig, batch: dict) -> Tensor:
    """Batched small graphs: mean-readout per graph + CE (the value).

    batch: feats [N,F], src/dst [E], graph_ids i32[N], g_labels i32[G].
    """
    n = batch["feats"].shape[0]
    g = batch["g_labels"].shape[0]
    h = forward(params, cfg, batch["feats"], batch["src"], batch["dst"], n)
    pooled = segments.segment_mean(h, batch["graph_ids"], g)
    logp = F.log_softmax(pooled @ params["out"], dim=-1)
    gold = logp.gather(-1, batch["g_labels"].long()[:, None])[:, 0]
    return -gold.mean()
