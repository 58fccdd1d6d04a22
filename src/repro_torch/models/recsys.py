"""Recsys architectures: SASRec, BERT4Rec, DIEN, xDeepFM — the port of
``repro.models.recsys`` (serving, and the losses with their gradients).

The embedding layer is where the paper's layout insight lands: item
histories and multi-hot features are bags over huge tables.  xDeepFM's
field lookups go through ``kernels.ops.embedding_bag`` (the bag kernel on
the card, its plain version on the CPU): the one-hot path as bags of one
(``tables[ids]`` in the reference), the multi-hot path as bags of
``n_hot`` (the reference's ragged ``segments.embedding_bag`` over evenly
spaced offsets).  A bag sums from +0.0, so a -0.0 table entry comes back
as +0.0: equal in value to the reference's gather.  SASRec's and
BERT4Rec's attention and DIEN's GRUs stay plain torch, as the reference
computes them in XLA.

Four shapes per arch (``configs``): train_batch (the loss), serve_p99 /
serve_bulk (full-model scoring) and retrieval_cand (two-tower scoring of
1M candidates + top-k).  ``retrieval_topk`` over more rows than
``chunk`` is the reference's bucketed, approximate top-k: one winner per
bucket, then an exact ``iterative_topk`` over the winners.

The reference's semantics, kept: ties go to the lowest index (``top_k``
and ``argmax``); masks are -1e30, so a history of padding only
softmaxes uniformly; ``jax.nn.gelu`` is the tanh approximation; a
gather ``x[ids]`` reads as a JAX gather does (a negative id from the
end, then clamped).

Differences from the reference, by design:
  * ``init_*`` draw from a ``torch.Generator`` (or a seed) on ``device``:
    the reference's shapes, scales, dtypes and tree (stacked ``blocks``
    keep their depth axis, xDeepFM's ``cin`` stays a list), other values;
  * ``batch_axes`` and ``tp_axis`` steer only GSPMD in the reference;
    they are accepted and have no effect (``retrieval_topk`` over at most
    ``chunk`` rows always takes the exact stable top-k);
  * ``sampled_softmax_loss`` runs its sequence chunks as a Python loop;
    autograd keeps each chunk's gathered negatives (the reference's
    ``jax.checkpoint`` recomputes them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.segments import jax_take
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import (ROW_PAD,  # noqa: F401
                                               field_ids, padded_rows)
from repro_torch.models.layers import (dense_init, embed_init, gru_scan,
                                       init_gru, init_mlp, layer_norm, mlp)
from repro_torch.models.transformer import generator, top_k_stable

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# shared: sampled softmax + two-tower retrieval scoring
# ---------------------------------------------------------------------------


def _sampled_softmax_chunk(user_vec, pos_ids, neg_ids, table, valid):
    pos_e = jax_take(table, pos_ids)                    # [..., d]
    neg_e = jax_take(table, neg_ids)                    # [..., K, d]
    pos_l = (user_vec * pos_e).sum(-1, keepdim=True)    # [..., 1]
    neg_l = torch.einsum("...d,...kd->...k", user_vec, neg_e)
    logits = torch.cat([pos_l, neg_l], dim=-1)
    loss = -F.log_softmax(logits, dim=-1)[..., 0]
    w = valid.float()
    return (loss * w).sum(), w.sum()


def sampled_softmax_loss(user_vec: Tensor, pos_ids: Tensor, neg_ids: Tensor,
                         table: Tensor, valid: Tensor | None = None,
                         seq_chunk: int = 8) -> Tensor:
    """CE against [pos | sampled negs].  user_vec [B,d] (or [B,S,d]),
    pos_ids [B]([B,S]), neg_ids [B,K]([B,S,K]).

    Sequence inputs are taken ``seq_chunk`` positions at a time, so the
    [B,S,K,d] negative-embedding gather is never materialized.
    """
    if valid is None:
        valid = torch.ones(pos_ids.shape, dtype=torch.bool,
                           device=pos_ids.device)
    if pos_ids.dim() == 1:
        num, den = _sampled_softmax_chunk(user_vec, pos_ids, neg_ids, table,
                                          valid)
        return num / den.clamp_min(1.0)
    s = pos_ids.shape[1]
    chunk = min(seq_chunk, s)
    if s % chunk:
        chunk = math.gcd(chunk, s)
    num = torch.zeros((), device=user_vec.device)
    den = torch.zeros((), device=user_vec.device)
    for i in range(0, s, chunk):
        dn, dd = _sampled_softmax_chunk(
            user_vec[:, i:i + chunk], pos_ids[:, i:i + chunk],
            neg_ids[:, i:i + chunk], table, valid[:, i:i + chunk])
        num, den = num + dn, den + dd
    return num / den.clamp_min(1.0)


def iterative_topk(scores: Tensor, k: int):
    """Exact top-k WITHOUT sort: k rounds of (max, argmax, mask), as the
    reference's; ``argmax`` takes the first (lowest-index) maximum."""
    m = scores.shape[-1]
    iota = torch.arange(m, device=scores.device)
    sc = scores
    vals, ids = [], []
    for _ in range(k):
        v = sc.amax(dim=-1)
        a = sc.argmax(dim=-1)
        sc = torch.where(iota == a[..., None], float("-inf"), sc)
        vals.append(v)
        ids.append(a.to(torch.int32))
    return torch.stack(vals, dim=-1), torch.stack(ids, dim=-1)


def retrieval_layout(c: int, k: int, chunk: int) -> dict:
    """The bucketed scheme's geometry over ``c`` rows: ``n`` slabs of
    ``chunk`` rows (the first chunk size near the asked one that divides
    ``c``), ``kb`` buckets of ``width`` rows a slab, the last bucket
    padded by ``pad`` rows."""
    n = -(-c // chunk)
    chunk = c // n
    while c % chunk:
        n += 1
        chunk = c // n
    n = c // chunk
    kb = min(k, chunk)
    width = -(-chunk // kb)
    return {"n": n, "chunk": chunk, "kb": kb, "width": width,
            "pad": kb * width - chunk}


def retrieval_topk(user_vec: Tensor, cand_table: Tensor, k: int = 100,
                   chunk: int = 8192, batch_axes: tuple = (),
                   tp_axis: str = ""):
    """Score [B] queries against C candidate rows: batched dot + top-k.

    Up to ``chunk`` rows: one dot and the exact top-k (ties lowest id
    first).  More: the reference's sort-free two phases -- each slab of
    rows keeps its ``kb`` bucket maxima (one winner per bucket), then one
    exact ``iterative_topk`` over all the winners.  Bucketed, so
    approximate overall; recall@k is tested.
    """
    c = cand_table.shape[0]
    if c <= chunk:
        return top_k_stable((user_vec @ cand_table.T).float(), k)
    g = retrieval_layout(c, k, chunk)
    n, chunk, kb, width, pad = (g[x] for x in ("n", "chunk", "kb", "width",
                                                "pad"))
    slabs = cand_table.reshape(n, chunk, cand_table.shape[-1])
    base = torch.arange(kb, device=user_vec.device) * width
    vs, ids = [], []
    for ci in range(n):
        sc = (user_vec @ slabs[ci].T).float()           # [..., chunk]
        scp = F.pad(sc, (0, pad), value=float("-inf"))
        b = scp.reshape(sc.shape[:-1] + (kb, width))
        vs.append(b.amax(dim=-1))                       # [..., kb]
        ids.append((ci * chunk + base + b.argmax(dim=-1)).to(torch.int32))
    flat_v = torch.cat(vs, dim=-1)                      # [..., n*kb]
    flat_i = torch.cat(ids, dim=-1)
    topv, sel = iterative_topk(flat_v, k)
    return topv, flat_i.gather(-1, sel.long())


# ---------------------------------------------------------------------------
# SASRec (arXiv:1808.09781)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SasRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    n_negatives: int = 128
    dtype: Any = torch.float32
    # GSPMD activation annotations in the reference; no effect here
    batch_axes: tuple = ()
    tp_axis: str = ""


def init_sasrec(gen, cfg: SasRecConfig, device="cuda") -> dict:
    gen = generator(gen, device)
    d, L = cfg.embed_dim, cfg.n_blocks
    ones = dict(dtype=torch.float32, device=gen.device)

    def stacked():
        return torch.stack([dense_init(gen, d, d) for _ in range(L)])

    return {
        "item_emb": embed_init(gen, padded_rows(cfg.n_items), d),
        "pos_emb": embed_init(gen, cfg.seq_len, d),
        "blocks": {
            "wq": stacked(), "wk": stacked(), "wv": stacked(),
            "wo": stacked(), "w1": stacked(), "w2": stacked(),
            "ln1_g": torch.ones((L, d), **ones),
            "ln1_b": torch.zeros((L, d), **ones),
            "ln2_g": torch.ones((L, d), **ones),
            "ln2_b": torch.zeros((L, d), **ones),
        },
    }


def _blocks(params: dict):
    """Each block's slice of the stacked ``blocks``, in depth order."""
    blocks = params["blocks"]
    depth = next(iter(blocks.values())).shape[0]
    return [{k: v[i] for k, v in blocks.items()} for i in range(depth)]


def _heads(x: Tensor, n_heads: int) -> Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)


def _attend(sc: Tensor, vh: Tensor) -> Tensor:
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vh)
    b, h, s, hd = o.shape
    return o.transpose(1, 2).reshape(b, s, h * hd)


def _causal_attn(q, k, v, n_heads):
    s, hd = q.shape[1], q.shape[2] // n_heads
    qh, kh, vh = (_heads(x, n_heads) for x in (q, k, v))
    sc = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / (hd ** 0.5)
    m = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    return _attend(torch.where(m, sc, -1e30), vh)


def _embed_history(params: dict, hist: Tensor):
    s = hist.shape[1]
    h = jax_take(params["item_emb"], hist) + params["pos_emb"][None, :s]
    pad = (hist == 0)[..., None]
    return torch.where(pad, 0.0, h), pad


def sasrec_hidden(params: dict, cfg: SasRecConfig, hist: Tensor) -> Tensor:
    """hist i32[B,S] (0 = padding item) -> hidden [B,S,d]."""
    h, pad = _embed_history(params, hist)
    for blk in _blocks(params):
        hn = layer_norm(h, blk["ln1_g"], blk["ln1_b"])
        a = _causal_attn(hn @ blk["wq"], hn @ blk["wk"], hn @ blk["wv"],
                         cfg.n_heads) @ blk["wo"]
        h = h + a
        hn = layer_norm(h, blk["ln2_g"], blk["ln2_b"])
        h = h + torch.relu(hn @ blk["w1"]) @ blk["w2"]
        h = torch.where(pad, 0.0, h)
    return h


def sasrec_loss(params: dict, cfg: SasRecConfig, batch: dict) -> Tensor:
    """batch: hist [B,S], pos [B,S] (next item), neg [B,S,K]."""
    h = sasrec_hidden(params, cfg, batch["hist"])
    valid = batch["pos"] != 0
    return sampled_softmax_loss(h, batch["pos"], batch["neg"],
                                params["item_emb"], valid)


def sasrec_user_vec(params: dict, cfg: SasRecConfig, hist: Tensor) -> Tensor:
    return sasrec_hidden(params, cfg, hist)[:, -1, :]


# ---------------------------------------------------------------------------
# BERT4Rec (arXiv:1904.06690)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    n_negatives: int = 128
    dtype: Any = torch.float32
    # GSPMD activation annotations in the reference; no effect here
    batch_axes: tuple = ()
    tp_axis: str = ""


def init_bert4rec(gen, cfg: Bert4RecConfig, device="cuda") -> dict:
    sas = SasRecConfig(n_items=cfg.n_items + 1,  # +1: [MASK] token
                       embed_dim=cfg.embed_dim, n_blocks=cfg.n_blocks,
                       n_heads=cfg.n_heads, seq_len=cfg.seq_len)
    return init_sasrec(gen, sas, device)    # init pads rows (padded_rows)


def bert4rec_hidden(params: dict, cfg: Bert4RecConfig, hist: Tensor
                    ) -> Tensor:
    """Bidirectional encoder (no causal mask; padding keys masked)."""
    h, pad = _embed_history(params, hist)
    hd = cfg.embed_dim // cfg.n_heads
    for blk in _blocks(params):
        hn = layer_norm(h, blk["ln1_g"], blk["ln1_b"])
        qh, kh, vh = (_heads(hn @ blk[w], cfg.n_heads)
                      for w in ("wq", "wk", "wv"))
        sc = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / (hd ** 0.5)
        sc = torch.where(pad[:, None, None, :, 0], -1e30, sc)
        h = h + _attend(sc, vh) @ blk["wo"]
        hn = layer_norm(h, blk["ln2_g"], blk["ln2_b"])
        h = h + F.gelu(hn @ blk["w1"], approximate="tanh") @ blk["w2"]
    return h


def bert4rec_loss(params: dict, cfg: Bert4RecConfig, batch: dict) -> Tensor:
    """Cloze objective: batch hist has [MASK]=n_items at masked slots;
    targets [B,S] hold the true item there (0 elsewhere); neg [B,S,K]."""
    h = bert4rec_hidden(params, cfg, batch["hist"])
    valid = batch["targets"] != 0
    return sampled_softmax_loss(h, batch["targets"], batch["neg"],
                                params["item_emb"], valid)


def bert4rec_user_vec(params: dict, cfg: Bert4RecConfig,
                      hist: Tensor) -> Tensor:
    """Serve path: [MASK] appended at the last position scores next item."""
    return bert4rec_hidden(params, cfg, hist)[:, -1, :]


# ---------------------------------------------------------------------------
# DIEN (arXiv:1809.03672)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DienConfig:
    name: str = "dien"
    n_items: int = 1_000_000
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: tuple = (200, 80)
    n_negatives: int = 8
    use_aux_loss: bool = True
    dtype: Any = torch.float32
    # GSPMD activation annotations in the reference; no effect here
    batch_axes: tuple = ()
    tp_axis: str = ""


def init_dien(gen, cfg: DienConfig, device="cuda") -> dict:
    gen = generator(gen, device)
    d, g = cfg.embed_dim, cfg.gru_dim
    return {
        "item_emb": embed_init(gen, padded_rows(cfg.n_items), d),
        "gru1": init_gru(gen, d, g),
        "gru2": init_gru(gen, g, g),           # AUGRU (att-gated)
        "att_w": dense_init(gen, g + d, 1),
        "aux_w": dense_init(gen, g, d),
        "mlp": init_mlp(gen, (g + 2 * d,) + tuple(cfg.mlp_dims) + (1,)),
    }


def dien_forward(params: dict, cfg: DienConfig, hist: Tensor,
                 target: Tensor):
    """hist i32[B,S], target i32[B] -> (logit [B], interest states,
    history embeddings)."""
    b, s = hist.shape
    e = jax_take(params["item_emb"], hist)                 # [B,S,d]
    t_e = jax_take(params["item_emb"], target)             # [B,d]
    h0 = torch.zeros((b, cfg.gru_dim), dtype=torch.float32,
                     device=hist.device)
    _, states = gru_scan(params["gru1"], e, h0)            # [B,S,g]
    att_in = torch.cat([states, t_e[:, None].expand(b, s, cfg.embed_dim)],
                       dim=-1)
    att = torch.softmax((att_in @ params["att_w"])[..., 0] +
                        torch.where(hist == 0, -1e30, 0.0), dim=-1)
    final, _ = gru_scan(params["gru2"], states, h0, atts=att)
    feats = torch.cat([final, t_e, (e * att[..., None]).sum(1)], dim=-1)
    logit = mlp(params["mlp"], feats)[:, 0]
    return logit, states, e


def _bce(logit: Tensor, label: Tensor) -> Tensor:
    return -(label * F.logsigmoid(logit) +
             (1 - label) * F.logsigmoid(-logit)).mean()


def dien_loss(params: dict, cfg: DienConfig, batch: dict) -> Tensor:
    """batch: hist [B,S], target [B], label f32[B], aux_neg [B,S]."""
    logit, states, e = dien_forward(params, cfg, batch["hist"],
                                    batch["target"])
    loss = _bce(logit, batch["label"])
    if cfg.use_aux_loss and "aux_neg" in batch:
        # auxiliary loss (DIEN §4.2): h_t should predict e_{t+1} vs a neg
        h_proj = states[:, :-1] @ params["aux_w"]          # [B,S-1,d]
        pos_e = e[:, 1:]
        neg_e = jax_take(params["item_emb"], batch["aux_neg"][:, 1:])
        valid = (batch["hist"][:, 1:] != 0).float()
        pos_l = F.logsigmoid((h_proj * pos_e).sum(-1))
        neg_l = F.logsigmoid(-(h_proj * neg_e).sum(-1))
        aux = -((pos_l + neg_l) * valid).sum() / valid.sum().clamp_min(1.)
        loss = loss + aux
    return loss


def dien_user_vec(params: dict, cfg: DienConfig, hist: Tensor) -> Tensor:
    b = hist.shape[0]
    e = jax_take(params["item_emb"], hist)
    h0 = torch.zeros((b, cfg.gru_dim), dtype=torch.float32,
                     device=hist.device)
    _, states = gru_scan(params["gru1"], e, h0)
    return states[:, -1] @ params["aux_w"]                 # project to d


# ---------------------------------------------------------------------------
# xDeepFM (arXiv:1803.05170)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class XDeepFmConfig:
    name: str = "xdeepfm"
    n_fields: int = 39
    field_vocab: int = 1_000_000
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp_dims: tuple = (400, 400)
    n_hot: int = 1              # multi-hot arity (>1 -> EmbeddingBag path)
    dtype: Any = torch.float32
    # GSPMD activation annotations in the reference; no effect here
    batch_axes: tuple = ()
    tp_axis: str = ""


def init_xdeepfm(gen, cfg: XDeepFmConfig, device="cuda") -> dict:
    gen = generator(gen, device)
    f, v, d = cfg.n_fields, cfg.field_vocab, cfg.embed_dim
    rows = padded_rows(f * v)
    tables = embed_init(gen, rows, d)                      # [F*V, d] fused
    cin_ws, h_prev = [], f
    for hk in cfg.cin_layers:
        cin_ws.append(dense_init(gen, h_prev * f, hk))     # [Hk-1*F, Hk]
        h_prev = hk
    return {
        "tables": tables,
        "linear": torch.zeros((rows,), dtype=torch.float32,
                              device=gen.device),          # 1st-order term
        "cin": cin_ws,
        "mlp": init_mlp(gen, (f * d,) + tuple(cfg.mlp_dims) + (1,)),
        "cin_out": dense_init(gen, sum(cfg.cin_layers), 1),
        "bias": torch.zeros((), dtype=torch.float32, device=gen.device),
    }


def _xdeepfm_embed(params: dict, cfg: XDeepFmConfig, sparse: Tensor
                   ) -> tuple:
    """sparse i32[B, F] (or [B, F, H] multi-hot) -> e [B,F,d], linear [B]:
    each field's ids are bags (of one, or of ``n_hot``) over the fused
    table, summed by ``ops.embedding_bag``."""
    b, f = sparse.shape[:2]
    ids = field_ids(sparse.to(torch.int32), cfg.field_vocab)
    e = ops.embedding_bag(params["tables"], ids.reshape(b * f, -1))
    lin = jax_take(params["linear"], ids).reshape(b, -1).sum(-1)
    return e.reshape(b, f, -1), lin


def xdeepfm_logit(params: dict, cfg: XDeepFmConfig, sparse: Tensor
                  ) -> Tensor:
    e, lin = _xdeepfm_embed(params, cfg, sparse)           # [B,F,d]
    b, f, d = e.shape
    # CIN: x^{k+1}_h = sum_ij W^k_{ij,h} (x^k_i * x^0_j)
    xk, pooled = e, []
    for w in params["cin"]:
        z = torch.einsum("bid,bjd->bijd", xk, e).reshape(b, -1, d)
        xk = torch.einsum("bpd,ph->bhd", z, w)             # [B,Hk+1,d]
        del z
        pooled.append(xk.sum(-1))                          # [B,Hk+1]
    cin_term = (torch.cat(pooled, dim=-1) @ params["cin_out"])[:, 0]
    dnn_term = mlp(params["mlp"], e.reshape(b, f * d))[:, 0]
    return lin + cin_term + dnn_term + params["bias"]


def xdeepfm_loss(params: dict, cfg: XDeepFmConfig, batch: dict) -> Tensor:
    logit = xdeepfm_logit(params, cfg, batch["sparse"])
    return _bce(logit, batch["label"])


def xdeepfm_user_vec(params: dict, cfg: XDeepFmConfig,
                     sparse: Tensor) -> Tensor:
    """Two-tower retrieval head: mean field embedding as the user vector."""
    e, _ = _xdeepfm_embed(params, cfg, sparse)
    return e.mean(dim=1)
