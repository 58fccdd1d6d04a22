"""Config registry machinery: the port of ``repro.configs.base``'s
``ArchDef``, ``lm_active_params`` and the bodies of its recsys cells.

An ``ArchDef`` names an architecture, the function that makes its
config, ``make_config(scale, shape_id)`` ("full" or "smoke"), and its
input shapes.  The reference's recsys cells are plain functions here:
``recsys_serve_fn`` (its serve step, in user chunks) and
``recsys_retrieval_fn`` (its retrieval step), over the inputs that
``rec_serve_inputs`` lays out.  The reference's dry-run cells
(``Cell``, ``ArchDef.cell``) wait for the port's training path and
sharding rules.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tfm


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    kind: str                           # "lm" | "gnn" | "recsys"
    make_config: Callable               # (scale, shape_id) -> model config
    shapes: dict
    smoke_shapes: dict
    source: str = ""                    # provenance tag

    def shape_ids(self):
        return list(self.shapes)


def _paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict / list, paths joined by "/"."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))


def lm_active_params(params, cfg: tfm.TransformerConfig) -> int:
    """Active (per-token) parameter count of a param tree (anything with
    ``.shape`` at the leaves) — MoE counts top_k/E of its experts."""
    total = 0
    for path, leaf in _paths(params):
        n = 1
        for dim in leaf.shape:
            n *= int(dim)
        if cfg.moe is not None and "mlp" in path and "router" not in path:
            n = int(n * cfg.moe.top_k / cfg.moe.n_experts)
        total += n
    return total


# ---------------------------------------------------------------------------
# recsys cells' bodies
# ---------------------------------------------------------------------------


_REC_INIT = {
    "sasrec": rec_lib.init_sasrec,
    "bert4rec": rec_lib.init_bert4rec,
    "dien": rec_lib.init_dien,
    "xdeepfm": rec_lib.init_xdeepfm,
}
_REC_LOSS = {
    "sasrec": rec_lib.sasrec_loss,
    "bert4rec": rec_lib.bert4rec_loss,
    "dien": rec_lib.dien_loss,
    "xdeepfm": rec_lib.xdeepfm_loss,
}
_REC_USER = {
    "sasrec": rec_lib.sasrec_user_vec,
    "bert4rec": rec_lib.bert4rec_user_vec,
    "dien": rec_lib.dien_user_vec,
    "xdeepfm": rec_lib.xdeepfm_user_vec,
}


def _rec_arch(arch_id: str) -> str:
    return arch_id.split("-")[0]


def _rec_serve_inputs(arch: str, cfg, b: int) -> dict:
    """A batch of ``b`` users' serve inputs: name -> (shape, dtype)."""
    i32 = torch.int32
    if arch in ("sasrec", "bert4rec"):
        return {"hist": ((b, cfg.seq_len), i32)}
    if arch == "dien":
        return {"hist": ((b, cfg.seq_len), i32), "target": ((b,), i32)}
    shape = (b, cfg.n_fields) if cfg.n_hot == 1 else \
        (b, cfg.n_fields, cfg.n_hot)
    return {"sparse": (shape, i32)}


def serve_chunks(shape: dict) -> tuple[int, int]:
    """(chunks, users a chunk) of a serve shape: ``user_chunk`` (2,048)
    users a chunk where that divides a larger batch, else one chunk."""
    b = shape["batch"]
    uchunk = shape.get("user_chunk", 2048)
    n = b // uchunk if (b % uchunk == 0 and b > uchunk) else 1
    return n, b // n


def rec_serve_inputs(arch_id: str, cfg, shape: dict) -> dict:
    """The serve step's inputs, as the reference's cell lays them out:
    name -> (shape, dtype), each ``[chunks, users a chunk, ...]``."""
    n, ueff = serve_chunks(shape)
    return {k: ((n, ueff) + s[1:], dt) for k, (s, dt) in
            _rec_serve_inputs(_rec_arch(arch_id), cfg, shape["batch"]
                              ).items()}


def recsys_serve_fn(arch_id: str, cfg, shape: dict) -> Callable:
    """The serve step of the reference's recsys cell (its ``make_fn``):
    ``fn(params, inp)`` over ``rec_serve_inputs``' layout, one user chunk
    at a time.  SASRec and BERT4Rec score the whole item table
    (``retrieval_topk``, k = ``shape["topk"]`` or 100) and return (values,
    ids); DIEN and xDeepFM return logits.  With one chunk the outputs are
    the chunk's; with more they are stacked on a leading chunk axis, as
    ``jax.lax.map`` stacks them."""
    arch = _rec_arch(arch_id)
    n_chunks, _ = serve_chunks(shape)
    if arch in ("sasrec", "bert4rec"):
        user_fn = _REC_USER[arch]

        def one(params, sl):
            return rec_lib.retrieval_topk(
                user_fn(params, cfg, sl["hist"]), params["item_emb"],
                k=shape.get("topk", 100))
    elif arch == "dien":
        def one(params, sl):
            return rec_lib.dien_forward(params, cfg, sl["hist"],
                                        sl["target"])[0]
    else:
        def one(params, sl):
            return rec_lib.xdeepfm_logit(params, cfg, sl["sparse"])

    def fn(params, inp):
        outs = [one(params, {k: v[i] for k, v in inp.items()})
                for i in range(n_chunks)]
        if n_chunks == 1:
            return outs[0]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(x) for x in zip(*outs))
        return torch.stack(outs)
    return fn


def recsys_retrieval_fn(arch_id: str, cfg, shape: dict) -> Callable:
    """The retrieval step of the reference's recsys cell: ``fn(params,
    inp, cand)``, the arch's user vector for ``inp`` (a batch laid out by
    ``_rec_serve_inputs``) against the candidate rows ``cand`` [C, d]
    (C = ``padded_rows(shape["n_candidates"])`` in the cell) through
    ``retrieval_topk`` -> (values, ids)."""
    arch = _rec_arch(arch_id)
    user_fn = _REC_USER[arch]
    key = "sparse" if arch == "xdeepfm" else "hist"

    def fn(params, inp, cand):
        return rec_lib.retrieval_topk(user_fn(params, cfg, inp[key]), cand,
                                      k=shape.get("topk", 100))
    return fn
