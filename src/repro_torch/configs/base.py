"""Config/registry machinery: ``ArchDef`` and the dry run's ``Cell``
builders; the port of ``repro.configs.base``.

A **Cell** = (architecture x input shape) -> one concrete step:
  train_*     -> full train step (fwd + bwd + AdamW update)
  prefill_*   -> prefill (logits + KV cache)
  decode_*/long_* -> one decode step against a seq_len cache
  serve_*     -> batched scoring (``recsys_serve_fn``, in user chunks)
  retrieval_* -> two-tower candidate scoring + top-k
                 (``recsys_retrieval_fn``)

Cells carry abstract args and a sharding builder, so the dry run can
size every cell on the production meshes without allocating anything.
``make_config(scale, shape_id)`` is "full" or "smoke".

Differences from the reference, by design:
  * abstract args are tensors on the ``meta`` device (shape and dtype,
    no storage), in place of ``jax.ShapeDtypeStruct``; abstract params
    come from each model's own ``init_params`` drawing from a generator
    that reports the ``meta`` device, so no full-scale tree is ever
    made (Mixtral-8x22B's f32 params are over 500 GB);
  * ``fn`` is the port's own step, plain eager PyTorch: nothing is
    compiled, and ``donate`` is kept for the bytes bookkeeping only
    (nothing is donated at run time);
  * ``make_shardings(mesh)`` takes a ``shmap.NamedMesh`` and gives
    ``launch.sharding.NamedSharding`` trees.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.launch import sharding as shard_lib
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt_lib


def sds(shape, dtype) -> torch.Tensor:
    """An abstract array: a ``meta`` tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class Cell:
    arch_id: str
    shape_id: str
    kind: str
    fn: Callable
    abstract_args: tuple
    donate: tuple
    make_shardings: Callable            # mesh -> tuple matching args
    meta: dict
    make_out_shardings: Callable | None = None   # mesh -> out tree or None


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

    def cell(self, shape_id: str, scale: str = "full",
             mesh_axes: tuple = ()) -> Cell:
        """``mesh_axes``: axis names of the target mesh (they set the
        config's ``batch_axes`` / ``tp_axis``, and an MoE config's
        dispatch groups, as the reference's)."""
        shp = (self.shapes if scale == "full" else
               self.smoke_shapes)[shape_id]
        cfg = self.make_config(scale, shape_id)
        if self.kind == "lm":
            if mesh_axes:
                batch_axes = tuple(a for a in ("pod", "data")
                                   if a in mesh_axes)
                cfg = dataclasses.replace(
                    cfg, batch_axes=batch_axes,
                    tp_axis="model" if "model" in mesh_axes else "")
                if cfg.moe is not None:
                    # dispatch groups == dp shards (16 or 32); decode
                    # steps route only `batch` tokens
                    dp = 16 * (2 if "pod" in mesh_axes else 1)
                    tokens = shp["batch"] * (
                        shp["seq"] if shp["step"] in ("train", "prefill")
                        else 1)
                    if tokens % dp == 0:
                        cfg = dataclasses.replace(
                            cfg, moe=dataclasses.replace(cfg.moe,
                                                         groups=dp))
            return _lm_cell(self.arch_id, cfg, shape_id, shp)
        if self.kind == "gnn":
            return _gnn_cell(self.arch_id, cfg, shape_id, shp)
        if mesh_axes:
            cfg = dataclasses.replace(
                cfg,
                batch_axes=tuple(a for a in ("pod", "data")
                                 if a in mesh_axes),
                tp_axis="model" if "model" in mesh_axes else "")
        return _recsys_cell(self.arch_id, cfg, shape_id, shp)


OPT_CFG = opt_lib.AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: an init
    function run with it builds its tree's shapes and dtypes only."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _params_abstract(init_fn):
    return init_fn(_MetaGenerator())


def _n_elems(t) -> int:
    return sum(int(np.prod(x.shape)) for x in tree.leaves(t))


def _bf16_abstract(t):
    """Serving reads bf16 weights (args + HBM traffic halve)."""
    return tree.map(lambda x: sds(x.shape, torch.bfloat16)
                    if x.dtype.is_floating_point else x, t)


def _paths(t, prefix=""):
    """(path, leaf) pairs of a nested dict / list, paths joined by "/"."""
    if isinstance(t, dict):
        items = t.items()
    elif isinstance(t, (list, tuple)):
        items = enumerate(t)
    else:
        yield prefix, t
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
# LM cells
# ---------------------------------------------------------------------------


def _lm_cell(arch_id: str, cfg: tfm.TransformerConfig, shape_id: str,
             shp: dict) -> Cell:
    p_abs = _params_abstract(lambda g: tfm.init_params(g, cfg))
    n_active = lm_active_params(p_abs, cfg)
    n_total = _n_elems(p_abs)
    b, s = shp["batch"], shp["seq"]
    if shp["step"] in ("prefill", "decode"):
        p_abs = _bf16_abstract(p_abs)

    if shp["step"] == "train":
        # parallelism policy: models under ~2B params don't use tensor
        # parallelism — both non-pod axes become FSDP/data (see
        # launch/sharding.lm_small_param_spec).
        small = n_total < 2_000_000_000
        if small and cfg.batch_axes:
            cfg = dataclasses.replace(cfg, tp_axis="",
                                      batch_axes=("data", "model"))
        opt_abs = opt_lib.init(p_abs)
        batch_abs = {"tokens": sds((b, s), torch.int32),
                     "labels": sds((b, s), torch.int32)}
        step = opt_lib.make_train_step(
            lambda p, bb: tfm.loss_fn(p, cfg, bb), OPT_CFG,
            microbatches=shp.get("microbatches", 1))
        pspec = (shard_lib.lm_small_param_spec if small
                 else shard_lib.lm_param_spec)
        bspec = (shard_lib.lm_small_batch_spec if small
                 else shard_lib.batch_spec)

        def mk_sh(mesh):
            psh = shard_lib.named(p_abs, mesh, pspec)
            osh = shard_lib.named(opt_abs, mesh, pspec)
            bsh = shard_lib.named(batch_abs, mesh, bspec)
            return (psh, osh, bsh)

        return Cell(arch_id, shape_id, "train", step,
                    (p_abs, opt_abs, batch_abs), (0, 1), mk_sh,
                    {"model_flops": 6.0 * n_active * b * s,
                     "n_params": n_total, "n_active": n_active,
                     "tokens": b * s})

    if shp["step"] == "prefill":
        tokens_abs = sds((b, s), torch.int32)
        fn = functools.partial(_lm_prefill, cfg)

        def mk_sh(mesh):
            psh = shard_lib.named(p_abs, mesh, shard_lib.lm_param_spec)
            tsh = shard_lib.named(tokens_abs, mesh, shard_lib.batch_spec)
            return (psh, tsh)

        # the prefill's output, abstract: last-position f32 logits, the
        # stacked caches, the cache lengths
        out_abs = tfm.PrefillResult(
            logits=sds((b, cfg.vocab), torch.float32),
            cache=tfm._cache_buffers(cfg, b, s, "meta"),
            cache_len=sds((b,), torch.int32))

        def mk_out(mesh):
            # the prefill KV cache [L,B,H,S,hd] (or MLA [L,B,S,c]) leaves
            # the step sequence-sharded over "model"

            def one(path, leaf):
                if len(leaf.shape) >= 4:     # a cache leaf
                    return shard_lib.named_from_specs(
                        shard_lib.kv_cache_spec(
                            leaf.shape, mesh, batch_idx=1,
                            seq_idx=2 if cfg.attn == "mla" else 3), mesh)
                return shard_lib.named_from_specs(
                    shard_lib.batch_spec(path, leaf, mesh), mesh)
            return tree.map_with_path(one, out_abs)

        return Cell(arch_id, shape_id, "prefill", fn, (p_abs, tokens_abs),
                    (), mk_sh,
                    {"model_flops": 2.0 * n_active * b * s,
                     "n_params": n_total, "n_active": n_active,
                     "tokens": b * s}, mk_out)

    # decode (decode_32k / long_500k): one token against a seq-len cache
    cache_abs = tfm.init_cache(cfg, b, s, device="meta")
    tokens_abs = sds((b, 1), torch.int32)
    clen_abs = sds((b,), torch.int32)
    fn = functools.partial(_lm_decode, cfg)

    def mk_sh(mesh):
        psh = shard_lib.named(p_abs, mesh, shard_lib.lm_param_spec)
        csh = tree.map(
            lambda leaf: shard_lib.named_from_specs(
                shard_lib.kv_cache_spec(
                    leaf.shape, mesh, batch_idx=1,
                    seq_idx=2 if cfg.attn == "mla" else 3), mesh),
            cache_abs)
        tsh = shard_lib.named(tokens_abs, mesh, shard_lib.batch_spec)
        lsh = shard_lib.named(clen_abs, mesh, shard_lib.batch_spec)
        return (psh, csh, tsh, lsh)

    cache_bytes = sum(int(np.prod(x.shape)) * x.element_size()
                      for x in tree.leaves(cache_abs))
    return Cell(arch_id, shape_id, "decode", fn,
                (p_abs, cache_abs, tokens_abs, clen_abs), (1,), mk_sh,
                {"model_flops": 2.0 * n_active * b,
                 "n_params": n_total, "n_active": n_active, "tokens": b,
                 "cache_bytes": cache_bytes})


def _lm_prefill(cfg, params, tokens):
    return tfm.prefill(params, cfg, tokens)


def _lm_decode(cfg, params, cache, tokens, cache_len):
    return tfm.decode_step(params, cfg, cache, tokens, cache_len)


# ---------------------------------------------------------------------------
# GNN cells (all four shapes are training steps)
# ---------------------------------------------------------------------------


def _gnn_cell(arch_id: str, cfg: gnn_lib.PnaConfig, shape_id: str,
              shp: dict) -> Cell:
    p_abs = _params_abstract(lambda g: gnn_lib.init_params(g, cfg))
    n_total = _n_elems(p_abs)
    opt_abs = opt_lib.init(p_abs)
    n, e = shp["n_nodes"], shp["n_edges"]
    i32 = torch.int32
    if shp.get("graph_level"):
        batch_abs = {"feats": sds((n, cfg.d_feat), torch.float32),
                     "src": sds((e,), i32), "dst": sds((e,), i32),
                     "graph_ids": sds((n,), i32),
                     "g_labels": sds((shp["n_graphs"],), i32)}
        loss = lambda p, bb: gnn_lib.graph_loss(p, cfg, bb)   # noqa: E731
    else:
        batch_abs = {"feats": sds((n, cfg.d_feat), torch.float32),
                     "src": sds((e,), i32), "dst": sds((e,), i32),
                     "labels": sds((n,), i32),
                     "mask": sds((n,), torch.bool)}
        loss = lambda p, bb: gnn_lib.node_loss(p, cfg, bb)    # noqa: E731
    step = opt_lib.make_train_step(loss, OPT_CFG)

    def mk_sh(mesh):
        psh = shard_lib.named(p_abs, mesh, shard_lib.gnn_param_spec)
        osh = shard_lib.named(opt_abs, mesh, shard_lib.gnn_param_spec)
        bsh = shard_lib.named(batch_abs, mesh, shard_lib.gnn_batch_spec)
        return (psh, osh, bsh)

    # message-passing flops: ~ E * (2d*d pretrans) + N * posttrans
    d = cfg.d_hidden
    mp_flops = cfg.n_layers * (2 * e * 2 * d * d +
                               2 * n * (13 * d) * d) * 3   # fwd+bwd
    return Cell(arch_id, shape_id, "train", step,
                (p_abs, opt_abs, batch_abs), (0, 1), mk_sh,
                {"model_flops": float(mp_flops), "n_params": n_total,
                 "tokens": n})


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


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------


def _rec_batch_abs(arch: str, cfg, b: int) -> dict:
    i32 = torch.int32
    if arch == "sasrec":
        s = cfg.seq_len
        return {"hist": sds((b, s), i32), "pos": sds((b, s), i32),
                "neg": sds((b, s, cfg.n_negatives), i32)}
    if arch == "bert4rec":
        s = cfg.seq_len
        return {"hist": sds((b, s), i32), "targets": sds((b, s), i32),
                "neg": sds((b, s, cfg.n_negatives), i32)}
    if arch == "dien":
        s = cfg.seq_len
        return {"hist": sds((b, s), i32), "target": sds((b,), i32),
                "label": sds((b,), torch.float32),
                "aux_neg": sds((b, s), i32)}
    s = cfg.n_fields
    shape = (b, s) if cfg.n_hot == 1 else (b, s, cfg.n_hot)
    return {"sparse": sds(shape, i32), "label": sds((b,), torch.float32)}


def _chunk_spec(path, leaf, mesh):
    return shard_lib.P(None, shard_lib._dp(mesh),
                       *([None] * (len(leaf.shape) - 2)))


def _recsys_cell(arch_id: str, cfg, shape_id: str, shp: dict) -> Cell:
    arch = _rec_arch(arch_id)
    init_fn = _REC_INIT[arch]
    p_abs = _params_abstract(lambda g: init_fn(g, cfg))
    n_total = _n_elems(p_abs)
    b = shp["batch"]

    if shp["step"] == "train":
        opt_abs = opt_lib.init(p_abs)
        batch_abs = _rec_batch_abs(arch, cfg, b)
        loss_fn = _REC_LOSS[arch]
        step = opt_lib.make_train_step(
            lambda p, bb: loss_fn(p, cfg, bb), OPT_CFG)

        def mk_sh(mesh):
            return (shard_lib.named(p_abs, mesh,
                                    shard_lib.recsys_param_spec),
                    shard_lib.named(opt_abs, mesh,
                                    shard_lib.recsys_param_spec),
                    shard_lib.named(batch_abs, mesh, shard_lib.batch_spec))

        # dense tower flops dominate; embedding gathers dominate bytes
        return Cell(arch_id, shape_id, "train", step,
                    (p_abs, opt_abs, batch_abs), (0, 1), mk_sh,
                    {"model_flops": 6.0 * _rec_dense_params(arch, cfg) * b,
                     "n_params": n_total, "tokens": b})

    if shp["step"] == "serve":
        # big offline batches stream through the encoder tower in user
        # chunks: [n_chunks, uchunk, ...], uchunk data-sharded; serving
        # params are replicated
        n_chunks, _ = serve_chunks(shp)
        inp_abs = {k: sds(sh, dt) for k, (sh, dt) in
                   rec_serve_inputs(arch_id, cfg, shp).items()}
        fn = recsys_serve_fn(arch_id, cfg, shp)

        def mk_sh(mesh):
            return (shard_lib.named(p_abs, mesh,
                                    shard_lib.recsys_serve_param_spec),
                    shard_lib.named(inp_abs, mesh, _chunk_spec))

        def mk_out(mesh):
            # the outputs' shapes: one chunk's on meta, stacked n_chunks
            # deep as the chunks' outputs are
            _, ueff = serve_chunks(shp)
            one = recsys_serve_fn(arch_id, cfg, dict(shp, batch=ueff))(
                p_abs, {k: v[:1] for k, v in inp_abs.items()})
            lead = (n_chunks,) if n_chunks > 1 else ()
            out_abs = tree.map(lambda x: sds(lead + tuple(x.shape), x.dtype),
                               one)
            return tree.map(
                lambda x: shard_lib.named_from_specs(
                    _chunk_spec(None, x, mesh)
                    if len(x.shape) >= 2 and n_chunks > 1
                    else shard_lib.batch_spec(None, x, mesh), mesh),
                out_abs)

        retrieval_flops = (2.0 * b * rec_lib.padded_rows(cfg.n_items) *
                           cfg.embed_dim
                           if arch in ("sasrec", "bert4rec") else 0.0)
        return Cell(arch_id, shape_id, "serve", fn, (p_abs, inp_abs), (),
                    mk_sh,
                    {"model_flops": 2.0 * _rec_dense_params(arch, cfg) * b
                     + retrieval_flops,
                     "n_params": n_total, "tokens": b}, mk_out)

    # retrieval_cand: one query vs n_candidates (batched dot + top-k)
    n_cand = rec_lib.padded_rows(shp["n_candidates"])
    d = cfg.embed_dim
    inp_abs = {k: sds(sh, dt) for k, (sh, dt) in
               _rec_serve_inputs(arch, cfg, b).items()}
    cand_abs = sds((n_cand, d), torch.float32)
    fn = recsys_retrieval_fn(arch_id, cfg, shp)

    def mk_sh(mesh):
        model = "model" if "model" in mesh.axis_names else None
        return (shard_lib.named(p_abs, mesh,
                                shard_lib.recsys_serve_param_spec),
                shard_lib.named(inp_abs, mesh, shard_lib.batch_spec),
                shard_lib.NamedSharding(mesh, shard_lib.P(model, None)))

    return Cell(arch_id, shape_id, "retrieval", fn,
                (p_abs, inp_abs, cand_abs), (), mk_sh,
                {"model_flops": 2.0 * n_cand * d * b,
                 "n_params": n_total, "tokens": b * n_cand})


def _rec_dense_params(arch: str, cfg) -> int:
    """Parameters touched per example (excludes embedding tables)."""
    if arch == "sasrec":
        return cfg.n_blocks * 6 * cfg.embed_dim ** 2 + \
            cfg.seq_len * cfg.embed_dim
    if arch == "bert4rec":
        return cfg.n_blocks * 6 * cfg.embed_dim ** 2 + \
            cfg.seq_len * cfg.embed_dim
    if arch == "dien":
        g, d = cfg.gru_dim, cfg.embed_dim
        m = (g + 2 * d) * cfg.mlp_dims[0] + \
            cfg.mlp_dims[0] * cfg.mlp_dims[1] + cfg.mlp_dims[1]
        return 2 * 3 * (d * g + g * g) * cfg.seq_len // max(cfg.seq_len, 1) \
            * cfg.seq_len + m
    # xdeepfm: CIN + DNN
    f, d = cfg.n_fields, cfg.embed_dim
    h_prev, cin = f, 0
    for hk in cfg.cin_layers:
        cin += h_prev * f * hk * d
        h_prev = hk
    dnn = f * d * cfg.mlp_dims[0] + cfg.mlp_dims[0] * cfg.mlp_dims[1]
    return cin // max(d, 1) + dnn
