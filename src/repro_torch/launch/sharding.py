"""Partition-spec policy: (tree, mesh, cell kind) -> PartitionSpecs; the
port of ``repro.launch.sharding``, with the same rules and thresholds.

Rules (DESIGN.md §4):
  * batch dims shard over ("pod","data");
  * tensor-model parallelism over "model": attention heads / d_ff /
    vocab / expert-ffn columns;
  * FSDP: the d_model ("embed") dimension of big weights shards over
    "data", so optimizer state is fully sharded (ZeRO) for free;
  * decode KV caches: batch over data when divisible, sequence over
    "model" (and over everything for batch=1 long-context) -> split-K
    decode attention;
  * small leaves (norms, biases, scalars) replicate.

Specs are FUNCTIONS of (tree, mesh) — never baked into checkpoints —
which is what makes elastic restart (train/elastic.py) work.  They read
only ``mesh.axis_names`` and ``mesh.shape``, and a leaf's ``shape``, and
decide by its path string (``_path_str``: dict keys, list indices and
``.field`` for a NamedTuple field, joined by "/", as JAX's key paths
print).

What stands in for JAX here (in ``distributed.shmap``, beside the
mesh, and imported here):
  * ``PartitionSpec``: a tuple of ``None``, an axis name or a tuple of
    axis names per dimension, normalised as JAX's (a one-name tuple is
    the name, an empty one ``None``);
  * ``NamedSharding(mesh, spec)`` refuses an axis the mesh lacks and an
    axis used twice, as JAX's does; ``shard_shape`` pads an uneven
    dimension up (``ceil``), as GSPMD pads it (JAX's own ``shard_shape``
    refuses one);
  * ``place(tensor, sharding)``, the counterpart of ``jax.device_put``:
    a ``ShardedTensor``, one piece per slot of the mesh on the slot's
    device (refusing an uneven split, as ``device_put`` does), which
    ``gather`` reassembles.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.distributed.shmap import (  # noqa: F401
    NamedSharding, P, PartitionSpec, ShardedTensor, gather, place)

Tensor = torch.Tensor

MIN_SHARD_SIZE = 1 << 14       # leaves smaller than 16Ki elems replicate


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _size(leaf) -> int:
    return int(np.prod(leaf.shape))


def _axis(mesh, name: str):
    return name if name in mesh.axis_names else None


def _dp(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _all(mesh):
    return tuple(mesh.axis_names)


# ---------------------------------------------------------------------------
# LM parameter specs
# ---------------------------------------------------------------------------


def lm_param_spec(path, leaf, mesh) -> P:
    s = _path_str(path)
    nd = len(leaf.shape)
    model = _axis(mesh, "model")
    data = _axis(mesh, "data")
    if _size(leaf) < MIN_SHARD_SIZE:
        return P()
    if "embed" in s:                                   # [V, d]
        # vocab on model ONLY: sharding d on data as well puts the tied
        # embedding's gradient contraction and the data-sharded batch on
        # the same axis
        return P(model, None)
    if "lm_head" in s:                                 # [d, V]
        return P(None, model)
    if "attn" in s:
        if "wq" in s:                                  # [L, d, Hq*hd]
            return P(None, data, model)
        if any(k in s for k in ("wk", "wv")):          # [L, d, Hkv*hd]
            # KV heads (8) don't divide the model axis (16): FSDP over
            # data only, replicated over model (Megatron GQA)
            return P(None, data, None)
        if "wo" in s or "w_o" in s:                    # [L, H*hd, d]
            return P(None, model, data)
        if any(k in s for k in ("w_dq", "w_dkv", "w_kr")):
            return P(None, data, None)                 # [L, d, lora]
        if any(k in s for k in ("w_uq", "w_ukv")):     # [L, lora, H*x]
            return P(None, None, model)
        return P()                                     # norms/gammas
    if "mlp" in s:
        if "router" in s:                              # [L, d, E]
            return P(None, data, None)
        if "w_down" in s:
            if nd == 4:                                # moe [L, E, ff, d]
                return P(None, None, model, data)
            return P(None, model, data)                # [L, ff, d]
        if any(k in s for k in ("w_gate", "w_up")):
            if nd == 4:                                # moe [L, E, d, ff]
                return P(None, None, data, model)
            return P(None, data, model)                # [L, d, ff]
    return P()


# ---------------------------------------------------------------------------
# other param families
# ---------------------------------------------------------------------------


def gnn_param_spec(path, leaf, mesh) -> P:
    return P()     # PNA params are tiny; replicate


def recsys_param_spec(path, leaf, mesh) -> P:
    """Embedding tables shard rows over "model" ONLY: batch-sharded
    lookups against a model-sharded table stay local along the data
    axis."""
    s = _path_str(path)
    model = _axis(mesh, "model")
    if _size(leaf) < MIN_SHARD_SIZE:
        return P()
    if any(k in s for k in ("item_emb", "tables", "linear")):
        return P(model) if len(leaf.shape) == 1 \
            else P(model, *([None] * (len(leaf.shape) - 1)))
    return P()


def recsys_serve_param_spec(path, leaf, mesh) -> P:
    """Serving replicates the tables outright, so lookups and candidate
    dots are local; training keeps the sharded spec."""
    return P()


def lm_small_param_spec(path, leaf, mesh) -> P:
    """Small-model policy (< ~2B params): NO tensor parallelism.  BOTH
    non-pod axes act as FSDP/data parallelism: weights shard their first
    divisible inner dim over ("data","model"), the batch shards over
    ("data","model"), and the only per-step collectives left are the
    weight gathers and gradient reductions, O(params)."""
    s = _path_str(path)
    fsdp = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    fsdp = fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None)
    n = int(np.prod([mesh.shape[a] for a in
                     (fsdp if isinstance(fsdp, tuple) else (fsdp,))])) \
        if fsdp else 1
    if _size(leaf) < MIN_SHARD_SIZE:
        return P()
    if "embed" in s:
        return P(fsdp, None) if leaf.shape[0] % n == 0 else P()
    if "lm_head" in s:
        return P(fsdp, None) if leaf.shape[0] % n == 0 else P()
    # stacked layer weights [L, a, b]: shard the first divisible inner dim
    spec = [None] * len(leaf.shape)
    for i in range(1, len(leaf.shape)):
        if leaf.shape[i] % n == 0 and leaf.shape[i] >= n:
            spec[i] = fsdp
            return P(*spec)
    return P()


def lm_small_batch_spec(path, leaf, mesh) -> P:
    fsdp = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    n = int(np.prod([mesh.shape[a] for a in fsdp]))
    if leaf.shape and leaf.shape[0] % n == 0 and leaf.shape[0] >= n:
        return P(fsdp, *([None] * (len(leaf.shape) - 1)))
    return batch_spec(path, leaf, mesh)


PARAM_SPEC_FNS = {"lm": lm_param_spec, "gnn": gnn_param_spec,
                  "recsys": recsys_param_spec}


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def batch_spec(path, leaf, mesh) -> P:
    """Shard leading (batch) dim over DP axes when it is at least as
    long as their product (an uneven one is padded)."""
    dp = _dp(mesh)
    if dp is None or not leaf.shape:
        return P()
    n_dp = int(np.prod([mesh.shape[a] for a in
                        (dp if isinstance(dp, tuple) else (dp,))]))
    if leaf.shape[0] >= n_dp:
        return P(dp, *([None] * (len(leaf.shape) - 1)))
    return P()


def gnn_batch_spec(path, leaf, mesh) -> P:
    """Nodes/edges shard over ALL axes: a GNN has no tensor-parallel
    dimension."""
    axes = _all(mesh)
    n_ax = int(np.prod([mesh.shape[a] for a in axes]))
    if leaf.shape and leaf.shape[0] % n_ax == 0 and leaf.shape[0] >= n_ax:
        return P(axes, *([None] * (len(leaf.shape) - 1)))
    return batch_spec(path, leaf, mesh)


def kv_cache_spec(leaf_shape: tuple, mesh, batch_idx: int = 1,
                  seq_idx: int = 3) -> P:
    """GQA cache [L,B,Hkv,S,hd] or MLA cache [L,B,S,c] (seq_idx=2)."""
    dp = _dp(mesh)
    model = _axis(mesh, "model")
    n_dp = int(np.prod([mesh.shape[a] for a in
                        (dp if isinstance(dp, tuple) else (dp,))])) \
        if dp else 1
    spec = [None] * len(leaf_shape)
    b = leaf_shape[batch_idx]
    if dp and b % n_dp == 0 and b >= n_dp:
        spec[batch_idx] = dp
        spec[seq_idx] = model
    else:
        # batch too small (long-context): shard the SEQUENCE over
        # everything -> distributed split-K decode attention.
        spec[seq_idx] = tuple(mesh.axis_names)
    return P(*spec)


def cache_specs(cache_shapes: Any, mesh, mla: bool) -> Any:
    def one(leaf):
        if mla:
            return kv_cache_spec(leaf.shape, mesh, batch_idx=1, seq_idx=2)
        return kv_cache_spec(leaf.shape, mesh, batch_idx=1, seq_idx=3)
    return tree.map(one, cache_shapes)


# ---------------------------------------------------------------------------
# top level: build NamedSharding trees
# ---------------------------------------------------------------------------


def named(tree_: Any, mesh, spec_fn) -> Any:
    def one(path, leaf):
        return NamedSharding(mesh, spec_fn(path, leaf, mesh))
    return tree.map_with_path(one, tree_)


def named_from_specs(spec_tree: Any, mesh) -> Any:
    return tree.map(lambda sp: NamedSharding(mesh, sp), spec_tree,
                    is_leaf=lambda x: isinstance(x, PartitionSpec))
