"""Elastic scaling: re-shard state onto whatever mesh a restart sees; the
port of ``repro.train.elastic``.

A restart builds the largest mesh the surviving slots allow and resumes.
Because checkpoints are logical trees (host numpy) and partition specs
are FUNCTIONS of (tree, mesh), restoring onto a different slot count is
``launch.sharding.place`` with the new mesh's shardings.

Difference from the reference, by design: ``largest_mesh`` counts the
cards (``torch.cuda.device_count()``), or takes ``n_slots`` slots on one
device type, where the reference counts JAX's devices (forced host
devices included).
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.core import tree
from repro_torch.distributed.shmap import (NamedMesh, make_named_mesh,
                                           slot_count)
from repro_torch.launch import sharding as shard_lib
from repro_torch.train import checkpoint as ckpt_lib


def largest_mesh(axis_names: tuple[str, ...] = ("data", "model"),
                 model_parallelism: int = 1, n_slots: int | None = None,
                 device="cuda") -> NamedMesh:
    """Build the biggest mesh the surviving slots allow.

    ``model_parallelism`` is pinned (weights must fit); the data axis
    absorbs whatever slot count remains — elastic data parallelism.
    """
    n = slot_count(n_slots, device)
    model = min(model_parallelism, n)
    data = n // model
    return make_named_mesh((data, model), axis_names, device)


def shardings_for(tree_: Any, mesh: NamedMesh,
                  spec_fn: Callable[[tuple, Any], tuple]) -> Any:
    """Tree of ``NamedSharding`` from a (path, leaf) -> PartitionSpec
    rule."""
    def one(path, leaf):
        return shard_lib.NamedSharding(mesh, spec_fn(path, leaf))
    return tree.map_with_path(one, tree_)


def reshard(tree_: Any, shardings: Any) -> Any:
    """Each leaf placed by its sharding (``launch.sharding.place``)."""
    return tree.map(lambda x, sh: shard_lib.place(shard_lib.gather(x), sh),
                    tree_, shardings)


def recover(ckpt_dir: str, template: Any, mesh: NamedMesh,
            spec_fn: Callable[[tuple, Any], tuple]) -> tuple[Any, int]:
    """Restore the latest checkpoint directly onto ``mesh``: read onto
    the host, then each leaf placed by its sharding.  Returns
    (state tree of ``ShardedTensor``, step).  Works for ANY slot count:
    this is the elastic-restart entry point."""
    sh = shardings_for(template, mesh, spec_fn)
    host, step = ckpt_lib.restore(ckpt_dir, template, device="cpu")
    return reshard(host, sh), step
