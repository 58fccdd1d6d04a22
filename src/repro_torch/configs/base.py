"""Config registry machinery: the port of ``repro.configs.base``'s
``ArchDef`` and ``lm_active_params``.

An ``ArchDef`` names an architecture, the function that makes its
config, ``make_config(scale, shape_id)`` ("full" or "smoke"), and its
input shapes.  The reference's dry-run cells (``Cell``,
``ArchDef.cell``) wait for the port's training path and sharding
rules.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

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
