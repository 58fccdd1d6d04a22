"""Meshes: the port of ``repro.launch.mesh``.

The production meshes shape the dry run: 16 x 16 ``("data", "model")``
or 2 x 16 x 16 ``("pod", "data", "model")``, by default on the ``meta``
device (shapes only: nothing is placed).  ``make_host_mesh`` builds a
small mesh over the slots a process has: every card
(``torch.cuda.device_count()``), or ``n_slots`` slots on one device
type, the counterpart of the reference's forced host devices.
"""
from __future__ import annotations

from repro_torch.distributed.shmap import (NamedMesh, make_named_mesh,
                                           slot_count)


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> NamedMesh:
    """16x16 single-pod (256 slots) or 2x16x16 multi-pod (512 slots)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_named_mesh(shape, axes, device)


def make_host_mesh(model_parallelism: int = 1, axes=("data", "model"),
                   n_slots: int | None = None, device="cuda") -> NamedMesh:
    """Small ``(n // model, model)`` mesh over ``slot_count(n_slots,
    device)`` slots (tests / elastic restart)."""
    n = slot_count(n_slots, device)
    model = min(model_parallelism, n)
    return make_named_mesh((n // model, model), axes, device)


def batch_axes(mesh) -> tuple[str, ...]:
    """The axes a batch dimension shards over for this mesh."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)
