"""One controller, S shards: the port's counterpart of the reference's
``shard_map`` shim (``repro.distributed.shmap``).

A JAX mesh is driven by one controller: one process runs the shard
program on each of S devices, and the collectives join their outputs.
The port keeps that model without process groups.  ``Mesh`` names S
shard slots, each a ``torch.device``; ``run`` calls the shard program
once per shard, in shard order, on that shard's own tensors; and the
collectives are explicit joins on ``mesh.devices[0]``, in shard order:

  * ``all_gather`` concatenates the shards' tensors along the last axis;
  * ``psum`` is the sequential sum ``((x0 + x1) + x2) + ...``, the order
    XLA's CPU ``psum`` adds host devices in;
  * ``pmax`` is the elementwise maximum (exact in any order);
  * the shard's index in the loop is its ``axis_index``.

``make_mesh`` places shard s on ``cuda:(s % device_count)``: on one card
all S shards sit on ``cuda:0`` and run in turn.  On the CPU every shard
is ``cpu``.  A mesh on ``cuda`` without a card raises; nothing falls
back to the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    """S shard slots along one named axis: ``devices[s]`` holds shard
    s's tensors and runs its program.  Several slots may name the same
    device."""
    devices: tuple
    axis: str = "shards"

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> dict:
        """``{axis: S}``, as a JAX mesh's ``shape``."""
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_shards: int, axis: str = "shards", device="cuda") -> Mesh:
    """A mesh of ``n_shards`` slots on ``device``'s type: shard s on
    ``cuda:(s % device_count)``, or every shard on the CPU."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: a CUDA mesh needs a CUDA device")
        n = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", s % n) for s in range(n_shards))
    else:
        devices = (dev,) * n_shards
    return Mesh(devices, axis)


def check_axis(mesh: Mesh, axis: str, n_shards: int) -> None:
    """Refuse a mesh whose ``axis`` does not hold exactly ``n_shards``
    slots: a structure built for S shards would otherwise lose shards."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r} (it has "
                         f"{mesh.axis!r})")
    if mesh.shape[axis] != n_shards:
        raise ValueError(
            f"index was built for {n_shards} shards but mesh axis "
            f"{axis!r} has {mesh.shape[axis]} devices: whole shards "
            "would be dropped")


def run(mesh: Mesh, program: Callable, per_shard: Sequence,
        *replicated: Any) -> list:
    """``[program(s, per_shard[s], *replicated) for s in shards]``: the
    shard program once per shard, in shard order.  A replicated tensor
    argument is moved to each shard's device."""
    if len(per_shard) != mesh.size:
        raise ValueError(f"{len(per_shard)} shards of inputs for a mesh of "
                         f"{mesh.size}")
    out = []
    for s, dev in enumerate(mesh.devices):
        args = [a.to(dev) if isinstance(a, Tensor) else a
                for a in replicated]
        out.append(program(s, per_shard[s], *args))
    return out


def all_gather(mesh: Mesh, parts: Sequence[Tensor]) -> Tensor:
    """The shards' tensors concatenated along the last axis, in shard
    order, on ``mesh.devices[0]``."""
    root = mesh.devices[0]
    return torch.cat([p.to(root) for p in parts], dim=-1)


def psum(mesh: Mesh, parts: Sequence[Tensor]) -> Tensor:
    """The sum over shards, added in shard order ``((x0 + x1) + x2) ...``
    on ``mesh.devices[0]``."""
    root = mesh.devices[0]
    acc = parts[0].to(root)
    for p in parts[1:]:
        acc = acc + p.to(root)
    return acc


def pmax(mesh: Mesh, parts: Sequence[Tensor]) -> Tensor:
    """The elementwise maximum over shards, on ``mesh.devices[0]``."""
    root = mesh.devices[0]
    acc = parts[0].to(root)
    for p in parts[1:]:
        acc = torch.maximum(acc, p.to(root))
    return acc
