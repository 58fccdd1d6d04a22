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

``NamedMesh`` is the N-D counterpart of a JAX mesh (``jax.make_mesh``):
named axes over slots in C order, slot i on ``cuda:(i % device_count)``,
or every slot on ``cpu`` or on ``meta`` (shapes only: the dry run's
production meshes).  The sharding rules read its ``axis_names`` and
``shape``; a shard program over one of its axes runs on the 1-D
``Mesh`` that ``along`` gives.  ``PartitionSpec`` and ``NamedSharding``
lay a tensor over a ``NamedMesh``; ``place`` (the counterpart of
``jax.device_put``) gives a ``ShardedTensor``, one piece per slot on
the slot's device, and ``gather`` reassembles it.  The sharding rules
(``launch.sharding``) build on these.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np
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
    return Mesh(tuple(_slot_devices(n_shards, device)), axis)


def slot_count(n_slots: int | None = None, device="cuda") -> int:
    """``n_slots``, or one slot a card on ``cuda``."""
    if n_slots is not None:
        return int(n_slots)
    if torch.device(device).type != "cuda":
        raise ValueError(f"a {device} mesh needs n_slots")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device")
    return torch.cuda.device_count()


def _slot_devices(n: int, device) -> list:
    """``n`` slots on ``device``'s type: slot i on ``cuda:(i %
    device_count)``, else every slot on ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


@dataclasses.dataclass(frozen=True, eq=False)
class NamedMesh:
    """Slots over named axes, as a JAX mesh: ``devices`` an object array
    of ``torch.device`` of ``shape``'s sizes, slot i (in C order) at
    ``devices.flat[i]``."""
    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        names = tuple(self.axis_names)
        if len(set(names)) != len(names) or \
                len(names) != self.devices.ndim:
            raise ValueError(f"axes {names} for a mesh of shape "
                             f"{self.devices.shape}")
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict:
        """``{axis: n}`` in axis order, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, slot: int) -> dict:
        """``{axis: index}`` of flat slot ``slot``."""
        idx = np.unravel_index(slot, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def along(self, axis: str) -> Mesh:
        """The 1-D mesh of the slots along ``axis`` at coordinate 0 of
        every other axis: what a shard program over ``axis`` runs on."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r} (it has "
                             f"{self.axis_names})")
        idx = tuple(slice(None) if a == axis else 0
                    for a in self.axis_names)
        return Mesh(tuple(self.devices[idx]), axis)

    def __repr__(self) -> str:
        kinds = sorted({str(d) for d in self.devices.flat})
        return f"NamedMesh({self.shape}, devices={kinds})"


def make_named_mesh(shape: Sequence[int], axis_names: Sequence[str],
                    device="cuda") -> NamedMesh:
    """A ``NamedMesh`` of ``shape`` over ``axis_names`` on ``device``'s
    type (the counterpart of ``jax.make_mesh``)."""
    shape = tuple(int(n) for n in shape)
    if not shape or min(shape) < 1:
        raise ValueError(f"mesh shape {shape}")
    arr = np.empty(shape, dtype=object)
    for i, d in enumerate(_slot_devices(int(np.prod(shape)), device)):
        arr.flat[i] = d
    return NamedMesh(arr, tuple(axis_names))


class PartitionSpec(tuple):
    """One entry a dimension: ``None`` (replicated), an axis name, or a
    tuple of axis names (the first the major one)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """``spec`` over ``mesh``'s named axes."""
    mesh: Any
    spec: PartitionSpec

    def __post_init__(self):
        spec = self.spec if isinstance(self.spec, PartitionSpec) else \
            PartitionSpec(*self.spec)
        object.__setattr__(self, "spec", spec)
        seen = []
        for entry in spec:
            for a in _entry_axes(entry):
                if a not in self.mesh.axis_names:
                    raise ValueError(
                        f"axis {a!r} of {spec} is not found in mesh: "
                        f"{tuple(self.mesh.axis_names)}")
                if a in seen:
                    raise ValueError(f"{spec} maps axis {a!r} to more than "
                                     "one dimension")
                seen.append(a)

    def tiling(self, ndim: int) -> list[int]:
        """How many pieces each of ``ndim`` dimensions is cut into."""
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than the "
                             f"{ndim} dimensions of the array")
        ents = list(self.spec) + [None] * (ndim - len(self.spec))
        return [math.prod(self.mesh.shape[a] for a in _entry_axes(e))
                for e in ents]

    def shard_shape(self, shape) -> tuple:
        """One slot's piece of an array of ``shape``: each dimension over
        its pieces, an uneven one padded up (``ceil``), as GSPMD pads."""
        return tuple(-(-int(d) // n)
                     for d, n in zip(shape, self.tiling(len(shape))))

    def shard_bytes(self, shape, dtype) -> int:
        """Bytes of one slot's piece of an array of ``shape``, ``dtype``."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        return math.prod(self.shard_shape(shape)) * itemsize

    def slices(self, slot: int, shape) -> tuple:
        """Slot ``slot``'s piece of an evenly split array of ``shape``."""
        coords = self.mesh.coords(slot)
        ents = list(self.spec) + [None] * (len(shape) - len(self.spec))
        out = []
        for d, e in zip(shape, ents):
            idx, n = 0, 1
            for a in _entry_axes(e):
                idx = idx * self.mesh.shape[a] + coords[a]
                n *= self.mesh.shape[a]
            step = int(d) // n
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTensor:
    """A tensor laid out by ``sharding``: ``pieces[i]`` is slot i's, on
    ``sharding.mesh.devices.flat[i]``."""
    pieces: tuple
    sharding: NamedSharding
    shape: tuple
    dtype: torch.dtype

    def slot_bytes(self, slot: int) -> int:
        p = self.pieces[slot]
        return p.numel() * p.element_size()

    def gather(self) -> Tensor:
        """The whole tensor on slot 0's device; where several slots hold
        the same block, the first one's piece."""
        mesh = self.sharding.mesh
        dev = mesh.devices.flat[0]
        if math.prod(self.sharding.tiling(len(self.shape))) == 1:
            return self.pieces[0].to(dev)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for i, p in enumerate(self.pieces):
            sl = self.sharding.slices(i, self.shape)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in done:
                out[sl] = p.to(dev)
                done.add(key)
        return out


def place(x: Tensor, sharding: NamedSharding) -> ShardedTensor:
    """``x`` laid out by ``sharding``: each slot's piece copied to its
    device.  An uneven split is refused."""
    tiles = sharding.tiling(x.dim())
    for d, n in zip(x.shape, tiles):
        if d % n:
            raise ValueError(
                f"{sharding} cuts axis of size {d} into {n} pieces: the "
                f"pieces of {tuple(x.shape)} would be uneven")
    mesh = sharding.mesh
    pieces = tuple(
        x[sharding.slices(i, x.shape)].to(dev).contiguous()
        for i, dev in enumerate(mesh.devices.flat))
    return ShardedTensor(pieces, sharding, tuple(x.shape), x.dtype)


def gather(x):
    """A ``ShardedTensor`` reassembled; anything else as it is."""
    return x.gather() if isinstance(x, ShardedTensor) else x


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


def all_to_all(mesh: Mesh, parts: Sequence[Tensor]) -> list:
    """Shard s's ``[S, ...]`` tensor sends its chunk p to shard p: shard s
    receives ``[S, ...]``, chunk s of every peer in shard order, on its
    own device (``jax.lax.all_to_all(x[:, None], split_axis=0,
    concat_axis=1, tiled=False)``, that result's first axis dropped)."""
    n = mesh.size
    if len(parts) != n or any(p.shape[0] != n for p in parts):
        raise ValueError(f"all_to_all: {len(parts)} parts of leading "
                         f"extents {[p.shape[0] for p in parts]} on a mesh "
                         f"of {n}")
    return [torch.stack([p[s].to(dev) for p in parts])
            for s, dev in enumerate(mesh.devices)]
