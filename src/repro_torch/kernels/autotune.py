"""Kernel geometry for the fused candidate engine: the port of
``repro.kernels.autotune``'s configuration and lookup.

``TuneConfig`` is one geometry choice; ``DEFAULT_CONFIG`` is the
historical constants (tile 512, Q quantum 8, k quantum 8, one pair per
step, successive-maxima reducer).  The table of tuned H100 configs is
empty until the sweep is ported, so ``lookup`` returns the defaults.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.size_model import tuning_size_class


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """One kernel-geometry choice.  ``k_tile`` is an optional override
    of the per-tile candidate count; ``resolve_k_tile`` clamps it to the
    exactness floor ``min(k, tile)`` so a config can widen but never
    break the merge contract."""
    tile: int = 512
    q_pad: int = 8
    k_pad: int = 8
    k_tile: int | None = None
    reducer: str = "successive"
    pairs_per_step: int = 1

    def resolve_k_tile(self, k: int) -> int:
        from repro_torch.kernels.fused_decode_score import default_k_tile
        floor = default_k_tile(k, self.tile, self.k_pad)
        if self.k_tile is None:
            return floor
        return min(max(int(self.k_tile), floor), self.tile)


DEFAULT_CONFIG = TuneConfig()

# (device type, size class, layout) -> TuneConfig; filled by the sweep
# once it runs on the card.
_TABLE: dict[tuple[str, int, str], TuneConfig] = {}


def layout_of(index) -> str:
    """'banded' for a BandedCsrIndex, 'packed' for a PackedCsrIndex,
    'hor' otherwise: the live index's layout tags."""
    from repro_torch.core.layouts import BandedCsrIndex, PackedCsrIndex
    if isinstance(index, BandedCsrIndex):
        return "banded"
    return "packed" if isinstance(index, PackedCsrIndex) else "hor"


def lookup(device_type: str, num_docs: int, layout: str) -> TuneConfig:
    """The config for an index of ``num_docs`` docs on ``device_type``
    ("cuda" / "cpu"): the table's entry for its size class, else the
    defaults."""
    return _TABLE.get((str(device_type), tuning_size_class(num_docs),
                       str(layout)), DEFAULT_CONFIG)
