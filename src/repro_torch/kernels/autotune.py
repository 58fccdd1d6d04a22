"""Kernel geometry of the fused candidate engine, and its tuning table:
the port of ``repro.kernels.autotune``.

The fused kernels default to one geometry: ``TILE = 512`` docs per tile,
``Q_PAD = 8`` queries and ``K_PAD = 8`` candidates as padding quanta, one
routing pair per step, and the successive-maxima tile reducer.  This
module makes the geometry a measured quantity:

  * ``TuneConfig`` is one geometry choice; ``DEFAULT_CONFIG`` is exactly
    the defaults, so an EMPTY table leaves every path's geometry, and
    every result bit, as it was.
  * ``TuningTable`` holds the winning config per ``(device type,
    size_class, layout)`` with its measured median seconds, in the
    reference's JSON (schema ``repro-tune/1``): either package reads the
    other's files.  The key's first field is the CUDA device type
    (``"cuda"``, or ``"cpu"`` for the plain versions) where the
    reference keys its Pallas backend, so a reference table's entries
    load but never match a port lookup.  The module-level ACTIVE table is
    what ``make_scorer``, ``LiveView.topk`` and the seal path consult.
  * ``autotune_index`` sweeps ``candidate_configs`` over a real index and
    query batch and stores the winner.

``REPRO_REDUCER=bitonic`` (or ``successive``) forces the tile reducer
whatever the table says.  Every device runs both reducers (the CUDA
kernels on the card, their plain versions on the CPU), so the
reference's downgrade of a bitonic entry on compiled lowerings
(``downgrade_reducer``) has no counterpart.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterable

from repro_torch.core.size_model import tuning_size_class

TUNE_SCHEMA = "repro-tune/1"

_TILE_DEFAULT = 512
_Q_PAD_DEFAULT = 8
_K_PAD_DEFAULT = 8


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """One kernel-geometry choice.  ``k_tile`` is an optional override
    of the per-tile candidate count; ``resolve_k_tile`` clamps it to the
    exactness floor ``min(k, tile)`` so a config can widen but never
    break the merge contract."""
    tile: int = _TILE_DEFAULT
    q_pad: int = _Q_PAD_DEFAULT
    k_pad: int = _K_PAD_DEFAULT
    k_tile: int | None = None
    reducer: str = "successive"
    pairs_per_step: int = 1

    def resolve_k_tile(self, k: int) -> int:
        from repro_torch.kernels.fused_decode_score import default_k_tile
        floor = default_k_tile(k, self.tile, self.k_pad)
        if self.k_tile is None:
            return floor
        return min(max(int(self.k_tile), floor), self.tile)

    def resolved(self) -> "TuneConfig":
        """This config with ``REPRO_REDUCER`` applied."""
        forced = os.environ.get("REPRO_REDUCER", "")
        if forced and forced != self.reducer:
            from repro_torch.kernels.fused_decode_score import REDUCERS
            if forced not in REDUCERS:
                raise ValueError(f"REPRO_REDUCER={forced!r} not in "
                                 f"{REDUCERS}")
            return dataclasses.replace(self, reducer=forced)
        return self

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TuneConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


DEFAULT_CONFIG = TuneConfig()


def size_class_of(num_docs: int) -> int:
    return tuning_size_class(num_docs)


def layout_of(index) -> str:
    """'banded' for a BandedCsrIndex, 'packed' for a PackedCsrIndex,
    'hor' otherwise: the live index's layout tags."""
    from repro_torch.core.layouts import BandedCsrIndex, PackedCsrIndex
    if isinstance(index, BandedCsrIndex):
        return "banded"
    return "packed" if isinstance(index, PackedCsrIndex) else "hor"


class TuningTable:
    """Winning ``TuneConfig`` per ``(device type, size_class, layout)``,
    and the winner's measured median seconds where the sweep timed it.
    The JSON key of the first field is ``"backend"``, as the
    reference's."""

    def __init__(self) -> None:
        self._entries: dict[tuple[str, int, str], TuneConfig] = {}
        self._costs: dict[tuple[str, int, str], float] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, device_type: str, size_class: int, layout: str,
            cfg: TuneConfig, cost_s: float | None = None) -> None:
        key = (str(device_type), int(size_class), str(layout))
        self._entries[key] = cfg
        if cost_s is not None:
            self._costs[key] = float(cost_s)

    def get(self, device_type: str, size_class: int,
            layout: str) -> TuneConfig | None:
        return self._entries.get((str(device_type), int(size_class),
                                  str(layout)))

    def cost(self, device_type: str, size_class: int,
             layout: str) -> float | None:
        """The winner's measured median seconds at EXACTLY this
        (device type, size_class, layout), or None: no nearest-class
        fallback, so the layout cost model compares costs of one class."""
        return self._costs.get((str(device_type), int(size_class),
                                str(layout)))

    def lookup(self, device_type: str, num_docs: int,
               layout: str) -> TuneConfig:
        """The config for an index of ``num_docs`` docs: its class's
        entry, else the nearest SMALLER tuned class of the same (device
        type, layout), else ``DEFAULT_CONFIG``."""
        cls_ = size_class_of(num_docs)
        hit = self.get(device_type, cls_, layout)
        if hit is not None:
            return hit
        below = [(c, cfg) for (d, c, l), cfg in self._entries.items()
                 if d == device_type and l == layout and c < cls_]
        if below:
            return max(below, key=lambda e: e[0])[1]
        return DEFAULT_CONFIG

    def to_dict(self) -> dict:
        entries = []
        for (d, c, l), cfg in sorted(self._entries.items()):
            e = {"backend": d, "size_class": c, "layout": l,
                 "config": cfg.to_dict()}
            cost = self._costs.get((d, c, l))
            if cost is not None:
                e["median_s"] = cost
            entries.append(e)
        return {"schema": TUNE_SCHEMA, "entries": entries}

    @classmethod
    def from_dict(cls, d: dict) -> "TuningTable":
        if d.get("schema") != TUNE_SCHEMA:
            raise ValueError(f"unknown tuning-table schema "
                             f"{d.get('schema')!r} (want {TUNE_SCHEMA})")
        t = cls()
        for e in d.get("entries", []):
            t.put(e["backend"], e["size_class"], e["layout"],
                  TuneConfig.from_dict(e["config"]),
                  cost_s=e.get("median_s"))
        return t

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# The table every engine call site consults.  It starts EMPTY: every
# lookup resolves to DEFAULT_CONFIG.
_ACTIVE = TuningTable()


def get_active() -> TuningTable:
    return _ACTIVE


def set_active(table: TuningTable | None) -> TuningTable:
    """Install ``table`` (None: a fresh empty table) as the active
    table; returns the previous one, so a caller can restore it."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = table if table is not None else TuningTable()
    return prev


def lookup(device_type: str, num_docs: int, layout: str) -> TuneConfig:
    """The active table's config for an index of ``num_docs`` docs on
    ``device_type`` ("cuda" / "cpu"), with ``REPRO_REDUCER`` applied:
    the query-time entry point of every engine."""
    return _ACTIVE.lookup(str(device_type), num_docs, str(layout)).resolved()


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def candidate_configs(k: int, tile_default: int = _TILE_DEFAULT,
                      tiles: Iterable[int] = (256, 512, 1024),
                      reducers: Iterable[str] = ("successive", "bitonic"),
                      pairs: Iterable[int] = (1, 2),
                      include_wide_k: bool = True) -> list[TuneConfig]:
    """The reference's pruned sweep grid: the default; each other tile;
    each other reducer and pairs-per-step at the default tile; ``k_tile``
    widened once (twice the floor) with each reducer; and the widest
    tile with the most pairs per step."""
    from repro_torch.kernels.fused_decode_score import default_k_tile
    out: list[TuneConfig] = [TuneConfig()]
    for t in tiles:
        if t != tile_default:
            out.append(TuneConfig(tile=t))
    for r in reducers:
        if r != "successive":
            out.append(TuneConfig(reducer=r))
    for p in pairs:
        if p != 1:
            out.append(TuneConfig(pairs_per_step=p))
    if include_wide_k:
        floor = default_k_tile(k, tile_default, _K_PAD_DEFAULT)
        wide = min(2 * floor, tile_default)
        if wide > floor:
            out.append(TuneConfig(k_tile=wide))
            out.append(TuneConfig(k_tile=wide, reducer="bitonic"))
    big = max(tiles)
    if big != tile_default:
        out.append(TuneConfig(tile=big, pairs_per_step=max(pairs)))
    return out


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def time_config(index, query_hashes, idf_w, k: int, cap: int,
                cfg: TuneConfig, reps: int = 3, warmup: int = 1,
                rank_blend: float = 0.0) -> float:
    """Median wall-clock seconds of one ``ops.fused_segment_topk`` call
    under ``cfg`` over the index's whole routing budget at that geometry
    (``padded_pairs_budget``, so a ``pairs_per_step`` > 1 is timed
    routing every pair); warm-up calls excluded.  On the card each timed
    call is bracketed by ``torch.cuda.synchronize()``."""
    import torch

    from repro_torch.kernels import ops

    k_tile = cfg.resolve_k_tile(k)
    max_pairs = ops.padded_pairs_budget(index, cfg.tile, cfg.pairs_per_step)
    cuda = index.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(index.device)

    def run():
        ops.fused_segment_topk(
            index, query_hashes, idf_w, 0, k_tile=k_tile, cap=cap,
            max_pairs=max_pairs, rank_blend=rank_blend, tile=cfg.tile,
            q_pad=cfg.q_pad, reducer=cfg.reducer,
            pairs_per_step=cfg.pairs_per_step)

    for _ in range(max(warmup, 1)):
        run()
    samples = []
    for _ in range(max(reps, 1)):
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        samples.append(time.perf_counter() - t0)
    return _median(samples)


def autotune_index(index, query_hashes, idf_w, k: int, cap: int | None = None,
                   configs: Iterable[TuneConfig] | None = None,
                   reps: int = 3, warmup: int = 1,
                   table: TuningTable | None = None):
    """Sweep ``configs`` (default ``candidate_configs(k)``) over one
    (index, query batch): ``query_hashes`` i32[B, T] dedup'd hash
    bit-views and ``idf_w`` f32[B, T] their weights, as the live index
    passes a segment.

    Returns ``(best_config, records)``, one record per config (config,
    median seconds, candidate bytes per query, whether it is the
    default).  Configs within 2% of the fastest tie, and the tie breaks
    toward fewer candidate bytes, then toward the default.  With
    ``table`` the winner is stored under this index's (device type,
    size_class, layout) with its median seconds."""
    from repro_torch.core.size_model import candidate_bytes_per_query

    if cap is None:
        cap = max(int(index.max_posting_len), 1)
    if configs is None:
        configs = candidate_configs(k)
    num_docs = int(index.docs.num_docs)
    records = []
    for cfg in configs:
        sec = time_config(index, query_hashes, idf_w, k, cap, cfg,
                          reps=reps, warmup=warmup)
        records.append({
            "config": cfg.to_dict(),
            "median_s": sec,
            "candidate_bytes_per_query": candidate_bytes_per_query(
                num_docs, cfg.tile, cfg.resolve_k_tile(k)),
            "is_default": cfg == DEFAULT_CONFIG,
        })
    fastest = min(r["median_s"] for r in records)

    def rank(r):
        return (r["median_s"] > fastest * 1.02,
                r["candidate_bytes_per_query"],
                not r["is_default"], r["median_s"])

    best_rec = min(records, key=rank)
    best = TuneConfig.from_dict(best_rec["config"])
    if table is not None:
        table.put(index.device.type, size_class_of(num_docs),
                  layout_of(index), best, cost_s=best_rec["median_s"])
    return best, records
