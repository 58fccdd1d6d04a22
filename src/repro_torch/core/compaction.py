"""Tiered compaction policy for the segmented live index (stdlib only:
a copy of ``repro.core.compaction``).

The live index (core/live_index.py) accumulates immutable sealed
segments; left alone, a long ingest stream would mean one fused-kernel
launch per tiny segment at query time and an ever-growing tombstone
set.  Background reorganization fixes both — the DB-IR systems the
design follows (ODYS, arXiv:1208.4270; compressed-index maintenance,
arXiv:1209.5448) merge sealed runs in the background while queries keep
reading the old stack.

This module is the POLICY half: pure functions over the stack's posting
counts deciding WHAT to merge.  The MECHANISM (building the merged
segment, dropping tombstoned postings) lives on ``SegmentedIndex`` so
the policy stays trivially unit-testable.

Size-tiered semantics (Cassandra/Lucene-style): the newest runs are the
smallest (each seal emits one delta-sized run); ``pick_compaction``
finds the maximal suffix of similarly-sized runs (max/min within
``size_ratio``) and merges it once it has ``min_run`` members.  Merged
runs are ~``min_run``x bigger, so they leave the suffix band and only
merge again when enough same-sized peers accumulate — write
amplification stays O(log_{min_run} N) per posting while the stack
depth stays O(log N).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TieredPolicy:
    """Size-ratio trigger for merging the newest run of segments.

    size_ratio: two runs are "similarly sized" when max/min < size_ratio.
    min_run:    merge only once the similar-sized suffix has this many
                members (smaller merges waste write bandwidth).
    """
    size_ratio: float = 4.0
    min_run: int = 4

    def pick(self, sizes: list[int]) -> tuple[int, int] | None:
        """Segments to merge as a half-open stack slice (lo, hi), newest
        last, or None.  ``sizes`` are per-segment posting counts in
        stack order (oldest first)."""
        return pick_compaction(sizes, self.size_ratio, self.min_run)

    def due(self, sizes: list[int]) -> bool:
        """True when the stack has a mergeable run.  The serving tier's
        maintenance thread checks this BEFORE taking the index write
        lock, so an idle stack costs queries no lock contention."""
        return self.pick(sizes) is not None


def pick_compaction(sizes: list[int], size_ratio: float = 4.0,
                    min_run: int = 4) -> tuple[int, int] | None:
    """Maximal suffix of similarly-sized runs, if long enough to merge.

    Walks from the newest run backwards while the suffix stays within
    ``size_ratio`` (strict: ``max < size_ratio * min``, so a run that
    already absorbed ``size_ratio`` peers does not re-merge with fresh
    delta-sized runs).  Empty segments (size 0, all postings tombstoned
    away) count as size 1 so they are always eligible for cleanup.
    A pick always spans >= 2 segments regardless of ``min_run`` — a
    single-segment "merge" makes no progress, and returning one would
    spin the caller's compact-until-quiescent loop forever.
    """
    n = len(sizes)
    min_run = max(min_run, 2)
    if n < min_run:
        return None
    lo = n - 1
    hi_max = hi_min = max(sizes[-1], 1)
    while lo > 0:
        s = max(sizes[lo - 1], 1)
        new_max, new_min = max(hi_max, s), min(hi_min, s)
        if not new_max < size_ratio * new_min:
            break
        hi_max, hi_min = new_max, new_min
        lo -= 1
    if n - lo >= min_run:
        return lo, n
    return None


def pick_layout_rewrite(current: list[str],
                        wanted: list[str]) -> int | None:
    """Stack position of the next segment to re-seal into its
    policy-preferred layout, or None when converged.

    ``current`` / ``wanted`` are per-segment layout tags in stack order
    (oldest first).  Oldest-first: old segments are the biggest and the
    least likely to be rewritten by a future tiered merge anyway, so
    converging them first retires the most mispredicted bytes per
    rewrite.  Same policy/mechanism split as ``pick_compaction`` — the
    rebuild itself lives on ``SegmentedIndex.rewrite_segment``.
    """
    for i, (cur, want) in enumerate(zip(current, wanted)):
        if cur != want:
            return i
    return None
