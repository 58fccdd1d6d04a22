"""Background index maintenance: seal full deltas, tiered compaction
(a copy of ``repro.serve.maintenance`` over the port's index).

``compact()`` is safe to call between query batches but synchronous on
the caller.  This module is the background half: a
thread that watches the delta's fill fraction and the compaction
policy's trigger, and runs seal/compact UNDER THE WRITE LOCK while the
query path keeps serving pinned epochs (the QueryServer probes that
lock non-blockingly — a batch never waits on maintenance, it just
scores one epoch staler).

Cheap-check-then-lock: both triggers are read without the lock first
(``delta_fill`` is two integer divides, ``TieredPolicy.due`` a pure
function of posting counts), so an idle index costs queries no lock
contention at all; the trigger is re-checked under the lock before
acting because a writer may have raced in between.
"""
from __future__ import annotations

import dataclasses
import threading
import time

from repro_torch.core.live_index import SegmentedIndex


@dataclasses.dataclass
class MaintenanceStats:
    runs: int = 0            # run_once invocations that checked triggers
    seals: int = 0
    compactions: int = 0
    layout_rewrites: int = 0  # policy-driven single-segment re-seals


class IndexMaintenance:
    """Seal-and-compact runner, callable inline or as a thread.

    ``run_once`` is the whole policy (deterministic, what the tests
    drive); ``start``/``stop`` wrap it in a polling thread for real
    serving loops.  ``seal_fill`` is the delta fill fraction that
    triggers a seal — 1.0 means "only when ingest would have sealed
    anyway", lower values trade delta scan width for seal frequency.
    ``max_compactions_per_run`` bounds lock hold time per run; the
    policy re-fires next run if more merges are due.

    ``layout_policy`` installs an adaptive hor-vs-packed chooser
    (``size_model.LayoutCostModel``) on the index: seals and compactions
    resolve their layout through the override ladder (an explicit
    ``seal_layout`` here still wins), and each run additionally
    converts up to ``max_rewrites_per_run`` already-sealed segments
    whose layout disagrees with the policy — so a quiescent stack still
    converges to the policy's layout mix, one bounded lock hold at a
    time.  ``layout_policy=None`` leaves the index's own policy (or
    lack of one) untouched.
    """

    def __init__(self, index: SegmentedIndex, lock: threading.RLock, *,
                 seal_fill: float = 0.75, interval_s: float = 0.002,
                 max_compactions_per_run: int = 1,
                 seal_layout: str | None = None,
                 layout_policy=None, max_rewrites_per_run: int = 1):
        self.index = index
        self.lock = lock
        self.seal_fill = float(seal_fill)
        self.interval_s = float(interval_s)
        self.max_compactions_per_run = int(max_compactions_per_run)
        self.seal_layout = seal_layout
        self.max_rewrites_per_run = int(max_rewrites_per_run)
        if layout_policy is not None:
            index.layout_policy = layout_policy
        self.stats = MaintenanceStats()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _due(self) -> bool:
        ix = self.index
        return (ix.delta_fill >= self.seal_fill
                or ix.policy.due(ix.segment_postings())
                or ix.pick_layout_rewrite() is not None)

    def run_once(self) -> dict:
        """One maintenance step: seal if the delta is full enough,
        then up to ``max_compactions_per_run`` policy-picked merges,
        then up to ``max_rewrites_per_run`` layout-policy re-seals.
        Returns what happened (for tests and telemetry)."""
        self.stats.runs += 1
        did = {"sealed": False, "compacted": 0, "rewritten": 0}
        if not self._due():                 # unlocked cheap check
            return did
        t0 = time.perf_counter()
        with self.lock:
            ix = self.index
            if ix.delta_fill >= self.seal_fill and ix._delta.n_docs > 0:
                ix.seal(layout=self.seal_layout)
                self.stats.seals += 1
                did["sealed"] = True
            for _ in range(self.max_compactions_per_run):
                if not ix.policy.due(ix.segment_postings()):
                    break
                if not ix.compact():
                    break
                self.stats.compactions += 1
                did["compacted"] += 1
            for _ in range(self.max_rewrites_per_run):
                i = ix.pick_layout_rewrite()
                if i is None:
                    break
                ix.rewrite_segment(i)
                self.stats.layout_rewrites += 1
                did["rewritten"] += 1
        if did["sealed"] or did["compacted"] or did["rewritten"]:
            # the seal/compact/rewrite calls above each emitted their
            # own detailed event; this one records the run envelope
            # (lock hold time, work mix) the serving tier alerts on
            self.index.events.emit(
                "maintenance_run", epoch=self.index.epoch,
                sealed=did["sealed"], compacted=did["compacted"],
                rewritten=did["rewritten"],
                duration_us=(time.perf_counter() - t0) * 1e6)
        return did

    # -- thread -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self.run_once()
                self._stop.wait(timeout=self.interval_s)

        self._thread = threading.Thread(target=loop,
                                        name="index-maintenance",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=30.0)
        self._thread = None
