"""QueryServer: admission queue + micro-batched fused evaluation (the
port of ``repro.serve.server``).

Single queries arrive one at a time; the fused engines score a batch
per launch.  The server bridges the two: requests admission-queue, and
each pump drains up to ``batch_size`` of them into one
``(batch_size, n_terms_budget)`` pad-and-mask evaluation through
``LiveView.topk``.  Eager PyTorch compiles nothing per shape and the
CUDA kernels take every extent at run time, so the padding keeps the
reference's shapes (and its answers), not a compilation cache.

Consistency: each micro-batch pins the index's current epoch view
(``LiveView``) and scores every request in the batch against it: a
response equals the engine's answer over the live corpus AT THAT EPOCH,
whatever ingest or background maintenance does meanwhile.  The pin
takes the write lock NON-blockingly: if a writer holds it (mid-seal,
mid-compact), the batch serves from the previous pinned epoch instead
of waiting.

Caching: results key on (padded query row, k, epoch).  An epoch advance
makes every older entry unreachable (see ``serve/cache.py``), so hits
are always consistent with the epoch they are reported against.

Failure: a batch whose scoring raises (a kernel that fails to build or
launch) resolves its unserved tickets with ``status="error"`` and
re-raises out of ``pump``; the engine is never swapped for another.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np

from repro_torch.core.live_index import LiveView, SegmentedIndex
from repro_torch.obs.registry import GLOBAL, MetricsRegistry
from repro_torch.obs.trace import StageAggregator, Trace, Tracer
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.metrics import ServerMetrics


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Serving shapes + engine selection.

    Every micro-batch is padded to exactly (batch_size, n_terms_budget)
    and ``k`` fixes the candidate width.  Queries wider than
    ``n_terms_budget`` are rejected at admission (never silently
    truncated).

    ``engine`` is ``"fused"`` (the hand-written kernels on a CUDA index,
    their plain versions on a CPU one) or ``"torch"`` (the gather
    oracle); ``mode`` is the fused engine's ``"candidates"`` or
    ``"dense"``.  There is no ``backend``: the index's device decides.

    ``tune`` optionally pins a ``kernels.autotune.TuneConfig`` for every
    segment the server scores; ``None`` (the default) resolves each
    segment's geometry from the ACTIVE tuning table per batch, so
    segments sealed after ``autotune.set_active`` serve with their tuned
    geometry.

    ``layout_policy`` optionally installs a ``size_model.LayoutCostModel``
    on the index at construction, so maintenance-driven seals and
    compactions resolve their layout through the override ladder while
    every response still comes from an epoch-pinned view.  ``None``
    leaves the index's own policy untouched.

    ``event_capacity`` optionally rebounds the index's maintenance event
    ring at server construction (``index.events.resize``); ``None``
    leaves it as built.

    ``trace_sample`` samples end-to-end query traces: every Nth
    submitted ticket carries an ``obs.trace.Trace`` through queue wait,
    batch assembly, per-segment kernel dispatch, candidate merge, and
    response (``1`` traces every request, ``0``, the default, constructs
    no span at all; results are bit-identical either way).
    """
    batch_size: int = 8
    n_terms_budget: int = 8
    k: int = 10
    cap: int | None = None
    rank_blend: float = 0.0
    engine: str = "fused"
    mode: str = "candidates"
    cache_capacity: int = 4096
    tune: object | None = None
    layout_policy: object | None = None
    trace_sample: int = 0
    event_capacity: int | None = None


class Response:
    """One served result: top-k ids/scores (host numpy) + serving
    metadata.  ``trace`` is the sampled ``obs.trace.Trace`` (None unless
    this ticket was sampled); its top-level stage spans sum exactly to
    ``latency_us``.  ``status`` is ``"ok"`` for a served result; a
    ticket the server gave up on carries ``"shutdown"`` (queued when the
    server stopped) or ``"error"`` (its batch's scoring raised), with
    empty ids (-1) and zero scores, so ``result()`` never blocks on it."""
    __slots__ = ("doc_ids", "scores", "epoch", "latency_us", "cached",
                 "trace", "status")

    def __init__(self, doc_ids, scores, epoch, latency_us, cached,
                 trace=None, status="ok"):
        self.doc_ids = doc_ids
        self.scores = scores
        self.epoch = epoch
        self.latency_us = latency_us
        self.cached = cached
        self.trace = trace
        self.status = status

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class Ticket:
    """Admission handle: resolves to a Response when its batch lands.
    ``tenant`` names a result-cache partition (single-tenant servers
    leave it at ``"default"``)."""

    def __init__(self, row: np.ndarray, tenant: str = "default"):
        self.row = row
        self.tenant = tenant
        self.t_submit = time.perf_counter()
        self.response: Response | None = None
        self.trace: Trace | None = None
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> Response:
        if not self._done.wait(timeout):
            raise TimeoutError("query not served within timeout")
        return self.response


class QueryServer:
    """Micro-batched server over a SegmentedIndex.

    Drive it either synchronously (``submit`` + ``pump`` from one
    thread: deterministic, what the parity tests do) or with the worker
    thread (``start``/``stop``) while a ``serve.maintenance`` thread
    churns the index in the background.  Writers (ingest, maintenance)
    must hold ``index_lock``; the server takes it only to pin a fresh
    view, and falls back to the previous pin when a writer has it.
    """

    def __init__(self, index: SegmentedIndex,
                 config: ServerConfig | None = None,
                 lock: threading.RLock | None = None):
        self.index = index
        self.config = config or ServerConfig()
        self.index_lock = lock if lock is not None else threading.RLock()
        self.cache = ResultCache(self.config.cache_capacity)
        self.registry = MetricsRegistry()
        self.metrics = ServerMetrics(registry=self.registry,
                                     cache=self.cache)
        self.tracer = Tracer(self.config.trace_sample)
        self.stages = StageAggregator(self.registry)
        self._register_index_gauges()
        self._queue: deque[Ticket] = deque()
        self._qlock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.error: BaseException | None = None   # the worker's failure
        with self.index_lock:
            if self.config.layout_policy is not None:
                index.layout_policy = self.config.layout_policy
            if self.config.event_capacity is not None:
                index.events.resize(self.config.event_capacity)
            self._pinned: LiveView = index.view()
        self._purged_epoch = self._pinned.epoch
        self.metrics.observe_layout_mix(self._pinned.layout_mix())

    # -- observability ------------------------------------------------------

    def _register_index_gauges(self) -> None:
        """Expose live-index state + maintenance counters as callback
        gauges, read at snapshot time (no polling thread)."""
        ix = self.index
        for name, fn in (
                ("index_epoch", lambda: ix.epoch),
                ("index_segments", lambda: ix.num_segments),
                ("index_docs", lambda: ix.num_docs),
                ("index_live_docs", lambda: ix.live_doc_count),
                ("index_delta_fill", lambda: ix.delta_fill),
                ("index_seals", lambda: ix.stats.seals),
                ("index_compactions", lambda: ix.stats.compactions),
                ("index_layout_rewrites", lambda: ix.stats.layout_rewrites),
                ("index_postings_merged", lambda: ix.stats.postings_merged),
                ("index_deletes", lambda: ix.stats.deletes),
                ("index_events_total", lambda: ix.events.total)):
            if self.registry.get(name) is None:
                self.registry.register_callback(name, fn)

    def metrics_snapshot(self, include_global: bool = True) -> dict:
        """The stable export (see ``obs.registry``): this server's
        registry (counters, cache gauges, index gauges, per-stage
        histograms) merged with the process-global engine counters
        (``engine_pair_overflow``, ``engine_truncated_terms``)."""
        snap = self.registry.snapshot()
        if include_global:
            for name, m in GLOBAL.snapshot().items():
                snap.setdefault(name, m)
        return snap

    def stage_summary(self) -> dict:
        """Per-stage latency breakdown ({stage: {count, sum, p50,
        p99}}) aggregated from sampled traces."""
        return self.stages.summary()

    def events(self, n: int | None = None, kind: str | None = None) -> list:
        """The last ``n`` maintenance events from the index's bounded
        event log (seal/compact/rewrite/ingest/delete/...)."""
        return self.index.events.tail(n, kind=kind)

    # -- admission ----------------------------------------------------------

    def _make_ticket(self, query_hashes, tenant: str = "default") -> Ticket:
        """Validate + zero-pad one query into a Ticket (not yet
        enqueued)."""
        qh = np.atleast_1d(np.asarray(query_hashes, np.uint32))
        if qh.ndim != 1:
            raise ValueError(
                f"submit takes ONE query (a 1-D hash vector), got shape "
                f"{qh.shape} — submit batch rows individually; the server "
                "does the batching")
        t = self.config.n_terms_budget
        if qh.shape[0] > t:
            raise ValueError(
                f"query has {qh.shape[0]} term slots > n_terms_budget={t} "
                "(widen the budget; truncation would drop terms silently)")
        row = np.zeros(t, np.uint32)
        row[:qh.shape[0]] = qh
        ticket = Ticket(row, tenant=tenant)
        if self.tracer.enabled:
            ticket.trace = self.tracer.sample()
        return ticket

    def submit(self, query_hashes) -> Ticket:
        """Enqueue one query (u32 term-hash vector, <= n_terms_budget
        wide; it is zero-padded to the budget).  Returns a Ticket."""
        ticket = self._make_ticket(query_hashes)
        with self._qlock:
            self._queue.append(ticket)
        self._work.set()
        return ticket

    def query(self, query_hashes, timeout: float = 60.0) -> Response:
        """Synchronous convenience: submit, then either wait on the
        worker thread or pump inline until served."""
        ticket = self.submit(query_hashes)
        if self._thread is None:
            while not ticket.done():
                if self.pump() == 0 and not ticket.done():
                    raise RuntimeError("queue drained without serving "
                                       "the submitted ticket")
        return ticket.result(timeout)

    @property
    def pending(self) -> int:
        with self._qlock:
            return len(self._queue)

    # -- view pinning ---------------------------------------------------

    def refresh_view(self) -> LiveView:
        """Pin the freshest view available WITHOUT waiting on writers:
        non-blocking lock probe, fall back to the previous pinned epoch
        when a writer is mid-mutation."""
        if self.index_lock.acquire(blocking=False):
            try:
                self._pinned = self.index.view()
            finally:
                self.index_lock.release()
        return self._pinned

    @property
    def pinned_epoch(self) -> int:
        return self._pinned.epoch

    # -- the micro-batch loop -------------------------------------------

    def pump(self, max_batches: int = 1) -> int:
        """Serve up to ``max_batches`` micro-batches from the queue;
        returns the number of requests answered."""
        served = 0
        for _ in range(max_batches):
            batch = self._take_batch()
            if not batch:
                break
            self._serve_batch(batch)
            served += len(batch)
        return served

    def _take_batch(self) -> list[Ticket]:
        with self._qlock:
            n = min(len(self._queue), self.config.batch_size)
            batch = [self._queue.popleft() for _ in range(n)]
            if not self._queue:
                self._work.clear()
        return batch

    def _serve_batch(self, batch: list[Ticket]) -> None:
        try:
            self._score_batch(batch)
        except BaseException:
            for ticket in batch:
                if not ticket.done():
                    self._resolve_unserved(ticket, "error")
            raise

    def _score_batch(self, batch: list[Ticket]) -> None:
        cfg = self.config
        # stage boundaries are SHARED timestamps: queue_wait ends where
        # assemble (or the cache-hit span) starts, so a sampled ticket's
        # top-level spans sum EXACTLY to its measured e2e latency
        traced = [t for t in batch if t.trace is not None]
        t_batch = time.perf_counter() if traced else 0.0
        for t in traced:
            t.trace.span("queue_wait", t0=t.t_submit).end(t_batch)
        view = self.refresh_view()
        epoch = view.epoch
        self.metrics.observe_epoch(epoch)
        if epoch != self._purged_epoch:
            # stale-epoch entries are already unreachable (keys carry
            # their epoch); reclaim them once per advance, not per batch
            self.cache.purge_below(epoch)
            self._purged_epoch = epoch
            self.metrics.observe_layout_mix(view.layout_mix())
        pending: list[tuple[Ticket, tuple]] = []
        for ticket in batch:
            key = self.cache.make_key(ticket.row, cfg.k, epoch)
            hit = self.cache.get(key)
            if hit is not None:
                self._respond(ticket, hit[0], hit[1], epoch, cached=True,
                              stage_t0=t_batch)
            else:
                pending.append((ticket, key))
        if not pending:
            return
        # batch-level spans (assembly, scoring + per-segment/merge
        # children) are recorded ONCE and adopted by every sampled
        # ticket in the batch: the work is genuinely shared
        btr = (Trace() if any(t.trace is not None for t, _ in pending)
               else None)
        asm = (btr.span("assemble", t0=t_batch, epoch=epoch,
                        fill=len(pending),
                        padded_slots=cfg.batch_size - len(pending))
               if btr is not None else None)
        qb = np.zeros((cfg.batch_size, cfg.n_terms_budget), np.uint32)
        for i, (ticket, _) in enumerate(pending):
            qb[i] = ticket.row
        if asm is not None:
            asm.end()
        score = (btr.span("score", t0=asm.t1, engine=cfg.engine,
                          mode=cfg.mode, segments=view.num_segments)
                 if btr is not None else None)
        result = view.topk(qb, cfg.k, cap=cfg.cap, rank_blend=cfg.rank_blend,
                           engine=cfg.engine, mode=cfg.mode, tune=cfg.tune,
                           trace=btr)
        # the view returns tensors on the index's device: one copy to the
        # host per micro-batch, which also waits for the device's work,
        # so latency_us (and the score span) include it
        ids = result.doc_ids.cpu().numpy()
        scores = result.scores.cpu().numpy()
        if score is not None:
            score.end()
        t_scored = score.t1 if score is not None else None
        for i, (ticket, key) in enumerate(pending):
            self.cache.put(key, ids[i], scores[i])
            if ticket.trace is not None:
                ticket.trace.adopt(btr.spans)
            self._respond(ticket, ids[i].copy(), scores[i].copy(), epoch,
                          cached=False, stage_t0=t_scored)
        self.metrics.batches += 1
        self.metrics.batched_queries += len(pending)
        self.metrics.padded_slots += cfg.batch_size - len(pending)

    def _respond(self, ticket: Ticket, doc_ids, scores, epoch: int,
                 cached: bool, stage_t0: float | None = None) -> None:
        now = time.perf_counter()
        latency_us = (now - ticket.t_submit) * 1e6
        tr = ticket.trace
        if tr is not None:
            # final stage closes at the SAME clock reading latency_us is
            # computed from: the stage sum is the e2e latency, exactly
            if stage_t0 is not None:
                tr.span("cache_hit" if cached else "respond",
                        t0=stage_t0, epoch=epoch).end(now)
            self.stages.observe_trace(tr)
            self.stages.observe("e2e", latency_us)
        ticket.response = Response(doc_ids, scores, epoch, latency_us,
                                   cached, trace=tr)
        self.metrics.record_response(latency_us)
        ticket._done.set()

    # -- warmup ---------------------------------------------------------

    def warmup(self) -> None:
        """One full-width batch of empty queries through the current
        view: on the card it loads the kernel library (built on first
        use) and warms the caching allocator at the serving shapes, so
        the first served batch pays for neither.  Nothing is compiled
        per shape; calling it again is harmless."""
        view = self.refresh_view()
        cfg = self.config
        qb = np.zeros((cfg.batch_size, cfg.n_terms_budget), np.uint32)
        view.topk(qb, cfg.k, cap=cfg.cap, rank_blend=cfg.rank_blend,
                  engine=cfg.engine, mode=cfg.mode, tune=cfg.tune)

    # -- worker thread ---------------------------------------------------

    def start(self) -> None:
        """Spawn the worker thread (idempotent).  A batch that raises
        ends the worker: the error is kept on ``self.error``, the queue
        is resolved with ``status="error"``, and ``stop`` re-raises."""
        if self._thread is not None:
            return
        self._stop.clear()
        self.error = None

        def loop():
            try:
                while not self._stop.is_set():
                    if self.pump(max_batches=4) == 0:
                        self._work.wait(timeout=0.005)
                self.pump(max_batches=1_000_000)   # drain on shutdown
            except BaseException as exc:    # re-raised by stop()
                self.error = exc
                self._fail_pending("error")

        self._thread = threading.Thread(target=loop, name="query-server",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the worker (if running) and resolve every still-queued
        ticket with a ``status="shutdown"`` Response: ``result()`` must
        never block until timeout on a server that has stopped.  The
        worker drains the queue normally first, so only tickets that
        raced the shutdown (or pump-mode leftovers) are failed.  Raises
        the worker's error, if it had one."""
        if self._thread is not None:
            self._stop.set()
            self._work.set()
            self._thread.join(timeout=30.0)
            self._thread = None
        self._fail_pending("shutdown")
        err, self.error = self.error, None
        if err is not None:
            raise RuntimeError("the query-server worker failed") from err

    def _fail_pending(self, status: str) -> int:
        with self._qlock:
            leftover = list(self._queue)
            self._queue.clear()
            self._work.clear()
        for ticket in leftover:
            self._resolve_unserved(ticket, status)
        return len(leftover)

    def _resolve_unserved(self, ticket: Ticket, status: str) -> None:
        """Resolve one unserved ticket as shed, with ``status``
        ("shutdown" or "error") as the reason."""
        now = time.perf_counter()
        k = self.config.k
        tr = ticket.trace
        if tr is not None:
            tr.span("shed", t0=ticket.t_submit, reason=status).end(now)
            self.stages.observe_trace(tr)
        ticket.response = Response(
            np.full(k, -1, np.int32), np.zeros(k, np.float32),
            self._pinned.epoch, (now - ticket.t_submit) * 1e6,
            False, trace=tr, status=status)
        self.registry.counter(f"serve_{status}_unserved").inc()
        ticket._done.set()
