r"""MeshServer: the serving path over sharded, replicated live indexes
(the port of ``repro.serve.mesh``): admission, micro-batch, shard
fan-out, candidate merge, response.

``QueryServer``-shaped micro-batches route through a sharded engine over
a PINNED epoch: the doc-sharded segment stack
(``retrieval.make_doc_sharded_segment_scorer``, the default) or the
term-sharded fused engine.  Index replicas run their own
``IndexMaintenance``, and a handoff publishes the primary's next epoch
to the shards::

                 submit(query, tenant)
                        |
               [admission control]  -- queue full -> shed("admission")
                        |
                 micro-batch pump   -- past deadline -> shed("deadline")
                        |
              per-tenant ResultCache -------------------- hit -> respond
                        |
          MeshEpochState (pinned epoch E)
             /      |        \
        shard 0  shard 1 ... shard S-1     one engine call per local
           \        |        /             segment slot
            all-gather candidate merge
                        |
                     respond

One controller drives the S shards (``distributed.shmap``): on one card
they share it and run in turn; replicas, the admission queue and the
tickets live in this process.

Consistency contract: a response equals a single-host ``QueryServer``
over the same pinned ``LiveView`` (ids, tie order included; scores to
rounding, as the reference's own test holds them), whatever churn does
meanwhile.  Handoff swaps the served ``MeshEpochState`` BETWEEN
micro-batches, so a batch never mixes epochs.

Shedding resolves a ticket at once with ``status="shed"`` (empty ids,
zero scores), counted per reason and logged to the index's ``EventLog``
next to the seal and compaction events.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.distributed import retrieval, shmap
from repro_torch.obs.trace import Trace
from repro_torch.serve.cache import TenantCachePartitions
from repro_torch.serve.maintenance import IndexMaintenance
from repro_torch.serve.server import (QueryServer, Response, ServerConfig,
                                      Ticket)
from repro_torch.serve.snapshot import restore_segmented, serialize_segmented

SHED_REASONS = ("admission", "deadline", "shutdown")


@dataclasses.dataclass(frozen=True)
class MeshConfig(ServerConfig):
    """ServerConfig + the mesh-only knobs.

    ``n_shards`` shards along mesh axis ``axis`` serve each query;
    ``topology`` picks the engine: ``"doc_stack"`` (the default) shards
    whole sealed segments, ``"term_fused"`` partitions the vocabulary
    (``term_layout`` hor / packed / banded) and rebuilds at every
    handoff, the right trade only for near-static corpora.

    ``n_replicas`` full index replicas absorb writes in lockstep (the
    clone carries the rng state); each runs its own maintenance with
    ``seal_fill`` / ``maintenance_interval_s``.

    Admission control: at most ``max_queue`` tickets wait (``None`` =
    unbounded); a submit beyond that resolves at once as
    ``shed("admission")``.  Deadline shedding: a ticket older than
    ``deadline_us`` at batch pickup resolves as ``shed("deadline")``.

    ``auto_handoff`` re-pins after the primary's epoch advances (at
    most once per ``handoff_min_interval_s``, between micro-batches);
    tests drive ``handoff()`` with it off."""
    n_shards: int = 1
    axis: str = "shards"
    topology: str = "doc_stack"
    term_layout: str = "hor"
    n_replicas: int = 1
    max_queue: int | None = None
    deadline_us: float | None = None
    cache_capacity_per_tenant: int = 1024
    max_tenants: int = 64
    seal_fill: float = 0.75
    maintenance_interval_s: float = 0.002
    auto_handoff: bool = True
    handoff_min_interval_s: float = 0.05


class ShardReplica:
    """One full-index replica: a ``SegmentedIndex`` clone with its own
    write lock and ``IndexMaintenance``.  The mesh applies every
    mutation to every replica; seal and compaction are deterministic, so
    replicas that saw the same writes answer alike at equal epochs."""

    def __init__(self, index, cfg: MeshConfig):
        self.index = index
        self.lock = threading.RLock()
        self.maintenance = IndexMaintenance(
            index, self.lock, seal_fill=cfg.seal_fill,
            interval_s=cfg.maintenance_interval_s,
            layout_policy=cfg.layout_policy)

    def digest(self) -> tuple:
        """Divergence signature over QUERY-VISIBLE state (docs, live
        docs, df), compared across replicas at handoff.  Segment
        structure is left out: maintenance timing differs per replica
        and never changes answers; a write that bypassed the mesh does,
        and this catches it."""
        ix = self.index
        with self.lock:
            return (ix.num_docs, ix.live_doc_count,
                    int(np.asarray(ix._df).sum()))


@dataclasses.dataclass
class MeshEpochState:
    """What the pump serves one pinned epoch with: the view (the parity
    reference), the sharded scorer, and the group structure for
    tracing: on the doc topology, the stack's ``signature()`` (one
    ``StackGroupMeta`` a group, slots included)."""
    epoch: int
    view: object
    score_row: object          # fn(row u32[T], trace=None) -> (ids, scores)
    topology: str
    n_groups: int
    groups: tuple = ()


def _null_score_row(k: int):
    def score_row(row, trace=None):
        return np.full(k, -1, np.int32), np.zeros(k, np.float32)
    return score_row


def _host(vv, ii) -> tuple[np.ndarray, np.ndarray]:
    """A scorer's (scores, ids) tensors as host numpy."""
    return vv.cpu().numpy(), ii.cpu().numpy()


class MeshServer(QueryServer):
    """Sharded, replicated QueryServer (see the module docstring).

    Drive it like the single-host server: ``submit`` / ``pump`` for the
    deterministic path, ``start`` / ``stop`` for the worker thread (which
    also start and stop every replica's maintenance thread).  Mutations
    go through ``add_batch`` / ``delete_docs`` so all replicas stay in
    lockstep; ``handoff()`` (or ``auto_handoff``) publishes the next
    epoch to the shards.  ``mesh=None`` builds
    ``shmap.make_mesh(cfg.n_shards, cfg.axis)`` on the index's device.
    """

    def __init__(self, index, config: MeshConfig | None = None,
                 mesh: shmap.Mesh | None = None):
        cfg = config or MeshConfig()
        if cfg.topology not in ("doc_stack", "term_fused"):
            raise ValueError(f"unknown mesh topology {cfg.topology!r}")
        self.mesh = (mesh if mesh is not None
                     else shmap.make_mesh(cfg.n_shards, cfg.axis,
                                          device=index.device))
        if self.mesh.shape.get(cfg.axis) != cfg.n_shards:
            raise ValueError(
                f"mesh axis {cfg.axis!r} has "
                f"{self.mesh.shape.get(cfg.axis)} devices but config asks "
                f"for {cfg.n_shards} shards")
        # replicas BEFORE super().__init__: the clone must not see the
        # layout_policy install (it gets its own below)
        primary = ShardReplica(index, cfg)
        self.replicas = [primary]
        for _ in range(cfg.n_replicas - 1):
            clone = restore_segmented(serialize_segmented(index),
                                      device=index.device)
            self.replicas.append(ShardReplica(clone, cfg))
        super().__init__(index, cfg, lock=primary.lock)
        if cfg.layout_policy is not None:
            for r in self.replicas[1:]:
                r.index.layout_policy = cfg.layout_policy
        if cfg.event_capacity is not None:
            for r in self.replicas[1:]:
                r.index.events.resize(cfg.event_capacity)
        # per-tenant result-cache partitions replace the flat LRU; the
        # metrics gauges follow the attach
        self.cache = TenantCachePartitions(cfg.cache_capacity_per_tenant,
                                           cfg.max_tenants)
        self.metrics.attach_cache(self.cache)
        for reason in SHED_REASONS:
            self.registry.counter(f"mesh_shed_{reason}")
        self.registry.counter("mesh_shed_total")
        self.registry.counter("mesh_handoffs")
        self.registry.gauge("mesh_shards").set(cfg.n_shards)
        self.registry.register_callback(
            "mesh_epoch", lambda: self._state.epoch)
        self._state: MeshEpochState | None = None
        self._last_handoff_t = float("-inf")
        self.handoff()

    # -- writes: fan out to every replica --------------------------------

    def add_batch(self, corpus) -> None:
        """Ingest one tokenized batch on EVERY replica."""
        for r in self.replicas:
            with r.lock:
                r.index.add_batch(corpus)

    def delete_docs(self, doc_ids) -> None:
        for r in self.replicas:
            with r.lock:
                r.index.delete(doc_ids)

    def run_maintenance_once(self) -> list[dict]:
        """One deterministic maintenance step per replica."""
        return [r.maintenance.run_once() for r in self.replicas]

    # -- epoch handoff ----------------------------------------------------

    def handoff(self) -> float:
        """Cross-shard epoch handoff: seal every replica's delta (the
        shards replicate immutable runs only), pin the primary's view,
        build the sharded state and swap it in between micro-batches.
        Returns the pause (seconds spent before the swap) and logs a
        ``handoff`` event with it."""
        t0 = time.perf_counter()
        view = None
        for r in self.replicas:
            with r.lock:
                if r.index._delta.n_docs > 0:
                    r.index.seal()
                if r is self.replicas[0]:
                    view = r.index.view()
        self._check_replicas()
        state = self._build_state(view)
        prev = self._state.epoch if self._state is not None else -1
        self._state = state
        self._pinned = view          # keep the QueryServer surface honest
        self._last_handoff_t = time.perf_counter()
        pause_us = (self._last_handoff_t - t0) * 1e6
        self.registry.counter("mesh_handoffs").inc()
        self.registry.histogram("mesh_handoff_pause_us").observe(pause_us)
        self.metrics.observe_layout_mix(view.layout_mix())
        self.index.events.emit(
            "handoff", epoch=state.epoch, prev_epoch=prev,
            n_shards=self.config.n_shards, topology=state.topology,
            groups=state.n_groups, pause_us=pause_us)
        return pause_us / 1e6

    def _check_replicas(self) -> None:
        ref = self.replicas[0].digest()
        for i, r in enumerate(self.replicas[1:], start=1):
            if r.digest() != ref:
                raise RuntimeError(
                    f"replica {i} diverged from primary ({r.digest()} != "
                    f"{ref}) — mutate through the mesh (add_batch/"
                    "delete_docs), not a replica's index directly")

    def _build_state(self, view) -> MeshEpochState:
        cfg = self.config
        k = cfg.k
        # nothing to shard: no sealed segments (doc topology) or no live
        # docs (term topology); the single-host view answers all -1 / 0.0
        # there too
        empty = (view.num_segments == 0 if cfg.topology == "doc_stack"
                 else view.live_docs == 0)
        if empty:
            return MeshEpochState(view.epoch, view, _null_score_row(k),
                                  cfg.topology, 0)
        if cfg.topology == "term_fused":
            tix, live_ids = retrieval.build_term_sharded_from_view(
                view, cfg.n_shards, layout=cfg.term_layout)
            scorer = retrieval.make_term_sharded_fused_scorer(
                tix, self.mesh, cfg.axis, k=k, cap=cfg.cap)

            def score_row(row, trace=None):
                vv, ii = _host(*scorer(np.asarray(row, np.uint32),
                                       trace=trace))
                hit = np.isfinite(vv) & (ii >= 0)
                gids = np.where(hit, live_ids[np.maximum(ii, 0)], -1)
                return (gids.astype(np.int32),
                        np.where(hit, vv, 0.0).astype(np.float32))

            return MeshEpochState(view.epoch, view, score_row,
                                  cfg.topology, cfg.n_shards)
        stacks = retrieval.stack_segment_shards(view, cfg.n_shards)
        scorer = retrieval.make_doc_sharded_segment_scorer(
            stacks, self.mesh, cfg.axis, k=k)

        def score_row(row, trace=None):
            vv, ii = _host(*scorer(np.asarray(row, np.uint32), trace=trace))
            hit = np.isfinite(vv)
            return (np.where(hit, ii, -1).astype(np.int32),
                    np.where(hit, vv, 0.0).astype(np.float32))

        return MeshEpochState(view.epoch, view, score_row, cfg.topology,
                              len(stacks.groups), stacks.signature())

    def _handoff_due(self) -> bool:
        cfg = self.config
        if not cfg.auto_handoff:
            return False
        if self.replicas[0].index.epoch == self._state.epoch:
            return False
        return (time.perf_counter() - self._last_handoff_t
                >= cfg.handoff_min_interval_s)

    @property
    def serving_epoch(self) -> int:
        return self._state.epoch

    @property
    def serving_view(self):
        """The pinned LiveView currently served: the single-host parity
        reference for this epoch."""
        return self._state.view

    # -- admission + shedding ---------------------------------------------

    def submit(self, query_hashes, tenant: str = "default") -> Ticket:
        """Enqueue one query for ``tenant``, or, when the admission queue
        is at ``max_queue``, resolve it at once as shed."""
        ticket = self._make_ticket(query_hashes, tenant=tenant)
        cfg = self.config
        with self._qlock:
            if cfg.max_queue is not None and len(self._queue) >= cfg.max_queue:
                admitted = False
            else:
                self._queue.append(ticket)
                admitted = True
        if admitted:
            self._work.set()
        else:
            self._shed(ticket, "admission")
        return ticket

    def _shed(self, ticket: Ticket, reason: str,
              stage_t0: float | None = None,
              status: str = "shed") -> None:
        """Resolve ``ticket`` without serving it.  The shed span closes
        at the same clock reading the latency is computed from."""
        now = time.perf_counter()
        latency_us = (now - ticket.t_submit) * 1e6
        tr = ticket.trace
        if tr is not None:
            tr.span("shed",
                    t0=stage_t0 if stage_t0 is not None else ticket.t_submit,
                    reason=reason).end(now)
            self.stages.observe_trace(tr)
        k = self.config.k
        epoch = self._state.epoch if self._state is not None else -1
        ticket.response = Response(
            np.full(k, -1, np.int32), np.zeros(k, np.float32), epoch,
            latency_us, False, trace=tr, status=status)
        self.registry.counter("mesh_shed_total").inc()
        self.registry.counter(f"mesh_shed_{reason}").inc()
        self.index.events.emit("shed", reason=reason, tenant=ticket.tenant,
                               epoch=epoch, latency_us=latency_us)
        ticket._done.set()

    def _resolve_unserved(self, ticket: Ticket, status: str) -> None:
        # stop() leftovers count and log as sheds on the mesh; a batch
        # whose scoring raised resolves as the single-host server does
        if status == "shutdown":
            self._shed(ticket, "shutdown", status="shutdown")
        else:
            super()._resolve_unserved(ticket, status)

    def shed_counts(self) -> dict:
        out = {r: self.registry.counter(f"mesh_shed_{r}").value
               for r in SHED_REASONS}
        out["total"] = self.registry.counter("mesh_shed_total").value
        return out

    def shed_rate(self) -> float:
        """Shed over offered (served + shed) requests."""
        shed = self.registry.counter("mesh_shed_total").value
        offered = self.metrics.requests + shed
        return shed / offered if offered else 0.0

    # -- the sharded micro-batch ------------------------------------------

    def _score_batch(self, batch: list[Ticket]) -> None:
        cfg = self.config
        traced = [t for t in batch if t.trace is not None]
        t_pickup = time.perf_counter() if traced else 0.0
        # handoff rides BETWEEN pickup and assembly so its cost is a
        # visible stage of the batch that paid it
        t_ready = t_pickup
        if self._handoff_due():
            self.handoff()
            if traced:
                t_ready = time.perf_counter()
        for t in traced:
            t.trace.span("queue_wait", t0=t.t_submit).end(t_pickup)
            if t_ready != t_pickup:
                t.trace.span("handoff", t0=t_pickup,
                             epoch=self._state.epoch).end(t_ready)
        state = self._state
        epoch = state.epoch
        self.metrics.observe_epoch(epoch)
        if epoch != self._purged_epoch:
            self.cache.purge_below(epoch)
            self._purged_epoch = epoch
        live: list[Ticket] = []
        for ticket in batch:
            if cfg.deadline_us is not None and (
                    (time.perf_counter() - ticket.t_submit) * 1e6
                    > cfg.deadline_us):
                self._shed(ticket, "deadline",
                           stage_t0=t_ready if ticket.trace is not None
                           else None)
            else:
                live.append(ticket)
        pending: list[tuple[Ticket, tuple]] = []
        for ticket in live:
            key = self.cache.make_key(ticket.row, cfg.k, epoch)
            hit = self.cache.get(ticket.tenant, key)
            if hit is not None:
                self._respond(ticket, hit[0], hit[1], epoch, cached=True,
                              stage_t0=t_ready)
            else:
                pending.append((ticket, key))
        if not pending:
            return
        btr = (Trace() if any(t.trace is not None for t, _ in pending)
               else None)
        asm = (btr.span("assemble", t0=t_ready, epoch=epoch,
                        fill=len(pending),
                        padded_slots=cfg.batch_size - len(pending))
               if btr is not None else None)
        rows = [ticket.row for ticket, _ in pending]
        if asm is not None:
            asm.end()
        score = (btr.span("score", t0=asm.t1, topology=state.topology,
                          n_shards=cfg.n_shards, groups=state.n_groups)
                 if btr is not None else None)
        # shard fan-out per row: one query per sharded-scorer call
        results = [state.score_row(row, trace=btr) for row in rows]
        if score is not None:
            score.end()
        t_scored = score.t1 if score is not None else None
        for (ticket, key), (ids, scores) in zip(pending, results):
            self.cache.put(ticket.tenant, key, ids, scores)
            if ticket.trace is not None:
                ticket.trace.adopt(btr.spans)
            self._respond(ticket, ids.copy(), scores.copy(), epoch,
                          cached=False, stage_t0=t_scored)
        self.metrics.batches += 1
        self.metrics.batched_queries += len(pending)
        self.metrics.padded_slots += cfg.batch_size - len(pending)

    # -- warmup / lifecycle -----------------------------------------------

    def warmup(self) -> None:
        """One empty row through the current epoch's sharded path: on
        the card it loads the kernel library and warms the allocator.
        Nothing is compiled per shape."""
        self._state.score_row(np.zeros(self.config.n_terms_budget,
                                       np.uint32))

    def start(self) -> None:
        for r in self.replicas:
            r.maintenance.start()
        super().start()

    def stop(self) -> None:
        for r in self.replicas:
            r.maintenance.stop()
        super().stop()       # drains, then sheds leftovers ("shutdown")

    def mesh_summary(self) -> dict:
        """``ServerMetrics.summary()`` + the mesh-side aggregates."""
        out = self.metrics.summary()
        hist = self.registry.histogram("mesh_handoff_pause_us").snapshot()
        out.update(
            epoch=self._state.epoch, topology=self.config.topology,
            n_shards=self.config.n_shards,
            n_replicas=len(self.replicas),
            shed=self.shed_counts(), shed_rate=self.shed_rate(),
            handoffs=self.registry.counter("mesh_handoffs").value,
            handoff_pause_us={k: hist[k]
                              for k in ("count", "p50", "p99")
                              if k in hist},
            tenants=self.cache.per_tenant())
        return out
