"""Open-loop search traffic with writes, against a live deployment.

Queries arrive on the mix's schedule whatever the server does, through
``QueryServer.submit`` to its worker thread; each is timed from when it
was due to its response (a query that never comes, or comes with an
error, counts as missing: ``inf``).  One writer, a closed loop paced by
the mix, makes a write (an add of new documents and the deletes of live
ones, under the write lock) when it is due, or at once when the previous
write was acknowledged after that.  The maintenance thread seals and
compacts in the background.  After the window every answer is judged
against the reference at the epoch it pinned, and against the writes
acknowledged before it was asked (``stale``).
"""
from __future__ import annotations

import threading
import time

import numpy as np

from portbench.gen import corpus as gen
from portbench.gen import traffic as gen_traffic
from portbench.lib import layouts
from portbench.reference import compare
from portbench.reference.tfidf import Collection

WAIT_PAST_CLOSE_S = 60.0
CHECK_ROWS = 64            # reference rows scored at once
SEGMENT_POLL_S = 0.1
HOLD_PAD_S = 0.05          # a lock hold's span, widened on each side


class Session:
    def __init__(self, system, mix: dict, seed: int, seconds: float):
        self.system = system
        self.seconds = float(seconds)
        rng = np.random.default_rng([int(seed), 11])
        q = mix["queries"]
        self.due = gen_traffic.arrivals(q["arrivals"], q["rate_per_s"],
                                        self.seconds, rng)
        lens = gen_traffic.lengths(q["terms"], len(self.due), rng)
        width = system.server.config.n_terms_budget
        self.rows = gen_traffic.query_rows(
            system.base_df, system.hashes, system.spec.num_docs, lens, width,
            q["df_band"], seed)
        w = mix["writes"]
        period = float(w["period_s"])
        n_writes = int(self.seconds // period)
        self.write_due = (np.arange(n_writes) + 0.5) * period
        spec = gen.Spec(w["add_docs"] * (n_writes + 1), system.spec.vocab,
                        system.spec.avg_distinct, system.spec.zipf_s)
        self._new = gen.generate(spec, seed, "writes", system.device)
        self._add = int(w["add_docs"])
        self._del = int(w["delete_docs"])
        self._del_rng = np.random.default_rng([int(seed), 13])
        self._next = 0

    def _write(self) -> int:
        lo = self._next * self._add
        docs = self._new.slice(lo, lo + self._add)
        self._next += 1
        picks = []
        live = self.system.live
        while len(picks) < self._del:
            d = int(self._del_rng.integers(0, self.system.n_docs))
            if live[d] and d not in picks:
                picks.append(d)
        return self.system.write(docs, np.array(picks, np.int64))

    def warm(self) -> None:
        """Load the kernels and serve two batches through the server,
        before its threads start (set-up's churn has already taken the
        write path through adds, deletes, refreshes and seals)."""
        srv = self.system.server
        srv.warmup()
        tickets = [srv.submit(r) for r in self.rows[:2 * srv.config
                                                    .batch_size]]
        while srv.pending:
            srv.pump()
        for t in tickets:
            if not t.result(timeout=60.0).ok:
                raise RuntimeError("a warm-up query failed")

    def window(self) -> None:
        sys_ = self.system
        self.stats0 = _stats(sys_.si)
        self.epoch0 = sys_.si.epoch       # every write of set-up
        sys_.maintenance.start()
        sys_.server.start()
        self.writes = []
        start = time.perf_counter() + 0.01
        self.t_start, self.t_wall_start = start, time.time() + 0.01

        def writer():
            for due in self.write_due:
                _sleep_until(start + due)
                t0 = time.perf_counter()
                epoch = self._write()
                self.writes.append((start + due, t0, time.perf_counter(),
                                    epoch))
        wt = threading.Thread(target=writer, name="bench-writer")
        traced = bool(sys_.server.config.trace_sample)
        self._segments: dict = {}
        stop_poll = threading.Event()
        poller = threading.Thread(target=self._poll_segments,
                                  args=(stop_poll,), name="bench-segments")
        if traced:
            self._poll_once()
            poller.start()
        wt.start()
        self.tickets, self.late = [], []
        for due, row in zip(self.due, self.rows):
            _sleep_until(start + due)
            self.late.append(time.perf_counter() - (start + due))
            self.tickets.append(sys_.server.submit(row))
        close = start + self.seconds
        self.responses = []
        for t in self.tickets:
            try:
                r = t.result(timeout=max(close + WAIT_PAST_CLOSE_S
                                         - time.perf_counter(), 0.001))
            except TimeoutError:
                r = None
            self.responses.append(r)
        wt.join(timeout=max(close + WAIT_PAST_CLOSE_S - time.perf_counter(),
                            0.001))
        if wt.is_alive():
            raise RuntimeError("a write did not finish within a minute "
                               "past the window")
        self.t_end = max([start + self.seconds]
                         + [w[2] for w in self.writes]
                         + [t.t_submit + r.latency_us * 1e-6
                            for t, r in zip(self.tickets, self.responses)
                            if r is not None])
        if traced:
            stop_poll.set()
            poller.join()
            self._poll_once()
        # a maintenance run logs its lock hold when it ends: end them all
        sys_.maintenance.stop()
        self.stats1 = _stats(sys_.si)
        self.events = sys_.si.events.tail()
        self.events_lost = (sys_.si.events.counts().get("maintenance_run", 0)
                            - sum(e["kind"] == "maintenance_run"
                                  for e in self.events))
        self.server_tids = _native_ids("query-server")
        self.segment_layouts = {key: layouts.bands(ix)
                                for key, ix in self._segments.items()}
        self._segments = {}

    def _poll_once(self) -> None:
        for s in self.system.si.segments():
            key = (int(s.doc_base), s.layout, int(s.size_class))
            self._segments.setdefault(key, s.index)

    def _poll_segments(self, stop: threading.Event) -> None:
        """Keeps every sealed segment the window's batches may score
        (a traced run's work count reads their layouts)."""
        while not stop.wait(SEGMENT_POLL_S):
            self._poll_once()

    def batches(self) -> list:
        """The traced batches: their rows, fill, epoch and spans."""
        out: dict = {}
        for t in self.tickets:
            if t.trace is None:
                continue
            asm = next((sp for sp in t.trace.spans
                        if sp.name == "assemble"), None)
            if asm is None:
                continue
            b = out.setdefault(id(asm), {"rows": [], "spans": [
                sp for sp in t.trace.spans
                if sp.name not in ("queue_wait", "respond", "cache_hit")],
                "fill": asm.attrs["fill"], "epoch": asm.attrs["epoch"]})
            b["rows"].append(t.row)
        return list(out.values())

    # -- end-to-end metrics ------------------------------------------------

    def e2e(self) -> dict:
        from portbench.yardstick.stats import percentile
        return {"query_p95_ms": percentile(self.latencies_ms(), 95)}

    def latencies_ms(self) -> np.ndarray:
        out = []
        for due, t, r in zip(self.due, self.tickets, self.responses):
            if r is None or not r.ok:
                out.append(np.inf)
            else:
                out.append((t.t_submit + r.latency_us * 1e-6
                            - (self.t_start + due)) * 1e3)
        return np.array(out)

    def write_latencies_ms(self) -> np.ndarray:
        """Each write's latency: due to acknowledged."""
        return np.array([(ack - due) * 1e3
                         for due, _, ack, _ in self.writes])

    def notes(self) -> str:
        """How late the generator ran, each write's latency, the answers
        the result cache gave, and the answers that missed a write
        acknowledged before they were asked (the lock was held while
        they waited: the server's documented fallback)."""
        late = np.array(self.late) * 1e3
        ok = [r for r in self.responses if r is not None and r.ok]
        cached = sum(bool(r.cached) for r in ok)
        behind = compare.behind(self.answers(), self.acks())
        return (f"generator late ms: p50 {np.median(late):.3f} max "
                f"{late.max():.3f}; writes ms from due to ack: " + " ".join(
                    f"{x:.1f}" for x in self.write_latencies_ms())
                + f"; cached answers {cached} of {len(ok)}"
                + f"; answers behind an acknowledged write {behind}")

    def answers(self) -> list:
        """(asked, answered, epoch) of every answer that came."""
        return [(t.t_submit, t.t_submit + r.latency_us * 1e-6, r.epoch)
                for t, r in zip(self.tickets, self.responses)
                if r is not None and r.ok]

    def acks(self) -> list:
        """(acknowledged, epoch) of every write: set-up's, then the
        window's."""
        return [(-np.inf, self.epoch0)] + [(ack, epoch)
                                          for _, _, ack, epoch in self.writes]

    def lock_holds(self) -> list:
        """(t0, t1) spans that hold every moment the write lock may have
        been held in the window: each write from when it was sent to its
        acknowledgement, each maintenance run from before it asked for
        the lock to its end (its ``maintenance_run`` event), each widened
        by ``HOLD_PAD_S``."""
        off = time.time() - time.perf_counter()
        out = [(sent, ack) for _, sent, ack, _ in self.writes]
        for e in self.events:
            if e["kind"] == "maintenance_run":
                t1 = e["t_wall"] - off
                out.append((t1 - e["duration_us"] * 1e-6, t1))
        return [(a - HOLD_PAD_S, b + HOLD_PAD_S) for a, b in out]

    def attempted(self) -> int:
        return len(self.tickets) + len(self.writes)

    def failed(self) -> int:
        return (sum(r is None or not r.ok for r in self.responses)
                + (len(self.write_due) - len(self.writes)))

    def host_spans(self) -> list:
        """(label, t0, t1) of what the host was doing in the window: the
        server's stage spans of each batch, the writes, the index's seals
        and compactions."""
        out = [("write", t0, t1) for _, t0, t1, _ in self.writes]
        seen = set()
        for t in self.tickets:
            tr = t.trace
            if tr is None:
                continue
            for sp in tr.spans:
                if id(sp) in seen or sp.t1 is None:
                    continue
                seen.add(id(sp))
                if sp.name in ("queue_wait", "respond", "cache_hit"):
                    continue
                out.append((sp.name, sp.t0, sp.t1))
        off = time.time() - time.perf_counter()
        for e in self.events:
            if e["kind"] in ("seal", "compact") and "duration_us" in e:
                t1 = e["t_wall"] - off
                out.append((e["kind"], t1 - e["duration_us"] * 1e-6, t1))
        return out

    # -- correctness -------------------------------------------------------

    def check(self, device, control: bool = False) -> dict:
        sys_ = self.system
        doc, term, count = sys_.triples()
        col = Collection(doc, term, count, sys_.n_docs, sys_.spec.vocab,
                         device)
        tally, tally_c = compare.Tally(), compare.Tally()
        # a write never acknowledged is an answer that never came
        tally.unanswered += len(self.write_due) - len(self.writes)
        if self.events_lost:
            raise RuntimeError(f"{self.events_lost} maintenance runs fell "
                               "out of the index's event log")
        tally.stale = compare.stale(self.answers(), self.acks(),
                                    self.lock_holds())
        term_of = _term_ids(sys_.hashes)
        by_epoch: dict = {}
        for i, r in enumerate(self.responses):
            if r is None or not r.ok:
                tally.unanswered += 1
                continue
            by_epoch.setdefault(r.epoch, []).append(i)
        import torch
        for epoch, idx in sorted(by_epoch.items()):
            live = torch.from_numpy(sys_.live_at(epoch)).to(col.device)
            idf, norm = col.weights(live)
            if control:
                idf_c, norm_c = col.weights(live, torch.bfloat16)
            for a in range(0, len(idx), CHECK_ROWS):
                part = idx[a:a + CHECK_ROWS]
                terms = [term_of(self.rows[i]) for i in part]
                final = col.scores(terms, idf, norm, live)
                ids = np.stack([self.responses[i].doc_ids for i in part])
                sc = np.stack([self.responses[i].scores for i in part])
                compare.judge(tally, final, live, ids, sc, sys_.k)
                if control:
                    ci, cs = compare.control_answers(
                        col.scores(terms, idf_c, norm_c, live), sys_.k)
                    compare.judge(tally_c, final, live, ci, cs, sys_.k)
                del final
        out = {"program": tally.numbers(), "checked": tally.checked}
        if control:
            out["control"] = tally_c.numbers()
        return out


def _sleep_until(t: float) -> None:
    d = t - time.perf_counter()
    if d > 0:
        time.sleep(d)


def _stats(si) -> dict:
    s = si.stats
    return {"postings_appended": s.postings_appended,
            "postings_merged": s.postings_merged}


def _native_ids(name: str) -> set:
    """Every id the trace may name the thread ``name`` by."""
    from portbench.lib.profiling import thread_ids
    return {i for t in threading.enumerate() if t.name == name
            for i in thread_ids(t)}


def _term_ids(hashes: np.ndarray):
    order = np.argsort(hashes)
    srt = hashes[order]

    def of(row):
        h = np.asarray(row, np.uint32)
        h = h[h != 0]
        pos = np.minimum(np.searchsorted(srt, h), len(srt) - 1)
        return order[pos][srt[pos] == h]
    return of
