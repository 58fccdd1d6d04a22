"""Port vs reference for the serving tier: ``repro_torch.serve``
(QueryServer, the result cache, metrics, maintenance, snapshots), the
serve launcher and the two public names ``layouts.REPRESENTATIONS`` and
``corpus.PAPER_SPEC``.

The port's server runs on the CPU (each kernel's plain version) beside
the reference's, driven by ``submit`` + ``pump`` through one schedule of
submissions, ingests, deletes, seals and maintenance runs.  Engines are
paired with their counterparts, never crossed: the port's ``fused``
with the reference's ``pallas`` (interpret mode), ``torch`` with
``jnp``.  Every comparison is exact (ids, score bits, epochs, cache
flags, statuses) unless a test says otherwise.
"""
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as rserve  # noqa: E402
from repro.core import build as rbuild, compaction as rcomp  # noqa: E402
from repro.core import layouts as rlayouts  # noqa: E402
from repro.core import live_index as rli  # noqa: E402
from repro.launch import serve as rlaunch  # noqa: E402
from repro.text import corpus as rcorpus  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import build as tbuild  # noqa: E402
from repro_torch.core import compaction as tcomp  # noqa: E402
from repro_torch.core import layouts as tlayouts  # noqa: E402
from repro_torch.core import live_index as tli  # noqa: E402
from repro_torch.core import size_model as tsize  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.text import corpus as tcorpus  # noqa: E402

K = 10


def _slice(tc, a, b, build_mod):
    return build_mod.TokenizedCorpus(tc.doc_term_ids[a:b],
                                     tc.doc_counts[a:b], tc.term_hashes,
                                     b - a)


def _pair(tc, min_run=3, **kw):
    """The reference's and the port's (CPU) index, same settings."""
    ref = rli.SegmentedIndex(term_hashes=tc.term_hashes,
                             policy=rcomp.TieredPolicy(size_ratio=4.0,
                                                       min_run=min_run), **kw)
    port = tli.SegmentedIndex(term_hashes=tc.term_hashes,
                              policy=tcomp.TieredPolicy(size_ratio=4.0,
                                                        min_run=min_run),
                              device="cpu", **kw)
    return ref, port


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(scores):
    return _np(scores).astype(np.float32).view(np.int32)


def _same_answer(got, want):
    """A port result (tensors or numpy) equals a reference result: ids
    and score bits."""
    np.testing.assert_array_equal(_np(got.doc_ids), _np(want.doc_ids))
    np.testing.assert_array_equal(_bits(got.scores), _bits(want.scores))


def _same_response(p, r):
    assert (p.epoch, p.cached, p.status) == (r.epoch, r.cached, r.status)
    np.testing.assert_array_equal(p.doc_ids, np.asarray(r.doc_ids))
    np.testing.assert_array_equal(_bits(p.scores), _bits(r.scores))


def _asdict_equal(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _stage_sum_is_latency(resp):
    """The top-level stage spans share their boundaries, so they sum to
    latency_us up to the rounding of the float sum (rel 1e-9)."""
    stages = resp.trace.stage_durations()
    assert sum(stages.values()) == pytest.approx(resp.latency_us,
                                                 rel=1e-9)
    want = ({"queue_wait", "cache_hit"} if resp.cached
            else {"queue_wait", "assemble", "score", "respond"})
    assert set(stages) == want


class _Recording:
    """Remembers every view the server pinned, by epoch."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.views = {self._pinned.epoch: self._pinned}

    def refresh_view(self):
        v = super().refresh_view()
        self.views[v.epoch] = v
        return v


class RefServer(_Recording, rserve.QueryServer):
    pass


class PortServer(_Recording, tserve.QueryServer):
    pass


def _pump(server, rows):
    tickets = [server.submit(r) for r in rows]
    while server.pending:
        server.pump()
    return [t.result(timeout=60.0) for t in tickets]


# ---------------------------------------------------------------------------
# the server under churn, both engine pairs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ref_engine,port_engine",
                         [("pallas", "fused"), ("jnp", "torch")])
def test_server_parity_under_churn(ref_engine, port_engine):
    """One schedule of submissions, ingests, deletes, seals (every
    layout) and maintenance runs drives both servers; every response is
    equal (ids, score bits, epoch, cached, status), both maintenance
    runners report the same work, and every traced response's stages
    sum to its latency."""
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=420, vocab=300,
                                             avg_distinct=14, seed=4))
    b = 48
    ref, port = _pair(tc, delta_doc_capacity=b,
                      delta_posting_capacity=b * 40)
    # the serving default, 8 x 8: at 4 x 8 the reference's own candidate
    # path computes other norm bits than its dense path (ROADMAP queue 3)
    kw = dict(batch_size=8, n_terms_budget=8, k=K, trace_sample=2)
    rs = RefServer(ref, rserve.ServerConfig(engine=ref_engine, **kw))
    ps = PortServer(port, tserve.ServerConfig(engine=port_engine, **kw))
    rm = rserve.IndexMaintenance(ref, rs.index_lock, seal_fill=0.9)
    pm = tserve.IndexMaintenance(port, ps.index_lock, seal_fill=0.9)
    first = rbuild.bulk_build(_slice(tc, 0, 120, rbuild))
    pool = list(rcorpus.sample_query_terms(first.df, tc.term_hashes, 10, 3,
                                           num_docs=120, seed=5))
    pool += list(rcorpus.sample_query_terms(first.df, tc.term_hashes, 2, 6,
                                            num_docs=120, seed=6))
    pool.append(np.array([0xDEADBEEF, pool[0][0]], np.uint32))  # absent
    rng = np.random.default_rng(0)
    seals = {3: "packed", 5: "banded", 8: "hor"}
    a, answered = 0, 0
    for step in range(9):
        for ix, srv, lib in ((ref, rs, rbuild), (port, ps, tbuild)):
            with srv.index_lock:
                if a + 60 <= tc.num_docs and step % 3 != 2:
                    ix.add_batch(_slice(tc, a, a + 60, lib))
                if step % 3 == 1:
                    ix.delete([a // 2, a // 3 + 1])
                if step in seals:
                    ix.seal(layout=seals[step])
        if a + 60 <= tc.num_docs and step % 3 != 2:
            a += 60
        assert pm.run_once() == rm.run_once()
        rows = [pool[i] for i in rng.integers(len(pool), size=10)]
        for pr, rr in zip(_pump(ps, rows), _pump(rs, rows)):
            _same_response(pr, rr)
            assert (pr.trace is None) == (rr.trace is None)
            if pr.trace is not None:
                _stage_sum_is_latency(pr)
            answered += 1
    assert _asdict_equal(pm.stats, rm.stats)
    assert port.stats.seals >= 4 and port.stats.compactions >= 1
    assert {s.layout for v in ps.views.values() for s in v.segments} == \
        {"hor", "packed", "banded"}
    assert ps.cache.hits == rs.cache.hits > 0
    assert ps.cache.misses == rs.cache.misses
    assert ps.pinned_epoch == rs.pinned_epoch
    # the served views equal the reference's at every epoch
    assert ps.views.keys() == rs.views.keys()
    ps_sum, rs_sum = ps.metrics.summary(), rs.metrics.summary()
    assert ps_sum.keys() == rs_sum.keys()
    for key in ("requests", "batches", "batch_fill", "epochs_served",
                "layout_mix", "cache_hit_rate", "cache_hits",
                "cache_misses"):
        assert ps_sum[key] == rs_sum[key], key
    assert ps_sum["requests"] == answered
    assert ps.metrics_snapshot(include_global=False).keys() == \
        rs.metrics_snapshot(include_global=False).keys()
    assert ps.stage_summary().keys() == rs.stage_summary().keys()


def test_metrics_snapshot_merges_the_engine_counters():
    from repro_torch.obs.registry import GLOBAL
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=120, vocab=120,
                                             avg_distinct=10, seed=2))
    port = tli.SegmentedIndex(term_hashes=tc.term_hashes, device="cpu")
    port.add_batch(_slice(tc, 0, 120, tbuild))
    server = tserve.QueryServer(port, tserve.ServerConfig(trace_sample=1))
    GLOBAL.counter("engine_pair_overflow")
    GLOBAL.counter("engine_truncated_terms")
    server.query(rcorpus.sample_query_terms(
        port._df, port.term_hashes, 1, 3, num_docs=120, seed=1)[0])
    snap = server.metrics_snapshot()
    for name in ("engine_pair_overflow", "engine_truncated_terms",
                 "serve_requests", "serve_stage_score_us", "index_epoch",
                 "cache_hit_rate"):
        assert name in snap, name
    assert snap["serve_requests"]["value"] == 1
    json.dumps(snap)
    assert "engine_pair_overflow" not in server.metrics_snapshot(
        include_global=False)


# ---------------------------------------------------------------------------
# views, the cache, metrics, maintenance
# ---------------------------------------------------------------------------


def test_pinned_view_is_immutable_under_mutation():
    """A pinned view keeps answering for ITS epoch after the index moves
    on (delete of its winner, ingest, seal, full compaction), and its
    answers equal the reference's pinned view's before and after."""
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=300, vocab=250,
                                             avg_distinct=15, seed=3))
    ref, port = _pair(tc, min_run=100, delta_doc_capacity=64,
                      delta_posting_capacity=4096)
    for ix, lib in ((ref, rbuild), (port, tbuild)):
        ix.add_batch(_slice(tc, 0, 200, lib))
        ix.seal()
    qh = rcorpus.sample_query_terms(ref._df, ref.term_hashes, 4, 3,
                                    num_docs=ref.live_doc_count, seed=2)
    rview, pview = rserve.pin(ref), tserve.pin(port)
    before = pview.topk(qh, k=K)
    _same_answer(before, rview.topk(qh, k=K))
    winner = int(before.doc_ids[0, 0])
    for ix, lib in ((ref, rbuild), (port, tbuild)):
        ix.delete([winner])
        ix.add_batch(_slice(tc, 200, 300, lib))
        ix.seal()
        ix.compact(all_segments=True)
    assert port.epoch == ref.epoch > pview.epoch
    again = pview.topk(qh, k=K)
    _same_answer(again, before)
    _same_answer(again, rview.topk(qh, k=K))
    now = port.topk(qh, k=K)
    _same_answer(now, ref.topk(qh, k=K))
    ids = now.doc_ids.numpy()
    assert winner not in ids[ids >= 0]


def _cache_ops(seed, n=400):
    """One op sequence for both packages' caches: (op, tenant, row, k,
    epoch)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        op = rng.choice(["get", "get", "put", "purge"], p=[.4, .2, .35, .05])
        row = rng.integers(1, 6, size=3).astype(np.uint32)
        ops.append((str(op), f"t{rng.integers(5)}", row,
                    int(rng.choice([5, 10])), int(rng.integers(0, 4))))
    return ops


def test_result_cache_and_tenant_partitions_match_reference():
    """One op sequence through both packages' ``ResultCache`` and
    ``TenantCachePartitions``: equal hits, misses, hit rates, contents,
    tenant directories and evictions; returned arrays are copies."""
    caches = [(rserve.ResultCache(8), tserve.ResultCache(8)),
              (rserve.TenantCachePartitions(4, 3),
               tserve.TenantCachePartitions(4, 3))]
    for ref, port in caches:
        tenants = isinstance(ref, rserve.TenantCachePartitions)
        for op, tenant, row, k, epoch in _cache_ops(1):
            key = ref.make_key(row, k, epoch)
            assert port.make_key(row, k, epoch) == key
            pre = (tenant,) if tenants else ()
            if op == "get":
                got, want = port.get(*pre, key), ref.get(*pre, key)
                assert (got is None) == (want is None)
                if got is not None:
                    np.testing.assert_array_equal(got[0], want[0])
                    got[0][0] = -99       # a copy: the cache is unchanged
            elif op == "put":
                ids = row.astype(np.int32) * 7
                sc = row.astype(np.float32) / 3
                port.put(*pre, key, ids, sc)
                ref.put(*pre, key, ids, sc)
            else:
                assert port.purge_below(epoch) == ref.purge_below(epoch)
            assert (port.hits, port.misses, len(port)) == \
                (ref.hits, ref.misses, len(ref))
        assert port.hit_rate == ref.hit_rate
        if tenants:
            assert port.tenants == ref.tenants
            assert port.per_tenant() == ref.per_tenant()
            assert port.tenant_evictions == ref.tenant_evictions > 0
        else:
            assert list(port._store) == list(ref._store)
        port.reset_counters()
        assert port.hits == port.misses == 0


def test_server_cache_hits_are_bit_identical_and_epoch_scoped():
    """A repeated query is a cache hit with the same bits and epoch; a
    delete advances the epoch and the fresh answer drops the winner;
    overwide queries and batches are refused at admission."""
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=200, vocab=200,
                                             avg_distinct=12, seed=6))
    port = tli.SegmentedIndex(term_hashes=tc.term_hashes,
                              delta_doc_capacity=64,
                              delta_posting_capacity=4096, device="cpu")
    port.add_batch(_slice(tc, 0, 150, tbuild))
    server = tserve.QueryServer(port, tserve.ServerConfig(
        batch_size=4, n_terms_budget=6, k=8))
    server.warmup()
    qh = rcorpus.sample_query_terms(port._df, port.term_hashes, 1, 3,
                                    num_docs=port.live_doc_count, seed=1)[0]
    r1 = server.query(qh)
    r2 = server.query(qh)
    assert not r1.cached and r2.cached and r1.epoch == r2.epoch
    np.testing.assert_array_equal(r1.doc_ids, r2.doc_ids)
    np.testing.assert_array_equal(_bits(r1.scores), _bits(r2.scores))
    winner = int(r1.doc_ids[0])
    with server.index_lock:
        port.delete([winner])
    r3 = server.query(qh)
    assert not r3.cached and r3.epoch > r1.epoch
    assert winner not in r3.doc_ids[r3.doc_ids >= 0]
    with pytest.raises(ValueError):
        server.submit(np.arange(1, 8, dtype=np.uint32))
    with pytest.raises(ValueError, match="ONE query"):
        server.submit(np.ones((2, 3), np.uint32))


def test_metrics_match_reference():
    """``percentiles``, ``LatencyWindow`` and ``ServerMetrics`` under the
    same calls give the reference's numbers (QPS is a wall-clock rate:
    only its sign is held); ``percentiles`` is the registry's own."""
    from repro.serve import metrics as rmetrics
    from repro_torch.obs import registry as tregistry
    from repro_torch.serve import metrics as tmetrics
    assert tmetrics.percentiles is tregistry.percentiles
    rng = np.random.default_rng(4)
    samples = list(rng.gamma(2.0, 300.0, size=257))
    for qs in ((50, 99), (50, 90, 99.9)):
        assert tmetrics.percentiles(samples, qs) == \
            rmetrics.percentiles(samples, qs)
    assert tmetrics.percentiles([]) == rmetrics.percentiles([])
    rw, pw = rmetrics.LatencyWindow(), tmetrics.LatencyWindow()
    for s in samples:
        rw.record(s)
        pw.record(s)
    rsum, psum = rw.summary(), pw.summary()
    assert rsum.keys() == psum.keys()
    for key in ("count", "p50_us", "p99_us", "mean_us"):
        assert psum[key] == rsum[key], key
    assert psum["qps"] >= 0.0
    np.testing.assert_array_equal(pw.samples_us(), rw.samples_us())
    rm, pm = rmetrics.ServerMetrics(), tmetrics.ServerMetrics()
    for m in (rm, pm):
        m.batched_queries, m.padded_slots = 6, 2
        for e in (3, 3, 4, 7):
            m.observe_epoch(e)
        m.observe_layout_mix({"counts": {"hor": 2}, "segments": [1]})
        for s in samples[:9]:
            m.record_response(s)
    rs, ps = rm.summary(), pm.summary()
    assert rs.keys() == ps.keys()
    for key in rs:
        if key != "qps":
            assert ps[key] == rs[key], key
    assert pm.snapshot().keys() == rm.snapshot().keys()
    with pytest.warns(DeprecationWarning):
        pm.summary(cache=object())
    pm.reset()
    assert pm.epochs_served == 0 and pm.batch_fill() == 0.0


def test_maintenance_triggers_and_stats_match_reference():
    """Seal on delta fill, compaction on the policy trigger, a layout
    policy's rewrites, and an idle no-op: both runners report the same
    work at every step and end with the same stacks."""
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=300, vocab=200,
                                             avg_distinct=12, seed=8))
    ref, port = _pair(tc, delta_doc_capacity=100,
                      delta_posting_capacity=8192)
    rm = rserve.IndexMaintenance(ref, threading.RLock(), seal_fill=0.5,
                                 max_compactions_per_run=4)
    pm = tserve.IndexMaintenance(port, threading.RLock(), seal_fill=0.5,
                                 max_compactions_per_run=4)
    idle = {"sealed": False, "compacted": 0, "rewritten": 0}
    assert pm.run_once() == rm.run_once() == idle
    for a in range(0, 240, 60):
        ref.add_batch(_slice(tc, a, a + 60, rbuild))
        port.add_batch(_slice(tc, a, a + 60, tbuild))
        assert pm.run_once() == rm.run_once()
    assert pm.stats.seals >= 3 and port.stats.compactions >= 1
    assert pm.run_once() == rm.run_once() == idle
    # a layout policy that wants packed everywhere: bounded rewrites
    from repro.core import size_model as rsize
    pm.index.layout_policy = tsize.LayoutCostModel(min_packed_docs=1,
                                                   hbm_ratio_max=10.0)
    rm.index.layout_policy = rsize.LayoutCostModel(min_packed_docs=1,
                                                   hbm_ratio_max=10.0)
    for _ in range(3):
        assert pm.run_once() == rm.run_once()
    assert _asdict_equal(pm.stats, rm.stats)
    assert pm.stats.layout_rewrites >= 1
    assert port.layout_mix() == ref.layout_mix()
    assert [e["kind"] for e in port.events.tail(None)] == \
        [e["kind"] for e in ref.events.tail(None)]
    pm.start()
    pm.start()
    pm.stop()


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------


def _mixed_pair(seed=9):
    """The same mixed hor/packed/banded stack (+ deletes, a live delta,
    vocabulary growth after the first seals) in both packages."""
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=400, vocab=250,
                                             avg_distinct=14, seed=seed))
    ref, port = _pair(tc, min_run=100, delta_doc_capacity=96,
                      delta_posting_capacity=8192)
    for ix, lib in ((ref, rbuild), (port, tbuild)):
        for i, a in enumerate(range(0, 300, 75)):
            ix.add_batch(_slice(tc, a, a + 75, lib))
            ix.seal(layout=("hor", "packed", "banded", "packed")[i])
        ix.delete([8, 120, 260])
        ix.add_batch(lib.TokenizedCorpus(
            doc_term_ids=[np.asarray([0, 1], np.int64)],
            doc_counts=[np.asarray([2, 1], np.int64)],
            term_hashes=np.array([0xDEADBEEF, 0xFEEDFACE], np.uint32),
            num_docs=1))
    qh = rcorpus.sample_query_terms(ref._df[:250], ref.term_hashes[:250], 6,
                                    3, num_docs=ref.live_doc_count, seed=2)
    return tc, ref, port, qh


def _same_index(a, b):
    """Two indexes (either package) hold the same state and stack."""
    assert (a.epoch, a.num_segments, a.live_doc_count, a.num_docs) == \
        (b.epoch, b.num_segments, b.live_doc_count, b.num_docs)
    for name in ("_df", "_norm", "_rank", "_live", "_hashes"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.layout_mix() == b.layout_mix()
    assert _asdict_equal(a.stats, b.stats)


def test_snapshot_files_cross_between_packages():
    """A ``.npz`` written by ``repro.serve.save_segmented`` loads in the
    port, and the port's loads in the reference: equal state, equal
    answers (each engine against its counterpart), and, the rank rng
    riding along, equal ranks and answers after the same later
    mutations."""
    tc, ref, port, qh = _mixed_pair()
    assert {s.layout for s in port.segments()} == {"hor", "packed",
                                                   "banded"}
    with tempfile.TemporaryDirectory() as d:
        rpath, ppath = os.path.join(d, "ref.npz"), os.path.join(d, "p.npz")
        rserve.save_segmented(ref, rpath)
        tserve.save_segmented(port, ppath, lock=threading.RLock())
        port2 = tserve.load_segmented(rpath, device="cpu")
        ref2 = rserve.load_segmented(ppath)
        with np.load(rpath) as zr, np.load(ppath) as zp:
            assert zr.files == zp.files
            for name in zr.files:
                np.testing.assert_array_equal(zp[name], zr[name], name)
    assert port2.device.type == "cpu"
    _same_index(port2, ref)
    _same_index(ref2, port)
    _same_answer(port2.topk(qh, k=K), ref.topk(qh, k=K))
    _same_answer(port2.topk(qh, k=K, engine="torch"),
                 ref2.topk(qh, k=K, engine="jnp"))
    for target, lib in ((ref, rbuild), (port2, tbuild)):
        target.add_batch(_slice(tc, 300, 400, lib))
        target.seal(layout="packed")
        target.delete([301])
    _same_index(port2, ref)
    _same_answer(port2.topk(qh, k=K, engine="torch"),
                 ref.topk(qh, k=K, engine="jnp"))


def test_snapshot_roundtrip_mixed_layouts_bitwise():
    """serialize -> restore in the port: every segment in its original
    layout with equal arrays, equal answers, and equal answers after the
    same later mutations."""
    tc, _, port, qh = _mixed_pair(seed=31)
    port3 = tserve.restore_segmented(
        tserve.serialize_segmented(port, lock=threading.RLock()),
        device="cpu")
    _same_index(port3, port)
    for s1, s3 in zip(port.segments(), port3.segments()):
        assert type(s1.index) is type(s3.index)
        assert (s1.band_cut, s1.chooser_reason, s1.size_class) == \
            (s3.band_cut, s3.chooser_reason, s3.size_class)
        ix1, ix3 = s1.index, s3.index
        if isinstance(ix1, tlayouts.BandedCsrIndex):
            pairs = [(ix1.packed, ix3.packed), (ix1.hor, ix3.hor)]
        else:
            pairs = [(ix1, ix3)]
        for a, b in pairs:
            main = "packed" if isinstance(a, tlayouts.PackedCsrIndex) \
                else "block_docs"
            assert torch.equal(getattr(a, main), getattr(b, main))
            assert torch.equal(a.docs.norm, b.docs.norm)
    assert port3.events.tail(1)[0]["kind"] == "restore"
    _same_answer(port3.topk(qh, k=K), port.topk(qh, k=K))
    for target in (port, port3):
        target.add_batch(_slice(tc, 300, 400, tbuild))
        target.seal(layout="banded")
        target.delete([301])
    _same_index(port3, port)
    _same_answer(port3.topk(qh, k=K, mode="dense"),
                 port.topk(qh, k=K, mode="dense"))


@pytest.mark.parametrize("version", [1, 2])
def test_older_snapshot_manifests_restore(version):
    """A v1 manifest (no layout policy, no per-segment size class, term
    count, chooser reason or band cut) and a v2 one (no band cut)
    restore to the same answers; v1 reports the chooser as "default"."""
    _, _, port, qh = _mixed_pair(seed=11)
    port.layout_policy = tsize.LayoutCostModel()
    state = tserve.serialize_segmented(port)
    meta = json.loads(bytes(state["meta"]).decode())
    assert meta["version"] == 3
    meta["version"] = version
    for sm in meta["segments"]:
        del sm["band_cut"]
        if version == 1:
            for key in ("size_class", "num_terms", "chooser_reason"):
                del sm[key]
    if version == 1:
        del meta["layout_policy"]
    state["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    old = tserve.restore_segmented(state, device="cpu")
    _same_answer(old.topk(qh, k=K), port.topk(qh, k=K))
    assert [s.layout for s in old.segments()] == \
        [s.layout for s in port.segments()]
    assert [s.band_cut for s in old.segments()] == \
        [s.band_cut for s in port.segments()]
    if version == 1:
        assert old.layout_policy is None
        assert {s.chooser_reason for s in old.segments()} == {"default"}
    else:
        assert old.layout_policy == port.layout_policy
    meta["version"] = 99
    state["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    with pytest.raises(ValueError, match="version"):
        tserve.restore_segmented(state, device="cpu")


def test_layout_cost_model_dict_matches_reference():
    from repro.core import size_model as rsize
    for kw in ({}, {"min_packed_docs": 9, "hbm_ratio_max": 0.5,
                    "candidates": ("hor", "packed", "banded")}):
        port, ref = tsize.LayoutCostModel(**kw), rsize.LayoutCostModel(**kw)
        assert port.to_dict() == ref.to_dict()
        assert tsize.LayoutCostModel.from_dict(ref.to_dict()) == port
    legacy = {"min_packed_docs": 7, "hbm_ratio_max": 0.8}
    assert tsize.LayoutCostModel.from_dict(legacy).candidates == \
        ("hor", "packed")


# ---------------------------------------------------------------------------
# tracing, event capacity, shutdown, failure
# ---------------------------------------------------------------------------


def _small_server(trace_sample=0, **kw):
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=240, vocab=200,
                                             avg_distinct=12, seed=9))
    port = tli.SegmentedIndex(term_hashes=tc.term_hashes,
                              delta_doc_capacity=128,
                              delta_posting_capacity=128 * 64, device="cpu")
    port.add_batch(_slice(tc, 0, 160, tbuild))
    port.seal()
    port.add_batch(_slice(tc, 160, 240, tbuild))
    server = tserve.QueryServer(port, tserve.ServerConfig(
        batch_size=4, n_terms_budget=8, k=K, trace_sample=trace_sample,
        **kw))
    pool = rcorpus.sample_query_terms(port._df, port.term_hashes, 6, 3,
                                      num_docs=port.live_doc_count, seed=2)
    return port, server, pool


def test_disabled_tracing_constructs_no_span(monkeypatch):
    port, server, pool = _small_server(trace_sample=0)
    server.warmup()

    def boom(self, *a, **k):
        raise AssertionError(f"{type(self).__name__} constructed with "
                             "tracing disabled")
    monkeypatch.setattr(ttrace.Span, "__init__", boom)
    monkeypatch.setattr(ttrace.Trace, "__init__", boom)
    responses = _pump(server, list(pool) + list(pool[:3]))
    assert len(responses) == 9 and sum(r.cached for r in responses) == 3
    assert all(r.trace is None for r in responses)
    assert server.stage_summary() == {}


def test_traced_responses_equal_untraced_and_sum_to_latency():
    """A traced server answers with the untraced server's bits; its
    stages sum to each latency, and its score span holds a segment
    child per sealed segment, the delta and the merge."""
    port, traced, pool = _small_server(trace_sample=1)
    _, plain, _ = _small_server(trace_sample=0)
    rows = list(pool) + list(pool[:2])
    for rt, ru in zip(_pump(traced, rows), _pump(plain, rows)):
        assert rt.trace is not None and ru.trace is None
        _same_response(rt, ru)
        _stage_sum_is_latency(rt)
        if not rt.cached:
            kids = [s.name for s in rt.trace.spans if s.parent == "score"]
            assert kids.count("segment") == port.num_segments == 2
            assert "delta" in kids and "merge" in kids
            seg = next(s for s in rt.trace.spans if s.name == "segment")
            for attr in ("size_class", "layout", "tile",
                         "candidate_bytes", "posting_bytes"):
                assert attr in seg.attrs, attr
    summary = traced.stage_summary()
    assert summary["e2e"]["count"] == len(rows)
    assert {"queue_wait", "assemble", "score", "respond",
            "cache_hit"} <= summary.keys()
    assert any(e["kind"] == "seal" for e in traced.events())


def test_event_capacity_resizes_the_index_ring():
    port, server, _ = _small_server(event_capacity=2)
    assert port.events.capacity == 2 and len(port.events) == 2
    total = port.events.total
    with server.index_lock:
        port.seal()
    assert len(port.events) == 2 and port.events.total == total + 1
    assert server.events(1)[0]["kind"] == "seal"


def test_shutdown_resolves_queued_tickets():
    """``stop`` resolves every queued ticket with ``status="shutdown"``
    (-1 ids, zero scores), so ``result()`` never waits out its timeout;
    the worker thread drains what it has first."""
    _, server, pool = _small_server(trace_sample=1)
    queued = [server.submit(q) for q in pool]
    server.stop()
    for t in queued:
        r = t.result(timeout=1.0)
        assert r.status == "shutdown" and not r.ok and not r.cached
        assert (r.doc_ids == -1).all() and not r.scores.any()
        assert [s.name for s in r.trace.spans] == ["shed"]
    assert server.metrics_snapshot()["serve_shutdown_unserved"]["value"] \
        == len(pool)
    server.start()
    server.start()
    served = [server.submit(q) for q in pool]
    assert all(t.result(timeout=60.0).ok for t in served)
    server.stop()


def test_failed_batch_raises_out_of_pump_and_resolves_its_tickets(
        monkeypatch):
    """A batch whose scoring raises (a kernel that cannot launch)
    re-raises out of ``pump``; its tickets resolve as ``"error"``; the
    server never answers through another engine.  The worker thread
    keeps the error and ``stop`` re-raises it."""
    _, server, pool = _small_server()

    def broken(self, *a, **kw):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(tli.LiveView, "topk", broken)
    tickets = [server.submit(q) for q in pool[:3]]
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        server.pump()
    assert [t.result(timeout=1.0).status for t in tickets] == ["error"] * 3
    server.start()
    late = server.submit(pool[3])
    assert late.result(timeout=60.0).status == "error"
    with pytest.raises(RuntimeError, match="worker failed"):
        server.stop()


# ---------------------------------------------------------------------------
# the launcher and the two public names
# ---------------------------------------------------------------------------


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


@pytest.mark.parametrize("rep", ["pr", "or", "cor", "hor", "packed"])
def test_launcher_prints_the_reference_lines(rep, monkeypatch):
    """The port's launcher on the CPU prints the reference launcher's
    corpus line (its build time aside), engine line and served/hits
    count for the same flags; timings are not compared."""
    argv = ["--repr", rep, "--docs", "300", "--vocab", "600",
            "--avg-terms", "20", "--queries", "24", "--batch", "8"]
    rc, got = _run(tlaunch.main, argv + ["--device", "cpu"])
    assert rc == 0
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    _, want = _run(lambda _: rlaunch.main(), None)
    assert len(got) == len(want) == 3
    assert got[0].split(" build=")[0] == want[0].split(" build=")[0]
    assert got[1] == want[1]
    assert got[2].split(" p50=")[0] == want[2].split(" p50=")[0]


def test_launcher_serves_shards(monkeypatch):
    """``--shards 2`` serves through the document-sharded gather engine
    on a mesh of 2 CPU shards: its ids and score bits equal the port's
    single-node gather oracle on the same queries, and it prints the
    single-node run's corpus and served/hits lines."""
    from repro_torch.core import query as tquery
    from repro_torch.distributed import retrieval as tret
    argv = ["--docs", "300", "--vocab", "600", "--avg-terms", "20",
            "--queries", "24", "--batch", "8", "--device", "cpu"]
    answers = []
    make = tret.make_doc_sharded_scorer

    def recording(*a, **kw):
        scorer = make(*a, **kw)

        def score(row):
            out = scorer(row)
            answers.append((row, out))
            return out
        return score
    monkeypatch.setattr(tret, "make_doc_sharded_scorer", recording)
    rc, got = _run(tlaunch.main, argv + ["--shards", "2"])
    assert rc == 0 and got[1] == "engine: doc-sharded x2"
    assert len(answers) == 24
    rc, single = _run(tlaunch.main, argv)
    assert got[0].split(" build=")[0] == single[0].split(" build=")[0]
    assert got[2].split(" p50=")[0] == single[2].split(" p50=")[0]
    tc = tcorpus.generate(tcorpus.CorpusSpec(num_docs=300, vocab=600,
                                             avg_distinct=20, seed=0))
    host = tbuild.bulk_build(tc)
    oracle = tquery.make_scorer(tlayouts.build_csr(host, device="cpu"), k=K,
                                cap=max(host.max_posting_len, 1))
    want = oracle(np.stack([row for row, _ in answers]))
    np.testing.assert_array_equal(
        np.stack([i.numpy() for _, (_, i) in answers]),
        want.doc_ids.numpy())
    np.testing.assert_array_equal(
        _bits(np.stack([v.numpy() for _, (v, _) in answers])),
        _bits(want.scores))


def test_representations_and_paper_spec_match_reference():
    assert tlayouts.REPRESENTATIONS.keys() == rlayouts.REPRESENTATIONS.keys()
    assert tcorpus.PAPER_SPEC == tcorpus.CorpusSpec(1_004_721, 216_449, 239)
    assert tcorpus.PAPER_SPEC.__dict__ == rcorpus.PAPER_SPEC.__dict__
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=150, vocab=200,
                                             avg_distinct=10, seed=3))
    rhost, phost = rbuild.bulk_build(tc), tbuild.bulk_build(tc)
    qh = rcorpus.sample_query_terms(rhost.df, rhost.term_hashes, 4, 3,
                                    num_docs=150, seed=1)
    from repro.core import query as rquery
    from repro_torch.core import query as tquery
    for name, builder in tlayouts.REPRESENTATIONS.items():
        port = builder(phost, device="cpu")
        ref = rlayouts.REPRESENTATIONS[name](rhost)
        assert port.nbytes() == ref.nbytes(), name
        assert port.posting_bytes() == ref.posting_bytes(), name
        if name == "banded":
            continue            # the oracle scores single layouts only
        cap = max(rhost.max_posting_len, 1)
        got = tquery.make_scorer(port, k=K, cap=cap)(qh)
        want = rquery.make_scorer(ref, k=K, cap=cap)(qh)
        _same_answer(got, want)
