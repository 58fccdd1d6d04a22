"""Port vs reference for the mesh server: ``repro_torch.serve.MeshServer``
(both topologies, replicas, handoff, admission and deadline shedding,
per-tenant cache partitions, shutdown).

One schedule of ingests, deletes, maintenance runs, handoffs and query
submissions drives the reference's ``MeshServer`` and the port's (on
the CPU: each kernel's plain version), thread-free through ``pump``.
Every response must be equal: ids, score bits, epoch, cache flag and
status.  S = 1 runs in process on a one-device JAX mesh; S = 2 and 4 run
the reference in one subprocess with four host devices.  The port's
responses are also held to the single-host ``QueryServer`` path over the
same pinned view (``view.topk``): ids exactly, scores within rtol 1e-5,
the reference's own contract between the two.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serve as rserve  # noqa: E402
from repro.core import build as rbuild, live_index as rli  # noqa: E402
from repro.text import corpus as rcorpus  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import build as tbuild, live_index as tli  # noqa: E402
from repro_torch.distributed import shmap  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
K = 10
SUB_SHARDS = (2, 4)
TOPOLOGIES = ("doc_stack", "term_fused")
FIELDS = ("ids", "scores", "epoch", "cached", "status")


def _corpus(num_docs=480):
    return rcorpus.generate(rcorpus.CorpusSpec(
        num_docs=num_docs, vocab=360, avg_distinct=20, seed=1))


def _slice(tc, a, b, build_mod):
    return build_mod.TokenizedCorpus(tc.doc_term_ids[a:b],
                                     tc.doc_counts[a:b], tc.term_hashes,
                                     b - a)


def _queries(si, n, seed):
    return rcorpus.sample_query_terms(
        np.asarray(si._df), si.term_hashes, n, 3,
        num_docs=max(si.num_docs, 1), seed=seed)


def _seeded(li_mod, build_mod, tc, **kw):
    """240 docs sealed banded, later seals packed (the maintenance and
    handoff seals), so the stack mixes layouts."""
    si = li_mod.SegmentedIndex(delta_doc_capacity=128, seal_layout="packed",
                               **kw)
    si.add_batch(_slice(tc, 0, 240, build_mod))
    si.seal(layout="banded")
    return si


def run_schedule(serve_mod, li_mod, build_mod, mesh, n_shards, topology,
                 **kw):
    """The shared schedule; returns (responses as arrays, the views
    served by epoch, the server)."""
    tc = _corpus()
    si = _seeded(li_mod, build_mod, tc, **kw)
    cfg = serve_mod.MeshConfig(batch_size=4, n_terms_budget=8, k=K,
                               n_shards=n_shards, topology=topology,
                               n_replicas=2, auto_handoff=False,
                               trace_sample=3)
    ms = serve_mod.MeshServer(si, cfg, mesh=mesh)
    ms.warmup()
    views = {ms.serving_epoch: ms.serving_view}
    tickets = []

    def ask(seed, n=4):
        qs = [ms.submit(q, tenant=f"t{i % 2}")
              for i, q in enumerate(_queries(si, n, seed))]
        ms.pump(max_batches=4)
        tickets.extend(qs)

    def handoff():
        ms.handoff()
        views[ms.serving_epoch] = ms.serving_view

    ask(1)
    ms.add_batch(_slice(tc, 240, 330, build_mod))
    ask(1)                                   # old epoch: cache hits
    handoff()
    ask(1)
    ms.delete_docs(np.arange(10, 40))
    ms.run_maintenance_once()
    handoff()
    ask(2)
    ms.add_batch(_slice(tc, 330, 480, build_mod))
    ms.run_maintenance_once()
    handoff()
    ask(3)
    ask(3)
    assert all(t.done() for t in tickets)
    out = {"ids": np.stack([np.asarray(t.response.doc_ids)
                            for t in tickets]),
           "scores": np.stack([np.asarray(t.response.scores, np.float32)
                               for t in tickets]),
           "epoch": np.asarray([t.response.epoch for t in tickets]),
           "cached": np.asarray([t.response.cached for t in tickets]),
           "status": np.asarray([t.response.status for t in tickets])}
    return out, views, ms, tickets


def reference_outputs(path):
    """The reference's schedule at SUB_SHARDS for both topologies, run
    where JAX has four host devices; saved to ``path`` (.npz)."""
    out = {}
    for s in SUB_SHARDS:
        mesh = jax.make_mesh((s,), ("shards",))
        for top in TOPOLOGIES:
            got, *_ = run_schedule(rserve, rli, rbuild, mesh, s, top)
            out.update({f"{top}/{s}/{f}": got[f] for f in FIELDS})
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref_sub(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    code = ("import importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('m', {__file__!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            f"m.reference_outputs({str(path)!r})\n")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(path))


def _port(s, top):
    return run_schedule(tserve, tli, tbuild,
                        shmap.make_mesh(s, "shards", device="cpu"), s, top,
                        device="cpu")


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _same_responses(got, want):
    for f in FIELDS:
        a, b = got[f], want[f]
        if f == "scores":
            a, b = _bits(a), _bits(b)
        np.testing.assert_array_equal(a, b, err_msg=f)


def _assert_view_parity(views, tickets, rtol=1e-5):
    """Each fresh response against ``view.topk`` of its served epoch
    (the single-host QueryServer's computation): ids exactly, scores to
    rtol; a cache hit repeats an earlier response of its epoch."""
    fresh = {}
    for t in tickets:
        r = t.response
        assert r.status == "ok"
        if r.cached:
            continue
        want = views[r.epoch].topk(t.row[None], K)
        np.testing.assert_array_equal(r.doc_ids, want.doc_ids.numpy()[0])
        np.testing.assert_allclose(r.scores, want.scores.numpy()[0],
                                   rtol=rtol)
        fresh[(r.epoch, t.row.tobytes())] = r
    for t in tickets:
        r = t.response
        if r.cached:
            f = fresh[(r.epoch, t.row.tobytes())]
            np.testing.assert_array_equal(r.doc_ids, f.doc_ids)
            np.testing.assert_array_equal(_bits(r.scores), _bits(f.scores))


# ---------------------------------------------------------------------------
# the schedule against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top", TOPOLOGIES)
def test_mesh_equals_reference_in_process(top):
    want, *_ = run_schedule(rserve, rli, rbuild,
                            jax.make_mesh((1,), ("shards",)), 1, top)
    got, views, ms, tickets = _port(1, top)
    _same_responses(got, want)
    assert got["cached"].any() and len(views) >= 4
    _assert_view_parity(views, tickets)


@pytest.mark.parametrize("s", SUB_SHARDS)
@pytest.mark.parametrize("top", TOPOLOGIES)
def test_mesh_equals_reference_sharded(ref_sub, top, s):
    got, views, ms, tickets = _port(s, top)
    _same_responses(got, {f: ref_sub[f"{top}/{s}/{f}"] for f in FIELDS})
    _assert_view_parity(views, tickets)
    # replicas agree; every handoff is counted beside its pause
    assert len({r.digest() for r in ms.replicas}) == 1
    summ = ms.mesh_summary()
    assert summ["handoffs"] == 4 and summ["handoff_pause_us"]["count"] == 4
    assert summ["n_shards"] == s and summ["n_replicas"] == 2


def test_traced_stages_and_shard_spans():
    """A sampled ticket's stages sum to its latency; the scored batch's
    spans carry the sharded scorer's shard_fanout / shard_sync."""
    _, _, ms, tickets = _port(2, "doc_stack")
    traced = [t for t in tickets if t.response.trace is not None]
    assert traced
    for t in traced:
        r = t.response
        sd = r.trace.stage_durations()
        assert sum(sd.values()) == pytest.approx(r.latency_us, rel=1e-9)
    names = {sp.name for t in traced if not t.response.cached
             for sp in t.response.trace.spans}
    assert {"shard_fanout", "shard_sync", "score"} <= names


def test_summary_and_names_match_reference():
    tc = _corpus(num_docs=260)
    r = rserve.MeshServer(_seeded(rli, rbuild, tc),
                          rserve.MeshConfig(k=K, auto_handoff=False),
                          mesh=jax.make_mesh((1,), ("shards",)))
    p = tserve.MeshServer(_seeded(tli, tbuild, tc, device="cpu"),
                          tserve.MeshConfig(k=K, auto_handoff=False))
    assert p.mesh.devices == (torch.device("cpu"),)
    assert r.mesh_summary().keys() == p.mesh_summary().keys()
    assert (set(tserve.MeshConfig.__dataclass_fields__)
            == set(rserve.MeshConfig.__dataclass_fields__) - {"backend"})
    from repro.serve import mesh as rmesh
    from repro_torch.serve import mesh as tmesh
    assert rmesh.SHED_REASONS == tmesh.SHED_REASONS


# ---------------------------------------------------------------------------
# admission, deadlines, shutdown, errors (thread-free, no sleeps)
# ---------------------------------------------------------------------------


def _server(**cfg):
    tc = _corpus(num_docs=260)
    si = _seeded(tli, tbuild, tc, device="cpu")
    return si, tserve.MeshServer(
        si, tserve.MeshConfig(batch_size=4, k=K, auto_handoff=False, **cfg))


def test_admission_and_deadline_shedding():
    si, ms = _server(max_queue=3, deadline_us=50_000.0, trace_sample=1)
    before = si.events.counts().get("shed", 0)
    tickets = [ms.submit(q, tenant=f"t{i % 2}")
               for i, q in enumerate(_queries(si, 8, seed=13))]
    admitted = [t for t in tickets if not t.done()]
    shed_now = [t for t in tickets if t.done()]
    assert len(admitted) == 3 and len(shed_now) == 5
    for t in shed_now:
        r = t.result(timeout=0)
        assert r.status == "shed" and not r.ok
        assert (r.doc_ids == -1).all() and (r.scores == 0.0).all()
        sd = r.trace.stage_durations()
        assert set(sd) == {"shed"}
        assert abs(sum(sd.values()) - r.latency_us) < 1e-3
    admitted[0].t_submit -= 1.0
    admitted[1].t_submit -= 1.0
    ms.pump(max_batches=2)
    assert [t.response.status for t in admitted] == ["shed", "shed", "ok"]
    sd = admitted[0].response.trace.stage_durations()
    assert set(sd) == {"queue_wait", "shed"}
    counts = ms.shed_counts()
    assert (counts["admission"], counts["deadline"], counts["total"]) == (
        5, 2, 7)
    assert ms.shed_rate() == pytest.approx(7 / 8)
    reasons = sorted(e["reason"] for e in ms.events(kind="shed"))
    assert reasons == ["admission"] * 5 + ["deadline"] * 2
    assert si.events.counts()["shed"] == before + 7


def test_stop_resolves_queued_tickets_as_shutdown():
    si, ms = _server()
    tickets = [ms.submit(q) for q in _queries(si, 3, seed=3)]
    ms.stop()
    for t in tickets:
        assert t.result(timeout=0.1).status == "shutdown"
    assert ms.shed_counts()["shutdown"] == 3
    assert {e["reason"] for e in ms.events(kind="shed")} == {"shutdown"}
    # threaded: the worker and both replicas' maintenance start and stop
    si2, ms2 = _server(n_replicas=2)
    ms2.warmup()
    ms2.start()
    assert all(r.maintenance._thread is not None for r in ms2.replicas)
    tickets = [ms2.submit(q) for q in _queries(si2, 6, seed=4)]
    ms2.stop()
    for t in tickets:
        assert t.result(timeout=5.0).status in ("ok", "shutdown")
    assert all(r.maintenance._thread is None for r in ms2.replicas)


def test_scoring_error_resolves_the_batch():
    si, ms = _server()

    def broken(row, trace=None):
        raise RuntimeError("kernel failed")
    ms._state.score_row = broken
    tickets = [ms.submit(q) for q in _queries(si, 2, seed=5)]
    with pytest.raises(RuntimeError, match="kernel failed"):
        ms.pump()
    assert [t.result(timeout=0).status for t in tickets] == ["error"] * 2


def test_tenant_partitions_end_to_end():
    si, ms = _server()
    q = _queries(si, 1, seed=21)[0]
    a1 = ms.submit(q, tenant="a"); ms.pump()
    a2 = ms.submit(q, tenant="a"); ms.pump()
    b1 = ms.submit(q, tenant="b"); ms.pump()
    assert not a1.response.cached and a2.response.cached
    assert not b1.response.cached
    np.testing.assert_array_equal(a2.response.doc_ids, b1.response.doc_ids)
    per = ms.cache.per_tenant()
    assert per["a"]["hits"] == 1 and per["b"]["hits"] == 0
    ms.add_batch(_slice(_corpus(), 240, 260, tbuild))
    ms.handoff()
    a3 = ms.submit(q, tenant="a"); ms.pump()
    assert not a3.response.cached and a3.response.epoch > a2.response.epoch


def test_replica_divergence_is_caught():
    si, ms = _server(n_replicas=3)
    ms.add_batch(_slice(_corpus(), 240, 330, tbuild))
    ms.delete_docs(np.arange(50, 70))
    ms.run_maintenance_once()
    ms.handoff()
    assert len({r.digest() for r in ms.replicas}) == 1
    assert all(r.index.device == torch.device("cpu") for r in ms.replicas)
    ms.replicas[1].index.delete(np.asarray([80]))
    with pytest.raises(RuntimeError, match="diverged"):
        ms.handoff()


def test_auto_handoff_and_event():
    si, ms = _server(trace_sample=1)
    ms.warmup()
    ms = tserve.MeshServer(si, tserve.MeshConfig(
        batch_size=4, k=K, auto_handoff=True, handoff_min_interval_s=0.0,
        trace_sample=1))
    e0 = ms.serving_epoch
    t = ms.submit(_queries(si, 1, seed=31)[0]); ms.pump()
    assert ms.serving_epoch == e0
    ms.add_batch(_slice(_corpus(), 240, 300, tbuild))
    t2 = ms.submit(_queries(si, 1, seed=32)[0]); ms.pump()
    assert ms.serving_epoch > e0 and t2.response.epoch == ms.serving_epoch
    assert "handoff" in t2.response.trace.stage_durations()
    ev = ms.events(kind="handoff")[-1]
    assert ev["epoch"] == ms.serving_epoch and ev["pause_us"] > 0
    assert t.response.status == "ok"


def test_config_refusals():
    tc = _corpus(num_docs=260)
    si = _seeded(tli, tbuild, tc, device="cpu")
    with pytest.raises(ValueError, match="topology"):
        tserve.MeshServer(si, tserve.MeshConfig(topology="ring"))
    with pytest.raises(ValueError, match="shards"):
        tserve.MeshServer(si, tserve.MeshConfig(n_shards=2),
                          mesh=shmap.make_mesh(3, device="cpu"))
    # an empty index serves -1 / 0.0, as the single-host view does
    empty = tli.SegmentedIndex(term_hashes=tc.term_hashes, device="cpu")
    ms = tserve.MeshServer(empty, tserve.MeshConfig(k=K, n_shards=2))
    t = ms.submit(np.asarray([tc.term_hashes[0]], np.uint32)); ms.pump()
    assert (t.response.doc_ids == -1).all()
