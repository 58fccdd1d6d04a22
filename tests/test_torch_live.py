"""Port vs reference for the live-index slice: ``SegmentedIndex`` /
``LiveView`` (ingest, delete, seal in every layout, compact, layout
rewrite), the delta scorers and ``add_documents``.

The port's index runs on the CPU (plain kernel versions) beside the
reference's on the same schedule.  State (norms, df, ranks, stats,
segment layouts, size classes, band cuts, every segment's arrays, the
exported live corpus) must be EQUAL.  Answers are held engine to
counterpart, ids and score bits: the fused engine in each mode to the
reference's Pallas engine in that mode, the gather oracle to its jnp
oracle, the AND filter to its AND filter.  The reference's own two
engines are up to 2 ulp apart (its Pallas kernels add each ``qw * tf``
as one fused multiply-add, its oracle rounds the product first), so
they are paired, never crossed; all of them rank the oracle's ids.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import build as rbuild, compaction as rcomp  # noqa: E402
from repro.core import layouts as rlayouts  # noqa: E402
from repro.core import live_index as rli, size_model as rsize  # noqa: E402
from repro.text import corpus as rcorpus  # noqa: E402
from repro_torch.core import build as tbuild, compaction as tcomp  # noqa: E402
from repro_torch.core import layouts as tlayouts, query as tquery  # noqa: E402
from repro_torch.core import live_index as tli, size_model as tsize  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.obs.trace import Trace  # noqa: E402

K = 10


def _slices(tc, bounds, build_mod):
    return [build_mod.TokenizedCorpus(tc.doc_term_ids[a:b], tc.doc_counts[a:b],
                                      tc.term_hashes, b - a)
            for a, b in zip(bounds[:-1], bounds[1:])]


def _pair(tc, min_run=3, **kw):
    """The reference's and the port's index, same settings."""
    ref = rli.SegmentedIndex(term_hashes=tc.term_hashes,
                             policy=rcomp.TieredPolicy(size_ratio=4.0,
                                                       min_run=min_run), **kw)
    port = tli.SegmentedIndex(term_hashes=tc.term_hashes,
                              policy=tcomp.TieredPolicy(size_ratio=4.0,
                                                        min_run=min_run),
                              device="cpu", **kw)
    return ref, port


def _np(x):
    """jax array or tensor -> numpy, with u32 as int32 bits."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _index_arrays(ix, prefix=""):
    """Every array and static of a (possibly banded) index, by name."""
    if isinstance(ix, (rlayouts.BandedCsrIndex, tlayouts.BandedCsrIndex)):
        return {**_index_arrays(ix.packed, "packed."),
                **_index_arrays(ix.hor, "hor.")}
    out = {}
    for f in dataclasses.fields(ix):
        v = getattr(ix, f.name)
        if f.name == "docs":
            out[prefix + "norm"] = _np(v.norm)
            out[prefix + "rank"] = _np(v.rank)
        elif v is None or isinstance(v, int):
            out[prefix + f.name] = v
        else:
            out[prefix + f.name] = _np(v)
    return out


def _assert_same_state(ref, port):
    assert (ref.num_docs, ref.live_doc_count, ref.epoch, ref.num_terms) == \
        (port.num_docs, port.live_doc_count, port.epoch, port.num_terms)
    for name in ("_norm", "_rank", "_df", "_live", "_hashes"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), name)
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.layout_mix() == ref.layout_mix()
    for rs, ps in zip(ref.segments(), port.segments()):
        want, got = _index_arrays(rs.index), _index_arrays(ps.index)
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], name)
        for name in ("doc_of", "terms", "tfs", "doc_offsets"):
            np.testing.assert_array_equal(getattr(ps, name),
                                          getattr(rs, name), name)
    (rtc, rids), (ptc, pids) = (ref.export_live_corpus(),
                                port.export_live_corpus())
    np.testing.assert_array_equal(pids, rids)
    np.testing.assert_array_equal(ptc.term_hashes, rtc.term_hashes)
    for a, b in zip(ptc.doc_term_ids + ptc.doc_counts,
                    rtc.doc_term_ids + rtc.doc_counts):
        np.testing.assert_array_equal(a, b)


def _bits(scores):
    """f32 scores (a tensor or a jax array) as their int32 bit patterns."""
    return _np(scores).astype(np.float32).view(np.int32)


def _assert_same_answers(ref, port, qh, modes=("candidates", "dense")):
    """Each port engine against its reference counterpart, ids and score
    bits: the fused engine in each mode against the reference's Pallas
    engine in that mode (interpret mode), the gather oracle against the
    reference's jnp oracle.  Every engine ranks the oracle's ids."""
    oracle = ref.topk(qh, k=K, engine="jnp")
    ids = np.asarray(oracle.doc_ids)
    pairs = [(dict(mode=m), ref.topk(qh, k=K, mode=m)) for m in modes]
    pairs.append((dict(engine="torch"), oracle))
    for kw, want in pairs:
        got, stats = port.topk(qh, k=K, return_stats=True, **kw)
        assert stats["pair_overflow"] == 0
        np.testing.assert_array_equal(got.doc_ids.numpy(), ids, str(kw))
        np.testing.assert_array_equal(np.asarray(want.doc_ids), ids, str(kw))
        np.testing.assert_array_equal(_bits(got.scores), _bits(want.scores),
                                      str(kw))
    for q in qh[:2]:
        (rw, rs), (pw, ps) = (ref.conjunctive(q, K, cap=40),
                              port.conjunctive(q, K, cap=40))
        np.testing.assert_array_equal(pw.doc_ids.numpy(),
                                      np.asarray(rw.doc_ids))
        np.testing.assert_array_equal(_bits(pw.scores), _bits(rw.scores))
        assert ps == rs


def test_randomized_schedule_equals_reference_every_step():
    """Random adds (delta auto-seals as banded), deletes, explicit seals
    in all three layouts, a full compaction, tiered compactions, and a
    chooser-driven layout rewrite: the two indexes stay equal, and rank
    alike, at every step."""
    rng = np.random.default_rng(0)
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=420, vocab=300,
                                             avg_distinct=18, seed=11))
    bounds = [0, 60, 110, 180, 240, 300, 360, 420]
    ref, port = _pair(tc, delta_doc_capacity=48,
                      delta_posting_capacity=2048, seal_layout="banded")
    qh = rcorpus.sample_query_terms(rbuild.bulk_build(tc).df, tc.term_hashes,
                                    4, 3, num_docs=tc.num_docs, seed=5)
    layouts_seen = set()
    for step, (rb, pb) in enumerate(zip(_slices(tc, bounds, rbuild),
                                        _slices(tc, bounds, tbuild))):
        ref.add_batch(rb)
        port.add_batch(pb)
        if step >= 1:
            live = np.flatnonzero(ref.live_mask())
            kill = rng.choice(live, size=min(7, len(live)), replace=False)
            ref.delete(kill)
            port.delete(kill)
        if step in (1, 2, 5):
            layout = {1: "hor", 2: "packed", 5: "hor"}[step]
            ref.seal(layout=layout)
            port.seal(layout=layout)
        if step == 3:
            assert ref.compact(all_segments=True)
            assert port.compact(all_segments=True)
        if step == 4:
            for si, mod in ((ref, rsize), (port, tsize)):
                si.layout_policy = mod.LayoutCostModel(
                    min_packed_docs=64,
                    candidates=("hor", "packed", "banded"))
            i = ref.pick_layout_rewrite()
            assert i is not None and port.pick_layout_rewrite() == i
            ref.rewrite_segment(i)
            port.rewrite_segment(i)
        layouts_seen |= {s.layout for s in port.segments()}
        _assert_same_state(ref, port)
        _assert_same_answers(ref, port, qh,
                             modes=("candidates", "dense")[:1 + step % 2])
    assert layouts_seen == {"hor", "packed", "banded"}
    assert ref.stats.compactions >= 2 and ref.stats.layout_rewrites == 1
    assert port.delta_postings > 0


def test_fused_engine_equals_reference_pallas_engine():
    """On one mixed stack (banded, HOR and packed segments, tombstones, a
    live delta), the port's fused engine in both modes returns the
    reference's Pallas engine's ids and score bits, run in interpret
    mode, and the gather oracle the jnp oracle's."""
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=300, vocab=250,
                                             avg_distinct=15, seed=3))
    ref, port = _pair(tc, min_run=100, delta_doc_capacity=128,
                      delta_posting_capacity=4096, seal_layout="banded")
    for (rb, pb), layout in zip(zip(_slices(tc, [0, 120, 200, 260, 300],
                                            rbuild),
                                    _slices(tc, [0, 120, 200, 260, 300],
                                            tbuild)),
                                ("banded", "hor", "packed", None)):
        for si, b in ((ref, rb), (port, pb)):
            si.add_batch(b)
            if layout is not None:
                si.seal(layout=layout)
    for si in (ref, port):
        si.delete(np.arange(0, 300, 9))
    assert [s.layout for s in port.segments()] == ["banded", "hor", "packed"]
    qh = rcorpus.sample_query_terms(rbuild.bulk_build(tc).df, tc.term_hashes,
                                    5, 3, num_docs=tc.num_docs, seed=2)
    for mode in ("candidates", "dense"):
        want = ref.topk(qh, k=K, mode=mode)
        got = port.topk(qh, k=K, mode=mode)
        np.testing.assert_array_equal(got.doc_ids.numpy(),
                                      np.asarray(want.doc_ids))
        np.testing.assert_array_equal(_bits(got.scores), _bits(want.scores))
    oracle = ref.topk(qh, k=K, engine="jnp")
    got = port.topk(qh, k=K, engine="torch")
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(oracle.doc_ids))
    np.testing.assert_array_equal(_bits(got.scores), _bits(oracle.scores))
    # make_scorer hands a SegmentedIndex to its multi-segment path
    got = tquery.make_scorer(port, k=K, cap=None, engine="fused",
                             mode="dense")(qh)
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    with pytest.raises(ValueError):
        tquery.make_scorer(port, k=K, cap=None, max_pairs=8)
    # tune passes through to every segment, as in the reference
    got = tquery.make_scorer(port, k=K, cap=None, engine="fused",
                             mode="dense", tune=tautotune.DEFAULT_CONFIG)(qh)
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    with pytest.raises(ValueError):
        port.topk(qh, k=K, engine="pallas")
    with pytest.raises(ValueError):
        port.topk(qh, k=K, mode="sparse")


def test_query_norm_once_per_live_batch(monkeypatch):
    """``LiveView.topk`` computes the batch's query norms once
    (``prepare``) and hands them to every segment's engine, in both modes
    and in the oracle: no segment engine computes a norm of its own."""
    from repro_torch.kernels import ops as tops
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=300, vocab=250,
                                             avg_distinct=15, seed=4))
    _, port = _pair(tc, min_run=100, delta_doc_capacity=128,
                    delta_posting_capacity=4096, seal_layout="banded")
    for b, layout in zip(_slices(tc, [0, 120, 200, 260, 300], tbuild),
                         ("banded", "hor", "packed", None)):
        port.add_batch(b)
        if layout is not None:
            port.seal(layout=layout)
    qh = rcorpus.sample_query_terms(rbuild.bulk_build(tc).df, tc.term_hashes,
                                    5, 3, num_docs=tc.num_docs, seed=1)
    before = [port.topk(qh, k=K, **kw) for kw in (
        dict(mode="candidates"), dict(mode="dense"), dict(engine="torch"))]
    norms = []

    def counted(w):
        norms.append(w.shape)
        return tquery.query_norm(w)
    monkeypatch.setattr(tops, "query_norm", counted)
    for kw, want in zip((dict(mode="candidates"), dict(mode="dense"),
                         dict(engine="torch")), before):
        got = port.topk(qh, k=K, **kw)
        assert torch.equal(got.doc_ids, want.doc_ids)
        assert torch.equal(got.scores, want.scores)
    assert norms == []


def _delta_inputs(seed):
    """A delta with docs holding several query terms each (so the order
    of a doc's adds matters), plus dedup'd query term ids and weights."""
    rng = np.random.default_rng(seed)
    n_docs, w = 300, 40
    lens = rng.integers(1, 12, size=n_docs)
    terms = np.concatenate([np.sort(rng.choice(w, size=n, replace=False))
                            for n in lens]).astype(np.int32)
    doc_of = np.repeat(np.arange(n_docs), lens).astype(np.int32)
    tfs = rng.integers(1, 9, size=len(terms)).astype(np.float32)
    norm = (rng.random(n_docs) + 0.5).astype(np.float32)
    norm[::7] = 0.0
    rank = (rng.random(n_docs) * 1e-3).astype(np.float32)
    tids = np.stack([rng.choice(w, size=4, replace=False)
                     for _ in range(6)]).astype(np.int32)
    tids[1, 3] = -1
    idf = (rng.random(tids.shape) * 3 + 0.1).astype(np.float32)
    idf[tids < 0] = 0.0
    qnorm = np.sqrt((idf * idf).sum(1)).astype(np.float32)
    return terms, tfs, doc_of, norm, rank, tids, idf, qnorm


@pytest.mark.parametrize("seed", [0, 1])
def test_delta_scorers_equal_reference_bitwise(seed):
    """The delta's scatter-add sums a doc's postings in posting order;
    the port's round-per-posting-rank sum gives the very same bits, in
    the candidate scorer and the conjunctive one."""
    terms, tfs, doc_of, norm, rank, tids, idf, qnorm = _delta_inputs(seed)
    cap = len(terms) + 5                     # capacity padding, reference
    pad = cap - len(terms)
    r_terms = np.pad(terms, (0, pad), constant_values=-1)
    r_tfs = np.pad(tfs, (0, pad))
    r_doc_of = np.pad(doc_of, (0, pad), constant_values=-1)
    dev = {k: torch.from_numpy(v) for k, v in dict(
        terms=terms, tfs=tfs, doc_of=doc_of, norm=norm, rank=rank).items()}
    for blend in (0.0, 0.4):
        wv, wi = rli._delta_candidates(
            *map(jnp.asarray, (r_terms, r_tfs, r_doc_of, norm, rank, tids,
                               idf, qnorm)), jnp.int32(1000), k_tile=16,
            rank_blend=blend)
        gv, gi = tli._delta_candidates(
            dev, torch.from_numpy(tids), torch.from_numpy(idf),
            torch.from_numpy(qnorm), 1000, k_tile=16, rank_blend=blend)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy().view(np.int32),
                                      np.asarray(wv).view(np.int32))
    for q in range(3):
        needed = int((tids[q] >= 0).sum()) - 1
        wv, wi = rli._delta_conjunctive(
            *map(jnp.asarray, (r_terms, r_tfs, r_doc_of, norm, tids[q],
                               idf[q])), jnp.int32(needed), jnp.int32(7),
            k_tile=16)
        gv, gi = tli._delta_conjunctive(
            dev, torch.from_numpy(tids[q]), torch.from_numpy(idf[q]), needed,
            7, k_tile=16)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy().view(np.int32),
                                      np.asarray(wv).view(np.int32))
        assert (gi.numpy() >= 0).any()


def test_query_weights_and_host_helpers_match_reference():
    rng = np.random.default_rng(2)
    df = rng.integers(0, 500, size=(6, 4)).astype(np.int32)
    df[2] = 0
    wi, wq = rli._query_weights(jnp.asarray(df), jnp.float32(1234.0))
    gi, gq = tli._query_weights(torch.from_numpy(df), 1234.0)
    np.testing.assert_array_equal(gi.numpy().view(np.int32),
                                  np.asarray(wi).view(np.int32))
    np.testing.assert_array_equal(gq.numpy().view(np.int32),
                                  np.asarray(wq).view(np.int32))
    qh = rng.integers(0, 6, size=(5, 4)).astype(np.uint32)
    np.testing.assert_array_equal(tli._dedup_np(qh), rli._dedup_np(qh))
    hashes = rng.permutation(50).astype(np.uint32) + 1
    order = np.argsort(hashes, kind="stable")
    args = (hashes[order], order.astype(np.int64), qh * 9)
    np.testing.assert_array_equal(tli._lookup_sorted(*args),
                                  rli._lookup_sorted(*args))


def test_add_documents_equals_reference():
    """The live-index add path and the one-shot merge (an overlapping
    ``doc_id_base``), with vocabulary growth, field by field."""
    old = rcorpus.generate(rcorpus.CorpusSpec(num_docs=150, vocab=120,
                                              avg_distinct=10, seed=1))
    new = rcorpus.generate(rcorpus.CorpusSpec(num_docs=60, vocab=300,
                                              avg_distinct=12, seed=2))
    host = rbuild.bulk_build(old)
    thost = tlayouts.PostingsHost(**dataclasses.asdict(host))
    tnew = tbuild.TokenizedCorpus(new.doc_term_ids, new.doc_counts,
                                  new.term_hashes, new.num_docs)
    for base in (None, 100):
        want = rbuild.add_documents(host, new, doc_id_base=base)
        got = tbuild.add_documents(thost, tnew, doc_id_base=base,
                                   device="cpu")
        assert got.num_docs == want.num_docs
        for f in ("term_hashes", "df", "offsets", "doc_ids", "tfs", "norm",
                  "rank"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          f)


def test_trace_spans_and_result_unchanged():
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=200, vocab=200,
                                             avg_distinct=12, seed=4))
    port = tli.SegmentedIndex(term_hashes=tc.term_hashes,
                              delta_doc_capacity=64, seal_layout="banded",
                              device="cpu")
    port.add_batch(_slices(tc, [0, 200], tbuild)[0])
    qh = rcorpus.sample_query_terms(rbuild.bulk_build(tc).df, tc.term_hashes,
                                    3, 3, num_docs=tc.num_docs, seed=1)
    trace = Trace()
    a = port.topk(qh, k=K, trace=trace)
    b = port.topk(qh, k=K)
    assert torch.equal(a.doc_ids, b.doc_ids) and torch.equal(a.scores,
                                                             b.scores)
    names = [s.name for s in trace.spans]
    assert names == ["segment"] * port.num_segments + ["delta", "merge"]
    seg = trace.spans[0].attrs
    assert seg["layout"] == "banded" and "band_cut" in seg
    assert all(s.t1 is not None and s.parent == "score" for s in trace.spans)
    assert [e["kind"] for e in port.events.tail()][:2] == ["seal", "seal"]
