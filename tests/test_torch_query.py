"""Port vs reference for the slice as a whole: query hashes in, ranked
top-k out.

The port's fused engine (``make_scorer(engine="fused")``, plain kernels
on the CPU) and its dense oracle (``engine="torch"``) must return the
same doc ids as the JAX fused engine (``engine="pallas"``, interpret
mode) and the JAX oracle, on the very same HOR and packed indexes
(``index_from_numpy``).  Each port engine also gives its reference
counterpart's scores to the bit: the fused engine in both modes those of
the Pallas engine, the port's oracle those of the reference's oracle.
The reference's own two engines differ from each other by up to 2 ulp
(its Pallas kernel adds each ``qw * tf`` as one fused multiply-add, its
jnp oracle rounds the product before the add), so the engines are
paired, never crossed.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import build as rbuild, layouts as rlayouts  # noqa: E402
from repro.core import query as rquery  # noqa: E402
from repro.text import corpus as rcorpus  # noqa: E402
from repro_torch.core import build as tbuild, layouts as tlayouts  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402
from repro_torch.obs.registry import GLOBAL  # noqa: E402
from repro_torch.text import corpus as tcorpus  # noqa: E402

BUILDERS = {"hor": rlayouts.build_blocked,
            "packed": rlayouts.build_packed_csr}


def _host(seed=7, docs=600, vocab=500, avg=25):
    return rbuild.bulk_build(rcorpus.generate(rcorpus.CorpusSpec(
        num_docs=docs, vocab=vocab, avg_distinct=avg, seed=seed)))


def _tied_host(num_docs=1200):
    """Term A covers every doc at tf=1, term B the upper half at tf=2,
    all norms equal: querying A alone ties every doc exactly."""
    half = num_docs // 2
    return rlayouts.PostingsHost(
        term_hashes=np.array([111, 222], np.uint32),
        df=np.array([num_docs, num_docs - half], np.int32),
        offsets=np.array([0, num_docs, num_docs + (num_docs - half)],
                         np.int64),
        doc_ids=np.concatenate([np.arange(num_docs, dtype=np.int32),
                                np.arange(half, num_docs, dtype=np.int32)]),
        tfs=np.concatenate([np.ones(num_docs, np.float32),
                            np.full(num_docs - half, 2.0, np.float32)]),
        num_docs=num_docs, norm=np.ones(num_docs, np.float32),
        rank=np.zeros(num_docs, np.float32))


def _port_index(kind, ix):
    """The reference index ``ix`` as the port's index, on the CPU."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(ix):
        v = getattr(ix, f.name)
        if f.name == "docs":
            arrays.update(norm=np.asarray(v.norm), rank=np.asarray(v.rank))
        elif f.name in type(ix)._static_fields:
            statics[f.name] = v
        else:
            arrays[f.name] = np.asarray(v)
    return tlayouts.index_from_numpy(kind, arrays, statics, device="cpu")


def _absent_hash(host):
    taken = set(int(h) for h in host.term_hashes)
    h = 12345
    while h in taken:
        h += 1
    return h


def _bits(scores):
    """f32 scores (a tensor or a jax array) as their int32 bit patterns."""
    a = scores.numpy() if isinstance(scores, torch.Tensor) else \
        np.asarray(scores)
    return a.astype(np.float32).view(np.int32)


def _assert_slice_parity(kind, ix, qh, k, cap, rank_blend=0.0):
    """Five engines, one answer: the reference's fused engine and oracle,
    and the port's fused engine in both modes and its oracle.  Returns
    the port's fused (candidates) result."""
    kw = dict(k=k, cap=cap, rank_blend=rank_blend)
    want = rquery.make_scorer(ix, engine="pallas", **kw)(jnp.asarray(qh))
    oracle = rquery.make_scorer(ix, **kw)(jnp.asarray(qh))
    tix = _port_index(kind, ix)
    got = tquery.make_scorer(tix, engine="fused", **kw)(qh)
    got_dense = tquery.make_scorer(tix, engine="fused", mode="dense",
                                   **kw)(qh)
    got_oracle = tquery.make_scorer(tix, engine="torch", **kw)(qh)
    ids = np.asarray(want.doc_ids)
    np.testing.assert_array_equal(np.asarray(oracle.doc_ids), ids)
    for g in (got, got_dense, got_oracle):
        np.testing.assert_array_equal(g.doc_ids.numpy(), ids)
    # each port engine gives its reference counterpart's scores to the bit:
    # the fused engine in both modes the Pallas engine's, the oracle the
    # oracle's (the reference's two engines are up to 2 ulp apart)
    for g, w in ((got, want), (got_dense, want), (got_oracle, oracle)):
        np.testing.assert_array_equal(_bits(g.scores), _bits(w.scores))
    return got


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_mixed_batch(layout):
    """Sampled queries, shared terms, an absent term mixed in, an
    absent-only query, an empty query, and repeated hashes."""
    host = _host()
    q = rcorpus.sample_query_terms(host.df, host.term_hashes, 6, 4,
                                   num_docs=host.num_docs, seed=3)
    absent = _absent_hash(host)
    qh = np.zeros((9, 4), np.uint32)
    qh[:5] = q[:5]
    qh[1, 2] = q[0, 0]                # a term shared across queries
    qh[2, 1] = absent                 # absent term in a real query
    qh[5, 0] = absent                 # absent-only query; qh[6] empty
    qh[7] = q[5]
    qh[7, 1] = qh[7, 0]               # duplicate hashes in one query
    qh[8, 1:] = qh[8, 0] = q[5, 2]    # one term in every slot
    got = _assert_slice_parity(layout, BUILDERS[layout](host), qh, 10,
                               host.max_posting_len)
    ids = got.doc_ids.numpy()
    assert (ids[5:7] == -1).all() and (got.scores.numpy()[5:7] == 0).all()
    assert (ids[:5] >= 0).all()


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_deleted_docs_blend_and_mid_block_cap(layout):
    """Deleted docs (norm 0, incl. the winners), a rank blend whose
    product is inexact (one FMA in both packages), a cap cutting
    mid-block, and a batch that is not a multiple of 8."""
    host = _host()
    ix = BUILDERS[layout](host)
    qh = rcorpus.sample_query_terms(host.df, host.term_hashes, 5, 3,
                                    num_docs=host.num_docs, seed=21)
    winners = np.asarray(rquery.make_scorer(ix, k=10, cap=257)(
        jnp.asarray(qh)).doc_ids)
    norm = np.asarray(ix.docs.norm).copy()
    norm[::3] = 0.0
    norm[winners[winners >= 0]] = 0.0
    ix = dataclasses.replace(ix, docs=rlayouts.DocTable(
        norm=jnp.asarray(norm), rank=ix.docs.rank))
    got = _assert_slice_parity(layout, ix, qh, 10, 257, rank_blend=0.3)
    ids = got.doc_ids.numpy()
    assert (ids >= 0).any() and not np.isin(ids[ids >= 0],
                                            np.flatnonzero(norm == 0)).any()


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_tie_corpus(layout):
    """Hundreds of exactly tied docs over several tiles: lowest doc id
    first, in both packages."""
    host = _tied_host()
    qh = np.zeros((2, 4), np.uint32)
    qh[:, 0] = 111                    # every doc tied
    qh[1, 1] = 222                    # upper half breaks away
    got = _assert_slice_parity(layout, BUILDERS[layout](host), qh, 25,
                               host.num_docs)
    np.testing.assert_array_equal(got.doc_ids.numpy()[0], np.arange(25))


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_k_exceeds_hits(layout):
    host = _host(docs=120, vocab=400, avg=8)
    rare = int(np.argmin(np.where(host.df > 0, host.df, 10**9)))
    qh = np.zeros((1, 4), np.uint32)
    qh[0, 0] = host.term_hashes[rare]
    got = _assert_slice_parity(layout, BUILDERS[layout](host), qh,
                               host.num_docs, host.max_posting_len)
    assert (got.doc_ids.numpy()[0] == -1).sum() == host.num_docs - int(
        host.df[rare])


def test_port_pipeline_end_to_end():
    """The port alone, spec to top-k (generate -> bulk_build -> both
    layouts -> fused engine), against the reference oracle on the
    reference's own build of the same spec."""
    kw = dict(num_docs=900, vocab=600, avg_distinct=20, seed=5)
    rh = rbuild.bulk_build(rcorpus.generate(rcorpus.CorpusSpec(**kw)))
    th = tbuild.bulk_build(tcorpus.generate(tcorpus.CorpusSpec(**kw)))
    qh = tcorpus.sample_query_terms(th.df, th.term_hashes, 8, 3,
                                    num_docs=th.num_docs, seed=2)
    want = rquery.make_scorer(rlayouts.build_blocked(rh), k=10,
                              cap=rh.max_posting_len)(jnp.asarray(qh))
    for build in (tlayouts.build_blocked, tlayouts.build_packed_csr):
        ix = build(th, device="cpu")
        got = tquery.make_scorer(ix, k=10, cap=th.max_posting_len,
                                 engine="fused")(qh)
        np.testing.assert_array_equal(got.doc_ids.numpy(),
                                      np.asarray(want.doc_ids))
        one = tquery.score_query(ix, tlayouts.hash_tensor(qh[0]), 10,
                                 th.max_posting_len)
        np.testing.assert_array_equal(one.doc_ids.numpy(),
                                      np.asarray(want.doc_ids)[0])


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_overflow_is_surfaced(layout):
    """An undersized routing budget is a returned stat, a warning and a
    registry counter — never a silent drop."""
    host = _host()
    tix = _port_index(layout, BUILDERS[layout](host))
    qh = rcorpus.sample_query_terms(host.df, host.term_hashes, 4, 4,
                                    num_docs=host.num_docs, seed=4)
    counter = GLOBAL.counter("engine_pair_overflow")
    before = counter.value
    with pytest.warns(RuntimeWarning, match="routing overflow"):
        _, stats = tquery.make_scorer(tix, k=10, cap=host.max_posting_len,
                                      engine="fused", max_pairs=2,
                                      return_stats=True)(qh)
    assert stats["pair_overflow"] > 0
    assert counter.value == before + stats["pair_overflow"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, stats = tquery.make_scorer(tix, k=10, cap=host.max_posting_len,
                                      engine="fused", return_stats=True)(qh)
    assert stats["pair_overflow"] == 0


def test_make_scorer_rejects_unknown_engine_and_modes():
    """Both of the reference's modes are accepted and rank alike; an
    unknown engine or mode is a ValueError, as in the reference."""
    host = tbuild.bulk_build(tcorpus.generate(tcorpus.CorpusSpec(
        num_docs=60, vocab=80, avg_distinct=5)))
    ix = tlayouts.build_blocked(host, device="cpu")
    qh = tcorpus.sample_query_terms(host.df, host.term_hashes, 3, 2,
                                    num_docs=host.num_docs, seed=1)
    got = [tquery.make_scorer(ix, k=5, cap=8, engine="fused", mode=m)(qh)
           for m in ("candidates", "dense")]
    assert torch.equal(got[0].doc_ids, got[1].doc_ids)
    with pytest.raises(ValueError):
        tquery.make_scorer(ix, k=5, cap=8, engine="pallas")
    with pytest.raises(ValueError, match="mode"):
        tquery.make_scorer(ix, k=5, cap=8, engine="fused", mode="sparse")
    with pytest.raises(ValueError, match="mode"):
        rquery.make_scorer(ix, k=5, cap=8, engine="pallas", mode="sparse")
    with pytest.raises(TypeError, match="BlockedIndex or PackedCsrIndex"):
        tquery.make_scorer(ix.docs, k=5, cap=8, engine="fused")


def test_candidate_merges_match_reference():
    """Both merge tiers against the reference's, on ragged sources with
    ties, -inf misses and k beyond the candidate count."""
    from repro.distributed import topk as rtopk
    from repro_torch.distributed import topk as ttopk
    rng = np.random.default_rng(4)
    vals = [np.where(rng.random((3, c)) < 0.2, -np.inf,
                     rng.integers(0, 4, size=(3, c)) / 2).astype(np.float32)
            for c in (5, 1, 7)]
    ids = [rng.integers(0, 100, size=(3, c)).astype(np.int32)
           for c in (5, 1, 7)]
    for k in (4, 20):
        want = rtopk.merge_topk_candidates_host(vals, ids, k)
        got = ttopk.merge_topk_candidates_host(vals, ids, k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        v, i = np.concatenate(vals, -1), np.concatenate(ids, -1)
        want = rtopk.merge_topk_candidates(jnp.asarray(v), jnp.asarray(i), k)
        got = ttopk.merge_topk_candidates(torch.from_numpy(v),
                                          torch.from_numpy(i), k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_tuned_geometry_ranks_like_the_oracle(layout):
    """A non-default geometry (256-doc tiles, so the routing spans come
    from the block min/max instead of the build-time cache; two pairs
    per step; a widened k_tile) changes no ranking."""
    from repro_torch.kernels.autotune import TuneConfig
    host = _host()
    ix = BUILDERS[layout](host)
    qh = rcorpus.sample_query_terms(host.df, host.term_hashes, 8, 3,
                                    num_docs=host.num_docs, seed=12)
    want = rquery.make_scorer(ix, k=10, cap=host.max_posting_len)(
        jnp.asarray(qh))
    tune = TuneConfig(tile=256, pairs_per_step=2, k_tile=24)
    got = tquery.make_scorer(_port_index(layout, ix), k=10,
                             cap=host.max_posting_len, engine="fused",
                             tune=tune)(qh)
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
