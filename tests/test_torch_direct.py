"""The direct index (paper §4.4) in the port against the reference.

``build_direct`` must equal the reference's arrays; ``expand_query``,
``expand_query_scan`` (over PR and OR), ``relevance_feedback`` and
``delete_docs`` must return the same term ids and weights to the bit,
ties included (lowest term id first, as ``jax.lax.top_k``).  A corpus
whose tfs are not integers shows that the port adds each term's values
in the reference's order, not only that integer sums are exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import build as rbuild, direct_index as rdirect  # noqa: E402
from repro.core import layouts as rlayouts, query as rquery  # noqa: E402
from repro.text import corpus as rcorpus  # noqa: E402
from repro_torch.core import direct_index as tdirect  # noqa: E402
from repro_torch.core import layouts as tlayouts  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402


@pytest.fixture(scope="module")
def host():
    return rbuild.bulk_build(rcorpus.generate(rcorpus.CorpusSpec(
        num_docs=500, vocab=300, avg_distinct=20, seed=11)))


def _float_host(h, seed=0):
    """The same postings with tfs drawn from (0, 4): sums of a term's
    values then round, so their order shows."""
    rng = np.random.default_rng(seed)
    tfs = (rng.random(h.num_postings) * 4 + 1e-3).astype(np.float32)
    return dataclasses.replace(h, tfs=tfs)


def _port_host(h):
    return tlayouts.PostingsHost(**{f.name: getattr(h, f.name)
                                    for f in dataclasses.fields(h)})


def _port_direct(d):
    return tlayouts.index_from_numpy(
        "direct", {f: np.asarray(getattr(d, f))
                   for f in ("offsets", "term_ids", "tfs")},
        {"max_doc_len": d.max_doc_len}, device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_expansion_equal(got, want):
    assert np.array_equal(got.term_ids.numpy(), np.asarray(want.term_ids))
    assert np.array_equal(got.weights.numpy().view(np.int32),
                          np.asarray(want.weights).view(np.int32))


def _top_docs(h, n_sets=6, n=10, seed=0):
    rng = np.random.default_rng(seed)
    sets = [rng.choice(h.num_docs, size=n, replace=False) for _ in
            range(n_sets)]
    sets.append(np.r_[sets[0][:4], [-1] * (n - 4)])        # -1 padding
    sets.append(np.full(n, -1))                             # nothing
    return [s.astype(np.int32) for s in sets]


@pytest.mark.parametrize("floats", [False, True])
def test_build_direct_equals_reference(host, floats):
    h = _float_host(host) if floats else host
    ref = rdirect.build_direct(h)
    port = tdirect.build_direct(_port_host(h), device="cpu")
    for f in ("offsets", "term_ids", "tfs"):
        want = np.asarray(getattr(ref, f))
        got = getattr(port, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert port.max_doc_len == ref.max_doc_len
    assert port.nbytes() == ref.nbytes() and port.num_docs == ref.num_docs
    via = _port_direct(ref)
    assert torch.equal(via.term_ids, port.term_ids)


@pytest.mark.parametrize("floats", [False, True])
def test_expand_query_equals_reference(host, floats):
    h = _float_host(host) if floats else host
    ref = rdirect.build_direct(h)
    port = _port_direct(ref)
    for docs in _top_docs(h):
        for n_suggest, cap in ((5, ref.max_doc_len), (12, 7)):
            want = rdirect.expand_query(ref, jnp.asarray(docs), h.num_terms,
                                        cap, n_suggest=n_suggest)
            got = tdirect.expand_query(port, _t(docs), h.num_terms, cap,
                                       n_suggest=n_suggest)
            _assert_expansion_equal(got, want)
        top = np.asarray(want.term_ids)[:3]
        top = top[top >= 0]
        # -1 padding after the excluded terms; term 0 is left out here:
        # the reference's padding writes term 0's old weight back (see
        # test_exclude_terms_padding_keeps_term_0_excluded)
        for excl in (np.r_[top[top > 0], [-1, -1]], top):
            excl = excl.astype(np.int32)
            want = rdirect.expand_query(ref, jnp.asarray(docs), h.num_terms,
                                        ref.max_doc_len, n_suggest=6,
                                        exclude_terms=jnp.asarray(excl))
            got = tdirect.expand_query(port, _t(docs), h.num_terms,
                                       ref.max_doc_len, n_suggest=6,
                                       exclude_terms=_t(excl))
            _assert_expansion_equal(got, want)
            assert not np.isin(got.term_ids.numpy(), excl[excl >= 0]).any()


def test_exclude_terms_padding_keeps_term_0_excluded(host):
    """The reference sets excluded weights with one scatter in which
    each -1 of the padding writes term 0's old weight back to slot 0, so
    term 0 excluded beside padding comes back (XLA's CPU scatter applies
    the later write).  The port zeroes exactly the listed terms."""
    ref = rdirect.build_direct(host)
    port = _port_direct(ref)
    t0_docs = host.doc_ids[host.offsets[0]:host.offsets[1]][:10]
    assert len(t0_docs)
    excl = np.array([0, -1], np.int32)
    want = rdirect.expand_query(ref, jnp.asarray(t0_docs), host.num_terms,
                                ref.max_doc_len, n_suggest=40,
                                exclude_terms=jnp.asarray(excl))
    got = tdirect.expand_query(port, _t(t0_docs), host.num_terms,
                               ref.max_doc_len, n_suggest=40,
                               exclude_terms=_t(excl))
    assert 0 in np.asarray(want.term_ids).tolist()
    assert 0 not in got.term_ids.tolist()
    rest = [t for t in np.asarray(want.term_ids).tolist() if t != 0]
    assert got.term_ids.tolist()[:len(rest)] == rest


def test_expansion_ties_break_on_lowest_term_id():
    """Two docs whose terms all sum to the same weight: every suggestion
    ties, and both packages list the lowest term ids first."""
    W, D = 12, 4
    doc_terms = {0: [9, 3, 5, 1], 1: [7, 2, 11, 0], 2: [4, 6], 3: [8, 10]}
    lists = [[d for d in range(D) if t in doc_terms[d]] for t in range(W)]
    lens = np.array([len(x) for x in lists])
    offsets = np.zeros(W + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    h = rlayouts.PostingsHost(
        term_hashes=np.arange(1, W + 1, dtype=np.uint32) * 977,
        df=lens.astype(np.int32), offsets=offsets,
        doc_ids=np.concatenate(lists).astype(np.int32),
        tfs=np.full(int(lens.sum()), 2.0, np.float32), num_docs=D,
        norm=np.ones(D, np.float32), rank=np.zeros(D, np.float32))
    ref = rdirect.build_direct(h)
    port = tdirect.build_direct(_port_host(h), device="cpu")
    docs = np.array([1, 0, -1], np.int32)
    want = rdirect.expand_query(ref, jnp.asarray(docs), W, 4, n_suggest=6)
    got = tdirect.expand_query(port, _t(docs), W, 4, n_suggest=6)
    _assert_expansion_equal(got, want)
    assert got.term_ids.tolist() == [0, 1, 2, 3, 5, 7]


@pytest.mark.parametrize("floats", [False, True])
@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_expand_query_scan_equals_reference(host, floats, layout):
    """The full scan over PR's heap and OR's slabs gives the reference's
    answer, and the direct index's."""
    h = _float_host(host) if floats else host
    ref_ix = getattr(rlayouts, f"build_{layout}")(h)
    port_ix = getattr(tlayouts, f"build_{layout}")(_port_host(h),
                                                   device="cpu")
    port_direct = tdirect.build_direct(_port_host(h), device="cpu")
    for docs in _top_docs(h, n_sets=3):
        want = rdirect.expand_query_scan(ref_ix, jnp.asarray(docs),
                                         h.num_terms, n_suggest=8)
        got = tdirect.expand_query_scan(port_ix, _t(docs), h.num_terms,
                                        n_suggest=8)
        _assert_expansion_equal(got, want)
        direct = tdirect.expand_query(port_direct, _t(docs), h.num_terms,
                                      port_direct.max_doc_len, n_suggest=8)
        assert torch.equal(direct.term_ids, got.term_ids)
        if not floats:      # integer tfs: the sums are exact either way
            assert torch.equal(direct.weights, got.weights)


@pytest.mark.parametrize("floats", [False, True])
def test_relevance_feedback_equals_reference(host, floats):
    h = _float_host(host) if floats else host
    ref = rdirect.build_direct(h)
    port = _port_direct(ref)
    rng = np.random.default_rng(2)
    for docs in _top_docs(h, n_sets=3):
        q = np.r_[rng.choice(h.num_terms, size=3, replace=False), [-1],
                  ].astype(np.int32)
        q[2] = q[0]                                 # a repeated term
        for alpha, beta in ((1.0, 0.75), (0.3, 1.7)):
            want = rdirect.relevance_feedback(
                ref, jnp.asarray(docs), jnp.asarray(q), h.num_terms,
                ref.max_doc_len, alpha=alpha, beta=beta)
            got = tdirect.relevance_feedback(
                port, _t(docs), _t(q), h.num_terms, ref.max_doc_len,
                alpha=alpha, beta=beta)
            _assert_expansion_equal(got, want)


def test_delete_docs_equals_reference_and_hides_docs(host):
    ix = rlayouts.build_csr(host)
    port = tlayouts.build_csr(_port_host(host), device="cpu")
    qh = rcorpus.sample_query_terms(host.df, host.term_hashes, 4, 2,
                                    num_docs=host.num_docs, seed=2)
    first = tquery.make_scorer(port, k=10, cap=host.max_posting_len)(qh)
    victims = np.r_[first.doc_ids[:, 0].numpy(), [-1]].astype(np.int32)
    want = np.asarray(rdirect.delete_docs(ix.docs.norm,
                                          jnp.asarray(victims)))
    got = tdirect.delete_docs(port.docs.norm, _t(victims))
    assert np.array_equal(got.numpy(), want)
    assert (port.docs.norm.numpy() > 0).all()           # a copy
    deleted = dataclasses.replace(
        port, docs=tlayouts.DocTable(norm=got, rank=port.docs.rank))
    again = tquery.make_scorer(deleted, k=10, cap=host.max_posting_len)(qh)
    assert not np.isin(again.doc_ids.numpy(), victims[:-1]).any()
    ref_again = rquery.make_scorer(
        dataclasses.replace(ix, docs=rlayouts.DocTable(
            norm=jnp.asarray(want), rank=ix.docs.rank)),
        k=10, cap=host.max_posting_len)(jnp.asarray(qh))
    assert np.array_equal(again.doc_ids.numpy(),
                          np.asarray(ref_again.doc_ids))


def test_sum_in_order_adds_in_the_given_order():
    """Each slot's values are summed left to right: a large value first
    swallows the small ones that follow it, as a sequential scatter-add
    does, where a pairwise sum of the small ones first would not."""
    keys = torch.tensor([2, 0, 2, 2, 2, 5, 0], dtype=torch.int32)
    vals = torch.tensor([2**24, 1.0, 1.0, 1.0, 1.0, 3.0, 0.5])
    got = tdirect.sum_in_order(keys, vals, 4)
    assert got.tolist() == [1.5, 0.0, float(2**24), 0.0]
