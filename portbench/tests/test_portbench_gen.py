"""The generators repeat by seed and give every seed the same work."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _tiny  # noqa: E402,F401
from portbench.gen import corpus as gen  # noqa: E402
from portbench.gen import traffic  # noqa: E402

SPEC = gen.Spec(400, 300, 12, 1.07)


def test_corpus_repeats_by_seed_and_stream():
    a = gen.generate(SPEC, 2**31 + 9, "base", "cpu")
    b = gen.generate(SPEC, 2**31 + 9, "base", "cpu")
    c = gen.generate(SPEC, 2**31 + 9, "writes", "cpu")
    for x, y in ((a.doc_of, b.doc_of), (a.terms, b.terms),
                 (a.counts, b.counts)):
        assert np.array_equal(x, y)
    assert not np.array_equal(a.terms[:200], c.terms[:200])


def test_corpus_is_doc_major_with_distinct_terms():
    d = gen.generate(SPEC, 5, "base", "cpu")
    assert d.offsets[-1] == len(d.terms) and d.num_docs == SPEC.num_docs
    for i in range(0, SPEC.num_docs, 37):
        t = d.terms[d.offsets[i]:d.offsets[i + 1]]
        assert len(t) >= 1 and np.all(np.diff(t) > 0)
    s = d.slice(10, 20)
    assert s.num_docs == 10 and s.doc_of.min() == 0
    assert np.array_equal(s.terms, d.terms[d.offsets[10]:d.offsets[20]])


def test_corpus_follows_the_tier_distribution():
    """As the port's own synthetic corpus at the same spec: distinct
    terms a document within a few percent."""
    from repro_torch.text import corpus
    spec = gen.Spec(3000, 2000, 20, 1.07)
    ours = gen.generate(spec, 3, "base", "cpu")
    theirs = corpus.generate(corpus.CorpusSpec(num_docs=3000, vocab=2000,
                                               avg_distinct=20, seed=3))
    mean_theirs = np.mean([len(x) for x in theirs.doc_term_ids])
    assert len(ours.terms) / 3000 == pytest.approx(mean_theirs, rel=0.05)
    assert np.array_equal(gen.term_hashes(2000), theirs.term_hashes)


def test_arrivals_are_one_set_in_another_order():
    a = traffic.arrivals("poisson", 40.0, 30.0, np.random.default_rng(1))
    b = traffic.arrivals("poisson", 40.0, 30.0, np.random.default_rng(2))
    assert len(a) == len(b) == 1200
    assert np.all(np.diff(a) > 0) and a[-1] < 30.0
    assert np.allclose(np.sort(np.diff(a)), np.sort(np.diff(b)),
                       rtol=1e-3, atol=1e-4)
    assert not np.allclose(a, b)


def test_lengths_have_exact_shares_and_rows_their_terms():
    rng = np.random.default_rng(4)
    lens = traffic.lengths({"1": 1, "2": 1, "3": 1, "4": 1}, 103, rng)
    assert sorted(np.bincount(lens)[1:].tolist()) == [25, 26, 26, 26]
    d = gen.generate(SPEC, 5, "base", "cpu")
    df = gen.document_frequency(d, SPEC.vocab)
    rows = traffic.query_rows(df, gen.term_hashes(SPEC.vocab),
                              SPEC.num_docs, lens, 8, (0.15, 0.5), 7)
    again = traffic.query_rows(df, gen.term_hashes(SPEC.vocab),
                               SPEC.num_docs, lens, 8, (0.15, 0.5), 7)
    assert np.array_equal(rows, again)
    assert np.array_equal((rows != 0).sum(axis=1), lens)
    for r in rows:
        assert len(set(r[r != 0].tolist())) == (r != 0).sum()
