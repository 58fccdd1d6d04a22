"""The plain reference against brute force on a tiny collection, and the
comparison on hand-made answers."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _tiny  # noqa: E402,F401
from portbench.reference import compare  # noqa: E402
from portbench.reference.tfidf import Collection  # noqa: E402

# doc: {term: tf}
DOCS = [{0: 2, 1: 1}, {1: 3}, {0: 1, 2: 4}, {2: 1, 3: 1}, {0: 5},
        {1: 1, 3: 2}]


def brute(docs, live, query):
    n_live = sum(live)
    df = {}
    for d, ok in zip(docs, live):
        if ok:
            for t in d:
                df[t] = df.get(t, 0) + 1
    idf = {t: math.log1p(n_live / c) for t, c in df.items()}
    qn = math.sqrt(sum(idf.get(t, 0.0) ** 2 for t in query))
    out = []
    for d, ok in zip(docs, live):
        norm = math.sqrt(sum((tf * idf[t]) ** 2 for t, tf in d.items())) \
            if ok else 0.0
        s = sum(d.get(t, 0) * idf.get(t, 0.0) for t in query)
        out.append(s / (norm * qn) if ok and s > 0 else -math.inf)
    return out


def collection():
    doc = [i for i, d in enumerate(DOCS) for _ in d]
    term = [t for d in DOCS for t in d]
    tf = [c for d in DOCS for c in d.values()]
    return Collection(np.array(doc), np.array(term), np.array(tf),
                      len(DOCS), 4, "cpu")


@pytest.mark.parametrize("live", [[True] * 6, [True, False, True, True,
                                               False, True]])
def test_reference_scores_equal_brute_force(live):
    col = collection()
    mask = torch.tensor(live)
    idf, norm = col.weights(mask)
    queries = [[0], [1, 3], [0, 2, 3], [3, 3, 1]]
    final = col.scores(queries, idf, norm, mask).numpy()
    for q, row in zip(queries, final):
        want = np.array(brute(DOCS, live, set(q)))
        hit = np.isfinite(want)
        assert np.array_equal(np.isfinite(row), hit)
        np.testing.assert_allclose(row[hit], want[hit], rtol=1e-12)


def test_judge_reads_each_fault():
    col = collection()
    live = torch.tensor([True, False, True, True, True, True])
    idf, norm = col.weights(live)
    final = col.scores([[0, 1]], idf, norm, live)
    row = final[0].numpy()
    order = [int(i) for i in np.argsort(-row) if np.isfinite(row[i])]
    k = 3
    ids = np.array([order[:k]])
    sc = row[ids].astype(np.float32)

    t = compare.Tally()
    compare.judge(t, final, live, ids, sc, k)
    assert t.numbers() == {"rank_gap": 0.0, "score_err": t.score_err,
                           "missing": 0, "dead_ids": 0, "unanswered": 0,
                           "stale": 0}
    assert t.score_err < 1e-7

    t = compare.Tally()       # a dead document served
    compare.judge(t, final, live, np.array([[1] + order[:k - 1]]), sc, k)
    assert t.dead_ids == 1 and t.rank_gap == 1.0

    t = compare.Tally()       # half the answer left out
    compare.judge(t, final, live, np.array([order[:1] + [-1] * (k - 1)]),
                  sc, k)
    assert t.missing == k - 1

    t = compare.Tally()       # a score altered
    compare.judge(t, final, live, ids, sc * np.float32(1.001), k)
    assert t.score_err == pytest.approx(1e-3, rel=1e-3)

    t = compare.Tally()       # a worse document in place of the k-th
    worse = [order[:k - 1] + [order[k]]] if len(order) > k else None
    if worse:
        compare.judge(t, final, live, np.array(worse), row[worse].astype(
            np.float32), k)
        assert t.rank_gap > 0


def test_stale_counts_answers_behind_a_write_while_the_lock_was_free():
    """Writes acknowledged at 1.0 (epoch 5) and 3.0 (epoch 9); the lock
    was held over [2.0, 2.5]."""
    acks = [(-math.inf, 2), (1.0, 5), (3.0, 9)]
    holds = [(2.0, 2.5)]
    answers = [(0.5, 0.9, 2),     # asked before any write: in time
               (1.2, 1.5, 5),     # sees the first write
               (1.2, 1.5, 2),     # misses it, lock free: stale
               (1.8, 2.1, 2),     # misses it while the lock was held
               (2.6, 2.9, 4),     # misses it, lock free again: stale
               (3.5, 3.6, 5),     # misses the second write: stale
               (3.5, 3.6, 9)]
    assert compare.behind(answers, acks) == 4
    assert compare.stale(answers, acks, holds) == 3
    assert compare.stale(answers, acks, []) == 4
    assert compare.stale(answers, acks, [(0.0, 10.0)]) == 0


def test_control_answers_pad_to_k():
    final = torch.tensor([[0.5, -math.inf, 0.25]], dtype=torch.bfloat16)
    ids, sc = compare.control_answers(final, 5)
    assert ids.tolist() == [[0, 2, -1, -1, -1]]
    assert sc.dtype == np.float32 and sc[0, 2] == 0
