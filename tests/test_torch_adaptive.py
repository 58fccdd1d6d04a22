"""Port vs reference for the adaptive routing budget:
``query.AdaptiveRoutingBudget``, ``_pow2_at_least`` and
``make_adaptive_scorer``.  The port's scorer runs on the CPU (the fused
kernels' plain versions) beside the reference's (``engine="pallas"`` in
interpret mode) on the same query stream; ids and score bits must be
equal, and the budgets must follow the same rules."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import build as rbuild, layouts as rlayouts  # noqa: E402
from repro.core import query as rquery  # noqa: E402
from repro.text import corpus as rcorpus  # noqa: E402
from repro_torch.core import build as tbuild, layouts as tlayouts  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402

K = 10


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.float32).view(np.int32)


def test_pow2_quantizer_matches_reference():
    for n in [0, 1, 7, 8, 9, 63, 64, 65, 1000, 65_536, 65_537, 10**7]:
        for floor in (8, 64):
            assert tquery._pow2_at_least(n, floor) == \
                rquery._pow2_at_least(n, floor)


def test_budget_rules_match_reference():
    """The same ``observe`` sequence (growth on overflow, quiet windows
    that shrink, several ``n_terms`` buckets) gives the same budgets
    and overflow count after every call."""
    rng = np.random.default_rng(3)
    kw = dict(initial=16, window=8, shrink_ratio=4)
    ref, port = rquery.AdaptiveRoutingBudget(**kw), \
        tquery.AdaptiveRoutingBudget(**kw)
    for step in range(400):
        n_terms = int(rng.integers(1, 5))
        used = port.budget(n_terms)
        assert used == ref.budget(n_terms)
        # bursts of demand, then long quiet stretches
        hi = 5000 if (step // 50) % 2 == 0 else 200
        demand = int(rng.integers(1, hi))
        overflow = max(demand - used, 0)
        # report the pairs a quiet batch really used, so that the
        # shrink rule fires too (the scorers report their budget)
        port.observe(n_terms, min(demand, used), overflow)
        ref.observe(n_terms, min(demand, used), overflow)
        assert port._budgets == ref._budgets
        assert port.overflows == ref.overflows
    assert port.overflows > 0
    assert any(v < 4096 for v in port._budgets.values())   # shrank
    for v in port._budgets.values():
        assert v & (v - 1) == 0


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_adaptive_scorer_converges_and_equals_reference(layout):
    """From a deliberately small budget the scorer overflows, grows,
    and reaches zero overflow within a step, as the reference's does
    (``tests/test_live_index.py``); every call's budget and overflow
    equal the reference's; converged results equal the reference's
    adaptive scorer's (ids and score bits) and the static-budget fused
    scorer's."""
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=400, vocab=400,
                                             avg_distinct=25, seed=2))
    rhost, thost = rbuild.bulk_build(tc), tbuild.bulk_build(tc)
    builders = {"hor": (rlayouts.build_blocked, tlayouts.build_blocked),
                "packed": (rlayouts.build_packed_csr,
                           tlayouts.build_packed_csr)}
    rb, tb = builders[layout]
    rix, tix = rb(rhost), tb(thost, device="cpu")
    cap = rhost.max_posting_len
    rscorer = rquery.make_adaptive_scorer(
        rix, k=K, cap=cap, budget=rquery.AdaptiveRoutingBudget(initial=8))
    tscorer = tquery.make_adaptive_scorer(
        tix, k=K, cap=cap, budget=tquery.AdaptiveRoutingBudget(initial=8))
    static = tquery.make_scorer(tix, k=K, cap=cap, engine="fused")
    stream = [rcorpus.sample_query_terms(rhost.df, rhost.term_hashes, 4,
                                         4, num_docs=400, seed=s)
              for s in range(6)]
    stream.append(np.concatenate([stream[0][:, :2],
                                  stream[0][:, :2]], axis=1))  # dup slots
    overflows = []
    for qh in stream:
        tres, tstats = tscorer(qh)
        rres, rstats = rscorer(jnp.asarray(qh))
        assert tstats["pair_overflow"] == int(rstats["pair_overflow"])
        assert tscorer.budget._budgets == rscorer.budget._budgets
        overflows.append(tstats["pair_overflow"])
        if tstats["pair_overflow"] == 0:
            np.testing.assert_array_equal(tres.doc_ids.numpy(),
                                          np.asarray(rres.doc_ids))
            np.testing.assert_array_equal(_bits(tres.scores),
                                          _bits(rres.scores))
            want = static(qh)
            np.testing.assert_array_equal(tres.doc_ids.numpy(),
                                          want.doc_ids.numpy())
            np.testing.assert_array_equal(_bits(tres.scores),
                                          _bits(want.scores))
    assert overflows[0] > 0
    assert all(o == 0 for o in overflows[2:]), overflows
    # the 2-unique-term batch keys its own bucket
    assert set(tscorer.budget._budgets) == {2, 4}
    for v in tscorer.budget._budgets.values():
        assert v & (v - 1) == 0
    # a bit-view tensor input buckets like numpy
    again, _ = tscorer(tlayouts.hash_tensor(stream[-2], "cpu"))
    np.testing.assert_array_equal(again.doc_ids.numpy(),
                                  static(stream[-2]).doc_ids.numpy())
