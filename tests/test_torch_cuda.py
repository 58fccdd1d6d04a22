"""The port's CUDA kernels against their plain PyTorch versions, and the
live index on the card against the same index on the CPU.  Marked ``cuda``: skipped where no GPU is available (the
CPU tests hold the plain versions against the JAX reference).  Imports
no jax, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import build, layouts, live_index, query  # noqa: E402
from repro_torch.core.layouts import DocTable, PostingsHost  # noqa: E402
from repro_torch.kernels import fused_decode_score as fds  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.text import corpus  # noqa: E402

pytestmark = pytest.mark.cuda
BUILDERS = {"hor": layouts.build_blocked, "packed": layouts.build_packed_csr}


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def host():
    tc = corpus.generate(corpus.CorpusSpec(num_docs=5000, vocab=2000,
                                           avg_distinct=30, seed=3))
    return build.bulk_build(tc)


def _wide_delta_host():
    """Postings whose block deltas need 1..21 bits (straddling u32 word
    boundaries), over a 2**21-doc space."""
    rng = np.random.default_rng(0)
    num_docs = 2**21
    lists = []
    for bits in range(1, 22):
        gaps = rng.integers(2**(bits - 1), 2**bits, size=150)
        docs = np.cumsum(gaps) % num_docs
        lists.append(np.unique(docs))
    lens = np.array([len(x) for x in lists])
    offsets = np.zeros(len(lists) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return PostingsHost(
        term_hashes=np.arange(1, len(lists) + 1, dtype=np.uint32) * 7919,
        df=lens.astype(np.int32), offsets=offsets,
        doc_ids=np.concatenate(lists).astype(np.int32),
        tfs=rng.integers(1, 5, size=int(lens.sum())).astype(np.float32),
        num_docs=num_docs,
        norm=rng.random(num_docs).astype(np.float32) + 0.5,
        rank=rng.random(num_docs).astype(np.float32))


def _assert_kernel_equals_plain(ix, qh, k, cap, rank_blend=0.0, pps=1):
    qh = layouts.hash_tensor(qh, ix.device)
    term_ids, idf_t = query.lookup_query(ix, qh)
    kernel, plain, args, kw, _ = ops.fused_topk_args(
        ix, term_ids, idf_t, cap, k, rank_blend=rank_blend,
        pairs_per_step=pps)
    before = kernel.launches
    gv, gi = kernel(*args, **kw)
    wv, wi = plain(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(gi, wi)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))


@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("rank_blend", [0.0, 0.3])
def test_kernel_equals_plain(gpu, host, layout, rank_blend):
    ix = BUILDERS[layout](host, device=gpu)
    for seed in range(3):
        qh = corpus.sample_query_terms(host.df, host.term_hashes, 8, 3,
                                       num_docs=host.num_docs, seed=seed)
        _assert_kernel_equals_plain(ix, qh, 10, host.max_posting_len,
                                    rank_blend)


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_kernel_equals_plain_odd_shapes(gpu, host, layout):
    """Deleted docs, a mid-block cap, 13 queries (Q padded to 16), k
    beyond one k_pad quantum, and run-aligned pairs (pairs_per_step 2)."""
    ix = BUILDERS[layout](host, device=gpu)
    norm = ix.docs.norm.clone()
    norm[::3] = 0.0
    ix = dataclasses.replace(ix, docs=DocTable(norm=norm, rank=ix.docs.rank))
    qh = corpus.sample_query_terms(host.df, host.term_hashes, 13, 4,
                                   num_docs=host.num_docs, seed=9)
    _assert_kernel_equals_plain(ix, qh, 20, 257)
    _assert_kernel_equals_plain(ix, qh, 10, host.max_posting_len, pps=2)


def test_packed_kernel_wide_deltas(gpu):
    h = _wide_delta_host()
    ix = layouts.build_packed_csr(h, device=gpu)
    qh = np.zeros((8, 3), np.uint32)
    qh.flat[:21] = h.term_hashes
    _assert_kernel_equals_plain(ix, qh, 10, h.max_posting_len)


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_engine_matches_oracle_on_card(gpu, host, layout):
    ix = BUILDERS[layout](host, device=gpu)
    qh = corpus.sample_query_terms(host.df, host.term_hashes, 8, 3,
                                   num_docs=host.num_docs, seed=5)
    cap = host.max_posting_len
    fused = query.make_scorer(ix, k=10, cap=cap, engine="fused")(qh)
    oracle = query.make_scorer(ix, k=10, cap=cap)(qh)
    assert torch.equal(fused.doc_ids, oracle.doc_ids)
    torch.testing.assert_close(fused.scores, oracle.scores, rtol=1e-5,
                               atol=0)


def test_bitonic_reducer_is_refused_on_card(gpu, host):
    ix = layouts.build_blocked(host, device=gpu)
    qh = layouts.hash_tensor(corpus.sample_query_terms(
        host.df, host.term_hashes, 8, 3, num_docs=host.num_docs), gpu)
    term_ids, idf_t = query.lookup_query(ix, qh)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.fused_batched_topk(ix, term_ids, idf_t, host.max_posting_len,
                               10, reducer="bitonic")


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_ties_break_on_lowest_id_on_card(gpu, layout):
    """Exactly tied docs over several tiles: the kernel's reducer and the
    CUDA stable sort of the merge keep the lowest doc ids, in order."""
    n = 1200
    h = PostingsHost(
        term_hashes=np.array([111], np.uint32), df=np.array([n], np.int32),
        offsets=np.array([0, n], np.int64),
        doc_ids=np.arange(n, dtype=np.int32),
        tfs=np.ones(n, np.float32), num_docs=n,
        norm=np.ones(n, np.float32), rank=np.zeros(n, np.float32))
    ix = BUILDERS[layout](h, device=gpu)
    qh = np.zeros((8, 2), np.uint32)
    qh[:, 0] = 111
    for engine in ("fused", "torch"):
        got = query.make_scorer(ix, k=25, cap=n, engine=engine)(qh)
        assert torch.equal(got.doc_ids.cpu(),
                           torch.arange(25, dtype=torch.int32).expand(8, 25))


def _assert_dense_equals_plain(ix, qh, cap, max_pairs=None):
    qh = layouts.hash_tensor(qh, ix.device)
    term_ids, idf_t = query.lookup_query(ix, qh)
    kernel, plain, args, kw, _ = ops.fused_score_args(
        ix, term_ids, idf_t, cap, max_pairs=max_pairs)
    before = kernel.launches
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_dense_kernel_equals_plain(gpu, host, layout):
    """Sampled batches; 13 queries (Q padded to 16) with a mid-block cap;
    an overflowing budget; one rare term, so most tiles are unvisited
    and must read 0.0."""
    ix = BUILDERS[layout](host, device=gpu)
    for seed in range(2):
        qh = corpus.sample_query_terms(host.df, host.term_hashes, 8, 3,
                                       num_docs=host.num_docs, seed=seed)
        _assert_dense_equals_plain(ix, qh, host.max_posting_len)
    qh = corpus.sample_query_terms(host.df, host.term_hashes, 13, 4,
                                   num_docs=host.num_docs, seed=9)
    _assert_dense_equals_plain(ix, qh, 257)
    _assert_dense_equals_plain(ix, qh, 257, max_pairs=64)
    rare = np.zeros((8, 2), np.uint32)
    rare[0, 0] = host.term_hashes[int(np.argmin(np.where(
        host.df > 0, host.df, 10**9)))]
    got = _assert_dense_equals_plain(ix, rare, host.max_posting_len)
    assert (got[1:] == 0).all() and (got[0] != 0).sum() <= 128


def test_dense_packed_kernel_wide_deltas(gpu):
    h = _wide_delta_host()
    ix = layouts.build_packed_csr(h, device=gpu)
    qh = np.zeros((8, 3), np.uint32)
    qh.flat[:21] = h.term_hashes
    _assert_dense_equals_plain(ix, qh, h.max_posting_len)


def _live_schedule(tc, device):
    """A banded seed segment, a tiered merge of four seals, an HOR and
    a packed seal, tombstones and a delta tail."""
    host = build.bulk_build(build.TokenizedCorpus(
        tc.doc_term_ids[:3000], tc.doc_counts[:3000], tc.term_hashes, 3000))
    si = live_index.SegmentedIndex.from_host(
        host, seal_layout="banded", delta_doc_capacity=512, device=device)
    bounds = [3000, 3300, 3600, 3900, 4200, 4500, 4800, 4900]
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        si.add_batch(build.TokenizedCorpus(
            tc.doc_term_ids[lo:hi], tc.doc_counts[lo:hi], tc.term_hashes,
            hi - lo))
        if i < len(bounds) - 2:
            si.seal(layout=(None, None, None, None, "hor", "packed")[i])
        if i == 3:
            si.delete(np.arange(0, si.num_docs, 64))
    si.delete(np.arange(1, si.num_docs, 64))
    return si


def test_live_index_on_card_equals_cpu(gpu):
    """The same schedule on the card and on the CPU: equal stacks, every
    kernel launched, ids equal in both modes and in the oracle, scores
    within rtol 1e-6 (torch.log1p differs between CUDA and the CPU in
    the last bit); the conjunctive path too."""
    tc = corpus.generate(corpus.CorpusSpec(num_docs=4900, vocab=3000,
                                           avg_distinct=30, seed=5))
    cpu = _live_schedule(tc, "cpu")
    for name in ("fused_topk_blocked", "fused_topk_packed",
                 "fused_score_blocked", "fused_score_packed"):
        getattr(fds, name).launches = 0
    card = _live_schedule(tc, gpu)
    assert card.layout_mix() == cpu.layout_mix()
    assert set(card.layout_mix()["counts"]) == {"banded", "hor", "packed"}
    assert card.stats.compactions >= 1 and card.view().delta_n_docs > 0
    np.testing.assert_array_equal(card._norm, cpu._norm)
    qh = corpus.sample_query_terms(np.asarray(cpu._df), cpu.term_hashes, 8,
                                   3, num_docs=cpu.live_doc_count, seed=3)
    for kw in (dict(mode="candidates"), dict(mode="dense"),
               dict(engine="torch")):
        got, stats = card.topk(qh, k=10, return_stats=True, **kw)
        want = cpu.topk(qh, k=10, **kw)
        assert stats["pair_overflow"] == 0
        assert torch.equal(got.doc_ids.cpu(), want.doc_ids)
        torch.testing.assert_close(got.scores.cpu(), want.scores, rtol=1e-6,
                                   atol=0)
    for name in ("fused_topk_blocked", "fused_topk_packed",
                 "fused_score_blocked", "fused_score_packed"):
        assert getattr(fds, name).launches > 0, name
    (g, gs), (w, ws) = card.conjunctive(qh[0], 10, 200), cpu.conjunctive(
        qh[0], 10, 200)
    assert gs == ws and torch.equal(g.doc_ids.cpu(), w.doc_ids)
