"""The port's CUDA candidate kernels against their plain PyTorch versions,
on the card.  Marked ``cuda``: skipped where no GPU is available (the
CPU tests hold the plain versions against the JAX reference).  Imports
no jax, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import build, layouts, query  # noqa: E402
from repro_torch.core.layouts import DocTable, PostingsHost  # noqa: E402
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
