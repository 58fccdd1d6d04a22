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
from repro_torch.kernels import embedding_bag as tbag  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import fused_decode_score as fds  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import packed_postings as pp  # noqa: E402
from repro_torch.kernels import posting_score as ps  # noqa: E402
from repro_torch.kernels import segment_multi_agg as tpna  # noqa: E402
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


@pytest.mark.parametrize("block", [16, 32, 128])
def test_posting_score_kernel_equals_plain(gpu, host, block):
    """The single-query scorer on the card: each query's pairs (sized
    exactly from the routing spans, plus padding pairs) through the
    kernel and the plain version, to the bit; the scores equal the
    oracle's raw accumulation to the bit; one rare term leaves most
    tiles unvisited, at 0.0."""
    ix = layouts.build_blocked(host, block=block, device=gpu)
    qh = corpus.sample_query_terms(host.df, host.term_hashes, 4, 4,
                                   num_docs=host.num_docs, seed=block)
    rare = np.zeros((1, 4), np.uint32)
    rare[0, 0] = host.term_hashes[int(np.argmin(np.where(
        host.df > 0, host.df, 10**9)))]
    tids, idf_w = query.lookup_query(
        ix, layouts.hash_tensor(np.concatenate([qh, rare]), gpu))
    tfirst, tcount, n_tiles = ops.routing_spans(ix, ps.TILE)
    for t, w in zip(tids, idf_w):
        sel, valid, sw = ops.select_query_blocks(ix, t, w,
                                                 ix.max_blocks_per_term)
        max_pairs = int(tcount[sel.long()][valid].sum()) + 3
        pb, pt, pw, ovf = ps.build_pairs(sel, valid, sw, tfirst, tcount,
                                         n_tiles, max_pairs)
        before = ps.posting_score.launches
        got = ps.posting_score(ix.block_docs, ix.block_tfs, pb, pt, pw,
                               host.num_docs)
        want = ps.posting_score_plain(ix.block_docs, ix.block_tfs, pb, pt,
                                      pw, host.num_docs)
        torch.cuda.synchronize()
        assert int(ovf) == 0 and ps.posting_score.launches == before + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        scores, _ = ops.blocked_query_scores(ix, t, w,
                                             ix.max_blocks_per_term,
                                             max_pairs)
        d, tf, v = ix.gather_postings(t, host.max_posting_len)
        raw = query.accumulate_scores(d, tf * w[:, None], v, host.num_docs)
        assert torch.equal(scores.view(torch.int32), raw.view(torch.int32))
    assert (got != 0).sum() <= block


@pytest.mark.parametrize("bits", list(range(4, 33)))
@pytest.mark.parametrize("block", [16, 32, 128])
def test_unpack_kernel_equals_plain(gpu, bits, block):
    """Random words with all-ones high bytes, bases that wrap int32,
    counts below the block width: kernel and plain version agree."""
    rng = np.random.default_rng(bits * 1000 + block)
    nb = 64
    wpb = (block * bits + 31) // 32
    words = rng.integers(0, 2**32, size=(nb, wpb), dtype=np.uint32)
    words[:, -1] |= np.uint32(0xFF000000)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(gpu)  # noqa
    args = (t(words.view(np.int32)), t(np.full(nb, bits, np.int32)),
            t(np.r_[rng.integers(-5, 1000, nb - 1), [2**31 - 7]]
              .astype(np.int32)),
            t(rng.integers(0, block + 1, nb).astype(np.int32)))
    before = pp.unpack_blocks.launches
    got = pp.unpack_blocks(*args, block)
    want = pp.unpack_blocks_plain(*args, block)
    torch.cuda.synchronize()
    assert pp.unpack_blocks.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("block", [100, 128, 1024])
def test_unpack_postings_on_card(gpu, host, block):
    """Every block of a packed index (a block width that is not a
    multiple of a warp, the default, the widest) decoded on the card:
    equal to the plain decode and to the CPU build's."""
    ix = layouts.build_packed_csr(host, block=block, device=gpu)
    got = ops.unpack_postings(ix)
    want = pp.unpack_blocks_plain(ix.packed, ix.block_bits, ix.block_base,
                                  ix.block_count, block)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    cpu = ops.unpack_postings(layouts.build_packed_csr(host, block=block,
                                                       device="cpu"))
    assert torch.equal(got.cpu(), cpu)
    with pytest.raises(ValueError, match="lanes"):
        pp.unpack_blocks(ix.packed, ix.block_bits, ix.block_base,
                         ix.block_count, 2048)


def test_representations_rank_alike_on_card(gpu, host):
    """PR, OR (both lookups), COR, HOR and packed on the card: identical
    ids and bit-equal scores through the oracle, equal to the CPU's ids."""
    ixs = [layouts.build_coo(host, device=gpu),
           layouts.build_coo(host, lookup="hash", device=gpu),
           layouts.build_csr(host, device=gpu),
           layouts.build_csr(host, lookup="hash", device=gpu),
           layouts.build_compact_csr(host, device=gpu),
           layouts.build_blocked(host, device=gpu),
           layouts.build_packed_csr(host, device=gpu)]
    qh = corpus.sample_query_terms(host.df, host.term_hashes, 8, 4,
                                   num_docs=host.num_docs, seed=4)
    res = [query.make_scorer(ix, k=10, cap=host.max_posting_len)(qh)
           for ix in ixs]
    for r in res[1:]:
        assert torch.equal(r.doc_ids, res[0].doc_ids)
        assert torch.equal(r.scores.view(torch.int32),
                           res[0].scores.view(torch.int32))
    cpu = query.make_scorer(layouts.build_csr(host, device="cpu"), k=10,
                            cap=host.max_posting_len)(qh)
    assert torch.equal(res[0].doc_ids.cpu(), cpu.doc_ids)


# ---------------------------------------------------------------------------
# the model kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v,d,b,h,dtype", [
    (1000, 10, 777, 1, torch.float32), (5000, 10, 333, 8, torch.float32),
    (100, 128, 64, 3, torch.float32), (5000, 10, 333, 8, torch.bfloat16),
    (300, 64, 50, 5, torch.bfloat16)])
def test_embedding_bag_kernel_equals_plain(gpu, v, d, b, h, dtype):
    """Bit-equal, any B, a quarter of the slots padding, one bag of
    padding only; rows of mixed magnitude so bf16 rounds at every add."""
    g = torch.Generator(device=gpu).manual_seed(v + b)
    scale = torch.tensor([1.0, 300.0, 1e-3], device=gpu)[
        torch.randint(0, 3, (v, 1), generator=g, device=gpu)]
    table = (torch.randn(v, d, generator=g, device=gpu) * scale).to(dtype)
    idx = torch.randint(0, v, (b, h), generator=g, device=gpu,
                        dtype=torch.int32)
    idx[torch.rand(b, h, generator=g, device=gpu) < 0.25] = -1
    idx[0] = -1
    before = tbag.embedding_bag.launches
    got = tbag.embedding_bag(table, idx)
    want = tbag.embedding_bag_plain(table, idx)
    torch.cuda.synchronize()
    assert tbag.embedding_bag.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, d)
    assert torch.equal(got.float().view(torch.int32),
                       want.float().view(torch.int32))
    assert not got[0].float().view(torch.int32).any()


@pytest.mark.parametrize("n,k,d,nsrc", [(1000, 64, 75, 5000),
                                        (100, 15, 75, 300), (37, 5, 8, 20)])
def test_pna_kernel_equals_plain(gpu, n, k, d, nsrc):
    """Bit-equal: rows with no neighbour, padding scattered through the
    lists, signed zeros in the features."""
    g = torch.Generator(device=gpu).manual_seed(n + k)
    feats = torch.randn(nsrc, d, generator=g, device=gpu)
    feats[torch.rand(nsrc, d, generator=g, device=gpu) < 0.1] = 0.0
    feats[torch.rand(nsrc, d, generator=g, device=gpu) < 0.1] = -0.0
    nbr = torch.randint(0, nsrc, (n, k), generator=g, device=gpu,
                        dtype=torch.int32)
    nbr[torch.rand(n, k, generator=g, device=gpu) < 0.3] = -1
    nbr[::10] = -1
    before = tpna.pna_multi_agg.launches
    got = tpna.pna_multi_agg(feats, nbr)
    want = tpna.pna_multi_agg_plain(feats, nbr)
    torch.cuda.synchronize()
    assert tpna.pna_multi_agg.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("causal,window,b,hq,hkv,s,d,dtype", [
    (True, 0, 2, 4, 2, 64, 16, torch.float32),
    (True, 24, 2, 4, 4, 200, 32, torch.float32),
    (False, 0, 1, 2, 1, 130, 64, torch.float32),
    (False, 40, 1, 4, 2, 190, 16, torch.float32),
    (True, 0, 1, 4, 2, 256, 128, torch.float32),
    (True, 100, 1, 2, 1, 300, 256, torch.float32),
    (True, 16, 1, 8, 2, 128, 16, torch.bfloat16),
    (True, 0, 2, 4, 2, 320, 128, torch.bfloat16),
    (True, 128, 1, 4, 2, 512, 256, torch.bfloat16),
    (True, 0, 1, 2, 2, 100, 256, torch.bfloat16)])
def test_flash_kernel_equals_plain(gpu, causal, window, b, hq, hkv, s, d,
                                   dtype):
    """Within 2e-4 (f32) or 3e-2 (bf16, compared in f32) of the plain
    version, and in bf16 also within one bf16 rounding of the plain
    version run in f32 on the same inputs: head widths 16-256, S not a
    multiple of the 64-row tiles, causal, windowed, non-causal and
    GQA."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=gpu).manual_seed(s + d)
    q = torch.randn(b, hq, s, d, generator=g, device=gpu).to(dtype)
    k = torch.randn(b, hkv, s, d, generator=g, device=gpu).to(dtype)
    v = torch.randn(b, hkv, s, d, generator=g, device=gpu).to(dtype)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        f32 = tfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal=causal, window=window)
        torch.testing.assert_close(got.float(),
                                   f32.to(torch.bfloat16).float(),
                                   rtol=8e-3, atol=1e-3)
