"""The port's CUDA kernels against their plain PyTorch versions, and the
live index on the card against the same index on the CPU.  Marked ``cuda``: skipped where no GPU is available (the
CPU tests hold the plain versions against the JAX reference).  Imports
no jax, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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


def test_bitonic_reducer_launches_on_card(gpu, host):
    """``reducer="bitonic"`` on CUDA tensors launches the bitonic
    epilogue's kernel, counted apart from the successive one, with the
    successive kernel's answer (ids and, without signed zeros, bits)."""
    ix = layouts.build_blocked(host, device=gpu)
    qh = layouts.hash_tensor(corpus.sample_query_terms(
        host.df, host.term_hashes, 8, 3, num_docs=host.num_docs), gpu)
    term_ids, idf_t = query.lookup_query(ix, qh)
    before = (fds.fused_topk_blocked.launches,
              fds.fused_topk_blocked.launches_bitonic)
    out = {r: ops.fused_batched_topk(ix, term_ids, idf_t,
                                     host.max_posting_len, 10, reducer=r)
           for r in ("successive", "bitonic")}
    torch.cuda.synchronize()
    assert (fds.fused_topk_blocked.launches,
            fds.fused_topk_blocked.launches_bitonic) == (before[0] + 1,
                                                         before[1] + 1)
    (sv, si, _), (bv, bi, _) = out["successive"], out["bitonic"]
    assert torch.equal(si, bi)
    assert torch.equal(sv.view(torch.int32), bv.view(torch.int32))


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


def _dense_terms_host(num_docs, terms, seed):
    """``terms`` terms each in 50-90% of ``num_docs`` docs: a batch over
    them routes 100+ pairs to every tile, past the dense kernels' 16-pair
    pipeline chunk and their 32 pairs in flight."""
    rng = np.random.default_rng(seed)
    lists = [np.sort(rng.choice(num_docs, int(num_docs * f), replace=False))
             for f in rng.uniform(0.5, 0.9, terms)]
    lens = np.array([len(x) for x in lists])
    offsets = np.zeros(terms + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return PostingsHost(
        term_hashes=np.arange(1, terms + 1, dtype=np.uint32) * 7919,
        df=lens.astype(np.int32), offsets=offsets,
        doc_ids=np.concatenate(lists).astype(np.int32),
        tfs=rng.integers(1, 6, size=int(lens.sum())).astype(np.float32),
        num_docs=num_docs,
        norm=rng.random(num_docs).astype(np.float32) + 0.5,
        rank=rng.random(num_docs).astype(np.float32))


@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("queries", [8, 16])
@pytest.mark.parametrize("num_docs", [3001, 4096])
def test_dense_kernel_long_runs(gpu, layout, queries, num_docs):
    """Bit-equal to the plain version where every tile's run is longer
    than a pipeline chunk and the ring (runs of 100+ pairs), at Q = 8 and
    Q = 16, with a clipped last tile, and (3,001 docs) rows of the output
    that start off a 16-byte boundary; a mid-block cap too."""
    h = _dense_terms_host(num_docs, 40, num_docs + queries)
    ix = BUILDERS[layout](h, device=gpu)
    rng = np.random.default_rng(queries)
    qh = np.stack([rng.choice(h.term_hashes, 4, replace=False)
                   for _ in range(queries)]).astype(np.uint32)
    for cap in (h.max_posting_len, 300):
        tids, idf_t = query.lookup_query(ix, layouts.hash_tensor(qh, gpu))
        _, _, args, _, _ = ops.fused_score_args(ix, tids, idf_t, cap)
        pt = args[3].cpu().numpy()
        runs = np.bincount(pt[pt < -(-num_docs // fds.TILE)])
        assert runs.max() > 32 and args[4].shape[1] == queries
        assert runs.min() > 32 or cap == 300      # the cap ends in tile 1
        got = _assert_dense_equals_plain(ix, qh, cap)
        assert got.shape == (queries, num_docs) and bool((got > 0).any())


@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("queries,tile", [(24, 512), (8, 1024), (8, 256)])
def test_dense_kernel_other_q_and_tiles(gpu, layout, queries, tile):
    """Bit-equal to the plain version off the kernels compiled for Q = 8
    and 16 at 512-doc tiles: Q = 24 and 1,024-doc tiles take the generic
    kernel, 256-doc tiles the Q = 8 one with idle threads."""
    h = _dense_terms_host(3001, 40, queries + tile)
    ix = BUILDERS[layout](h, device=gpu)
    rng = np.random.default_rng(tile)
    qh = np.stack([rng.choice(h.term_hashes, 4, replace=False)
                   for _ in range(queries)]).astype(np.uint32)
    tids, idf_t = query.lookup_query(ix, layouts.hash_tensor(qh, gpu))
    kernel, plain, args, kw, _ = ops.fused_score_args(
        ix, tids, idf_t, h.max_posting_len, tile=tile)
    assert args[4].shape[1] == queries and kw["tile"] == tile
    before = kernel.launches
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got > 0).any())


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_dense_kernel_no_real_pairs_at_1m_docs(gpu, host, layout):
    """Zero real pairs (every pair padding) at 1,048,576 docs: every
    element 0.0, as the plain version gives, in one launch."""
    ix = BUILDERS[layout](host, device=gpu)
    num_docs = 1 << 20
    n_tiles = num_docs // fds.TILE
    n, q = 4096, 8
    i32 = dict(dtype=torch.int32, device=gpu)
    pb = torch.zeros(n, **i32)
    pt = torch.full((n,), n_tiles, **i32)
    qw = torch.ones(n, q, device=gpu)
    cap = torch.full((n,), 128, **i32)
    if layout == "hor":
        args = (ix.block_docs, ix.block_tfs, pb, pt, qw, cap, num_docs)
        kernel = fds.fused_score_blocked
        plain = fds.fused_score_blocked_plain
    else:
        zeros = torch.zeros(n, **i32)
        args = (ix.packed, ix.block_tfs, pb, pt, qw, cap, zeros, zeros,
                zeros, num_docs, ix.block)
        kernel = fds.fused_score_packed
        plain = fds.fused_score_packed_plain
    before = kernel.launches
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and got.shape == (q, num_docs)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not bool(got.view(torch.int32).any())


SPIN = "spin_kernel"      # torch.cuda._sleep's kernel, a trace's marker
OPENING_SPINS = 16        # markers before the calls


def _device_kernels(calls, attempts=3):
    """The device kernels, in order, of one profiler trace of
    ``kernel(*args, **kw)`` over ``calls``.  The profiler can drop the
    first events a trace records (2-4 of every trace late in a long
    ``-m cuda`` run; rarely in a fresh process, see
    ``scripts/probe_profiler_drops.py``), so the calls run between
    ``OPENING_SPINS`` short spin kernels of torch's and a closing one.
    A trace is taken as whole only when it opens and closes on a spin,
    else it is taken again, ``attempts`` times at most; its other
    kernels are the calls' kernels, each one that ran."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(OPENING_SPINS):
                torch.cuda._sleep(10_000)
            for kernel, args, kw in calls:
                kernel(*args, **kw)
            torch.cuda._sleep(10_000)
            torch.cuda.synchronize()
        names = [e.name for e in sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        if len(names) >= 2 and SPIN in names[0] and SPIN in names[-1]:
            return [n for n in names if SPIN not in n]
    raise AssertionError(f"no whole trace in {attempts} attempts: {names}")


def _layout_calls(host, gpu, make_args):
    """One HOR call then one packed call of the kernel ``make_args``
    routes to, each run once first (built and loaded)."""
    calls = []
    for layout in ("hor", "packed"):
        ix = BUILDERS[layout](host, device=gpu)
        qh = corpus.sample_query_terms(host.df, host.term_hashes, 8, 3,
                                       num_docs=host.num_docs, seed=4)
        tids, idf_t = query.lookup_query(ix, layouts.hash_tensor(qh, gpu))
        kernel, _, args, kw, _ = make_args(ix, tids, idf_t,
                                           host.max_posting_len)
        kernel(*args, **kw)
        calls.append((kernel, args, kw))
    return calls


def test_dense_kernel_is_one_device_launch(gpu, host):
    """A dense call is one kernel on the card and nothing else: no
    run-start search, copy or fill before it.  One profiler trace of an
    HOR call then a packed call shows exactly their two kernels."""
    names = _device_kernels(_layout_calls(host, gpu, ops.fused_score_args))
    assert len(names) == 2, names
    assert "score_kernel<fused_score::DenseOut, fused_score::HorBlocks" \
        in names[0], names
    assert "score_kernel<fused_score::DenseOut, fused_score::PackedBlocks" \
        in names[1], names


def test_topk_kernel_is_one_device_launch(gpu, host):
    """A candidate call is one kernel on the card, the dense kernels'
    walk with the candidate epilogue: no ``searchsorted``, ``arange``,
    copy or fill before it.  One profiler trace of an HOR call then a
    packed call shows exactly their two kernels."""
    names = _device_kernels(_layout_calls(
        host, gpu, lambda ix, tids, idf_t, cap: ops.fused_topk_args(
            ix, tids, idf_t, cap, 10)))
    assert len(names) == 2, names
    assert "score_kernel<fused_score::TopkOut, fused_score::HorBlocks" \
        in names[0], names
    assert "score_kernel<fused_score::TopkOut, fused_score::PackedBlocks" \
        in names[1], names


def _assert_topk_equals_plain(kernel, plain, args, kw,
                              reducer="successive"):
    """One launch of ``reducer``'s epilogue (counted in ``launches``, or
    in ``launches_bitonic`` for the bitonic one, and nowhere else) equal
    to the plain version with the same reducer, ids and value bits; a NaN
    equals a NaN in the same slot whatever its payload (the kernel's
    tail makes the card's NaN, 0x7fffffff; the plain version's f64 FMA
    emulation another)."""
    before = kernel.launches, kernel.launches_bitonic
    gv, gi = kernel(*args, **kw, reducer=reducer)
    wv, wi = plain(*args, **kw, reducer=reducer)
    torch.cuda.synchronize()
    bitonic = reducer == "bitonic"
    assert (kernel.launches, kernel.launches_bitonic) == (
        before[0] + (not bitonic), before[1] + bitonic)
    assert torch.equal(gi, wi)
    nan = gv.isnan()
    assert torch.equal(nan, wv.isnan())
    assert torch.equal(gv.view(torch.int32)[~nan], wv.view(torch.int32)[~nan])
    return gv, gi


@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("queries", [8, 16])
@pytest.mark.parametrize("num_docs", [3001, 4096])
def test_topk_kernel_long_runs(gpu, layout, queries, num_docs):
    """The candidate epilogue bit-equal to the plain version where every
    tile's run spans several pipeline chunks (runs of 100+ pairs), at
    Q = 8 and 16 (sums in registers, norm and rank staged), with a clipped
    last tile and a rank blend; a mid-block cap too."""
    h = _dense_terms_host(num_docs, 40, num_docs + queries)
    ix = BUILDERS[layout](h, device=gpu)
    rng = np.random.default_rng(queries)
    qh = np.stack([rng.choice(h.term_hashes, 4, replace=False)
                   for _ in range(queries)]).astype(np.uint32)
    tids, idf_t = query.lookup_query(ix, layouts.hash_tensor(qh, gpu))
    for cap in (h.max_posting_len, 300):
        kernel, plain, args, kw, _ = ops.fused_topk_args(
            ix, tids, idf_t, cap, 10, rank_blend=0.3)
        pt = args[3].cpu().numpy()
        runs = np.bincount(pt[pt < -(-num_docs // fds.TILE)])
        assert runs.max() > 32 and args[4].shape[1] == queries
        gv, gi = _assert_topk_equals_plain(kernel, plain, args, kw)
        assert bool(gv.isfinite().any())


@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("queries", [8, 16, 24])
@pytest.mark.parametrize("tile", [256, 512, 1024])
@pytest.mark.parametrize("k_tile", [1, 16, "tile"])
def test_topk_kernel_q_tiles_and_k_tile(gpu, layout, queries, tile, k_tile):
    """Bit-equal to the plain version at every kernel the launcher picks
    (Q = 8 and 16 at tiles up to 512, the generic one at Q = 24 and
    1,024-doc tiles, idle threads at 256) and at k_tile 1, 16 and the
    whole tile, where every lane is emitted and the rows run out of
    finite scores: (-inf, -1) fills them, as in successive maxima."""
    k_tile = tile if k_tile == "tile" else k_tile
    h = _dense_terms_host(3001, 40, queries + tile)
    ix = BUILDERS[layout](h, device=gpu)
    norm = ix.docs.norm.clone()
    norm[::5] = 0.0
    ix = dataclasses.replace(ix, docs=DocTable(norm=norm, rank=ix.docs.rank))
    rng = np.random.default_rng(tile + k_tile)
    qh = np.stack([rng.choice(h.term_hashes, 4, replace=False)
                   for _ in range(queries)]).astype(np.uint32)
    tids, idf_t = query.lookup_query(ix, layouts.hash_tensor(qh, gpu))
    kernel, plain, args, kw, _ = ops.fused_topk_args(
        ix, tids, idf_t, h.max_posting_len, k_tile, tile=tile, k_tile=k_tile)
    assert args[4].shape[1] == queries and kw["tile"] == tile
    assert args[-1] == k_tile
    gv, gi = _assert_topk_equals_plain(kernel, plain, args, kw)
    assert bool(gv.isfinite().any())
    if k_tile == tile:
        assert not bool(gv.isfinite().all()) and bool((gi == -1).any())


@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("queries", [8, 16])
@pytest.mark.parametrize("tile", [256, 512, 1024])
@pytest.mark.parametrize("k_tile", [8, 16, 32, 64, "tile"])
def test_bitonic_kernel_q_tiles_and_k_tile(gpu, layout, queries, tile,
                                           k_tile):
    """The bitonic epilogue bit-equal to the plain bitonic reducer at
    every geometry of the reference's sweep grid: tiles 256, 512 and
    1,024, Q = 8 and 16 (the kernels for their Q up to 512-doc tiles, the
    generic one at 1,024), k_tile from 8 to the whole tile (the
    selection up to 64, the network above), over deleted docs, a rank
    blend and runs of 100+ pairs; its ids and value bits equal the
    successive kernel's on the same pairs (no zero among them)."""
    k_tile = tile if k_tile == "tile" else k_tile
    h = _dense_terms_host(3001, 40, queries + tile)
    ix = BUILDERS[layout](h, device=gpu)
    norm = ix.docs.norm.clone()
    norm[::5] = 0.0
    ix = dataclasses.replace(ix, docs=DocTable(norm=norm, rank=ix.docs.rank))
    rng = np.random.default_rng(tile + k_tile)
    qh = np.stack([rng.choice(h.term_hashes, 4, replace=False)
                   for _ in range(queries)]).astype(np.uint32)
    tids, idf_t = query.lookup_query(ix, layouts.hash_tensor(qh, gpu))
    kernel, plain, args, kw, _ = ops.fused_topk_args(
        ix, tids, idf_t, h.max_posting_len, k_tile, rank_blend=0.3,
        tile=tile, k_tile=k_tile)
    assert args[4].shape[1] == queries and args[-1] == k_tile
    gv, gi = _assert_topk_equals_plain(kernel, plain, args, kw,
                                       "bitonic")
    sv, si = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(gi, si)
    assert torch.equal(gv.view(torch.int32), sv.view(torch.int32))
    assert bool(gv.isfinite().any())
    if k_tile == tile:
        assert bool((gi == -1).any())


@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("tile", [256, 1024])
def test_bitonic_kernel_ties_and_empty_tiles(gpu, layout, tile):
    """Exact ties over every doc (one term at tf 1, equal norms): the
    bitonic kernel keeps the lowest doc ids, in order; a visited tile
    whose docs are all deleted and the tiles no pair visits give
    (-inf, -1) throughout, as the plain version does."""
    n = 3 * tile + 17
    h = PostingsHost(
        term_hashes=np.array([111], np.uint32), df=np.array([n], np.int32),
        offsets=np.array([0, n], np.int64),
        doc_ids=np.arange(n, dtype=np.int32), tfs=np.ones(n, np.float32),
        num_docs=n + 5 * tile, norm=np.ones(n + 5 * tile, np.float32),
        rank=np.zeros(n + 5 * tile, np.float32))
    ix = BUILDERS[layout](h, device=gpu)
    norm = ix.docs.norm.clone()
    norm[tile:2 * tile] = 0.0
    ix = dataclasses.replace(ix, docs=DocTable(norm=norm, rank=ix.docs.rank))
    qh = np.zeros((8, 2), np.uint32)
    qh[:, 0] = 111
    tids, idf_t = query.lookup_query(ix, layouts.hash_tensor(qh, gpu))
    kernel, plain, args, kw, _ = ops.fused_topk_args(
        ix, tids, idf_t, n, 10, tile=tile)
    k_tile = args[-1]
    gv, gi = _assert_topk_equals_plain(kernel, plain, args, kw,
                                       "bitonic")
    assert torch.equal(gi[:, :k_tile].cpu(),
                       torch.arange(k_tile, dtype=torch.int32).expand(8, -1))
    for t in (1, 4, 7):                        # deleted, unvisited tiles
        assert bool((gi[:, t * k_tile:(t + 1) * k_tile] == -1).all())
        assert bool((gv[:, t * k_tile:(t + 1) * k_tile]
                     == float("-inf")).all())


def _signed_zero_docs(n, tile, gpu):
    """Two doc tables whose final scores hold zeros of both signs, made
    by the kernels' own scoring tail at qnorm 1e30 and rank_blend 0.5
    (norm 3e38 overflows the denominator, so the cosine is +0.0; half a
    rank of plus or minus the least subnormal rounds to a zero of that
    sign; norm 1.0 leaves a positive cosine near 1e-30, which the blend
    does not move).  "all": every doc a zero, the sign alternating by
    doc.  "mixed": per 64 docs one positive, four zeros, the rest deleted
    (norm 0); the zeros +0.0 in each tile's first half and in every third
    group of 16 docs after it but the last four, -0.0 elsewhere, so that
    a tile's zeros reach past the threshold of its 32 best and past its
    last +0.0."""
    tiny = float(np.float32(np.finfo(np.float32).smallest_subnormal))
    d = torch.arange(n, device=gpu)
    pos = d % tile
    plus = ((pos < tile // 2) | ((pos // 16) % 3 == 0)) & (pos < tile - 64)
    mixed = DocTable(
        norm=torch.where(d % 64 == 1, 1.0,
                         torch.where(d % 16 == 0, 3e38, 0.0)),
        rank=torch.where(plus, tiny, -tiny))
    rank = torch.full((n,), tiny, device=gpu)
    rank[::2] = -tiny
    return {"all": DocTable(norm=torch.full((n,), 3e38, device=gpu),
                            rank=rank),
            "mixed": mixed}


@pytest.mark.parametrize("reducer", fds.REDUCERS)
@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("tile", [512, 1024])
def test_bitonic_kernel_signed_zeros(gpu, layout, tile, reducer):
    """Final scores of +0.0 and -0.0 written by the kernel's own scoring
    tail (``_signed_zero_docs``), at k_tile 32 (at 512-doc tiles the
    gathered sort of the row's best) and 128 (every zero of a row
    emitted): each epilogue equals its plain reducer, ids and value bits.
    Both tie the two zeros and go by lane; the bitonic one moves each
    lane's own bits, the successive one writes the row's maximum, +0.0
    while one is left.  Both signs come out."""
    h = _dense_terms_host(3001, 40, tile)
    ix = BUILDERS[layout](h, device=gpu)
    qh = h.term_hashes[:24].reshape(8, 3)
    signs = set()
    for case, docs in _signed_zero_docs(ix.docs.norm.shape[0], tile,
                                        gpu).items():
        zx = dataclasses.replace(ix, docs=docs)
        tids, idf_t = query.lookup_query(zx, layouts.hash_tensor(qh, gpu))
        for k_tile in (32, 128):
            kernel, plain, args, kw, _ = ops.fused_topk_args(
                zx, tids, idf_t, h.max_posting_len, k_tile, rank_blend=0.5,
                tile=tile, k_tile=k_tile,
                qnorm=torch.full((8,), 1e30, device=gpu))
            gv, gi = _assert_topk_equals_plain(kernel, plain, args, kw,
                                               reducer)
            zero = gv == 0
            signs.update(torch.signbit(gv[zero]).unique().tolist())
            if case == "all":
                fin = gv.isfinite()
                assert bool(zero[fin].all())
                if reducer == "bitonic":        # each lane's own sign
                    assert torch.signbit(gv[zero]).unique().numel() == 2
    assert signs == {False, True}


def _nan_docs(ix, tile, gpu):
    """The index's docs with a NaN rank on four docs of tile 1, its last
    doc among them: their final scores are NaN wherever a query hits
    them (the blend multiplies the rank)."""
    rank = ix.docs.rank.clone()
    rank[torch.tensor([tile + 3, tile + 77, tile + 300, 2 * tile - 1],
                      device=gpu)] = float("nan")
    return dataclasses.replace(ix, docs=DocTable(norm=ix.docs.norm,
                                                 rank=rank))


def _nan_args(ix, h, tile, gpu, nan_query):
    """A 3,001-doc batch of 8 queries over ``ix`` at ``tile``, k_tile 16,
    rank_blend 0.3; with ``nan_query`` query 3 carries a NaN qnorm, so
    its rows are NaN in every tile it hits."""
    rng = np.random.default_rng(tile)
    qh = np.stack([rng.choice(h.term_hashes, 3, replace=False)
                   for _ in range(8)]).astype(np.uint32)
    tids, idf_t = query.lookup_query(ix, layouts.hash_tensor(qh, gpu))
    qnorm = query.query_norm(idf_t)
    if nan_query:
        qnorm[3] = float("nan")
    return ops.fused_topk_args(ix, tids, idf_t, h.max_posting_len, 16,
                               rank_blend=0.3, tile=tile, qnorm=qnorm)


@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("tile", [512, 1024])
def test_successive_kernel_nan_rows(gpu, layout, tile):
    """NaN final scores (a NaN rank on four docs of tile 1, a NaN qnorm
    on query 3): a row holding one gives (NaN, -1) in every slot, as
    successive maxima do, and every other row of the same tiles its
    best; the kernel equals the plain version, ids and value bits."""
    h = _dense_terms_host(3001, 40, tile + 1)
    ix = _nan_docs(BUILDERS[layout](h, device=gpu), tile, gpu)
    kernel, plain, args, kw, _ = _nan_args(ix, h, tile, gpu, True)
    gv, gi = _assert_topk_equals_plain(kernel, plain, args, kw)
    k_tile = args[-1]
    rows = gv.isnan().view(8, -1, k_tile)
    assert bool((rows.any(-1) == rows.all(-1)).all())   # NaN rows whole
    assert bool(rows[3].all(-1).any()) and bool(rows[:, 1].all(-1).any())
    assert bool((gi[gv.isnan()] == -1).all())
    assert bool(gv[0, :k_tile].isfinite().all())


@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("tile", [512, 1024])
def test_bitonic_kernel_nan_rows(gpu, layout, tile):
    """NaN final scores through the bitonic epilogue: a CTA whose tile
    holds one sorts with the reference's network, whose output at a NaN
    depends on positions.  One launch with NaN ranks in tile 1 only (the
    network there, the selection in the NaN-free tiles beside it), one
    with query 3's qnorm NaN too (the network in every visited tile);
    each equals the plain bitonic reducer, ids and value bits."""
    h = _dense_terms_host(3001, 40, tile + 2)
    ix = _nan_docs(BUILDERS[layout](h, device=gpu), tile, gpu)
    for nan_query in (False, True):
        kernel, plain, args, kw, _ = _nan_args(ix, h, tile, gpu, nan_query)
        gv, gi = _assert_topk_equals_plain(kernel, plain, args, kw,
                                           "bitonic")
        assert bool(gv[0, :args[-1]].isfinite().all())


def test_bitonic_kernel_is_one_device_launch(gpu, host):
    """A bitonic call is one kernel on the card, the walk with the
    bitonic epilogue: one profiler trace of an HOR call then a packed
    call shows exactly their two kernels."""
    def make_args(ix, tids, idf_t, cap):
        kernel, plain, args, kw, ovf = ops.fused_topk_args(ix, tids, idf_t,
                                                           cap, 10)
        return kernel, plain, args, dict(kw, reducer="bitonic"), ovf
    names = _device_kernels(_layout_calls(host, gpu, make_args))
    assert len(names) == 2, names
    assert "score_kernel<fused_score::BitonicOut, fused_score::HorBlocks" \
        in names[0], names
    assert "score_kernel<fused_score::BitonicOut, fused_score::PackedBlocks" \
        in names[1], names


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_bitonic_geometry_past_shared_memory_is_refused(gpu, layout):
    """Q = 32 at 1,024-doc tiles: the bitonic epilogue's lane array does
    not fit beside the walk's buffers, so the launcher and the occupancy
    query refuse it by name, before any launch; the successive epilogue
    runs it."""
    h = _dense_terms_host(3001, 40, 32)
    ix = BUILDERS[layout](h, device=gpu)
    qh = np.stack([h.term_hashes[i:i + 4] for i in range(32)])
    tids, idf_t = query.lookup_query(ix, layouts.hash_tensor(qh, gpu))
    kernel, plain, args, kw, _ = ops.fused_topk_args(
        ix, tids, idf_t, h.max_posting_len, 10, tile=1024)
    before = kernel.launches_bitonic
    with pytest.raises(ValueError, match=r"Q=32 x tile=1024 \(reducer="
                                         r"'bitonic'.*shared memory"):
        kernel(*args, **kw, reducer="bitonic")
    wpb = args[0].shape[1] if layout == "packed" else 0
    with pytest.raises(ValueError, match="shared memory"):
        fds.occupancy(kernel.__name__, 32, 1024, wpb, "bitonic")
    assert kernel.launches_bitonic == before
    _assert_topk_equals_plain(kernel, plain, args, kw)


@pytest.mark.parametrize("name,wpb", [("fused_topk_blocked", 0),
                                      ("fused_topk_packed", 9),
                                      ("fused_score_blocked", 0),
                                      ("fused_score_packed", 33)])
def test_smem_plan_mirror_equals_kernel(gpu, name, wpb):
    """``fused_smem_bytes``, which ``check_smem`` refuses geometries by,
    gives the shared memory the kernels' own plan asks for (their
    occupancy entry points), at every Q, tile and epilogue that fits."""
    reducers = ("successive", "bitonic") if "topk" in name else \
        ("successive",)
    for q in (8, 16, 24):
        for tile in (256, 512, 1024):
            for reducer in reducers:
                want = fds.fused_smem_bytes(name, q, tile, wpb, reducer)
                if want > fds.SMEM_LIMIT:
                    continue
                ctas, smem = fds.occupancy(name, q, tile, wpb, reducer)
                assert smem == want and ctas >= 1, (q, tile, reducer)


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_bitonic_table_entry_launches_bitonic_kernel(gpu, host, layout):
    """A bitonic entry of the active tuning table, keyed by the CUDA
    device type, reaches the bitonic kernel through ``make_scorer`` (no
    downgrade), with the empty table's answer to the bit."""
    from repro_torch.kernels import autotune
    ix = BUILDERS[layout](host, device=gpu)
    qh = corpus.sample_query_terms(host.df, host.term_hashes, 8, 3,
                                   num_docs=host.num_docs, seed=6)
    cap = host.max_posting_len
    kernel = getattr(fds, "fused_topk_blocked" if layout == "hor"
                     else "fused_topk_packed")
    base = query.make_scorer(ix, k=10, cap=cap, engine="fused")(qh)
    table = autotune.TuningTable()
    table.put("cuda", autotune.size_class_of(int(ix.docs.num_docs)), layout,
              autotune.TuneConfig(reducer="bitonic"))
    prev = autotune.set_active(table)
    try:
        before = kernel.launches, kernel.launches_bitonic
        got = query.make_scorer(ix, k=10, cap=cap, engine="fused")(qh)
        torch.cuda.synchronize()
        assert (kernel.launches, kernel.launches_bitonic) == (
            before[0], before[1] + 1)
    finally:
        autotune.set_active(prev)
    assert torch.equal(got.doc_ids, base.doc_ids)
    assert torch.equal(got.scores.view(torch.int32),
                       base.scores.view(torch.int32))


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_topk_kernel_visited_tile_all_deleted(gpu, layout):
    """A visited tile whose every doc is deleted (norm 0) gives (-inf, -1)
    in every slot, as an unvisited one does, beside live tiles."""
    h = _dense_terms_host(3001, 40, 5)
    ix = BUILDERS[layout](h, device=gpu)
    norm = ix.docs.norm.clone()
    norm[fds.TILE:2 * fds.TILE] = 0.0
    ix = dataclasses.replace(ix, docs=DocTable(norm=norm, rank=ix.docs.rank))
    qh = h.term_hashes[:24].reshape(8, 3)
    tids, idf_t = query.lookup_query(ix, layouts.hash_tensor(qh, gpu))
    kernel, plain, args, kw, _ = ops.fused_topk_args(
        ix, tids, idf_t, h.max_posting_len, 10)
    k_tile = args[-1]
    assert bool((args[3] == 1).any())           # tile 1 is visited
    gv, gi = _assert_topk_equals_plain(kernel, plain, args, kw)
    dead = slice(k_tile, 2 * k_tile)
    assert bool((gv[:, dead] == float("-inf")).all())
    assert bool((gi[:, dead] == -1).all())
    assert bool(gv[:, :k_tile].isfinite().all())


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_topk_kernel_no_real_pairs_at_1m_docs(gpu, host, layout):
    """Zero real pairs (every pair padding) at 1,048,576 docs: (-inf, -1)
    in every slot, as the plain version gives, in one launch."""
    ix = BUILDERS[layout](host, device=gpu)
    num_docs = 1 << 20
    n_tiles = num_docs // fds.TILE
    n, q, k_tile = 4096, 8, 16
    i32 = dict(dtype=torch.int32, device=gpu)
    pb = torch.zeros(n, **i32)
    pt = torch.full((n,), n_tiles, **i32)
    qw = torch.ones(n, q, device=gpu)
    cap = torch.full((n,), 128, **i32)
    norm = torch.ones(num_docs, device=gpu)
    rank = torch.zeros(num_docs, device=gpu)
    qnorm = torch.ones(q, device=gpu)
    if layout == "hor":
        args = (ix.block_docs, ix.block_tfs, pb, pt, qw, cap, norm, rank,
                qnorm, num_docs, k_tile)
        kernel, plain = fds.fused_topk_blocked, fds.fused_topk_blocked_plain
    else:
        zeros = torch.zeros(n, **i32)
        args = (ix.packed, ix.block_tfs, pb, pt, qw, cap, zeros, zeros,
                zeros, norm, rank, qnorm, num_docs, ix.block, k_tile)
        kernel, plain = fds.fused_topk_packed, fds.fused_topk_packed_plain
    gv, gi = _assert_topk_equals_plain(kernel, plain, args, {})
    assert gv.shape == (q, n_tiles * k_tile)
    assert bool((gv == float("-inf")).all()) and bool((gi == -1).all())


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


def _synthetic_blocks(gpu, nb, block, num_docs, seed):
    """Posting blocks of unique doc ids (a tenth of the lanes padding)
    and tfs in (0, 4), so that every product rounds."""
    rng = np.random.default_rng(seed)
    docs = np.stack([np.sort(rng.choice(num_docs, block, replace=False))
                     for _ in range(nb)]).astype(np.int32)
    docs[rng.random(docs.shape) < 0.1] = -1
    tfs = (rng.random(docs.shape) * 4 + 1e-3).astype(np.float32)
    return (torch.from_numpy(docs).to(gpu), torch.from_numpy(tfs).to(gpu),
            rng)


@pytest.mark.parametrize("case", ["no_pairs", "one_tile", "wide_tile"])
def test_posting_score_kernel_edge_runs(gpu, case):
    """Bit-equal to the plain version where the kernel's own run search
    meets its edges: no real pair (every pair padding, all scores 0), one
    tile holding every pair (a run far longer than the warp's 32
    samples), and a 16,384-doc tile whose accumulator takes 64 KB of
    shared memory, past the 48 KB default."""
    num_docs, tile, n = 100_000, ps.TILE, 3000
    if case == "wide_tile":
        tile = 16_384
    docs, tfs, rng = _synthetic_blocks(gpu, 512, 128, num_docs, len(case))
    n_tiles = -(-num_docs // tile)
    pb = rng.integers(0, 512, n)
    if case == "no_pairs":
        pt = np.full(n, n_tiles)
    elif case == "one_tile":
        pt = np.full(n, n_tiles // 2)
        pt[-5:] = n_tiles
    else:
        pt = np.sort(rng.integers(0, n_tiles + 1, n))
    pw = rng.random(n).astype(np.float32) * 3
    pb, pt, pw = (torch.from_numpy(x).to(gpu) for x in (
        pb.astype(np.int32), pt.astype(np.int32), pw))
    before = ps.posting_score.launches
    got = ps.posting_score(docs, tfs, pb, pt, pw, num_docs, tile)
    want = ps.posting_score_plain(docs, tfs, pb, pt, pw, num_docs, tile)
    torch.cuda.synchronize()
    assert ps.posting_score.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got != 0).any()) == (case != "no_pairs")


def test_posting_score_is_one_device_launch(gpu):
    """A call of the scorer is one kernel on the card and nothing else
    (no run search, copy or fill of its own), counted by the
    profiler (a whole trace: see ``_device_kernels``)."""
    docs, tfs, rng = _synthetic_blocks(gpu, 64, 128, 20_000, 0)
    n_tiles = -(-20_000 // ps.TILE)
    pt = torch.from_numpy(np.sort(rng.integers(0, n_tiles + 1, 500))
                          .astype(np.int32)).to(gpu)
    pb = torch.from_numpy(rng.integers(0, 64, 500).astype(np.int32)).to(gpu)
    pw = torch.ones(500, device=gpu)
    ps.posting_score(docs, tfs, pb, pt, pw, 20_000)      # built and loaded
    names = _device_kernels([(ps.posting_score,
                              (docs, tfs, pb, pt, pw, 20_000), {})])
    assert len(names) == 1 and "posting_score_kernel" in names[0], names


@pytest.mark.parametrize("num_docs", [1_004_721, 1_054_721, 4_097])
def test_idf_kernel_equals_plain(gpu, num_docs):
    """``query.idf`` on the card (``csrc/query_weights.cu``) gives the
    plain version's bits, on the card and on the CPU, over every df in
    0..D: one launch."""
    df = torch.arange(0, num_docs + 1, dtype=torch.int32)
    want = query.idf_plain(df, num_docs)
    before = query.idf.launches
    got = query.idf(df.to(gpu), num_docs)
    on_card = query.idf_plain(df.to(gpu), num_docs)
    torch.cuda.synchronize()
    assert query.idf.launches == before + 1
    for x in (got, on_card):
        assert torch.equal(x.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("rows", [5, 8, 4096])
def test_query_norm_kernel_equals_plain(gpu, rows):
    """``query.query_norm`` on the card gives the plain version's bits at
    every width from 1 to 32 (the FMA chain and the 5-8-slot rule alike),
    with absent slots and an all-zero row; one launch per call."""
    rng = np.random.default_rng(rows)
    for slots in range(1, 33):
        w = (rng.random((rows, slots)) * 14).astype(np.float32)
        w[rng.random(w.shape) < 0.2] = 0.0
        w[0] = 0.0
        want = query.query_norm_plain(torch.from_numpy(w))
        before = query.query_norm.launches
        got = query.query_norm(torch.from_numpy(w).to(gpu))
        torch.cuda.synchronize()
        assert query.query_norm.launches == before + 1
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)), slots


def test_query_weights_are_one_device_launch_each(gpu):
    """``idf`` and ``query_norm`` on the card are one kernel each and
    nothing else: no copy to the host, no elementwise op of their own.
    Two rounds, in one whole trace (``_device_kernels``), show exactly
    idf, norm, idf, norm."""
    df = torch.randint(0, 1000, (8, 3), dtype=torch.int32, device=gpu)
    query.query_norm(query.idf(df, 1000))          # built and loaded
    names = _device_kernels([(lambda: query.query_norm(query.idf(df, 1000)),
                              (), {})] * 2)
    assert len(names) == 4, names
    for name, want in zip(names, ("idf_kernel", "norm_kernel") * 2):
        assert want in name, names


def test_query_weights_refuse_bad_inputs(gpu):
    """The weights' launcher refuses what its kernels would misread."""
    df = torch.ones(4, 6, dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError, match="contiguous"):
        query.idf(df.t(), 10)
    with pytest.raises(ValueError, match="torch.int32"):
        query.idf(df.long(), 10)
    with pytest.raises(ValueError, match="contiguous"):
        query.query_norm(df.float().t())


@pytest.mark.parametrize("bits", list(range(1, 33)))
@pytest.mark.parametrize("block", [1, 7, 16, 32, 33, 100, 128, 1000, 1024])
def test_unpack_kernel_equals_plain(gpu, bits, block):
    """Random words with all-ones high bytes, bases that wrap int32,
    counts below the block width and blocks with count 0, every width
    class of the kernel (1 to 32 lanes per thread, widths that are not
    a multiple of 4 or of a warp): kernel and plain version agree."""
    rng = np.random.default_rng(bits * 1000 + block)
    nb = 64
    wpb = (block * bits + 31) // 32
    words = rng.integers(0, 2**32, size=(nb, wpb), dtype=np.uint32)
    words[:, -1] |= np.uint32(0xFF000000)
    count = rng.integers(0, block + 1, nb).astype(np.int32)
    count[::5] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(gpu)  # noqa
    args = (t(words.view(np.int32)), t(np.full(nb, bits, np.int32)),
            t(np.r_[rng.integers(-5, 1000, nb - 1), [2**31 - 7]]
              .astype(np.int32)),
            t(count))
    before = pp.unpack_blocks.launches
    got = pp.unpack_blocks(*args, block)
    want = pp.unpack_blocks_plain(*args, block)
    torch.cuda.synchronize()
    assert pp.unpack_blocks.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("nb,block", [(200_003, 32), (200_003, 128),
                                      (30_011, 1000)])
def test_unpack_kernel_walk_wraps(gpu, nb, block):
    """More blocks than the card's resident warps take in one sweep, so
    each warp's walk wraps many times; a bit width per block from 0 to
    40 (above 32 a block decodes from device memory, not its staged
    words), a row as wide as 40 bits need, counts from 0 to the width."""
    g = torch.Generator(device=gpu).manual_seed(nb + block)
    wpb = (block * 40 + 31) // 32
    words = torch.randint(-2**31, 2**31 - 1, (nb, wpb), generator=g,
                          device=gpu, dtype=torch.int32)
    bits = torch.randint(0, 41, (nb,), generator=g, device=gpu,
                         dtype=torch.int32)
    base = torch.randint(-2**31, 2**31 - 1, (nb,), generator=g, device=gpu,
                         dtype=torch.int32)
    count = torch.randint(0, block + 1, (nb,), generator=g, device=gpu,
                          dtype=torch.int32)
    before = pp.unpack_blocks.launches
    got = pp.unpack_blocks(words, bits, base, count, block)
    want = pp.unpack_blocks_plain(words, bits, base, count, block)
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
    (True, 512, 1, 16, 8, 4096, 128, torch.float32),
    (True, 16, 1, 8, 2, 128, 16, torch.bfloat16),
    (True, 0, 2, 4, 2, 320, 128, torch.bfloat16),
    (True, 128, 1, 4, 2, 512, 256, torch.bfloat16),
    (True, 0, 1, 2, 2, 100, 256, torch.bfloat16),
    (True, 0, 1, 16, 8, 4000, 128, torch.bfloat16),
    (True, 0, 2, 8, 1, 65, 16, torch.bfloat16),
    (True, 0, 1, 8, 1, 65, 32, torch.bfloat16),
    (True, 40, 1, 8, 1, 4000, 64, torch.bfloat16),
    (False, 20, 1, 16, 8, 65, 32, torch.bfloat16),
    (False, 0, 1, 16, 8, 300, 64, torch.bfloat16),
    (True, 24, 1, 4, 2, 4000, 256, torch.bfloat16),
    (True, 50, 1, 16, 8, 4000, 16, torch.bfloat16)])
def test_flash_kernel_equals_plain(gpu, causal, window, b, hq, hkv, s, d,
                                   dtype):
    """Within 2e-4 (f32) or 3e-2 (bf16, compared in f32) of the plain
    version, and in bf16 also within one bf16 rounding of the plain
    version run in f32 on the same inputs: every head width in both
    dtypes (bf16 on the tensor cores), S not a multiple of the 64-row
    tiles (65, 4,000), windows shorter than a tile, causal, windowed,
    non-causal and GQA (Hq/Hkv 16/8, 8/1)."""
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


@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (1, 4, 2, 1000, 128, 0), (1, 16, 8, 4096, 128, 0),
    (2, 4, 2, 300, 64, 100), (1, 2, 1, 500, 256, 0),
    (1, 8, 2, 333, 16, 40)])
def test_flash_f32_wide_logits(gpu, b, hq, hkv, s, d, window):
    """Logits 30 times wider than unit-variance q and k give (q and k
    scaled by its root): the kernel's three TF32 passes stay within 2e-4
    of the plain version, where the plain version on inputs rounded to
    TF32 alone, less error than one pass, is already outside it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=gpu).manual_seed(s + d + window)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=gpu)
               for h in (hq, hkv, hkv))
    q, k = q * 30 ** 0.5, k * 30 ** 0.5
    got = tfa.flash_attention(q, k, v, causal=True, window=window)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    tf32 = [((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)
            for x in (q, k, v)]
    one = tfa.flash_attention_plain(*tf32, causal=True, window=window)
    assert not bool(((one - want).abs() <= 2e-4 + 2e-4 * want.abs()).all())


def _misaligned(x):
    """A contiguous copy of ``x`` that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def _transposed(x):
    """The same values as ``x`` in a non-contiguous view (its last two
    dimensions stored the other way round)."""
    out = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not out.is_contiguous() and torch.equal(out, x)
    return out


@pytest.mark.parametrize("view", ["transposed", "misaligned"])
def test_model_entry_points_take_views(gpu, view):
    """``ops.embedding_bag``, ``ops.pna_multi_agg`` and ``ops.attention``
    take non-contiguous and misaligned views, as the reference's entry
    points take any array, and return what the contiguous call returns,
    to the bit, in one launch each; the kernel wrappers called directly
    still refuse a non-contiguous tensor (attention's also a misaligned
    one)."""
    g = torch.Generator(device=gpu).manual_seed(11)
    mk = _transposed if view == "transposed" else _misaligned
    table = torch.randn(500, 24, generator=g, device=gpu)
    idx = torch.randint(-1, 500, (64, 6), generator=g, device=gpu,
                        dtype=torch.int32)
    feats = torch.randn(300, 40, generator=g, device=gpu)
    nbr = torch.randint(-1, 300, (90, 12), generator=g, device=gpu,
                        dtype=torch.int32)
    q, k, v = (torch.randn(1, h, 130, 64, generator=g, device=gpu)
               .to(torch.bfloat16) for h in (4, 2, 2))
    cases = [(ops.embedding_bag, tbag.embedding_bag, (table, idx), {}),
             (ops.pna_multi_agg, tpna.pna_multi_agg, (feats, nbr), {}),
             (ops.attention, tfa.flash_attention, (q, k, v),
              {"causal": True, "window": 0})]
    for entry, wrapper, args, kw in cases:
        want = entry(*args, **kw)
        views = tuple(mk(a) for a in args)
        before = wrapper.launches
        got = entry(*views, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert torch.equal(got.float().view(torch.int32),
                           want.float().view(torch.int32))
        if view == "transposed" or wrapper is tfa.flash_attention:
            with pytest.raises(ValueError, match="contiguous|16-byte"):
                wrapper(*views, **kw)


# ---------------------------------------------------------------------------
# the two gathers at their kernels' edges, one launch with no
# synchronisation, ids past the table refused on the card
# ---------------------------------------------------------------------------


def _pna_case(gpu, case):
    """(feats, nbr) for one edge of the PNA kernel: ogbn-like lists (d 75,
    K 64, degrees 37-64, padding only at the tail); padding scattered
    with some nodes of no valid neighbour; lists longer than the
    kernel's 64-slot chunk; rows wider than one pass of columns."""
    g = torch.Generator(device=gpu).manual_seed(len(case))
    n, k, d, nsrc = {"ogbn": (3000, 64, 75, 40_000),
                     "scattered": (2000, 15, 75, 5000),
                     "long_lists": (300, 150, 75, 5000),
                     "wide_rows": (500, 12, 300, 3000)}[case]
    feats = torch.randn(nsrc, d, generator=g, device=gpu)
    feats[torch.rand(nsrc, d, generator=g, device=gpu) < 0.1] = -0.0
    nbr = torch.randint(0, nsrc, (n, k), generator=g, device=gpu,
                        dtype=torch.int32)
    if case == "ogbn":
        deg = torch.randint(37, 65, (n, 1), generator=g, device=gpu)
        nbr[torch.arange(k, device=gpu)[None, :] >= deg] = -1
    else:
        nbr[torch.rand(n, k, generator=g, device=gpu) < 0.3] = -1
        nbr[::7] = -1
    return feats, nbr


@pytest.mark.parametrize("case", ["ogbn", "scattered", "long_lists",
                                  "wide_rows"])
def test_pna_kernel_edges(gpu, case):
    """The PNA kernel gives the plain version's bits at each edge of its
    design (padding anywhere, nodes of no neighbour, several 64-slot list
    chunks, several blocks of 128 columns)."""
    feats, nbr = _pna_case(gpu, case)
    got = tpna._launch_pna_cuda(feats, nbr)
    want = tpna.pna_multi_agg_plain(feats, nbr)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case != "ogbn":
        assert not got[::7, 75:225].view(torch.int32).any()


def _bag_case(gpu, case):
    """(table, indices) for one edge of the bag kernel: a one-hot batch
    larger than one wave of the card, and one too small to fill it; bf16
    tables at d 10 (4-byte vectors) and 64 (16-byte vectors); an odd bf16
    width (2-byte vectors); f32 rows of 128 (32 vectors); 13 slots (a
    partial group of eight); a table 4 bytes past an 8-byte boundary."""
    g = torch.Generator(device=gpu).manual_seed(len(case))
    v, d, b, h, dtype = {
        "one_hot_waves": (1_000_000, 10, 600_000, 1, torch.float32),
        "small_one_hot": (1_000_000, 10, 50_000, 1, torch.float32),
        "bf16_d10": (5000, 10, 2000, 8, torch.bfloat16),
        "bf16_d64": (3000, 64, 700, 5, torch.bfloat16),
        "bf16_d7": (3000, 7, 700, 3, torch.bfloat16),
        "f32_d128": (2000, 128, 500, 3, torch.float32),
        "slots_13": (4000, 10, 900, 13, torch.float32),
        "misaligned": (4000, 10, 900, 4, torch.float32)}[case]
    scale = torch.tensor([1.0, 300.0, 1e-3], device=gpu)[
        torch.randint(0, 3, (v, 1), generator=g, device=gpu)]
    table = (torch.randn(v, d, generator=g, device=gpu) * scale).to(dtype)
    if case == "misaligned":
        buf = torch.empty(table.numel() + 1, device=gpu)
        table = buf[1:].view(v, d).copy_(table)
        assert table.data_ptr() % 8 == 4
    idx = torch.randint(0, v, (b, h), generator=g, device=gpu,
                        dtype=torch.int32)
    if h > 1:
        idx[torch.rand(b, h, generator=g, device=gpu) < 0.25] = -1
    idx[::11] = -1
    return table, idx


@pytest.mark.parametrize("case", ["one_hot_waves", "small_one_hot",
                                  "bf16_d10", "bf16_d64", "bf16_d7",
                                  "f32_d128", "slots_13", "misaligned"])
def test_embedding_bag_kernel_edges(gpu, case):
    """The bag kernel gives the plain version's bits at each edge of its
    design (4 items per thread, or 1 below 2**20 items; vectors of 16, 8,
    4 and 2 bytes; groups of 8 slots); a bag of padding only sums to
    +0.0."""
    table, idx = _bag_case(gpu, case)
    got = tbag._launch_embedding_bag_cuda(table, idx)
    want = tbag.embedding_bag_plain(table, idx)
    torch.cuda.synchronize()
    assert got.dtype == table.dtype and got.shape == want.shape
    assert torch.equal(got.float().view(torch.int32),
                       want.float().view(torch.int32))
    assert not got[::11].float().view(torch.int32).any()


def test_gathers_are_one_launch_without_sync(gpu):
    """Each call of the two gathers, through the entry point or the
    wrapper, is one device kernel and nothing else (no reduction of the
    ids), and nothing on its path synchronises with the device: the calls
    run under ``set_sync_debug_mode("error")``, which raises at any
    synchronising call of torch's."""
    table, idx = _bag_case(gpu, "bf16_d10")
    feats, nbr = _pna_case(gpu, "scattered")
    calls = [(ops.embedding_bag, (table, idx), {}),
             (tbag.embedding_bag, (table, idx), {}),
             (ops.pna_multi_agg, (feats, nbr), {}),
             (tpna.pna_multi_agg, (feats, nbr), {})]
    for fn, args, kw in calls:                 # built and loaded
        fn(*args, **kw)
    torch.cuda.synchronize()
    before = (tbag.embedding_bag.launches, tpna.pna_multi_agg.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn, args, kw in calls:
            fn(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (tbag.embedding_bag.launches, tpna.pna_multi_agg.launches) == (
        before[0] + 2, before[1] + 2)
    names = _device_kernels(calls)
    assert len(names) == 4, names
    for name, want in zip(names, ("bag_kernel", "bag_kernel", "pna_kernel",
                                  "pna_kernel")):
        assert want in name, names


_REFUSE = """
import torch
from repro_torch.kernels import ops
dev = torch.device("cuda", 0)
if {kernel!r} == "embedding_bag":
    idx = torch.full((64, 3), -1, dtype=torch.int32, device=dev)
    idx[:, 0] = 5
    idx[17, 2] = {bad}
    ops.embedding_bag(torch.ones(100, 10, device=dev), idx)
else:
    nbr = torch.full((300, 64), -1, dtype=torch.int32, device=dev)
    nbr[:, :40] = 7
    nbr[123, 41] = {bad}
    ops.pna_multi_agg(torch.ones(100, 75, device=dev), nbr)
torch.cuda.synchronize()
print("no error")
"""


@pytest.mark.parametrize("kernel", ["embedding_bag", "pna_multi_agg"])
def test_gather_refuses_id_past_table(gpu, kernel):
    """An id past the table is refused on the card: the kernel prints
    the id and traps, so the launch fails and the next synchronising
    call raises.  A trap ends the process's CUDA context, so the call
    runs in a child process, which must exit non-zero with the id in its
    output."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(src)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    bad = 100_007
    run = subprocess.run(
        [sys.executable, "-c", _REFUSE.format(kernel=kernel, bad=bad)],
        capture_output=True, text=True, env=env, timeout=600)
    said = run.stdout + run.stderr
    assert run.returncode != 0, said
    assert "no error" not in said
    assert f"holds id {bad}" in said, said


# ---------------------------------------------------------------------------
# the serving tier on the card
# ---------------------------------------------------------------------------


def _recording_server(index, config, lock=None):
    """A ``QueryServer`` that remembers every view it pinned, by epoch."""
    from repro_torch.serve import QueryServer

    class Server(QueryServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.views = {self._pinned.epoch: self._pinned}

        def refresh_view(self):
            v = super().refresh_view()
            self.views[v.epoch] = v
            return v
    return Server(index, config, lock)


def _held_to_views(server, tickets, k):
    """Every response equals ``view.topk`` (fused, candidates) of the
    view pinned for its epoch on its own padded row, ids and score bits,
    and its ids equal the gather oracle's there.  A row's answer does
    not depend on the other rows of its batch."""
    by_epoch = {}
    for t in tickets:
        r = t.result(timeout=120.0)
        assert r.ok
        by_epoch.setdefault(r.epoch, []).append(t)
    for epoch, group in by_epoch.items():
        view = server.views[epoch]
        for b0 in range(0, len(group), 8):
            part = group[b0:b0 + 8]
            qb = np.stack([t.row for t in part])
            want = view.topk(qb, k)
            oracle = view.topk(qb, k, engine="torch")
            ids = np.stack([t.response.doc_ids for t in part])
            sc = np.stack([t.response.scores for t in part])
            np.testing.assert_array_equal(ids, want.doc_ids.cpu().numpy())
            np.testing.assert_array_equal(
                sc.view(np.int32), want.scores.cpu().numpy().view(np.int32))
            np.testing.assert_array_equal(ids, oracle.doc_ids.cpu().numpy())
    return by_epoch


def test_server_on_card_equals_view_and_oracle(gpu):
    """A small live stack on the card (banded, HOR and packed seals, a
    delta, tombstones) behind a ``QueryServer``: every response equals
    ``view.topk`` on the same batch, ids and score bits, its ids equal
    the oracle's, cache hits repeat it bit for bit, and each micro-batch
    launched ``idf`` and ``query_norm`` once."""
    from repro_torch.serve import ServerConfig
    tc = corpus.generate(corpus.CorpusSpec(num_docs=4900, vocab=3000,
                                           avg_distinct=30, seed=5))
    si = _live_schedule(tc, gpu)
    server = _recording_server(si, ServerConfig(trace_sample=1))
    server.warmup()
    pool = corpus.sample_query_terms(np.asarray(si._df), si.term_hashes, 16,
                                     3, num_docs=si.live_doc_count, seed=4)
    query.idf.launches = query.query_norm.launches = 0
    tickets = [server.submit(q) for q in pool]
    while server.pending:
        server.pump()
    assert query.idf.launches == query.query_norm.launches == 2
    _held_to_views(server, tickets, 10)
    query.idf.launches = 0
    again = [server.query(q) for q in pool[:4]]
    assert query.idf.launches == 0          # hits launch nothing
    for r, t in zip(again, tickets):
        assert r.cached and r.epoch == t.response.epoch
        np.testing.assert_array_equal(r.scores.view(np.int32),
                                      t.response.scores.view(np.int32))


def test_threaded_server_with_maintenance_on_card(gpu):
    """The worker thread serves while an ingest thread adds docs under
    the lock and an ``IndexMaintenance`` thread seals and compacts:
    every wait is bounded, and every response is held only to the view
    recorded for its epoch.  Nothing is asserted on timing."""
    import threading

    from repro_torch.serve import IndexMaintenance, ServerConfig
    tc = corpus.generate(corpus.CorpusSpec(num_docs=1500, vocab=800,
                                           avg_distinct=20, seed=7))
    si = live_index.SegmentedIndex(
        term_hashes=tc.term_hashes, delta_doc_capacity=96,
        delta_posting_capacity=96 * 40, seal_layout="packed", device=gpu)
    si.add_batch(build.TokenizedCorpus(tc.doc_term_ids[:600],
                                       tc.doc_counts[:600], tc.term_hashes,
                                       600))
    server = _recording_server(si, ServerConfig(batch_size=8, k=10))
    maint = IndexMaintenance(si, server.index_lock, seal_fill=0.5,
                             interval_s=0.001)
    pool = corpus.sample_query_terms(np.asarray(si._df), si.term_hashes, 12,
                                     3, num_docs=si.live_doc_count, seed=2)
    server.warmup()

    def ingest():
        for a in range(600, 1500, 100):
            with server.index_lock:
                si.add_batch(build.TokenizedCorpus(
                    tc.doc_term_ids[a:a + 100], tc.doc_counts[a:a + 100],
                    tc.term_hashes, 100))
                if a % 300 == 0:
                    si.delete([a - 7, a - 50])

    rng = np.random.default_rng(3)
    server.start()
    maint.start()
    writer = threading.Thread(target=ingest, daemon=True)
    writer.start()
    tickets = []
    for _ in range(8):
        wave = [server.submit(pool[rng.integers(len(pool))])
                for _ in range(12)]
        for t in wave:
            t.result(timeout=120.0)
        tickets += wave
    writer.join(timeout=300.0)
    assert not writer.is_alive()
    maint.stop()
    server.stop()
    by_epoch = _held_to_views(server, tickets, 10)
    assert sum(len(g) for g in by_epoch.values()) == len(tickets)
    assert maint.stats.seals >= 1


def test_snapshot_saved_on_card_restores_on_cpu(gpu, tmp_path):
    """A snapshot of an index on the card loads on the CPU (and back on
    the card) with the same answers: ids and score bits in both modes,
    and the oracle's ids."""
    from repro_torch.serve import load_segmented, save_segmented
    tc = corpus.generate(corpus.CorpusSpec(num_docs=4900, vocab=3000,
                                           avg_distinct=30, seed=5))
    card = _live_schedule(tc, gpu)
    path = tmp_path / "live.npz"
    save_segmented(card, path)
    cpu = load_segmented(path, device="cpu")
    back = load_segmented(path, device=gpu)
    assert cpu.device.type == "cpu" and back.device.type == "cuda"
    assert cpu.layout_mix() == card.layout_mix() == back.layout_mix()
    qh = corpus.sample_query_terms(np.asarray(card._df), card.term_hashes, 8,
                                   8, num_docs=card.live_doc_count, seed=6)
    for kw in (dict(mode="candidates"), dict(mode="dense")):
        want = card.topk(qh, k=10, **kw)
        for other in (cpu, back):
            got = other.topk(qh, k=10, **kw)
            assert torch.equal(got.doc_ids.cpu(), want.doc_ids.cpu())
            assert torch.equal(got.scores.cpu().view(torch.int32),
                               want.scores.cpu().view(torch.int32))
    assert torch.equal(cpu.topk(qh, k=10, engine="torch").doc_ids,
                       card.topk(qh, k=10, engine="torch").doc_ids.cpu())


# ---------------------------------------------------------------------------
# distributed retrieval: a 4-shard mesh on the card against the same
# 4-shard mesh on the CPU (whose kernels run as their plain versions)
# ---------------------------------------------------------------------------

DIST_SHARDS = 4
DIST_ENGINES = {          # name: (builder, scorer maker, scorer kwargs)
    "doc": ("build_doc_sharded", "make_doc_sharded_scorer", {}),
    "term": ("build_term_sharded", "make_term_sharded_scorer", {}),
    "doc_hor": ("build_doc_sharded_blocked", "make_doc_sharded_fused_scorer",
                {}),
    "doc_packed": ("build_doc_sharded_packed",
                   "make_doc_sharded_fused_scorer", {}),
    "term_hor": ("build_term_sharded_blocked",
                 "make_term_sharded_fused_scorer", {}),
    "term_packed": ("build_term_sharded_packed",
                    "make_term_sharded_fused_scorer", {}),
    "term_banded": ("build_term_sharded_banded",
                    "make_term_sharded_fused_scorer", {}),
    "term_banded_cap": ("build_term_sharded_banded",
                        "make_term_sharded_fused_scorer",
                        {"cap": 100, "return_stats": True}),
}


def _meshes(gpu):
    from repro_torch.distributed import shmap
    return (shmap.make_mesh(DIST_SHARDS, "s", device=gpu),
            shmap.make_mesh(DIST_SHARDS, "s", device="cpu"))


def _same_rows(card, cpu, rows):
    """The two scorers answer every row alike: ids and score bits (and
    the truncation stats of a ``return_stats`` scorer)."""
    for row in rows:
        a, b = card(row), cpu(row)
        if isinstance(a[1], dict):
            assert a[1] == b[1]
            a, b = a[0], b[0]
        assert a[0].is_cuda and not b[0].is_cuda
        assert torch.equal(a[1].cpu(), b[1])
        assert torch.equal(a[0].cpu().view(torch.int32),
                           b[0].view(torch.int32))


def _fused_launches():
    return {n: (getattr(fds, n).launches, getattr(fds, n).launches_bitonic
                if n.startswith("fused_topk") else 0)
            for n in ("fused_topk_blocked", "fused_topk_packed",
                      "fused_score_blocked", "fused_score_packed")}


@pytest.mark.parametrize("name", list(DIST_ENGINES))
def test_sharded_engine_on_card_equals_cpu(gpu, host, name):
    """Each bulk sharded engine on a 4-shard mesh on the card equals the
    same engine on a 4-shard CPU mesh, ids and score bits, and a fused
    engine launches its kernel once per shard per query."""
    from repro_torch.distributed import retrieval
    builder, maker, kw = DIST_ENGINES[name]
    index = getattr(retrieval, builder)(host, DIST_SHARDS)
    card_mesh, cpu_mesh = _meshes(gpu)
    card = getattr(retrieval, maker)(index, card_mesh, "s", k=10, **kw)
    cpu = getattr(retrieval, maker)(index, cpu_mesh, "s", k=10, **kw)
    rows = [*corpus.sample_query_terms(host.df, host.term_hashes, 6, 3,
                                       num_docs=host.num_docs, seed=8),
            *corpus.sample_query_terms(host.df, host.term_hashes, 4, 8,
                                       num_docs=host.num_docs, seed=9)]
    before = _fused_launches()
    _same_rows(card, cpu, rows)
    grew = {n: after[0] - before[n][0]
            for n, after in _fused_launches().items()
            if after[0] != before[n][0]}
    kernels = {"doc_hor": ["fused_topk_blocked"],
               "doc_packed": ["fused_topk_packed"],
               "term_hor": ["fused_score_blocked"],
               "term_packed": ["fused_score_packed"]}.get(
                   name, ["fused_score_blocked", "fused_score_packed"]
                   if name.startswith("term_banded") else [])
    assert grew == {n: DIST_SHARDS * len(rows) for n in kernels}


@pytest.mark.parametrize("reducer", ["successive", "bitonic"])
def test_stack_scorer_on_card_equals_cpu(gpu, reducer):
    """The doc-sharded segment stack over mixed banded, HOR and packed
    seals (4 shards, inert slots included) on the card equals the same
    stack on the CPU, ids and score bits; every slot of every shard
    launches its kernels, through the bitonic epilogue where the table
    says so."""
    from repro_torch.distributed import retrieval
    from repro_torch.kernels import autotune
    tc = corpus.generate(corpus.CorpusSpec(num_docs=4900, vocab=3000,
                                           avg_distinct=30, seed=5))
    stacks = []
    for dev in (gpu, "cpu"):
        si = _live_schedule(tc, dev)
        si.seal()
        stacks.append(retrieval.stack_segment_shards(si.view(), DIST_SHARDS))
    metas = stacks[0].signature()
    assert metas == stacks[1].signature()
    assert {m.layout for m in metas} == {"banded", "hor", "packed"}
    table = autotune.TuningTable()
    if reducer == "bitonic":
        for m in metas:
            for dt in ("cuda", "cpu"):
                table.put(dt, autotune.size_class_of(m.d_pad), m.layout,
                          autotune.TuneConfig(reducer="bitonic"))
    prev = autotune.set_active(table)
    try:
        card_mesh, cpu_mesh = _meshes(gpu)
        card = retrieval.make_doc_sharded_segment_scorer(stacks[0],
                                                         card_mesh, "s")
        cpu = retrieval.make_doc_sharded_segment_scorer(stacks[1], cpu_mesh,
                                                        "s")
        rows = corpus.sample_query_terms(np.asarray(si._df), si.term_hashes,
                                         8, 8, num_docs=si.live_doc_count,
                                         seed=4)
        before = _fused_launches()
        _same_rows(card, cpu, rows)
        after = _fused_launches()
    finally:
        autotune.set_active(prev)
    slots = {lay: DIST_SHARDS * sum(m.n_slots for m in metas
                                    if m.layout == lay)
             for lay in ("banded", "hor", "packed")}
    col = 1 if reducer == "bitonic" else 0
    n = len(rows)
    assert after["fused_topk_blocked"][col] - \
        before["fused_topk_blocked"][col] == n * slots["hor"]
    assert after["fused_topk_packed"][col] - \
        before["fused_topk_packed"][col] == n * slots["packed"]
    for dense in ("fused_score_blocked", "fused_score_packed"):
        assert after[dense][0] - before[dense][0] == n * slots["banded"]


@pytest.mark.parametrize("topology", ["doc_stack", "term_fused"])
def test_mesh_server_on_card_equals_cpu(gpu, topology):
    """``MeshServer`` (4 shards, 2 replicas) on the card and on the CPU
    through one schedule of queries, a write step and a handoff: equal
    responses (ids, score bits, epochs, cache flags), replicas in step."""
    from repro_torch.serve import MeshConfig, MeshServer
    tc = corpus.generate(corpus.CorpusSpec(num_docs=4900, vocab=3000,
                                           avg_distinct=30, seed=5))
    answers = []
    for dev in (gpu, "cpu"):
        si = _live_schedule(tc, dev)
        ms = MeshServer(si, MeshConfig(
            batch_size=8, n_terms_budget=8, k=10, n_shards=DIST_SHARDS,
            n_replicas=2, topology=topology, auto_handoff=False))
        assert ms.mesh.devices[0].type == torch.device(dev).type
        pool = corpus.sample_query_terms(np.asarray(si._df), si.term_hashes,
                                         12, 3, num_docs=si.live_doc_count,
                                         seed=2)
        got = []
        for step in range(2):
            if step:
                ms.add_batch(build.TokenizedCorpus(
                    tc.doc_term_ids[:200], tc.doc_counts[:200],
                    tc.term_hashes, 200))
                ms.delete_docs(np.arange(5, 400, 9))
                ms.handoff()
            tickets = [ms.submit(q) for q in [*pool, *pool[:4]]]
            while ms.pending:
                ms.pump()
            got += [t.result(timeout=60.0) for t in tickets]
        assert len({r.digest() for r in ms.replicas}) == 1
        answers.append(got)
    for a, b in zip(*answers):
        assert (a.epoch, a.cached, a.status) == (b.epoch, b.cached, b.status)
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        np.testing.assert_array_equal(a.scores.view(np.int32),
                                      b.scores.view(np.int32))


# ---------------------------------------------------------------------------
# the language-model serving path (models.transformer) on the card
# ---------------------------------------------------------------------------

LM_ARCHS = ("qwen3-0.6b", "gemma3-4b", "minicpm3-4b", "mixtral-8x7b",
            "mixtral-8x22b")


def _lm_smoke(arch_id, gpu, dtype=None):
    """The arch's smoke config (compute dtype ``dtype`` if given), its
    weights made on the CPU from a seed and the same weights on the
    card, and 2 x 16 tokens on both."""
    from repro_torch import configs
    from repro_torch.models import transformer as ttfm
    cfg = configs.get_arch(arch_id).make_config("smoke")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    cpu = ttfm.init_params(1, cfg, device="cpu")
    card = ttfm.tree_map(lambda t: t.to(gpu), cpu)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    return ttfm, cfg, cpu, card, toks


def _rel(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_smoke_on_card_equals_cpu(gpu, arch_id):
    """Each smoke arch on the card (GQA prefill through the flash kernel,
    decode plain) against the port on the CPU with the same weights:
    prefill logits and cache, then one decode step from each side's own
    padded cache.  bf16 within 2e-2 of the max; the two MoE archs in f32
    within 1e-3 (the kernel's 3xTF32 path): at bf16 a token whose router
    logits lie one bf16 ulp apart (mixtral-8x7b's smoke weights hold
    one) may take another expert on each device once the attention
    before it (the kernel's f32 p, the plain path's bf16 p) moves its
    input, and its later K/V differ wholly
    (``test_lm_moe_bf16_routes_as_cpu`` holds the bf16 dispatch)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    moe = arch_id.startswith("mixtral")
    ttfm, cfg, cpu, card, toks = _lm_smoke(
        arch_id, gpu, torch.float32 if moe else None)
    tol = 1e-3 if moe else 2e-2
    got = ttfm.prefill(card, cfg, toks[:, :15].to(gpu))
    want = ttfm.prefill(cpu, cfg, toks[:, :15])
    assert _rel(got.logits, want.logits) < tol, arch_id
    for g, w in zip(got.cache, want.cache):
        assert g.dtype == w.dtype == cfg.dtype
        assert _rel(g, w) < tol, arch_id
    logits, _, n = ttfm.decode_step(
        card, cfg, ttfm.pad_cache(got.cache, 16, cfg), toks[:, 15:].to(gpu),
        got.cache_len)
    wl, _, _ = ttfm.decode_step(cpu, cfg, ttfm.pad_cache(want.cache, 16, cfg),
                                toks[:, 15:], want.cache_len)
    assert _rel(logits, wl) < tol, arch_id
    assert n.tolist() == [16, 16] and torch.isfinite(logits).all()


def _route(ttfm, cfg, prm, x):
    """(top-k experts [N, k] in order, the least gap between neighbours
    among the k + 1 largest router logits, in bf16 ulps of the larger
    of the two [N]) of tokens x [N, d], as ``_moe_ffn`` routes them."""
    k = cfg.moe.top_k
    logits = ttfm.router_logits(prm, x, cfg.moe, cfg.dtype)
    _, experts = ttfm.top_k_stable(torch.softmax(logits, dim=-1), k)
    top = logits.sort(dim=-1, descending=True).values[..., :k + 1]
    ulp = torch.exp2(torch.floor(torch.log2(
        top[..., :-1].abs().clamp_min(2.0 ** -126))) - 7)
    gaps = (top[..., :-1] - top[..., 1:]) / ulp
    return (experts.reshape(x.shape[0], k).cpu(),
            gaps.amin(-1).reshape(-1).cpu())


@pytest.mark.parametrize("arch_id", ("mixtral-8x7b", "mixtral-8x22b"))
def test_lm_moe_bf16_routes_as_cpu(gpu, arch_id, monkeypatch):
    """The bf16 MoE dispatch on the card against the CPU's on the same
    inputs: every MoE call of a card prefill (smoke config, its own
    capacity) runs again on the CPU on the card's tokens.  Each token
    whose k + 1 largest router logits lie more than one bf16 ulp apart
    on both devices takes the same experts, in the same order, on both;
    the outputs agree within 2e-2 of the max on every token that routes
    to no expert a changed token moved to or from (its slot ranks, so
    its drops, are the same); the near-tie tokens are printed.  Where
    the two devices' own prefills route every token alike, their logits
    and caches agree within 2e-2 too."""
    ttfm, cfg, cpu, card, toks = _lm_smoke(arch_id, gpu)
    assert cfg.dtype == torch.bfloat16
    real, calls = ttfm._moe_ffn, []

    def recording(prm, x, moe, dtype, dropless=False):
        out = real(prm, x, moe, dtype, dropless=dropless)
        calls.append((prm, x, out))
        return out

    monkeypatch.setattr(ttfm, "_moe_ffn", recording)
    got = ttfm.prefill(card, cfg, toks[:, :15].to(gpu))
    want = ttfm.prefill(cpu, cfg, toks[:, :15])
    n_layers = cfg.n_layers
    assert len(calls) == 2 * n_layers
    near, alike, compared, tokens = [], True, 0, 0
    for layer, ((prm, x, out), (prm_c, x_c, _)) in enumerate(
            zip(calls[:n_layers], calls[n_layers:])):
        e_card, m_card = _route(ttfm, cfg, prm, x)
        e_cpu, m_cpu = _route(ttfm, cfg, prm_c, x.cpu())
        margin = torch.minimum(m_card, m_cpu)
        moved = e_card != e_cpu                               # [N, k]
        changed = moved.any(-1)
        assert not (changed & (margin > 1)).any(), (
            arch_id, layer, torch.nonzero(changed).flatten().tolist(),
            margin[changed].tolist())
        near += [(layer, t, float(margin[t]), bool(changed[t]))
                 for t in torch.nonzero(margin <= 1).flatten().tolist()]
        g = ttfm._moe_groups(x.shape[0], cfg.moe)
        clean = ~changed
        for grp, rows in enumerate(torch.arange(x.shape[0]).reshape(g, -1)):
            hit = torch.cat([e_card[rows][moved[rows]],
                             e_cpu[rows][moved[rows]]])
            clean[rows] &= ~torch.isin(e_card[rows], hit).any(-1)
        ref = real(prm_c, x.cpu(), cfg.moe, cfg.dtype)
        if clean.any():
            assert _rel(out.cpu()[clean], ref[clean]) < 2e-2, (arch_id, layer)
        compared += int(clean.sum())
        tokens += x.shape[0]
        alike &= bool((_route(ttfm, cfg, prm_c, x_c)[0] == e_card).all())
    print(f"{arch_id} bf16 MoE: {compared} of {tokens} token "
          f"outputs compared; near-tie tokens (layer, token, least gap "
          f"in ulps, changed experts): {near}; own prefills route alike: "
          f"{alike}")
    assert compared > 0
    if alike:
        assert _rel(got.logits, want.logits) < 2e-2, arch_id
        for g_, w_ in zip(got.cache, want.cache):
            assert _rel(g_, w_) < 2e-2, arch_id


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_prefill_launches_per_gqa_layer(gpu, arch_id):
    """A prefill launches the flash kernel once per GQA layer (counted
    by the wrapper and seen by the profiler), MLA's prefill never; a
    decode step launches it never."""
    ttfm, cfg, _, card, toks = _lm_smoke(arch_id, gpu)
    toks = toks.to(gpu)
    pre = ttfm.prefill(card, cfg, toks[:, :15])       # built and loaded
    cache = ttfm.pad_cache(pre.cache, 16, cfg)
    want = cfg.n_layers if cfg.attn == "gqa" else 0   # 2, 6, 0, 2, 3
    before = tfa.flash_attention.launches
    names = _device_kernels([(ttfm.prefill, (card, cfg, toks[:, :15]), {})])
    assert tfa.flash_attention.launches - before == want
    assert sum("flash_" in n for n in names) == want, names
    before = tfa.flash_attention.launches
    names = _device_kernels([(ttfm.decode_step, (card, cfg, cache,
                                                 toks[:, 15:],
                                                 pre.cache_len), {})])
    assert tfa.flash_attention.launches == before
    assert not any("flash_" in n for n in names), names


def test_mla_prefill_on_card_launches_nothing(gpu):
    """MLA's prefill attention (Dk = nope + rope != Dv) takes the plain
    chunked path on CUDA tensors: no flash launch, the plain path's
    answer."""
    from repro_torch.models import attention as tattn
    g = torch.Generator(device=gpu).manual_seed(0)
    q = torch.randn(2, 4, 48, 24, generator=g, device=gpu)
    k = torch.randn(2, 4, 48, 24, generator=g, device=gpu)
    v = torch.randn(2, 4, 48, 16, generator=g, device=gpu)
    before = tfa.flash_attention.launches
    got = tattn.chunked_attention(q, k, v, chunk=16)
    assert tfa.flash_attention.launches == before
    want = tattn.chunked_attention(q.cpu(), k.cpu(), v.cpu(), chunk=16)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 24])
def test_splitk_decode_on_card(gpu, window):
    """Split-K decode over a 4-shard mesh on the card equals the
    single-device decode attention, within the reference's rtol 2e-4,
    atol 1e-5."""
    from repro_torch.distributed import decode_attn, shmap
    from repro_torch.models import attention as tattn
    g = torch.Generator(device=gpu).manual_seed(window)
    q = torch.randn(3, 8, 1, 64, generator=g, device=gpu)
    kc = torch.randn(3, 2, 256, 64, generator=g, device=gpu)
    vc = torch.randn(3, 2, 256, 64, generator=g, device=gpu)
    cl = torch.tensor([200, 63, 255], dtype=torch.int32, device=gpu)
    fn = decode_attn.splitk_decode_attention(
        shmap.make_mesh(4, device="cuda"), "shards")
    got = fn(q, kc, vc, cl, window=window)
    want = tattn.decode_attention(q, kc, vc, cl, window=window)
    assert got.device == q.device
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)


REC_CASES = [("sasrec", 1), ("bert4rec", 1), ("dien", 1), ("xdeepfm", 1),
             ("xdeepfm", 3)]


def _launch_counts():
    return tbag.embedding_bag.launches, tpna.pna_multi_agg.launches


def _same_ids_near_ties(got, want, near_tie=1e-5):
    """Top-k ids equal but at adjacent scores within ``near_tie``
    relative (the two devices round the user vectors apart); scores
    within rtol 1e-5."""
    gv, gi = (x.cpu().reshape(-1, x.shape[-1]).numpy() for x in got)
    wv, wi = (x.reshape(-1, x.shape[-1]).numpy() for x in want)
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=0)
    for q, j in zip(*np.nonzero(gi != wi)):
        s = wv[q]
        assert any(abs(s[j] - s[i]) <= near_tie * abs(s[j])
                   for i in (j - 1, j + 1) if 0 <= i < len(s)), (q, j)


@pytest.mark.parametrize("arch_id,n_hot", REC_CASES)
def test_recsys_smoke_on_card_equals_cpu(gpu, arch_id, n_hot):
    """Each recsys arch at its smoke config, the same weights on the card
    and on the CPU: the serve step at serve_p99 and the retrieval step at
    retrieval_cand.  Logits within rel-to-max 1e-4, top-k ids equal but
    at near ties; xDeepFM launches the bag kernel once a user chunk, the
    others no kernel."""
    from repro_torch import configs
    from repro_torch.configs import base as cbase
    from repro_torch.models import transformer as ttfm
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = configs.get_arch(arch_id)
    cfg = dataclasses.replace(arch.make_config("smoke"), n_hot=n_hot) \
        if arch_id == "xdeepfm" else arch.make_config("smoke")
    cpu = cbase._REC_INIT[arch_id](1, cfg, device="cpu")
    card = ttfm.tree_map(lambda t: t.to(gpu), cpu)
    rng = np.random.default_rng(2)
    for shape_id in ("serve_p99", "retrieval_cand"):
        shp = arch.smoke_shapes[shape_id]
        if shape_id == "serve_p99":
            layout = cbase.rec_serve_inputs(arch_id, cfg, shp)
            fn = cbase.recsys_serve_fn(arch_id, cfg, shp)
            extra = ()
        else:
            layout = cbase._rec_serve_inputs(arch_id, cfg, shp["batch"])
            fn = cbase.recsys_retrieval_fn(arch_id, cfg, shp)
            d = cfg.embed_dim
            extra = (torch.from_numpy(rng.normal(size=(
                512, d)).astype(np.float32)),)
        hi = cfg.field_vocab if arch_id == "xdeepfm" else cfg.n_items
        inp = {k: torch.from_numpy(rng.integers(0, hi, s).astype(np.int32))
               for k, (s, _) in layout.items()}
        before = _launch_counts()
        got = fn(card, {k: v.to(gpu) for k, v in inp.items()},
                 *(x.to(gpu) for x in extra))
        torch.cuda.synchronize()
        bag = int(arch_id == "xdeepfm")
        assert _launch_counts() == (before[0] + bag, before[1]), arch_id
        want = fn(cpu, inp, *extra)
        if isinstance(want, tuple):
            _same_ids_near_ties(got, want)
        else:
            assert _rel(got, want) < 1e-4, (arch_id, shape_id)
            assert torch.isfinite(got).all()


PNA_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def _pna_batch(shape_id):
    from repro_torch import configs
    from repro_torch.train import data
    arch = configs.get_arch("pna")
    shp = arch.smoke_shapes[shape_id]
    cfg = arch.make_config("smoke", shape_id)
    if shp.get("graph_level"):
        b = data.molecule_batch(0, 0, shp["n_graphs"],
                                shp["n_nodes"] // shp["n_graphs"],
                                shp["n_edges"] // shp["n_graphs"],
                                cfg.d_feat, cfg.n_classes)
    elif "full_graph" in shp:
        fg = shp["full_graph"]
        g = data.make_synthetic_graph(fg["n_nodes"], fg["n_edges"],
                                      cfg.d_feat, cfg.n_classes, 0)
        b = data.NeighborSampler(g, fg["batch_nodes"], fg["fanout"]).sample(0)
    else:
        g = data.make_synthetic_graph(shp["n_nodes"], shp["n_edges"],
                                      cfg.d_feat, cfg.n_classes, 0)
        b = data.fullgraph_batch(g, seed=0)
    return cfg, {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.mark.parametrize("shape_id", PNA_SHAPES)
def test_pna_smoke_on_card_equals_cpu(gpu, shape_id):
    """PNA at each smoke shape, the same weights and graph on both sides:
    node logits (the molecule's graph loss) within rel-to-max 1e-4, one
    PNA launch a layer and no bag launch."""
    from repro_torch.models import gnn
    from repro_torch.models import transformer as ttfm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, batch = _pna_batch(shape_id)
    cpu = gnn.init_params(1, cfg, device="cpu")
    card = ttfm.tree_map(lambda t: t.to(gpu), cpu)
    cb = {k: v.to(gpu) for k, v in batch.items()}
    n = batch["feats"].shape[0]
    before = _launch_counts()
    if shape_id == "molecule":
        got = gnn.graph_loss(card, cfg, cb)
        want = gnn.graph_loss(cpu, cfg, batch)
    else:
        got = gnn.node_logits(card, cfg, cb["feats"], cb["src"], cb["dst"], n)
        want = gnn.node_logits(cpu, cfg, batch["feats"], batch["src"],
                               batch["dst"], n)
    torch.cuda.synchronize()
    assert _launch_counts() == (before[0], before[1] + cfg.n_layers)
    assert _rel(got, want) < 1e-4 and torch.isfinite(got).all()


@pytest.mark.parametrize("eps", [1e-5, 0.25, 3e-7])
def test_pna_eps_reaches_kernel(gpu, eps):
    """``eps`` reaches the kernel as a C float: the kernel equals its
    plain version at each eps to the bit, and the default's bits are the
    former constant's (an isolated node's std is sqrt(1e-5f))."""
    feats, nbr = _pna_case(gpu, "scattered")
    nbr[0] = -1
    got = tpna.pna_multi_agg(feats, nbr, eps=eps)
    want = tpna.pna_multi_agg_plain(feats, nbr, eps=eps)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    d = feats.shape[1]
    iso = np.sqrt(np.float32(eps), dtype=np.float32)
    assert (got[0, 3 * d:].cpu().numpy() == iso).all()
    if eps == 1e-5:
        default = tpna.pna_multi_agg(feats, nbr)
        assert torch.equal(default.view(torch.int32), got.view(torch.int32))
        assert np.float32(tpna.EPS) == np.float32(1e-5)


def test_bag_mean_on_card_equals_plain(gpu):
    """``mode="mean"`` on the card: the kernel's sum over max(valid
    slots, 1), equal to the plain version's to the bit; one launch."""
    g = torch.Generator(device=gpu).manual_seed(3)
    table = torch.randn(500, 10, generator=g, device=gpu)
    idx = torch.randint(-1, 500, (64, 5), generator=g, device=gpu,
                        dtype=torch.int32)
    idx[3] = -1
    before = tbag.embedding_bag.launches
    got = ops.embedding_bag(table, idx, mode="mean")
    assert tbag.embedding_bag.launches == before + 1
    want = tbag.embedding_bag_plain(table, idx, "mean")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# training: the backward rules, fixed-order sums, a small train on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["attention_f32", "attention_bf16", "bag",
                                   "bag_mean", "pna"])
def test_backward_rules_on_card(gpu, which):
    """Each ``ops`` Function on the card: the forward launches its kernel
    once, and the backward rule (torch ops) equals autograd of the plain
    version on the card (attention: the reference's chunked arithmetic,
    f32 within 1e-4 and bf16 within 2e-2 rel-to-max, as the kernel's
    forward rounds otherwise; bag: 1e-6, autograd adds a row's slots in
    another order; PNA: 1e-4, against ``pna_multi_agg_autograd`` over the
    whole graph at once) and the same rule run on the CPU (1e-5)."""
    from repro_torch.models.attention import chunked_attention_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=gpu).manual_seed(5)
    if which.startswith("attention"):
        dt = torch.bfloat16 if which.endswith("bf16") else torch.float32
        args = [torch.randn(2, h, 256, 64, generator=g, device=gpu).to(dt)
                for h in (8, 4, 4)]
        counter = tfa.flash_attention
        tol = 2e-2 if dt == torch.bfloat16 else 1e-4

        def call(*x):
            return ops.attention(*x, causal=True, window=100)

        def plain(*x):
            return chunked_attention_plain(*x, causal=True, window=100,
                                           chunk=64)
    elif which.startswith("bag"):
        mode = "mean" if which == "bag_mean" else "sum"
        idx = torch.randint(-1, 300, (512, 6), generator=g, device=gpu,
                            dtype=torch.int32)
        args = [torch.randn(300, 16, generator=g, device=gpu)]
        counter, tol = tbag.embedding_bag, 1e-6

        def call(t):
            return ops.embedding_bag(t, idx.to(t.device), mode)

        def plain(t):
            return tbag.embedding_bag_plain(t, idx, mode)
    else:
        feats, nbr = _pna_case(gpu, "scattered")
        args = [torch.relu(feats)]                 # relu ties at zero
        counter, tol = tpna.pna_multi_agg, 1e-4

        def call(f):
            return ops.pna_multi_agg(f, nbr.to(f.device))

        def plain(f):
            return tpna.pna_multi_agg_autograd(f, nbr)
    grads, cot = [], None
    for fn, device in ((call, gpu), (plain, gpu), (call, "cpu")):
        xs = [a.detach().to(device).requires_grad_() for a in args]
        before = counter.launches
        out = fn(*xs)
        assert counter.launches == before + (fn is call and device == gpu)
        if cot is None:
            cot = torch.randn(out.shape, generator=g, device=gpu).to(
                out.dtype)
        out.backward(cot.to(device))
        grads.append([x.grad for x in xs])
    for got, want_plain, want_cpu in zip(*grads):
        assert torch.isfinite(got).all()
        assert _rel(got, want_plain) <= tol
        assert _rel(got, want_cpu) <= max(tol, 1e-5)


def test_raw_launchers_refuse_grad_on_card(gpu):
    """A CUDA input that requires grad never reaches a raw launch (its
    gradient would be lost); ``ops`` takes it through its Function."""
    q = torch.randn(1, 2, 64, 64, device=gpu, requires_grad=True)
    for call in (lambda: tfa.flash_attention(q, q, q),
                 lambda: tbag.embedding_bag(
                     q[0, 0], torch.zeros(3, 2, dtype=torch.int32,
                                          device=gpu)),
                 lambda: tpna.pna_multi_agg(
                     q[0, 0], torch.zeros(3, 2, dtype=torch.int32,
                                          device=gpu))):
        with pytest.raises(ValueError, match="requires grad"):
            call()
    ops.attention(q, q, q).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_segment_sum_repeats_on_card(gpu):
    """``segment_sum`` on the card adds in a fixed order: the same bits
    run after run (atomics once made them vary), 1-D and 2-D, unsorted
    ids with out-of-range ones; within 1e-5 of the CPU's entry order."""
    from repro_torch.core import segments
    g = torch.Generator(device=gpu).manual_seed(8)
    ids = torch.randint(-2, 1003, (200_000,), generator=g, device=gpu,
                        dtype=torch.int32)
    for shape in ((200_000,), (200_000, 17)):
        x = torch.randn(shape, generator=g, device=gpu) * 1e3
        runs = [segments.segment_sum(x, ids, 1000) for _ in range(3)]
        for r in runs[1:]:
            assert torch.equal(r.view(torch.int32), runs[0].view(torch.int32))
        want = segments.segment_sum(x.cpu(), ids.cpu(), 1000)
        assert _rel(runs[0], want) < 1e-5
        std = [segments.segment_std(x, ids, 1000) for _ in range(2)]
        assert torch.equal(std[0].view(torch.int32), std[1].view(torch.int32))


def test_pna_kernel_nan_rows(gpu):
    """NaN rows through ``csrc/pna_multi_agg.cu``: the kernel equals the
    plain version (mean and std NaN, min and max 0 where a NaN row is a
    neighbour), NaN for NaN and bit for bit elsewhere."""
    feats, nbr = _pna_case(gpu, "scattered")
    feats[torch.arange(0, feats.shape[0], 7, device=gpu)] = float("nan")
    feats[3, 5] = -float("nan")
    got = tpna.pna_multi_agg(feats, nbr)
    want = tpna.pna_multi_agg_plain(feats, nbr)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok].view(torch.int32), want[ok].view(torch.int32))
    d = feats.shape[1]
    hit = (nbr >= 0) & (nbr % 7 == 0)
    rows = hit.any(1)
    assert rows.any() and torch.isnan(got[rows, :d]).all()
    assert (got[rows, d:3 * d] == 0).all()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_small_transformer_trains_on_card_as_on_cpu(gpu, dt):
    """Two train steps of a small transformer (qwen3's smoke shape) on the
    card and on the CPU from the same weights and batches: the card's
    attention is the flash kernel (launched twice a layer a step: the
    forward, and its recomputation under ``remat``), its backward the
    rule in torch ops.  Loss and every gradient leaf of the first step
    within 1e-4 (f32) / 3e-2 (bf16, the kernel's own bf16 bound: a bf16
    product's rounding differs between the devices) rel-to-max; the
    second step's loss too."""
    from repro_torch import configs
    from repro_torch.models import transformer as ttfm
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as topt
    from repro_torch.core import tree
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_arch("qwen3-0.6b").make_config("smoke")
    cfg = dataclasses.replace(cfg, dtype=torch.float32 if dt == "f32"
                              else torch.bfloat16)
    tol = 1e-4 if dt == "f32" else 3e-2
    cpu = ttfm.init_params(0, cfg, device="cpu")
    loss = lambda p, b: ttfm.loss_fn(p, cfg, b)                # noqa: E731
    step = topt.make_train_step(loss, topt.AdamWConfig(lr=1e-2))
    states = {}
    for dev in (gpu, "cpu"):
        p = ttfm.tree_map(lambda t: t.to(dev), cpu)
        s = topt.init(p)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                    tdata.lm_batch(0, i, 2, 32, cfg.vocab).items()}
                   for i in range(2)]
        before = tfa.flash_attention.launches
        l0, g0 = topt.value_and_grad(loss, p, batches[0])
        launched = tfa.flash_attention.launches - before
        out = []
        for b in batches:
            p, s, m = step(p, s, b)
            out.append(float(m["loss"]))
        states[str(dev)] = (l0, g0, out, launched)
    (l0, g0, out, launched), (cl0, cg0, cout, _) = states.values()
    assert launched == 2 * cfg.n_layers
    assert abs(float(l0) - float(cl0)) <= tol * abs(float(cl0))
    for a, b in zip(tree.leaves(g0), tree.leaves(cg0)):
        assert torch.isfinite(a).all() and _rel(a, b) <= tol
    np.testing.assert_allclose(out, cout, rtol=tol)
