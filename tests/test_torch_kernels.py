"""Port vs reference at kernel level.

The plain PyTorch versions of the two candidate kernels are fed the
JAX engine's own routing pairs and must equal the Pallas kernels (run in
interpret mode, as the reference's own tests run them on the CPU) to the
bit, values and ids.  The port's pair builder must equal the
reference's, its decode must equal ``PackedCsrIndex.unpack_block``'s,
and its per-tile reducer must equal ``_tile_topk``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import build as rbuild, layouts as rlayouts  # noqa: E402
from repro.core import query as rquery  # noqa: E402
from repro.kernels import fused_decode_score as rfds, ops as rops  # noqa: E402
from repro.text import corpus as rcorpus  # noqa: E402
from repro_torch.core import layouts as tlayouts  # noqa: E402
from repro_torch.core.segments import run_ranks  # noqa: E402
from repro_torch.kernels import fused_decode_score as tfds  # noqa: E402

K = 10


@pytest.fixture(scope="module")
def host():
    return rbuild.bulk_build(rcorpus.generate(rcorpus.CorpusSpec(
        num_docs=600, vocab=500, avg_distinct=25, seed=7)))


def _t(x):
    """jax/numpy array -> torch tensor (u32 as int32 bit-views)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _bits(t):
    return t.view(torch.int32).numpy()


def _reference_pairs(ix, qh, cap, pps=1, max_pairs=None):
    """The JAX engine's routing arrays for one batch
    (``ops.fused_batched_topk`` up to the kernel call)."""
    qh = rquery.dedup_query_hashes(jnp.asarray(qh))
    tids = jnp.where(qh != 0, ix.lookup_terms(qh), -1)
    idf_t = rquery.idf(ix.term_df(tids), ix.docs.num_docs)
    b, t = tids.shape
    m = max(-(-min(cap, ix.max_posting_len) // ix.block), 1)
    if isinstance(ix, rlayouts.BlockedIndex):
        m = min(m, ix.max_blocks_per_term)
    cands = rops.expand_block_candidates(ix.block_offsets, tids, idf_t, m,
                                         ix.block, cap)
    tfirst, tcount, n_tiles = rops.routing_spans(ix, rfds.TILE)
    if max_pairs is None:
        max_pairs = rops.widen_pairs_for_step(
            rops.default_max_pairs(ix, b, t, cap), ix.docs.num_docs,
            rfds.TILE, pps)
    qnorm = jnp.sqrt(jnp.maximum(jnp.sum(idf_t * idf_t, axis=1), 1e-12))
    return cands, (tfirst, tcount, n_tiles, b, max_pairs), qnorm


def _kernel_inputs(ix, qh, cap, pps):
    cands, route, qnorm = _reference_pairs(ix, qh, cap, pps)
    cb, cv, cq, cw, cc = cands
    pb, pt, pqw, pcap, _ = rfds.build_batched_pairs(
        cb, cv, cq, cw.astype(jnp.float32), *route, cand_cap=cc,
        pairs_per_step=pps)
    b = qnorm.shape[0]
    bp = -(-b // 8) * 8
    pqw = jnp.pad(pqw, ((0, 0), (0, bp - b)))
    qnorm = jnp.pad(qnorm, (0, bp - b), constant_values=1.0)
    return pb, pt, pqw, pcap, qnorm


@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("case", ["plain", "deleted_blend_cap", "pps2"])
def test_plain_kernel_equals_pallas(host, layout, case):
    ix = (rlayouts.build_blocked(host) if layout == "hor"
          else rlayouts.build_packed_csr(host))
    nq, cap, rank_blend, pps = 8, host.max_posting_len, 0.0, 1
    if case == "deleted_blend_cap":
        norm = np.asarray(ix.docs.norm).copy()
        norm[::3] = 0.0
        ix = dataclasses.replace(ix, docs=rlayouts.DocTable(
            norm=jnp.asarray(norm), rank=ix.docs.rank))
        nq, cap, rank_blend = 5, 257, 0.5
    elif case == "pps2":
        pps = 2
    qh = rcorpus.sample_query_terms(host.df, host.term_hashes, nq, 3,
                                    num_docs=host.num_docs, seed=nq + pps)
    pb, pt, pqw, pcap, qnorm = _kernel_inputs(ix, qh, cap, pps)
    nd, kt = host.num_docs, rfds.default_k_tile(K)
    kw = dict(rank_blend=rank_blend, pairs_per_step=pps, interpret=True)
    if layout == "hor":
        want = rfds.fused_topk_blocked_pallas(
            ix.block_docs, ix.block_tfs, pb, pt, pqw, pcap, ix.docs.norm,
            ix.docs.rank, qnorm, nd, kt, **kw)
        got = tfds.fused_topk_blocked(
            _t(ix.block_docs), _t(ix.block_tfs), _t(pb), _t(pt), _t(pqw),
            _t(pcap), _t(ix.docs.norm), _t(ix.docs.rank), _t(qnorm), nd, kt,
            rank_blend=rank_blend)
    else:
        ext = (ix.block_bits[pb], ix.block_base[pb], ix.block_count[pb])
        want = rfds.fused_topk_packed_pallas(
            ix.packed, ix.block_tfs, pb, pt, pqw, pcap, *ext, ix.docs.norm,
            ix.docs.rank, qnorm, nd, ix.block, kt, **kw)
        got = tfds.fused_topk_packed(
            _t(ix.packed), _t(ix.block_tfs), _t(pb), _t(pt), _t(pqw),
            _t(pcap), *map(_t, ext), _t(ix.docs.norm), _t(ix.docs.rank),
            _t(qnorm), nd, ix.block, kt, rank_blend=rank_blend)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(_bits(got[0]),
                                  np.asarray(want[0]).view(np.int32))
    assert (got[1].numpy() >= 0).any()


@pytest.mark.parametrize("pps,budget", [(1, None), (2, None), (1, 8),
                                        (2, 8)])
def test_build_batched_pairs_matches(host, pps, budget):
    ix = rlayouts.build_packed_csr(host)
    qh = rcorpus.sample_query_terms(host.df, host.term_hashes, 6, 4,
                                    num_docs=host.num_docs, seed=1)
    qh[1, 2] = qh[0, 0]                   # a block shared across queries
    cands, route, _ = _reference_pairs(ix, qh, 300, pps, max_pairs=budget)
    cb, cv, cq, cw, cc = cands
    want = rfds.build_batched_pairs(cb, cv, cq, cw.astype(jnp.float32),
                                    *route, cand_cap=cc, pairs_per_step=pps)
    tfirst, tcount, n_tiles, b, max_pairs = route
    got = tfds.build_batched_pairs(
        _t(cb), _t(cv), _t(cq), _t(cw), _t(tfirst), _t(tcount), n_tiles, b,
        max_pairs, cand_cap=_t(cc), pairs_per_step=pps)
    for name, g, w in zip(("block", "tile", "qw", "cap", "overflow"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert (int(want[4]) > 0) == (budget is not None)


@pytest.mark.parametrize("block", [16, 128])
def test_decode_matches_reference(block):
    """Every bit width 0..32 over adversarial random words (all-ones high
    bytes in the last word catch any hi-word bleed) and wrapping bases."""
    rng = np.random.default_rng(block)
    nb, wpb = 33, (block * 32 + 31) // 32
    words = rng.integers(0, 2**32, size=(nb, wpb), dtype=np.uint32)
    words[:, -1] |= np.uint32(0xFF000000)
    bits = np.arange(nb, dtype=np.int32)
    base = rng.integers(-2**31, 2**31 - 1, size=nb).astype(np.int32)
    count = rng.integers(0, block + 1, size=nb).astype(np.int32)
    want = jax.vmap(lambda w, b, ba, c: rfds._unpack_block_vmem(
        w, b.astype(jnp.uint32), ba, c, block))(
            jnp.asarray(words), jnp.asarray(bits), jnp.asarray(base),
            jnp.asarray(count))
    got = tlayouts.unpack_words(_t(words), _t(bits), _t(base), _t(count),
                                block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unpack_block_matches_reference(host):
    ref = rlayouts.build_packed_csr(host)
    got = tlayouts.build_packed_csr(
        tlayouts.PostingsHost(**dataclasses.asdict(host)), device="cpu")
    b = np.arange(ref.packed.shape[0], dtype=np.int32)
    want = jax.vmap(ref.unpack_block)(jnp.asarray(b))
    have = got.unpack_block(torch.from_numpy(b))
    for w, h in zip(want, have):
        np.testing.assert_array_equal(h.numpy(), np.asarray(w))


def test_tile_reducers_match_reference():
    rng = np.random.default_rng(3)
    q, tile, k_tile = 8, 512, 16
    final = rng.integers(0, 6, size=(q, tile)).astype(np.float32) / 4
    final[final == 0] = -np.inf                   # misses, and heavy ties
    final[3] = -np.inf                            # an all-miss row
    want_v, want_i = rfds._tile_topk(jnp.asarray(final), 1024, k_tile, tile)
    got_v, got_i = tfds._tile_topk(
        torch.from_numpy(final), torch.full((q,), 1024, dtype=torch.int32),
        k_tile, tile)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    dense = np.concatenate([final, final[:, :300]], axis=1)
    want = rfds.extract_tile_candidates(jnp.asarray(dense), tile, k_tile)
    got = tfds.extract_tile_candidates(torch.from_numpy(dense), tile,
                                       k_tile)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0][:, :k_tile].numpy(),
                                  got_v.numpy())


def test_pair_and_tile_helpers_match_reference():
    rng = np.random.default_rng(9)
    n_tiles, tile, k_tile, q = 5, 64, 8, 3
    pt = np.sort(rng.integers(0, n_tiles + 1, size=40)).astype(np.int32)
    # the port's run ranks start a run exactly where the reference's
    # pair_first marks one, and end it where its pair_last does
    rnk = run_ranks(torch.from_numpy(pt)).numpy()
    first = np.asarray(rfds._pair_first(jnp.asarray(pt)))
    last = np.asarray(rfds._pair_last(jnp.asarray(pt)))
    np.testing.assert_array_equal((rnk == 0).astype(np.int32), first)
    np.testing.assert_array_equal(
        np.r_[rnk[1:] == 0, True].astype(np.int32), last)
    np.testing.assert_array_equal(
        rnk, np.arange(len(pt)) - np.maximum.accumulate(
            np.where(first == 1, np.arange(len(pt)), 0)))
    norm = rng.random(300).astype(np.float32)
    rank = rng.random(300).astype(np.float32)
    for g, w in zip(tfds._doc_tiles(_t(norm), _t(rank), n_tiles, tile),
                    rfds._doc_tiles(jnp.asarray(norm), jnp.asarray(rank),
                                    n_tiles, tile)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    vals = rng.random((n_tiles + 1, q, k_tile)).astype(np.float32)
    ids = rng.integers(0, 300, size=vals.shape).astype(np.int32)
    pt_sparse = np.array([0, 0, 3, 5, 5], np.int32)   # tiles 1, 2, 4 unvisited
    got = tfds._finish_candidates(_t(vals), _t(ids), _t(pt_sparse), n_tiles,
                                  k_tile)
    want = rfds._finish_candidates(jnp.asarray(vals), jnp.asarray(ids),
                                   jnp.asarray(pt_sparse), n_tiles, k_tile)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k in (1, 7, 8, 10, 100, 600):
        for tl in (256, 512):
            assert tfds.default_k_tile(k, tl) == rfds.default_k_tile(k, tl)
    with pytest.raises(ValueError):
        tfds._check_k_tile(600, 512)


def test_fma_f32_single_rounding():
    """``fma_f32`` is the reference's contracted ``c + a * b`` (XLA emits
    an FMA on the CPU), bit for bit, including a case where rounding the
    exact value first to f64 and then to f32 would round it the wrong
    way (2**30 + 2**6 + a hair: the true f32 neighbour is 2**30 + 2**7)."""
    from repro_torch.core.query import fma_f32
    rng = np.random.default_rng(1)
    a = (rng.random(20000) * 8).astype(np.float32)
    b = (rng.random(20000) * 3).astype(np.float32)
    c = (rng.random(20000) * 50).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: c + a * b)(a, b, c))
    got = fma_f32(_t(a), _t(b), _t(c)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ha = np.float32(1 + 2896 * 2.0**-23)
    hb = np.float32(2.0**6 * (1 - 2895 * 2.0**-23))
    hc = np.float32(2.0**30)
    hard = fma_f32(*(torch.tensor([v]) for v in (ha, hb, hc)))
    assert float(hard[0]) == 2.0**30 + 2.0**7
    assert np.float32(np.float64(ha) * np.float64(hb) + np.float64(hc)) \
        == np.float32(2.0**30)                    # the double-rounding trap


@pytest.mark.parametrize("slots", [1, 3, 4])
def test_query_norm_matches_xla(slots):
    """``query_norm`` is the reference's qnorm, bit for bit, for queries of
    up to 4 slots: XLA on the CPU chains the slot sum through FMAs in
    slot order and rounds the square root correctly; torch's own ``sum``
    and ``sqrt`` do neither."""
    from repro_torch.core.query import query_norm
    rng = np.random.default_rng(slots)
    w = (rng.random((50000, slots)) * 6).astype(np.float32)
    w[::7, 0] = 0.0                               # absent slots
    want = np.asarray(jax.jit(lambda a: jnp.sqrt(jnp.maximum(
        jnp.sum(a * a, axis=1), 1e-12)))(w))
    got = query_norm(_t(w)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
