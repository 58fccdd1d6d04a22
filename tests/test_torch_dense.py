"""Port vs reference for the dense engine: the plain versions of the two
dense kernels (``fused_score_{blocked,packed}_plain``) against the Pallas
kernels run in interpret mode, on the reference's own routing pairs, to
the bit; then the engines built on them (``fused_batched_scores``, the
per-segment dense and banded engines, the gather oracles) against the
reference's, on shared inputs.
"""
import dataclasses
import functools

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
from repro_torch.kernels import fused_decode_score as tfds  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

K = 10


@pytest.fixture(scope="module")
def host():
    return rbuild.bulk_build(rcorpus.generate(rcorpus.CorpusSpec(
        num_docs=1500, vocab=800, avg_distinct=25, seed=7)))


@pytest.fixture(scope="module")
def sparse_host():
    """A wide vocabulary over few docs: many terms of df 1."""
    return rbuild.bulk_build(rcorpus.generate(rcorpus.CorpusSpec(
        num_docs=2000, vocab=6000, avg_distinct=8, seed=3)))


def _t(x):
    """jax/numpy array -> torch tensor (u32 as int32 bit-views)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _assert_bits(got, want):
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


def _port(ix):
    """The reference index ``ix`` (any layout) as the port's, on the CPU."""
    if isinstance(ix, rlayouts.BandedCsrIndex):
        parts = {b: _fields(getattr(ix, b)) for b in ("packed", "hor")}
        return tlayouts.index_from_numpy(
            "banded", {b: p[0] for b, p in parts.items()},
            {b: p[1] for b, p in parts.items()}, device="cpu")
    kind = "packed" if isinstance(ix, rlayouts.PackedCsrIndex) else "hor"
    return tlayouts.index_from_numpy(kind, *_fields(ix), device="cpu")


def _fields(ix):
    arrays, statics = {}, {}
    for f in dataclasses.fields(ix):
        v = getattr(ix, f.name)
        if f.name == "docs":
            arrays.update(norm=np.asarray(v.norm), rank=np.asarray(v.rank))
        elif f.name in type(ix)._static_fields:
            statics[f.name] = v
        else:
            arrays[f.name] = np.asarray(v)
    return arrays, statics


def _terms(ix, qh):
    qh = rquery.dedup_query_hashes(jnp.asarray(qh))
    tids = jnp.where(qh != 0, ix.lookup_terms(qh), -1)
    return qh, tids, rquery.idf(ix.term_df(tids), ix.docs.num_docs)


def _queries(host, case):
    if case == "sparse":
        # two terms whose postings all lie in the first tile, and an
        # empty query: the other tiles see no pair
        last = host.doc_ids[np.maximum(host.offsets[1:] - 1, 0)]
        first_tile = np.flatnonzero((host.df > 0) & (last < 512))[:2]
        qh = np.zeros((3, 2), np.uint32)
        qh[0, 0] = host.term_hashes[first_tile[0]]
        qh[1, :] = host.term_hashes[first_tile]
        return qh
    nq = 5 if case == "cap_overflow" else 8
    return rcorpus.sample_query_terms(host.df, host.term_hashes, nq, 3,
                                      num_docs=host.num_docs, seed=nq)


def _budget(real: int) -> int:
    """A pair budget just above ``real`` pairs.  Interpret mode costs a
    Python step per pair and compiles once per budget, so the budgets
    are powers of two that repeat across cases."""
    return 1 << (real + 16).bit_length()


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _routing(m, block, cap, n_tiles, budget, block_offsets, tfirst, tcount,
             tids, idf_t):
    cb, cv, cq, cw, cc = rops.expand_block_candidates(
        block_offsets, tids, idf_t, m, block, cap)
    return rfds.build_batched_pairs(cb, cv, cq, cw.astype(jnp.float32),
                                    tfirst, tcount, n_tiles, tids.shape[0],
                                    budget, cand_cap=cc)


def _reference_pairs(ix, tids, idf_t, cap, budget=None):
    """The reference engine's routing arrays (``ops.fused_batched_scores``
    up to the kernel, jitted once per shape), and the real-pair count."""
    b, t = tids.shape
    m = max(-(-min(cap, ix.max_posting_len) // ix.block), 1)
    if isinstance(ix, rlayouts.BlockedIndex):
        m = min(m, ix.max_blocks_per_term)
    tfirst, tcount, n_tiles = rops.routing_spans(ix, rfds.TILE)
    if budget is None:
        budget = rops.default_max_pairs(ix, b, t, cap)
    out = _routing(m, ix.block, cap, n_tiles, budget, ix.block_offsets,
                   tfirst, tcount, tids, idf_t)
    return out, int((np.asarray(out[1]) < n_tiles).sum()), n_tiles


@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("case", ["plain", "cap_overflow", "sparse"])
def test_plain_dense_kernel_equals_pallas(host, sparse_host, layout, case):
    """Padding pairs on the pad tile (plain), a mid-block cap with 5
    queries padded to 8 and a budget that overflows (cap_overflow), and
    tiles no pair visits, which must read 0.0 (sparse)."""
    if case == "sparse":
        host = sparse_host
    ix = (rlayouts.build_blocked(host) if layout == "hor"
          else rlayouts.build_packed_csr(host))
    cap = 257 if case == "cap_overflow" else host.max_posting_len
    _, tids, idf_t = _terms(ix, _queries(host, case))
    b = tids.shape[0]
    _, real, n_tiles = _reference_pairs(ix, tids, idf_t, cap)
    budget = real // 2 if case == "cap_overflow" else _budget(real)
    (pb, pt, pqw, pcap, overflow), _, _ = _reference_pairs(
        ix, tids, idf_t, cap, budget)
    pqw = jnp.pad(pqw, ((0, 0), (0, -(-b // 8) * 8 - b)))
    nd = host.num_docs
    if layout == "hor":
        want = rfds.fused_score_blocked_pallas(
            ix.block_docs, ix.block_tfs, pb, pt, pqw, pcap, nd,
            interpret=True)
        got = tfds.fused_score_blocked(
            _t(ix.block_docs), _t(ix.block_tfs), _t(pb), _t(pt), _t(pqw),
            _t(pcap), nd)
    else:
        ext = (ix.block_bits[pb], ix.block_base[pb], ix.block_count[pb])
        want = rfds.fused_score_packed_pallas(
            ix.packed, ix.block_tfs, pb, pt, pqw, pcap, *ext, nd, ix.block,
            interpret=True)
        got = tfds.fused_score_packed(
            _t(ix.packed), _t(ix.block_tfs), _t(pb), _t(pt), _t(pqw),
            _t(pcap), *map(_t, ext), nd, ix.block)
    _assert_bits(got, want)
    assert got.shape == (pqw.shape[1], nd) and (got.numpy() > 0).any()
    if case == "sparse":
        assert set(np.asarray(pt).tolist()) == {0, n_tiles}
        assert not got[:, 512:].any()
    assert (int(overflow) > 0) == (case == "cap_overflow")
    assert tfds.fused_score_blocked.launches == 0
    assert tfds.fused_score_packed.launches == 0


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_fused_batched_scores_equals_reference(host, layout):
    """The port's own routing into its dense engine == the reference's
    dense engine (interpret mode), scores and overflow, for the default
    budget and an undersized one."""
    ix = (rlayouts.build_blocked(host) if layout == "hor"
          else rlayouts.build_packed_csr(host))
    _, tids, idf_t = _terms(ix, _queries(host, "plain"))
    tix = _port(ix)
    _, real, _ = _reference_pairs(ix, tids, idf_t, 300)
    assert tops.default_max_pairs(tix, *tids.shape, 300) == \
        rops.default_max_pairs(ix, *tids.shape, 300)
    for max_pairs in (_budget(real), real // 2):
        want, wov = rops.fused_batched_scores(ix, tids, idf_t, 300,
                                              max_pairs=max_pairs)
        got, gov = tops.fused_batched_scores(tix, _t(tids), _t(idf_t), 300,
                                             max_pairs=max_pairs)
        _assert_bits(got, want)
        assert int(gov) == int(wov)
        assert (int(wov) > 0) == (max_pairs < real)


def test_segment_engines_equal_reference(host):
    """On one banded segment and its bands: the banded engine (two dense
    launches, partials summed as acc_p + acc_h), the dense and candidate
    engines, and the gather oracles, each against the reference's on
    shared query hashes and global weights, bit for bit."""
    norm = np.asarray(host.norm).copy()
    norm[::5] = 0.0                            # tombstones
    h = dataclasses.replace(host, norm=norm)
    bix = rlayouts.build_banded(h)
    assert bix.packed.df.sum() > 0 and bix.hor.df.sum() > 0
    tix = _port(bix)
    qh, tids, idf_t = _terms(bix, _queries(host, "plain"))
    qh_t, idf = _t(qh), _t(idf_t)
    kt = rfds.default_k_tile(K)
    kw = dict(k_tile=kt, rank_blend=0.25)
    assert rops.banded_pairs_budgets(bix) == tops.banded_pairs_budgets(tix)
    budget = {}
    for band in ("packed", "hor"):
        rb = getattr(bix, band)
        budget[band] = _budget(_reference_pairs(rb, tids, idf_t,
                                                rb.max_posting_len)[1])
        assert rops.padded_pairs_budget(rb) == tops.padded_pairs_budget(
            getattr(tix, band))
    caps = dict(cap_packed=max(bix.packed.max_posting_len, 1),
                cap_hor=max(bix.hor.max_posting_len, 1),
                max_pairs_packed=budget["packed"],
                max_pairs_hor=budget["hor"])
    runs = [(rops.fused_segment_banded_topk(bix, qh, idf_t, jnp.int32(50),
                                            **caps, **kw),
             tops.fused_segment_banded_topk(tix, qh_t, idf, 50, **caps,
                                            **kw))]
    for band in ("packed", "hor"):
        rb, tb = getattr(bix, band), getattr(tix, band)
        seg = dict(cap=max(rb.max_posting_len, 1), max_pairs=budget[band],
                   **kw)
        runs.append((rops.fused_segment_dense_topk(rb, qh, idf_t,
                                                   jnp.int32(50), **seg),
                     tops.fused_segment_dense_topk(tb, qh_t, idf, 50, **seg)))
        runs.append((rops.fused_segment_topk(rb, qh, idf_t, jnp.int32(50),
                                             **seg),
                     tops.fused_segment_topk(tb, qh_t, idf, 50, **seg)))
    oracle = dict(k_tile=kt, cap=bix.max_posting_len, rank_blend=0.25)
    runs.append((rops.jnp_segment_topk(bix, qh, idf_t, jnp.int32(50),
                                       **oracle),
                 tops.torch_segment_topk(tix, qh_t, idf, 50, **oracle)))
    for (wv, wi, wo), (gv, gi, go) in runs:
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        _assert_bits(gv, wv)
        assert int(go) == int(wo) == 0
    # the banded answer is the HOR oracle's answer
    np.testing.assert_array_equal(runs[0][1][1].numpy(),
                                  runs[-1][1][1].numpy())
    for q in range(3):
        for cap in (bix.max_posting_len, 40):
            wv, wi, wt = rops.jnp_segment_conjunctive(
                bix, qh[q], idf_t[q], jnp.int32(2), jnp.int32(50),
                k_tile=kt, cap=cap)
            gv, gi, gt = tops.torch_segment_conjunctive(
                tix, qh_t[q], idf[q], 2, 50, k_tile=kt, cap=cap)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            _assert_bits(gv, wv)
            assert gt == int(wt)
