"""Port vs reference for the banded layout, the size-class padding, the
size model and the compaction policy: ``build_banded`` /
``term_packed_words`` / ``choose_band_cut`` / ``pad_*_to_class`` array by
array, ``posting_bytes()`` equal to the byte model, the layout chooser's
decisions and reasons, and the tiered policy's picks.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import build as rbuild, compaction as rcomp  # noqa: E402
from repro.core import layouts as rlayouts, size_model as rsize  # noqa: E402
from repro.text import corpus as rcorpus  # noqa: E402
from repro_torch.core import compaction as tcomp  # noqa: E402
from repro_torch.core import layouts as tlayouts  # noqa: E402
from repro_torch.core import size_model as tsize  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.distributed.topk import merge_topk_candidates  # noqa: E402


def _host(seed=7, docs=6000, vocab=400, avg=20):
    return rbuild.bulk_build(rcorpus.generate(rcorpus.CorpusSpec(
        num_docs=docs, vocab=vocab, avg_distinct=avg, seed=seed)))


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_index_equal(got, want):
    """Every field of a port index equals the reference's, bit for bit."""
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "docs":
            for col in ("norm", "rank"):
                np.testing.assert_array_equal(_np(getattr(g, col)),
                                              _np(getattr(w, col)), col)
        elif w is None or isinstance(w, int):
            assert g == w, f.name
        else:
            np.testing.assert_array_equal(_np(g), _np(w), f.name)


@pytest.mark.parametrize("cut", [None, 0, "mid", 10**6])
@pytest.mark.parametrize("quantum", [1, 8])
def test_build_banded_equals_reference(cut, quantum):
    """Byte-model cut (and forced ones: all HOR, a middle cut, all
    packed) at both lane quanta: both bands array by array, the shared
    DocTable and vocabulary, df / term_df / gather_postings, and
    posting_bytes() equal to the exact byte model."""
    h = _host()
    th = tlayouts.PostingsHost(**dataclasses.asdict(h))
    words, nblocks = rlayouts.term_packed_words(h)
    tw, tn = tlayouts.term_packed_words(th)
    np.testing.assert_array_equal(tw, words)
    np.testing.assert_array_equal(tn, nblocks)
    mid = cut == "mid"
    if mid:
        widths = np.unique(words[words > 0])
        cut = int(widths[len(widths) // 2])
    want_cut = rsize.choose_band_cut(words, nblocks, lane_quantum=quantum)
    assert tsize.choose_band_cut(tw, tn, lane_quantum=quantum) == want_cut
    want = rlayouts.build_banded(h, max_band_words=cut,
                                 lane_quantum=quantum)
    got = tlayouts.build_banded(th, max_band_words=cut,
                                lane_quantum=quantum, device="cpu")
    _assert_index_equal(got.packed, want.packed)
    _assert_index_equal(got.hor, want.hor)
    assert got.hor.docs is got.packed.docs
    assert got.hor.sorted_hash is got.packed.sorted_hash
    assert (got.max_posting_len, got.num_terms, got.block, got.route_tile) \
        == (want.max_posting_len, want.num_terms, want.block,
            want.route_tile)
    assert got.posting_bytes() == want.posting_bytes()
    assert got.nbytes() == want.nbytes()
    used = want_cut[0] if cut is None else cut
    assert got.posting_bytes() == tsize.banded_posting_bytes_from_words(
        tw, tn, used)
    if cut is None and quantum == 1:
        assert got.posting_bytes() == want_cut[1]
    if mid:
        assert got.packed.df.sum() > 0 and got.hor.df.sum() > 0
    np.testing.assert_array_equal(_np(got.df), _np(want.df))
    tids = np.array([0, 5, -1, 17, 300, 2], np.int32)
    np.testing.assert_array_equal(_np(got.term_df(torch.from_numpy(tids))),
                                  _np(want.term_df(jnp.asarray(tids))))
    if want.packed.df.sum() and want.hor.df.sum():   # both bands in use
        for g, w in zip(got.gather_postings(torch.from_numpy(tids), 300),
                        want.gather_postings(jnp.asarray(tids), 300)):
            np.testing.assert_array_equal(_np(g), _np(w))
    # the unpadded index, an empty band included, scores through the
    # banded engine as through the gather oracle
    rng = np.random.default_rng(1)
    qh = tlayouts.hash_tensor(rcorpus.sample_query_terms(
        h.df, h.term_hashes, 4, 3, num_docs=h.num_docs, seed=1))
    idf = torch.from_numpy((rng.random(qh.shape) + 0.5).astype(np.float32))
    mp_p, mp_h = tops.banded_pairs_budgets(got)
    fused = tops.fused_segment_banded_topk(
        got, qh, idf, 0, k_tile=16,
        cap_packed=max(got.packed.max_posting_len, 1),
        cap_hor=max(got.hor.max_posting_len, 1), max_pairs_packed=mp_p,
        max_pairs_hor=mp_h)
    oracle = tops.torch_segment_topk(got, qh, idf, 0, k_tile=16,
                                     cap=got.max_posting_len)
    assert int(fused[2]) == 0
    assert torch.equal(merge_topk_candidates(*fused[:2], 10)[1],
                       merge_topk_candidates(*oracle[:2], 10)[1])


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_pad_to_class_equals_reference(layout):
    """Size-class padding as the seal path applies it, field by field,
    and its guards."""
    h = _host(docs=700)
    th = tlayouts.PostingsHost(**dataclasses.asdict(h))
    w_pad = tlayouts.size_class(h.num_terms, base=256)
    if layout == "hor":
        ix = rlayouts.build_blocked(h)
        tix = tlayouts.build_blocked(th, device="cpu")
        mpl = tlayouts.size_class(ix.max_posting_len)
        kw = dict(nb_pad=tlayouts.size_class(ix.block_docs.shape[0]),
                  w_pad=w_pad, max_posting_len=mpl,
                  max_blocks_per_term=mpl // 128,
                  route_pairs_max=tlayouts.size_class(ix.route_pairs_max),
                  route_span_max=tlayouts.size_class(ix.route_span_max,
                                                     base=8))
        want = rlayouts.pad_blocked_to_class(ix, **kw)
        got = tlayouts.pad_blocked_to_class(tix, **kw)
        pad = tlayouts.pad_blocked_to_class
    else:
        ix = rlayouts.build_packed_csr(h)
        tix = tlayouts.build_packed_csr(th, device="cpu")
        kw = dict(nb_pad=tlayouts.size_class(ix.packed.shape[0]),
                  w_pad=w_pad,
                  max_posting_len=tlayouts.size_class(ix.max_posting_len),
                  words_per_block=-(-ix.words_per_block // 8) * 8 + 8,
                  route_pairs_max=tlayouts.size_class(ix.route_pairs_max),
                  route_span_max=tlayouts.size_class(ix.route_span_max,
                                                     base=8))
        want = rlayouts.pad_packed_to_class(ix, **kw)
        got = tlayouts.pad_packed_to_class(tix, **kw)
        pad = tlayouts.pad_packed_to_class
    _assert_index_equal(got, want)
    assert got.posting_bytes() == want.posting_bytes()
    assert rlayouts.size_class(12345, base=512) == \
        tlayouts.size_class(12345, base=512) == 16384
    with pytest.raises(ValueError, match="size class"):
        pad(tix, **{**kw, "w_pad": 1})
    with pytest.raises(ValueError, match="cover"):
        pad(tix, **{**kw, "route_pairs_max": 0})


def test_size_model_and_chooser_equal_reference():
    """The byte models, the band-cut model and the layout chooser over a
    grid of run shapes: same numbers, same decisions, same reasons."""
    rng = np.random.default_rng(3)
    for num_docs in (10, 300, 4095, 4096, 20_000, 1_000_000):
        for num_terms in (0, 1, 40, 5000):
            for per_term in (1, 3, 50):
                st = dict(num_docs=num_docs, num_terms=num_terms,
                          num_postings=num_terms * per_term)
                rs, ts = rsize.SegmentStats(**st), tsize.SegmentStats(**st)
                assert tsize.est_delta_bits(ts) == rsize.est_delta_bits(rs)
                for lay in ("pr", "or", "cor", "hor", "packed", "banded"):
                    assert tsize.est_posting_bytes(ts, lay) == \
                        rsize.est_posting_bytes(rs, lay)
                for cands in (("hor", "packed"), ("hor",),
                              ("hor", "packed", "banded")):
                    want = rsize.LayoutCostModel(candidates=cands).choose(rs)
                    got = tsize.LayoutCostModel(candidates=cands).choose(ts)
                    assert (got.layout, got.reason) == (want.layout,
                                                        want.reason)
                pol = (rsize.LayoutCostModel(min_packed_docs=100),
                       tsize.LayoutCostModel(min_packed_docs=100))
                for explicit in (None, "banded"):
                    for i in (0, 1):
                        assert tsize.resolve_layout(
                            explicit, pol[1] if i else None, ts, "hor",
                            size_class=8192) == rsize.resolve_layout(
                            explicit, pol[0] if i else None, rs, "hor",
                            size_class=8192)
    df = rng.integers(0, 900, size=500)
    assert tsize.hor_posting_bytes_from_df(df) == \
        rsize.hor_posting_bytes_from_df(df)
    words = rng.integers(0, 60, size=400)
    nblocks = np.where(words > 0, rng.integers(1, 9, size=400), 0)
    for cut in (0, 7, 59):
        for q in (1, 8):
            assert tsize.banded_posting_bytes_from_words(
                words, nblocks, cut, lane_quantum=q) == \
                rsize.banded_posting_bytes_from_words(
                    words, nblocks, cut, lane_quantum=q)
    assert tsize.candidate_bytes_per_query(1_004_721, 512, 16) == \
        rsize.candidate_bytes_per_query(1_004_721, 512, 16)


def test_compaction_policy_equals_reference():
    rng = np.random.default_rng(5)
    for _ in range(300):
        sizes = [int(x) for x in rng.integers(0, 4000,
                                              size=rng.integers(0, 9))]
        ratio, run = float(rng.choice([2.0, 4.0, 8.0])), int(
            rng.integers(1, 6))
        assert tcomp.pick_compaction(sizes, ratio, run) == \
            rcomp.pick_compaction(sizes, ratio, run)
        assert tcomp.TieredPolicy(ratio, run).due(sizes) == \
            rcomp.TieredPolicy(ratio, run).due(sizes)
        cur = list(rng.choice(["hor", "packed", "banded"], size=len(sizes)))
        want = list(rng.choice(["hor", "packed", "banded"],
                               size=len(sizes)))
        assert tcomp.pick_layout_rewrite(cur, want) == \
            rcomp.pick_layout_rewrite(cur, want)
