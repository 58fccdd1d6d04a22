"""The paper's side kernels in the port against the reference.

``posting_score_plain`` (the plain version of the single-query posting
scorer) must equal ``posting_score_pallas`` run in interpret mode, to
the bit, on the reference's own routing pairs; ``build_pairs`` must
equal the reference's, overflow included; ``blocked_query_scores`` must
equal the reference's and the dense oracle's raw accumulation to the
bit.  ``unpack_blocks_plain`` must equal ``unpack_blocks_pallas`` in
interpret mode over every bit width and two block widths, and
``unpack_postings`` must reproduce the host's doc ids term by term.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import build as rbuild, layouts as rlayouts  # noqa: E402
from repro.core.query import idf as ridf  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import posting_score as rps  # noqa: E402
from repro.kernels.packed_postings import unpack_blocks_pallas  # noqa: E402
from repro.text import corpus as rcorpus  # noqa: E402
from repro_torch.core import layouts as tlayouts  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import packed_postings as tpp  # noqa: E402
from repro_torch.kernels import posting_score as tps  # noqa: E402


def _host(seed, docs=512, vocab=400, avg=25):
    return rbuild.bulk_build(rcorpus.generate(rcorpus.CorpusSpec(
        num_docs=docs, vocab=vocab, avg_distinct=avg, seed=seed)))


def _t(x):
    a = np.array(x)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _port_hor(ix):
    arrays, statics = {}, {}
    for f in dataclasses.fields(ix):
        v = getattr(ix, f.name)
        if f.name == "docs":
            arrays.update(norm=np.asarray(v.norm), rank=np.asarray(v.rank))
        elif f.name in type(ix)._static_fields:
            statics[f.name] = v
        elif v is not None:
            arrays[f.name] = np.asarray(v)
    return tlayouts.index_from_numpy("hor", arrays, statics, device="cpu")


def _query(host, hor, seed, n_terms=4):
    """One Table-7 query's term ids and the reference's idf weights."""
    qh = rcorpus.sample_query_terms(host.df, host.term_hashes, 1, n_terms,
                                    num_docs=host.num_docs, seed=seed)[0]
    tids = hor.lookup_terms(jnp.asarray(qh))
    return tids, ridf(hor.term_df(tids), host.num_docs)


def _exact_pairs(hor, tids, tile):
    """The real pairs of a query: the routing spans of its valid blocks."""
    sel, valid, _ = rops.select_query_blocks(
        hor, tids, jnp.zeros(tids.shape), hor.max_blocks_per_term)
    _, tcount, _ = rops.routing_spans(hor, tile)
    return int(np.asarray(tcount)[np.asarray(sel)][np.asarray(valid)].sum())


@pytest.mark.parametrize("seed,block,tile", [(0, 16, 128), (1, 32, 256),
                                             (2, 64, 128)])
def test_posting_score_plain_equals_pallas(seed, block, tile):
    """The reference kernel's own pairs through both versions, compared
    to the bit; then the whole single-query path."""
    host = _host(seed)
    hor = rlayouts.build_blocked(host, block=block)
    tids, w = _query(host, hor, seed)
    max_pairs = _exact_pairs(hor, tids, tile) + 5       # 5 padding pairs
    sel, valid, sw = rops.select_query_blocks(hor, tids, w,
                                              hor.max_blocks_per_term)
    tfirst, tcount, n_tiles = rops.routing_spans(hor, tile)
    pb, pt, pw, ovf = rps.build_pairs(sel, valid, sw, tfirst, tcount,
                                      n_tiles, max_pairs)
    assert int(ovf) == 0
    want = np.asarray(rps.posting_score_pallas(
        hor.block_docs, hor.block_tfs, pb, pt, pw, host.num_docs, tile,
        interpret=True))
    got = tps.posting_score_plain(_t(hor.block_docs), _t(hor.block_tfs),
                                  _t(pb), _t(pt), _t(pw), host.num_docs,
                                  tile).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert (want > 0).any()

    port = _port_hor(hor)
    scores, overflow = tops.blocked_query_scores(
        port, _t(tids), _t(w), hor.max_blocks_per_term, max_pairs, tile)
    assert int(overflow) == 0
    assert np.array_equal(scores.numpy().view(np.int32), want.view(np.int32))
    assert tps.posting_score.launches == 0       # CPU tensors: plain only


def test_posting_score_rounds_the_product_before_adding():
    """The Pallas kernel rounds ``tf * w`` before adding it (XLA does not
    contract its one-hot matmul and the accumulate into a fused
    multiply-add), which is why the CUDA kernel multiplies, then adds:
    the same pairs summed with one FMA per lane differ from it.  The tfs
    are drawn from (0, 4), so the products round."""
    host = _host(0)
    rng = np.random.default_rng(0)
    host = dataclasses.replace(host, tfs=(rng.random(host.num_postings) * 4
                                          + 1e-3).astype(np.float32))
    hor = rlayouts.build_blocked(host, block=16)
    tids, w = _query(host, hor, 0)
    sel, valid, sw = rops.select_query_blocks(hor, tids, w,
                                              hor.max_blocks_per_term)
    tfirst, tcount, n_tiles = rops.routing_spans(hor, 128)
    pb, pt, pw, _ = rps.build_pairs(sel, valid, sw, tfirst, tcount, n_tiles,
                                    _exact_pairs(hor, tids, 128))
    want = np.asarray(rps.posting_score_pallas(
        hor.block_docs, hor.block_tfs, pb, pt, pw, host.num_docs, 128,
        interpret=True))
    docs, tfs = _t(hor.block_docs), _t(hor.block_tfs)
    acc_fma = torch.zeros(host.num_docs)
    acc_mul = torch.zeros(host.num_docs)
    for b, t, wt in zip(np.asarray(pb), np.asarray(pt), np.asarray(pw)):
        d = docs[int(b)]
        ok = (d >= 0) & (d // 128 == int(t))
        rows, tf = d[ok].long(), tfs[int(b)][ok]
        wt = torch.full_like(tf, float(wt))
        acc_fma[rows] = tquery.fma_f32(tf, wt, acc_fma[rows])
        acc_mul[rows] = acc_mul[rows] + tf * wt
    assert np.array_equal(acc_mul.numpy().view(np.int32), want.view(np.int32))
    assert (acc_fma.numpy() != want).sum() > 0


def test_posting_score_equals_oracle_accumulation():
    """The single-query scores equal the dense oracle's raw
    accumulation (``accumulate_scores`` over the gathered postings) to
    the bit: both add ``round(tf * w)`` in term-slot order per doc."""
    host = _host(4, docs=900, vocab=300, avg=30)
    hor = rlayouts.build_blocked(host)
    port = _port_hor(hor)
    for seed in range(3):
        tids, w = _query(host, hor, seed)
        tids, w = _t(tids), _t(w)
        scores, overflow = tops.blocked_query_scores(
            port, tids, w, port.max_blocks_per_term,
            _exact_pairs(hor, jnp.asarray(tids.numpy()), tps.TILE))
        d, tf, valid = port.gather_postings(tids, host.max_posting_len)
        raw = tquery.accumulate_scores(d, tf * w[:, None], valid,
                                       host.num_docs)
        assert int(overflow) == 0
        assert torch.equal(scores.view(torch.int32), raw.view(torch.int32))


def _warp_lower_bound(a, key):
    """A mirror of ``warp_lower_bound`` (``csrc/posting_score.cu``): one
    warp's 32-ary search of sorted ``a`` for the first index whose value
    is >= key.  Returns the bound and the dependent loads it took; checks
    that the lanes below the key form a prefix, as the ballot count
    assumes."""
    lane = np.arange(32)
    lo, hi, loads = 0, len(a), 0

    def below(idx):
        ok = idx < hi
        b = np.zeros(32, bool)
        b[ok] = a[idx[ok]] < key
        assert not (b[1:] & ~b[:-1]).any()          # a prefix of lanes
        return int(b.sum())
    while hi - lo > 32:
        step = (hi - lo + 31) // 32
        lo += below(lo + (lane + 1) * step - 1) * step
        hi = min(hi, lo + step - 1)
        loads += 1
    return lo + below(lo + lane), loads + 1


def _runs(rng, n_tiles, sizes):
    """Tile-sorted pair tiles: run ``sizes[i]`` pairs at tile ``i`` (0
    leaves the tile unvisited), the last entry padding at ``n_tiles``."""
    return np.repeat(np.arange(n_tiles + 1), sizes).astype(np.int32)


@pytest.mark.parametrize("case", ["gaps", "padding_only", "one_tile",
                                  "straddle", "empty", "long"])
def test_run_search_equals_tile_starts(case):
    """Each CTA's on-device run search (two warp searches, for t and
    t + 1) gives the run starts ``searchsorted(pair_tile, t)`` for sorted
    pair tiles: unvisited tiles, pairs that are all padding, one tile
    holding every pair, runs of 31-33, 1,023-1,025 and 32 * 32 + 1 pairs
    that straddle the warp's 32 samples, no pairs at all, and 2^25 pairs
    within 5 dependent loads."""
    rng = np.random.default_rng(len(case))
    n_tiles = 40
    if case == "gaps":
        sizes = rng.integers(0, 4, n_tiles + 1) * rng.integers(0, 9, n_tiles + 1)
    elif case == "padding_only":
        sizes = np.zeros(n_tiles + 1, int)
        sizes[-1] = 300
    elif case == "one_tile":
        sizes = np.zeros(n_tiles + 1, int)
        sizes[17], sizes[-1] = 5000, 3
    elif case == "straddle":
        sizes = rng.choice([0, 31, 32, 33, 1023, 1024, 1025, 1025, 33],
                           n_tiles + 1)
    elif case == "empty":
        sizes = np.zeros(n_tiles + 1, int)
    else:
        n_tiles = 300
        sizes = rng.multinomial(2**25, np.ones(n_tiles + 1) / (n_tiles + 1))
    pair_tile = _runs(rng, n_tiles, sizes)
    want = np.searchsorted(pair_tile, np.arange(n_tiles + 1))
    got, loads = zip(*(_warp_lower_bound(pair_tile, t)
                       for t in range(n_tiles + 1)))
    assert list(got) == want.tolist()
    assert max(loads) <= (5 if case == "long" else 3)


@pytest.mark.parametrize("max_pairs", [3, 40, 4096])
def test_build_pairs_equal_reference(max_pairs):
    host = _host(3)
    hor = rlayouts.build_blocked(host, block=16)
    tids, w = _query(host, hor, 3)
    sel, valid, sw = rops.select_query_blocks(hor, tids, w,
                                              hor.max_blocks_per_term)
    tfirst, tcount, n_tiles = rops.routing_spans(hor, 64)
    want = rps.build_pairs(sel, valid, sw, tfirst, tcount, n_tiles,
                           max_pairs)
    got = tps.build_pairs(_t(sel), _t(valid), _t(sw), _t(tfirst),
                          _t(tcount), n_tiles, max_pairs)
    for g, wv in zip(got[:3], want[:3]):
        wv = np.asarray(wv)
        assert g.numpy().dtype == wv.dtype
        assert np.array_equal(g.numpy(), wv)
    assert int(got[3]) == int(want[3])
    if max_pairs < 40:
        assert int(got[3]) > 0    # a too-small budget is reported exactly

    port = _port_hor(hor)
    tsel, tvalid, tsw = tops.select_query_blocks(
        port, _t(tids), _t(w), hor.max_blocks_per_term)
    for g, wv in ((tsel, sel), (tvalid, valid), (tsw, sw)):
        assert np.array_equal(g.numpy(), np.asarray(wv))


def _np_unpack(words, bits, base, count, block):
    """Independent numpy decoder with the kernel's int32 wrap-around."""
    mask = (1 << bits) - 1 if bits < 32 else 0xFFFFFFFF
    deltas = np.zeros(block, np.int64)
    for lane in range(block):
        wi, off = divmod(lane * bits, 32)
        lo = int(words[wi]) >> off
        hi = (int(words[min(wi + 1, len(words) - 1)]) << (32 - off)) \
            if off else 0
        deltas[lane] = (lo | hi) & mask
    docs = int(base) + np.cumsum(deltas)
    docs = ((docs + 2**31) % 2**32 - 2**31).astype(np.int32)
    return np.where(np.arange(block) < count, docs, -1)


@pytest.mark.parametrize("bits", list(range(4, 33)))
@pytest.mark.parametrize("block", [16, 128])
def test_unpack_blocks_plain_equals_pallas(bits, block):
    """Random words with all-ones high bytes (a hi-word fetch that bled
    into a neighbouring lane would show), random bases that wrap int32,
    and counts below the block width."""
    rng = np.random.default_rng(bits * 1000 + block)
    nb = 4
    wpb = (block * bits + 31) // 32
    words = rng.integers(0, 2**32, size=(nb, wpb), dtype=np.uint32)
    words[:, -1] |= np.uint32(0xFF000000)
    bits_a = np.full(nb, bits, np.int32)
    base_a = np.concatenate([rng.integers(-5, 1000, size=nb - 1),
                             [2**31 - 7]]).astype(np.int32)
    count_a = rng.integers(1, block, size=nb).astype(np.int32)
    want = np.asarray(unpack_blocks_pallas(
        jnp.asarray(words), jnp.asarray(bits_a), jnp.asarray(base_a),
        jnp.asarray(count_a), block, interpret=True))
    got = tpp.unpack_blocks_plain(_t(words), _t(bits_a), _t(base_a),
                                  _t(count_a), block).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(want, np.stack([
        _np_unpack(words[i], bits, base_a[i], count_a[i], block)
        for i in range(nb)]))
    assert np.array_equal(tpp.unpack_blocks(
        _t(words), _t(bits_a), _t(base_a), _t(count_a), block).numpy(), got)


@pytest.mark.parametrize("block", [16, 32, 128])
def test_unpack_postings_equals_host(block):
    """Every block of a packed index decoded: equal to the reference's
    decode and, term by term in hash order, to the host's doc ids."""
    host = _host(block)
    ref = rlayouts.build_packed_csr(host, block=block)
    port = tlayouts.build_packed_csr(
        tlayouts.PostingsHost(**{f.name: getattr(host, f.name)
                                 for f in dataclasses.fields(host)}),
        block=block, device="cpu")
    got = tops.unpack_postings(port).numpy()
    want = np.asarray(rops.unpack_postings(ref, backend="xla"))
    assert np.array_equal(got, want)
    offs = np.asarray(ref.block_offsets)
    for tid, term in enumerate(np.argsort(host.term_hashes, kind="stable")):
        s, e = host.offsets[term], host.offsets[term + 1]
        rows = got[offs[tid]:offs[tid + 1]].reshape(-1)
        assert np.array_equal(rows[:e - s], host.doc_ids[s:e])
        assert (rows[e - s:] == -1).all()
