"""Port vs reference: host ingest and the HOR / packed device layouts.

Every ``PostingsHost`` array and every ``BlockedIndex`` /
``PackedCsrIndex`` array the port builds must equal the JAX package's,
byte for byte (u32 arrays compared through their int32 bit-views), on
the same seeded corpora — including engineered postings whose packed
blocks need every bit width from 1 to 32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import build as rbuild, layouts as rlayouts  # noqa: E402
from repro.text import corpus as rcorpus, tokenizer as rtok  # noqa: E402
from repro_torch.core import build as tbuild, layouts as tlayouts  # noqa: E402
from repro_torch.text import corpus as tcorpus, tokenizer as ttok  # noqa: E402

HOST_FIELDS = ("term_hashes", "df", "offsets", "doc_ids", "tfs", "norm",
               "rank")
HOR_FIELDS = ("sorted_hash", "df", "block_offsets", "block_docs",
              "block_tfs", "block_min", "block_max", "tile_first",
              "tile_count")
PACKED_FIELDS = ("sorted_hash", "df", "block_offsets", "block_bits",
                 "block_base", "block_count", "packed", "block_tfs",
                 "block_min", "block_max", "tile_first", "tile_count")
STATICS = ("max_posting_len", "block", "route_tile", "route_pairs_max",
           "route_span_max")


def _same_bytes(ref, got, name):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, name
    assert ref.dtype.itemsize == got.dtype.itemsize, name
    assert ref.tobytes() == got.tobytes(), name


def _hosts(spec_kw, stream=False):
    rspec = rcorpus.CorpusSpec(**spec_kw)
    tspec = tcorpus.CorpusSpec(**spec_kw)
    if stream:
        rc = next(rcorpus.stream_batches(rspec, rspec.num_docs))
        tc = next(tcorpus.stream_batches(tspec, tspec.num_docs))
    else:
        rc, tc = rcorpus.generate(rspec), tcorpus.generate(tspec)
    return rbuild.bulk_build(rc), tbuild.bulk_build(tc)


def _engineered_host():
    """One term per bit width 1..32: the first block's deltas need
    exactly that width (doc 2**31 - 1 after a term start is a delta of
    2**31, i.e. 32 bits), plus a multi-block term whose later blocks
    start from the previous block's last id."""
    rng = np.random.default_rng(88)
    lists = []
    for bits in range(1, 33):
        if bits == 32:
            docs = np.array([2**31 - 1])
        else:
            hi = 2**bits - 1
            gaps = rng.integers(1, hi + 1, size=40)
            gaps[0] = hi - 1 if hi > 1 else 0      # first delta == hi
            docs = np.cumsum(gaps)
            docs = docs[docs < 2**31 - 1]
        lists.append(np.unique(docs))
    lists.append(np.arange(0, 300 * 5, 5))          # 3 blocks, 3-bit gaps
    lens = np.array([len(x) for x in lists])
    offsets = np.zeros(len(lists) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    n = 64
    return rlayouts.PostingsHost(
        term_hashes=rtok.mix32(np.arange(len(lists), dtype=np.uint32)),
        df=lens.astype(np.int32), offsets=offsets,
        doc_ids=np.concatenate(lists).astype(np.int32),
        tfs=rng.integers(1, 9, size=int(lens.sum())).astype(np.float32),
        num_docs=2**31, norm=rng.random(n).astype(np.float32),
        rank=rng.random(n).astype(np.float32))


def _as_port_host(h):
    return tlayouts.PostingsHost(**{f: getattr(h, f) for f in (
        *HOST_FIELDS, "num_docs")})


@pytest.mark.parametrize("spec_kw,stream", [
    (dict(num_docs=400, vocab=900, avg_distinct=30, seed=11), False),
    (dict(num_docs=1500, vocab=700, avg_distinct=20, seed=4), True),
])
def test_postings_host_byte_equal(spec_kw, stream):
    rh, th = _hosts(spec_kw, stream)
    for f in HOST_FIELDS:
        _same_bytes(getattr(rh, f), getattr(th, f), f)
    assert rh.num_docs == th.num_docs
    assert rh.max_posting_len == th.max_posting_len
    assert (dataclasses.astuple(rbuild.corpus_stats(rh))
            == dataclasses.astuple(tbuild.corpus_stats(th)))


@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("engineered", [False, True])
def test_layouts_byte_equal(layout, engineered):
    if engineered:
        rh = _engineered_host()
        th = _as_port_host(rh)
    else:
        rh, th = _hosts(dict(num_docs=600, vocab=500, avg_distinct=25,
                             seed=7))
    if layout == "hor":
        ref = rlayouts.build_blocked(rh)
        got = tlayouts.build_blocked(th, device="cpu")
        fields, statics = HOR_FIELDS, STATICS + ("max_blocks_per_term",)
    else:
        ref = rlayouts.build_packed_csr(rh)
        got = tlayouts.build_packed_csr(th, device="cpu")
        fields, statics = PACKED_FIELDS, STATICS + ("words_per_block",)
    for f in fields:
        _same_bytes(getattr(ref, f), getattr(got, f), f)
    _same_bytes(ref.docs.norm, got.docs.norm, "norm")
    _same_bytes(ref.docs.rank, got.docs.rank, "rank")
    for s in statics:
        assert getattr(ref, s) == getattr(got, s), s
    assert ref.nbytes() == got.nbytes()
    assert ref.posting_bytes() == got.posting_bytes()
    if engineered and layout == "packed":
        assert set(np.asarray(ref.block_bits).tolist()) == set(range(1, 33))


@pytest.mark.parametrize("layout", ["hor", "packed"])
def test_lookup_df_and_gather_match(layout):
    rh, th = _hosts(dict(num_docs=600, vocab=500, avg_distinct=25, seed=7))
    build_r = {"hor": rlayouts.build_blocked,
               "packed": rlayouts.build_packed_csr}[layout]
    build_t = {"hor": tlayouts.build_blocked,
               "packed": tlayouts.build_packed_csr}[layout]
    ref, got = build_r(rh), build_t(th, device="cpu")
    taken = set(rh.term_hashes.tolist())
    misses = [h for h in (1, 12345, 2**31 + 7, 2**32 - 2) if h not in taken]
    hashes = np.concatenate([rh.term_hashes[::37], np.array(
        misses, np.uint32), np.zeros(2, np.uint32)]).astype(np.uint32)
    want = np.asarray(ref.lookup_terms(jnp.asarray(hashes)))
    have = got.lookup_terms(tlayouts.hash_tensor(hashes))
    np.testing.assert_array_equal(have.numpy(), want)
    assert (want[-len(misses) - 2:] == -1).all()
    tids = np.where(hashes != 0, want, -1).astype(np.int32)
    np.testing.assert_array_equal(
        got.term_df(torch.from_numpy(tids)).numpy(),
        np.asarray(ref.term_df(jnp.asarray(tids))))
    cap = 130                       # cuts the second block mid-way
    rd, rt, rv = ref.gather_postings(jnp.asarray(tids), cap)
    td, tt, tv = got.gather_postings(torch.from_numpy(tids), cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_index_from_numpy_round_trips():
    rh, th = _hosts(dict(num_docs=400, vocab=300, avg_distinct=20, seed=2))
    ref = rlayouts.build_packed_csr(rh)
    arrays = {f: np.asarray(getattr(ref, f)) for f in PACKED_FIELDS}
    arrays.update(norm=np.asarray(ref.docs.norm),
                  rank=np.asarray(ref.docs.rank))
    statics = {s: getattr(ref, s) for s in STATICS + ("words_per_block",)}
    got = tlayouts.index_from_numpy("packed", arrays, statics, device="cpu")
    built = tlayouts.build_packed_csr(th, device="cpu")
    for f in PACKED_FIELDS:
        assert torch.equal(getattr(got, f), getattr(built, f)), f


def test_merge_vocab_and_tokenizer_match():
    rng = np.random.default_rng(5)
    old = rng.choice(2**32 - 1, size=300, replace=False).astype(np.uint32)
    new = np.concatenate([old[rng.choice(300, 50)], rng.choice(
        2**32 - 1, size=80).astype(np.uint32)])
    rm, rr = rbuild.merge_vocab(old, new)
    tm, tr = tbuild.merge_vocab(old, new)
    np.testing.assert_array_equal(rm, tm)
    np.testing.assert_array_equal(rr, tr)
    ids = np.arange(5000, dtype=np.uint32)
    np.testing.assert_array_equal(rtok.mix32(ids), ttok.mix32(ids))
    words = ttok.tokenize("Informational retrieval of stemmed words, 2009")
    assert words == rtok.tokenize(
        "Informational retrieval of stemmed words, 2009")
    np.testing.assert_array_equal(rtok.hash_terms(words),
                                  ttok.hash_terms(words))


def test_size_class_matches():
    for n in (0, 1, 127, 128, 129, 1000, 5000, 1_004_721):
        for base, growth in ((128, 2), (512, 2), (100, 3)):
            assert (tlayouts.size_class(n, base, growth)
                    == rlayouts.size_class(n, base, growth))
