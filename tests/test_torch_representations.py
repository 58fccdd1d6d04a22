"""The paper's four representations in the port against the reference.

PR (``CooIndex``) and OR (``CsrIndex``) with both lookups of Table 6,
COR (``CompactCsrIndex``): the port's builds must equal the reference's
array for array (u32 as int32 bit-views), and so must their byte counts
and lookups.  The dense oracle (``make_scorer(engine="torch")``) over
all seven indexes of Table 7 must rank like the reference's ``jnp``
engine on the very same indexes (``index_from_numpy``): identical ids,
scores within rtol 1e-5, because the port computes its own idf and
``torch.log1p`` differs from XLA's in the last bit; the seven rankings
of the port agree to the bit among themselves.  ``conjunctive_filter``,
``BlockedIndex.contains`` and the paper's size model are held the same
way.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import build as rbuild, layouts as rlayouts  # noqa: E402
from repro.core import query as rquery, size_model as rsize  # noqa: E402
from repro.text import corpus as rcorpus  # noqa: E402
from repro_torch.core import layouts as tlayouts  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402
from repro_torch.core import size_model as tsize  # noqa: E402
from repro_torch.obs.registry import GLOBAL  # noqa: E402

K = 10
# Table 7's seven indexes: (reference build function, kind, keyword args)
SEVEN = {
    "pr_btree": ("build_coo", "coo", {"lookup": "btree"}),
    "pr_hash": ("build_coo", "coo", {"lookup": "hash"}),
    "or_btree": ("build_csr", "csr", {"lookup": "btree"}),
    "or_hash": ("build_csr", "csr", {"lookup": "hash"}),
    "cor": ("build_compact_csr", "compact_csr", {}),
    "hor": ("build_blocked", "hor", {}),
    "packed": ("build_packed_csr", "packed", {}),
}
RELATIONAL = ("pr_btree", "pr_hash", "or_btree", "or_hash", "cor")


@pytest.fixture(scope="module")
def host():
    return rbuild.bulk_build(rcorpus.generate(rcorpus.CorpusSpec(
        num_docs=600, vocab=500, avg_distinct=25, seed=7)))


@pytest.fixture(scope="module")
def ref_indexes(host):
    return {name: getattr(rlayouts, fn)(host, **kw)
            for name, (fn, _, kw) in SEVEN.items()}


def _port_host(h):
    return tlayouts.PostingsHost(**{f.name: getattr(h, f.name)
                                    for f in dataclasses.fields(h)})


def _np(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _lookup_dict(lk):
    kind = "sorted" if isinstance(lk, rlayouts.SortedLookup) else "hash"
    return {kind: {f.name: np.asarray(getattr(lk, f.name))
                   for f in dataclasses.fields(lk)}}


def _port_index(kind, ix):
    """The port's index over the reference index's own arrays."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(ix):
        v = getattr(ix, f.name)
        if v is None:
            continue
        if f.name == "docs":
            arrays.update(norm=np.asarray(v.norm), rank=np.asarray(v.rank))
        elif f.name == "lookup":
            arrays["lookup"] = _lookup_dict(v)
        elif f.name in type(ix)._static_fields:
            statics[f.name] = v
        else:
            arrays[f.name] = np.asarray(v)
    return tlayouts.index_from_numpy(kind, arrays, statics, device="cpu")


def _assert_fields_equal(ref, port):
    """Every field of a reference layout (or lookup) equals the port's:
    arrays to the bit (u32 as int32 bit-views), statics by value."""
    static = getattr(type(ref), "_static_fields", ())
    for f in dataclasses.fields(ref):
        want, got = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "docs":
            _assert_fields_equal(want, got)
        elif f.name == "lookup":
            assert type(got).__name__ == type(want).__name__
            _assert_fields_equal(want, got)
        elif f.name in static:
            assert got == want, f.name
        else:
            w = _np(want)
            g = got.numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, f.name
            assert np.array_equal(g, w), f.name


@pytest.mark.parametrize("name", RELATIONAL)
def test_builds_equal_reference(host, ref_indexes, name):
    fn, _, kw = SEVEN[name]
    ref = ref_indexes[name]
    port = getattr(tlayouts, fn)(_port_host(host), device="cpu", **kw)
    _assert_fields_equal(ref, port)
    assert port.nbytes() == ref.nbytes()
    assert port.posting_bytes() == ref.posting_bytes()
    assert port.device.type == "cpu"


def _probe_hashes(host, rng):
    """Present, absent, zero and duplicate hashes, as u32 [4, 8]."""
    present = rng.choice(host.term_hashes, size=12, replace=False)
    taken = set(int(x) for x in host.term_hashes)
    absent = [x for x in rng.integers(1, 2**32, size=64, dtype=np.uint64)
              if int(x) not in taken][:10]
    absent += [0xFFFFFFFF, 0xFFFFFFFE]
    qh = np.concatenate([present, np.asarray(absent, np.uint64),
                         np.zeros(4), present[:4]]).astype(np.uint32)
    return qh.reshape(4, 8)


@pytest.mark.parametrize("name", [*RELATIONAL, "hor", "packed"])
def test_lookup_terms_equal_reference(host, ref_indexes, name):
    ref = ref_indexes[name]
    port = _port_index(SEVEN[name][1], ref)
    qh = _probe_hashes(host, np.random.default_rng(3))
    # the reference looks up one query [T] at a time (its hash lookup
    # takes 1-D hashes); the port takes the batch [B, T] at once
    want = np.array(ref.lookup_terms(jnp.asarray(qh.reshape(-1))))
    got = port.lookup_terms(tlayouts.hash_tensor(qh)).numpy()
    assert np.array_equal(got.reshape(-1), want)
    flat = want
    assert (flat[:12] >= 0).all() and (flat[12:24] == -1).all()
    assert np.array_equal(flat[28:], flat[:4])
    tids = torch.from_numpy(want)
    assert np.array_equal(port.term_df(tids).numpy(),
                          np.asarray(ref.term_df(jnp.asarray(want))))


def test_hash_lookup_grows_past_max_probes():
    """Twenty hashes with one home slot in every table of up to 4096
    slots: the build must grow the table until the 17th key fits within
    MAX_PROBES, and both packages must agree on the table and on every
    lookup."""
    hashes = (1 + 4096 * np.arange(20, dtype=np.uint64)).astype(np.uint32)
    ref = rlayouts.build_hash_lookup(hashes)
    port = tlayouts.build_hash_lookup(hashes, device="cpu")
    assert tlayouts.MAX_PROBES == rlayouts.MAX_PROBES == 16
    assert port.keys.shape[0] == ref.keys.shape[0] > 128
    _assert_fields_equal(ref, port)
    probe = np.concatenate([hashes, hashes + 1, [0, 0xFFFFFFFF]]).astype(
        np.uint32)
    want = np.asarray(ref.lookup(jnp.asarray(probe)))
    got = port.lookup(tlayouts.hash_tensor(probe)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(want[:20], np.arange(20))


def test_lookup_builds_equal_reference(host):
    for ref, port in ((rlayouts.build_sorted_lookup(host.term_hashes),
                       tlayouts.build_sorted_lookup(host.term_hashes,
                                                    device="cpu")),
                      (rlayouts.build_hash_lookup(host.term_hashes),
                       tlayouts.build_hash_lookup(host.term_hashes,
                                                  device="cpu"))):
        _assert_fields_equal(ref, port)
        assert port.nbytes() == ref.nbytes()
    with pytest.raises(ValueError, match="unknown lookup"):
        tlayouts.build_lookup(host.term_hashes, "gin", device="cpu")


def _queries(host):
    """Table 7's protocol, small: 1-4 term queries from the df band, plus
    a batch with an absent hash, an empty slot and a duplicate."""
    out = [rcorpus.sample_query_terms(host.df, host.term_hashes, 8, n,
                                      num_docs=host.num_docs, seed=n)
           for n in (1, 2, 3, 4)]
    mixed = out[3].copy()
    mixed[0, 1] = 12345
    mixed[1, 2] = 0
    mixed[2, 3] = mixed[2, 0]
    return out + [mixed]


@pytest.mark.parametrize("name", list(SEVEN))
def test_score_queries_equal_reference(host, ref_indexes, name):
    ref = ref_indexes[name]
    port = _port_index(SEVEN[name][1], ref)
    cap = host.max_posting_len
    for qh in _queries(host):
        want = rquery.make_scorer(ref, k=K, cap=cap)(jnp.asarray(qh))
        got = tquery.make_scorer(port, k=K, cap=cap, engine="torch")(qh)
        np.testing.assert_array_equal(got.doc_ids.numpy(),
                                      np.asarray(want.doc_ids))
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), rtol=1e-5,
                                   atol=0)


def test_seven_representations_rank_alike(host):
    """Built by the port, the seven indexes give the same ids and the
    same scores to the bit (same postings, same order of adds), at a
    full cap and at a cap that cuts the lists mid-block."""
    th = _port_host(host)
    ixs = {name: getattr(tlayouts, fn)(th, device="cpu", **kw)
           for name, (fn, _, kw) in SEVEN.items()}
    for cap in (host.max_posting_len, 37):
        for qh in _queries(host):
            res = {n: tquery.make_scorer(ix, k=K, cap=cap)(qh)
                   for n, ix in ixs.items()}
            base = res["pr_btree"]
            for n, r in res.items():
                assert torch.equal(r.doc_ids, base.doc_ids), n
                assert torch.equal(r.scores.view(torch.int32),
                                   base.scores.view(torch.int32)), n


def test_coo_gather_reads_the_heap(host, ref_indexes):
    """PR's q_occ equals the reference's: the same (doc, tf, valid) for
    present, absent and capped terms."""
    ref = ref_indexes["pr_btree"]
    port = _port_index("coo", ref)
    tids = np.array([[0, 5, -1, 17], [3, 3, 40, -1]], np.int32)
    for cap in (host.max_posting_len, 9):
        for row in tids:
            want = ref.gather_postings(jnp.asarray(row), cap)
            got = port.gather_postings(torch.from_numpy(row), cap)
            for w, g in zip(want, got):
                assert np.array_equal(g.numpy(), np.asarray(w))
        got_b = port.gather_postings(torch.from_numpy(tids), 9)
        assert got_b[0].shape == (2, 4, 9)


_ref_conjunctive = jax.jit(rquery.conjunctive_filter,
                           static_argnames=("k", "cap"))


@pytest.mark.parametrize("name", list(SEVEN))
def test_conjunctive_filter_equal_reference(host, ref_indexes, name):
    ref = ref_indexes[name]
    port = _port_index(SEVEN[name][1], ref)
    qs = _queries(host)
    min_df = int(host.df[host.df > 0].min())
    df_q = np.sort(host.df[np.isin(host.term_hashes, qs[1])])
    # full lists, a cap below some query terms' df (truncation), and a
    # cap below every df
    for cap in (host.max_posting_len, int(df_q[len(df_q) // 2]),
                max(min_df - 1, 1)):
        for qh in (qs[0][0], qs[1][0], qs[1][3], qs[4][0], qs[4][2]):
            want, wstats = _ref_conjunctive(ref, jnp.asarray(qh), k=K,
                                            cap=cap)
            before = GLOBAL.counter("engine_truncated_terms").value
            got, gstats = tquery.conjunctive_filter(port, qh, k=K, cap=cap)
            assert gstats["truncated_terms"] == int(wstats["truncated_terms"])
            assert (GLOBAL.counter("engine_truncated_terms").value - before
                    == gstats["truncated_terms"])
            np.testing.assert_array_equal(got.doc_ids.numpy(),
                                          np.asarray(want.doc_ids))
            np.testing.assert_allclose(got.scores.numpy(),
                                       np.asarray(want.scores), rtol=1e-5,
                                       atol=0)


def test_conjunctive_truncation_is_reported(host, ref_indexes):
    port = _port_index("csr", ref_indexes["or_btree"])
    qh = _queries(host)[1][0]
    _, full = tquery.conjunctive_filter(port, qh, k=K,
                                        cap=host.max_posting_len)
    _, cut = tquery.conjunctive_filter(port, qh, k=K, cap=1)
    assert full["truncated_terms"] == 0
    assert cut["truncated_terms"] == 2


def test_contains_equal_reference(host, ref_indexes):
    ref = ref_indexes["hor"]
    port = _port_index("hor", ref)
    rng = np.random.default_rng(5)
    tids = np.array([0, 3, 99, -1, int(np.argmax(ref.df))], np.int32)
    for doc in list(rng.integers(0, host.num_docs, size=12)) + [
            0, host.num_docs - 1]:
        want = np.asarray(ref.contains(jnp.asarray(tids), jnp.int32(doc)))
        got = port.contains(torch.from_numpy(tids), int(doc)).numpy()
        assert np.array_equal(got, want)
    # a doc that holds a term is found in that term's blocks
    d0 = int(np.asarray(ref.block_docs)[int(ref.block_offsets[3]), 0])
    assert bool(port.contains(torch.tensor([3], dtype=torch.int32), d0)[0])


@pytest.mark.parametrize("stats", [
    (1_004_721, 216_449, 1_004_721 * 239, 1_004_721 * 239 * 3),
    (600, 500, 14_873, 40_000), (1, 1, 1, 0)])
def test_size_model_equals_reference(stats):
    rs, ts = rsize.CorpusStats(*stats), tsize.CorpusStats(*stats)
    for positions in (False, True):
        assert tsize.pr_bytes(ts, positions) == rsize.pr_bytes(rs, positions)
        assert (tsize.orif_bytes(ts, positions)
                == rsize.orif_bytes(rs, positions))
        assert (tsize.pr_over_orif(ts, positions)
                == rsize.pr_over_orif(rs, positions))
    for fn in ("coo_layout_bytes", "csr_layout_bytes",
               "packed_csr_layout_bytes"):
        assert getattr(tsize, fn)(ts) == getattr(rsize, fn)(rs)
    assert tsize.packed_csr_layout_bytes(ts, mean_bits=7.5) == \
        rsize.packed_csr_layout_bytes(rs, mean_bits=7.5)
    for n in (0, 1, 8191, 8192, 8193, tsize.pr_bytes(ts)):
        assert tsize.pages(n) == rsize.pages(n)
    assert tsize.PAPER_COLLECTION == tsize.CorpusStats(
        **dataclasses.asdict(rsize.PAPER_COLLECTION))


def test_posting_bytes_match_the_size_model(host):
    """The analytic posting bytes of PR and OR/COR are exact for the
    port's builds, as Table 5 prints them."""
    th = _port_host(host)
    st = tsize.SegmentStats(num_docs=host.num_docs,
                            num_postings=host.num_postings,
                            num_terms=host.num_terms)
    assert tlayouts.build_coo(th, device="cpu").posting_bytes() == \
        tsize.est_posting_bytes(st, "pr")
    for fn in ("build_csr", "build_compact_csr"):
        assert getattr(tlayouts, fn)(th, device="cpu").posting_bytes() == \
            tsize.est_posting_bytes(st, "or")


def test_segment_primitives_equal_reference():
    """The CSR primitives the layouts gather with: offsets and segment
    ids, and one slab or a batch of slabs into a fixed capacity, with
    empty segments, a capacity below a segment's length and 2-D values."""
    from repro.core import segments as rseg
    from repro_torch.core import segments as tseg
    lengths = np.array([3, 0, 5, 1, 0, 7], np.int32)
    want = np.asarray(rseg.lengths_to_offsets(jnp.asarray(lengths)))
    offsets = tseg.lengths_to_offsets(torch.from_numpy(lengths))
    assert offsets.dtype == torch.int32
    assert np.array_equal(offsets.numpy(), want)
    for cap in (16, 20):
        assert np.array_equal(
            tseg.offsets_to_segment_ids(offsets, cap).numpy(),
            np.asarray(rseg.offsets_to_segment_ids(jnp.asarray(want), cap)))
    rng = np.random.default_rng(1)
    for values in (rng.random(16).astype(np.float32),
                   rng.integers(0, 9, (16, 3)).astype(np.int32)):
        for cap in (4, 8):
            for seg in range(6):
                w = rseg.gather_segment(jnp.asarray(values),
                                        jnp.asarray(want), seg, cap, fill=-1)
                g = tseg.gather_segment(torch.from_numpy(values), offsets,
                                        seg, cap, fill=-1)
                for a, b in zip(g, w):
                    assert np.array_equal(a.numpy(), np.asarray(b))
            segs = np.array([5, 0, 1, 2], np.int32)
            w = rseg.gather_segments(jnp.asarray(values), jnp.asarray(want),
                                     jnp.asarray(segs), cap)
            g = tseg.gather_segments(torch.from_numpy(values), offsets,
                                     torch.from_numpy(segs), cap)
            for a, b in zip(g, w):
                assert np.array_equal(a.numpy(), np.asarray(b))
