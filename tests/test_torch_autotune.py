"""The tuned-geometry path of the port against the reference: the two
tile reducers (``_tile_topk``, ``_tile_topk_bitonic``), the tuning
table and its sweep (``kernels.autotune``), the measured layout rung
(``size_model.LayoutCostModel``) and ``tune=`` through the engines, the
live index and the server.

Each port reducer and engine is held to its own reference counterpart,
never crosswise: the reference's two reducers give the same ids but
other value bits at signed zeros (successive maxima write the row's
maximum, +0.0 above -0.0; the bitonic sort moves each lane's own bits),
and its fused engine is up to 2 ulp from its oracle.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import build as rbuild, layouts as rlayouts  # noqa: E402
from repro.core import query as rquery, size_model as rsize  # noqa: E402
from repro.core.live_index import SegmentedIndex as RSegmented  # noqa: E402
from repro.kernels import autotune as rtune  # noqa: E402
from repro.kernels import fused_decode_score as rfds  # noqa: E402
from repro.text import corpus as rcorpus  # noqa: E402
from repro_torch.core import layouts as tlayouts  # noqa: E402
from repro_torch.core import query as tquery, size_model as tsize  # noqa: E402
from repro_torch.core import live_index as tlive  # noqa: E402
from repro_torch.kernels import autotune as ttune  # noqa: E402
from repro_torch.kernels import fused_decode_score as tfds  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serve import QueryServer, ServerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REDUCERS = ("successive", "bitonic")


@pytest.fixture(autouse=True)
def _clean_tables():
    """Every test starts from empty active tables in both packages and
    restores whatever was active before."""
    prev_r, prev_t = rtune.set_active(None), ttune.set_active(None)
    yield
    rtune.set_active(prev_r)
    ttune.set_active(prev_t)


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32).view(np.int32)


def _assert_reducer_parity(final, base, k_tile, tile, reducer):
    """The port's reducer against the reference's same reducer, on one
    [Q, tile] tile: ids equal, values equal to the bit."""
    want_v, want_i = rfds._tile_reduce(jnp.asarray(final), base, k_tile,
                                       tile, reducer)
    got_v, got_i = tfds._tile_reduce(
        torch.from_numpy(final),
        torch.full(final.shape[:1], base, dtype=torch.int32), k_tile, tile,
        reducer)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
    return got_v, got_i


# ---------------------------------------------------------------------------
# the two tile reducers, each against its reference counterpart
# ---------------------------------------------------------------------------


def _engineered_ties():
    """Many lanes share the maximum, over a 256-lane tile: 37 tied lanes,
    8 tied maxima mid-tile, a row of one value (the reference's case)."""
    final = np.full((4, 256), -np.inf, np.float32)
    final[:, ::7] = 1.0
    final[:, 128:136] = 2.5
    final[1] = 0.25
    return final, 512, 16, 256


def _signed_zero_rows():
    """Zeros of both signs tied at the top of a row, in both orders, and
    behind a positive value."""
    final = np.full((3, 8), -np.inf, np.float32)
    final[0, :4] = [0.0, -0.0, 0.0, -0.0]
    final[1, :4] = [-0.0, 0.0, -0.0, 0.0]
    final[2, :5] = [-0.0, 3.0, -0.0, 0.0, -0.0]
    return final, 0, 5, 8


def _nan_rows():
    """NaN final scores: a row whose only NaN is its last lane, a NaN
    among zeros of both signs, a negative NaN, and a row with none."""
    final = np.tile(np.float32([0.5, 2.0, -0.0, 0.0, 1.0, -np.inf, 3.0,
                                0.25]), (4, 1))
    final[0, 7] = np.nan
    final[1, 3] = np.nan
    final[2, 0] = -np.float32(np.nan)
    return final, 16, 4, 8


CASES = {
    "engineered_ties": _engineered_ties,
    "nan_rows": _nan_rows,
    "all_neg_inf": lambda: (np.full((3, 128), -np.inf, np.float32), 0, 8,
                            128),
    "signed_zeros": _signed_zero_rows,
    "whole_tile": lambda: (np.random.default_rng(1).standard_normal(
        (2, 64)).astype(np.float32), 64, 64, 64),
}


@pytest.mark.parametrize("reducer", REDUCERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_reducer_equals_reference(case, reducer):
    final, base, k_tile, tile = CASES[case]()
    v, i = _assert_reducer_parity(final, base, k_tile, tile, reducer)
    if case == "all_neg_inf":
        assert bool((i == -1).all())
    if case == "signed_zeros":
        # same ids from both reducers; other value bits, as in the
        # reference
        other = tfds._tile_reduce(torch.from_numpy(final),
                                  torch.zeros(3, dtype=torch.int32), k_tile,
                                  tile, REDUCERS[reducer == "successive"])
        assert torch.equal(other[1], i)
        assert not torch.equal(other[0].view(torch.int32),
                               v.view(torch.int32))


try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # pragma: no cover - optional dependency
    st = None

if st is not None:

    @st.composite
    def tile_cases(draw):
        tile = draw(st.sampled_from([1, 2, 8, 64, 128, 256]))
        q = draw(st.integers(1, 4))
        k_tile = draw(st.integers(1, tile))
        kind = draw(st.sampled_from(["random", "ties", "sparse", "zeros"]))
        rng = np.random.default_rng(draw(st.integers(0, 2**16)))
        if kind == "random":
            final = rng.standard_normal((q, tile)).astype(np.float32)
        elif kind == "ties":
            final = rng.choice(np.float32([0.0, 0.5, 1.0, 2.0]),
                               size=(q, tile)).astype(np.float32)
        elif kind == "zeros":
            final = rng.choice(np.float32([0.0, -0.0, -np.inf, 1.0]),
                               size=(q, tile)).astype(np.float32)
        else:
            final = np.full((q, tile), -np.inf, np.float32)
            idx = rng.choice(tile, size=draw(st.integers(0, tile)),
                             replace=False)
            final[:, idx] = rng.standard_normal(
                (q, len(idx))).astype(np.float32)
        base = draw(st.sampled_from([0, tile, 7 * tile]))
        return final, base, k_tile, tile

    @settings(max_examples=30, deadline=None)
    @given(case=tile_cases(), reducer=st.sampled_from(REDUCERS))
    def test_reducer_equals_reference_property(case, reducer):
        """PROPERTY: random tiles, heavy ties, mostly -inf rows and signed
        zeros: each port reducer gives its reference counterpart's ids and
        value bits."""
        _assert_reducer_parity(*case, reducer)


def test_reducer_geometry_is_checked():
    """The bitonic reducer refuses a tile that is not a power of two (the
    plain reducer, and both candidate wrappers before any work), an
    unknown reducer is refused, and so is a k_tile wider than the tile."""
    with pytest.raises(ValueError, match="power-of-two"):
        tfds._tile_topk_bitonic(torch.zeros(1, 96), torch.zeros(1), 8, 96)
    with pytest.raises(ValueError, match="power-of-two"):
        rfds._tile_topk_bitonic(jnp.zeros((1, 96), jnp.float32), 0, 8, 96)
    i32, f32 = torch.int32, torch.float32
    args = (torch.zeros(2, 128, dtype=i32), torch.zeros(2, 128, dtype=f32),
            torch.zeros(8, dtype=i32), torch.full((8,), 7, dtype=i32),
            torch.zeros(8, 8, dtype=f32), torch.zeros(8, dtype=i32),
            torch.ones(600), torch.zeros(600), torch.ones(8), 600, 8)
    with pytest.raises(ValueError, match="power-of-two"):
        tfds.fused_topk_blocked(*args, tile=96, reducer="bitonic")
    with pytest.raises(ValueError, match="unknown reducer"):
        tfds.fused_topk_blocked(*args, reducer="heap")
    with pytest.raises(ValueError, match="cannot emit"):
        tfds.fused_topk_blocked(*args[:-1], 600, tile=256)
    for k_tile in (0, 257):
        with pytest.raises(ValueError):
            tfds._check_k_tile(k_tile, 256)
    tfds._check_k_tile(256, 256)
    for k in (1, 8, 10, 300):
        for tile in (256, 512, 1024):
            for k_pad in (8, 64):
                assert tfds.default_k_tile(k, tile, k_pad) == \
                    rfds.default_k_tile(k, tile, k_pad)
    assert tfds.default_k_tile(300, tile=256) == 256
    assert ttune.TuneConfig(k_tile=4096).resolve_k_tile(10) == 512
    assert ttune.TuneConfig(k_tile=4).resolve_k_tile(10) == 16


def test_bitonic_smem_refused_by_name():
    """The shared-memory plan of the candidate kernels (``Plan`` in
    ``csrc/fused_score.cuh``, mirrored by ``fused_smem_bytes``): the
    bitonic epilogue's u16 lane array at Q = 32 and 1,024-doc tiles no
    longer fits a CTA, so that geometry is refused by name, while the
    successive epilogue still fits."""
    name = "fused_topk_blocked"
    tfds.check_smem(name, 32, 1024, 0, "successive")
    with pytest.raises(ValueError, match=r"fused_topk_blocked: Q=32 x "
                                         r"tile=1024 \(reducer='bitonic'\)"):
        tfds.check_smem(name, 32, 1024, 0, "bitonic")
    # the lane array is the only difference: 2 bytes per (query, doc)
    assert tfds.fused_smem_bytes(name, 16, 1024, 0, "bitonic") - \
        tfds.fused_smem_bytes(name, 16, 1024, 0) == 16 * 1024 * 2
    assert tfds.fused_smem_bytes("fused_topk_packed", 8, 512, 9) < \
        tfds.SMEM_LIMIT


# ---------------------------------------------------------------------------
# tuned geometries through the fused engine, paired with the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    """A 700-doc corpus, its HOR and packed indexes in both packages, and
    a batch of 4 queries x 3 terms."""
    host = rbuild.bulk_build(rcorpus.generate(rcorpus.CorpusSpec(
        num_docs=700, vocab=900, avg_distinct=30, seed=13)))
    qh = rcorpus.sample_query_terms(host.df, host.term_hashes, 4, 3,
                                    num_docs=host.num_docs, seed=5)
    out = {"host": host, "qh": qh}
    for kind, build in (("hor", rlayouts.build_blocked),
                        ("packed", rlayouts.build_packed_csr)):
        ix = build(host)
        out[kind] = (ix, _port_index(kind, ix))
    return out


def _port_index(kind, ix):
    arrays, statics = {}, {}
    for f in dataclasses.fields(ix):
        v = getattr(ix, f.name)
        if f.name == "docs":
            arrays.update(norm=np.asarray(v.norm), rank=np.asarray(v.rank))
        elif f.name in type(ix)._static_fields:
            statics[f.name] = v
        else:
            arrays[f.name] = np.asarray(v)
    return tlayouts.index_from_numpy(kind, arrays, statics, device="cpu")


TUNED = {
    "tile256": dict(tile=256),
    "tile1024": dict(tile=1024),
    "bitonic": dict(reducer="bitonic"),
    "pps2": dict(pairs_per_step=2),
    "pps4_bitonic": dict(pairs_per_step=4, reducer="bitonic"),
    "q_pad16": dict(q_pad=16),
    "k_tile32": dict(k_tile=32),
    "k_tile32_bitonic": dict(k_tile=32, reducer="bitonic"),
}


@pytest.mark.parametrize("layout", ["hor", "packed"])
@pytest.mark.parametrize("tuned", sorted(TUNED))
def test_tuned_geometry_equals_reference(small, layout, tuned):
    """Each tuned geometry: the port's fused engine gives the reference's
    tuned fused engine's ids and score bits (paired), and the port's
    default geometry's too (the reference's bit-parity contract, and
    other tiles rank alike)."""
    ix, tix = small[layout]
    cap = small["host"].max_posting_len
    qh = small["qh"]
    kw = dict(k=10, cap=cap)
    want = rquery.make_scorer(ix, engine="pallas",
                              tune=rtune.TuneConfig(**TUNED[tuned]),
                              **kw)(jnp.asarray(qh))
    got = tquery.make_scorer(tix, engine="fused",
                             tune=ttune.TuneConfig(**TUNED[tuned]), **kw)(qh)
    base = tquery.make_scorer(tix, engine="fused", **kw)(qh)
    for g in (got, base):
        np.testing.assert_array_equal(g.doc_ids.numpy(),
                                      np.asarray(want.doc_ids))
    np.testing.assert_array_equal(_bits(got.scores), _bits(want.scores))
    np.testing.assert_array_equal(_bits(got.scores), _bits(base.scores))


def test_bitonic_entry_reaches_the_bitonic_reducer(small, monkeypatch):
    """A bitonic table entry is never downgraded: on the CPU it reaches
    the plain bitonic reducer (the card's test launches the kernel), and
    the answer is the default table's."""
    ix, tix = small["hor"]
    cap = small["host"].max_posting_len
    calls = []
    real = tfds._tile_topk_bitonic
    monkeypatch.setattr(tfds, "_tile_topk_bitonic",
                        lambda *a: calls.append(1) or real(*a))
    base = tquery.make_scorer(tix, k=10, cap=cap, engine="fused")(small["qh"])
    assert not calls
    table = ttune.TuningTable()
    table.put("cpu", ttune.size_class_of(int(tix.docs.num_docs)), "hor",
              ttune.TuneConfig(reducer="bitonic"))
    ttune.set_active(table)
    assert ttune.lookup("cpu", int(tix.docs.num_docs), "hor").reducer == \
        "bitonic"
    got = tquery.make_scorer(tix, k=10, cap=cap, engine="fused")(small["qh"])
    assert calls
    assert torch.equal(got.doc_ids, base.doc_ids)
    assert torch.equal(got.scores.view(torch.int32),
                       base.scores.view(torch.int32))
    assert not hasattr(ttune, "downgrade_reducer")


# ---------------------------------------------------------------------------
# the tuning table
# ---------------------------------------------------------------------------


def test_tuning_table_round_trip_and_schema(tmp_path):
    """put / get / cost, a save-load round trip that both packages read
    alike, and a foreign schema refused."""
    t = ttune.TuningTable()
    t.put("cuda", 2048, "hor", ttune.TuneConfig(tile=1024, pairs_per_step=2),
          cost_s=1e-4)
    t.put("cpu", 512, "packed", ttune.TuneConfig(reducer="bitonic"))
    assert len(t) == 2
    assert t.cost("cuda", 2048, "hor") == pytest.approx(1e-4)
    assert t.cost("cuda", 4096, "hor") is None      # exact class only
    assert t.cost("cpu", 512, "packed") is None     # never timed
    p = tmp_path / "table.json"
    t.save(str(p))
    t2 = ttune.TuningTable.load(str(p))
    assert t2.to_dict() == t.to_dict()
    assert t2.get("cuda", 2048, "hor") == ttune.TuneConfig(
        tile=1024, pairs_per_step=2)
    assert rtune.TuningTable.load(str(p)).to_dict() == t.to_dict()
    assert json.loads(p.read_text())["schema"] == ttune.TUNE_SCHEMA == \
        rtune.TUNE_SCHEMA
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "other/9", "entries": []}))
    with pytest.raises(ValueError, match="schema"):
        ttune.TuningTable.load(str(bad))


def test_reference_table_loads_and_never_matches_cuda():
    """The reference's committed CPU sweep loads into the port's table as
    it loads into the reference's; its ``pallas`` / ``xla`` entries are
    there by their keys, and a ``cuda`` lookup never matches them."""
    path = ROOT / "benchmarks" / "artifacts" / "TUNED_cpu.json"
    t = ttune.TuningTable.load(str(path))
    assert t.to_dict() == rtune.TuningTable.load(str(path)).to_dict()
    assert len(t) > 0
    for e in t.to_dict()["entries"]:
        assert e["backend"] in ("pallas", "xla")
        assert t.get(e["backend"], e["size_class"], e["layout"]) == \
            ttune.TuneConfig.from_dict(e["config"])
        assert t.lookup("cuda", e["size_class"], e["layout"]) == \
            ttune.DEFAULT_CONFIG


def test_lookup_falls_back_then_defaults(monkeypatch):
    """The nearest smaller tuned class of the same (device type, layout),
    else the defaults; an empty table gives the defaults;
    ``REPRO_REDUCER`` forces the reducer and refuses an unknown one."""
    t = ttune.TuningTable()
    cfg = ttune.TuneConfig(pairs_per_step=2)
    t.put("cuda", ttune.size_class_of(1000), "hor", cfg)
    assert t.lookup("cuda", 500_000, "hor") == cfg
    assert t.lookup("cuda", 500, "hor") == ttune.DEFAULT_CONFIG
    assert t.lookup("cuda", 500_000, "packed") == ttune.DEFAULT_CONFIG
    assert t.lookup("cpu", 500_000, "hor") == ttune.DEFAULT_CONFIG
    assert ttune.lookup("cuda", 123_456, "hor") == ttune.DEFAULT_CONFIG
    assert ttune.DEFAULT_CONFIG.to_dict() == rtune.DEFAULT_CONFIG.to_dict()
    assert ttune.size_class_of(123_456) == rtune.size_class_of(123_456)
    prev = ttune.set_active(t)
    assert ttune.get_active() is t and len(prev) == 0
    assert ttune.lookup("cuda", 500_000, "hor") == cfg
    assert ttune.set_active(None) is t and len(ttune.get_active()) == 0
    monkeypatch.setenv("REPRO_REDUCER", "bitonic")
    assert ttune.lookup("cpu", 1000, "hor").reducer == "bitonic"
    monkeypatch.setenv("REPRO_REDUCER", "nope")
    with pytest.raises(ValueError, match="REPRO_REDUCER"):
        ttune.lookup("cpu", 1000, "hor")


def test_candidate_configs_are_the_reference_grid():
    for k in (1, 10, 64, 600):
        assert [c.to_dict() for c in ttune.candidate_configs(k)] == \
            [c.to_dict() for c in rtune.candidate_configs(k)]
    grid = ttune.candidate_configs(10)
    assert len(grid) == 8 and grid[0] == ttune.DEFAULT_CONFIG


def test_autotune_index_stores_the_winner(small):
    """The sweep on the CPU's plain path: one record per config with its
    median and candidate bytes (the reference's size model), the winner
    stored under ("cpu", class, layout) with its median seconds."""
    _, tix = small["packed"]
    qh_dev = tlayouts.hash_tensor(small["qh"], "cpu")
    tids, idf_w = tquery.lookup_query(tix, qh_dev)
    table = ttune.TuningTable()
    configs = [ttune.DEFAULT_CONFIG, ttune.TuneConfig(pairs_per_step=2),
               ttune.TuneConfig(reducer="bitonic")]
    best, records = ttune.autotune_index(tix, qh_dev, idf_w, k=10,
                                         configs=configs, reps=1, warmup=1,
                                         table=table)
    assert [r["config"] for r in records] == [c.to_dict() for c in configs]
    assert all(r["median_s"] > 0 for r in records)
    assert records[0]["is_default"] and not records[1]["is_default"]
    assert [r["candidate_bytes_per_query"] for r in records] == [
        rsize.candidate_bytes_per_query(int(tix.docs.num_docs), 512, 16)] * 3
    cls_ = ttune.size_class_of(int(tix.docs.num_docs))
    assert table.get("cpu", cls_, "packed") == best
    best_rec = [r for r in records if r["config"] == best.to_dict()][0]
    assert table.cost("cpu", cls_, "packed") == best_rec["median_s"]


# ---------------------------------------------------------------------------
# routing budgets under pairs_per_step
# ---------------------------------------------------------------------------


def test_padded_pairs_budget_covers_run_alignment():
    """The reference's corpus where a budget exact at one pair per step
    drops a real pair under two (run-aligned padding): the port's
    ``padded_pairs_budget`` equals the reference's and drops none."""
    host = rbuild.bulk_build(rcorpus.generate(rcorpus.CorpusSpec(
        num_docs=2600, vocab=80, avg_distinct=20, seed=1)))
    ix = rlayouts.build_blocked(host)
    tix = _port_index("hor", ix)
    cap = host.max_posting_len
    th = host.term_hashes
    qh = torch.from_numpy(th[th != 0][None, :].view(np.int32).copy())
    tids = torch.where(qh != 0, tix.lookup_terms(qh), -1)
    m = min(max(-(-cap // tix.block), 1), max(tix.max_blocks_per_term, 1))
    cb, cv, cq, cw, cc = tops.expand_block_candidates(
        tix.block_offsets, tids, torch.ones(tids.shape), m, tix.block, cap)
    tf, tcn, n_tiles = tops.routing_spans(tix, 512)

    def overflow_at(mp):
        *_, ovf = tfds.build_batched_pairs(cb, cv, cq, cw, tf, tcn, n_tiles,
                                           1, mp, cand_cap=cc,
                                           pairs_per_step=2)
        return int(ovf)

    from repro.kernels import ops as rops
    padded = tops.padded_pairs_budget(tix, 512, 2)
    assert padded == rops.padded_pairs_budget(ix, 512, 2)
    assert overflow_at(tops.round_up_pairs(
        tops.scaled_pairs_budget(tix, 512), 2)) > 0
    assert overflow_at(padded) == 0


# ---------------------------------------------------------------------------
# tune= through the live index, make_scorer and the server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def live():
    """A small live index in both packages (three sealed HOR segments of
    150 docs and a delta), a batch over it, and each package's default
    answer (the port's fused engine, the reference's Pallas engine)."""
    spec = rcorpus.CorpusSpec(num_docs=600, vocab=500, avg_distinct=22,
                              seed=17)
    kw = dict(delta_doc_capacity=128, delta_posting_capacity=128 * 64)
    ref = RSegmented(**kw)
    port = tlive.SegmentedIndex(device="cpu", **kw)
    for b in rcorpus.stream_batches(spec, batch_docs=150):
        ref.add_batch(b)
        port.add_batch(b)
    qh = rcorpus.sample_query_terms(
        np.asarray(ref.view().df), np.asarray(ref.view().hashes), 5, 3,
        num_docs=spec.num_docs, seed=2)
    want = ref.topk(qh, 10)
    got = port.topk(qh, 10)
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    np.testing.assert_array_equal(_bits(got.scores), _bits(want.scores))
    return {"ref": ref, "port": port, "qh": qh, "want": want}


LIVE_TUNE = dict(reducer="bitonic", pairs_per_step=2, k_tile=32)


def _assert_same(got, want):
    ids = got.doc_ids.numpy() if isinstance(got.doc_ids, torch.Tensor) \
        else np.asarray(got.doc_ids)
    np.testing.assert_array_equal(ids, np.asarray(want.doc_ids))
    np.testing.assert_array_equal(_bits(got.scores), _bits(want.scores))


def test_live_index_with_tuned_table_equals_reference(live):
    """The reference's ``test_live_view_with_tuned_table_matches_default``
    with a ``"cpu"`` key: a table that moves every sealed segment to a
    tuned geometry (bitonic, two pairs per step, k_tile 32) leaves the
    live index's answer, held to the reference's tuned one (a
    ``"pallas"`` key) and to the default one, to the bit."""
    port, ref, qh = live["port"], live["ref"], live["qh"]
    tt, rt = ttune.TuningTable(), rtune.TuningTable()
    for seg in port.view().segments:
        cls_ = ttune.size_class_of(int(seg.index.docs.num_docs))
        tt.put("cpu", cls_, seg.layout, ttune.TuneConfig(**LIVE_TUNE))
        rt.put("pallas", cls_, seg.layout, rtune.TuneConfig(**LIVE_TUNE))
    ttune.set_active(tt)
    rtune.set_active(rt)
    tuned_ref = ref.topk(qh, 10)
    got, stats = port.topk(qh, 10, return_stats=True)
    assert stats["pair_overflow"] == 0
    _assert_same(got, tuned_ref)
    _assert_same(got, live["want"])


def test_seal_routes_at_the_tuned_tile():
    """A seal builds its segment's routing cache at the tile the active
    table gives its (device type, size class, layout), as the
    reference's seal does for its backend, and the answer is the
    reference's."""
    tc = rcorpus.generate(rcorpus.CorpusSpec(num_docs=300, vocab=200,
                                             avg_distinct=15, seed=4))
    kw = dict(delta_doc_capacity=512, delta_posting_capacity=512 * 64)
    ref, port = RSegmented(**kw), tlive.SegmentedIndex(device="cpu", **kw)
    tt, rt = ttune.TuningTable(), rtune.TuningTable()
    cls_ = ttune.size_class_of(512)
    tt.put("cpu", cls_, "hor", ttune.TuneConfig(tile=256))
    rt.put("pallas", cls_, "hor", rtune.TuneConfig(tile=256))
    ttune.set_active(tt)
    rtune.set_active(rt)
    for si in (ref, port):
        si.add_batch(tc)
        si.seal()
    seg, = port.view().segments
    assert seg.index.route_tile == 256 == ref.segments()[0].index.route_tile
    qh = rcorpus.sample_query_terms(np.asarray(ref.view().df),
                                    np.asarray(ref.view().hashes), 4, 3,
                                    num_docs=300, seed=1)
    _assert_same(port.topk(qh, 10), ref.topk(qh, 10))


@pytest.mark.parametrize("how", ["view", "segmented", "make_scorer"])
def test_tune_override_equals_reference(live, how):
    """``tune=`` for every segment, through ``LiveView.topk``,
    ``SegmentedIndex.topk`` and ``make_scorer`` over a SegmentedIndex,
    gives the reference's tuned answer and the untuned one, with no
    routing overflow at two pairs per step; ``max_pairs`` is still
    refused for a SegmentedIndex, as in the reference."""
    port, ref, qh = live["port"], live["ref"], live["qh"]
    cfg = ttune.TuneConfig(**LIVE_TUNE)
    want = ref.topk(qh, 10, tune=rtune.TuneConfig(**LIVE_TUNE))
    if how == "view":
        got, stats = port.view().topk(qh, 10, tune=cfg, return_stats=True)
    elif how == "segmented":
        got, stats = port.topk(qh, 10, tune=cfg, return_stats=True)
    else:
        got, stats = tquery.make_scorer(port, k=10, cap=None, engine="fused",
                                        return_stats=True, tune=cfg)(qh)
        with pytest.raises(ValueError, match="max_pairs"):
            tquery.make_scorer(port, k=10, cap=None, max_pairs=8)
    assert stats["pair_overflow"] == 0
    _assert_same(got, want)
    _assert_same(got, live["want"])


def test_server_with_tune_answers_as_untuned(live):
    """``ServerConfig(tune=...)`` serves each query with the untuned
    server's ids and score bits."""
    port, qh = live["port"], live["qh"]
    answers = []
    for tune in (None, ttune.TuneConfig(**LIVE_TUNE)):
        server = QueryServer(port, ServerConfig(batch_size=8,
                                                n_terms_budget=8, k=10,
                                                tune=tune))
        tickets = [server.submit(row) for row in qh]
        while server.pending:
            server.pump()
        answers.append([t.result() for t in tickets])
        server.stop()
    assert ServerConfig(tune=ttune.DEFAULT_CONFIG).tune == \
        ttune.DEFAULT_CONFIG
    for a, b in zip(*answers):
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        np.testing.assert_array_equal(_bits(a.scores), _bits(b.scores))


# ---------------------------------------------------------------------------
# the measured layout rung
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("swept", ["both", "hor_only", "none"])
def test_measured_rung_reason_equals_reference(swept):
    """The reference's measured and partial-sweep reasons
    (``tests/test_layout_policy.py``), character for character with the
    device type where the reference names its backend; the seal path's
    ``resolve_layout`` reads the same rung."""
    tt, rt = ttune.TuningTable(), rtune.TuningTable()
    costs = {"both": {"hor": 1e-4, "packed": 5e-4},
             "hor_only": {"hor": 1e-4}, "none": {}}[swept]
    for layout, c in costs.items():
        tt.put("cuda", 2048, layout, ttune.TuneConfig(tile=1024), cost_s=c)
        rt.put("pallas", 2048, layout, rtune.TuneConfig(tile=1024), cost_s=c)
    ttune.set_active(tt)
    rtune.set_active(rt)
    big_t = tsize.SegmentStats(2_000, 60_000, 500)
    big_r = rsize.SegmentStats(2_000, 60_000, 500)
    got = tsize.LayoutCostModel(min_packed_docs=64).choose(big_t,
                                                           size_class=2048)
    want = rsize.LayoutCostModel(min_packed_docs=64).choose(big_r,
                                                            size_class=2048)
    assert got.layout == want.layout
    assert got.reason == want.reason.replace("measured:pallas",
                                             "measured:cuda")
    assert tsize.LayoutCostModel(min_packed_docs=64).measured_cost_s(
        "cuda", 2048, "hor") == costs.get("hor")
    if swept == "both":
        assert got.layout == "hor" and got.reason.startswith(
            "measured:cuda@2048 hor=1.00e-04s packed=5.00e-04s")
    if swept == "hor_only":
        assert got.reason.startswith("analytic:partial-measured(hor) ")
    # another device type reads nothing measured
    other = tsize.LayoutCostModel(min_packed_docs=64).choose(
        big_t, size_class=2048, device_type="cpu")
    assert other.reason.startswith("analytic:bytes/q")
    assert tsize.resolve_layout(None, tsize.LayoutCostModel(
        min_packed_docs=64), big_t, "hor", size_class=2048) == \
        (got.layout, got.reason)
