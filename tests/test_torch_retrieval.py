"""Port vs reference for distributed retrieval: ``repro_torch.distributed``
(the one-controller mesh ``shmap``, the top-k merges, the doc- and
term-sharded engines, the sharded segment stack of the live index).

Both packages build from the same seeded corpus (``bulk_build`` of each
package; the two hosts are equal), and both live indexes from the same
ingest schedule.  The host builders are compared array for array at
S = 1-4 (301 docs, so the doc slices are uneven), the stack with a shard
that owns no segment.  Engines are paired, never crossed: the port's
fused engines against the reference's Pallas engines (interpret mode),
its oracle engines against the reference's jnp ones, ids and score
bits.  S = 1 runs in process on a one-device JAX mesh; S = 2 and 4 run
the reference in one subprocess with four host devices, which writes
its answers to an ``.npz``.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import build as rbuild, compaction as rcomp  # noqa: E402
from repro.core import live_index as rli  # noqa: E402
from repro.distributed import retrieval as rret, topk as rtopk  # noqa: E402
from repro.distributed.shmap import shard_map  # noqa: E402
from repro.kernels import autotune as rtune  # noqa: E402
from repro.text import corpus as rcorpus  # noqa: E402
from repro_torch.core import build as tbuild, compaction as tcomp  # noqa: E402
from repro_torch.core import live_index as tli  # noqa: E402
from repro_torch.distributed import retrieval as tret  # noqa: E402
from repro_torch.distributed import shmap, topk as ttopk  # noqa: E402
from repro_torch.kernels import autotune as ttune  # noqa: E402
from repro_torch.kernels import fused_decode_score as tfds  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.obs.registry import GLOBAL  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
K = 10
SPEC = dict(num_docs=301, vocab=500, avg_distinct=20, seed=5)
SUB_SHARDS = (2, 4)
CAP = 24                       # a posting cap some query terms exceed
# (name, reference builder, port builder, scorer kind)
ENGINES = (
    ("doc", "build_doc_sharded", "make_doc_sharded_scorer"),
    ("term", "build_term_sharded", "make_term_sharded_scorer"),
    ("doc_hor", "build_doc_sharded_blocked", "make_doc_sharded_fused_scorer"),
    ("doc_packed", "build_doc_sharded_packed",
     "make_doc_sharded_fused_scorer"),
    ("term_hor", "build_term_sharded_blocked",
     "make_term_sharded_fused_scorer"),
    ("term_packed", "build_term_sharded_packed",
     "make_term_sharded_fused_scorer"),
    ("term_banded", "build_term_sharded_banded",
     "make_term_sharded_fused_scorer"),
)
# the live schedule: (first doc, end, seal layout); then every 13th deleted
SCHEDULE = ((0, 300, "banded"), (300, 420, "hor"), (420, 520, "packed"),
            (520, 600, "hor"), (600, 700, "banded"))


# ---------------------------------------------------------------------------
# inputs both sides make the same way (the subprocess imports this module)
# ---------------------------------------------------------------------------


def _tc():
    return rcorpus.generate(rcorpus.CorpusSpec(**SPEC))


def _rows(host):
    """4 queries of 3 terms, then 4 of 8 (the serving width)."""
    qa = rcorpus.sample_query_terms(host.df, host.term_hashes, 4, 3,
                                    num_docs=host.num_docs, seed=3)
    qb = rcorpus.sample_query_terms(host.df, host.term_hashes, 4, 8,
                                    num_docs=host.num_docs, seed=4)
    return [*qa, *qb]


def _live_tc():
    return rcorpus.generate(rcorpus.CorpusSpec(num_docs=700, vocab=500,
                                               avg_distinct=20, seed=2))


def _live(li_mod, build_mod, comp_mod, **kw):
    """The live index of SCHEDULE: mixed banded, HOR and packed seals of
    several sizes, tombstones."""
    tc = _live_tc()
    si = li_mod.SegmentedIndex(
        term_hashes=tc.term_hashes, delta_doc_capacity=1000,
        policy=comp_mod.TieredPolicy(size_ratio=4.0, min_run=8), **kw)
    for a, b, lay in SCHEDULE:
        si.add_batch(build_mod.TokenizedCorpus(
            tc.doc_term_ids[a:b], tc.doc_counts[a:b], tc.term_hashes, b - a))
        si.seal(layout=lay)
    si.delete(np.arange(0, 700, 13))
    return si


def _live_rows(si):
    return rcorpus.sample_query_terms(np.asarray(si._df), si.term_hashes, 6,
                                      8, num_docs=700, seed=4)


def _mixed(seed=0, n=4096):
    """f32 lanes of mixed magnitude for the psum order."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, n)).astype(np.float32)
    return (x * (10.0 ** rng.integers(-4, 5, (4, n)))).astype(np.float32)


def _run_ref(scorer, rows, stats=False):
    vs, ids, trunc = [], [], []
    for row in rows:
        out = scorer(jnp.asarray(row))
        if stats:
            out, st = out
            trunc.append(st["truncated_terms"])
        vs.append(np.asarray(out[0]))
        ids.append(np.asarray(out[1]))
    return np.stack(vs), np.stack(ids), np.asarray(trunc, np.int64)


def reference_outputs(path):
    """The reference's answers at SUB_SHARDS, run where JAX has four
    host devices; saved to ``path`` (.npz)."""
    out = {}
    host = rbuild.bulk_build(_tc())
    rows = _rows(host)
    si = _live(rli, rbuild, rcomp)
    view = si.view()
    for s in SUB_SHARDS:
        mesh = jax.make_mesh((s,), ("s",))
        for name, b, m in ENGINES:
            sc = getattr(rret, m)(getattr(rret, b)(host, s), mesh, "s", k=K)
            out[f"{name}/{s}/v"], out[f"{name}/{s}/i"], _ = _run_ref(sc, rows)
        sc = rret.make_term_sharded_fused_scorer(
            rret.build_term_sharded_packed(host, s), mesh, "s", k=K, cap=CAP,
            return_stats=True)
        (out[f"cap/{s}/v"], out[f"cap/{s}/i"],
         out[f"cap/{s}/t"]) = _run_ref(sc, rows, stats=True)
        stack = rret.stack_segment_shards(view, s)
        sc = rret.make_doc_sharded_segment_scorer(stack, mesh, "s", k=K)
        out[f"stack/{s}/v"], out[f"stack/{s}/i"], _ = _run_ref(
            sc, _live_rows(si))
        v, i = rtopk.sharded_topk(mesh, "s")(K)(jnp.asarray(_mixed()[0]))
        out[f"sharded_topk/{s}/v"], out[f"sharded_topk/{s}/i"] = (
            np.asarray(v), np.asarray(i))
    mesh4 = jax.make_mesh((4,), ("s",))
    psum = jax.jit(shard_map(lambda x: jax.lax.psum(x[0], "s"), mesh=mesh4,
                             in_specs=(P("s"),), out_specs=P()))
    out["psum"] = np.asarray(psum(jnp.asarray(_mixed())))
    np.savez(path, **out)


# ---------------------------------------------------------------------------
# port-side helpers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hosts():
    tc = _tc()
    return rbuild.bulk_build(tc), tbuild.bulk_build(tc)


@pytest.fixture(scope="module")
def live_pair():
    return (_live(rli, rbuild, rcomp),
            _live(tli, tbuild, tcomp, device="cpu"))


@pytest.fixture(scope="module")
def ref_sub(tmp_path_factory):
    """The reference's answers at S = 2 and 4, from one subprocess."""
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('m', {__file__!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            f"m.reference_outputs({str(path)!r})\n")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(path))


def _cpu_mesh(s):
    return shmap.make_mesh(s, "s", device="cpu")


def _run_port(scorer, rows, stats=False):
    vs, ids, trunc = [], [], []
    for row in rows:
        out = scorer(row)
        if stats:
            out, st = out
            trunc.append(st["truncated_terms"])
        vs.append(out[0].numpy())
        ids.append(out[1].numpy())
    return np.stack(vs), np.stack(ids), np.asarray(trunc, np.int64)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _same(got, want_v, want_i):
    np.testing.assert_array_equal(got[1], want_i)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want_v))


def _equal_arrays(a, b):
    """Equal dtype, shape and bytes; the port keeps u32 as int32 views
    on the device, its host arrays are u32 like the reference's."""
    if isinstance(b, torch.Tensor):
        b = b.cpu().numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _equal_index(ref, port):
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(a, np.ndarray):
            _equal_arrays(a, b)
        else:
            assert a == b, f.name


# ---------------------------------------------------------------------------
# host builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("builder", [b for _, b, _ in ENGINES])
def test_host_builders_equal_reference(hosts, builder, s):
    """Every bulk builder gives the reference's arrays and statics, at
    even and uneven slices (301 docs over 2-4 shards)."""
    rhost, thost = hosts
    _equal_index(getattr(rret, builder)(rhost, s),
                 getattr(tret, builder)(thost, s))


def test_fused_front_door_ladder(hosts):
    rhost, thost = hosts
    for lay in (None, "hor", "packed"):
        ri, rr = rret.build_doc_sharded_fused(rhost, 2, layout=lay)
        ti, tr = tret.build_doc_sharded_fused(thost, 2, layout=lay)
        assert rr == tr and type(ri).__name__ == type(ti).__name__
        _equal_index(ri, ti)
    for bad, msg in (("banded", "segment-stack"), ("csr", "unknown")):
        with pytest.raises(ValueError, match=msg):
            tret.build_doc_sharded_fused(thost, 2, layout=bad)


@pytest.mark.parametrize("s", [1, 2, 4, 6])
def test_stack_equals_reference(live_pair, s):
    """The sharded stack's groups (metadata and every slot array, inert
    slots included) and its replicated vocabulary equal the reference's;
    at S = 6 the last shard owns no segment."""
    ref, port = live_pair
    a = rret.stack_segment_shards(ref.view(), s)
    b = tret.stack_segment_shards(port.view(), s)
    assert ([dataclasses.asdict(m) for m in a.signature()]
            == [dataclasses.asdict(m) for m in b.signature()])
    for (_, x), (_, y) in zip(a.groups, b.groups):
        assert x.keys() == y.keys()
        for n in x:
            _equal_arrays(x[n], y[n])
    _equal_arrays(a.vocab_hash, b.vocab_hash)
    _equal_arrays(a.vocab_df, b.vocab_df)
    assert (a.n_shards, a.live_docs, a.tile) == (b.n_shards, b.live_docs,
                                                 b.tile)
    if s == 6:
        assert not any(int(arr["tile_count"][5].sum())
                       for _, arr in b.groups)
    # the index itself stacks like its pinned view
    c = tret.stack_segment_shards(port, s)
    for (_, y), (_, z) in zip(b.groups, c.groups):
        for n in y:
            assert torch.equal(y[n], z[n])


def test_stack_refusals(live_pair):
    _, port = live_pair
    stack = tret.stack_segment_shards(port.view(), 2)
    with pytest.raises(ValueError, match="built for 2 shards"):
        tret.make_doc_sharded_segment_scorer(stack, _cpu_mesh(4), "s")
    with pytest.raises(ValueError, match="no axis"):
        tret.make_doc_sharded_segment_scorer(stack, _cpu_mesh(2), "data")
    tc = _live_tc()
    si = tli.SegmentedIndex(term_hashes=tc.term_hashes, device="cpu")
    with pytest.raises(ValueError, match="no sealed segments"):
        tret.stack_segment_shards(si.view(), 1)
    si.add_batch(tbuild.TokenizedCorpus(tc.doc_term_ids[:20],
                                        tc.doc_counts[:20], tc.term_hashes,
                                        20))
    with pytest.raises(ValueError, match="seal"):
        tret.stack_segment_shards(si, 1)
    with pytest.raises(ValueError, match="sealed delta"):
        tret.stack_segment_shards(si.view(), 1)


# ---------------------------------------------------------------------------
# engines: S = 1 in process, S = 2 and 4 against the subprocess
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,builder,maker", ENGINES)
def test_engine_equals_reference_in_process(hosts, name, builder, maker):
    rhost, thost = hosts
    rows = _rows(rhost)
    want = _run_ref(getattr(rret, maker)(getattr(rret, builder)(rhost, 1),
                                         jax.make_mesh((1,), ("s",)), "s",
                                         k=K), rows)
    got = _run_port(getattr(tret, maker)(getattr(tret, builder)(thost, 1),
                                         _cpu_mesh(1), "s", k=K), rows)
    _same(got, want[0], want[1])


@pytest.mark.parametrize("s", SUB_SHARDS)
@pytest.mark.parametrize("name,builder,maker", ENGINES)
def test_engine_equals_reference_sharded(hosts, ref_sub, name, builder,
                                         maker, s):
    _, thost = hosts
    got = _run_port(getattr(tret, maker)(getattr(tret, builder)(thost, s),
                                         _cpu_mesh(s), "s", k=K),
                    _rows(thost))
    _same(got, ref_sub[f"{name}/{s}/v"], ref_sub[f"{name}/{s}/i"])


@pytest.mark.parametrize("s", [1, *SUB_SHARDS])
def test_stack_scorer_equals_reference(live_pair, ref_sub, s):
    """Mixed banded, HOR and packed groups, inert slots, tombstones and
    8-slot queries: the port's stack scorer answers as the reference's
    Pallas program, ids and score bits."""
    ref, port = live_pair
    rows = _live_rows(port)
    got = _run_port(tret.make_doc_sharded_segment_scorer(
        tret.stack_segment_shards(port.view(), s), _cpu_mesh(s), "s", k=K),
        rows)
    if s == 1:
        want = _run_ref(rret.make_doc_sharded_segment_scorer(
            rret.stack_segment_shards(ref.view(), 1),
            jax.make_mesh((1,), ("s",)), "s", k=K), rows)
        _same(got, want[0], want[1])
    else:
        _same(got, ref_sub[f"stack/{s}/v"], ref_sub[f"stack/{s}/i"])
    # and ranks as the single-node pinned view does
    view_ids = port.view().topk(np.stack(rows), K).doc_ids.numpy()
    np.testing.assert_array_equal(got[1], view_ids)


@pytest.mark.parametrize("s", [1, *SUB_SHARDS])
def test_cap_truncation_summed_over_shards(hosts, ref_sub, s):
    """``cap`` truncates at posting granularity on every shard; the
    count of truncated terms is the sum over shards, returned and added
    to ``engine_truncated_terms``."""
    rhost, thost = hosts
    rows = _rows(thost)
    sc = tret.make_term_sharded_fused_scorer(
        tret.build_term_sharded_packed(thost, s), _cpu_mesh(s), "s", k=K,
        cap=CAP, return_stats=True)
    before = GLOBAL.counter("engine_truncated_terms").value
    got = _run_port(sc, rows, stats=True)
    if s == 1:
        want = _run_ref(rret.make_term_sharded_fused_scorer(
            rret.build_term_sharded_packed(rhost, 1),
            jax.make_mesh((1,), ("s",)), "s", k=K, cap=CAP,
            return_stats=True), rows, stats=True)
    else:
        want = tuple(ref_sub[f"cap/{s}/{x}"] for x in "vit")
    _same(got, want[0], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].sum() > 0
    assert (GLOBAL.counter("engine_truncated_terms").value - before
            == got[2].sum())


# ---------------------------------------------------------------------------
# the collectives and the query norm
# ---------------------------------------------------------------------------


def test_psum_is_the_sequential_sum_in_shard_order(ref_sub):
    """XLA's CPU psum over 4 host devices adds in shard order: the
    port's ``shmap.psum`` gives its bits on every lane, and the reverse
    order would not."""
    x = torch.from_numpy(_mixed())
    mesh = _cpu_mesh(4)
    got = shmap.psum(mesh, list(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref_sub["psum"]))
    rev = shmap.psum(mesh, list(x.flip(0))).numpy()
    assert (_bits(rev) != _bits(ref_sub["psum"])).any()


def test_all_gather_and_merges():
    """``all_gather`` concatenates in shard order; the merges keep the
    lowest id among equal values; ``canonicalize_candidates`` equals the
    reference's."""
    mesh = _cpu_mesh(3)
    parts = [torch.tensor([1.0, 2.0]), torch.tensor([3.0]),
             torch.tensor([2.0, 2.0])]
    assert shmap.all_gather(mesh, parts).tolist() == [1, 2, 3, 2, 2]
    rng = np.random.default_rng(1)
    v = rng.integers(0, 4, (3, 12)).astype(np.float32)
    v[v == 0] = -np.inf
    i = np.stack([rng.permutation(12) for _ in range(3)]).astype(np.int32)
    i[v == -np.inf] = -1
    a = rtopk.canonicalize_candidates(jnp.asarray(v), jnp.asarray(i))
    b = ttopk.canonicalize_candidates(torch.from_numpy(v), torch.from_numpy(i))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    vals = [torch.tensor([3.0, 1.0, 3.0]), torch.tensor([3.0, 2.0])]
    got = ttopk.local_topk_merge(vals, 4, _cpu_mesh(2), [0, 10])
    assert got[0].tolist() == [3, 3, 3, 2] and got[1].tolist() == [0, 2, 10,
                                                                   11]
    # k past a shard's length pads with -inf / -1
    got = ttopk.local_topk_merge([torch.tensor([1.0])], 3, _cpu_mesh(1), [5])
    assert got[1].tolist() == [5, -1, -1]


@pytest.mark.parametrize("s", [1, *SUB_SHARDS])
def test_sharded_topk_equals_reference(ref_sub, s):
    x = torch.from_numpy(_mixed()[0])
    got = ttopk.sharded_topk(_cpu_mesh(s), "s")(K)(x)
    if s == 1:
        want = rtopk.sharded_topk(jax.make_mesh((1,), ("s",)), "s")(K)(
            jnp.asarray(_mixed()[0]))
    else:
        want = (ref_sub[f"sharded_topk/{s}/v"], ref_sub[f"sharded_topk/{s}/i"])
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_mesh_placement():
    mesh = shmap.make_mesh(3, "x", device="cpu")
    assert mesh.shape == {"x": 3} and mesh.size == 3
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError):
        shmap.make_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            shmap.make_mesh(2, device="cuda")


def test_single_row_norm_at_widths_1_to_32():
    """One query's norm inside a shard program: XLA chains the squares
    as fused multiply-adds at every width (a single row never takes its
    vectorised row loop).  ``retrieval.row_norm`` (one ``query_norm``
    launch, 5-8 slots padded to 9) and ``norm_of(square_sum(w))`` give
    its bits; the batch rule of ``query.query_norm`` does not at 5-8
    slots, which is why the sharded engines do not use it bare."""
    from repro_torch.core import query as tquery
    mesh = jax.make_mesh((1,), ("s",))
    ref = jax.jit(shard_map(
        lambda w: jnp.sqrt(jnp.maximum(jnp.sum(w * w), 1e-12)), mesh=mesh,
        in_specs=(P(),), out_specs=P()))
    rng = np.random.default_rng(0)
    batch_differs = False
    for t in range(1, 33):
        w = (rng.random((40, t)) * rng.choice([1.0, 5.0, 13.0], (40, t))
             ).astype(np.float32)
        w[rng.random((40, t)) < 0.3] = 0
        want = np.stack([np.asarray(ref(jnp.asarray(r))) for r in w])
        tw = torch.from_numpy(w)
        got = torch.stack([tret.row_norm(r) for r in tw]).numpy()
        got2 = torch.stack([tret.norm_of(tret.square_sum(r))
                            for r in tw]).numpy()
        # the rows at once, as the term-sharded norm chains its shards'
        got3 = tret.norm_of(tret.square_sum(tw)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(got2), _bits(want))
        np.testing.assert_array_equal(_bits(got3), _bits(want))
        if 5 <= t <= 8:
            batch = tquery.query_norm(tw).numpy()
            batch_differs |= bool((_bits(batch) != _bits(want)).any())
    assert batch_differs


# ---------------------------------------------------------------------------
# tuning, inert slots, overflow
# ---------------------------------------------------------------------------


def test_bitonic_table_through_the_stack_scorer(live_pair, monkeypatch):
    """A loaded table with ``reducer="bitonic"`` for the stack's groups
    reaches the bitonic reducer (the candidate calls of the HOR and
    packed slots) and answers as the reference's bitonic program."""
    ref, port = live_pair
    rs, ts = (rret.stack_segment_shards(ref.view(), 1),
              tret.stack_segment_shards(port.view(), 1))
    rt, tt = rtune.TuningTable(), ttune.TuningTable()
    for m in ts.signature():
        cls = ttune.size_class_of(m.d_pad)
        rt.put("pallas", cls, m.layout, rtune.TuneConfig(reducer="bitonic"))
        tt.put("cpu", cls, m.layout, ttune.TuneConfig(reducer="bitonic"))
    calls = []
    real = tfds._tile_topk_bitonic
    monkeypatch.setattr(tfds, "_tile_topk_bitonic",
                        lambda *a: calls.append(1) or real(*a))
    rprev, tprev = rtune.set_active(rt), ttune.set_active(tt)
    try:
        rows = _live_rows(port)
        want = _run_ref(rret.make_doc_sharded_segment_scorer(
            rs, jax.make_mesh((1,), ("s",)), "s", k=K), rows)
        got = _run_port(tret.make_doc_sharded_segment_scorer(
            ts, _cpu_mesh(1), "s", k=K), rows)
    finally:
        rtune.set_active(rprev)
        ttune.set_active(tprev)
    _same(got, want[0], want[1])
    n_single = sum(m.n_slots for m in ts.signature()
                   if m.layout != "banded")
    assert len(calls) == len(rows) * n_single


def _count_kernel_calls(monkeypatch):
    calls = {}
    for n in ("fused_topk_blocked", "fused_topk_packed",
              "fused_score_blocked", "fused_score_packed"):
        real = getattr(tops, n)

        def call(*a, _n=n, _real=real, **kw):
            calls[_n] = calls.get(_n, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(tops, n, call)
    return calls


def test_inert_slots_launch_and_add_nothing(live_pair, monkeypatch):
    """Every shard runs every group's ``n_slots`` slots, inert ones
    included (as the reference's static program does): a call makes
    S x slots launches per layout (two per banded slot), and the answer
    is the pinned view's."""
    _, port = live_pair
    s = 2
    stack = tret.stack_segment_shards(port.view(), s)
    metas = stack.signature()
    used = [int((arr["tile_count"].sum(dim=-1) > 0).sum())
            for _, arr in stack.groups]
    assert sum(s * m.n_slots for m in metas) > sum(used)   # some inert
    calls = _count_kernel_calls(monkeypatch)
    sc = tret.make_doc_sharded_segment_scorer(stack, _cpu_mesh(s), "s", k=K)
    row = _live_rows(port)[0]
    got = sc(row)
    want = {"fused_topk_blocked": 0, "fused_topk_packed": 0,
            "fused_score_blocked": 0, "fused_score_packed": 0}
    for m in metas:
        if m.layout == "banded":
            want["fused_score_packed"] += s * m.n_slots
            want["fused_score_blocked"] += s * m.n_slots
        else:
            want[f"fused_topk_{'packed' if m.layout == 'packed' else 'blocked'}"] \
                += s * m.n_slots
    assert calls == {n: c for n, c in want.items() if c}
    view = port.view().topk(row[None], K)
    np.testing.assert_array_equal(got[1].numpy(), view.doc_ids.numpy()[0])


def test_overflow_is_surfaced(hosts, monkeypatch):
    """A routing overflow in any shard is summed, warned and counted,
    never silent."""
    _, thost = hosts
    real = tops.build_batched_pairs

    def short(*a, **kw):
        out = list(real(*a, **kw))
        out[4] = out[4] + 3
        return tuple(out)
    monkeypatch.setattr(tops, "build_batched_pairs", short)
    sc = tret.make_doc_sharded_fused_scorer(
        tret.build_doc_sharded_blocked(thost, 2), _cpu_mesh(2), "s", k=K)
    before = GLOBAL.counter("engine_pair_overflow").value
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sc(_rows(thost)[0])
    assert any("routing overflow dropped 6" in str(w.message)
               for w in caught)
    assert GLOBAL.counter("engine_pair_overflow").value - before == 6


def test_term_sharded_from_view_equals_reference(live_pair):
    ref, port = live_pair
    for lay in ("hor", "packed", "banded"):
        ri, rids = rret.build_term_sharded_from_view(ref.view(), 2, lay)
        ti, tids = tret.build_term_sharded_from_view(port.view(), 2, lay)
        _equal_index(ri, ti)
        np.testing.assert_array_equal(rids, tids)


def test_stack_scorer_spans(live_pair):
    """``trace=`` records the reference's shard_fanout and shard_sync
    spans; the answer does not change."""
    from repro_torch.obs.trace import Trace
    _, port = live_pair
    stack = tret.stack_segment_shards(port.view(), 2)
    sc = tret.make_doc_sharded_segment_scorer(stack, _cpu_mesh(2), "s", k=K)
    row = _live_rows(port)[1]
    tr = Trace()
    a = sc(row, trace=tr)
    b = sc(row)
    names = [sp.name for sp in tr.spans]
    assert names == ["shard_fanout", "shard_sync"]
    fan = tr.spans[0]
    assert fan.attrs["n_shards"] == 2 and len(fan.attrs["groups"]) == len(
        stack.groups)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
