"""Port vs reference for ``core.segments``' reductions, the ragged
EmbeddingBag, ``pack_ragged_np``, the bag's ``mode="mean"`` and the data
generators of ``train.data``, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Min, max, counts and offsets must be equal to the bit.  Sums and means
are equal to the bit too: on the CPU ``index_add_`` adds each segment's
entries in entry order, which is XLA's scatter order there.  std and
softmax add exp / log / sqrt, whose last bit may differ between the two
libraries, so they are held within rtol 1e-6, and atol FLT_MIN: XLA's
CPU code flushes a subnormal result to zero, torch keeps it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import segments as rseg  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag_pallas  # noqa: E402
from repro.train import data as rdata  # noqa: E402
from repro_torch.core import segments as tseg  # noqa: E402
from repro_torch.kernels import embedding_bag as tbag  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402

N_SEG = 9
FLT_MIN = float(np.finfo(np.float32).tiny)


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.int32)


def _assert_bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _ids(kind, n, rng):
    """Segment ids over N_SEG segments: sorted or not, with the trash id
    N_SEG, ids past it, negative ids, and segments 2 and 5 empty."""
    ids = rng.integers(0, N_SEG, size=n)
    ids[(ids == 2) | (ids == 5)] = 0
    if kind == "sorted":
        ids = np.sort(ids)
        ids[-4:] = N_SEG                            # padding at the end
    else:
        ids[rng.random(n) < 0.1] = N_SEG
        ids[rng.random(n) < 0.05] = N_SEG + 3
        ids[rng.random(n) < 0.05] = -1
        ids[rng.random(n) < 0.03] = -7
    return ids.astype(np.int32)


def _data(n, d, rng):
    x = (rng.normal(size=(n, d)) * rng.choice([1.0, 30.0, 1e-3],
                                              size=(n, 1))).astype(np.float32)
    x[rng.random((n, d)) < 0.05] = 0.0
    x[rng.random((n, d)) < 0.05] = -0.0              # signed zeros
    return x


REDUCTIONS = ["segment_sum", "segment_max", "segment_min", "segment_mean",
              "segment_std", "segment_softmax"]


@pytest.fixture(scope="module")
def ref_fns():
    """Each reference reduction, jitted once."""
    return {name: jax.jit(getattr(rseg, name), static_argnums=(2,))
            for name in REDUCTIONS}


CASES = [(kind, name, d) for kind in ("sorted", "unsorted")
         for name in REDUCTIONS for d in (0, 3)
         if not (name == "segment_softmax" and d)]   # 1-D logits only


@pytest.mark.parametrize("kind,name,d", CASES)
def test_reductions_match_reference(ref_fns, kind, name, d):
    """Each reduction, 1-D and 2-D data (``d`` 0 is 1-D), over sorted and
    unsorted ids with padding, out-of-range and negative ids and empty
    segments."""
    rng = np.random.default_rng(CASES.index((kind, name, d)))
    n = 200
    ids = _ids(kind, n, rng)
    x = _data(n, max(d, 1), rng)
    if not d:
        x = x[:, 0]
    want = np.asarray(ref_fns[name](jnp.asarray(x), jnp.asarray(ids), N_SEG))
    got = getattr(tseg, name)(torch.from_numpy(x), torch.from_numpy(ids),
                              N_SEG).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if name in ("segment_std", "segment_softmax"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=FLT_MIN)
    else:
        _assert_bits(got, want)
    if name == "segment_max":
        assert np.isneginf(got[[2, 5]]).all()
    if name == "segment_min":
        assert np.isposinf(got[[2, 5]]).all()


def test_signed_zeros_order_as_xla(ref_fns):
    """-0.0 orders below +0.0 in min and max, whatever the entry order."""
    x = np.array([-0.0, 0.0, 0.0, -0.0, -0.0, -0.0, 0.0, 0.0], np.float32)
    ids = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    for name in ("segment_max", "segment_min"):
        want = np.asarray(ref_fns[name](jnp.asarray(x), jnp.asarray(ids), 4))
        got = getattr(tseg, name)(torch.from_numpy(x),
                                  torch.from_numpy(ids), 4)
        _assert_bits(got, want)
    assert np.signbit(tseg.segment_max(torch.from_numpy(x),
                                       torch.from_numpy(ids), 4).numpy()
                      ).tolist() == [False, False, True, False]


@pytest.mark.parametrize("case", ["sorted", "negative", "past"])
def test_offsets_match_reference(case):
    """offsets <-> lengths <-> segment ids, with ``jnp.bincount``'s
    semantics: a negative id counts in segment 0, one past the trash row
    is dropped."""
    rng = np.random.default_rng(1)
    lengths = rng.integers(0, 5, size=N_SEG).astype(np.int32)
    offsets = np.asarray(rseg.lengths_to_offsets(jnp.asarray(lengths)))
    ids = np.asarray(rseg.offsets_to_segment_ids(jnp.asarray(offsets), 40))
    if case == "negative":
        ids = ids.copy()
        ids[:3] = -2
    if case == "past":
        ids = ids.copy()
        ids[-3:] = N_SEG + 4
    def t(a):
        return torch.from_numpy(np.array(a))
    np.testing.assert_array_equal(
        tseg.offsets_to_lengths(t(offsets)).numpy(),
        np.asarray(rseg.offsets_to_lengths(jnp.asarray(offsets))))
    np.testing.assert_array_equal(
        tseg.offsets_to_segment_ids(t(offsets), 40).numpy(),
        np.asarray(rseg.offsets_to_segment_ids(jnp.asarray(offsets), 40)))
    got = tseg.segment_ids_to_offsets(t(ids), N_SEG)
    want = np.asarray(rseg.segment_ids_to_offsets(jnp.asarray(ids), N_SEG))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ragged_embedding_bag_matches_reference(mode, weighted):
    """Ragged bags (empty ones included) with members padded past
    ``offsets[-1]``, every mode, with and without per-member weights."""
    rng = np.random.default_rng(2)
    table = _data(60, 5, rng)
    lengths = rng.integers(0, 6, size=12)
    lengths[[3, 7]] = 0
    total = int(lengths.sum())
    vals, offsets = rseg.pack_ragged_np(
        [rng.integers(0, 60, size=n) for n in lengths], pad_to=total + 5)
    w = rng.normal(size=vals.shape).astype(np.float32) if weighted else None
    want = np.asarray(jax.jit(rseg.embedding_bag, static_argnums=(3,))(
        jnp.asarray(table), jnp.asarray(vals), jnp.asarray(offsets), mode,
        None if w is None else jnp.asarray(w)))
    got = tseg.embedding_bag(torch.from_numpy(table), torch.from_numpy(vals),
                             torch.from_numpy(offsets), mode,
                             None if w is None else torch.from_numpy(w))
    _assert_bits(got, want)
    with pytest.raises(ValueError, match="unknown mode"):
        tseg.embedding_bag(torch.from_numpy(table), torch.from_numpy(vals),
                           torch.from_numpy(offsets), "median")


def test_pack_ragged_np_matches_reference():
    rng = np.random.default_rng(3)
    lists = [rng.integers(0, 99, size=n) for n in (3, 0, 5, 1, 0)]
    for pad_to in (None, 12):
        for a, b in zip(tseg.pack_ragged_np(lists, pad_to),
                        rseg.pack_ragged_np(lists, pad_to)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for a, b in zip(tseg.pack_ragged_np([]), rseg.pack_ragged_np([])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="pad_to"):
        tseg.pack_ragged_np(lists, 4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bag_mean_matches_reference(dtype):
    """``embedding_bag_plain(mode="mean")`` and ``ops.embedding_bag`` on
    CPU tensors: the bag sum divided by max(valid slots, 1), a bag of
    padding only included.  f32 within rtol 1e-6 of
    ``ref_embedding_bag(mode="mean")`` (XLA's reduction may add in
    another order); bf16 to the bit against the Pallas kernel's sum (one
    rounding per slot, as the port's kernel adds) divided the same way
    (``ref_embedding_bag`` rounds a bf16 sum once, not per slot)."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(70, 6)).astype(np.float32)
    idx = rng.integers(-1, 70, size=(32, 5)).astype(np.int32)
    idx[4] = -1
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    if dtype == "bf16":
        jt, tt = jt.astype(jnp.bfloat16), tt.to(torch.bfloat16)
        total = embedding_bag_pallas(jt, jnp.asarray(idx), tile_b=16,
                                     interpret=True)
        n = jnp.maximum((jnp.asarray(idx) >= 0).sum(1, keepdims=True), 1)
        want = total / n.astype(jnp.bfloat16)
    else:
        want = rref.ref_embedding_bag(jt, jnp.asarray(idx), mode="mean")
    for got in (tbag.embedding_bag_plain(tt, torch.from_numpy(idx), "mean"),
                tops.embedding_bag(tt, torch.from_numpy(idx), mode="mean")):
        assert got.dtype == tt.dtype
        if dtype == "f32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
        else:
            _assert_bits(got.float(), np.asarray(want, np.float32))
        assert not got[4].float().any()
    with pytest.raises(ValueError, match="mode"):
        tbag.embedding_bag_plain(tt, torch.from_numpy(idx), "max")


def _same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype, k


def test_batch_makers_match_reference():
    """Every batch maker, array for array, at a few seeds and steps."""
    for seed, step in ((0, 0), (7, 3)):
        _same_arrays(tdata.lm_batch(seed, step, 2, 9, 50),
                     rdata.lm_batch(seed, step, 2, 9, 50))
        _same_arrays(tdata.sasrec_batch(seed, step, 3, 5, 40, 4),
                     rdata.sasrec_batch(seed, step, 3, 5, 40, 4))
        _same_arrays(tdata.bert4rec_batch(seed, step, 3, 5, 40, 4),
                     rdata.bert4rec_batch(seed, step, 3, 5, 40, 4))
        _same_arrays(tdata.dien_batch(seed, step, 3, 5, 40),
                     rdata.dien_batch(seed, step, 3, 5, 40))
        for hot in (1, 3):
            _same_arrays(tdata.xdeepfm_batch(seed, step, 3, 4, 20, hot),
                         rdata.xdeepfm_batch(seed, step, 3, 4, 20, hot))
        _same_arrays(tdata.molecule_batch(seed, step, 4, 5, 7, 3, 2),
                     rdata.molecule_batch(seed, step, 4, 5, 7, 3, 2))


def test_graphs_and_sampler_match_reference():
    """The synthetic graph, the full-graph batch and the neighbour
    sampler's blocks (within this one process: the sampler seeds from a
    per-process str hash) equal the reference's."""
    tg = tdata.make_synthetic_graph(300, 2000, 6, 4, seed=5)
    rg = rdata.make_synthetic_graph(300, 2000, 6, 4, seed=5)
    for name in ("indptr", "indices", "feats", "labels"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(rg, name))
    assert (tg.num_nodes, tg.num_edges) == (rg.num_nodes, rg.num_edges)
    _same_arrays(tdata.fullgraph_batch(tg, seed=2),
                 rdata.fullgraph_batch(rg, seed=2))
    ts = tdata.NeighborSampler(tg, 8, (3, 2))
    rs = rdata.NeighborSampler(rg, 8, (3, 2))
    for step in (0, 1, 5):
        _same_arrays(ts.sample(step), rs.sample(step))


def test_prefetcher_yields_steps_in_order():
    pf = tdata.Prefetcher(lambda s: {"step": s}, start_step=3, depth=2)
    it = iter(pf)
    assert [next(it)["step"] for _ in range(4)] == [3, 4, 5, 6]
    pf.close()
