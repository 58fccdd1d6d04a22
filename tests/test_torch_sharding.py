"""The port's sharding rules (``repro_torch.launch.sharding``), meshes
(``launch.mesh``, ``distributed.shmap.NamedMesh``) and placement against
the reference's, on the CPU.

Every spec function of ``repro.launch.sharding`` is applied to every
leaf of the ten archs' cell arguments (parameters, optimizer states,
batches, inputs, caches), at smoke scale and at full scale (the
reference's abstract trees beside the port's ``meta`` trees: nothing is
allocated), on the meshes (16, 16), (2, 16, 16), (2, 2), (1, 1) and a
(4,) ``data`` mesh: each port spec equals the reference's ``tuple(P)``.
The reference's rules read only ``mesh.axis_names`` and ``mesh.shape``,
so a JAX ``AbstractMesh`` stands in for a 256-device mesh, in process.
Then ``NamedSharding.shard_shape`` against JAX's where the split is even
(an uneven one pads up, where JAX's refuses), the refusals, and
``place`` / ``gather``.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as RNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as RP  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.launch import mesh as rmesh  # noqa: E402
from repro.launch import sharding as rsh  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.distributed import shmap  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data",
                                                          "model")),
          ((2, 2), ("data", "model")), ((1, 1), ("data", "model")),
          ((4,), ("data",))]
LEAF_FNS = ("lm_param_spec", "lm_small_param_spec", "gnn_param_spec",
            "recsys_param_spec", "recsys_serve_param_spec", "batch_spec",
            "lm_small_batch_spec", "gnn_batch_spec")


def _leaves(arch_id):
    """Every distinct (path, shape) of the arch's cell arguments, smoke
    and full: [(reference path, reference leaf, port path, port leaf)],
    and the decode caches: [(reference leaf, port leaf, mla)]."""
    seen, leaves, caches = set(), [], []
    rarch, tarch = rconfigs.get_arch(arch_id), tconfigs.get_arch(arch_id)
    for scale in ("smoke", "full"):
        for shape_id in rarch.shape_ids():
            r = rarch.cell(shape_id, scale=scale)
            t = tarch.cell(shape_id, scale=scale)
            for i, (ra, ta) in enumerate(zip(r.abstract_args,
                                             t.abstract_args)):
                rp = jax.tree_util.tree_flatten_with_path(ra)[0]
                tp = tree.flatten_with_path(ta)[0]
                assert [rsh._path_str(p) for p, _ in rp] == \
                    [tsh._path_str(p) for p, _ in tp]
                for (rpath, rl), (tpath, tl) in zip(rp, tp):
                    assert tuple(tl.shape) == rl.shape
                    key = (rsh._path_str(rpath), rl.shape)
                    if key not in seen:
                        seen.add(key)
                        leaves.append((rpath, rl, tpath, tl))
                if r.kind == "decode" and i == 1:
                    mla = tarch.make_config(scale, shape_id).attn == "mla"
                    caches.append((ra, ta, mla))
    return leaves, caches


_LEAVES: dict = {}


def _arch_leaves(arch_id):
    if arch_id not in _LEAVES:
        _LEAVES[arch_id] = _leaves(arch_id)
    return _LEAVES[arch_id]


def _meshes():
    return [(AbstractMesh(shape, axes),
             shmap.make_named_mesh(shape, axes, "meta"))
            for shape, axes in MESHES]


@pytest.mark.parametrize("arch_id", list(rconfigs.ARCHS))
def test_leaf_specs_match_reference(arch_id):
    leaves, _ = _arch_leaves(arch_id)
    assert leaves
    for rm, tm in _meshes():
        for name in LEAF_FNS:
            rfn, tfn = getattr(rsh, name), getattr(tsh, name)
            for rpath, rl, tpath, tl in leaves:
                want = tuple(rfn(rpath, rl, rm))
                got = tfn(tpath, tl, tm)
                assert isinstance(got, tsh.PartitionSpec)
                assert got == want, (name, rsh._path_str(rpath), rl.shape,
                                     rm.shape)


@pytest.mark.parametrize("arch_id", [a for a, d in rconfigs.ARCHS.items()
                                     if d.kind == "lm"])
def test_cache_specs_match_reference(arch_id):
    _, caches = _arch_leaves(arch_id)
    assert caches
    for rm, tm in _meshes():
        for rc, tc, mla in caches:
            want = rsh.cache_specs(rc, rm, mla)
            got = tsh.cache_specs(tc, tm, mla)
            assert [tuple(w) for w in want] == list(got)
            for leaf in tc:
                for b, s in ((1, 2), (1, 3)):
                    assert tsh.kv_cache_spec(tuple(leaf.shape), tm, b, s) \
                        == tuple(rsh.kv_cache_spec(tuple(leaf.shape), rm,
                                                   b, s))


@pytest.mark.parametrize("entries", [(), (None,), ("model", None),
                                     (("data", "model"), None),
                                     (("data",), None), ((), "model"),
                                     (("pod", "data"), None, "model")])
def test_partition_spec_normalises_as_jax(entries):
    assert tsh.P(*entries) == tuple(RP(*entries))


def test_shard_shape_matches_jax_and_pads_uneven():
    for shape, axes in MESHES:
        rm = AbstractMesh(shape, axes)
        tm = shmap.make_named_mesh(shape, axes, "meta")
        for spec in ((), (axes[0],), (None, axes[-1]), (tuple(axes),)):
            for dims in ((512, 64), (1024, 32), (8192, 16)):
                want = RNamedSharding(rm, RP(*spec)).shard_shape(dims)
                assert tsh.NamedSharding(tm, spec).shard_shape(dims) == want
    tm = shmap.make_named_mesh((16, 16), ("data", "model"), "meta")
    sh = tsh.NamedSharding(tm, tsh.P(("data", "model"), None))
    assert sh.shard_shape((300, 7)) == (2, 7)          # ceil(300 / 256)
    assert sh.shard_bytes((300, 7), torch.bfloat16) == 2 * 7 * 2


@pytest.mark.parametrize("spec", [("pod",), ("data", "data"),
                                  (("data", "model"), "model")])
def test_named_sharding_refuses_what_jax_refuses(spec):
    tm = shmap.make_named_mesh((2, 2), ("data", "model"), "meta")
    with pytest.raises(Exception):          # JAX's DuplicateSpecError too
        RNamedSharding(AbstractMesh((2, 2), ("data", "model")), RP(*spec))
    with pytest.raises(ValueError):
        tsh.NamedSharding(tm, spec)


def test_named_and_named_from_specs():
    tm = shmap.make_named_mesh((2, 2), ("data", "model"), "cpu")
    params = {"embed": torch.zeros(512, 64), "mlp": {
        "w_up": torch.zeros(2, 64, 256)}, "norm": torch.zeros(64)}
    shs = tsh.named(params, tm, tsh.lm_param_spec)
    assert shs["embed"].spec == ("model", None)
    assert shs["mlp"]["w_up"].spec == (None, "data", "model")
    assert shs["norm"].spec == ()
    specs = (tsh.P("data"), [tsh.P(), tsh.P(None, "model")])
    got = tsh.named_from_specs(specs, tm)
    assert got[0].spec == ("data",) and got[1][1].spec == (None, "model")


def test_meshes():
    m = tmesh.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    assert {d.type for d in m.devices.flat} == {"meta"}
    m2 = tmesh.make_production_mesh(multi_pod=True)
    assert m2.axis_names == ("pod", "data", "model") and m2.size == 512
    assert tmesh.batch_axes(m2) == rmesh.batch_axes(
        AbstractMesh((2, 16, 16), ("pod", "data", "model")))
    assert tmesh.all_axes(m2) == ("pod", "data", "model")
    h = tmesh.make_host_mesh(model_parallelism=2, n_slots=4, device="cpu")
    assert h.shape == {"data": 2, "model": 2}
    assert h.coords(3) == {"data": 1, "model": 1}
    assert [h.coords(i) for i in range(4)] == [
        {"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    line = h.along("model")
    assert isinstance(line, shmap.Mesh) and line.shape == {"model": 2}
    assert h.along("data").size == 2
    with pytest.raises(ValueError):
        h.along("pod")
    with pytest.raises(ValueError):
        tmesh.make_host_mesh(device="cpu")           # no slot count
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.make_host_mesh(n_slots=2, device="cuda")


@pytest.mark.parametrize("spec", [(), ("data",), (None, "model"),
                                  (("data", "model"), None),
                                  (("model", "data"), None), ("model",
                                                              "data")])
def test_place_and_gather(spec):
    """Each slot's piece is the block of its mesh position (the first
    axis of a tuple the major one, as ``tests/test_torch_compress.py``
    holds against JAX's ``addressable_shards``); ``gather`` reassembles
    the tensor bit for bit."""
    tm = shmap.make_named_mesh((2, 2), ("data", "model"), "cpu")
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    st = tsh.place(x, tsh.NamedSharding(tm, spec))
    assert len(st.pieces) == 4
    sh = tsh.NamedSharding(tm, spec)
    for i, p in enumerate(st.pieces):
        assert torch.equal(p, x[sh.slices(i, x.shape)])
        assert tuple(p.shape) == sh.shard_shape(x.shape)
    assert torch.equal(tsh.gather(st), x)
    assert st.slot_bytes(0) == math.prod(
        sh.shard_shape(x.shape)) * 4


def test_place_refuses_an_uneven_split():
    tm = shmap.make_named_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="uneven"):
        tsh.place(torch.zeros(6, 5), tsh.NamedSharding(tm, (None, "model")))
