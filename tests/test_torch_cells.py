"""The port's dry-run cells (``repro_torch.configs`` ``ArchDef.cell``) and
the dry run (``repro_torch.launch.dryrun``) against the reference's, on
the CPU.

* ``meta`` (``model_flops``, ``n_params``, ``n_active``, ``tokens``,
  ``cache_bytes``), ``kind`` and ``donate`` equal the reference's for
  all 40 smoke cells, and for the four full-scale cells of the
  reference's own dry-run test on the single- and multi-pod axes (the
  MoE ``groups`` rewrite and the small-model FSDP switch included);
* on a (2, 2) mesh, those four cells' per-device argument bytes equal
  the sum of the reference's ``NamedSharding.shard_shape`` bytes over
  the same shardings (a JAX ``AbstractMesh``: nothing is placed), at
  smoke and at full scale;
* those four cells' ``fn`` on the CPU, the port's and the reference's
  (jitted, ``xla_allow_excess_precision`` off) on the same weights and
  inputs: every float leaf within rel-to-max 1e-4 (f32) or 2e-2 (bf16),
  an optimizer's second moment by its square root;
* every smoke cell's ``fn`` runs on the CPU to finite outputs, its
  arguments and outputs of the reference's shapes, dtypes and tree
  (``jax.eval_shape`` of the reference's cell; a train step's outputs
  are its params, its optimizer state and the metrics);
* ``launch.dryrun`` writes 80 records, all ``ok``, on both production
  meshes, keeps them on a second run and rewrites them with ``--force``;
  a spec naming an axis the mesh lacks gives ``ok`` false;
  ``collective_bytes`` equals the reference's on HLO text.
"""
import dataclasses
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as RNamedSharding  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.distributed import shmap  # noqa: E402
from repro_torch.launch import dryrun, sharding  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SMOKE_CELLS = rconfigs.list_cells()
FOUR = [("qwen3-0.6b", "train_4k"), ("mixtral-8x7b", "decode_32k"),
        ("pna", "full_graph_sm"), ("xdeepfm", "serve_bulk")]
AXES = (("data", "model"), ("pod", "data", "model"))
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
STRICT = {"xla_allow_excess_precision": False}


def _dt(x) -> str:
    return str(x.dtype)[6:] if isinstance(x, torch.Tensor) else str(x.dtype)


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _to_jax(t):
    """A port tree of CPU tensors (dicts, lists, tuples) as jax arrays."""
    if isinstance(t, dict):
        return {k: _to_jax(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_to_jax(v) for v in t)
    a = jnp.asarray(_np(t))
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


_CELLS: dict = {}


def _smoke_cells(arch_id, shape_id):
    """(port cell, reference cell) of a smoke shape, built once."""
    key = (arch_id, shape_id)
    if key not in _CELLS:
        _CELLS[key] = (
            tconfigs.get_arch(arch_id).cell(shape_id, scale="smoke"),
            rconfigs.get_arch(arch_id).cell(shape_id, scale="smoke"))
    return _CELLS[key]


@pytest.mark.parametrize("arch_id,shape_id", SMOKE_CELLS)
def test_smoke_cell_meta_matches_reference(arch_id, shape_id):
    t, r = _smoke_cells(arch_id, shape_id)
    assert (t.kind, t.donate, t.meta) == (r.kind, r.donate, r.meta)
    assert (t.make_out_shardings is None) == (r.make_out_shardings is None)


@pytest.mark.parametrize("arch_id,shape_id", FOUR)
def test_full_cell_meta_matches_reference(arch_id, shape_id):
    for axes in ((),) + AXES:
        r = rconfigs.get_arch(arch_id).cell(shape_id, mesh_axes=axes)
        t = tconfigs.get_arch(arch_id).cell(shape_id, mesh_axes=axes)
        assert (t.kind, t.donate, t.meta) == (r.kind, r.donate, r.meta), axes
        assert all(x.device.type == "meta"
                   for x in tree.leaves(t.abstract_args))


def _ref_arg_bytes(cell, mesh):
    out = []
    for args, sh in zip(cell.abstract_args, cell.make_shardings(mesh)):
        flat = jax.tree.leaves(args)
        shs = jax.tree.leaves(sh, is_leaf=lambda x: isinstance(
            x, RNamedSharding))
        out.append(sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
                       for x, s in zip(flat, shs)))
    return out


@pytest.mark.parametrize("scale", ["smoke", "full"])
@pytest.mark.parametrize("arch_id,shape_id", FOUR)
def test_arg_bytes_on_2x2_match_reference(arch_id, shape_id, scale):
    axes = ("data", "model")
    r = rconfigs.get_arch(arch_id).cell(shape_id, scale=scale,
                                        mesh_axes=axes)
    t = tconfigs.get_arch(arch_id).cell(shape_id, scale=scale,
                                        mesh_axes=axes)
    want = _ref_arg_bytes(r, AbstractMesh((2, 2), axes))
    got = dryrun.arg_bytes(t, shmap.make_named_mesh((2, 2), axes, "meta"))
    assert list(got.values()) == want
    rec = dryrun.cell_record(t, shmap.make_named_mesh((2, 2), axes, "meta"))
    assert rec["ok"] and rec["argument_bytes_per_device"] == sum(want)
    assert rec["donated_bytes_per_device"] == sum(want[i] for i in r.donate)


def _leaf_err(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if ".v" in name:                 # a second moment: its square root
        got, want = np.sqrt(got), np.sqrt(want)
    return float(np.abs(got - want).max() /
                 max(np.abs(want).max(), 1e-9))


@pytest.mark.parametrize("arch_id,shape_id", FOUR)
def test_four_cells_run_as_the_reference(arch_id, shape_id):
    """The port's step and the reference's on the same weights and
    inputs (smoke scale), every float leaf within the dtype's
    tolerance, integer leaves equal."""
    arch = tconfigs.get_arch(arch_id)
    t = arch.cell(shape_id, scale="smoke")
    r = rconfigs.get_arch(arch_id).cell(shape_id, scale="smoke")
    args = chip_smoke.cell_inputs(arch, t, seed=3)
    rargs = [_to_jax(args[0])]
    if t.kind == "train":
        rargs += [ropt.init(rargs[0]), _to_jax(args[2])]
    else:
        rargs += [_to_jax(a) for a in args[1:]]
    want = jax.jit(r.fn, compiler_options=STRICT)(*rargs)
    got = t.fn(*tree.map(torch.clone, args))
    cfg = arch.make_config("smoke", shape_id)
    tol = TOL[str(getattr(cfg, "dtype", torch.float32))[6:]]
    gp, _ = tree.flatten_with_path(got)
    wl = jax.tree.leaves(want)
    assert len(gp) == len(wl)
    for (path, g), w in zip(gp, wl):
        name = "/".join(str(k) for k in path)
        assert tuple(g.shape) == w.shape and _dt(g) == _dt(w), name
        if g.dtype.is_floating_point:
            assert np.isfinite(_np(g)).all(), name
            assert _leaf_err(name, _np(g), w) < tol, name
        else:
            assert np.array_equal(g.numpy(), np.asarray(w)), name


def _spec(x):
    return (tuple(x.shape), _dt(x))


_METRICS: list = []


def _ref_outputs(r):
    """The reference cell's outputs, abstract.  A train step's are its
    params' and optimizer state's own shapes and its metrics, whose
    shapes one ``jax.eval_shape`` of a train cell gives (tracing the
    other train steps' gradients again would repeat it)."""
    if r.kind != "train":
        return jax.eval_shape(r.fn, *r.abstract_args)
    if not _METRICS:
        c = rconfigs.get_arch("pna").cell("molecule", scale="smoke")
        _METRICS.append(jax.eval_shape(c.fn, *c.abstract_args)[2])
    return (r.abstract_args[0], r.abstract_args[1], _METRICS[0])


@pytest.mark.parametrize("arch_id,shape_id", SMOKE_CELLS)
def test_smoke_cell_runs_with_reference_shapes(arch_id, shape_id):
    arch = tconfigs.get_arch(arch_id)
    t, r = _smoke_cells(arch_id, shape_id)
    args = chip_smoke.cell_inputs(arch, t, seed=5)
    assert [_spec(x) for x in tree.leaves(args)] == \
        [_spec(x) for x in jax.tree.leaves(r.abstract_args)]
    assert [_spec(x) for x in tree.leaves(args)] == \
        [_spec(x) for x in tree.leaves(t.abstract_args)]
    out = t.fn(*args)
    want = _ref_outputs(r)
    got_flat, got_def = tree.flatten(out)
    # a list and a tuple alike: the reference's small top-k is a list

    def seq(td):
        return str(td).replace("[", "(").replace("]", ")")
    assert seq(got_def) == seq(jax.tree.structure(want))
    assert [_spec(x) for x in got_flat] == \
        [_spec(x) for x in jax.tree.leaves(want)]
    for x in got_flat:
        if x.dtype.is_floating_point:
            assert torch.isfinite(x).all(), (arch_id, shape_id)
    if t.kind == "train":
        assert any(not torch.equal(a, b) for a, b in
                   zip(tree.leaves(out[0]), tree.leaves(args[0])))


def test_dryrun_writes_80_ok_records_and_resumes(tmp_path):
    out = str(tmp_path)
    assert dryrun.main(["--all", "--mesh", "both", "--out", out]) == 0
    files = sorted(tmp_path.glob("*/*.json"))
    assert len(files) == 80
    recs = [json.loads(p.read_text()) for p in files]
    assert all(r["ok"] for r in recs)
    assert {r["mesh"] for r in recs} == {"single", "multi"}
    for r in recs:
        assert set(r["arg_bytes_per_device"]) == \
            set(dryrun.ARG_NAMES[r["kind"]])
        assert r["fits"] == (r["argument_bytes_per_device"] <=
                             r["hbm_per_chip"])
    one = tmp_path / "single" / "qwen3-0.6b__train_4k.json"
    rec = json.loads(one.read_text())
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["meta"] == rconfigs.get_arch("qwen3-0.6b").cell(
        "train_4k", mesh_axes=("data", "model")).meta
    one.write_text(json.dumps(dict(rec, marker=1)))
    kept = dryrun.run_cell("qwen3-0.6b", "train_4k", "single", out)
    assert kept.get("marker") == 1                  # resumed, not rerun
    fresh = dryrun.run_cell("qwen3-0.6b", "train_4k", "single", out,
                            force=True)
    assert "marker" not in fresh and fresh["ok"]


def test_dryrun_refuses_an_axis_the_mesh_lacks():
    cell = tconfigs.get_arch("pna").cell("molecule", scale="smoke")
    bad = dict(make_shardings=lambda mesh: tuple(
        tree.map(lambda x: sharding.NamedSharding(mesh, sharding.P("pod")),
                 a) for a in cell.abstract_args))
    mesh = shmap.make_named_mesh((16, 16), ("data", "model"), "meta")
    rec = dryrun.cell_record(dataclasses.replace(cell, **bad), mesh)
    assert not rec["ok"] and "pod" in rec["error"]


def test_collective_bytes_matches_reference():
    # the reference module sets XLA_FLAGS (512 host devices) on import:
    # start this process's backend first, and put the variable back
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as rdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    hlo = "\n".join([
        "  %ar = f32[1024,16]{1,0} all-reduce(f32[1024,16] %x), to_apply=%s",
        "  %ag = bf16[8,512]{1,0} all-gather(bf16[1,512] %y), dims={0}",
        "  %t = (s8[4,64], f32[4]) all-to-all(s8[4,64] %q, f32[4] %s)",
        "  %cp = u32[7] collective-permute(u32[7] %z)",
        "  %n = f32[3] add(f32[3] %a, f32[3] %b)"])
    assert dryrun.collective_bytes(hlo) == rdryrun.collective_bytes(hlo)
