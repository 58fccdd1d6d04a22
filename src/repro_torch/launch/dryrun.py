"""Multi-pod dry run of the port: size every (arch x shape) cell on the
production meshes and record its per-device memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \
        --shape train_4k --mesh single

Runs on the host only: the meshes are on the ``meta`` device (16 x 16,
and 2 x 16 x 16), the cells' abstract args are ``meta`` tensors, and
nothing is placed.  Results land in
``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json`` and runs are
RESUMABLE: existing result files are kept unless ``--force``.

A record holds the cell's ``kind``, ``meta`` and ``mesh_shape``; the
bytes per device of each argument (params, optimizer state, batch or
cache, from ``NamedSharding.shard_shape`` of every leaf, an uneven
dimension padded up as GSPMD pads it), of all of them and of the
donated ones; ``fits`` (the arguments within ``hw.HBM_PER_CHIP``); and
``ok``, false (with ``error``) when a spec names an axis the mesh lacks
or one axis twice, the mismatch the reference's compile would refuse.

Differences from the reference, by design: PyTorch has nothing to lower
or compile, so there is no HLO, no ``cost_analysis``, no temporaries'
or outputs' bytes from a compiled program and no collective bytes.
``collective_bytes`` is kept, unchanged: it reads HLO text.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time
import traceback

from repro_torch.core import tree
from repro_torch.launch import hw

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "c128": 16,
}

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")

# each cell kind's arguments, in ``abstract_args`` order
ARG_NAMES = {"train": ("params", "opt_state", "batch"),
             "prefill": ("params", "tokens"),
             "decode": ("params", "cache", "tokens", "cache_len"),
             "serve": ("params", "inputs"),
             "retrieval": ("params", "inputs", "candidates")}

OUT_DIR = "experiments/dryrun_torch"


def _shape_bytes(tok_dtype: str, dims: str) -> int:
    if tok_dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[tok_dtype]


def collective_bytes(hlo_text: str) -> dict:
    """Sum RESULT-shape bytes per collective opcode (optimized HLO prints
    operands without type annotations, so we use the lhs result shape —
    equal to operand bytes for all-reduce / permute / all-to-all, and to
    the gathered size for all-gather).  NOTE: ops inside while bodies are
    counted ONCE here."""
    out = {c: 0 for c in COLLECTIVES}
    counts = {c: 0 for c in COLLECTIVES}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        for c in COLLECTIVES:
            if f" {c}(" in stripped and "=" in stripped:
                lhs = stripped.split(f" {c}(", 1)[0]
                for m in _SHAPE_RE.finditer(lhs):
                    out[c] += _shape_bytes(m.group(1), m.group(2))
                counts[c] += 1
                break
    out_total = sum(out.values())
    return {"per_op_bytes": out, "counts": counts, "total_bytes": out_total}


def arg_bytes(cell, mesh) -> dict:
    """Bytes per device of each of ``cell``'s arguments on ``mesh``:
    every leaf's ``shard_shape`` under its sharding."""
    shardings = cell.make_shardings(mesh)
    out = {}
    for name, args, sh in zip(ARG_NAMES[cell.kind], cell.abstract_args,
                              shardings):
        out[name] = sum(s.shard_bytes(x.shape, x.dtype) for x, s in
                        zip(tree.leaves(args), tree.leaves(sh)))
    return out


def cell_record(cell, mesh) -> dict:
    """The dry run's record of ``cell`` on ``mesh`` (any ``NamedMesh``):
    see the module docstring."""
    record = {"arch": cell.arch_id, "shape": cell.shape_id,
              "mesh_shape": dict(mesh.shape), "kind": cell.kind,
              "meta": cell.meta}
    try:
        t0 = time.perf_counter()
        per_arg = arg_bytes(cell, mesh)
        if cell.make_out_shardings is not None:
            cell.make_out_shardings(mesh)
        names = ARG_NAMES[cell.kind]
        total = sum(per_arg.values())
        record["arg_bytes_per_device"] = per_arg
        record["argument_bytes_per_device"] = total
        record["donated_bytes_per_device"] = sum(
            per_arg[names[i]] for i in cell.donate)
        record["hbm_per_chip"] = hw.HBM_PER_CHIP
        record["fits"] = total <= hw.HBM_PER_CHIP
        record["size_s"] = time.perf_counter() - t0
        record["ok"] = True
    except Exception as e:                       # noqa: BLE001
        record["ok"] = False
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    return record


def run_cell(arch_id: str, shape_id: str, mesh_kind: str,
             out_dir: str = OUT_DIR, force: bool = False) -> dict:
    """Size one cell on a production mesh ("single" or "multi") and
    write its record, unless one is there already (``force`` rewrites)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_production_mesh

    path = os.path.join(out_dir, mesh_kind, f"{arch_id}__{shape_id}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    os.makedirs(os.path.dirname(path), exist_ok=True)

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    try:
        cell = configs.get_arch(arch_id).cell(
            shape_id, scale="full", mesh_axes=tuple(mesh.axis_names))
        record = cell_record(cell, mesh)
    except Exception as e:                       # noqa: BLE001
        record = {"arch": arch_id, "shape": shape_id,
                  "mesh_shape": dict(mesh.shape), "ok": False,
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    record["mesh"] = mesh_kind
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    status = "OK" if record.get("ok") else "FAIL"
    print(f"[{mesh_kind}] {arch_id:15s} {shape_id:14s} {status} "
          f"args/device={record.get('argument_bytes_per_device', 0):.4g}B "
          f"fits={record.get('fits')}", flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    from repro_torch import configs
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = configs.list_cells()
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        shapes = ([args.shape] if args.shape else
                  configs.get_arch(args.arch).shape_ids())
        cells = [(args.arch, s) for s in shapes]

    n_fail = n_fit = n = 0
    for mesh_kind in meshes:
        for arch_id, shape_id in cells:
            rec = run_cell(arch_id, shape_id, mesh_kind, args.out,
                           force=args.force)
            n += 1
            n_fail += 0 if rec.get("ok") else 1
            n_fit += bool(rec.get("fits"))
    print(f"done; {n} records, failures: {n_fail}, fit "
          f"{hw.HBM_PER_CHIP / 1e9:g} GB: {n_fit}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
