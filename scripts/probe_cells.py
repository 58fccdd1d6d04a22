#!/usr/bin/env python3
"""Leaf by leaf, how far the card's smoke cells lie from the CPU's and
how far rounding alone moves the CPU's: the readings behind step 15(a)
of ``chip_smoke.py``.

    python3 scripts/probe_cells.py [--seed 7] [--out FILE]
    python3 scripts/probe_cells.py --moves 12 [--cells pna/ogb_products]

Without ``--moves`` (needs one CUDA device): every smoke cell once on
the card and once on the CPU on the same arguments (the CPU on the
card's MoE experts), and ``chip_smoke.cell_witness``'s first run (a
bf16 cell in f32, an f32 cell on its params moved one ulp); for every
float leaf its rel-to-max distances card-CPU, card-witness and
CPU-witness, each over that leaf's own largest value (an optimizer's
second moment by its square root).  Prints the three largest card-CPU
leaves of each cell, and with ``--out`` writes every leaf to a JSON
file.

With ``--moves N`` (the CPU only): for each cell of ``--cells``, the
CPU's run against each of the witness's first N one-ulp moves of its
params: each move's largest distance over the cell's optimizer moments,
and the leaf where it lies.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rel(a, b, name):
    a, b = a.cpu().double(), b.cpu().double()
    if ".v" in name:
        a, b = a.sqrt(), b.sqrt()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def leaves(t):
    from repro_torch.core import tree
    flat, _ = tree.flatten_with_path(t)
    return [("/".join(str(k) for k in p), x) for p, x in flat]


def on_card(cs, seed, out_path):
    import torch
    from repro_torch import configs
    from repro_torch.core import tree
    from repro_torch.kernels import cuda_build
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda", 0)
    cuda_build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.smi("name,power.limit")
    report = {"card": card, "cells": {}}
    for arch_id, shape_id in configs.list_cells():
        arch = configs.get_arch(arch_id)
        cell = arch.cell(shape_id, scale="smoke")
        args = cs.cell_inputs(arch, cell, seed)
        with cs.moe_routes(tfm) as routes:
            got = cell.fn(*cs.to_card(args, dev))
            torch.cuda.synchronize()
        with cs.moe_routes(tfm, routes):
            want = cell.fn(*tree.map(torch.clone, args))
        kind, wit = cs.cell_witness(arch, arch_id, shape_id, args, routes,
                                    seed, 0)
        rows = []
        for (name, g), (_, w), (_, x) in zip(leaves(got), leaves(want),
                                             leaves(wit)):
            if w.dtype.is_floating_point:
                rows.append({"leaf": name, "card_cpu": rel(g, w, name),
                             "card_witness": rel(g, x, name),
                             "cpu_witness": rel(x, w, name)})
        rows.sort(key=lambda r: -r["card_cpu"])
        report["cells"][f"{arch_id}/{shape_id}"] = {"witness": kind,
                                                    "leaves": rows}
        print(arch_id, shape_id, kind, json.dumps(rows[:3]), flush=True)
        del got, want, wit
        torch.cuda.empty_cache()
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(report))
    print(card)


def moves(cs, seed, n, cells):
    import torch
    from repro_torch import configs
    from repro_torch.core import tree
    for key in cells:
        arch_id, shape_id = key.split("/")
        arch = configs.get_arch(arch_id)
        cell = arch.cell(shape_id, scale="smoke")
        args = cs.cell_inputs(arch, cell, seed)
        want = leaves(cell.fn(*tree.map(torch.clone, args)))
        for k in range(n):
            run = cs.cell_witness(arch, arch_id, shape_id, args, [], seed, k)
            if run is None:
                break
            d, leaf = max((rel(x, w, name), name) for (name, w), (_, x) in
                          zip(want, leaves(run[1]))
                          if name.startswith("[1]/.") and
                          w.dtype.is_floating_point)
            print(f"{key} {run[0]} {k}: {d:.3e} at {leaf}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    ap.add_argument("--moves", type=int, default=0)
    ap.add_argument("--cells", nargs="*", default=["pna/ogb_products"])
    a = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    if a.moves:
        moves(cs, a.seed, a.moves, a.cells)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("probe_cells: no CUDA device", file=sys.stderr)
        return 2
    on_card(cs, a.seed, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
