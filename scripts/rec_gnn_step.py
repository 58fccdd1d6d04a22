#!/usr/bin/env python3
"""``chip_smoke.py``'s step 13 alone: the recsys and GNN serving paths
on the card, then their step-9 trace.

    python3 scripts/rec_gnn_step.py [--seed 7] [--out FILE]

Builds the kernels, runs ``chip_smoke.rec_gnn_phase`` (every check of
step 13 included) and ``rec_gnn_trace``, prints each model-path site's
kernel, device, bound, plain and library ms, and with ``--out`` writes
the step's report (with the sites) to that file.  Needs one CUDA device; run from a
checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None,
                    help="also write the step's report to this JSON file")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rec_gnn_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import cuda_build

    t0 = time.perf_counter()
    cuda_build.build()
    print(f"build_s {time.perf_counter() - t0:.1f}", flush=True)
    card = cs.smi("name,power.limit")
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    report: dict = {}
    sites, keep = cs.rec_gnn_phase(a.seed, dev, report, card)
    report["rec_gnn_serve"]["trace"] = cs.rec_gnn_trace(keep, sites, dev)
    for s in sites:
        print("SITE", json.dumps({k: s.get(k) for k in (
            "site", "launches", "kernel_ms", "device_ms", "bound_ms",
            "plain_ms", "library_ms", "gather_floor_ms", "max_abs_err")}))
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(
            {**report, "sites": sites, "card": card}, indent=1, default=str))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
