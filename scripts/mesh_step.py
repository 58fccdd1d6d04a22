#!/usr/bin/env python3
"""``chip_smoke.py``'s step 15 alone: the cells, the dry run,
compressed-gradient training over shard slots and the elastic restore.

    python3 scripts/mesh_step.py [--seed 7] [--out FILE]

Builds the kernels and runs ``chip_smoke.mesh_phase`` (every check of
step 15 included); with ``--out`` writes the step's report to that file.
Needs one CUDA device; run from a checkout of the repository.
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
        print("mesh_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import cuda_build

    t0 = time.perf_counter()
    cuda_build.build()
    print(f"build_s {time.perf_counter() - t0:.1f}", flush=True)
    card = cs.smi("name,power.limit")
    print(f"card: {card}", flush=True)
    report: dict = {}
    cs.mesh_phase(a.seed, torch.device("cuda", 0), report, card)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps({**report, "card": card},
                                          indent=1, default=str))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
