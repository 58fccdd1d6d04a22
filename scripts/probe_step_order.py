#!/usr/bin/env python3
"""Does running ``chip_smoke.py``'s step 13 first move step 12's
prefill?  Step 12 (the Qwen3-0.6B serving path) in one process: first,
after step 13, and once more.

    python3 scripts/probe_step_order.py [--seed 7]

Prints each step-12 run's first and second prefill ms and its decode ms
a step (host clock with ``synchronize``, as step 12 reads them), then
the card.  Needs one CUDA device; run from a checkout of the
repository.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_step_order: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import cuda_build

    cuda_build.build()
    card = cs.smi("name,power.limit")
    dev = torch.device("cuda", 0)
    rows = []
    for label in ("step 12 first", "step 13", "step 12 after step 13",
                  "step 12 again"):
        report: dict = {}
        t0 = time.perf_counter()
        if label == "step 13":
            cs.rec_gnn_phase(a.seed, dev, report, card)
        else:
            cs.lm_phase(a.seed, dev, report, card)
            lm = report["lm_serve"]
            rows.append((label, lm["prefill_ms"], lm["prefill_ms_second"],
                         lm["decode_ms_per_step"]))
        torch.cuda.empty_cache()
        print(f"PROBE {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    for label, first, second, decode in rows:
        print(f"PREFILL {label}: first {first:.1f} ms, second "
              f"{second:.1f} ms, decode {decode:.1f} ms a step")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
