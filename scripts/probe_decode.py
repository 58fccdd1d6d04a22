#!/usr/bin/env python3
"""Step 12 of ``chip_smoke.py`` alone (the Qwen3-0.6B serving path),
from the checkout at ``--root``: its decode ms a step, to compare two
checkouts' host-bound decode path on one card.

    python3 scripts/probe_decode.py [--root DIR] [--seed 7] [--reps 2]

Builds the attention kernel of that checkout, runs its ``lm_phase``
``--reps`` times in one process, and prints each run's prefill ms and
decode ms a step (host clock with ``synchronize``, as step 12 reads
them), then the host time of one decode step's ``_layer_params`` calls
(28 layers), then the card.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose step 12 runs")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=2)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_decode: no CUDA device", file=sys.stderr)
        return 2
    root = Path(a.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import cuda_build
    from repro_torch.models import transformer as tfm

    cuda_build.build(["flash_attention"])
    card = cs.smi("name,power.limit")
    dev = torch.device("cuda", 0)
    for rep in range(a.reps):
        report: dict = {}
        t0 = time.perf_counter()
        cs.lm_phase(a.seed, dev, report, card)
        lm = report["lm_serve"]
        print(f"DECODE {root.name} run {rep}: prefill "
              f"{lm['prefill_ms']:.1f} ms, decode "
              f"{lm['decode_ms_per_step']:.2f} ms a step "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.empty_cache()
    cfg = configs.get_arch("qwen3-0.6b").make_config("full")
    params = tfm.init_params(a.seed, cfg, device=dev)
    n = 200
    t0 = time.perf_counter()
    for _ in range(n):
        for i in range(cfg.n_layers):
            tfm._layer_params(params, cfg, i)
    print(f"LAYER_PARAMS {root.name}: "
          f"{(time.perf_counter() - t0) * 1e3 / n:.3f} ms a decode step")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
