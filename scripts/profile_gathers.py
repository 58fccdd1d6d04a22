#!/usr/bin/env python3
"""The two gather kernels at the model sites, for any tree, with the
diagnostics that ``chip_smoke.py`` does not run.

    python3 scripts/profile_gathers.py [--src DIR] [--seed 7] [--out FILE]

Runs ``embedding_bag`` and ``pna_multi_agg`` on one GPU at
``chip_smoke.py``'s bag and PNA sites (its ``model_inputs``, made on the
card from ``--seed``).  ``--src`` names the ``src`` directory whose
``repro_torch`` is run (default: this checkout's), so that the same
script reads another tree's kernels, an older one's or a variant's.

Per site, after holding the entry point to its plain version to the
bit: ``event_ms`` (``chip_smoke.event_ms``, ``REPS`` back-to-back calls
per turn, two turns), ``device_ms`` (``chip_smoke.device_ms``: one
trace of every site, ``TRACED`` calls after a warm-up, taken after all
event timings), ``host_share`` = 1 - device_ms / event_ms, the bound
and the gather floor (``chip_smoke.model_work``).  For the bag,
``F.embedding_bag``'s event time; where every bag holds one id, three
yardsticks of the card's rate for random 40-byte rows:
``index_select_ms`` (PyTorch's gather of the same rows), ``sorted_ms``
(the kernel on the same ids sorted: rows in address order) and
``l2_rows_ms`` (the ids folded into the first ``L2_ROWS`` rows, a slice
that L2 holds).  Prints one JSON line per site and the card's name and
power limit.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS, TURNS, TRACED = 20, 2, 3
L2_ROWS = 500_000             # 20 MB of 40-byte rows: held by the 50 MB L2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_gathers: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(a.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import cuda_build, ops
    from repro_torch.kernels import embedding_bag as tbag
    from repro_torch.kernels import segment_multi_agg as tpna

    t0 = time.perf_counter()
    logs = cuda_build.build(("embedding_bag", "pna_multi_agg"))
    print(f"nvcc build: {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    dev = torch.device("cuda", 0)
    entries = {"embedding_bag": (ops.embedding_bag, tbag.embedding_bag_plain),
               "pna_multi_agg": (ops.pna_multi_agg,
                                 tpna.pna_multi_agg_plain)}
    rows, traces = [], {}
    for site, kern, args, _ in cs.model_inputs(a.seed, dev):
        if kern not in entries:
            continue
        entry, plain = entries[kern]
        got, want = entry(*args), plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got.float().view(torch.int32),
                           want.float().view(torch.int32)):
            raise AssertionError(f"{site}: kernel != plain version")
        del want, got
        event = [cs.event_ms(entry, [args], REPS) for _ in range(TURNS)]
        nbytes, _, extra = cs.model_work(kern, args, {})
        row = {"site": site, "shapes": [list(x.shape) for x in args],
               "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
               "gather_floor_ms": extra["gather_floor_bytes"]
               / cs.HBM_BYTES_PER_S * 1e3,
               "event_ms": sum(event) / TURNS, "event_ms_turns": event}
        if kern == "embedding_bag":
            table, idx = args
            lib_args = (idx.clamp_min(0), (idx >= 0).to(table.dtype))
            row["library_ms"] = cs.event_ms(lambda i, w: F.embedding_bag(
                i, table, mode="sum", per_sample_weights=w), [lib_args],
                REPS)
            if idx.shape[1] == 1:
                row["index_select_ms"] = cs.event_ms(
                    lambda i: table.index_select(0, i),
                    [(idx[:, 0].clamp_min(0),)], REPS)
                row["sorted_ms"] = cs.event_ms(
                    entry, [(table, idx.sort(dim=0).values)], REPS)
                row["l2_rows_ms"] = cs.event_ms(
                    entry, [(table, idx % L2_ROWS)], REPS)
        row["clocks_sm_mem_power_temp"] = cs.smi(
            "clocks.sm,clocks.mem,power.draw,temperature.gpu")
        rows.append(row)
        traces[site] = (kern, entry, [args] * (1 + TRACED), 1)
    device = cs.device_ms(traces)
    for row in rows:
        row["device_ms"] = device[row["site"]]
        row["host_share"] = (None if row["device_ms"] is None
                             else 1 - row["device_ms"] / row["event_ms"])
        print(json.dumps(row), flush=True)
    card = cs.smi("name,power.limit")
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(
            {"src": a.src, "card": card, "sites": rows}, indent=1) + "\n")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
