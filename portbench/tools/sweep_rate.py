"""Finds the highest query rate a live cell sustains: one set-up, then a
window at each offered rate in turn (writes as the mix makes them), and
for each the latency tail, how late the last answers came and whether
the backlog grew.

    python3 portbench/tools/sweep_rate.py --workload live1m.search_write \
        --seed <n> --seconds 20 --rates 30,36,42,48,54

A rate is sustained when the queue does not grow through the window:
the answers of its last fifth come no later than those of its middle
fifth.  The cell's rate is set once, at about four fifths of the highest
sustained rate, and written into its traffic mix.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch

    from portbench.lib import cell, manifest as mf
    from portbench.yardstick.stats import percentile
    device = cell.device_of(1)
    m = mf.load()
    w = mf.workload(m, args.workload)
    cfg = mf.config(m, w["config"])
    mix = mf.traffic(w["traffic"])
    system = mf.module("deployments", cfg["deployment"]).build(
        cfg, args.seed, device, False)
    load = mf.module("loads", mix["load"])
    warm = load.Session(system, mix, args.seed, args.seconds)
    warm.warm()
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        over = cell.merged(mix, {"queries": {"rate_per_s": rate}})
        sess = load.Session(system, over, args.seed + i + 1, args.seconds)
        sess.window()
        lat = sess.latencies_ms()
        n = len(lat)
        mid = np.median(lat[2 * n // 5:3 * n // 5])
        last = np.median(lat[4 * n // 5:])
        print(json.dumps({
            "rate": rate, "queries": n,
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "middle_fifth_p50_ms": float(mid),
            "last_fifth_p50_ms": float(last),
            "sustained": bool(last <= 1.5 * mid + 50.0),
            "write_ms_from_due": sess.write_latencies_ms().tolist(),
            "writes": len(sess.writes),
            "failed": sess.failed(),
            "device": torch.cuda.get_device_name(device)}), flush=True)
        time.sleep(2.0)
    system.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
