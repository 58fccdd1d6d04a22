"""Runs one cell of the benchmark once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

From the root of a checkout.  With ``--trace 0`` the line holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics (the
window under the profiler).  Every answer of the window is judged
against the plain reference; the numbers compared, each beside its
limit, close the line (``checks``) and standard error.  ``--control 1``
also judges the control (the reference in bfloat16) on the same
queries and prints its numbers (``control``).  Exits 2 without a CUDA
card, 1 on any other failure, and prints no result then.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    try:
        from portbench.lib import cell, manifest
        import torch
        torch.set_num_threads(4)
        chips = manifest.workload(manifest.load(), args.workload)["chips"]
        device = cell.device_of(chips)
        line, numbers = cell.run(args.workload, args.seed, args.seconds,
                                 bool(args.trace), device, T_PROCESS,
                                 control=bool(args.control))
    except Exception as exc:     # no result line: say why, exit nonzero
        traceback.print_exc()
        return 2 if type(exc).__name__ == "NoDevice" else 1
    found = cell.banned_modules()      # the window has closed
    if found:
        print(f"modules of JAX or its package are loaded: {found}",
              file=sys.stderr)
        return 1
    checks = line.pop("checks")
    if args.control:
        line["control"] = numbers["control"]
    line["checks"] = checks            # the numbers compared close the line
    print(json.dumps(line), flush=True)
    for text in cell.check_lines(checks):
        print(text, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
