"""Tiny versions of the cells, small enough for the CPU tests: the same
deployments, loads, reference and comparison at a few thousand documents
and a window of about a second."""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

LIVE = {"collection": {"num_docs": 1500, "vocab": 700, "avg_distinct": 16},
        "index": {"delta_doc_capacity": 256,
                  "delta_posting_capacity": 256 * 64},
        "churn": {"docs": 600, "steps": [
            ["add", 0, 150], ["seal", None], ["add", 150, 300],
            ["seal", None], ["add", 300, 400], ["seal", None],
            ["add", 400, 450], ["seal", None], ["delete_every", 64],
            ["add", 450, 500], ["seal", "hor"], ["add", 500, 550],
            ["seal", "packed"], ["add", 550, 600], ["delete_every", 64]]}}
LIVE_MIX = {"queries": {"rate_per_s": 24.0},
            "writes": {"period_s": 0.3, "add_docs": 48, "delete_docs": 2}}
STATIC = {"collection": {"num_docs": 1500, "vocab": 700, "avg_distinct": 16}}
STATIC_MIX = {"pool_batches": 8}
SEED = 2**31 + 4242
SECONDS = 0.7


def run(cell, control=False, seed=SEED):
    from portbench.lib import cell as cell_mod
    live = cell.startswith("live")
    return cell_mod.run(
        cell, seed, SECONDS, False, "cpu", time.perf_counter(),
        control=control, config_over=LIVE if live else STATIC,
        mix_over=LIVE_MIX if live else STATIC_MIX)
