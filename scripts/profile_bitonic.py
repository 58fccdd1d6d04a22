#!/usr/bin/env python3
"""The bitonic epilogue's two paths, timed on the same routing pairs.

    python3 scripts/profile_bitonic.py [--src DIR] [--seed 7] [--out FILE]

``fused_topk_{blocked,packed}`` with ``reducer="bitonic"`` selects each
row's first k_tile where its CTA's final scores hold no NaN and k_tile is
at most ``kBitonicSelectUpTo`` (``csrc/fused_score.cuh``), and sorts the
CTA's rows with the reference's network otherwise.  At ``chip_smoke.py``'s
1M-doc tier (the last two of its 5 bulk batches of 8 queries x 3 terms,
df band 0.15-0.5, cap = max_posting_len, tile 512), for HOR and packed and
k_tile 16, 32, 64, 128, 256 and 512, this prints per site the ms per call by
CUDA events (wrapper included), each taken twice, in turns:

- ``bitonic_ms``: the bitonic kernel on the index's own docs (no NaN
  score: every CTA takes the path its k_tile picks);
- ``network_ms``: the same pairs over a rank of NaN on every doc, so that
  every visited CTA votes NaN and runs the network (whose stages do not
  depend on the values: the time of the network path at this k_tile);
- ``successive_ms``: the successive kernel on the same pairs.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that the same script times an older
tree's kernels: compare two trees in one call, in turns (this, other,
this, other).  ``--k-tiles`` picks the k_tiles.  Prints one JSON line
per site and the card's name and power limit; exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NUM_DOCS, VOCAB, AVG_DISTINCT = 1_004_721, 50_000, 40   # chip_smoke.py
BATCH, TERMS, K, BATCHES, REPS = 8, 3, 10, 5, 5
K_TILES = (16, 32, 64, 128, 256, 512)
KERNELS = {"hor": "fused_topk_blocked", "packed": "fused_topk_packed"}


def smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, calls):
    """Mean ms per call of ``fn(*c)`` over ``REPS`` rounds of ``calls``,
    after one warm-up round."""
    import torch
    for c in calls:
        fn(*c)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        for c in calls:
            fn(*c)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (REPS * len(calls))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    ap.add_argument("--k-tiles", type=int, nargs="+", default=K_TILES)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_bitonic: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, a.src)

    from repro_torch.core import build, layouts, query
    from repro_torch.core.layouts import DocTable
    from repro_torch.kernels import cuda_build, ops
    from repro_torch.kernels import fused_decode_score as fds
    from repro_torch.text import corpus

    cuda_build.build(tuple(KERNELS.values()))
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    report = {"src": a.src, "card": card, "sites": []}
    spec = corpus.CorpusSpec(num_docs=NUM_DOCS, vocab=VOCAB,
                             avg_distinct=AVG_DISTINCT, seed=a.seed)
    host = build.bulk_build(next(corpus.stream_batches(
        spec, batch_docs=spec.num_docs)))
    batches = [corpus.sample_query_terms(
        host.df, host.term_hashes, BATCH, TERMS, df_band=(0.15, 0.5),
        num_docs=host.num_docs, seed=a.seed * 1000 + i)
        for i in range(BATCHES)][-2:]
    for kind, name in KERNELS.items():
        ix = (layouts.build_blocked if kind == "hor"
              else layouts.build_packed_csr)(host, device=dev)
        nan_ix = dataclasses.replace(ix, docs=DocTable(
            norm=ix.docs.norm,
            rank=torch.full_like(ix.docs.rank, float("nan"))))
        wrapper = getattr(fds, name)
        own, nan = [], []
        for qb in batches:
            qh = layouts.hash_tensor(qb, dev)
            for index, calls in ((ix, own), (nan_ix, nan)):
                tids, idf_t = query.lookup_query(index, qh)
                _, _, args, kw, _ = ops.fused_topk_args(
                    index, tids, idf_t, host.max_posting_len, K)
                calls.append(args[:-1])
        torch.cuda.synchronize()
        for k_tile in a.k_tiles:
            def run(reducer):
                def call(*c):
                    return wrapper(*c, k_tile, **kw, reducer=reducer)
                return call
            legs = {"bitonic_ms": (run("bitonic"), own),
                    "network_ms": (run("bitonic"), nan),
                    "successive_ms": (run("successive"), own)}
            turns = {key: [] for key in legs}
            for _ in range(2):
                for key, (fn, calls) in legs.items():
                    turns[key].append(event_ms(fn, calls))
            site = {"site": f"{kind}@{host.num_docs}", "kernel": name,
                    "src": a.src, "tile": kw["tile"], "k_tile": k_tile,
                    **{key: sum(t) / 2 for key, t in turns.items()},
                    "turns": turns,
                    "clocks_sm_mem_power_temp": smi(
                        "clocks.sm,clocks.mem,power.draw,temperature.gpu")}
            report["sites"].append(site)
            print(json.dumps(site), flush=True)
        del ix, nan_ix, own, nan
        torch.cuda.empty_cache()
    print(card)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(report, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
