#!/usr/bin/env python3
"""Where the candidate kernels' time goes, split by profiler traces.

    python3 scripts/profile_candidates.py [--src DIR] [--seed 7] [--out FILE]

Profiles ``fused_topk_blocked`` and ``fused_topk_packed`` (the port's
candidate kernels) through their wrappers on one GPU, at two sizes:
``chip_smoke.py``'s bulk call sites (the 1M-doc tier, 5 batches of 8
queries x 3 terms, df band 0.15-0.5, k = 10, cap = max_posting_len) and a
seal-sized site (a 4,850-doc index, the size of the live phase's HOR and
packed seals, 5 batches drawn the same way).  ``--src`` names the ``src``
directory whose ``repro_torch`` is profiled (default: this checkout's),
so that the same script reads an older tree's kernels.

Per site, means per call over its batches:

- ``event_ms``: CUDA events around one wrapper call per round, ``REPS``
  rounds over the batches, wrapper included;
- from one ``torch.profiler`` trace of every batch's call at the site's
  k_tile, and one at k_tile = 1: ``routing_ms``, the device time of the
  kernels the wrapper launches besides the candidate kernel; ``kernel_ms``,
  the candidate kernel's; ``reduction_ms`` = (kernel_ms at k_tile - at 1)
  * k_tile / (k_tile - 1), the part that grows with the per-tile
  reduction's passes; ``walk_ms`` = kernel_ms - reduction_ms: the walk
  over the run of pairs and the scoring tail;
- ``host_ms`` = event_ms - routing_ms - kernel_ms, what the host adds
  per call when calls run back to back;
- ``dense_ms``: the device time of the layout's dense kernel
  (``fused_score_*``) on the same batches, a walk over the same pairs
  that writes the Q x num_docs sums instead of the candidates.

Prints one JSON line per site and the card's name and power limit.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NUM_DOCS, VOCAB, AVG_DISTINCT = 1_004_721, 50_000, 40   # chip_smoke.py
SEAL_DOCS = 4_850                                       # a live seal
BATCH, TERMS, K, BATCHES, REPS = 8, 3, 10, 5, 5
KERNELS = {"hor": "fused_topk_blocked", "packed": "fused_topk_packed"}
DENSE = {"hor": "fused_score_blocked", "packed": "fused_score_packed"}
# the candidate and dense kernels' names in a trace, in either design
CANDIDATE = ("topk_kernel<", "TopkOut")
DENSE_SYMBOL = ("score_kernel<fused_score::HorBlocks",
                "score_kernel<fused_score::PackedBlocks", "DenseOut")


def smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, calls):
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


def traced(fn, calls, symbols=CANDIDATE):
    """(routing ms, kernel ms) of each call, from one trace: the device
    kernels before a call's kernel (named by one of ``symbols``) are its
    routing."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(10_000)     # a trace can miss its first kernel
        for c in calls:
            fn(*c)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "spin_kernel" not in e.name),
                    key=lambda e: e.time_range.start)
    out, pending = [], 0.0
    for e in events:
        us = e.time_range.elapsed_us()
        if any(c in e.name for c in symbols):
            out.append((pending / 1e3, us / 1e3))
            pending = 0.0
        else:
            pending += us
    if len(out) != len(calls):
        raise AssertionError(f"{len(out)} candidate kernels in a trace of "
                             f"{len(calls)} calls: "
                             f"{sorted({e.name for e in events})}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_candidates: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, a.src)
    import numpy as np

    from repro_torch.core import build, layouts, query
    from repro_torch.kernels import cuda_build, ops
    from repro_torch.text import corpus

    cuda_build.build((*KERNELS.values(), *DENSE.values()))
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    report = {"src": a.src, "card": card, "sites": []}
    for docs, seed in ((NUM_DOCS, a.seed), (SEAL_DOCS, a.seed + 1)):
        spec = corpus.CorpusSpec(num_docs=docs, vocab=VOCAB,
                                 avg_distinct=AVG_DISTINCT, seed=seed)
        host = build.bulk_build(next(corpus.stream_batches(
            spec, batch_docs=spec.num_docs)))
        batches = [corpus.sample_query_terms(
            host.df, host.term_hashes, BATCH, TERMS, df_band=(0.15, 0.5),
            num_docs=host.num_docs, seed=seed * 1000 + i)
            for i in range(BATCHES)]
        for kind, name in KERNELS.items():
            ix = (layouts.build_blocked if kind == "hor"
                  else layouts.build_packed_csr)(host, device=dev)
            by_k = {}
            for k_tile in (None, 1):
                calls = []
                for qb in batches:
                    tids, idf_t = query.lookup_query(
                        ix, layouts.hash_tensor(qb, dev))
                    wrapper, _, args, kw, _ = ops.fused_topk_args(
                        ix, tids, idf_t, host.max_posting_len, K,
                        k_tile=k_tile)
                    calls.append(args)
                torch.cuda.synchronize()

                def run(*c):
                    return wrapper(*c, **kw)
                run(*calls[0])                      # built and loaded
                ms = event_ms(run, calls) if k_tile is None else None
                by_k[calls[0][-1]] = (ms, traced(run, calls))
                del calls
                torch.cuda.empty_cache()
            (kt, (ev, full)), (_, (_, one)) = sorted(
                by_k.items(), reverse=True)
            calls = []
            for qb in batches:
                tids, idf_t = query.lookup_query(
                    ix, layouts.hash_tensor(qb, dev))
                dense, _, args, kw, _ = ops.fused_score_args(
                    ix, tids, idf_t, host.max_posting_len)
                calls.append(args)

            def run_dense(*c):
                return dense(*c, **kw)
            run_dense(*calls[0])
            dense_ms = float(np.mean(
                [k for _, k in traced(run_dense, calls, DENSE_SYMBOL)]))
            del calls
            routing = float(np.mean([r for r, _ in full]))
            kernel = float(np.mean([k for _, k in full]))
            kernel_1 = float(np.mean([k for _, k in one]))
            reduction = (kernel - kernel_1) * kt / (kt - 1)
            site = {"site": f"{kind}@{host.num_docs}", "kernel": name,
                    "k_tile": kt, "event_ms": ev, "routing_ms": routing,
                    "kernel_ms": kernel, "kernel_ms_k_tile_1": kernel_1,
                    "reduction_ms": reduction,
                    "walk_ms": kernel - reduction,
                    "host_ms": ev - routing - kernel, "dense_ms": dense_ms}
            report["sites"].append(site)
            print(json.dumps(site), flush=True)
            del ix
            torch.cuda.empty_cache()
    print(card)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(report, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
