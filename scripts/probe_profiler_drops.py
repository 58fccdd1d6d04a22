#!/usr/bin/env python3
"""How often a ``torch.profiler`` trace of the fused candidate kernels
loses device events, and which ones.

    PYTHONPATH=src python3 scripts/probe_profiler_drops.py [--traces 25]

The one-launch tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py``
read kernel launches from traces; some full ``-m cuda`` runs see a
kernel missing from a trace.  This probe builds a 5,000-doc HOR and
packed index on the card, then traces one HOR and one packed candidate
call (successive and bitonic epilogue) many times under each opener:

* ``spin``: a ``torch.cuda._sleep`` kernel first (as the tests do);
* ``spin_sync``: the same, then a synchronize and 20 ms on the host;
* ``torch``: a torch kernel first (``ones`` then ``add_``);
* ``none``: the calls alone;
* ``bracket``: a spin kernel before and after 2 or 6 calls.

For each it prints how many traces showed which events, in order:
``S`` a spin kernel, ``H`` / ``P`` an HOR / packed candidate kernel,
``T`` a torch kernel.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=25)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_profiler_drops: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import build, layouts, query
    from repro_torch.kernels import ops
    from repro_torch.text import corpus

    gpu = torch.device("cuda", 0)
    host = build.bulk_build(corpus.generate(corpus.CorpusSpec(
        num_docs=5000, vocab=2000, avg_distinct=30, seed=3)))
    calls = []
    for build_index in (layouts.build_blocked, layouts.build_packed_csr):
        ix = build_index(host, device=gpu)
        qh = corpus.sample_query_terms(host.df, host.term_hashes, 8, 3,
                                       num_docs=host.num_docs, seed=4)
        tids, idf_t = query.lookup_query(ix, layouts.hash_tensor(qh, gpu))
        kernel, _, args, kw, _ = ops.fused_topk_args(
            ix, tids, idf_t, host.max_posting_len, 10)
        for reducer in ("successive", "bitonic"):
            kernel(*args, **kw, reducer=reducer)     # built and loaded
        calls.append((kernel, args, kw))
    torch.cuda.synchronize()

    def trace(opener, reducer, n_calls=2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if opener in ("spin", "spin_sync", "bracket"):
                torch.cuda._sleep(10_000)
            if opener == "spin_sync":
                torch.cuda.synchronize()
                time.sleep(0.02)
            if opener == "torch":
                torch.ones(1, device=gpu).add_(1)
            for i in range(n_calls):
                kernel, args, kw = calls[i % 2]
                kernel(*args, **kw, reducer=reducer)
            if opener == "bracket":
                torch.cuda._sleep(10_000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        return "".join("S" if "spin" in e.name else
                       "H" if "HorBlocks" in e.name else
                       "P" if "PackedBlocks" in e.name else "T"
                       for e in events)

    out = {}
    for opener in ("spin", "spin_sync", "torch", "none"):
        for reducer in ("successive", "bitonic"):
            out[f"{opener}/{reducer}"] = collections.Counter(
                trace(opener, reducer) for _ in range(a.traces))
    for n in (2, 6):
        out[f"bracket/bitonic/{n} calls"] = collections.Counter(
            trace("bracket", "bitonic", n) for _ in range(6 * a.traces))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
