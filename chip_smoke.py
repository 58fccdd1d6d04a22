#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's query path on one GPU and check it.

    python3 chip_smoke.py [--seed 7] [--out FILE]

1. Builds the CUDA candidate kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together) and prints the card's
   name and power limit.
2. Generates the repository's 1M-document tier
   (``CorpusSpec(num_docs=1_004_721, vocab=50_000, avg_distinct=40)``,
   one ``stream_batches`` batch of all docs) and bulk-builds it.
3. Puts the HOR and the packed index on the card and serves ``BATCHES``
   batches of 8 queries x 3 terms (df band 0.15-0.5, k = 10,
   cap = max_posting_len) through ``make_scorer(engine="fused")``, with
   every kernel launch counter reset just before and read just after.
4. Checks: each kernel was launched; each kernel equals its plain
   PyTorch version on the same routing pairs (values and ids, to the
   bit); the engine's ids equal the dense oracle's (``engine="torch"``),
   scores within rtol 1e-5; no routing overflow; HOR and packed agree.
5. Times each kernel and its plain version with CUDA events, in turns
   (kernel, plain, kernel) beside a reading of the card's clocks, computes
   its bound at 3.35 TB/s from the bytes this run's pairs must move, and
   prints the measurements, a ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Every failed check raises.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device-memory rate
F32_OPS_PER_S = 67e12         # H100 SXM f32 rate outside the tensor cores
NUM_DOCS, VOCAB, AVG_DISTINCT = 1_004_721, 50_000, 40
BATCH, TERMS, K = 8, 3, 10
BATCHES = 5                   # query batches served per layout
REPS = 5                      # timing rounds over all batches per turn
KERNELS = {
    "fused_topk_blocked": ("hor", "src/repro/kernels/fused_decode_score.py:513"),
    "fused_topk_packed": ("packed",
                          "src/repro/kernels/fused_decode_score.py:589"),
}


def smi(fields: str) -> str:
    """One ``nvidia-smi`` reading of ``fields`` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, calls, reps):
    """Mean ms per call of ``fn(*c)`` over ``reps`` rounds of ``calls``
    (round-robin over distinct batches, so each call finds the previous
    batch's blocks, not its own, in L2)."""
    import torch
    for c in calls:                       # warm-up
        fn(*c)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for c in calls:
            fn(*c)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * len(calls))


def kernel_work(kind, args, tile, q_real):
    """(bytes, ops) one call must move/do at least, from this call's
    pairs: each distinct routed block read once, the real pairs'
    routing rows, norm/rank of visited tiles, candidates written."""
    import torch
    if kind == "hor":
        (docs, tfs, pb, pt, pqw, pcap, norm, rank, qnorm, num_docs,
         k_tile) = args
        block_bytes = docs.shape[1] * 4 + tfs.shape[1] * 4
        pair_bytes = 4 + 4 + 4 * pqw.shape[1]
    else:
        (packed, tfs, pb, pt, pqw, pcap, bits, base, count, norm, rank,
         qnorm, num_docs, block, k_tile) = args
        block_bytes = packed.shape[1] * 4 + tfs.shape[1] * 2
        pair_bytes = 4 + 4 + 4 * pqw.shape[1] + 12
    n_tiles = -(-num_docs // tile)
    real = int(torch.searchsorted(
        pt, torch.tensor([n_tiles], dtype=pt.dtype, device=pt.device)))
    blocks = int(torch.unique(pb[:real]).numel())
    tiles = int(torch.unique(pt[:real]).numel())
    q = pqw.shape[1]
    out_bytes = q * n_tiles * k_tile * 8
    nbytes = (blocks * block_bytes + real * pair_bytes + (n_tiles + 1) * 4
              + tiles * tile * 8 + q * 4 + out_bytes)
    # per posting lane: Q products + Q adds; per (query, doc) of a
    # visited tile: the 5-op scoring tail and k_tile compares
    ops = (blocks * 128 * 2 * q_real
           + q_real * tiles * tile * (5 + k_tile))
    return nbytes, ops, real, blocks, tiles


def same_candidates(a, b):
    import torch
    (va, ia), (vb, ib) = a, b
    if not (torch.equal(ia, ib) and torch.equal(va.isfinite(),
                                                vb.isfinite())):
        return False, float("inf")
    fin = va.isfinite()
    err = float((va[fin] - vb[fin]).abs().max()) if fin.any() else 0.0
    bits_equal = torch.equal(va.view(torch.int32), vb.view(torch.int32))
    return bits_equal, err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None,
                    help="also write the measurements to this JSON file")
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import build, layouts, query
    from repro_torch.kernels import cuda_build, fused_decode_score as fds
    from repro_torch.kernels import ops
    from repro_torch.text import corpus

    report: dict = {}
    dev = torch.device("cuda", 0)

    # 1. kernels + card ---------------------------------------------------
    t0 = time.perf_counter()
    ptxas = cuda_build.build()
    report["build_s"] = time.perf_counter() - t0
    for name, log in ptxas.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    card = smi("name,power.limit")
    print(f"card: {card}")
    print(f"nvcc build: {report['build_s']:.2f} s "
          f"({len(ptxas)} kernels compiled)")

    # 2. corpus -----------------------------------------------------------
    t0 = time.perf_counter()
    spec = corpus.CorpusSpec(num_docs=NUM_DOCS, vocab=VOCAB,
                             avg_distinct=AVG_DISTINCT, seed=a.seed)
    host = build.bulk_build(next(corpus.stream_batches(
        spec, batch_docs=spec.num_docs)))
    report["corpus"] = {"docs": host.num_docs, "terms": host.num_terms,
                        "postings": host.num_postings,
                        "max_posting_len": host.max_posting_len,
                        "build_s": time.perf_counter() - t0}
    print(f"corpus: {json.dumps(report['corpus'])}")
    cap = host.max_posting_len
    batches = [corpus.sample_query_terms(
        host.df, host.term_hashes, BATCH, TERMS, df_band=(0.15, 0.5),
        num_docs=host.num_docs, seed=a.seed * 1000 + i)
        for i in range(BATCHES)]

    # 3-4. each layout on the card ----------------------------------------
    kernel_rows = []
    ids_by_layout = {}
    builders = {"hor": layouts.build_blocked,
                "packed": layouts.build_packed_csr}
    for name, (kind, replaces) in KERNELS.items():
        t0 = time.perf_counter()
        ix = builders[kind](host, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        wrapper = getattr(fds, name)
        plain = getattr(fds, name + "_plain")
        fused = query.make_scorer(ix, k=K, cap=cap, engine="fused",
                                  return_stats=True)
        oracle = query.make_scorer(ix, k=K, cap=cap, engine="torch")

        fused(batches[0])                 # warm-up (allocator, lib load)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fds.fused_topk_blocked.launches = 0
        fds.fused_topk_packed.launches = 0
        results, e2e_ms = [], []
        for qb in batches:
            t0 = time.perf_counter()
            res, stats = fused(qb)
            torch.cuda.synchronize()
            e2e_ms.append((time.perf_counter() - t0) * 1e3)
            results.append((res, stats))
        launches = {n: getattr(fds, n).launches for n in KERNELS}
        peak = torch.cuda.max_memory_allocated(dev)
        if launches[name] < len(batches):
            raise AssertionError(f"{name}: {launches[name]} launches for "
                                 f"{len(batches)} batches")
        if any(launches[n] for n in KERNELS if n != name):
            raise AssertionError(f"{kind} index launched {launches}")

        ids_all, oracle_ms = [], []
        for qb, (res, stats) in zip(batches, results):
            if stats["pair_overflow"] != 0:
                raise AssertionError(f"{kind}: overflow {stats}")
            ids = res.doc_ids.cpu().numpy()
            sc = res.scores.cpu().numpy()
            if ids.shape != (BATCH, K) or not np.isfinite(sc).all():
                raise AssertionError(f"{kind}: bad result {ids.shape}")
            if not ((ids >= 0) & (ids < host.num_docs)).all():
                raise AssertionError(f"{kind}: ids out of range / missing")
            t0 = time.perf_counter()
            ref = oracle(qb)
            ref_ids = ref.doc_ids.cpu().numpy()
            oracle_ms.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(ids, ref_ids):
                raise AssertionError(f"{kind}: engine ids != oracle ids\n"
                                     f"{ids}\n{ref_ids}")
            np.testing.assert_allclose(sc, ref.scores.cpu().numpy(),
                                       rtol=1e-5, atol=0)
            ids_all.append(ids)
        ids_by_layout[kind] = np.stack(ids_all)

        # kernel vs plain on the very same routing pairs
        calls, work, pairs_ms = [], [], []
        for qb in batches:
            t0 = time.perf_counter()
            qh = layouts.hash_tensor(qb, dev)
            term_ids, idf_t = query.lookup_query(ix, qh)
            _, _, args, kw, _ = ops.fused_topk_args(ix, term_ids, idf_t,
                                                    cap, K)
            torch.cuda.synchronize()
            pairs_ms.append((time.perf_counter() - t0) * 1e3)
            calls.append(args)
            work.append(kernel_work(kind, args, kw["tile"], BATCH))
        max_err, bit_equal = 0.0, True
        for args in calls:
            got = wrapper(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            eq, err = same_candidates(got, want)
            bit_equal &= eq
            max_err = max(max_err, err)
        if not bit_equal:
            raise AssertionError(f"{name}: kernel != plain version "
                                 f"(max abs err {max_err})")
        # in turns (kernel, plain, kernel) on this card, with the clocks
        # read while the card is warm
        ms_first = event_ms(lambda *c: wrapper(*c, **kw), calls, REPS)
        plain_ms = event_ms(lambda *c: plain(*c, **kw), calls, 1)
        ms_second = event_ms(lambda *c: wrapper(*c, **kw), calls, REPS)
        clocks = smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")
        ms = (ms_first + ms_second) / 2
        nbytes = float(np.mean([w[0] for w in work]))
        nops = float(np.mean([w[1] for w in work]))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        layout_report = {
            "index_build_s": build_s, "device_bytes": ix.nbytes(),
            "words_per_block": getattr(ix, "words_per_block", None),
            "posting_bytes": ix.posting_bytes(),
            "e2e_ms_per_batch": e2e_ms,
            "pairs_ms_per_batch": pairs_ms,
            "oracle_ms_per_batch": oracle_ms,
            "launches": launches[name],
            "real_pairs_per_batch": [w[2] for w in work],
            "distinct_blocks_per_batch": [w[3] for w in work],
            "visited_tiles_per_batch": [w[4] for w in work],
            "max_pairs": int(calls[0][2].shape[0]),
            "bytes_per_batch": nbytes, "ops_per_batch": nops,
            "kernel_ms": ms, "kernel_ms_turns": [ms_first, ms_second],
            "plain_ms": plain_ms,
            "clocks_sm_mem_power_temp": clocks,
            "bound_ms": max(t_bytes, t_ops),
            "max_memory_allocated": peak,
        }
        report[kind] = layout_report
        print(f"{kind}: {json.dumps(layout_report)}")
        kernel_rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
        del ix, fused, oracle, calls
        torch.cuda.empty_cache()

    if not np.array_equal(ids_by_layout["hor"], ids_by_layout["packed"]):
        raise AssertionError("HOR and packed engines rank differently")

    kinfo = {"kernels": kernel_rows}
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(
            {**report, **kinfo, "card": card}, indent=1) + "\n")
    print(json.dumps(kinfo))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
