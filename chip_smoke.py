#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's query paths on one GPU and check them.

    python3 chip_smoke.py [--seed 7] [--out FILE]

1. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and prints the card's name and
   power limit.
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
   (kernel, plain, kernel) beside a reading of the card's clocks, and
   computes its bound at 3.35 TB/s from the bytes this run's pairs must
   move.
6. The live phase, on the same corpus: ``SegmentedIndex.from_host(host,
   seal_layout="banded")`` (one banded segment over all docs), 50,000
   new docs (``CorpusSpec(num_docs=50_000, ..., seed=seed+1)``) ingested
   through a 16,384-doc delta as four 10,000-doc seals (which the tiered
   policy merges), an HOR seal, a packed seal and a 300-doc delta tail,
   with every 64th doc deleted.  Serves ``BATCHES`` batches through
   ``LiveView.topk(mode="candidates")``, then ``BATCHES`` through
   ``mode="dense"``, each mode with every launch counter reset just
   before and read just after.  The kernel calls of each mode's last
   batch are recorded as the path makes them; each is then held to its
   plain version on the same arguments, to the bit, and timed (one
   call repeated: its blocks may sit in L2).  A check batch of HOR-band
   terms, which the served df band lacks, gives the 1M-doc segment's
   HOR band real pairs and is held the same way (not timed).  Checks
   that all four kernels launched, that there was no routing overflow,
   and that ids and scores hold to the gather oracle
   (``engine="torch"``).
7. Prints per-phase wall times, a ``{"kernels": [...]}`` line with all
   four kernels (means per launch over every counted call site of both
   paths) and, last, ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Every failed check raises.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
DENSE_KERNELS = {
    "fused_score_blocked": ("hor",
                            "src/repro/kernels/fused_decode_score.py:309"),
    "fused_score_packed": ("packed",
                           "src/repro/kernels/fused_decode_score.py:342"),
}
ALL_KERNELS = (*KERNELS, *DENSE_KERNELS)
# live phase: the 1m tier's ingest batch and delta (benchmarks/campaign.py)
NEW_DOCS, DELTA_DOCS = 50_000, 16_384
SEALS = ((0, 10_000, None), (10_000, 20_000, None), (20_000, 30_000, None),
         (30_000, 40_000, None), (40_000, 44_850, "hor"),
         (44_850, 49_700, "packed"))     # then 49_700..50_000 stay in delta
NEAR_TIE = 1e-6


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


def dense_work(kind, args, tile, q_real):
    """(bytes, ops) one dense call must move/do at least: each distinct
    routed block read once, the real pairs' routing rows, and the
    Q x num_docs f32 scores written."""
    import torch
    if kind == "hor":
        docs, tfs, pb, pt, pqw, pcap, num_docs = args
        block_bytes = docs.shape[1] * 4 + tfs.shape[1] * 4
        pair_bytes = 4 + 4 + 4 + 4 * pqw.shape[1]
    else:
        (packed, tfs, pb, pt, pqw, pcap, bits, base, count, num_docs,
         block) = args
        block_bytes = packed.shape[1] * 4 + tfs.shape[1] * 2
        pair_bytes = 4 + 4 + 4 + 4 * pqw.shape[1] + 12
    n_tiles = -(-num_docs // tile)
    real = int(torch.searchsorted(
        pt, torch.tensor([n_tiles], dtype=pt.dtype, device=pt.device)))
    blocks = int(torch.unique(pb[:real]).numel())
    q = pqw.shape[1]
    nbytes = (blocks * block_bytes + real * pair_bytes + (n_tiles + 1) * 4
              + q * num_docs * 4)
    # per posting lane of a routed pair: one multiply-add per real query
    ops = real * 128 * 2 * q_real
    return nbytes, ops, real, blocks


def time_in_turns(run, run_plain, calls):
    """Kernel, plain, kernel timings (ms per call) of ``run(*c)`` and
    ``run_plain(*c)`` over ``calls``, and the card's clocks read right
    after, while it is warm."""
    ms_first = event_ms(run, calls, REPS)
    plain_ms = event_ms(run_plain, calls, 1)
    ms_second = event_ms(run, calls, REPS)
    clocks = smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")
    return (ms_first + ms_second) / 2, [ms_first, ms_second], plain_ms, \
        clocks


def reset_launches(fds):
    for name in ALL_KERNELS:
        getattr(fds, name).launches = 0


def near_tie_swaps(ids, scores, ref_ids, ref_scores, k):
    """Positions where the engine's ids differ from the oracle's.  Each
    must sit at an oracle near-tie — its score within NEAR_TIE relative
    of an adjacent oracle score (the oracle has k+1 entries) — where the
    fused engines' other grouping of a doc's adds may swap two docs; any
    other difference raises.  Scores agree within rtol 1e-5."""
    import numpy as np
    np.testing.assert_allclose(scores, ref_scores[:, :k], rtol=1e-5, atol=0)
    cases = []
    for q, j in zip(*np.nonzero(ids != ref_ids[:, :k])):
        s = ref_scores[q]
        near = [i for i in (j - 1, j + 1)
                if abs(s[j] - s[i]) <= NEAR_TIE * abs(s[j])]
        if not near:
            raise AssertionError(
                f"query {q} rank {j}: engine id {ids[q, j]} != oracle id "
                f"{ref_ids[q, j]} at score {s[j]!r}, no near tie")
        cases.append({"query": int(q), "rank": int(j),
                      "engine_id": int(ids[q, j]),
                      "oracle_id": int(ref_ids[q, j]),
                      "oracle_score": float(s[j]),
                      "neighbour_score": float(s[near[0]])})
    return cases


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

    phase_s = {}
    t_phase = time.perf_counter()

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
    sites = []
    ids_by_layout = {}
    builders = {"hor": layouts.build_blocked,
                "packed": layouts.build_packed_csr}
    for name, (kind, _) in KERNELS.items():
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
        reset_launches(fds)
        results, e2e_ms = [], []
        for qb in batches:
            t0 = time.perf_counter()
            res, stats = fused(qb)
            torch.cuda.synchronize()
            e2e_ms.append((time.perf_counter() - t0) * 1e3)
            results.append((res, stats))
        launches = {n: getattr(fds, n).launches for n in ALL_KERNELS}
        peak = torch.cuda.max_memory_allocated(dev)
        if launches[name] < len(batches):
            raise AssertionError(f"{name}: {launches[name]} launches for "
                                 f"{len(batches)} batches")
        if any(launches[n] for n in ALL_KERNELS if n != name):
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
        ms, turns, plain_ms, clocks = time_in_turns(
            lambda *c: wrapper(*c, **kw), lambda *c: plain(*c, **kw), calls)
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
            "kernel_ms": ms, "kernel_ms_turns": turns,
            "plain_ms": plain_ms,
            "clocks_sm_mem_power_temp": clocks,
            "bound_ms": max(t_bytes, t_ops),
            "max_memory_allocated": peak,
        }
        report[kind] = layout_report
        print(f"{kind}: {json.dumps(layout_report)}")
        sites.append({
            "site": f"bulk:{name}@{host.num_docs}", "kernel": name,
            "launches": launches[name], "max_abs_err": max_err,
            "kernel_ms": ms, "plain_ms": plain_ms, "t_bytes_ms": t_bytes,
            "t_ops_ms": t_ops})
        del ix, fused, oracle, calls
        torch.cuda.empty_cache()

    if not np.array_equal(ids_by_layout["hor"], ids_by_layout["packed"]):
        raise AssertionError("HOR and packed engines rank differently")
    phase_s["bulk"] = time.perf_counter() - t_phase
    print(f"phase bulk: {phase_s['bulk']:.1f} s")

    t_phase = time.perf_counter()
    sites += live_phase(host, batches, a.seed, dev, report)
    phase_s["live"] = time.perf_counter() - t_phase
    print(f"phase live: {phase_s['live']:.1f} s")
    report["phase_s"] = phase_s

    kinfo = {"kernels": kernel_rows(sites)}
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


@contextlib.contextmanager
def recording(ops, on=True):
    """Record every kernel call the path makes through ``ops`` (the
    module whose names the engines call) as (name, args, kwargs), while
    still launching the real wrappers, so the calls checked afterwards
    are the path's own."""
    calls = []
    saved = {n: getattr(ops, n) for n in ALL_KERNELS}

    def rec(name, fn):
        def call(*args, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return call
    if on:
        for n, fn in saved.items():
            setattr(ops, n, rec(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def replay(calls, fds, label, timed=True):
    """Holds each recorded kernel call against its plain version on the
    same arguments, to the bit, and (``timed``) times both in turns.
    Returns one dict per call (a call site of the path)."""
    import torch
    sites = []
    for i, (name, args, kw) in enumerate(calls):
        wrapper, plain = getattr(fds, name), getattr(fds, name + "_plain")
        pkw = {k: v for k, v in kw.items() if k != "reducer"}
        got, want = wrapper(*args, **kw), plain(*args, **pkw)
        torch.cuda.synchronize()
        if name in DENSE_KERNELS:
            err = float((got - want).abs().max())
            eq = torch.equal(got.view(torch.int32), want.view(torch.int32))
            nbytes, nops, real, blocks = dense_work(
                DENSE_KERNELS[name][0], args, kw["tile"], BATCH)
            num_docs = args[-1 if name == "fused_score_blocked" else -2]
        else:
            eq, err = same_candidates(got, want)
            nbytes, nops, real, blocks, _ = kernel_work(
                KERNELS[name][0], args, kw["tile"], BATCH)
            num_docs = args[-2 if name == "fused_topk_blocked" else -3]
        site = {"site": f"{label}#{i}:{name}@{num_docs}", "kernel": name,
                "num_docs": int(num_docs),
                "max_pairs": int(args[2].shape[0]), "real_pairs": real,
                "distinct_blocks": blocks, "bytes": nbytes, "ops": nops,
                "t_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "t_ops_ms": nops / F32_OPS_PER_S * 1e3,
                "max_abs_err": err}
        if not eq:
            raise AssertionError(f"{site['site']}: kernel != plain version "
                                 f"(max abs err {err})")
        if timed:
            ms, turns, plain_ms, clocks = time_in_turns(
                lambda *c: wrapper(*c, **kw), lambda *c: plain(*c, **pkw),
                [args])
            site.update(kernel_ms=ms, kernel_ms_turns=turns,
                        plain_ms=plain_ms, clocks_sm_mem_power_temp=clocks)
        sites.append(site)
        print(f"live kernel site: {json.dumps(site)}")
    return sites


def hor_band_batch(view, batches):
    """A batch whose queries each hold two HOR-band terms of the largest
    banded segment (the densest such terms) beside one query term of
    ``batches[0]``: the served df band holds no HOR-band term, so this
    is the batch that gives that band's dense kernel real pairs."""
    import numpy as np
    import torch
    seg = max((s for s in view.segments if s.layout == "banded"),
              key=lambda s: int(s.index.docs.num_docs))
    df = seg.index.hor.df.cpu().numpy()
    order = np.argsort(-df, kind="stable")[:2 * BATCH]
    if df[order[-1]] == 0:
        raise AssertionError("the banded segment's HOR band holds too few "
                             "terms for a check batch")
    hashes = seg.index.sorted_hash.cpu().numpy().view(np.uint32)[order]
    qb = np.asarray(batches[0]).copy()
    qb[:, 1:] = hashes.reshape(BATCH, 2)
    return qb, int(seg.index.docs.num_docs)


def live_phase(host, batches, seed, dev, report):
    """The live index at the 1M tier (step 6 of the module docstring);
    returns its per-call-site kernel measurements."""
    import numpy as np
    import torch

    from repro_torch.core import build, live_index
    from repro_torch.kernels import ops
    from repro_torch.kernels import fused_decode_score as fds
    from repro_torch.text import corpus

    live: dict = {}
    t0 = time.perf_counter()
    si = live_index.SegmentedIndex.from_host(
        host, seal_layout="banded", delta_doc_capacity=DELTA_DOCS,
        delta_posting_capacity=DELTA_DOCS * 64, device=dev)
    torch.cuda.synchronize()
    live["from_host_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    new = corpus.generate(corpus.CorpusSpec(
        num_docs=NEW_DOCS, vocab=VOCAB, avg_distinct=AVG_DISTINCT,
        seed=seed + 1))

    def part(lo, hi):
        return build.TokenizedCorpus(new.doc_term_ids[lo:hi],
                                     new.doc_counts[lo:hi],
                                     new.term_hashes, hi - lo)
    for i, (lo, hi, layout) in enumerate(SEALS):
        si.add_batch(part(lo, hi))
        si.seal(layout=layout)
        if i == 3:      # before the add that triggers the tiered merge
            si.delete(np.arange(0, si.num_docs, 64))
    si.add_batch(part(SEALS[-1][1], NEW_DOCS))
    si.delete(np.arange(0, si.num_docs, 64))
    torch.cuda.synchronize()
    live["ingest_s"] = time.perf_counter() - t0

    view = si.view()
    mix = view.layout_mix()
    live.update(layout_mix=mix["segments"], stats=dataclasses.asdict(
        si.stats), delta_docs=view.delta_n_docs, live_docs=view.live_docs,
        num_docs=view.num_docs)
    print(f"live index: {json.dumps(live)}")
    for lay in ("banded", "hor", "packed"):
        if not mix["counts"].get(lay):
            raise AssertionError(f"live index holds no {lay} segment: "
                                 f"{mix['counts']}")
    if si.stats.compactions < 1 or view.delta_n_docs == 0:
        raise AssertionError(f"need a compaction and a live delta: "
                             f"{si.stats}, delta {view.delta_n_docs}")

    # warm-up, one batch per mode; the peak is read over it (the counted
    # run below holds its last batch's kernel arguments for the checks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for mode in ("candidates", "dense"):
        view.topk(batches[0], K, mode=mode)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)

    # the main path, one mode at a time: every launch counted from zero
    # just before and read just after; the last batch's kernel calls are
    # recorded, then each is held to its plain version and timed
    served, launches, sites = {}, {}, []
    for mode in ("candidates", "dense"):
        reset_launches(fds)
        out, e2e_ms = [], []
        for i, qb in enumerate(batches):
            with recording(ops, on=i == len(batches) - 1) as calls:
                t0 = time.perf_counter()
                res, stats = view.topk(qb, K, mode=mode, return_stats=True)
                torch.cuda.synchronize()
                e2e_ms.append((time.perf_counter() - t0) * 1e3)
            if stats["pair_overflow"] != 0:
                raise AssertionError(f"live {mode}: overflow {stats}")
            out.append(res)
        launches[mode] = {n: getattr(fds, n).launches for n in ALL_KERNELS}
        served[mode] = (out, e2e_ms)
        for site in replay(calls, fds, mode):
            # every batch launches each of the path's sites once
            site.update(mode=mode, launches=len(batches))
            sites.append(site)
        del calls
        torch.cuda.empty_cache()
    print(f"live launches: {json.dumps(launches)}")
    for name in ALL_KERNELS:
        n = sum(c[name] for c in launches.values())
        if n == 0:
            raise AssertionError(f"{name} never launched on the live path")
        if n != sum(x["launches"] for x in sites if x["kernel"] == name):
            raise AssertionError(f"{name}: {n} launches, but the recorded "
                                 f"sites account for a different count")

    # where a batch's time goes: one traced pass per mode after the
    # counted run (spans time the host; merge includes the copy back)
    from repro_torch.obs.trace import Trace
    spans = {}
    for mode in ("candidates", "dense"):
        acc: dict = {}
        for qb in batches:
            trace = Trace()
            view.topk(qb, K, mode=mode, trace=trace)
            for sp in trace.spans:
                key = sp.name + (f"@{sp.attrs['doc_base']}"
                                 if sp.name == "segment" else "")
                acc[key] = acc.get(key, 0.0) + sp.duration_us / 1e3
        spans[mode] = {key: ms / len(batches) for key, ms in acc.items()}
    print(f"live spans ms per batch: {json.dumps(spans)}")

    # a check batch (not served traffic) that routes real pairs to the
    # largest banded segment's HOR band: every kernel call held to its
    # plain version, ids and scores to the oracle
    hb, hb_docs = hor_band_batch(view, batches)
    with recording(ops) as calls:
        hres, hstats = view.topk(hb, K, mode="dense", return_stats=True)
    hor_check = replay(calls, fds, "hor-band-check", timed=False)
    del calls
    band = [x for x in hor_check if x["kernel"] == "fused_score_blocked"
            and x["num_docs"] == hb_docs]
    if not band or band[0]["real_pairs"] == 0 or hstats["pair_overflow"]:
        raise AssertionError(f"HOR-band check batch: {band}, {hstats}")
    live["hor_band_check"] = hor_check

    # results against the gather oracle over the same view
    swaps, oracle_ms = [], []
    checked = [(i, qb, {m: v[0][i] for m, v in served.items()})
               for i, qb in enumerate(batches)]
    checked.append(("hor-band-check", hb, {"dense": hres}))
    for i, qb, by_mode in checked:
        t0 = time.perf_counter()
        ref = view.topk(qb, K + 1, engine="torch")
        oracle_ms.append((time.perf_counter() - t0) * 1e3)
        ref_ids, ref_sc = ref.doc_ids.cpu().numpy(), ref.scores.cpu().numpy()
        for mode, res in by_mode.items():
            ids = res.doc_ids.cpu().numpy()
            sc = res.scores.cpu().numpy()
            if ids.shape != (BATCH, K) or not np.isfinite(sc).all():
                raise AssertionError(f"live {mode}: bad result {ids.shape}")
            if not ((ids >= 0) & (ids < view.num_docs)).all() or \
                    not view.live[ids].all():
                raise AssertionError(f"live {mode}: missing or dead ids")
            for case in near_tie_swaps(ids, sc, ref_ids, ref_sc, K):
                case.update(batch=i, mode=mode)
                print(f"near-tie swap: {json.dumps(case)}")
                swaps.append(case)

    live.update(
        launches=launches, max_memory_allocated=peak,
        e2e_ms_per_batch={m: v[1] for m, v in served.items()},
        oracle_ms_per_batch=oracle_ms, near_tie_swaps=swaps,
        span_ms_per_batch=spans, kernel_sites=sites)
    print(f"live serving: {json.dumps({k: live[k] for k in ('launches', 'max_memory_allocated', 'e2e_ms_per_batch', 'oracle_ms_per_batch')})}")
    report["live"] = live
    del si, view
    torch.cuda.empty_cache()
    return sites


def kernel_rows(sites):
    """One row per kernel for the ``kernels`` line: ``launches`` sums
    the counted runs of every path, and ``ms``, ``plain_ms`` and
    ``bound_ms`` are means per launch (each call site weighted by its
    launches); the per-site numbers are printed above."""
    import numpy as np
    rows = []
    for name, (_, replaces) in {**KERNELS, **DENSE_KERNELS}.items():
        mine = [x for x in sites if x["kernel"] == name]
        if not mine:
            raise AssertionError(f"{name}: no call site on any path")
        w = [x["launches"] for x in mine]

        def mean(key):
            return float(np.average([x[key] for x in mine], weights=w))
        t_bytes, t_ops = mean("t_bytes_ms"), mean("t_ops_ms")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": int(sum(w)),
            "max_abs_err": max(x["max_abs_err"] for x in mine),
            "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    return rows


if __name__ == "__main__":
    sys.exit(main())
