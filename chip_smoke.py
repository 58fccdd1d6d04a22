#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

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
7. The paper phase, on the same corpus: the paper's four
   representations as Table 7 compares them, PR (``CooIndex``) and OR
   (``CsrIndex``) each with a B+tree (``SortedLookup``) and a hash
   (``HashLookup``) lookup, COR (``CompactCsrIndex``), HOR and packed,
   plus the direct index.  Table 7's protocol: 8 queries of each of 1-4
   terms (``sample_query_terms``, seed = the term count), k = 10, cap =
   max_posting_len.  With every launch counter reset just before and
   read just after, it runs ``blocked_query_scores`` on the HOR index
   for each of the 32 queries (``posting_score``) and ``unpack_postings``
   over every block of the packed index (``unpack_blocks``).  Checks:
   the seven oracles (``make_scorer(engine="torch")``) give identical
   ids and bit-equal scores; both lookups give the same term ids for
   the queries and for 64 absent hashes; every ``posting_score`` launch
   equals its plain version and the oracle's raw accumulation to the
   bit, with no routing overflow; the decode equals its plain version
   and, term by term, the host's doc ids; ``conjunctive_filter`` gives
   identical ids on all seven and every returned doc holds every query
   term (``BlockedIndex.contains``); ``expand_query`` on each query's
   top 10 equals ``expand_query_scan`` over PR and over OR;
   ``relevance_feedback`` runs; after ``delete_docs`` of each query's
   top doc, no representation returns it.  Prints Tables 5-7 (bytes
   beside the size model, lookup bytes, ms per query) and times both
   kernels, their plain versions and, for the posting scorer, the one
   PyTorch call that computes its sum (``index_add_``).
8. The model phase: the three model kernels through their entry points
   (``ops.embedding_bag``, ``ops.pna_multi_agg``, ``ops.attention``) at
   the widths of the repository's model configurations, inputs made on
   the card from ``--seed``: xDeepFM's fused field table (39 fields x
   1,000,000 rows, d = 10, rows padded to 512) under a serve_bulk batch
   of 262,144 one-hot rows and a serve_p99 batch of 512 multi-hot rows
   (8 slots, a quarter padding); PNA's hidden features (d = 75) over
   ogbn-products (2,449,408 nodes, padded degree 64, degrees 37-64) and
   a Reddit minibatch (fanout 15, 10 from 1,024 seeds, a tenth of the
   nodes without neighbours); causal attention at S = 4,096 for
   Qwen3-0.6B (16 q / 8 kv heads, d 128, bf16 at batch 2, f32 at batch
   1) and Gemma-3-4B (8 / 4 heads, d 256, bf16, batch 2, a local layer's
   1,024 window and a global layer).  With every launch counter reset
   just before and read just after, each site is called once; each
   kernel must launch once per site and the six others never.  Checks:
   the bag and PNA equal their plain versions to the bit, attention
   within 2e-4 (f32) or 3e-2 (bf16), and a bf16 site also within one
   bf16 rounding (rtol 8e-3, atol 1e-3) of the plain version run in f32
   on the same inputs; PNA equals the model's segment
   aggregation written as ``scatter_reduce`` (a 1/16 slice of
   ogbn-products); Qwen3's bf16 site equals a mirror of the models'
   ``chunked_attention`` within 3e-2.  Times each site in turns with
   its plain version, beside its bound and the one PyTorch call that
   computes it (``F.embedding_bag``, ``F.scaled_dot_product_attention``;
   none for PNA).
9. Prints per-phase wall times, a ``{"kernels": [...]}`` line with all
   nine kernels (means per launch over every counted call site of the
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
FUSED_KERNELS = (*KERNELS, *DENSE_KERNELS)
PAPER_KERNELS = {
    "posting_score": "src/repro/kernels/posting_score.py:87",
    "unpack_blocks": "src/repro/kernels/packed_postings.py:46",
}
MODEL_KERNELS = {
    "embedding_bag": "src/repro/kernels/embedding_bag.py:46",
    "pna_multi_agg": "src/repro/kernels/segment_multi_agg.py:59",
    "flash_attention": "src/repro/kernels/flash_attention.py:78",
}
ALL_KERNELS = (*FUSED_KERNELS, *PAPER_KERNELS, *MODEL_KERNELS)
# live phase: the 1m tier's ingest batch and delta (benchmarks/campaign.py)
NEW_DOCS, DELTA_DOCS = 50_000, 16_384
SEALS = ((0, 10_000, None), (10_000, 20_000, None), (20_000, 30_000, None),
         (30_000, 40_000, None), (40_000, 44_850, "hor"),
         (44_850, 49_700, "packed"))     # then 49_700..50_000 stay in delta
NEAR_TIE = 1e-6
# paper phase: Table 7's seven indexes and its protocol
# (benchmarks/table7_query.py)
SEVEN = ("pr_btree", "pr_hash", "or_btree", "or_hash", "cor", "hor",
         "packed")
SIZE_LAYOUT = {"pr_btree": "pr", "pr_hash": "pr", "or_btree": "or",
               "or_hash": "or", "cor": "cor", "hor": "hor",
               "packed": "packed"}
PAPER_TERMS = (1, 2, 3, 4)
# model phase: the model kernels at the widths of the repository's configs
XDEEPFM_FIELDS, XDEEPFM_VOCAB, XDEEPFM_DIM = 39, 1_000_000, 10  # xdeepfm.py
XDEEPFM_BULK, XDEEPFM_P99, MULTI_HOT = 262_144, 512, 8
PNA_DIM = 75                                     # pna.py d_hidden
OGB_NODES, OGB_K, OGB_DEG = 2_449_408, 64, (37, 64)   # pna.py ogb_products
MB_SEEDS, MB_FANOUT = 1024, (15, 10)             # pna.py minibatch_lg
MB_NODES = MB_SEEDS * (1 + 15 + 150)
ATTN_SEQ = 4096                                  # the LM configs' train_4k
ATTN_SITES = {       # site: (batch, Hq, Hkv, head dim, window, dtype name)
    "attn@qwen3_0.6b": (2, 16, 8, 128, 0, "bfloat16"),
    "attn@gemma3_4b_local": (2, 8, 4, 256, 1024, "bfloat16"),
    "attn@gemma3_4b_global": (2, 8, 4, 256, 0, "bfloat16"),
    "attn@qwen3_0.6b_f32": (1, 16, 8, 128, 0, "float32"),
}
# a bf16 site's kernel against the plain version in f32, rounded to bf16:
# one bf16 rounding apart at most (2**-7 of the value), above a floor
BF16_RTOL, BF16_ATOL = 8e-3, 1e-3
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core rate


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


# the side kernels' symbols, as the profiler names their device activity
SYMBOLS = {"posting_score": "posting_score_kernel",
           "unpack_blocks": "unpack_kernel"}


def device_ms(runs):
    """Mean device time per launch of each kernel alone (no wrapper
    work, no other kernel), from ONE ``torch.profiler`` trace of a round
    of ``fn(*c)`` over ``calls`` for every ``name: (fn, calls)`` of
    ``runs``; None for a kernel the trace shows no device time for.  A
    trace slows the launches timed after it, so it runs once, after
    every event timing of the script."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn, calls in runs.values():
            for c in calls:
                fn(*c)
        torch.cuda.synchronize()
    out = {}
    for name in runs:
        total, count = 0.0, 0
        for e in prof.key_averages():
            if SYMBOLS[name] in e.key:
                total += getattr(e, "device_time_total", 0.0)
                count += e.count
        out[name] = total / count / 1e3 if count and total > 0 else None
    return out


def time_in_turns(run, run_plain, calls):
    """Kernel, plain, kernel timings (ms per call) of ``run(*c)`` and
    ``run_plain(*c)`` over ``calls`` (CUDA events, wrapper included),
    and the card's clocks read right after, while it is warm."""
    ms_first = event_ms(run, calls, REPS)
    plain_ms = event_ms(run_plain, calls, 1)
    ms_second = event_ms(run, calls, REPS)
    clocks = smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")
    return (ms_first + ms_second) / 2, [ms_first, ms_second], plain_ms, \
        clocks


def wrappers():
    """Each kernel's wrapper, by name (its ``.launches`` count)."""
    from repro_torch.kernels import fused_decode_score as fds
    from repro_torch.kernels import packed_postings, posting_score
    out = {n: getattr(fds, n) for n in FUSED_KERNELS}
    out.update(posting_score=posting_score.posting_score,
               unpack_blocks=packed_postings.unpack_blocks)
    from repro_torch.kernels import embedding_bag, flash_attention
    from repro_torch.kernels import segment_multi_agg
    out.update(embedding_bag=embedding_bag.embedding_bag,
               pna_multi_agg=segment_multi_agg.pna_multi_agg,
               flash_attention=flash_attention.flash_attention)
    return out


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


def read_launches():
    return {n: fn.launches for n, fn in wrappers().items()}


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
        reset_launches()
        results, e2e_ms = [], []
        for qb in batches:
            t0 = time.perf_counter()
            res, stats = fused(qb)
            torch.cuda.synchronize()
            e2e_ms.append((time.perf_counter() - t0) * 1e3)
            results.append((res, stats))
        launches = read_launches()
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

    t_phase = time.perf_counter()
    sites += paper_phase(host, dev, report)
    phase_s["paper"] = time.perf_counter() - t_phase
    print(f"phase paper: {phase_s['paper']:.1f} s")

    t_phase = time.perf_counter()
    sites += model_phase(a.seed, dev, report)
    phase_s["model"] = time.perf_counter() - t_phase
    print(f"phase model: {phase_s['model']:.1f} s")
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
    saved = {n: getattr(ops, n) for n in FUSED_KERNELS}

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
        reset_launches()
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
        launches[mode] = read_launches()
        served[mode] = (out, e2e_ms)
        for site in replay(calls, fds, mode):
            # every batch launches each of the path's sites once
            site.update(mode=mode, launches=len(batches))
            sites.append(site)
        del calls
        torch.cuda.empty_cache()
    print(f"live launches: {json.dumps(launches)}")
    for name in FUSED_KERNELS:
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


def absent_hashes(term_hashes, n, seed):
    """``n`` u32 hashes that are not in the vocabulary (nor 0)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    taken = set(int(x) for x in term_hashes)
    out = []
    while len(out) < n:
        h = int(rng.integers(1, 2**32))
        if h not in taken:
            out.append(h)
            taken.add(h)
    return np.asarray(out, np.uint32)


def paper_phase(host, dev, report):
    """The paper's representation comparison at the 1M tier (step 7 of
    the module docstring); returns the two side kernels' sites."""
    import numpy as np
    import torch

    from repro_torch.core import direct_index, layouts, query, size_model
    from repro_torch.kernels import ops
    from repro_torch.kernels import packed_postings as pp
    from repro_torch.kernels import posting_score as ps
    from repro_torch.text import corpus

    paper: dict = {}
    cap = host.max_posting_len
    W, D = host.num_terms, host.num_docs
    torch.cuda.reset_peak_memory_stats(dev)

    # builds: each posting set once; the _hash twins swap the lookup
    build_s = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
        return out
    btree = timed("btree_lookup",
                  lambda: layouts.build_sorted_lookup(host.term_hashes, dev))
    hashlk = timed("hash_lookup",
                   lambda: layouts.build_hash_lookup(host.term_hashes, dev))
    pr = timed("pr", lambda: layouts.build_coo(host, device=dev))
    orr = timed("or", lambda: layouts.build_csr(host, device=dev))
    ix = {"pr_btree": pr,
          "pr_hash": dataclasses.replace(pr, lookup=hashlk),
          "or_btree": orr,
          "or_hash": dataclasses.replace(orr, lookup=hashlk),
          "cor": timed("cor", lambda: layouts.build_compact_csr(
              host, device=dev)),
          "hor": timed("hor", lambda: layouts.build_blocked(host,
                                                            device=dev)),
          "packed": timed("packed", lambda: layouts.build_packed_csr(
              host, device=dev))}
    direct = timed("direct", lambda: direct_index.build_direct(
        host, device=dev))
    paper["build_s"] = build_s
    paper["device_bytes_allocated"] = torch.cuda.memory_allocated(dev)
    print(f"paper builds (s): {json.dumps(build_s)}")

    # Table 5: bytes per representation beside the size model
    seg = size_model.SegmentStats(num_docs=D, num_postings=host.num_postings,
                                  num_terms=W)
    cs = size_model.CorpusStats(D=D, W=W, N_d=host.num_postings)
    table5 = {name: {"nbytes": x.nbytes(), "posting_bytes": x.posting_bytes(),
                     "est_posting_bytes": size_model.est_posting_bytes(
                         seg, SIZE_LAYOUT[name])}
              for name, x in ix.items()}
    table5["direct"] = {"nbytes": direct.nbytes()}
    table5["model"] = {
        "pr_bytes": size_model.pr_bytes(cs),
        "orif_bytes": size_model.orif_bytes(cs),
        "pr_over_orif": size_model.pr_over_orif(cs),
        "pr_pages": size_model.pages(size_model.pr_bytes(cs)),
        "orif_pages": size_model.pages(size_model.orif_bytes(cs)),
        "coo_layout_bytes": size_model.coo_layout_bytes(cs),
        "csr_layout_bytes": size_model.csr_layout_bytes(cs),
        "packed_csr_layout_bytes": size_model.packed_csr_layout_bytes(cs)}
    for name in ("pr_btree", "or_btree", "cor"):
        if table5[name]["posting_bytes"] != table5[name]["est_posting_bytes"]:
            raise AssertionError(f"table 5 {name}: {table5[name]}")
    paper["table5"] = table5
    print(f"table 5 (bytes): {json.dumps(table5)}")

    # Table 7's protocol: 8 queries of 1-4 terms from the df band
    batches = {n: corpus.sample_query_terms(
        host.df, host.term_hashes, BATCH, n, num_docs=D, seed=n)
        for n in PAPER_TERMS}
    qhs = {n: layouts.hash_tensor(qb, dev) for n, qb in batches.items()}

    # Table 6: both lookups on the queries' hashes and on absent ones
    probe = layouts.hash_tensor(np.concatenate(
        [np.concatenate([b.reshape(-1) for b in batches.values()]),
         absent_hashes(host.term_hashes, 64, 6)]), dev)
    got_b, got_h = btree.lookup(probe), hashlk.lookup(probe)
    if not torch.equal(got_b, got_h) or bool((got_b[:-64] < 0).any()) \
            or bool((got_b[-64:] != -1).any()):
        raise AssertionError("btree and hash lookups disagree")
    look_ms = {k: event_ms(lk.lookup, [(probe,)], REPS)
               for k, lk in (("btree", btree), ("hash", hashlk))}
    paper["table6"] = {
        "btree_bytes": btree.nbytes(), "hash_bytes": hashlk.nbytes(),
        "hash_slots": int(hashlk.keys.shape[0]),
        "cor_folded_bytes": (ix["cor"].sorted_hash.numel()
                             + ix["cor"].df.numel()) * 4,
        "lookup_ms_per_call": look_ms, "hashes_per_call": probe.numel()}
    print(f"table 6: {json.dumps(paper['table6'])}")

    # 1. the seven representations through the oracle (Table 7)
    ms7, results = {}, {}
    for name, x in ix.items():
        scorer = query.make_scorer(x, k=K, cap=cap, engine="torch")
        scorer(qhs[1])                                   # warm-up
        ms7[name], results[name] = {}, {}
        for n, qh in qhs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = scorer(qh)
            torch.cuda.synchronize()
            ms7[name][n] = (time.perf_counter() - t0) * 1e3 / BATCH
            results[name][n] = r
    base = results["pr_btree"]
    for name in SEVEN:
        for n in PAPER_TERMS:
            r = results[name][n]
            if r.doc_ids.shape != (BATCH, K) or \
                    not bool(torch.isfinite(r.scores).all()) or \
                    bool((r.doc_ids < 0).any()):
                raise AssertionError(f"{name} {n}t: bad result")
            if not torch.equal(r.doc_ids, base[n].doc_ids) or not \
                    torch.equal(r.scores.view(torch.int32),
                                base[n].scores.view(torch.int32)):
                raise AssertionError(f"{name} {n}t ranks unlike pr_btree")

    hor, packed = ix["hor"], ix["packed"]
    tfirst, tcount, n_tiles = ops.routing_spans(hor, ps.TILE)
    # warm-up (library loads), then the main path: every counter from
    # zero just before, read just after
    tids, idf_w = query.lookup_query(hor, qhs[1])
    ops.blocked_query_scores(hor, tids[0], idf_w[0], hor.max_blocks_per_term,
                             1 << 16)
    pp.unpack_blocks(packed.packed[:1], packed.block_bits[:1],
                     packed.block_base[:1], packed.block_count[:1],
                     packed.block)
    torch.cuda.synchronize()
    reset_launches()
    single, ms_single = [], {}
    for n, qh in qhs.items():
        tids, idf_w = query.lookup_query(hor, qh)
        ms = []
        for t, w in zip(tids, idf_w):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sel, valid, sw = ops.select_query_blocks(
                hor, t, w, hor.max_blocks_per_term)
            max_pairs = max(int(tcount[sel.long()][valid].sum()), 1)
            scores, ovf = ops.blocked_query_scores(
                hor, t, w, hor.max_blocks_per_term, max_pairs)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            single.append((t, w, sel, valid, sw, max_pairs, scores,
                           int(ovf)))
        ms_single[n] = ms
    t0 = time.perf_counter()
    decoded = ops.unpack_postings(packed)
    torch.cuda.synchronize()
    unpack_e2e_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    print(f"paper launches: {json.dumps(launches)}")
    if launches["posting_score"] != BATCH * len(PAPER_TERMS) or \
            launches["unpack_blocks"] != 1 or \
            any(launches[k] for k in FUSED_KERNELS):
        raise AssertionError(f"paper path launches {launches}")
    ms7["hor_posting_score"] = {n: float(np.mean(v))
                                for n, v in ms_single.items()}
    paper["table7_ms_per_query"] = ms7
    print(f"table 7 (ms per query): {json.dumps(ms7)}")

    # 2. each posting_score launch against its plain version and the
    # oracle's raw accumulation, to the bit
    calls, lib_calls, work = [], [], []
    nb_docs = hor.block_docs.shape[1]
    for t, w, sel, valid, sw, max_pairs, scores, ovf in single:
        if ovf != 0:
            raise AssertionError(f"posting_score overflow {ovf}")
        pb, pt, pw, _ = ps.build_pairs(sel, valid, sw, tfirst, tcount,
                                       n_tiles, max_pairs)
        args = (hor.block_docs, hor.block_tfs, pb, pt, pw, D)
        want = ps.posting_score_plain(*args)
        d, tf, v = hor.gather_postings(t, cap)
        raw = query.accumulate_scores(d, tf * w[:, None], v, D)
        torch.cuda.synchronize()
        for label, other in (("plain", want), ("oracle", raw)):
            if not torch.equal(scores.view(torch.int32),
                               other.view(torch.int32)):
                err = float((scores - other).abs().max())
                raise AssertionError(f"posting_score != {label} "
                                     f"(max abs err {err})")
        calls.append(args)
        blocks = sel[valid].long()
        bd = hor.block_docs[blocks].reshape(-1)
        lib_calls.append((torch.where(bd >= 0, bd, D).long(),
                          (hor.block_tfs[blocks] * sw[valid][:, None])
                          .reshape(-1)))
        real = max_pairs
        work.append((int(torch.unique(pb).numel()) * nb_docs * 8
                     + real * 12 + (n_tiles + 1) * 4 + D * 4,
                     real * nb_docs * 2))
    ms, turns, plain_ms, clocks = time_in_turns(
        ps.posting_score, ps.posting_score_plain, calls)
    acc = torch.zeros(D + 1, dtype=torch.float32, device=dev)
    lib_ms = event_ms(lambda i, v: acc.index_add_(0, i, v), lib_calls, REPS)
    nbytes = float(np.mean([x[0] for x in work]))
    nops = float(np.mean([x[1] for x in work]))
    sites = [{"site": f"paper:posting_score@hor{D}", "kernel": "posting_score",
              "launches": launches["posting_score"], "max_abs_err": 0.0,
              "kernel_ms": ms, "kernel_ms_turns": turns,
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "bytes": nbytes, "ops": nops,
              "real_pairs_per_query": [x[5] for x in single],
              "t_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
              "t_ops_ms": nops / F32_OPS_PER_S * 1e3,
              "clocks_sm_mem_power_temp": clocks}]
    del lib_calls, acc

    # 3. the decode against its plain version and the host, term by term
    args = (packed.packed, packed.block_bits, packed.block_base,
            packed.block_count, packed.block)
    want = pp.unpack_blocks_plain(*args)
    if not torch.equal(decoded, want):
        raise AssertionError("unpack_blocks != plain version")
    del want
    _, _, _, _, src, brow, lane = layouts._block_layout(host, packed.block)
    expect = torch.full((decoded.numel(),), -1, dtype=torch.int32,
                        device=dev)
    expect[torch.from_numpy(brow * packed.block + lane).to(dev)] = \
        torch.from_numpy(host.doc_ids[src].astype(np.int32)).to(dev)
    if not torch.equal(decoded.reshape(-1), expect):
        raise AssertionError("unpack_postings != the host's doc ids")
    del expect, src, brow, lane
    nb, wpb = packed.packed.shape
    u_bytes = nb * wpb * 4 + nb * 12 + nb * packed.block * 4
    u_ops = nb * packed.block * 5
    ms_u, turns_u, plain_u, clocks_u = time_in_turns(
        pp.unpack_blocks, pp.unpack_blocks_plain, [args])
    sites.append({
        "site": f"paper:unpack_blocks@packed{D}", "kernel": "unpack_blocks",
        "launches": launches["unpack_blocks"], "max_abs_err": 0.0,
        "kernel_ms": ms_u, "kernel_ms_turns": turns_u, "plain_ms": plain_u,
        "library_ms": None, "e2e_ms": unpack_e2e_ms, "blocks": nb,
        "words_per_block": wpb, "bytes": u_bytes, "ops": u_ops,
        "t_bytes_ms": u_bytes / HBM_BYTES_PER_S * 1e3,
        "t_ops_ms": u_ops / F32_OPS_PER_S * 1e3,
        "clocks_sm_mem_power_temp": clocks_u})
    del decoded

    # 4. conjunctive_filter on all seven; every hit holds every term
    conj_hits, conj_ms = 0, {}
    for n, qb in batches.items():
        for q in range(BATCH):
            got = {}
            for name, x in ix.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r, st = query.conjunctive_filter(x, qb[q], K, cap)
                torch.cuda.synchronize()
                conj_ms.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)
                if st["truncated_terms"] != 0:
                    raise AssertionError(f"conjunctive {name}: {st}")
                got[name] = r
            for name, r in got.items():
                if not torch.equal(r.doc_ids, got["pr_btree"].doc_ids):
                    raise AssertionError(f"conjunctive {name} {n}t q{q}")
            tids = hor.lookup_terms(qhs[n][q])
            for doc in got["hor"].doc_ids.tolist():
                if doc >= 0:
                    conj_hits += 1
                    if not bool(hor.contains(tids, doc).all()):
                        raise AssertionError(f"conjunctive hit {doc} lacks "
                                             f"a term of {n}t q{q}")
    if conj_hits == 0:
        raise AssertionError("conjunctive_filter found no doc at all")
    paper["conjunctive"] = {
        "hits_checked": conj_hits,
        "ms_per_query": {k: float(np.mean(v)) for k, v in conj_ms.items()}}
    print(f"conjunctive: {json.dumps(paper['conjunctive'])}")

    # 5. the direct index: expansion beside the full scans, feedback,
    # deletion
    exp_ms = {"direct": [], "scan_pr": [], "scan_or": []}
    for n in PAPER_TERMS:
        tids_or = orr.lookup_terms(qhs[n])
        for q in range(BATCH):
            top = base[n].doc_ids[q]
            t0 = time.perf_counter()
            e = direct_index.expand_query(direct, top, W, direct.max_doc_len)
            torch.cuda.synchronize()
            exp_ms["direct"].append((time.perf_counter() - t0) * 1e3)
            for key, x in (("scan_pr", pr), ("scan_or", orr)):
                t0 = time.perf_counter()
                s_ = direct_index.expand_query_scan(x, top, W)
                torch.cuda.synchronize()
                exp_ms[key].append((time.perf_counter() - t0) * 1e3)
                if not (torch.equal(s_.term_ids, e.term_ids) and torch.equal(
                        s_.weights.view(torch.int32),
                        e.weights.view(torch.int32))):
                    raise AssertionError(f"expand_query != {key} "
                                         f"({n}t q{q})")
            fb = direct_index.relevance_feedback(direct, top, tids_or[q], W,
                                                 direct.max_doc_len)
            if fb.term_ids.shape != (10,) or \
                    not bool(torch.isfinite(fb.weights).all()) or \
                    not bool((fb.term_ids[:1] >= 0).all()):
                raise AssertionError(f"relevance_feedback {fb}")
    victims = torch.stack([base[n].doc_ids[:, 0] for n in PAPER_TERMS])
    victims = victims.reshape(-1)
    norm = direct_index.delete_docs(pr.docs.norm, victims)
    if bool((norm[victims.long()] != 0).any()):
        raise AssertionError("delete_docs left a norm")
    for name, x in ix.items():
        dead = dataclasses.replace(x, docs=layouts.DocTable(
            norm=norm, rank=x.docs.rank))
        scorer = query.make_scorer(dead, k=K, cap=cap, engine="torch")
        for n, qh in qhs.items():
            if bool(torch.isin(scorer(qh).doc_ids, victims).any()):
                raise AssertionError(f"{name} returned a deleted doc")
    paper["direct"] = {
        "max_doc_len": direct.max_doc_len, "deleted": victims.numel(),
        "expand_ms_per_query": {k: float(np.mean(v))
                                for k, v in exp_ms.items()}}
    print(f"direct index: {json.dumps(paper['direct'])}")

    paper["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    # last: each side kernel's own device time (the trace would slow the
    # launches timed after it)
    dev_ms = device_ms({"posting_score": (ps.posting_score, calls),
                        "unpack_blocks": (pp.unpack_blocks, [args])})
    for site in sites:
        site["device_ms"] = dev_ms[site["kernel"]]
        print(f"paper kernel site: {json.dumps(site)}")
    report["paper"] = {**paper, "kernel_sites": sites}
    del ix, pr, orr, hor, packed, direct, results, base, single, calls, args
    torch.cuda.empty_cache()
    return sites


def model_inputs(seed, dev):
    """Every input of the model phase, made on the card from ``seed``:
    xDeepFM's fused field table and its serve_bulk and multi-hot id
    batches, PNA's hidden features and padded neighbour lists at
    ogbn-products and a Reddit minibatch, and q/k/v at each attention
    site.  Returns the main path's calls as (site, kernel, args, kw)."""
    import torch
    from repro_torch.kernels import embedding_bag as tbag
    g = torch.Generator(device=dev).manual_seed(seed)

    def ids(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def rand(shape):
        return torch.rand(shape, generator=g, device=dev)

    f, vocab = XDEEPFM_FIELDS, XDEEPFM_VOCAB
    table = torch.randn(tbag.padded_rows(f * vocab), XDEEPFM_DIM,
                        generator=g, device=dev) * 0.02   # embed_init
    bulk = tbag.field_ids(ids(vocab, (XDEEPFM_BULK, f)), vocab)
    multi = tbag.field_ids(ids(vocab, (XDEEPFM_P99, f, MULTI_HOT)), vocab)
    multi = multi.reshape(-1, MULTI_HOT)
    multi[rand(multi.shape) < 0.25] = -1
    calls = [("bag@xdeepfm_serve_bulk", "embedding_bag",
              (table, bulk.reshape(-1, 1)), {}),
             ("bag@xdeepfm_multihot", "embedding_bag", (table, multi), {})]

    feats = torch.randn(OGB_NODES, PNA_DIM, generator=g, device=dev)
    nbr = ids(OGB_NODES, (OGB_NODES, OGB_K))
    deg = torch.randint(OGB_DEG[0], OGB_DEG[1] + 1, (OGB_NODES, 1),
                        generator=g, device=dev)
    nbr[torch.arange(OGB_K, device=dev)[None, :] >= deg] = -1
    calls.append(("pna@ogbn_products", "pna_multi_agg", (feats, nbr), {}))
    feats = torch.randn(MB_NODES, PNA_DIM, generator=g, device=dev)
    n = MB_SEEDS
    for hop, fan in enumerate(MB_FANOUT, 1):
        nbr = ids(MB_NODES, (n, fan))
        nbr[(rand((n, 1)) < 0.1).expand(n, fan)] = -1  # degree-0 nodes
        calls.append((f"pna@reddit_minibatch/hop{hop}", "pna_multi_agg",
                      (feats, nbr), {}))
        n *= fan

    for site, (b, hq, hkv, d, window, dt) in ATTN_SITES.items():
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, h, ATTN_SEQ, d, generator=g, device=dev)
                   .to(dtype) for h in (hq, hkv, hkv))
        calls.append((site, "flash_attention", (q, k, v),
                      {"causal": True, "window": window}))
    return calls


def scatter_aggregate(feats, nbr):
    """PNA's four aggregations the way the model computes them
    (``gnn._pna_layer``: segment reductions over an edge list), written
    as ``scatter_reduce`` over src = nbr, dst = the node."""
    import torch
    n, k = nbr.shape
    d = feats.shape[1]
    dst = torch.arange(n, device=nbr.device).repeat_interleave(k)
    src = nbr.reshape(-1).long()
    keep = src >= 0
    src, dst = src[keep], dst[keep]
    m = feats[src]
    idx = dst[:, None].expand(-1, d)
    zeros = torch.zeros((n, d), device=feats.device)
    cnt = torch.zeros(n, device=feats.device).scatter_reduce(
        0, dst, torch.ones_like(dst, dtype=torch.float32), "sum")
    cnt = cnt.clamp_min(1.0)[:, None]
    mean = zeros.scatter_reduce(0, idx, m, "sum") / cnt
    mean_sq = zeros.scatter_reduce(0, idx, m * m, "sum") / cnt
    mn = torch.full_like(zeros, float("inf")).scatter_reduce(0, idx, m,
                                                             "amin")
    mx = torch.full_like(zeros, float("-inf")).scatter_reduce(0, idx, m,
                                                              "amax")
    std = torch.sqrt((mean_sq - mean * mean).clamp_min(0.0) + 1e-5)
    return torch.cat([mean, torch.where(torch.isfinite(mn), mn, 0.0),
                      torch.where(torch.isfinite(mx), mx, 0.0), std], dim=1)


def model_attention(q, k, v, window, chunk=512):
    """A plain-torch mirror of the transformers' ``chunked_attention``
    (``repro.models.attention``): query chunks, f32 scores over all keys
    with GQA by head groups, masked to -1e30, softmax, p cast to v's
    dtype.  A correctness yardstick only."""
    import torch
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    kg = k.reshape(b, hkv, 1, s, d).float()
    vg = v.reshape(b, hkv, 1, s, d)
    kpos = torch.arange(s, device=q.device)
    out = []
    for c0 in range(0, s, chunk):
        qc = q[:, :, c0:c0 + chunk]
        c = qc.shape[2]
        qc = qc.reshape(b, hkv, hq // hkv, c, d).float()
        scores = (qc @ kg.transpose(-1, -2)) * d ** -0.5
        qpos = torch.arange(c0, c0 + c, device=q.device)[:, None]
        mask = kpos[None, :] <= qpos
        if window > 0:
            mask &= kpos[None, :] > qpos - window
        p = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
        out.append((p.to(v.dtype) @ vg).reshape(b, hq, c, d))
    return torch.cat(out, dim=2)


def live_pairs(s, window):
    """Causal (query, key) pairs with a live entry at length ``s``."""
    if window <= 0:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def model_work(kernel, args, kw):
    """(bytes, ops, extra) one call must move/do at least: every input
    read once and the output written once, counted from this call's
    data (distinct table and neighbour rows, valid slots, live
    pairs)."""
    import torch
    if kernel == "embedding_bag":
        table, idx = args
        elt = table.element_size()
        ok = idx >= 0
        valid = int(ok.sum())
        rows = int(torch.unique(idx[ok]).numel())
        d = table.shape[1]
        nbytes = idx.numel() * 4 + rows * d * elt + idx.shape[0] * d * elt
        return nbytes, valid * d, {"valid_slots": valid,
                                   "distinct_rows": rows,
                                   "gathered_row_bytes": valid * d * elt}
    if kernel == "pna_multi_agg":
        feats, nbr = args
        d = feats.shape[1]
        ok = nbr >= 0
        valid = int(ok.sum())
        rows = int(torch.unique(nbr[ok]).numel())
        nbytes = nbr.numel() * 4 + rows * d * 4 + nbr.shape[0] * 4 * d * 4
        # per valid (neighbour, column): add, two for the fma, min, max
        return nbytes, valid * d * 5, {
            "valid_edges": valid, "distinct_rows": rows,
            "gathered_row_bytes": valid * d * 4}
    q, k, v = args
    b, hq, s, d = q.shape
    live = live_pairs(s, kw["window"])
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return nbytes, 4 * b * hq * d * live, {"live_pairs_per_head": live}


def model_phase(seed, dev, report):
    """The model kernels at the widths of the repository's model
    configurations (step 8 of the module docstring); returns their
    sites."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as tbag
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_multi_agg as tpna

    # the plain versions' f32 products run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = {"embedding_bag": ops.embedding_bag,
             "pna_multi_agg": ops.pna_multi_agg,
             "flash_attention": ops.attention}
    plain = {"embedding_bag": tbag.embedding_bag_plain,
             "pna_multi_agg": tpna.pna_multi_agg_plain,
             "flash_attention": tfa.flash_attention_plain}
    model: dict = {}
    t0 = time.perf_counter()
    calls = model_inputs(seed, dev)
    torch.cuda.synchronize()
    model["inputs_s"] = time.perf_counter() - t0

    # warm-up (library loads) on a slice of each kind of call
    for _, kern, args, kw in calls:
        if kern == "flash_attention":
            entry[kern](*(x[:1, :, :64].contiguous() for x in args), **kw)
        else:
            entry[kern](args[0], args[1][:1].contiguous(), **kw)
    torch.cuda.synchronize()

    # the main path: every counter from zero just before, read just after
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    outs, e2e_ms = [], []
    for _, kern, args, kw in calls:
        t0 = time.perf_counter()
        outs.append(entry[kern](*args, **kw))
        torch.cuda.synchronize()
        e2e_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    print(f"model launches: {json.dumps(launches)}")
    for name in ALL_KERNELS:
        want = sum(c[1] == name for c in calls)
        if launches[name] != want:
            raise AssertionError(f"model path launched {name} "
                                 f"{launches[name]} times, not {want}")

    sites = []
    for (site, kern, args, kw), got, ms_e2e in zip(calls, outs, e2e_ms):
        want = plain[kern](*args, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{site}: bad output {tuple(got.shape)} "
                                 f"{got.dtype}")
        err = float((got.float() - want.float()).abs().max())
        info = {"site": site, "kernel": kern, "launches": 1,
                "shapes": [list(x.shape) for x in args],
                "dtype": str(args[0].dtype), **kw, "max_abs_err": err,
                "e2e_ms": ms_e2e}
        if kern == "flash_attention":
            tol = 3e-2 if got.dtype == torch.bfloat16 else 2e-4
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            info["tolerance"] = tol
            if got.dtype == torch.bfloat16:
                # the plain version computes in bf16; the kernel, like the
                # Pallas kernel, in f32 from the bf16 inputs: held to the
                # plain version run in f32 on the same inputs and rounded
                # to bf16, it may differ by one rounding of the output
                f32 = plain[kern](*(x.float() for x in args), **kw)
                f32 = f32.to(torch.bfloat16).float()
                torch.testing.assert_close(got.float(), f32,
                                           rtol=BF16_RTOL, atol=BF16_ATOL)
                gap = (got.float() - f32).abs()
                info.update(
                    tolerance_f32_plain=[BF16_RTOL, BF16_ATOL],
                    max_abs_err_f32_plain=float(gap.max()),
                    max_rel_err_f32_plain=float(
                        (gap / f32.abs().clamp_min(BF16_ATOL)).max()),
                    outputs_off_f32_plain=int((gap > 0).sum()))
                del f32, gap
            if site == "attn@qwen3_0.6b":
                yard = model_attention(*args, kw["window"])
                torch.testing.assert_close(got.float(), yard.float(),
                                           rtol=tol, atol=tol)
                info["max_abs_err_model_attention"] = float(
                    (got.float() - yard.float()).abs().max())
                del yard
        elif not torch.equal(got.float().view(torch.int32),
                             want.float().view(torch.int32)):
            raise AssertionError(f"{site}: kernel != plain version "
                                 f"(max abs err {err})")
        if kern == "pna_multi_agg":
            # the model's own aggregation on the same edges (a 1/16
            # slice of the largest graph)
            feats, nbr = args
            n = nbr.shape[0] if nbr.shape[0] < 100_000 else \
                nbr.shape[0] // 16
            agg = scatter_aggregate(feats, nbr[:n])
            torch.testing.assert_close(got[:n], agg, rtol=1e-5, atol=1e-5)
            info.update(scatter_nodes_checked=n, max_abs_err_scatter=float(
                (got[:n] - agg).abs().max()))
            del agg
        del want

        nbytes, nops, extra = model_work(kern, args, kw)
        # attention's products belong on the tensor cores in bf16; every
        # other operation here is f32 on the CUDA cores
        peak = BF16_OPS_PER_S if kern == "flash_attention" and \
            args[0].dtype == torch.bfloat16 else F32_OPS_PER_S
        ms, turns, plain_ms, clocks = time_in_turns(
            lambda *c: entry[kern](*c, **kw),
            lambda *c: plain[kern](*c, **kw), [args])
        lib_ms, lib_note = None, None
        if kern == "embedding_bag":
            table, idx = args
            lib_args = (idx.clamp_min(0), (idx >= 0).to(table.dtype))
            lib_ms = event_ms(lambda i, w: F.embedding_bag(
                i, table, mode="sum", per_sample_weights=w), [lib_args],
                REPS)
            lib_note = "F.embedding_bag(mode='sum', per_sample_weights)"
        elif kern == "flash_attention":
            q = args[0]
            s = q.shape[2]
            pos = torch.arange(s, device=dev)
            if kw["window"] > 0:
                mask = (pos[None, :] <= pos[:, None]) & \
                    (pos[None, :] > pos[:, None] - kw["window"])
                lib_ms = event_ms(lambda *c: F.scaled_dot_product_attention(
                    *c, attn_mask=mask, enable_gqa=True), [args], REPS)
                lib_note = "F.scaled_dot_product_attention(bool window mask)"
            else:
                lib_ms = event_ms(lambda *c: F.scaled_dot_product_attention(
                    *c, is_causal=True, enable_gqa=True), [args], REPS)
                lib_note = "F.scaled_dot_product_attention(is_causal)"
        else:
            lib_note = ("none: PNA's four aggregations take four "
                        "scatter_reduce calls, not one")
        info.update(extra, bytes=nbytes, ops=nops, kernel_ms=ms,
                    kernel_ms_turns=turns, plain_ms=plain_ms,
                    library_ms=lib_ms, library=lib_note,
                    t_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    t_ops_ms=nops / peak * 1e3,
                    clocks_sm_mem_power_temp=clocks)
        info["bound_ms"] = max(info["t_bytes_ms"], info["t_ops_ms"])
        print(f"model kernel site: {json.dumps(info)}")
        sites.append(info)
    model["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    print(f"model: {json.dumps(model)}")
    report["model"] = {**model, "kernel_sites": sites}
    del calls, outs
    torch.cuda.empty_cache()
    return sites


def kernel_rows(sites):
    """One row per kernel for the ``kernels`` line: ``launches`` sums
    the counted runs of every path, and ``ms``, ``plain_ms`` and
    ``bound_ms`` are means per launch (each call site weighted by its
    launches); the per-site numbers are printed above."""
    import numpy as np
    rows = []
    replaced = {n: r for n, (_, r) in {**KERNELS, **DENSE_KERNELS}.items()}
    for name, replaces in {**replaced, **PAPER_KERNELS,
                           **MODEL_KERNELS}.items():
        mine = [x for x in sites if x["kernel"] == name]
        if not mine:
            raise AssertionError(f"{name}: no call site on any path")
        w = [x["launches"] for x in mine]

        def mean(key):
            return float(np.average([x[key] for x in mine], weights=w))
        t_bytes, t_ops = mean("t_bytes_ms"), mean("t_ops_ms")
        lib = [x.get("library_ms") for x in mine]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": int(sum(w)),
            "max_abs_err": max(x["max_abs_err"] for x in mine),
            "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (mean("library_ms")
                           if None not in lib else None)})
    return rows


if __name__ == "__main__":
    sys.exit(main())
