"""Serving launcher: batched retrieval over the paper's index layouts
(the port of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --repr hor --docs 5000 --queries 64``

Builds a synthetic corpus, constructs the chosen index representation
on ``--device`` (``cuda`` unless asked otherwise), and serves batched
queries through the scorer (``query.make_scorer``, the gather oracle,
as the reference launcher's default engine).  Reports the corpus, the
index size, and the per-query latency percentiles: the q_word / q_occ /
q_doc pipeline of paper section 3.7 end to end.  ``--shards N`` serves
through the document-sharded gather engine instead
(``distributed.retrieval.build_doc_sharded`` and
``make_doc_sharded_scorer`` on a mesh of N shards on ``--device``, one
query per call, as the reference's launcher vmaps it).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repr", default="hor",
                    choices=["pr", "or", "cor", "hor", "packed"])
    ap.add_argument("--docs", type=int, default=5000)
    ap.add_argument("--vocab", type=int, default=8000)
    ap.add_argument("--avg-terms", type=int, default=60)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--terms", type=int, default=3)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--shards", type=int, default=0,
                    help=">0: the document-sharded engine over a mesh of "
                         "this many shards on --device")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core import build, layouts, query
    from repro_torch.text import corpus

    dev = torch.device(args.device)
    t0 = time.time()
    tc = corpus.generate(corpus.CorpusSpec(
        num_docs=args.docs, vocab=args.vocab, avg_distinct=args.avg_terms,
        seed=args.seed))
    host = build.bulk_build(tc)
    print(f"corpus: D={host.num_docs} W={host.num_terms} "
          f"P={host.num_postings} build={time.time() - t0:.2f}s")

    qh = corpus.sample_query_terms(host.df, host.term_hashes, args.queries,
                                   args.terms, num_docs=host.num_docs,
                                   seed=args.seed + 1)
    if args.shards > 0:
        from repro_torch.distributed import retrieval, shmap
        mesh = shmap.make_mesh(args.shards, "data", device=dev)
        ds = retrieval.build_doc_sharded(host, args.shards)
        row_scorer = retrieval.make_doc_sharded_scorer(ds, mesh, "data",
                                                       k=args.topk)

        def scorer(qb):
            # one query per call: the sharded scorer's contract
            rows = [row_scorer(row) for row in qb]
            return query.QueryResult(
                doc_ids=torch.stack([i for _, i in rows]),
                scores=torch.stack([v for v, _ in rows]))
        print(f"engine: doc-sharded x{args.shards}")
    else:
        index = layouts.REPRESENTATIONS[args.repr](host, device=dev)
        print(f"engine: {args.repr} index={index.nbytes() / 1e6:.1f} MB")
        cap = max(host.max_posting_len, 1)
        scorer = query.make_scorer(index, k=args.topk, cap=cap)

    lat = []
    hits = 0
    for i in range(0, args.queries, args.batch):
        qb = qh[i:i + args.batch]
        t0 = time.perf_counter()
        res = scorer(qb)
        # the copy to the host waits for the device's work
        scores = res.scores.cpu().numpy()
        lat.append((time.perf_counter() - t0) / qb.shape[0])
        # a hit scores above 0; a miss is -inf (sharded) or 0 (-1 id)
        hits += int((scores > 0).any(axis=-1).sum())
    lat_us = np.array(lat[1:] or lat) * 1e6
    print(f"served {args.queries} queries; {hits} with hits; "
          f"p50={np.percentile(lat_us, 50):.0f}us "
          f"p99={np.percentile(lat_us, 99):.0f}us per query "
          f"(steady-state, batch={args.batch})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
