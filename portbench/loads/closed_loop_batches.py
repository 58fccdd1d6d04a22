"""Closed-loop batch evaluation of a query log over a static index.

The caller scores one batch, waits for its answers on the host, and
sends the next: a fixed pool of batches, each with every query length in
its exact share, cycled in the seed's order for the whole window.  The
rate is every query answered over the time from the window's start to
the last answer.  After the window every answer is judged against the
reference.
"""
from __future__ import annotations

import time

import numpy as np

from portbench.gen import traffic as gen_traffic
from portbench.reference import compare
from portbench.reference.tfidf import Collection


class Session:
    def __init__(self, system, mix: dict, seed: int, seconds: float):
        self.system = system
        self.seconds = float(seconds)
        b, n = int(mix["batch"]), int(mix["pool_batches"])
        rng = np.random.default_rng([int(seed), 21])
        lens = np.concatenate([gen_traffic.lengths(mix["terms"], b, rng)
                               for _ in range(n)])
        rows = gen_traffic.query_rows(
            system.base_df, system.hashes, system.spec.num_docs, lens,
            int(mix["width"]), mix["df_band"], seed)
        self.pool = rows.reshape(n, b, -1)
        self.batch = b

    def warm(self) -> None:
        for qb in self.pool[:3]:
            r = self.system.scorer(qb)
            r.doc_ids.cpu()

    def window(self) -> None:
        scorer = self.system.scorer
        self.answers = []          # (pool index, ids, scores, t0, t1)
        n = len(self.pool)
        start = time.perf_counter()
        self.t_start, close = start, start + self.seconds
        i = 0
        while time.perf_counter() < close:
            t0 = time.perf_counter()
            r = scorer(self.pool[i % n])
            ids = r.doc_ids.cpu().numpy()
            scores = r.scores.cpu().numpy()
            self.answers.append((i % n, ids, scores, t0,
                                 time.perf_counter()))
            i += 1
        self.t_end = self.answers[-1][4]

    # -- end-to-end metrics ------------------------------------------------

    def e2e(self) -> dict:
        return {"queries_per_s": len(self.answers) * self.batch
                / (self.t_end - self.t_start)}

    def batches(self) -> list:
        """Every scorer call: its rows (all real queries)."""
        return [{"rows": self.pool[p], "fill": self.batch}
                for p, *_ in self.answers]

    def attempted(self) -> int:
        return len(self.answers) * self.batch

    def failed(self) -> int:
        return 0

    def host_spans(self) -> list:
        return [("scorer call", t0, t1) for *_, t0, t1 in self.answers]

    # -- correctness -------------------------------------------------------

    def check(self, device, control: bool = False) -> dict:
        import torch
        sys_ = self.system
        doc, term, count = sys_.triples()
        col = Collection(doc, term, count, sys_.n_docs, sys_.spec.vocab,
                         device)
        live = torch.ones(sys_.n_docs, dtype=torch.bool, device=col.device)
        idf, norm = col.weights(live)
        if control:
            idf_c, norm_c = col.weights(live, torch.bfloat16)
        tally, tally_c = compare.Tally(), compare.Tally()
        order = np.argsort(sys_.hashes)
        srt = sys_.hashes[order]
        by_pool: dict = {}
        for j, (p, *_rest) in enumerate(self.answers):
            by_pool.setdefault(p, []).append(j)
        for p, js in sorted(by_pool.items()):
            terms = []
            for row in self.pool[p]:
                h = row[row != 0]
                pos = np.minimum(np.searchsorted(srt, h), len(srt) - 1)
                terms.append(order[pos][srt[pos] == h])
            final = col.scores(terms, idf, norm, live)
            for j in js:
                _, ids, sc, *_ = self.answers[j]
                compare.judge(tally, final, live, ids, sc, sys_.k)
            if control:
                ci, cs = compare.control_answers(
                    col.scores(terms, idf_c, norm_c, live), sys_.k)
                compare.judge(tally_c, final, live, ci, cs, sys_.k)
        out = {"program": tally.numbers(), "checked": tally.checked}
        if control:
            out["control"] = tally_c.numbers()
        return out
