"""Builds a static deployment: a collection made from the seed,
bulk-built once into one of the port's posting layouts, and its scorer
(``query.make_scorer``) at the configuration's settings."""
from __future__ import annotations

import gc

import numpy as np
import torch

from portbench.gen import corpus as gen
from portbench.lib.laps import Laps

LAYOUT_BUILDS = {"packed": "build_packed_csr"}


class StaticSystem:
    def __init__(self, cfg: dict, seed: int, device):
        from repro_torch.core import build, layouts, query

        lap = Laps()
        self.cfg = cfg
        self.device = torch.device(device)
        col = cfg["collection"]
        self.spec = gen.Spec(col["num_docs"], col["vocab"],
                             col["avg_distinct"], col["zipf_s"])
        self.hashes = gen.term_hashes(self.spec.vocab)
        self.docs = gen.generate(self.spec, seed, "base", self.device)
        self.base_df = gen.document_frequency(self.docs, self.spec.vocab)
        terms, counts = self.docs.term_lists()
        lap("generate")
        host = build.bulk_build(build.TokenizedCorpus(
            terms, counts, self.hashes, self.docs.num_docs))
        del terms, counts
        lap("bulk_build")
        self.index = getattr(layouts, LAYOUT_BUILDS[cfg["layout"]])(
            host, device=self.device)
        del host
        lap("layout")
        sc = cfg["scorer"]
        self.k = int(sc["k"])
        # the exact static budget: every posting of the longest list
        self.scorer = query.make_scorer(self.index, k=self.k,
                                        cap=self.index.max_posting_len,
                                        engine=sc["engine"], mode=sc["mode"])
        self.n_docs = self.docs.num_docs
        lap("scorer")
        self.phases = lap.phases

    def triples(self):
        return (self.docs.doc_of.astype(np.int64), self.docs.terms,
                self.docs.counts)

    def release(self) -> None:
        self.scorer = self.index = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def build(cfg: dict, seed: int, device, trace: bool) -> StaticSystem:
    return StaticSystem(cfg, seed, device)
