"""Builds a live deployment: a collection made from the seed, bulk-built
and sealed into the port's segmented live index, then taken through the
configuration's churn (adds through the delta, seals, deletes), with the
query server and the maintenance thread over it.

Every mutation the benchmark makes is logged with the epoch the index
reached when it was acknowledged, so the reference can rebuild the live
set of any epoch a served answer pinned.  Doc ids follow the index's
documented rule: fresh ascending ids in the order documents are added.
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from portbench.gen import corpus as gen
from portbench.lib.laps import Laps


class LiveSystem:
    def __init__(self, cfg: dict, seed: int, device, trace_sample: int = 0):
        from repro_torch.core import build
        from repro_torch.core.live_index import SegmentedIndex
        from repro_torch.serve import (IndexMaintenance, QueryServer,
                                       ServerConfig)

        lap = Laps()
        self.cfg = cfg
        self.device = torch.device(device)
        col = cfg["collection"]
        self.spec = gen.Spec(col["num_docs"], col["vocab"],
                             col["avg_distinct"], col["zipf_s"])
        self.hashes = gen.term_hashes(self.spec.vocab)
        self._corpus_type = build.TokenizedCorpus
        base = gen.generate(self.spec, seed, "base", self.device)
        self.parts = [(0, base)]          # (first global id, Docs)
        self.base_df = gen.document_frequency(base, self.spec.vocab)
        corpus = self.corpus(base)
        lap("generate")
        host = build.bulk_build(corpus)
        del corpus
        lap("bulk_build")
        ix = cfg["index"]
        self.si = SegmentedIndex.from_host(
            host, seal_layout=ix["seal_layout"],
            delta_doc_capacity=ix["delta_doc_capacity"],
            delta_posting_capacity=ix["delta_posting_capacity"],
            device=self.device)
        del host
        lap("from_host")
        self.n_docs = base.num_docs
        self.live = np.ones(base.num_docs, bool)
        self.log = [(self.si.epoch, 0, base.num_docs, np.zeros(0, np.int64))]
        self._churn(cfg["churn"], seed)
        lap("churn")
        srv = cfg["server"]
        self.k = int(srv["k"])
        self.server = QueryServer(self.si, ServerConfig(
            batch_size=srv["batch_size"],
            n_terms_budget=srv["n_terms_budget"], k=self.k,
            engine=srv["engine"], mode=srv["mode"],
            trace_sample=trace_sample))
        self.lock = self.server.index_lock
        self.maintenance = IndexMaintenance(self.si, self.lock,
                                            **cfg["maintenance"])
        lap("server")
        self.phases = lap.phases

    def corpus(self, docs: gen.Docs):
        terms, counts = docs.term_lists()
        return self._corpus_type(terms, counts, self.hashes, docs.num_docs)

    def _churn(self, churn: dict, seed: int) -> None:
        """The configuration's state before the window: ``docs`` new
        documents (their own stream of the seed) taken through ``steps``:
        ``["add", lo, hi]`` adds documents lo..hi of the stream,
        ``["seal", layout]`` seals the delta (``null``: the index's own
        layout), ``["delete_every", n]`` deletes every n-th allocated id."""
        docs = gen.generate(dataclasses.replace(self.spec,
                                               num_docs=churn["docs"]),
                            seed, "churn", self.device)
        for step in churn["steps"]:
            op = step[0]
            if op == "add":
                self.add(docs.slice(step[1], step[2]))
            elif op == "seal":
                self.si.seal(layout=step[1])
            elif op == "delete_every":
                self.delete(np.arange(0, self.n_docs, step[1]))
            else:
                raise ValueError(f"unknown churn step {step!r}")

    def add(self, docs: gen.Docs, refresh_norms: bool = True) -> None:
        lo = self.n_docs
        self.si.add_batch(self.corpus(docs), refresh_norms=refresh_norms)
        self.parts.append((lo, docs))
        self.n_docs += docs.num_docs
        self.live = np.concatenate([self.live, np.ones(docs.num_docs, bool)])
        self.log.append((self.si.epoch, lo, self.n_docs,
                         np.zeros(0, np.int64)))

    def delete(self, ids) -> None:
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[self.live[ids]]
        self.si.delete(ids)
        self.live[ids] = False
        self.log.append((self.si.epoch, self.n_docs, self.n_docs, ids))

    def write(self, docs: gen.Docs, delete_ids) -> int:
        """One write: add ``docs`` and delete ``delete_ids`` under the
        write lock, the norms refreshed once, by the delete, before the
        lock is released; returns the epoch it was acknowledged at."""
        with self.lock:
            self.add(docs, refresh_norms=False)
            self.delete(delete_ids)
            epoch = self.si.epoch
        # both mutations become visible together, at the last one's epoch
        e0, lo, hi, _ = self.log[-2]
        self.log[-2] = (epoch, lo, hi, self.log[-2][3])
        return epoch

    # -- what the reference needs ------------------------------------------

    def triples(self):
        """(doc, term, count) of every document ever added, global ids."""
        doc = np.concatenate([p.doc_of.astype(np.int64) + lo
                              for lo, p in self.parts])
        return (doc, np.concatenate([p.terms for _, p in self.parts]),
                np.concatenate([p.counts for _, p in self.parts]))

    def live_at(self, epoch: int) -> np.ndarray:
        """The live mask over all ids once every mutation acknowledged at
        or before ``epoch`` is applied."""
        live = np.zeros(self.n_docs, bool)
        for e, lo, hi, dead in self.log:
            if e <= epoch:
                live[lo:hi] = True
                live[dead] = False
        return live

    def release(self) -> None:
        """Stop the threads and free the program's state."""
        self.maintenance.stop()
        self.server.stop()
        self.server = self.maintenance = self.si = self.lock = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def build(cfg: dict, seed: int, device, trace: bool) -> LiveSystem:
    return LiveSystem(cfg, seed, device, trace_sample=1 if trace else 0)
