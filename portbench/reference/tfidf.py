"""The plain reference: exact tf-idf cosine top-k over a set of live
documents, in plain PyTorch.

Semantics (the paper's ranking, as the served system defines it): over
the live documents L, ``df(t)`` counts the live documents holding term
``t`` and ``idf(t) = ln(1 + |L| / df(t))``; a document's norm is
``sqrt(sum_t (tf(d, t) idf(t))^2)`` over all its terms; a query (its
distinct terms) scores ``sum_{t in q} tf(d, t) idf(t) / (norm(d) *
sqrt(sum_{t in q} idf(t)^2))``; a live document with a positive score is
a hit, and the answer is the ``k`` best hits.

It builds its own postings from the documents the benchmark generated
and the writes it made, and imports nothing of the program.  ``dtype``
is float64 for the reference and bfloat16 for the control.
"""
from __future__ import annotations

import numpy as np
import torch


class Collection:
    """Every document ever added: doc-major triples ``doc`` (global id),
    ``term``, ``tf`` on ``device``, and a term-major copy for queries."""

    def __init__(self, doc_of: np.ndarray, terms: np.ndarray,
                 counts: np.ndarray, num_docs: int, vocab: int, device):
        self.device = torch.device(device)
        self.num_docs = int(num_docs)
        self.vocab = int(vocab)
        self.doc = torch.from_numpy(np.ascontiguousarray(doc_of)).to(
            self.device).long()
        self.term = torch.from_numpy(np.ascontiguousarray(terms)).to(
            self.device).long()
        self.tf = torch.from_numpy(np.ascontiguousarray(counts)).to(
            self.device).double()
        order = torch.argsort(self.term, stable=True)
        self.t_doc = self.doc[order]
        self.t_tf = self.tf[order]
        per_term = torch.bincount(self.term, minlength=self.vocab)
        self.t_off = torch.zeros(self.vocab + 1, dtype=torch.int64,
                                 device=self.device)
        torch.cumsum(per_term, 0, out=self.t_off[1:])
        self._t_off_host = self.t_off.cpu().numpy()

    def weights(self, live: torch.Tensor, dtype=torch.float64):
        """(idf [vocab], norm [num_docs]) in ``dtype`` over the live mask."""
        plive = live[self.doc]
        df = torch.bincount(self.term[plive], minlength=self.vocab)
        x = live.sum().to(dtype) / df.clamp_min(1).to(dtype)
        idf = torch.where(df > 0, torch.log1p(x), torch.zeros_like(x))
        w = self.tf.to(dtype) * idf[self.term]
        norm_sq = torch.zeros(self.num_docs, dtype=dtype, device=self.device)
        norm_sq.index_add_(0, self.doc,
                           torch.where(plive, w * w, torch.zeros_like(w)))
        return idf, norm_sq.sqrt()

    def scores(self, term_ids: list, idf: torch.Tensor, norm: torch.Tensor,
               live: torch.Tensor) -> torch.Tensor:
        """[len(term_ids), num_docs] final scores of each query (its
        distinct term ids), ``-inf`` where a document is no hit."""
        dtype = idf.dtype
        out = torch.full((len(term_ids), self.num_docs), float("-inf"),
                         dtype=dtype, device=self.device)
        for i, q in enumerate(term_ids):
            q = np.unique(np.asarray(q, np.int64))
            q = q[(q >= 0) & (q < self.vocab)]
            acc = torch.zeros(self.num_docs, dtype=dtype, device=self.device)
            qn = torch.zeros((), dtype=dtype, device=self.device)
            for t in q.tolist():
                a, b = int(self._t_off_host[t]), int(self._t_off_host[t + 1])
                acc.index_add_(0, self.t_doc[a:b],
                               self.t_tf[a:b].to(dtype) * idf[t])
                qn = qn + idf[t] * idf[t]
            cos = acc / (norm * qn.sqrt())
            out[i] = torch.where(live & (acc > 0) & (norm > 0), cos,
                                 torch.full_like(cos, float("-inf")))
        return out

