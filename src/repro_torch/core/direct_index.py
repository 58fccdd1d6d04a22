"""Direct (forward) index: document-based access, paper §4.4; the port of
``repro.core.direct_index``.

Without a doc -> terms access path, the paper's query expansion
degenerates to a sequential scan of the whole posting relation
(``expand_query_scan``).  The direct index stores, for each document,
the packed list of its (term id, tf) in the ORIF (CSR) representation,
so expansion reads only the chosen documents' slabs.

Supported tasks (paper §3.3): query expansion (top terms of top docs),
relevance feedback (terms of user-marked docs), document deletion.

The term sums are scatter-adds.  On CUDA ``index_add_`` is atomic, so
the order in which a slot's values arrive would vary; here every sum
adds a slot's values in the reference's sequential order (``sum_in_order``),
and ties among the suggested terms break on the lowest term id, as
``jax.lax.top_k`` breaks them (``distributed.topk``'s stable merge).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.layouts import CooIndex, PostingsHost, _to
from repro_torch.core.segments import (gather_segments, lengths_to_offsets,
                                       offsets_to_segment_ids, run_ranks)
from repro_torch.distributed.topk import merge_topk_candidates

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DirectIndex:
    """CSR doc -> (term_id, tf): the ORIF-representation forward index."""
    offsets: Tensor    # i32[D+1]
    term_ids: Tensor   # i32[Nd]
    tfs: Tensor        # f32[Nd]
    max_doc_len: int

    @property
    def num_docs(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def to(self, device) -> "DirectIndex":
        return _to(self, device)

    def doc_terms(self, doc_ids: Tensor, cap: int):
        """Each doc's packed (term, tf) slab: (terms, tfs, valid)
        [..., cap]."""
        t, valid = gather_segments(self.term_ids, self.offsets, doc_ids, cap,
                                   fill=-1)
        f, _ = gather_segments(self.tfs, self.offsets, doc_ids, cap,
                               fill=0.0)
        return t, f, valid

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for x in (self.offsets, self.term_ids, self.tfs))


def build_direct(h: PostingsHost, device="cuda") -> DirectIndex:
    """Transpose the canonical term-major postings into doc-major CSR,
    equal to ``repro.core.direct_index.build_direct``: the reference's
    stable host argsort by doc id runs as torch's stable sort on
    ``device``."""
    dev = torch.device(device)
    lengths = torch.from_numpy(np.diff(h.offsets).astype(np.int64)).to(dev)
    term_of = torch.repeat_interleave(
        torch.arange(h.num_terms, dtype=torch.int32, device=dev), lengths)
    docs = torch.from_numpy(h.doc_ids.astype(np.int32)).to(dev)
    order = torch.argsort(docs, stable=True)
    counts = torch.bincount(docs.long(), minlength=h.num_docs)
    tfs = torch.from_numpy(h.tfs.astype(np.float32)).to(dev)
    return DirectIndex(
        offsets=lengths_to_offsets(counts), term_ids=term_of[order],
        tfs=tfs[order],
        max_doc_len=int(counts.max()) if counts.numel() else 0)


class ExpansionResult(NamedTuple):
    term_ids: Tensor   # i32[n_terms]  (-1 where the weight is 0)
    weights: Tensor    # f32[n_terms]


def sum_in_order(keys: Tensor, values: Tensor, n: int) -> Tensor:
    """f32[n]: ``values`` scatter-added into slots ``keys``, each slot's
    values summed in the order given, as the reference's sequential
    scatter-add sums them.  Keys outside [0, n) are dropped.  Round r
    adds the r-th value of every slot at once, so no two adds of a round
    collide and the order is fixed on CUDA too."""
    acc = torch.zeros(n, dtype=torch.float32, device=values.device)
    keep = (keys >= 0) & (keys < n)
    keys, values = keys[keep].long(), values[keep].float()
    if keys.numel() == 0:
        return acc
    order = torch.argsort(keys, stable=True)
    rnd = run_ranks(keys[order])
    for r in range(int(rnd.max()) + 1):
        sel = order[rnd == r]
        acc.index_add_(0, keys[sel], values[sel])
    return acc


def _top_terms(sums: Tensor, n: int) -> ExpansionResult:
    """Top ``n`` terms by weight, lowest term id first on ties; terms of
    weight 0 come back as id -1."""
    ids = torch.arange(sums.shape[0], dtype=torch.int32, device=sums.device)
    w, top = merge_topk_candidates(sums, ids, n)
    return ExpansionResult(term_ids=torch.where(w > 0, top, -1), weights=w)


def expand_query(direct: DirectIndex, top_docs: Tensor, num_terms: int,
                 cap: int, n_suggest: int = 5,
                 exclude_terms: Tensor | None = None) -> ExpansionResult:
    """Paper §4.4: sum the tf of every term over the top docs, suggest
    the top ``n_suggest``.  ``top_docs`` i32[n] (pad with -1).  Reads
    O(n * cap) postings through the direct index, against a full posting
    scan without it.  ``exclude_terms`` (pad with -1) get weight 0."""
    t, f, valid = direct.doc_terms(top_docs.clamp_min(0), cap)
    valid = valid & (top_docs >= 0)[:, None]
    sums = sum_in_order(t[valid], f[valid], num_terms)
    if exclude_terms is not None:
        ex = exclude_terms[(exclude_terms >= 0) & (exclude_terms < num_terms)]
        sums[ex.long()] = 0.0
    return _top_terms(sums, n_suggest)


def expand_query_scan(index: Any, top_docs: Tensor, num_terms: int,
                      n_suggest: int = 5) -> ExpansionResult:
    """The degenerate path the paper measured (no doc-access structure):
    a full sequential scan of the posting relation, filtered by doc id.
    Works on any layout with flat (doc_ids, tfs) columns: the PR heap
    (its word-id column names the term) or a CSR layout (the term is the
    segment of each position; for COR that is the hash-sorted term id).
    """
    doc_col, tf_col = index.doc_ids, index.tfs
    if isinstance(index, CooIndex):
        term_col = index.word_ids
    else:
        term_col = offsets_to_segment_ids(index.offsets, doc_col.shape[0])
    # -1 padding in top_docs never matches a real doc id
    member = torch.isin(doc_col, top_docs)
    sums = sum_in_order(term_col[member], tf_col[member], num_terms)
    return _top_terms(sums, n_suggest)


def relevance_feedback(direct: DirectIndex, marked_docs: Tensor,
                       query_term_ids: Tensor, num_terms: int, cap: int,
                       alpha: float = 1.0, beta: float = 0.75,
                       n_terms: int = 10) -> ExpansionResult:
    """Rocchio-style feedback through the direct index: the query's own
    terms (weight ``alpha`` each) plus ``beta`` times the marked docs'
    expansion weights."""
    exp = expand_query(direct, marked_docs, num_terms, cap,
                       n_suggest=n_terms)
    boost = sum_in_order(query_term_ids,
                         torch.full(query_term_ids.shape, alpha,
                                    dtype=torch.float32,
                                    device=query_term_ids.device),
                         num_terms)
    sums = sum_in_order(exp.term_ids, beta * exp.weights, num_terms)
    return _top_terms(boost + sums, n_terms)


def delete_docs(docs_norm: Tensor, doc_ids: Tensor) -> Tensor:
    """Document deletion = zeroing the norm (scoring then skips the doc),
    on a copy.  Postings stay in place until the next bulk rebuild: the
    paper's §3.6 maintenance model (drop / bulk / rebuild).  Ids that
    are negative or past the table are ignored."""
    out = docs_norm.clone()
    ok = (doc_ids >= 0) & (doc_ids < out.shape[0])
    out[doc_ids[ok].long()] = 0.0
    return out
