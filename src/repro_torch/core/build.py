"""Index construction — the paper's §3.6 bulk "copy" pipeline.

Pipeline (host-side, vectorized numpy — this is the data-ingest layer):

  token streams -> (doc, term, count) triples -> lexsort by (term, doc)
  -> df / offsets / CSR postings -> tf-idf document norms -> PostingsHost

numpy-only, and byte-for-byte the reference's ``bulk_build``: the
device layouts (``core/layouts.py``) are built from the ``PostingsHost``
this returns.  The incremental ``add_documents`` goes through the
segmented live index (``core/live_index.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.layouts import PostingsHost
from repro_torch.core.size_model import CorpusStats


@dataclasses.dataclass(frozen=True)
class TokenizedCorpus:
    """Per-document distinct terms + in-doc counts (already aggregated)."""
    doc_term_ids: Sequence[np.ndarray]   # per-doc i64 distinct term ids
    doc_counts: Sequence[np.ndarray]     # per-doc i64 counts (same shapes)
    term_hashes: np.ndarray              # u32[W], id -> hash (bijective mix)
    num_docs: int

    @property
    def num_terms(self) -> int:
        return len(self.term_hashes)


def _flatten(corpus: TokenizedCorpus):
    lens = np.array([len(x) for x in corpus.doc_term_ids], dtype=np.int64)
    doc_of = np.repeat(np.arange(corpus.num_docs, dtype=np.int64), lens)
    terms = (np.concatenate(corpus.doc_term_ids) if len(lens) and lens.sum()
             else np.zeros(0, np.int64))
    counts = (np.concatenate(corpus.doc_counts) if len(lens) and lens.sum()
              else np.zeros(0, np.int64))
    return doc_of, terms, counts


def _postings_from_triples(doc_of, terms, counts, num_terms, num_docs,
                           term_hashes) -> PostingsHost:
    order = np.lexsort((doc_of, terms))      # term-major, doc-sorted within
    terms_s = terms[order]
    docs_s = doc_of[order].astype(np.int32)
    tf_s = counts[order].astype(np.float32)  # raw counts as tf (Mitos-style)
    df = np.bincount(terms_s, minlength=num_terms).astype(np.int32)
    offsets = np.zeros(num_terms + 1, dtype=np.int64)
    np.cumsum(df, out=offsets[1:])
    # tf-idf document norms (paper §3.6: computed after all docs indexed)
    idf = np.log1p(num_docs / np.maximum(df, 1).astype(np.float64))
    w = tf_s * idf[terms_s]
    norm_sq = np.bincount(docs_s, weights=w * w, minlength=num_docs)
    norm = np.sqrt(norm_sq).astype(np.float32)
    norm[norm == 0] = 1e-12  # empty docs stay "live" but unreachable
    rank = _pagerank_proxy(num_docs)
    return PostingsHost(
        term_hashes=term_hashes.astype(np.uint32), df=df,
        offsets=offsets, doc_ids=docs_s, tfs=tf_s,
        num_docs=num_docs, norm=norm, rank=rank,
    )


def _pagerank_proxy(num_docs: int, seed: int = 7) -> np.ndarray:
    """Static-rank column (the paper stores PageRank; we store a fixed
    pseudo-random static score so ranking paths are exercised)."""
    rng = np.random.default_rng(seed)
    return (rng.random(num_docs).astype(np.float32) * 1e-3)


def bulk_build(corpus: TokenizedCorpus) -> PostingsHost:
    """The §3.6 COPY path: one global sort, derived data computed once."""
    doc_of, terms, counts = _flatten(corpus)
    return _postings_from_triples(doc_of, terms, counts, corpus.num_terms,
                                  corpus.num_docs, corpus.term_hashes)


def merge_vocab(old_hashes: np.ndarray, new_hashes: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized vocabulary union.

    Returns ``(merged_hashes, remap)``: ``merged_hashes`` is
    ``old_hashes`` with genuinely new hashes appended in first-
    appearance order; ``remap[i]`` is the merged id of
    ``new_hashes[i]``.  One ``np.searchsorted`` over the sorted old
    hashes instead of a Python dict probe per term.
    """
    old = np.asarray(old_hashes, np.uint32)
    new = np.asarray(new_hashes, np.uint32)
    remap = np.empty(len(new), dtype=np.int64)
    if len(old):
        order = np.argsort(old, kind="stable")
        srt = old[order]
        pos = np.minimum(np.searchsorted(srt, new), len(old) - 1)
        found = srt[pos] == new
        remap[found] = order[pos[found]]
    else:
        found = np.zeros(len(new), bool)
    remap[~found] = len(old) + np.cumsum(~found)[~found] - 1
    merged = (np.concatenate([old, new[~found]]) if (~found).any()
              else old)
    return merged, remap


def add_documents(host: PostingsHost, new_corpus: TokenizedCorpus,
                  doc_id_base: int | None = None,
                  device="cuda") -> PostingsHost:
    """Incremental batch add (paper §3.6 semantics) through the live
    index: seed a one-segment ``SegmentedIndex`` on ``device`` from
    ``host``, ingest the batch through the delta, seal, compact the
    whole stack and export — the merged ``PostingsHost``.  A
    ``doc_id_base`` other than ``host.num_docs`` (ids overlapping or
    leaving a gap) takes the one-shot merge of ``_merge_documents``."""
    base = host.num_docs if doc_id_base is None else doc_id_base
    if base != host.num_docs:
        return _merge_documents(host, new_corpus, base)
    from repro_torch.core.live_index import SegmentedIndex
    si = SegmentedIndex.from_host(host, device=device)
    si.add_batch(new_corpus)
    si.seal()
    si.compact(all_segments=True)
    return si.to_host()


def _merge_documents(host: PostingsHost, new_corpus: TokenizedCorpus,
                     base: int) -> PostingsHost:
    """One-shot merge: the old postings back to triples, the new ones
    at ids ``base + i``, one merged sort."""
    doc_of, terms, counts = _flatten(new_corpus)
    doc_of = doc_of + base
    merged_hashes, remap = merge_vocab(host.term_hashes,
                                       new_corpus.term_hashes)
    terms = remap[terms]
    old_terms = np.repeat(np.arange(host.num_terms, dtype=np.int64),
                          np.diff(host.offsets))
    all_docs = np.concatenate([host.doc_ids.astype(np.int64), doc_of])
    all_terms = np.concatenate([old_terms, terms])
    all_counts = np.concatenate([host.tfs.astype(np.float64),
                                 counts.astype(np.float64)])
    num_docs = max(host.num_docs, int(doc_of.max()) + 1 if len(doc_of) else 0,
                   base + new_corpus.num_docs)
    return _postings_from_triples(all_docs, all_terms, all_counts,
                                  len(merged_hashes), num_docs,
                                  merged_hashes)


def corpus_stats(host: PostingsHost) -> CorpusStats:
    return CorpusStats(D=host.num_docs, W=host.num_terms,
                       N_d=host.num_postings,
                       N=int(host.tfs.sum()))
