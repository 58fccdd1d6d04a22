"""Synthetic Zipf corpus calibrated to the paper's collection (§4).

The paper's 1,004,721-document Greek crawl is not redistributable; we
generate corpora whose *statistics* match: W distinct terms, average
~239 distinct words per document, Zipf-distributed term frequencies, and
query terms drawn from a high-df band (the paper picks df ≈ 300,000 for
D ≈ 1M, i.e. df/D ≈ 0.3).

numpy-only: a copy of ``repro.text.corpus`` (whose package imports jax),
so both packages generate the very same corpus from the same spec.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.build import TokenizedCorpus
from repro_torch.text.tokenizer import mix32


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    num_docs: int = 2_000
    vocab: int = 5_000
    avg_distinct: int = 60      # paper: 239
    zipf_s: float = 1.07
    seed: int = 0


PAPER_SPEC = CorpusSpec(num_docs=1_004_721, vocab=216_449, avg_distinct=239)


def _zipf_cdf(vocab: int, s: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-s)
    p /= p.sum()
    return np.cumsum(p)


def generate(spec: CorpusSpec) -> TokenizedCorpus:
    """Vectorized Zipf corpus: per-doc distinct terms + counts."""
    rng = np.random.default_rng(spec.seed)
    cdf = _zipf_cdf(spec.vocab, spec.zipf_s)

    # Document lengths (token draws before dedup): lognormal around the
    # target, then dedup produces distinct-term lists.
    target = max(spec.avg_distinct, 1)
    raw_len = rng.lognormal(mean=np.log(target * 1.6), sigma=0.5,
                            size=spec.num_docs)
    raw_len = np.clip(raw_len.astype(np.int64), 4, spec.vocab * 4)

    doc_term_ids: list[np.ndarray] = []
    doc_counts: list[np.ndarray] = []
    boundaries = np.zeros(spec.num_docs + 1, dtype=np.int64)
    np.cumsum(raw_len, out=boundaries[1:])
    total = int(boundaries[-1])
    u = rng.random(total)
    tokens = np.searchsorted(cdf, u).astype(np.int64)  # Zipf-ranked ids
    tokens = np.minimum(tokens, spec.vocab - 1)
    for d in range(spec.num_docs):
        toks = tokens[boundaries[d]:boundaries[d + 1]]
        terms, counts = np.unique(toks, return_counts=True)
        doc_term_ids.append(terms)
        doc_counts.append(counts)

    term_hashes = mix32(np.arange(spec.vocab, dtype=np.uint32))
    return TokenizedCorpus(doc_term_ids=doc_term_ids, doc_counts=doc_counts,
                           term_hashes=term_hashes, num_docs=spec.num_docs)


def _batch_from_tokens(tokens: np.ndarray, boundaries: np.ndarray,
                       term_hashes: np.ndarray) -> TokenizedCorpus:
    """Vectorized per-doc dedup: one lexsort over the whole batch instead
    of a ``np.unique`` per document (the per-doc loop dominates build
    time at million-page scale)."""
    n_docs = len(boundaries) - 1
    doc_idx = np.repeat(np.arange(n_docs, dtype=np.int64),
                        np.diff(boundaries))
    order = np.lexsort((tokens, doc_idx))
    d, t = doc_idx[order], tokens[order]
    # run boundaries of (doc, term) pairs
    first = np.ones(len(t), dtype=bool)
    first[1:] = (d[1:] != d[:-1]) | (t[1:] != t[:-1])
    starts = np.flatnonzero(first)
    counts = np.diff(np.append(starts, len(t))).astype(np.int64)
    run_docs = d[starts]
    run_terms = t[starts]
    per_doc = np.bincount(run_docs, minlength=n_docs)
    splits = np.cumsum(per_doc)[:-1]
    doc_term_ids = np.split(run_terms, splits)
    doc_counts = np.split(counts, splits)
    return TokenizedCorpus(doc_term_ids=doc_term_ids,
                           doc_counts=doc_counts,
                           term_hashes=term_hashes, num_docs=n_docs)


def stream_batches(spec: CorpusSpec, batch_docs: int = 50_000):
    """Yield the corpus of ``spec`` as TokenizedCorpus batches of at most
    ``batch_docs`` documents WITHOUT materializing the full collection —
    host RAM is bounded by one batch regardless of ``spec.num_docs``.

    Determinism contract: the stream is a pure function of ``(spec,
    batch_docs)`` — each batch draws from its own ``seed + batch index``
    substream, so rerunning with the same batching reproduces the exact
    corpus (this is what makes the committed BENCH artifacts
    re-runnable).  Changing ``batch_docs`` moves batch boundaries and
    therefore reseeds every draw: the token draws differ, and only the
    DISTRIBUTIONAL statistics (Zipf term frequencies, lognormal doc
    lengths) are batching-independent.  Likewise the stream is NOT the
    same corpus as one-shot ``generate``; streams and one-shot corpora
    are distinct corpora by design.

    A single batch of all documents (``batch_docs >= num_docs``) is what
    ``core.build.bulk_build`` takes as one corpus.
    """
    if batch_docs < 1:
        raise ValueError("batch_docs must be >= 1")
    cdf = _zipf_cdf(spec.vocab, spec.zipf_s)
    term_hashes = mix32(np.arange(spec.vocab, dtype=np.uint32))
    target = max(spec.avg_distinct, 1)
    done = 0
    batch_i = 0
    while done < spec.num_docs:
        n = min(batch_docs, spec.num_docs - done)
        rng = np.random.default_rng(spec.seed + 7919 * (batch_i + 1))
        raw_len = rng.lognormal(mean=np.log(target * 1.6), sigma=0.5,
                                size=n)
        raw_len = np.clip(raw_len.astype(np.int64), 4, spec.vocab * 4)
        boundaries = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(raw_len, out=boundaries[1:])
        u = rng.random(int(boundaries[-1]))
        tokens = np.searchsorted(cdf, u).astype(np.int64)
        tokens = np.minimum(tokens, spec.vocab - 1)
        yield _batch_from_tokens(tokens, boundaries, term_hashes)
        done += n
        batch_i += 1


def sample_query_terms(df: np.ndarray, term_hashes: np.ndarray,
                       num_queries: int, terms_per_query: int,
                       df_band: tuple[float, float] = (0.15, 0.5),
                       num_docs: int | None = None,
                       seed: int = 1) -> np.ndarray:
    """Query workload mirroring §4.3: frequent terms (df in a high band).

    Returns u32[num_queries, terms_per_query] hash matrix (0-padded).
    """
    rng = np.random.default_rng(seed)
    D = num_docs if num_docs is not None else int(df.max()) + 1
    frac = df / max(D, 1)
    pool = np.where((frac >= df_band[0]) & (frac <= df_band[1]))[0]
    if len(pool) < terms_per_query:
        pool = np.argsort(df)[::-1][:max(terms_per_query * 8, 64)]
    out = np.zeros((num_queries, terms_per_query), dtype=np.uint32)
    for q in range(num_queries):
        pick = rng.choice(pool, size=terms_per_query,
                          replace=len(pool) < terms_per_query)
        out[q] = term_hashes[pick]
    return out
