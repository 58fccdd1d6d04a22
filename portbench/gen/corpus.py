"""Seeded synthetic collections, made on the device in a few large calls.

The distribution is the project's synthetic corpus (its 1m tier): each
document draws a lognormal number of tokens around 1.6x the target
count of distinct terms (sigma 0.5, at least 4), each token a
Zipf-ranked term id over ``vocab`` ids, and the document keeps its
distinct terms with their counts.  Term ids map to u32 hashes through a
bijective 32-bit mix, so no two terms share a hash.

The same ``(spec, seed, stream)`` gives the same documents on the same
device type; different streams of one seed are independent draws (the
base collection, the tier's churn, the writes of the window).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

STREAMS = {"base": 1, "churn": 2, "writes": 3}


@dataclasses.dataclass(frozen=True)
class Spec:
    num_docs: int
    vocab: int
    avg_distinct: int
    zipf_s: float


@dataclasses.dataclass
class Docs:
    """Documents as (doc, term, count) triples, doc-major and ascending
    term within a doc, on the host: ``doc_of`` i32, ``terms`` i64,
    ``counts`` i64, and ``offsets`` i64[num_docs + 1] per document."""
    doc_of: np.ndarray
    terms: np.ndarray
    counts: np.ndarray
    offsets: np.ndarray
    num_docs: int

    def slice(self, lo: int, hi: int) -> "Docs":
        a, b = int(self.offsets[lo]), int(self.offsets[hi])
        return Docs(doc_of=self.doc_of[a:b] - lo, terms=self.terms[a:b],
                    counts=self.counts[a:b],
                    offsets=self.offsets[lo:hi + 1] - a, num_docs=hi - lo)

    def term_lists(self) -> tuple[list, list]:
        """Per-document arrays of distinct term ids and their counts."""
        cut = self.offsets[1:-1]
        return np.split(self.terms, cut), np.split(self.counts, cut)


def mix32(x: np.ndarray) -> np.ndarray:
    """Bijective 32-bit finalizer (murmur3-style): term id -> hash, never 0
    (0 marks an empty query slot)."""
    x = x.astype(np.uint64)
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return np.maximum(x, 1).astype(np.uint32)


def term_hashes(vocab: int) -> np.ndarray:
    return mix32(np.arange(vocab, dtype=np.uint32))


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for one stream of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + STREAMS[stream]) % (1 << 63))
    return g


def zipf_cdf(vocab: int, s: float, device) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks.pow(-s)
    return torch.cumsum(p / p.sum(), 0)


def generate(spec: Spec, seed: int, stream: str, device) -> Docs:
    """``spec.num_docs`` documents of one stream of ``seed``."""
    g = generator(seed, stream, device)
    n, w = spec.num_docs, spec.vocab
    target = max(spec.avg_distinct, 1)
    raw = torch.empty(n, dtype=torch.float64, device=device)
    raw.log_normal_(math.log(target * 1.6), 0.5, generator=g)
    raw_len = raw.long().clamp_(4, w * 4)
    total = int(raw_len.sum())
    u = torch.rand(total, dtype=torch.float64, device=device, generator=g)
    tokens = torch.searchsorted(zipf_cdf(w, spec.zipf_s, device), u)
    del u
    tokens.clamp_(max=w - 1)
    doc = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=device), raw_len)
    key, counts = torch.unique(doc * w + tokens, sorted=True,
                               return_counts=True)
    del doc, tokens
    doc_of = torch.div(key, w, rounding_mode="floor")
    per_doc = torch.bincount(doc_of, minlength=n)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(per_doc, 0, out=offsets[1:])
    return Docs(doc_of=doc_of.to(torch.int32).cpu().numpy(),
                terms=(key % w).cpu().numpy(),
                counts=counts.cpu().numpy(),
                offsets=offsets.cpu().numpy(), num_docs=n)


def document_frequency(docs: Docs, vocab: int) -> np.ndarray:
    return np.bincount(docs.terms, minlength=vocab).astype(np.int64)
