"""The one generator of traffic: reads a mix's parameters and the seed
and makes the queries, their arrival times and the writes.

Every seed gets the same set of sizes and arrivals in another order:
the inter-arrival gaps are the stratified quantiles of the mix's
arrival law (scaled so that exactly ``rate x seconds`` queries fall in
the window), each query length has its exact share, and the seed only
permutes them and picks the terms.  So two seeds offer the same amount
of work; only which terms and in which order differ.
"""
from __future__ import annotations

import numpy as np


def sample_query_terms(df: np.ndarray, term_hashes: np.ndarray,
                       num_queries: int, terms_per_query: int,
                       df_band: tuple[float, float] = (0.15, 0.5),
                       num_docs: int | None = None,
                       seed: int = 1) -> np.ndarray:
    """Query workload mirroring the paper's §4.3: frequent terms (df in a
    high band).  Returns u32[num_queries, terms_per_query] hashes (a
    frozen copy of the port's ``text.corpus.sample_query_terms``)."""
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


def lengths(shares: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` query lengths with each length's exact share (largest
    remainders), in the seed's order."""
    keys = sorted(int(k) for k in shares)
    w = np.array([float(shares[str(k)]) for k in keys])
    exact = w / w.sum() * n
    count = np.floor(exact).astype(np.int64)
    rest = n - int(count.sum())
    count[np.argsort(-(exact - count), kind="stable")[:rest]] += 1
    return rng.permutation(np.repeat(np.array(keys), count))


def query_rows(df: np.ndarray, term_hashes: np.ndarray, num_docs: int,
               lens: np.ndarray, width: int, df_band, seed: int
               ) -> np.ndarray:
    """u32[len(lens), width]: query ``i`` holds ``lens[i]`` distinct
    terms of the df band (zero-padded), drawn from ``seed``."""
    rows = np.zeros((len(lens), width), np.uint32)
    for n in np.unique(lens):
        at = np.flatnonzero(lens == n)
        rows[at, :n] = sample_query_terms(
            df, term_hashes, len(at), int(n), tuple(df_band),
            num_docs=num_docs, seed=[int(seed), int(n)])
    return rows


def arrivals(law: str, rate: float, seconds: float,
             rng: np.random.Generator) -> np.ndarray:
    """Due times (s from the window's start) of ``round(rate x seconds)``
    queries: stratified gaps of the arrival law, in the seed's order,
    scaled so that the last is due just before the window closes."""
    n = max(int(round(rate * seconds)), 1)
    u = (np.arange(n) + 0.5) / n
    if law != "poisson":
        raise ValueError(f"unknown arrival law {law!r}")
    gaps = rng.permutation(-np.log1p(-u))
    due = np.cumsum(gaps)
    return due * (seconds * (n - 0.5) / n / due[-1])
