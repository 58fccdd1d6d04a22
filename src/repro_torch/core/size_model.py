"""The parts of the reference's analytic size model (``repro.core.
size_model``) that the bulk query path needs: the corpus statistics
record of paper Table 4 and the tuning-table size-class key.  The layout
cost model and the band-cut chooser come with the live-index slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CorpusStats:
    D: int        # documents
    W: int        # distinct words
    N_d: int      # total postings (sum of per-doc distinct words)
    N: int = 0    # total occurrences (only needed for position variants)

    @property
    def w_avg(self) -> float:
        return self.N_d / max(self.D, 1)


def tuning_size_class(num_docs: int, route_tile: int = 512) -> int:
    """Size-class key for the kernel tuning table: the smallest
    ``route_tile * 2**i >= num_docs`` (idempotent on its own output)."""
    n = max(int(num_docs), 1)
    c = max(int(route_tile), 1)
    while c < n:
        c *= 2
    return c
