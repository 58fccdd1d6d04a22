"""The reference's analytic size model (``repro.core.size_model``): the
paper's Table 4 corpus statistics and its §4.1 size formulas (Table 5:
PR against ORIF in a DBMS with per-tuple overhead, and the device
layouts' true array bytes), the tuning-table size-class key, the
per-layout posting-byte models, the band-cut chooser of banded segments
and the per-segment layout chooser (``LayoutCostModel``,
``resolve_layout``).

Notation (paper Table 4): N total word occurrences, D documents, N_d
total postings (sum over docs of distinct words), W distinct words, t
the per-tuple DBMS overhead (40 bytes in PSQL), f the field size (4
bytes for int4/float4).

The chooser prefers measured costs: when the active tuning table
(``kernels.autotune``) holds the sweep's median seconds for every
candidate layout at the run's (device type, size class), the fastest
wins; otherwise the byte model decides, and a partial sweep says so in
the reason.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusStats:
    D: int        # documents
    W: int        # distinct words
    N_d: int      # total postings (sum of per-doc distinct words)
    N: int = 0    # total occurrences (only needed for position variants)

    @property
    def w_avg(self) -> float:
        return self.N_d / max(self.D, 1)


PSQL_FIELD_BYTES = 4      # int4 / float4
PSQL_TUPLE_OVERHEAD = 40  # paper §4.1
PSQL_PAGE_BYTES = 8 * 1024
PSQL_POINT_BYTES = 16     # paper footnote 8 (point = 2 float8)

# The paper's own collection (§4): 1,004,721 docs, 216,449 terms, 239
# distinct words per doc on average.
PAPER_COLLECTION = CorpusStats(D=1_004_721, W=216_449,
                               N_d=1_004_721 * 239, N=1_004_721 * 239 * 3)


def pr_bytes(s: CorpusStats, positions: bool = False,
             f: int = PSQL_FIELD_BYTES, t: int = PSQL_TUPLE_OVERHEAD) -> int:
    """PR: N_d * (3f + t), plus N * (3f + t) with positions."""
    base = s.N_d * (3 * f + t)
    if positions:
        base += s.N * (3 * f + t)
    return base


def orif_bytes(s: CorpusStats, positions: bool = False,
               f: int = PSQL_FIELD_BYTES, t: int = PSQL_TUPLE_OVERHEAD) -> int:
    """ORIF: W * (f + t) + 2 f N_d, plus f N with positions."""
    base = s.W * (f + t) + 2 * f * s.N_d
    if positions:
        base += f * s.N
    return base


def pr_over_orif(s: CorpusStats, positions: bool = False) -> float:
    return pr_bytes(s, positions) / orif_bytes(s, positions)


def pages(nbytes: int, page: int = PSQL_PAGE_BYTES) -> int:
    return -(-nbytes // page)


def coo_layout_bytes(s: CorpusStats, id_bytes: int = 4,
                     tf_bytes: int = 4) -> int:
    """PR analogue: word_id + doc_id + tf columns, plus word and doc
    tables."""
    postings = s.N_d * (2 * id_bytes + tf_bytes)
    word_table = s.W * (id_bytes + id_bytes)          # hash, df
    doc_table = s.D * (tf_bytes + tf_bytes)           # norm, rank
    return postings + word_table + doc_table


def csr_layout_bytes(s: CorpusStats, id_bytes: int = 4,
                     tf_bytes: int = 4) -> int:
    """OR/COR analogue: offsets + packed doc_id, tf; no word_id column."""
    postings = s.N_d * (id_bytes + tf_bytes)
    offsets = (s.W + 1) * id_bytes
    word_table = s.W * (id_bytes + id_bytes)          # hash, df
    doc_table = s.D * (tf_bytes + tf_bytes)
    return postings + offsets + word_table + doc_table


def packed_csr_layout_bytes(s: CorpusStats, mean_bits: float = 12.0,
                            tf_bytes: int = 2, id_bytes: int = 4) -> int:
    """Beyond the paper: delta+bit-packed doc ids (``mean_bits`` per
    posting) + fp16 tf."""
    postings = int(s.N_d * mean_bits / 8) + s.N_d * tf_bytes
    offsets = (s.W + 1) * id_bytes
    word_table = s.W * (id_bytes + id_bytes)
    doc_table = s.D * (2 * tf_bytes)
    return postings + offsets + word_table + doc_table


def tuning_size_class(num_docs: int, route_tile: int = 512) -> int:
    """Size-class key for the kernel tuning table: the smallest
    ``route_tile * 2**i >= num_docs`` (idempotent on its own output)."""
    n = max(int(num_docs), 1)
    c = max(int(route_tile), 1)
    while c < n:
        c *= 2
    return c


def candidate_bytes_per_query(num_docs: int, tile: int, k_tile: int) -> int:
    """Device bytes of per-tile candidates one query emits: the (value,
    id) pair lists the fused candidate kernels write instead of a dense
    score row."""
    n_tiles = max(-(-int(num_docs) // max(int(tile), 1)), 1)
    return n_tiles * int(k_tile) * 8


# ---------------------------------------------------------------------------
# per-segment layout cost model (the adaptive hor-vs-packed chooser)
# ---------------------------------------------------------------------------

_BLOCK = 128          # layouts.BLOCK; kept literal to avoid a core cycle
_HOR_SLOT_BYTES = 8   # i32 doc id + f32 tf per posting slot
_PACKED_TF_BYTES = 2  # f16 tf per posting


@dataclasses.dataclass(frozen=True)
class SegmentStats:
    """Aggregate shape of one posting run (a sealed segment, a merged
    compaction input, or a whole host corpus)."""
    num_docs: int      # local doc span of the run
    num_postings: int
    num_terms: int     # distinct terms with >= 1 posting in the run

    @property
    def avg_df(self) -> float:
        return self.num_postings / max(self.num_terms, 1)


def est_delta_bits(stats: SegmentStats) -> float:
    """Expected per-block bit width of delta-coded doc ids: one bit of
    headroom over ceil(log2(mean gap)), since a block pays its widest
    gap."""
    gap = max(stats.num_docs / max(stats.avg_df, 1.0), 1.0)
    bits = math.ceil(math.log2(gap + 1.0)) + 1
    return float(min(max(bits, 1), 32))


def hor_posting_bytes_from_df(df, block: int = _BLOCK) -> int:
    """EXACT posting-array bytes of an (unpadded) BlockedIndex built
    from per-term document frequencies ``df``."""
    df = np.asarray(df, dtype=np.int64)
    nb = int(np.sum(-(-df[df > 0] // block)))
    offsets = (len(df) + 1) * 4
    return offsets + nb * (block * _HOR_SLOT_BYTES + 8)


def est_hor_posting_bytes(stats: SegmentStats, block: int = _BLOCK) -> int:
    """Analytic BlockedIndex posting bytes from aggregate stats: every
    term wastes half a block of padding in expectation."""
    nb = stats.num_postings / block + 0.5 * stats.num_terms
    offsets = (stats.num_terms + 1) * 4
    return int(offsets + nb * (block * _HOR_SLOT_BYTES + 8))


def est_packed_posting_bytes(stats: SegmentStats, block: int = _BLOCK,
                             bits: float | None = None) -> int:
    """Analytic PackedCsrIndex posting bytes from aggregate stats: per
    padded slot bits/8 + 2 bytes, plus the per-block decode triple and
    the per-term offsets."""
    if bits is None:
        bits = est_delta_bits(stats)
    nb = stats.num_postings / block + 0.5 * stats.num_terms
    offsets = (stats.num_terms + 1) * 4
    per_slot = bits / 8.0 + _PACKED_TF_BYTES
    return int(offsets + nb * (block * per_slot + 12))


def banded_posting_bytes_from_words(words, nblocks, cut: int,
                                    block: int = _BLOCK,
                                    lane_quantum: int = 1) -> int:
    """EXACT posting-array bytes of an (unpadded) BandedCsrIndex built
    with band cut ``cut`` from per-term packed widths ``words`` and
    block counts ``nblocks`` (``layouts.term_packed_words``).  Terms
    with ``0 < words <= cut`` land in the packed band, whose stride is
    the band-local max width rounded up to ``lane_quantum``; the rest
    pay the HOR slot cost.  Both bands carry a full-vocabulary offsets
    array."""
    words = np.asarray(words, dtype=np.int64)
    nblocks = np.asarray(nblocks, dtype=np.int64)
    offsets = 2 * (len(words) + 1) * 4
    in_packed = (words > 0) & (words <= int(cut))
    nb_p = int(nblocks[in_packed].sum())
    nb_h = int(nblocks[(words > 0) & ~in_packed].sum())
    if nb_p:
        q = max(int(lane_quantum), 1)
        stride = -(-int(words[in_packed].max()) // q) * q
    else:
        stride = 1
    return (offsets
            + nb_p * (4 * stride + _PACKED_TF_BYTES * block + 12)
            + nb_h * (block * _HOR_SLOT_BYTES + 8))


def choose_band_cut(words, nblocks, block: int = _BLOCK,
                    lane_quantum: int = 1) -> tuple[int, int]:
    """The band cut (in int32 words) minimizing the exact banded byte
    model over the realized per-term widths: 0 (everything HOR) or a
    distinct realized width, ties toward the smaller cut.  Returns
    ``(cut, posting_bytes_at_cut)``."""
    words = np.asarray(words, dtype=np.int64)
    nblocks = np.asarray(nblocks, dtype=np.int64)
    cands = [0] + sorted({int(w) for w in words[words > 0]})
    best_cut, best_bytes = 0, None
    for c in cands:
        b = banded_posting_bytes_from_words(words, nblocks, c, block=block,
                                            lane_quantum=lane_quantum)
        if best_bytes is None or b < best_bytes:
            best_cut, best_bytes = c, b
    return best_cut, int(best_bytes)


def est_banded_posting_bytes(stats: SegmentStats, block: int = _BLOCK) -> int:
    """Analytic BandedCsrIndex posting bytes from aggregate stats: half
    the vocabulary as a df~1 HOR tail of one block per term, the body at
    the packed rate, plus the second offsets array."""
    t_tail = min(stats.num_terms // 2, stats.num_postings)
    body_terms = stats.num_terms - t_tail
    body_postings = stats.num_postings - t_tail
    extra_offsets = (stats.num_terms + 1) * 4
    if body_terms <= 0 or body_postings <= 0:
        return est_hor_posting_bytes(stats, block) + extra_offsets
    body = SegmentStats(num_docs=stats.num_docs,
                        num_postings=body_postings, num_terms=body_terms)
    tail_bytes = t_tail * (block * _HOR_SLOT_BYTES + 8)
    return int(est_packed_posting_bytes(body, block) + tail_bytes
               + extra_offsets)


def est_posting_bytes(stats: SegmentStats, layout: str,
                      block: int = _BLOCK) -> int:
    """Analytic posting-array bytes for any layout of the reference
    (the posting columns + per-term offsets, as ``posting_bytes``)."""
    offsets = (stats.num_terms + 1) * 4
    if layout in ("pr", "coo"):
        return int(stats.num_postings * 16)
    if layout in ("or", "csr", "cor", "compact_csr"):
        return int(offsets + stats.num_postings * 8)
    if layout == "hor":
        return est_hor_posting_bytes(stats, block)
    if layout == "packed":
        return est_packed_posting_bytes(stats, block)
    if layout == "banded":
        return est_banded_posting_bytes(stats, block)
    raise ValueError(f"unknown layout {layout!r}")


@dataclasses.dataclass(frozen=True)
class LayoutDecision:
    """One chooser verdict: the layout plus a readable reason string
    that survives into segment introspection."""
    layout: str
    reason: str


@dataclasses.dataclass(frozen=True)
class LayoutCostModel:
    """Per-segment hor-vs-packed(-vs-banded) chooser: the best non-hor
    layout by predicted posting bytes must beat hor by ``hbm_ratio_max``
    or the run stays hor, and runs below ``min_packed_docs`` local docs
    stay hor (decode-bound).  The POLICY rung of the override ladder
    (``explicit arg > policy > default``)."""
    min_packed_docs: int = 4096
    hbm_ratio_max: float = 0.9
    candidates: tuple = ("hor", "packed")

    def predicted_posting_bytes(self, stats: SegmentStats,
                                layout: str) -> int:
        if layout == "packed":
            return est_packed_posting_bytes(stats)
        if layout == "banded":
            return est_banded_posting_bytes(stats)
        return est_hor_posting_bytes(stats)

    def measured_cost_s(self, device_type: str, size_class: int,
                        layout: str) -> float | None:
        """The fused engine's median seconds from the active tuning
        table's sweep record at exactly this (device type, size_class,
        layout), or None where the sweep has not timed it."""
        from repro_torch.kernels import autotune
        return autotune.get_active().cost(device_type, size_class, layout)

    def choose(self, stats: SegmentStats, size_class: int | None = None,
               device_type: str = "cuda") -> LayoutDecision:
        """Pick a layout for a run shaped like ``stats``: by the measured
        costs when the table has swept EVERY candidate at this
        (device type, size_class), else by the byte model gated on
        ``min_packed_docs``.  Reason strings are character-identical to
        the reference's, with the device type where it names a
        backend."""
        if size_class is None:
            size_class = tuning_size_class(stats.num_docs)
        costs = {l: self.measured_cost_s(device_type, size_class, l)
                 for l in self.candidates}
        if all(c is not None for c in costs.values()):
            best = min(self.candidates, key=lambda l: (costs[l], l))
            return LayoutDecision(best, (
                f"measured:{device_type}@{size_class} "
                + " ".join(f"{l}={costs[l]:.2e}s" for l in self.candidates)))
        d = self._analytic_choose(stats, size_class)
        measured = [l for l in self.candidates if costs[l] is not None]
        if measured:
            # a partial sweep is not a measurement: the byte model decided
            return LayoutDecision(d.layout, (
                f"analytic:partial-measured({','.join(measured)}) "
                + d.reason[len("analytic:"):]))
        return d

    def _analytic_choose(self, stats: SegmentStats,
                         size_class: int) -> LayoutDecision:
        """The byte-model rung: the best non-hor layout by predicted
        bytes must beat hor by ``hbm_ratio_max`` or the run stays hor."""
        if stats.num_docs < self.min_packed_docs:
            return LayoutDecision("hor", (
                f"analytic:small-segment {stats.num_docs}"
                f"<{self.min_packed_docs} docs (decode-bound)"))
        non_hor = [l for l in self.candidates if l != "hor"]
        if not non_hor:
            return LayoutDecision("hor",
                                  f"analytic:hor only candidate @{size_class}")
        hb = self.predicted_posting_bytes(stats, "hor")
        nh_bytes = {l: self.predicted_posting_bytes(stats, l)
                    for l in non_hor}
        best = min(non_hor, key=lambda l: (nh_bytes[l], l))
        ratio = nh_bytes[best] / max(hb, 1)
        if ratio <= self.hbm_ratio_max:
            return LayoutDecision(best, (
                f"analytic:bytes/q {ratio:.2f}x hor @{size_class}"))
        return LayoutDecision("hor", (
            f"analytic:{best} only {ratio:.2f}x hor @{size_class}"
            f" (>{self.hbm_ratio_max})"))

    def to_dict(self) -> dict:
        """The snapshot manifest's form (``serve.snapshot``, format v2+)."""
        return {"min_packed_docs": self.min_packed_docs,
                "hbm_ratio_max": self.hbm_ratio_max,
                "candidates": list(self.candidates)}

    @classmethod
    def from_dict(cls, d: dict) -> "LayoutCostModel":
        return cls(min_packed_docs=int(d["min_packed_docs"]),
                   hbm_ratio_max=float(d["hbm_ratio_max"]),
                   candidates=tuple(d.get("candidates", ("hor", "packed"))))


def resolve_layout(explicit: str | None, policy, stats: SegmentStats,
                   default: str, size_class: int | None = None,
                   device_type: str = "cuda") -> tuple[str, str]:
    """The override ladder every layout-taking layer funnels through:
    ``explicit arg > policy > default``; the policy reads measured costs
    on ``device_type``.  Returns ``(layout, reason)``."""
    if explicit is not None:
        return str(explicit), "explicit"
    if policy is not None:
        d = policy.choose(stats, size_class=size_class,
                          device_type=device_type)
        return d.layout, d.reason
    return str(default), "default"
