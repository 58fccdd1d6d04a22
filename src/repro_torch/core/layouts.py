"""The paper's four index representations, and the beyond-paper packed
and banded layouts, as PyTorch tensors: the port of
``repro.core.layouts``.

  PR     -> CooIndex        heap of (word, doc, tf) tuples in arrival
                            (doc) order plus a B+tree analogue: a
                            (term, doc)-sorted permutation with per-term
                            starts.  A term's postings are scattered over
                            the heap, so q_occ gathers at random.
  OR     -> CsrIndex        postings packed contiguously per term
                            (offsets + doc ids + tfs), beside a separate
                            word table (lookup + df)
  COR    -> CompactCsrIndex the word table folded into the posting
                            relation: terms in hash order, the sorted
                            hashes are the lookup structure
  HOR    -> BlockedIndex    postings in fixed 128-lane blocks with per-
                            block doc-id min/max summaries (the paper's
                            hstore + GIN analogue)
  (beyond paper)
         -> PackedCsrIndex  delta + bit-packed doc ids, fp16 tf
         -> BandedCsrIndex  per-term-band choice: a packed band with a
                            band-local stride + an HOR tail

PR and OR take either term lookup of the paper's Table 6: a
``SortedLookup`` (the B+tree analogue, binary search) or a
``HashLookup`` (open addressing).
Each index is a frozen dataclass of tensors with ``.to(device)`` (a
banded index pairs one HOR and one packed index).
Index builds are host-side numpy (the PR heap's two sorts run in torch on
the target device), byte-equal to the reference's, and put the result
on ``device`` ("cuda" unless the caller asks for the CPU).
Storage widths match the reference so ``nbytes()`` / ``posting_bytes()``
agree; u32 arrays (term hashes, hash-table keys, packed words) are held
as int32 bit-views because torch has no unsigned shifts or
``searchsorted``: hashes are searched on ``x ^ INT32_MIN``, which keeps
the unsigned order, and shifted words are masked after ``>>`` (int32
shifts are arithmetic).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.segments import gather_segments, take_rows

Tensor = torch.Tensor

BLOCK = 128  # posting block size
ROUTE_TILE = 512  # doc-tile width the scoring kernels route against
INT32_MIN = -2**31
HASH_EMPTY = -1   # u32 0xFFFFFFFF as an int32 bit-view: vocabulary padding


def as_i32_bits(a: np.ndarray) -> np.ndarray:
    """u32 numpy array -> the same bits as int32 (the port's storage)."""
    return np.ascontiguousarray(np.asarray(a).astype(np.uint32)).view(np.int32)


def hash_tensor(hashes, device=None) -> Tensor:
    """Query term hashes (u32 numpy, or a tensor already holding int32
    bit-views) -> an int32 bit-view tensor on ``device``."""
    if isinstance(hashes, Tensor):
        if hashes.dtype != torch.int32:
            raise TypeError(f"hash tensors hold u32 bit-views as int32, "
                            f"got {hashes.dtype}")
        return hashes.to(device)
    return torch.from_numpy(as_i32_bits(hashes)).to(device)


def _to(obj, device):
    """Move every tensor field (and nested DocTable or lookup) of a
    frozen layout."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _to(v, device)
    return dataclasses.replace(obj, **changes)


def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


def _block_tile_routing(block_min: np.ndarray, block_max: np.ndarray,
                        num_docs: int, tile: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side pair-routing cache: per-block doc-tile span.

    A block overlaps the contiguous tile range [min//tile, max//tile];
    a pure function of the immutable index, built once.  Returns
    (tile_first i32[NB], tile_count i32[NB]); empty blocks (max < 0)
    get count 0.
    """
    n_tiles = max(-(-num_docs // tile), 1)
    has = block_max >= 0
    t0 = np.clip(block_min // tile, 0, n_tiles - 1)
    t1 = np.clip(block_max // tile, 0, n_tiles - 1)
    first = np.where(has, t0, 0).astype(np.int32)
    count = np.where(has, t1 - t0 + 1, 0).astype(np.int32)
    return first, count


# ---------------------------------------------------------------------------
# shared tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DocTable:
    """Per-document metadata: the paper's ``document`` relation."""
    norm: Tensor   # f32[D]  vector norm under tf-idf (paper §3.6)
    rank: Tensor   # f32[D]  PageRank-like static score

    @property
    def num_docs(self) -> int:
        return self.norm.shape[0]

    def nbytes(self) -> int:
        return _nbytes(self.norm) + _nbytes(self.rank)

    def to(self, device) -> "DocTable":
        return DocTable(norm=self.norm.to(device), rank=self.rank.to(device))


def _sorted_positions(sorted_hash: Tensor, hashes: Tensor):
    """Binary search of int32 hash bit-views in an unsigned-ascending
    ``sorted_hash``: (clamped positions, hit) of the same shape."""
    keys = sorted_hash ^ INT32_MIN
    pos = torch.searchsorted(keys, (hashes ^ INT32_MIN).contiguous())
    pos = pos.clamp(0, sorted_hash.shape[0] - 1)
    return pos, sorted_hash[pos] == hashes


@dataclasses.dataclass(frozen=True)
class SortedLookup:
    """B+tree analogue: binary search over sorted term hashes."""
    sorted_hash: Tensor  # i32[W]  u32 hash bit-views, unsigned-ascending
    perm: Tensor         # i32[W]  sorted position -> term id

    def lookup(self, hashes: Tensor) -> Tensor:
        """int32 hash bit-views [...] -> term ids, -1 where absent."""
        pos, hit = _sorted_positions(self.sorted_hash, hashes)
        return torch.where(hit, self.perm[pos], -1).to(torch.int32)

    def nbytes(self) -> int:
        return _nbytes(self.sorted_hash) + _nbytes(self.perm)


HASH_MULT = 2654435761   # Knuth's multiplicative hash, as the reference
MAX_PROBES = 16


@dataclasses.dataclass(frozen=True)
class HashLookup:
    """Open-addressed hash table analogue of a DBMS Hash index: slot
    ``(hash * HASH_MULT) mod S`` and the next ``MAX_PROBES - 1`` slots."""
    keys: Tensor   # i32[S]  u32 bit-views, HASH_EMPTY where empty; S = 2**i
    vals: Tensor   # i32[S]  term id, -1 where empty

    def lookup(self, hashes: Tensor) -> Tensor:
        """int32 hash bit-views [...] -> term ids, -1 where absent.

        The reference computes the slot as a u32 product masked to
        ``S - 1``.  Here both factors are reduced mod S first, which
        leaves the product mod S unchanged (S is a power of two) and
        keeps it below 2**62 in int64, so nothing relies on overflow."""
        size = self.keys.shape[0]
        if size > 2**31:
            raise ValueError(f"hash table of {size} slots: the slot "
                             "arithmetic holds tables of up to 2**31")
        mask = size - 1
        h = hashes.long() & 0xFFFFFFFF
        base = ((h & mask) * (HASH_MULT & mask)) & mask
        k = torch.arange(MAX_PROBES, device=hashes.device)
        probe = (base[..., None] + k) & mask
        hit = self.keys[probe] == hashes[..., None]
        first = torch.where(hit, k, MAX_PROBES).min(dim=-1).values
        slot = torch.gather(probe, -1,
                            first.clamp_max(MAX_PROBES - 1)[..., None])[..., 0]
        return torch.where(hit.any(dim=-1), self.vals[slot],
                           -1).to(torch.int32)

    def nbytes(self) -> int:
        return _nbytes(self.keys) + _nbytes(self.vals)


def build_sorted_lookup(term_hashes: np.ndarray,
                        device="cuda") -> SortedLookup:
    order = np.argsort(term_hashes, kind="stable")
    return _to(SortedLookup(
        sorted_hash=torch.from_numpy(as_i32_bits(term_hashes[order])),
        perm=torch.from_numpy(order.astype(np.int32))), device)


def build_hash_lookup(term_hashes: np.ndarray, device="cuda") -> HashLookup:
    """The reference's build, unchanged: linear probing from each term's
    home slot, doubling the table until every key fits within
    ``MAX_PROBES`` slots."""
    w = len(term_hashes)
    size = 1 << int(np.ceil(np.log2(max(4 * w, 16))))
    while True:
        keys = np.full(size, 0xFFFFFFFF, dtype=np.uint32)
        vals = np.full(size, -1, dtype=np.int32)
        ok = True
        base = (term_hashes.astype(np.uint64) * HASH_MULT) % size
        for tid, b in enumerate(base.astype(np.int64)):
            placed = False
            for p in range(MAX_PROBES):
                s = (b + p) & (size - 1)
                if keys[s] == 0xFFFFFFFF:
                    keys[s] = term_hashes[tid]
                    vals[s] = tid
                    placed = True
                    break
            if not placed:
                ok = False
                break
        if ok:
            return _to(HashLookup(keys=torch.from_numpy(as_i32_bits(keys)),
                                  vals=torch.from_numpy(vals)), device)
        size *= 2  # grow until every key fits within MAX_PROBES


def build_lookup(term_hashes: np.ndarray, lookup: str, device="cuda"):
    """``lookup`` "btree" (a SortedLookup) or "hash" (a HashLookup)."""
    if lookup == "btree":
        return build_sorted_lookup(term_hashes, device)
    if lookup == "hash":
        return build_hash_lookup(term_hashes, device)
    raise ValueError(f"unknown lookup {lookup!r}: 'btree' or 'hash'")


@dataclasses.dataclass(frozen=True)
class PostingsHost:
    """Host (numpy) canonical postings: the logical index content."""
    term_hashes: np.ndarray   # u32[W]  hash of each term (id == position)
    df: np.ndarray            # i32[W]
    # CSR over terms (term-major, doc-sorted within term):
    offsets: np.ndarray       # i64[W+1]
    doc_ids: np.ndarray       # i32[P]
    tfs: np.ndarray           # f32[P]
    num_docs: int
    norm: np.ndarray          # f32[D]
    rank: np.ndarray          # f32[D]

    @property
    def num_terms(self) -> int:
        return len(self.term_hashes)

    @property
    def num_postings(self) -> int:
        return len(self.doc_ids)

    @property
    def max_posting_len(self) -> int:
        if self.num_terms == 0:
            return 0
        return int((self.offsets[1:] - self.offsets[:-1]).max())


class _Terms:
    """The per-term df table every layout carries: ``term_df``,
    ``num_terms``, ``device`` and ``to``."""

    def term_df(self, term_ids: Tensor) -> Tensor:
        safe = term_ids.clamp_min(0).long()
        return torch.where(term_ids >= 0, self.df[safe], 0)

    @property
    def num_terms(self) -> int:
        return self.df.shape[0]

    @property
    def device(self) -> torch.device:
        return self.df.device

    def to(self, device):
        return _to(self, device)


class _SortedTerms(_Terms):
    """Hash-sorted vocabulary (COR-style folded word table):
    ``lookup_terms`` binary-searches ``sorted_hash``, and a term id is
    its position there."""

    def lookup_terms(self, hashes: Tensor) -> Tensor:
        """int32 hash bit-views [...] -> term ids, -1 where absent."""
        pos, hit = _sorted_positions(self.sorted_hash, hashes)
        return torch.where(hit, pos, -1).to(torch.int32)

    def _term_blocks(self, term_ids: Tensor, nblk: int):
        """Block ids [..., nblk] of each term's first ``nblk`` blocks,
        and their validity (inside the term's block range)."""
        safe = term_ids.clamp_min(0).long()
        start = self.block_offsets[safe].long()
        nb = self.block_offsets[safe + 1].long() - start
        k = torch.arange(nblk, device=term_ids.device)
        bvalid = k < nb[..., None]
        bidx = torch.where(bvalid, start[..., None] + k, 0)
        return bidx, bvalid


class _LookupTerms(_Terms):
    """A separate word table (the paper's PR and OR): term ids come from
    the index's ``lookup`` (a SortedLookup or a HashLookup)."""

    def lookup_terms(self, hashes: Tensor) -> Tensor:
        return self.lookup.lookup(hashes)


def _present(term_ids: Tensor, d: Tensor, t: Tensor, v: Tensor):
    """Mask the postings of absent terms (id -1) to (-1, 0.0, False)."""
    present = (term_ids >= 0)[..., None]
    return (torch.where(present, d, -1), torch.where(present, t, 0.0),
            v & present)


def _gather_csr(ix, term_ids: Tensor, cap: int):
    """q_occ for the CSR layouts (OR, COR): one contiguous slab per
    term, (docs, tfs, valid) [..., T, cap]."""
    safe = term_ids.clamp_min(0)
    d, v = gather_segments(ix.doc_ids, ix.offsets, safe, cap, fill=-1)
    t, _ = gather_segments(ix.tfs, ix.offsets, safe, cap, fill=0.0)
    return _present(term_ids, d, t, v)


# ---------------------------------------------------------------------------
# (PR) CooIndex
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CooIndex(_LookupTerms):
    """Plain-Relational analogue: heap of tuples + B+tree permutation."""
    # heap columns, in arrival (doc-major) order, like tuples in a heap file
    word_ids: Tensor     # i32[P]  the redundant column PR pays for
    doc_ids: Tensor      # i32[P]
    tfs: Tensor          # f32[P]
    # "B+tree": (term, doc)-sorted permutation + per-term starts
    perm: Tensor         # i32[P]  sorted posting -> heap position
    term_starts: Tensor  # i32[W+1]
    df: Tensor           # i32[W]
    lookup: SortedLookup | HashLookup
    docs: DocTable
    max_posting_len: int

    def gather_postings(self, term_ids: Tensor, cap: int
                        ) -> Tuple[Tensor, Tensor, Tensor]:
        """q_occ for PR: read the index leaves (``perm``), then gather
        each posting from the heap at random.  The word-id column is
        read too and folded in as ``t + 0.0 * w``, as the reference
        does: streaming it is the cost PR pays."""
        idx, valid = gather_segments(self.perm, self.term_starts,
                                     term_ids.clamp_min(0), cap)
        idx = idx.long()
        d = take_rows(self.doc_ids, idx)
        t = take_rows(self.tfs, idx)
        w = take_rows(self.word_ids, idx)
        t = t + 0.0 * w.to(t.dtype)
        d = torch.where(valid, d, -1)
        t = torch.where(valid, t, 0.0)
        return _present(term_ids, d, t, valid)

    def nbytes(self) -> int:
        n = sum(_nbytes(x) for x in
                (self.word_ids, self.doc_ids, self.tfs, self.perm,
                 self.term_starts, self.df))
        return n + self.lookup.nbytes() + self.docs.nbytes()

    def posting_bytes(self) -> int:
        return sum(_nbytes(x) for x in
                   (self.word_ids, self.doc_ids, self.tfs, self.perm))


def build_coo(h: PostingsHost, lookup: str = "btree",
              device="cuda") -> CooIndex:
    """PR build, byte-equal to ``repro.core.layouts.build_coo``.

    The reference synthesizes the heap with ``lexsort`` by (doc, term)
    and the B+tree with ``lexsort`` by (term, doc).  Both key pairs are
    unique, so each order equals the order of one combined int64 key,
    sorted here with torch on ``device`` (at the 1M tier, two 52.7M-row
    host sorts become two device sorts).  The term starts of a
    (term, doc)-sorted posting list are the host's own term offsets."""
    dev = torch.device(device)
    W = h.num_terms
    lengths = torch.from_numpy(np.diff(h.offsets).astype(np.int64)).to(dev)
    term_of = torch.repeat_interleave(torch.arange(W, device=dev), lengths)
    docs = torch.from_numpy(h.doc_ids.astype(np.int32)).to(dev)
    tfs = torch.from_numpy(h.tfs.astype(np.float32)).to(dev)
    heap_order = torch.argsort(docs.long() * max(W, 1) + term_of)
    heap_word = term_of[heap_order]
    heap_doc = docs[heap_order]
    span = int(h.doc_ids.max()) + 1 if h.num_postings else 1
    perm = torch.argsort(heap_word * span + heap_doc.long())
    return CooIndex(
        word_ids=heap_word.to(torch.int32), doc_ids=heap_doc,
        tfs=tfs[heap_order], perm=perm.to(torch.int32),
        term_starts=torch.from_numpy(h.offsets.astype(np.int32)).to(dev),
        df=torch.from_numpy(h.df.astype(np.int32)).to(dev),
        lookup=build_lookup(h.term_hashes, lookup, dev),
        docs=_docs(h).to(dev), max_posting_len=h.max_posting_len)


# ---------------------------------------------------------------------------
# (OR) CsrIndex
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CsrIndex(_LookupTerms):
    """Object-Relational analogue: contiguous per-term posting slabs."""
    offsets: Tensor   # i32[W+1]
    doc_ids: Tensor   # i32[P]
    tfs: Tensor       # f32[P]
    df: Tensor        # i32[W]   (separate word table, as in OR)
    lookup: SortedLookup | HashLookup
    docs: DocTable
    max_posting_len: int

    def gather_postings(self, term_ids: Tensor, cap: int
                        ) -> Tuple[Tensor, Tensor, Tensor]:
        """q_occ for ORIF: one contiguous slab per term."""
        return _gather_csr(self, term_ids, cap)

    def nbytes(self) -> int:
        n = sum(_nbytes(x) for x in
                (self.offsets, self.doc_ids, self.tfs, self.df))
        return n + self.lookup.nbytes() + self.docs.nbytes()

    def posting_bytes(self) -> int:
        return sum(_nbytes(x) for x in (self.offsets, self.doc_ids,
                                        self.tfs))


def build_csr(h: PostingsHost, lookup: str = "btree",
              device="cuda") -> CsrIndex:
    """OR build, byte-equal to ``repro.core.layouts.build_csr``."""
    t = torch.from_numpy
    return CsrIndex(
        offsets=t(h.offsets.astype(np.int32)),
        doc_ids=t(h.doc_ids.astype(np.int32)),
        tfs=t(h.tfs.astype(np.float32)),
        df=t(h.df.astype(np.int32)),
        lookup=build_lookup(h.term_hashes, lookup, "cpu"),
        docs=_docs(h), max_posting_len=h.max_posting_len).to(device)


# ---------------------------------------------------------------------------
# (COR) CompactCsrIndex
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompactCsrIndex(_SortedTerms):
    """Compact OR: the word table folded into the posting relation.

    Terms are stored in hash-sorted order; the sorted hash array doubles
    as the lookup structure and df sits alongside, so q_word and q_occ
    fuse into one phase, the paper's "one fewer query"."""
    sorted_hash: Tensor  # i32[W]    u32 bit-views, unsigned-ascending
    df: Tensor           # i32[W]    (aligned with sorted_hash)
    offsets: Tensor      # i32[W+1]  (aligned with sorted_hash)
    doc_ids: Tensor      # i32[P]
    tfs: Tensor          # f32[P]
    docs: DocTable
    max_posting_len: int

    def gather_postings(self, term_ids: Tensor, cap: int
                        ) -> Tuple[Tensor, Tensor, Tensor]:
        return _gather_csr(self, term_ids, cap)

    def nbytes(self) -> int:
        return sum(_nbytes(x) for x in
                   (self.sorted_hash, self.df, self.offsets, self.doc_ids,
                    self.tfs)) + self.docs.nbytes()

    def posting_bytes(self) -> int:
        return sum(_nbytes(x) for x in (self.offsets, self.doc_ids,
                                        self.tfs))


def _term_sorted(h: PostingsHost):
    """Hash-sorted term order, per-term lengths, the new term offsets,
    and each posting's position within its term and source index."""
    order = np.argsort(h.term_hashes, kind="stable")
    lengths = np.diff(h.offsets)[order]
    new_offsets = np.zeros(h.num_terms + 1, dtype=np.int64)
    np.cumsum(lengths, out=new_offsets[1:])
    within = (np.arange(h.num_postings, dtype=np.int64)
              - np.repeat(new_offsets[:-1], lengths))
    src = np.repeat(h.offsets[order].astype(np.int64), lengths) + within
    return order, lengths, new_offsets, within, src


def build_compact_csr(h: PostingsHost, device="cuda") -> CompactCsrIndex:
    """COR build, byte-equal to ``repro.core.layouts.build_compact_csr``:
    the reference permutes the slabs term by term in a Python loop; here
    every posting's source index is computed at once."""
    order, _, new_offsets, _, src = _term_sorted(h)
    t = torch.from_numpy
    return CompactCsrIndex(
        sorted_hash=t(as_i32_bits(h.term_hashes[order])),
        df=t(h.df[order].astype(np.int32)),
        offsets=t(new_offsets.astype(np.int32)),
        doc_ids=t(h.doc_ids[src].astype(np.int32)),
        tfs=t(h.tfs[src].astype(np.float32)),
        docs=_docs(h), max_posting_len=h.max_posting_len).to(device)


# ---------------------------------------------------------------------------
# (HOR) BlockedIndex
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockedIndex(_SortedTerms):
    """hstore/GIN analogue: fixed-size posting blocks + per-block summaries.

    Each term's postings are rounded up to multiples of BLOCK lanes
    (padding doc_id = -1, tf = 0).  Per block we keep min/max doc id and
    the block -> doc-tile routing cache the fused kernels walk.
    """
    sorted_hash: Tensor    # i32[W]  u32 hash bit-views, unsigned-sorted
    df: Tensor             # i32[W]
    block_offsets: Tensor  # i32[W+1]  term -> block range
    block_docs: Tensor     # i32[NB, BLOCK]  (-1 padding)
    block_tfs: Tensor      # f32[NB, BLOCK]
    block_min: Tensor      # i32[NB]
    block_max: Tensor      # i32[NB]
    docs: DocTable
    max_posting_len: int
    max_blocks_per_term: int
    block: int = BLOCK
    tile_first: Tensor | None = None   # i32[NB]
    tile_count: Tensor | None = None   # i32[NB]
    route_tile: int = ROUTE_TILE
    route_pairs_max: int = 0   # sum(tile_count): dedup upper bound on pairs
    route_span_max: int = 0    # max(tile_count): worst span of one block

    def gather_postings(self, term_ids: Tensor, cap: int
                        ) -> Tuple[Tensor, Tensor, Tensor]:
        """q_occ: term ids [..., T] -> (docs, tfs, valid) [..., T, cap]."""
        bidx, bvalid = self._term_blocks(term_ids, -(-cap // self.block))
        d = torch.where(bvalid[..., None], take_rows(self.block_docs, bidx),
                        -1)
        t = torch.where(bvalid[..., None], take_rows(self.block_tfs, bidx),
                        0.0)
        d = d.flatten(-2)[..., :cap]
        t = t.flatten(-2)[..., :cap]
        return _present(term_ids, d, t, d >= 0)

    def contains(self, term_ids: Tensor, doc_id) -> Tensor:
        """Doc-membership probe with block skipping (the GIN-style
        path): term ids [..., T] and one doc id -> bool [..., T]; only
        blocks whose [min, max] covers the doc count."""
        bidx, bvalid = self._term_blocks(term_ids, self.max_blocks_per_term)
        doc = torch.as_tensor(doc_id, device=bidx.device)
        hit_range = ((take_rows(self.block_min, bidx) <= doc)
                     & (take_rows(self.block_max, bidx) >= doc) & bvalid)
        inblock = (take_rows(self.block_docs, bidx) == doc).any(dim=-1)
        return (hit_range & inblock).any(dim=-1) & (term_ids >= 0)

    def nbytes(self) -> int:
        return sum(_nbytes(x) for x in
                   (self.sorted_hash, self.df, self.block_offsets,
                    self.block_docs, self.block_tfs, self.block_min,
                    self.block_max)) + self.docs.nbytes()

    def posting_bytes(self) -> int:
        return sum(_nbytes(x) for x in
                   (self.block_offsets, self.block_docs, self.block_tfs,
                    self.block_min, self.block_max))


def _block_layout(h: PostingsHost, block: int):
    """Hash-sorted term order, per-term lengths and block counts, block
    offsets, and each posting's (source index, block row, lane)."""
    order, lengths, _, within, src = _term_sorted(h)
    nblocks = np.maximum(-(-lengths // block), (lengths > 0).astype(np.int64))
    block_offsets = np.zeros(h.num_terms + 1, dtype=np.int64)
    np.cumsum(nblocks, out=block_offsets[1:])
    brow = np.repeat(block_offsets[:-1], lengths) + within // block
    lane = within % block
    return order, nblocks, block_offsets, within, src, brow, lane


def _docs(h: PostingsHost) -> DocTable:
    """The host's doc table, copied (an index never aliases its host)."""
    return DocTable(norm=torch.tensor(h.norm, dtype=torch.float32),
                    rank=torch.tensor(h.rank, dtype=torch.float32))


def build_blocked(h: PostingsHost, block: int = BLOCK,
                  route_tile: int = ROUTE_TILE,
                  device="cuda") -> BlockedIndex:
    """HOR build, byte-equal to ``repro.core.layouts.build_blocked``."""
    order, nblocks, block_offsets, _, src, brow, lane = _block_layout(
        h, block)
    NB = int(block_offsets[-1])
    bd = np.full((NB, block), -1, dtype=np.int32)
    bt = np.zeros((NB, block), dtype=np.float32)
    bd[brow, lane] = h.doc_ids[src]
    bt[brow, lane] = h.tfs[src]
    bmin = np.where((bd >= 0).any(axis=1),
                    np.where(bd >= 0, bd, np.iinfo(np.int32).max).min(axis=1),
                    0).astype(np.int32)
    bmax = bd.max(axis=1).astype(np.int32) if NB else np.zeros(0, np.int32)
    tfirst, tcount = _block_tile_routing(bmin, bmax, h.num_docs, route_tile)
    t = torch.from_numpy
    return BlockedIndex(
        sorted_hash=t(as_i32_bits(h.term_hashes[order])),
        df=t(h.df[order].astype(np.int32)),
        block_offsets=t(block_offsets.astype(np.int32)),
        block_docs=t(bd), block_tfs=t(bt),
        block_min=t(bmin), block_max=t(bmax),
        docs=_docs(h),
        max_posting_len=h.max_posting_len,
        max_blocks_per_term=int(nblocks.max()) if len(nblocks) else 0,
        block=block,
        tile_first=t(tfirst), tile_count=t(tcount),
        route_tile=int(route_tile),
        route_pairs_max=int(tcount.sum()),
        route_span_max=int(tcount.max()) if len(tcount) else 0,
    ).to(device)


def size_class(n: int, base: int = 128, growth: int = 2) -> int:
    """Smallest ``base * growth**i >= max(n, 1)`` — the static size-class
    quantizer sealed segments are padded to."""
    n = max(int(n), 1)
    c = base
    while c < n:
        c *= growth
    return c


def _pad(t: Tensor, n: int, value=0, cols: int = 0) -> Tensor:
    """Append ``n`` rows (and ``cols`` columns of a 2-D tensor) of
    ``value``."""
    pad = (0, n) if t.dim() == 1 else (0, cols, 0, n)
    return torch.nn.functional.pad(t, pad, value=value)


def pad_blocked_to_class(ix: "BlockedIndex", nb_pad: int, w_pad: int,
                         max_posting_len: int, max_blocks_per_term: int,
                         route_pairs_max: int, route_span_max: int
                         ) -> "BlockedIndex":
    """Pad a BlockedIndex to a static size class, as the reference's
    ``pad_blocked_to_class``: inert padding (empty blocks with tile_count
    0, absent-hash vocabulary slots) and quantized upper bounds for the
    static metadata (each only a budget or a loop bound)."""
    w, nb = ix.num_terms, int(ix.block_docs.shape[0])
    if nb_pad < nb or w_pad < w:
        raise ValueError(f"size class ({nb_pad}, {w_pad}) below actual "
                         f"({nb}, {w})")
    if (max_posting_len < ix.max_posting_len
            or max_blocks_per_term < ix.max_blocks_per_term
            or route_pairs_max < ix.route_pairs_max
            or route_span_max < ix.route_span_max):
        raise ValueError("quantized static bounds must cover the actual "
                         "index statics")
    dn, dw = nb_pad - nb, w_pad - w
    last = int(ix.block_offsets[-1])
    return dataclasses.replace(
        ix,
        sorted_hash=_pad(ix.sorted_hash, dw, HASH_EMPTY),
        df=_pad(ix.df, dw),
        block_offsets=_pad(ix.block_offsets, dw, last),
        block_docs=_pad(ix.block_docs, dn, -1),
        block_tfs=_pad(ix.block_tfs, dn),
        block_min=_pad(ix.block_min, dn),
        block_max=_pad(ix.block_max, dn, -1),
        tile_first=_pad(ix.tile_first, dn),
        tile_count=_pad(ix.tile_count, dn),
        max_posting_len=int(max_posting_len),
        max_blocks_per_term=int(max_blocks_per_term),
        route_pairs_max=int(route_pairs_max),
        route_span_max=int(route_span_max),
    )


def pad_packed_to_class(ix: "PackedCsrIndex", nb_pad: int, w_pad: int,
                        max_posting_len: int, words_per_block: int,
                        route_pairs_max: int, route_span_max: int
                        ) -> "PackedCsrIndex":
    """Pad a PackedCsrIndex to a static size class (the packed twin of
    ``pad_blocked_to_class``): padding blocks have bit width 1, count 0
    and tile_count 0; the word dim pads to ``words_per_block``."""
    w, nb = ix.num_terms, int(ix.packed.shape[0])
    wpb = int(ix.packed.shape[1])
    if nb_pad < nb or w_pad < w or words_per_block < wpb:
        raise ValueError(f"size class ({nb_pad}, {w_pad}, {words_per_block})"
                         f" below actual ({nb}, {w}, {wpb})")
    if (max_posting_len < ix.max_posting_len
            or route_pairs_max < ix.route_pairs_max
            or route_span_max < ix.route_span_max):
        raise ValueError("quantized static bounds must cover the actual "
                         "index statics")
    dn, dw = nb_pad - nb, w_pad - w
    last = int(ix.block_offsets[-1])
    return dataclasses.replace(
        ix,
        sorted_hash=_pad(ix.sorted_hash, dw, HASH_EMPTY),
        df=_pad(ix.df, dw),
        block_offsets=_pad(ix.block_offsets, dw, last),
        block_bits=_pad(ix.block_bits, dn, 1),
        block_base=_pad(ix.block_base, dn),
        block_count=_pad(ix.block_count, dn),
        packed=_pad(ix.packed, dn, cols=words_per_block - wpb),
        block_tfs=_pad(ix.block_tfs, dn),
        block_min=_pad(ix.block_min, dn),
        block_max=_pad(ix.block_max, dn, -1),
        tile_first=_pad(ix.tile_first, dn),
        tile_count=_pad(ix.tile_count, dn),
        max_posting_len=int(max_posting_len),
        words_per_block=int(words_per_block),
        route_pairs_max=int(route_pairs_max),
        route_span_max=int(route_span_max),
    )


# ---------------------------------------------------------------------------
# (beyond paper) PackedCsrIndex — delta + bit-packed postings
# ---------------------------------------------------------------------------


def unpack_words(words: Tensor, bits: Tensor, base: Tensor, count: Tensor,
                 block: int = BLOCK) -> Tensor:
    """Decode delta+bit-packed blocks: words i32[N, Wpb] (u32 bit-views),
    bits/base/count i32[N] -> doc ids i32[N, block] (-1 at or past
    ``count``).  The plain twin of the packed kernel's in-shared-memory
    decode: each lane's delta sits at bit ``lane*bits``, spans the next
    word when the bit offset is nonzero, and is masked to ``bits`` (all
    ones at 32); doc id = base + inclusive prefix sum, in int32."""
    n, wpb = words.shape
    dev = words.device
    lane = torch.arange(block, device=dev, dtype=torch.int64)
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    bitpos = lane[None, :] * bits.to(torch.int64)[:, None]
    wi = (bitpos >> 5).clamp_max(wpb - 1)
    off = bitpos & 31
    lo = torch.gather(w64, 1, wi) >> off
    hi_w = torch.gather(w64, 1, (wi + 1).clamp_max(wpb - 1))
    hi = torch.where(off > 0, (hi_w << (32 - off)) & 0xFFFFFFFF, 0)
    raw = lo | hi
    b = bits.to(torch.int64)[:, None]
    mask = torch.where(b >= 32, 0xFFFFFFFF, (1 << b.clamp(0, 31)) - 1)
    deltas = raw & mask
    docs = base.to(torch.int64)[:, None] + torch.cumsum(deltas, dim=1)
    docs = (docs & 0xFFFFFFFF)
    docs = torch.where(docs >= 2**31, docs - 2**32, docs).to(torch.int32)
    valid = lane[None, :] < count.to(torch.int64)[:, None]
    return torch.where(valid, docs, -1)


@dataclasses.dataclass(frozen=True)
class PackedCsrIndex(_SortedTerms):
    """Delta+bit-packed doc ids per 128-posting block, fp16 tf.

    Each block of 128 doc-id deltas is packed at a per-block bit width
    into u32 words (held as int32 bit-views); the first delta of a block
    is taken from ``block_base`` (the previous block's last doc id, or
    -1 at a term start).
    """
    sorted_hash: Tensor    # i32[W]  u32 hash bit-views, unsigned-sorted
    df: Tensor             # i32[W]
    block_offsets: Tensor  # i32[W+1]    term -> block range
    block_bits: Tensor     # i32[NB]     bit width of this block
    block_base: Tensor     # i32[NB]     absolute doc id before first entry
    block_count: Tensor    # i32[NB]     valid postings in this block
    packed: Tensor         # i32[NB, words_per_block]  u32 bit-views
    block_tfs: Tensor      # f16[NB, BLOCK]
    docs: DocTable
    max_posting_len: int
    words_per_block: int
    block: int = BLOCK
    block_min: Tensor | None = None    # i32[NB]
    block_max: Tensor | None = None    # i32[NB]
    tile_first: Tensor | None = None   # i32[NB]
    tile_count: Tensor | None = None   # i32[NB]
    route_tile: int = ROUTE_TILE
    route_pairs_max: int = 0
    route_span_max: int = 0

    @property
    def max_blocks_per_term(self) -> int:
        """Worst-case posting blocks one term spans, from the (possibly
        size-class quantized) posting-length bound."""
        return max(-(-self.max_posting_len // self.block), 1)

    def unpack_block(self, b: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """Decode blocks ``b`` [N] -> (doc_ids, tfs f32, valid) [N, BLOCK]."""
        b = b.long()
        count = take_rows(self.block_count, b)
        docs = unpack_words(take_rows(self.packed, b),
                            take_rows(self.block_bits, b),
                            take_rows(self.block_base, b), count, self.block)
        valid = (torch.arange(self.block, device=b.device)[None, :]
                 < count[:, None])
        tfs = torch.where(valid, take_rows(self.block_tfs, b).float(), 0.0)
        return docs, tfs, valid

    def gather_postings(self, term_ids: Tensor, cap: int
                        ) -> Tuple[Tensor, Tensor, Tensor]:
        """q_occ: term ids [..., T] -> (docs, tfs, valid) [..., T, cap]."""
        bidx, bvalid = self._term_blocks(term_ids, -(-cap // self.block))
        d, t, v = self.unpack_block(bidx.reshape(-1))
        shape = bidx.shape + (self.block,)
        d, t, v = d.view(shape), t.view(shape), v.view(shape)
        bv = bvalid[..., None]
        d = torch.where(bv, d, -1).flatten(-2)[..., :cap]
        t = torch.where(bv, t, 0.0).flatten(-2)[..., :cap]
        v = (bv & v).flatten(-2)[..., :cap]
        return _present(term_ids, d, t, v)

    def nbytes(self) -> int:
        return sum(_nbytes(x) for x in
                   (self.sorted_hash, self.df, self.block_offsets,
                    self.block_bits, self.block_base, self.block_count,
                    self.packed, self.block_tfs)) + self.docs.nbytes()

    def posting_bytes(self) -> int:
        return sum(_nbytes(x) for x in
                   (self.block_offsets, self.block_bits, self.block_base,
                    self.block_count, self.packed, self.block_tfs))


def build_packed_csr(h: PostingsHost, max_bits: int = 32,
                     block: int = BLOCK, route_tile: int = ROUTE_TILE,
                     device="cuda") -> PackedCsrIndex:
    """Packed build, byte-equal to ``repro.core.layouts.build_packed_csr``.

    The reference packs block by block and lane by lane in Python; here
    every posting's (block row, word, shift) is computed at once and the
    words are OR-ed together with one ``np.bitwise_or.at`` per word
    half, so a million-page corpus packs in seconds.
    """
    order, nblocks, block_offsets, within, src, brow, lane = _block_layout(
        h, block)
    NB = int(block_offsets[-1])
    P = h.num_postings
    docs = h.doc_ids[src].astype(np.int64)
    prev = np.empty(P, dtype=np.int64)
    prev[1:] = docs[:-1]
    first = within == 0
    prev[first] = -1                    # term starts restart the delta
    deltas = docs - prev
    lane0 = lane == 0                   # first posting of each block
    last = np.ones(P, dtype=bool)
    last[:-1] = brow[1:] != brow[:-1]   # last posting of each block

    base_arr = np.zeros(NB, dtype=np.int32)
    min_arr = np.zeros(NB, dtype=np.int32)
    max_arr = np.full(NB, -1, dtype=np.int32)
    base_arr[brow[lane0]] = prev[lane0]
    min_arr[brow[lane0]] = docs[lane0]
    max_arr[brow[last]] = docs[last]
    count_arr = np.bincount(brow, minlength=NB).astype(np.int32)
    bits_arr = np.zeros(NB, dtype=np.int32)
    if P:
        bmax = np.maximum.reduceat(deltas, np.flatnonzero(lane0))
        # exact bit_length via the frexp exponent (x = m * 2**e)
        _, exp = np.frexp(np.maximum(bmax, 1).astype(np.float64))
        bits_arr[brow[lane0]] = np.minimum(np.maximum(exp, 1), max_bits)
    nwords = (block * bits_arr.astype(np.int64) + 31) // 32
    words_per_block = int(nwords.max()) if NB else 1

    flat = np.zeros(NB * words_per_block, dtype=np.uint64)
    if P:
        bits = bits_arr[brow].astype(np.int64)
        bitpos = lane * bits
        wi, off = bitpos // 32, bitpos % 32
        row0 = brow * words_per_block
        dv = deltas.astype(np.uint64)
        np.bitwise_or.at(flat, row0 + wi,
                         (dv << off.astype(np.uint64)) & 0xFFFFFFFF)
        spill_ok = (off > 0) & (wi + 1 < nwords[brow])
        spill = dv[spill_ok] >> (32 - off[spill_ok]).astype(np.uint64)
        np.bitwise_or.at(flat, (row0 + wi + 1)[spill_ok], spill)
    packed = flat.astype(np.uint32).reshape(NB, words_per_block)

    tf_arr = np.zeros((NB, block), dtype=np.float16)
    tf_arr[brow, lane] = h.tfs[src]
    tfirst, tcount = _block_tile_routing(min_arr, max_arr, h.num_docs,
                                         route_tile)
    t = torch.from_numpy
    return PackedCsrIndex(
        sorted_hash=t(as_i32_bits(h.term_hashes[order])),
        df=t(h.df[order].astype(np.int32)),
        block_offsets=t(block_offsets.astype(np.int32)),
        block_bits=t(bits_arr), block_base=t(base_arr),
        block_count=t(count_arr), packed=t(as_i32_bits(packed)),
        block_tfs=t(tf_arr),
        docs=_docs(h),
        max_posting_len=h.max_posting_len,
        words_per_block=words_per_block,
        block=block,
        block_min=t(min_arr), block_max=t(max_arr),
        tile_first=t(tfirst), tile_count=t(tcount),
        route_tile=int(route_tile),
        route_pairs_max=int(tcount.sum()),
        route_span_max=int(tcount.max()) if len(tcount) else 0,
    ).to(device)


# ---------------------------------------------------------------------------
# (beyond paper) BandedCsrIndex — per-term-band layout choice
# ---------------------------------------------------------------------------


def term_packed_words(h: PostingsHost, block: int = BLOCK,
                      max_bits: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Per-term packed width: the int32 words the WIDEST block of each
    term would occupy under ``build_packed_csr``, plus the term's block
    count, in ``h``'s term order (i64[W], i64[W]); terms with no
    postings get width 0.  Bit widths come from the ``np.frexp``
    exponent, exact for integers below 2**53."""
    W = h.num_terms
    lengths = np.diff(h.offsets).astype(np.int64)
    has = lengths > 0
    nblocks = np.maximum(-(-lengths // block), has.astype(np.int64))
    words = np.zeros(W, dtype=np.int64)
    P = h.num_postings
    if P == 0 or W == 0:
        return words, nblocks
    docs = h.doc_ids.astype(np.int64)
    prev = np.empty(P, dtype=np.int64)
    prev[1:] = docs[:-1]
    prev[h.offsets[:-1][has]] = -1          # term starts restart the delta
    deltas = docs - prev
    block_offsets = np.zeros(W + 1, dtype=np.int64)
    np.cumsum(nblocks, out=block_offsets[1:])
    NB = int(block_offsets[-1])
    bstart = (np.repeat(h.offsets[:-1][has], nblocks[has]).astype(np.int64)
              + (np.arange(NB, dtype=np.int64)
                 - np.repeat(block_offsets[:-1][has], nblocks[has])) * block)
    bmax = np.maximum.reduceat(deltas, bstart)
    _, exp = np.frexp(np.maximum(bmax, 1).astype(np.float64))
    bits = np.clip(exp.astype(np.int64), 1, max_bits)
    w_blk = (block * bits + 31) // 32
    term_of_block = np.repeat(np.arange(W, dtype=np.int64), nblocks)
    np.maximum.at(words, term_of_block, w_blk)
    return words, nblocks


@dataclasses.dataclass(frozen=True)
class BandedCsrIndex:
    """Per-term-band sealed segment: packed band + HOR tail.

    Terms whose widest packed block fits in ``<= cut`` int32 words live
    in a ``PackedCsrIndex`` with a band-local ``words_per_block``; the
    rest stay in a ``BlockedIndex``.  Both bands are full-vocabulary
    sub-indexes over the same doc space (a term's postings live in one
    band, the other holds an empty block range for it), and share one
    ``DocTable`` and one ``sorted_hash`` tensor: one term lookup serves
    both, and a query's score is the sum of the two band partials."""
    packed: PackedCsrIndex
    hor: BlockedIndex

    @property
    def docs(self) -> DocTable:
        return self.packed.docs

    @property
    def sorted_hash(self) -> Tensor:
        return self.packed.sorted_hash

    @property
    def df(self) -> Tensor:
        return self.packed.df + self.hor.df

    @property
    def num_terms(self) -> int:
        return self.packed.num_terms

    @property
    def block(self) -> int:
        return self.packed.block

    @property
    def route_tile(self) -> int:
        return self.packed.route_tile

    @property
    def max_posting_len(self) -> int:
        return max(self.packed.max_posting_len, self.hor.max_posting_len)

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def lookup_terms(self, hashes: Tensor) -> Tensor:
        return self.packed.lookup_terms(hashes)

    def term_df(self, term_ids: Tensor) -> Tensor:
        return self.packed.term_df(term_ids) + self.hor.term_df(term_ids)

    def gather_postings(self, term_ids: Tensor, cap: int
                        ) -> Tuple[Tensor, Tensor, Tensor]:
        # a term's postings live in one band; the other band yields
        # inert fill (-1 / 0.0 / False), so the merge is lane-wise
        dp, tp, vp = self.packed.gather_postings(term_ids, cap)
        dh, th, vh = self.hor.gather_postings(term_ids, cap)
        return torch.maximum(dp, dh), tp + th, vp | vh

    def nbytes(self) -> int:
        # the DocTable is shared between the bands — count it once
        return (self.packed.nbytes() + self.hor.nbytes()
                - self.docs.nbytes())

    def posting_bytes(self) -> int:
        return int(self.packed.posting_bytes() + self.hor.posting_bytes())


def _band_host(h: PostingsHost, keep: np.ndarray) -> PostingsHost:
    """Full-vocabulary sub-host: terms outside ``keep`` stay in the
    vocabulary with df 0 and an empty posting slab, so both bands'
    hash-sorted term ids stay aligned."""
    lengths = np.diff(h.offsets).astype(np.int64)
    kept = np.where(keep, lengths, 0)
    offsets = np.zeros(h.num_terms + 1, dtype=np.int64)
    np.cumsum(kept, out=offsets[1:])
    mask = np.repeat(keep, lengths)
    return PostingsHost(
        term_hashes=h.term_hashes,
        df=np.where(keep, h.df, 0).astype(h.df.dtype),
        offsets=offsets, doc_ids=h.doc_ids[mask], tfs=h.tfs[mask],
        num_docs=h.num_docs, norm=h.norm, rank=h.rank)


def build_banded(h: PostingsHost, max_band_words: int | None = None,
                 block: int = BLOCK, route_tile: int = ROUTE_TILE,
                 lane_quantum: int = 1, device="cuda") -> BandedCsrIndex:
    """Banded build, array-equal to ``repro.core.layouts.build_banded``.
    ``max_band_words`` (the band cut, in int32 words) defaults to the
    byte-model optimum (``size_model.choose_band_cut``, priced at the
    packed lane quantum ``lane_quantum``)."""
    words, nblocks = term_packed_words(h, block=block)
    if max_band_words is None:
        from repro_torch.core import size_model
        cut, _ = size_model.choose_band_cut(words, nblocks, block=block,
                                            lane_quantum=lane_quantum)
    else:
        cut = int(max_band_words)
    in_packed = (words > 0) & (words <= cut)
    packed = build_packed_csr(_band_host(h, in_packed), block=block,
                              route_tile=route_tile, device=device)
    hor = build_blocked(_band_host(h, ~in_packed), block=block,
                        route_tile=route_tile, device=device)
    # share the DocTable and the (identical-content) sorted_hash tensor
    hor = dataclasses.replace(hor, docs=packed.docs,
                              sorted_hash=packed.sorted_hash)
    return BandedCsrIndex(packed=packed, hor=hor)


# the paper's representations by name; each builder takes ``device``
# ("cuda" unless the caller asks for the CPU)
REPRESENTATIONS = {
    "pr": build_coo,            # Plain-Relational
    "or": build_csr,            # Object-Relational
    "cor": build_compact_csr,   # Compact Object-Relational
    "hor": build_blocked,       # HStore Object-Relational
    "packed": build_packed_csr,  # beyond the paper
    "banded": build_banded,      # beyond the paper: per-term-band choice
}

LAYOUTS = {"coo": CooIndex, "csr": CsrIndex, "compact_csr": CompactCsrIndex,
           "hor": BlockedIndex, "packed": PackedCsrIndex}
LOOKUPS = {"sorted": SortedLookup, "hash": HashLookup}


def _tensors(arrays: dict, skip=()) -> dict:
    """numpy arrays -> tensors, u32 stored as int32 bit-views."""
    out = {}
    for name, a in arrays.items():
        if name in skip:
            continue
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = as_i32_bits(a)
        out[name] = torch.from_numpy(np.array(a))
    return out


def index_from_numpy(kind: str, arrays: dict, statics: dict,
                     device="cuda"):
    """Build the port's index from a reference index given as numpy.

    ``kind`` is "coo", "csr", "compact_csr", "hor", "packed", "banded"
    or "direct"; ``arrays`` maps each tensor field name (plus ``norm``
    and ``rank`` for the DocTable) to a numpy array, u32 arrays included
    (they are stored as int32 bit-views); ``statics`` maps the static
    fields (``max_posting_len``, ``block``, ``route_tile``, ...).  For
    "coo" and "csr", ``arrays["lookup"]`` is ``{"sorted": {"sorted_hash",
    "perm"}}`` or ``{"hash": {"keys", "vals"}}``.  For "banded",
    ``arrays`` and ``statics`` map "packed" and "hor" to each band's
    dicts; the bands then share the packed band's DocTable and
    ``sorted_hash``, as in the reference.  "direct" builds a
    ``direct_index.DirectIndex`` (no DocTable).
    Lets the tests score the very index the reference built.
    """
    if kind == "banded":
        p = index_from_numpy("packed", arrays["packed"], statics["packed"],
                             device)
        h = index_from_numpy("hor", arrays["hor"], statics["hor"], device)
        return BandedCsrIndex(packed=p, hor=dataclasses.replace(
            h, docs=p.docs, sorted_hash=p.sorted_hash))
    if kind == "direct":
        from repro_torch.core.direct_index import DirectIndex
        return DirectIndex(**_tensors(arrays), **statics).to(device)
    cls = LAYOUTS[kind]
    fields = _tensors(arrays, skip=("norm", "rank", "lookup"))
    if "lookup" in arrays:
        (lk_kind, lk_arrays), = arrays["lookup"].items()
        fields["lookup"] = LOOKUPS[lk_kind](**_tensors(lk_arrays))
    docs = DocTable(norm=torch.from_numpy(np.asarray(arrays["norm"],
                                                     np.float32).copy()),
                    rank=torch.from_numpy(np.asarray(arrays["rank"],
                                                     np.float32).copy()))
    return cls(docs=docs, **fields, **statics).to(device)
