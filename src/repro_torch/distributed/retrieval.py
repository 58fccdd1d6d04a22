"""Distributed index engine, document- vs term-partitioned sharding: the
port of ``repro.distributed.retrieval``.

The paper's index is one node's database; at cluster scale an index
shards one of two ways, and the choice decides the collective pattern:

  * DOCUMENT-partitioned (``DocShardedIndex`` and its fused twins): each
    shard holds the full vocabulary over a contiguous slice of
    documents.  A query goes to every shard, each scores its slice, and
    the global answer is a top-k merge of the shards' candidates (an
    all-gather of k or k_tile-per-tile candidates per shard).
  * TERM-partitioned (``TermShardedIndex`` and its fused twins): each
    shard owns a contiguous hash range of the vocabulary (whole posting
    lists).  Per-document partial scores are summed across shards, a
    full [D] psum per query, and then ranked.

The serving tier doc-shards the live index's sealed segments
(``stack_segment_shards``, ``make_doc_sharded_segment_scorer``): each
shard owns whole segments, grouped by ``(size_class, layout)`` and
stacked ``[S, G, ...]``.

One controller drives the S shards (``distributed.shmap``): the shard
program runs once per shard, in shard order, on that shard's tensors on
its ``mesh.devices[s]``, and the collectives are joins on
``mesh.devices[0]`` in shard order (``all_gather`` a concatenation,
``psum`` a sequential sum).  On one card all S shards share it and run
in turn.  The fused engines reach the four fused kernels through
``kernels.ops``' names (``ops.fused_topk_blocked`` and the like): a
CUDA mesh launches the hand-written kernels, a CPU mesh runs their
plain versions.

The host builders are numpy, array for array the reference's; the
stack of sealed segments is assembled from the segments' tensors on
their device.  Every engine is bit-equal to its reference counterpart:
the oracle engines to the reference's ``jnp`` engines, the fused ones
to its Pallas engines.  One query per call: ``fn(query_hashes u32[T])
-> (scores f32[k], global doc ids i32[k])``, tensors on
``mesh.devices[0]``.  The reference's jit caches have no counterpart:
eager PyTorch compiles nothing per shape.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# module objects only: ``core.query`` imports ``distributed.topk``, so this
# module may load while ``core.query`` and ``kernels.ops`` are still
# initialising; their functions are looked up at call time
from repro_torch.core import build, layouts, query, segments, size_model
from repro_torch.core.layouts import PostingsHost
from repro_torch.distributed import shmap, topk
from repro_torch.kernels import autotune, ops

Tensor = torch.Tensor
NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _np(t: Tensor) -> np.ndarray:
    """A (CPU-built) layout tensor as numpy; u32 bit-views stay int32."""
    return t.detach().cpu().numpy()


def _u32(t: Tensor) -> np.ndarray:
    """An int32 bit-view tensor as the u32 numpy array it stands for."""
    return _np(t).view(np.uint32)


def _tensor(a: np.ndarray, device) -> Tensor:
    """A host array on ``device``: u32 as int32 bit-views (the port's
    storage of hashes and packed words), other dtypes as they are."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if not a.flags.c_contiguous:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _shard_arrays(index, mesh: shmap.Mesh, replicated=()) -> list:
    """Each shard's slice ``[s]`` of the index's stacked host arrays as
    tensors on ``mesh.devices[s]``; ``replicated`` arrays are whole, one
    copy per device."""
    copies: dict = {}
    out = []
    for s, dev in enumerate(mesh.devices):
        arrs = {}
        for f in dataclasses.fields(index):
            v = getattr(index, f.name)
            if not isinstance(v, np.ndarray):
                continue
            if f.name in replicated:
                if (f.name, dev) not in copies:
                    copies[(f.name, dev)] = _tensor(v, dev)
                arrs[f.name] = copies[(f.name, dev)]
            else:
                arrs[f.name] = _tensor(v[s], dev)
        out.append(arrs)
    return out


def _lookup(sorted_hash: Tensor, qh: Tensor):
    """Dedup'd query hashes [T] against a hash-sorted vocabulary:
    (term ids i32, -1 absent; hit; clamped positions)."""
    pos, hit = layouts._sorted_positions(sorted_hash, qh)
    hit = hit & (qh != 0)
    return torch.where(hit, pos, -1).to(torch.int32), hit, pos


def square_sum(w: Tensor) -> Tensor:
    """sum_t w_t**2 of ONE query's weights f32[T], as XLA sums a single
    row inside the reference's shard programs: a chain of fused
    multiply-adds in slot order at every width (the batch rule of
    ``query.query_norm_plain``, squares rounded alone at 5-8 slots,
    belongs to XLA's vectorised row loop, which one row never takes).
    Rows ``[..., T]`` are summed each alone, as the lanes of one chain."""
    acc = torch.zeros(w.shape[:-1], dtype=torch.float32, device=w.device)
    for t in range(w.shape[-1]):
        acc = query.fma_f32(w[..., t], w[..., t], acc)
    return acc


def norm_of(sq: Tensor) -> Tensor:
    """sqrt(max(sq, 1e-12)), rounded correctly (through f64)."""
    return torch.sqrt(sq.clamp_min(1e-12).double()).float()


def row_norm(w: Tensor) -> Tensor:
    """``norm_of(square_sum(w))`` in one ``query.query_norm`` launch on
    the card: at 5-8 slots the row is padded with zero weights to 9,
    where ``query_norm`` chains FMAs, and each added 0 * 0 leaves the
    chain's sum as it was."""
    t = w.shape[-1]
    if 5 <= t <= 8:
        w = torch.nn.functional.pad(w, (0, 9 - t))
    return query.query_norm(w[None])[0]


def _query_row(query_hashes) -> Tensor:
    """One query's hashes (u32 numpy or an int32 bit-view tensor) as an
    int32 bit-view tensor [T]."""
    qh = layouts.hash_tensor(query_hashes)
    if qh.dim() != 1:
        raise ValueError(f"one query per call: hashes [T], got shape "
                         f"{tuple(qh.shape)}")
    return qh


def _tail(scores: Tensor, norm: Tensor, qnorm: Tensor) -> Tensor:
    """Cosine scoring tail, no rank blend: -inf where the doc is deleted
    (norm 0) or scored nothing."""
    return torch.where((norm > 0) & (scores > 0),
                       scores / (norm.clamp_min(1e-12) * qnorm), NEG_INF)


def _k_tile(cfg, tile: int, k: int) -> int:
    """The tuned k_tile when the table's tile is the structure's (whose
    routing pins the tile), else the tuned k_pad quantum at that tile."""
    if cfg.tile == tile:
        return cfg.resolve_k_tile(k)
    return min(ops.default_k_tile(k, tile, cfg.k_pad), tile)


def _pad_lanes(pqw: Tensor, q_pad: int) -> Tensor:
    """One query's weight column padded to the kernel's query quantum."""
    return torch.nn.functional.pad(pqw, (0, q_pad - 1))


def _qn(qnorm: Tensor, q_pad: int) -> Tensor:
    """The candidate kernels' per-lane norms: the query's, then 1.0."""
    return torch.cat([qnorm.reshape(1),
                      torch.ones(q_pad - 1, device=qnorm.device)])


def _decode(sq: dict, pb: Tensor, slot: int | None = None) -> tuple:
    """Per-pair (bits, base, count) of the routed packed blocks (of
    stack slot ``slot`` when given)."""
    pbl = pb.long()
    return tuple(layouts.take_rows(sq[n] if slot is None else sq[n][slot],
                                   pbl)
                 for n in ("block_bits", "block_base", "block_count"))


def _pair_budget(route_pairs_max: int, t: int, m_blocks: int,
                 route_span_max: int) -> int:
    """The reference's exact pair budget of one shard (or slot): the
    whole structure's span sum, or candidates x the worst span."""
    return max(min(route_pairs_max, t * m_blocks * max(route_span_max, 1)),
               8)


def _warn_overflow(mesh: shmap.Mesh, overflows: list, label: str) -> int:
    """Sum the shards' routing overflows (one sync) and surface them."""
    if not overflows:
        return 0
    root = mesh.devices[0]
    total = int(torch.stack([o.to(root) for o in overflows]).sum())
    ops.warn_on_overflow(total, label)
    return total


def _sync(mesh: shmap.Mesh) -> None:
    for dev in dict.fromkeys(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _traced(mesh: shmap.Mesh, run, trace, **attrs):
    """``run()`` under the reference's ``shard_fanout`` (the shards'
    work, queued) and ``shard_sync`` (waiting for it) spans."""
    if trace is None:
        return run()
    span = trace.span("shard_fanout", parent="score", **attrs)
    out = run()
    span.end()
    sync = trace.span("shard_sync", parent="score")
    _sync(mesh)
    sync.end()
    return out


# ---------------------------------------------------------------------------
# document-partitioned
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DocShardedIndex:
    """Stacked per-shard CSR arrays (leading dim = shard)."""
    sorted_hash: np.ndarray   # u32[S, W]      (vocab replicated per shard)
    df_local: np.ndarray      # i32[S, W]      per-shard document frequency
    df_global: np.ndarray     # i32[S, W]      global df (same every shard)
    offsets: np.ndarray       # i32[S, W+1]
    doc_ids: np.ndarray       # i32[S, Pmax]   LOCAL doc ids
    tfs: np.ndarray           # f32[S, Pmax]
    norm: np.ndarray          # f32[S, Dmax]
    doc_base: np.ndarray      # i32[S]         global id of local doc 0
    n_shards: int
    num_docs: int
    cap: int                  # max local posting length

    def device_arrays(self, mesh: shmap.Mesh) -> list:
        return _shard_arrays(self, mesh)


def build_doc_sharded(host: PostingsHost, n_shards: int) -> DocShardedIndex:
    order = np.argsort(host.term_hashes, kind="stable")
    sorted_hash = host.term_hashes[order]
    W = host.num_terms
    bounds = np.linspace(0, host.num_docs, n_shards + 1).astype(np.int64)
    term_of = np.repeat(np.arange(W, dtype=np.int64),
                        np.diff(host.offsets))

    sh_offsets, sh_docs, sh_tfs, sh_df = [], [], [], []
    dmax = int(np.max(np.diff(bounds)))
    cap = 0
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        m = (host.doc_ids >= lo) & (host.doc_ids < hi)
        sel = np.argsort(term_of[m], kind="stable")
        t = term_of[m][sel]
        docs = (host.doc_ids[m][sel] - lo).astype(np.int32)
        tfs = host.tfs[m][sel]
        df = np.bincount(t, minlength=W).astype(np.int32)
        # reorder terms into hash-sorted order (COR-style fused lookup)
        df_sorted = df[order]
        offs = np.zeros(W + 1, dtype=np.int64)
        np.cumsum(df_sorted, out=offs[1:])
        # postings re-packed in hash-sorted term order: term order[j]'s
        # slab moves to position j, so one gather by posting index does it
        src_offs = np.zeros(W + 1, dtype=np.int64)
        np.cumsum(df, out=src_offs[1:])
        lens = df_sorted.astype(np.int64)
        src = (np.repeat(src_offs[order], lens)
               + np.arange(len(docs), dtype=np.int64)
               - np.repeat(offs[:-1], lens))
        sh_offsets.append(offs)
        sh_docs.append(docs[src])
        sh_tfs.append(tfs[src].astype(np.float32))
        sh_df.append(df_sorted)
        cap = max(cap, int(df_sorted.max()) if W else 0)

    pmax = max(len(x) for x in sh_docs)
    S = n_shards
    docs_a = np.zeros((S, pmax), np.int32)
    tfs_a = np.zeros((S, pmax), np.float32)
    offs_a = np.zeros((S, W + 1), np.int32)
    df_a = np.zeros((S, W), np.int32)
    norm_a = np.zeros((S, dmax), np.float32)
    for s in range(S):
        docs_a[s, :len(sh_docs[s])] = sh_docs[s]
        tfs_a[s, :len(sh_tfs[s])] = sh_tfs[s]
        offs_a[s] = sh_offsets[s]
        df_a[s] = sh_df[s]
        lo, hi = bounds[s], bounds[s + 1]
        norm_a[s, :hi - lo] = host.norm[lo:hi]
    df_glob = np.broadcast_to(host.df[order][None, :], (S, W)).copy()
    return DocShardedIndex(
        sorted_hash=np.broadcast_to(sorted_hash[None, :], (S, W)).copy(),
        df_local=df_a, df_global=df_glob.astype(np.int32),
        offsets=offs_a, doc_ids=docs_a, tfs=tfs_a, norm=norm_a,
        doc_base=bounds[:-1].astype(np.int32), n_shards=S,
        num_docs=host.num_docs, cap=cap)


def make_doc_sharded_scorer(index: DocShardedIndex, mesh: shmap.Mesh,
                            axis: str, k: int = 10):
    """fn(query_hashes u32[T]) -> (scores[k], global doc ids[k]): the
    gather oracle on every shard (a gather, then a slot-major
    scatter-add, as ``engine="torch"`` adds), a local top-k, and the
    all-gather merge."""
    shmap.check_axis(mesh, axis, index.n_shards)
    arrs = index.device_arrays(mesh)
    cap = max(index.cap, 1)
    dmax = index.norm.shape[1]
    num_docs = index.num_docs

    def shard(s, sq, qh):
        qh = query.dedup_query_hashes(qh)
        tid, hit, pos = _lookup(sq["sorted_hash"], qh)
        # idf uses GLOBAL df: scoring must match the single-node engine
        w = query.idf(torch.where(hit, sq["df_global"][pos], 0), num_docs)
        safe = tid.clamp_min(0)
        d, v = segments.gather_segments(sq["doc_ids"], sq["offsets"], safe,
                                        cap, fill=-1)
        t, _ = segments.gather_segments(sq["tfs"], sq["offsets"], safe, cap,
                                        fill=0.0)
        valid = v & (tid >= 0)[:, None]
        scores = query.accumulate_scores(d, t * w[:, None], valid, dmax)
        final = _tail(scores, sq["norm"], row_norm(w))
        return topk.local_topk(final, k, sq["doc_base"])

    def scorer(query_hashes):
        parts = shmap.run(mesh, shard, arrs, _query_row(query_hashes))
        return topk.local_candidate_merge([v for v, _ in parts],
                                          [i for _, i in parts], k, mesh)

    return scorer


# ---------------------------------------------------------------------------
# term-partitioned
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TermShardedIndex:
    sorted_hash: np.ndarray  # u32[S, Wmax]  (hash-range partition, padded)
    df: np.ndarray           # i32[S, Wmax]
    offsets: np.ndarray      # i32[S, Wmax+1]
    doc_ids: np.ndarray      # i32[S, Pmax]  GLOBAL doc ids
    tfs: np.ndarray          # f32[S, Pmax]
    norm: np.ndarray         # f32[D] (replicated)
    n_shards: int
    num_docs: int
    cap: int

    def device_arrays(self, mesh: shmap.Mesh) -> list:
        return _shard_arrays(self, mesh, replicated=("norm",))


def _term_slab(host: PostingsHost, terms: np.ndarray, offs: np.ndarray):
    """The posting lists of ``terms`` in that order: (doc ids, tfs)."""
    lens = (host.offsets[terms + 1] - host.offsets[terms]).astype(np.int64)
    total = int(lens.sum())
    src = (np.repeat(host.offsets[terms].astype(np.int64), lens)
           + np.arange(total, dtype=np.int64)
           - np.repeat(offs[:len(terms)], lens))
    return (host.doc_ids[src].astype(np.int32),
            host.tfs[src].astype(np.float32))


def build_term_sharded(host: PostingsHost, n_shards: int) -> TermShardedIndex:
    order = np.argsort(host.term_hashes, kind="stable")
    W = host.num_terms
    # contiguous hash-range partition of the sorted vocabulary
    bounds = np.linspace(0, W, n_shards + 1).astype(np.int64)
    wmax = int(np.max(np.diff(bounds)))
    sh = []
    pmax = 0
    for s in range(n_shards):
        terms = order[bounds[s]:bounds[s + 1]]
        lens = (host.offsets[terms + 1] - host.offsets[terms]).astype(np.int64)
        offs = np.zeros(wmax + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:len(lens) + 1])
        offs[len(lens) + 1:] = offs[len(lens)]
        total = int(offs[len(lens)])
        docs, tfs = _term_slab(host, terms, offs)
        hashes = np.full(wmax, 0xFFFFFFFF, np.uint32)
        hashes[:len(terms)] = host.term_hashes[terms]
        dfs = np.zeros(wmax, np.int32)
        dfs[:len(terms)] = host.df[terms]
        sh.append((hashes, dfs, offs, docs, tfs))
        pmax = max(pmax, total)
    S = n_shards
    out = TermShardedIndex(
        sorted_hash=np.stack([x[0] for x in sh]),
        df=np.stack([x[1] for x in sh]),
        offsets=np.stack([x[2] for x in sh]).astype(np.int32),
        doc_ids=np.zeros((S, pmax), np.int32),
        tfs=np.zeros((S, pmax), np.float32),
        norm=host.norm, n_shards=S, num_docs=host.num_docs,
        cap=int(host.max_posting_len))
    for s, (_, _, _, docs, tfs) in enumerate(sh):
        out.doc_ids[s, :len(docs)] = docs
        out.tfs[s, :len(tfs)] = tfs
    return out


def _psum_norm(mesh: shmap.Mesh, weights: list) -> Tensor:
    """The term-sharded query norm sqrt(max(psum(sum w_s**2), 1e-12)) on
    ``mesh.devices[0]``: each shard's weights summed as one row
    (``square_sum``; the S rows of T weights are gathered there and
    chained as S lanes at once), the shards' sums added in shard
    order."""
    root = mesh.devices[0]
    sums = square_sum(torch.stack([w.to(root) for w in weights]))
    return norm_of(shmap.psum(mesh, list(sums.unbind())))


def make_term_sharded_scorer(index: TermShardedIndex, mesh: shmap.Mesh,
                             axis: str, k: int = 10):
    """fn(query_hashes u32[T]) -> (scores[k], doc ids[k]): each shard
    gathers the query terms it owns and scatter-adds them over the whole
    doc space; the partials are summed across shards (a full [D] psum)
    and ranked whole, ids as ``jax.lax.top_k`` gives them (no -1)."""
    shmap.check_axis(mesh, axis, index.n_shards)
    arrs = index.device_arrays(mesh)
    cap = max(index.cap, 1)
    num_docs = index.num_docs

    def shard(s, sq, qh):
        qh = query.dedup_query_hashes(qh)
        tid, hit, pos = _lookup(sq["sorted_hash"], qh)  # others' terms miss
        w = query.idf(torch.where(hit, sq["df"][pos], 0), num_docs)
        safe = tid.clamp_min(0)
        d, v = segments.gather_segments(sq["doc_ids"], sq["offsets"], safe,
                                        cap, fill=-1)
        t, _ = segments.gather_segments(sq["tfs"], sq["offsets"], safe, cap,
                                        fill=0.0)
        valid = v & (tid >= 0)[:, None]
        return query.accumulate_scores(d, t * w[:, None], valid,
                                       num_docs), w

    def scorer(query_hashes):
        parts = shmap.run(mesh, shard, arrs, _query_row(query_hashes))
        # THE term-partitioned cost: a full [D] psum across shards
        scores = shmap.psum(mesh, [p for p, _ in parts])
        final = _tail(scores, arrs[0]["norm"],
                      _psum_norm(mesh, [w for _, w in parts]))
        vv, ii = torch.sort(final, descending=True, stable=True)
        return vv[:k], ii[:k].to(torch.int32)

    return scorer


# ---------------------------------------------------------------------------
# document-partitioned, fused engine (HOR or packed blocks per shard)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockedDocShardedIndex:
    """Stacked per-shard HOR arrays for the fused engine: each shard
    re-packs its document slice into 128-lane posting blocks with the
    build-time (block -> doc-tile) routing cache, routed against the
    PADDED local doc space so every shard sees the same tile grid."""
    sorted_hash: np.ndarray    # u32[S, W]
    df_global: np.ndarray      # i32[S, W]
    block_offsets: np.ndarray  # i32[S, W+1]
    block_docs: np.ndarray     # i32[S, NBmax, BLOCK]  LOCAL doc ids
    block_tfs: np.ndarray      # f32[S, NBmax, BLOCK]
    tile_first: np.ndarray     # i32[S, NBmax]
    tile_count: np.ndarray     # i32[S, NBmax]
    norm: np.ndarray           # f32[S, Dmax]
    doc_base: np.ndarray       # i32[S]
    n_shards: int
    num_docs: int              # global
    dmax: int                  # max local docs per shard
    tile: int
    max_blocks_per_term: int
    route_span_max: int
    route_pairs_max: int

    def device_arrays(self, mesh: shmap.Mesh) -> list:
        return _shard_arrays(self, mesh)


def _sorted_by_term_doc(terms: np.ndarray, docs: np.ndarray) -> bool:
    """True when (terms, docs) pairs ascend lexicographically."""
    dt, dd = np.diff(terms), np.diff(docs)
    return bool(np.all((dt > 0) | ((dt == 0) & (dd >= 0))))


def _doc_shard_subhosts(host: PostingsHost, n_shards: int):
    """Slice the corpus into per-doc-range PostingsHost sub-indexes
    (contiguous id ranges, LOCAL doc ids, term-major posting order): the
    one slicing both bulk doc-sharded builders share, so the HOR and
    packed structures see identical per-shard block boundaries."""
    bounds = np.linspace(0, host.num_docs, n_shards + 1).astype(np.int64)
    dmax = int(np.max(np.diff(bounds)))
    W = host.num_terms
    term_of = np.repeat(np.arange(W, dtype=np.int64), np.diff(host.offsets))
    subs = []
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        m = (host.doc_ids >= lo) & (host.doc_ids < hi)
        docs, terms, tfs = host.doc_ids[m], term_of[m], host.tfs[m]
        # (term, doc) order; a canonical host is in it already, and a
        # mask keeps it, so the sort runs only when it would move rows
        if not _sorted_by_term_doc(terms, docs):
            order = np.lexsort((docs, terms))
            docs, terms, tfs = docs[order], terms[order], tfs[order]
        docs = (docs - lo).astype(np.int32)
        tfs = tfs.astype(np.float32)
        df_l = np.bincount(terms, minlength=W).astype(np.int32)
        offs = np.zeros(W + 1, dtype=np.int64)
        np.cumsum(df_l, out=offs[1:])
        subs.append(PostingsHost(term_hashes=host.term_hashes, df=df_l,
                                 offsets=offs, doc_ids=docs, tfs=tfs,
                                 num_docs=int(hi - lo),
                                 norm=host.norm[lo:hi],
                                 rank=host.rank[lo:hi]))
    return subs, bounds, dmax


def _replicated_vocab(host: PostingsHost, S: int):
    """(sorted hashes u32[S, W], global df i32[S, W]): the hash-sorted
    vocabulary every doc shard carries."""
    order = np.argsort(host.term_hashes, kind="stable")
    W = host.num_terms
    return (np.broadcast_to(host.term_hashes[order][None, :], (S, W)).copy(),
            np.broadcast_to(host.df[order].astype(np.int32)[None, :],
                            (S, W)).copy())


def build_doc_sharded_blocked(host: PostingsHost, n_shards: int,
                              tile: int | None = None
                              ) -> BlockedDocShardedIndex:
    tile = tile or layouts.ROUTE_TILE
    subs, bounds, dmax = _doc_shard_subhosts(host, n_shards)
    W = host.num_terms
    shards = [layouts.build_blocked(sub, device="cpu") for sub in subs]

    block = shards[0].block
    nbmax = max(int(ix.block_docs.shape[0]) for ix in shards)
    S = n_shards
    bd = np.full((S, nbmax, block), -1, dtype=np.int32)
    bt = np.zeros((S, nbmax, block), dtype=np.float32)
    tf_arr = np.zeros((S, nbmax), dtype=np.int32)
    tc_arr = np.zeros((S, nbmax), dtype=np.int32)
    offs_a = np.zeros((S, W + 1), dtype=np.int32)
    norm_a = np.zeros((S, dmax), dtype=np.float32)
    for s, ix in enumerate(shards):
        nb = int(ix.block_docs.shape[0])
        bd[s, :nb] = _np(ix.block_docs)
        bt[s, :nb] = _np(ix.block_tfs)
        # routing spans vs the PADDED local doc space (uniform across
        # shards) so every shard's kernel sees the same tile grid
        tf_s, tc_s = layouts._block_tile_routing(
            _np(ix.block_min), _np(ix.block_max), dmax, tile)
        tf_arr[s, :nb] = tf_s
        tc_arr[s, :nb] = tc_s
        offs_a[s] = _np(ix.block_offsets)
        lo, hi = bounds[s], bounds[s + 1]
        norm_a[s, :hi - lo] = host.norm[lo:hi]
    sh, dfg = _replicated_vocab(host, S)
    return BlockedDocShardedIndex(
        sorted_hash=sh, df_global=dfg,
        block_offsets=offs_a, block_docs=bd, block_tfs=bt,
        tile_first=tf_arr, tile_count=tc_arr, norm=norm_a,
        doc_base=bounds[:-1].astype(np.int32), n_shards=S,
        num_docs=host.num_docs, dmax=dmax, tile=tile,
        max_blocks_per_term=max(ix.max_blocks_per_term for ix in shards),
        route_span_max=max(int(np.max(tc_arr[s])) if nbmax else 0
                           for s in range(S)),
        route_pairs_max=max(int(np.sum(tc_arr[s])) for s in range(S)),
    )


@dataclasses.dataclass
class PackedDocShardedIndex:
    """Stacked per-shard delta+bit-packed arrays for the fused engine:
    the compressed twin of ``BlockedDocShardedIndex``.  Cross-shard
    padding blocks carry ``bits=1, count=0`` and decode to nothing."""
    sorted_hash: np.ndarray    # u32[S, W]
    df_global: np.ndarray      # i32[S, W]
    block_offsets: np.ndarray  # i32[S, W+1]
    packed: np.ndarray         # u32[S, NBmax, WPB]  LOCAL-doc deltas
    block_tfs: np.ndarray      # f16[S, NBmax, BLOCK]
    block_bits: np.ndarray     # i32[S, NBmax]  (1 on padding blocks)
    block_base: np.ndarray     # i32[S, NBmax]
    block_count: np.ndarray    # i32[S, NBmax]  (0 on padding blocks)
    tile_first: np.ndarray     # i32[S, NBmax]
    tile_count: np.ndarray     # i32[S, NBmax]
    norm: np.ndarray           # f32[S, Dmax]
    doc_base: np.ndarray       # i32[S]
    n_shards: int
    num_docs: int              # global
    dmax: int                  # max local docs per shard
    tile: int
    block: int
    words_per_block: int
    max_blocks_per_term: int
    route_span_max: int
    route_pairs_max: int

    def device_arrays(self, mesh: shmap.Mesh) -> list:
        return _shard_arrays(self, mesh)


def _packed_stack(shards: list, S: int):
    """The packed blocks of per-shard packed indexes stacked [S, NBmax,
    ...], padding blocks inert (bits 1, count 0)."""
    block = shards[0].block
    nbmax = max(int(ix.packed.shape[0]) for ix in shards)
    wpb = max(ix.words_per_block for ix in shards)
    pk = np.zeros((S, nbmax, wpb), np.uint32)
    bt = np.zeros((S, nbmax, block), np.float16)
    bits_a = np.ones((S, nbmax), np.int32)     # padding blocks decode inert
    base_a = np.zeros((S, nbmax), np.int32)
    cnt_a = np.zeros((S, nbmax), np.int32)
    for s, ix in enumerate(shards):
        nb = int(ix.packed.shape[0])
        pk[s, :nb, :ix.words_per_block] = _u32(ix.packed)
        bt[s, :nb] = _np(ix.block_tfs)
        bits_a[s, :nb] = _np(ix.block_bits)
        base_a[s, :nb] = _np(ix.block_base)
        cnt_a[s, :nb] = _np(ix.block_count)
    return pk, bt, bits_a, base_a, cnt_a, nbmax, wpb


def build_doc_sharded_packed(host: PostingsHost, n_shards: int,
                             tile: int | None = None
                             ) -> PackedDocShardedIndex:
    """Per-doc-shard re-compression over the SAME slicing as
    ``build_doc_sharded_blocked``, so the packed fused engine is
    bit-identical to the HOR one."""
    tile = tile or layouts.ROUTE_TILE
    subs, bounds, dmax = _doc_shard_subhosts(host, n_shards)
    W = host.num_terms
    shards = [layouts.build_packed_csr(sub, device="cpu") for sub in subs]
    S = n_shards
    pk, bt, bits_a, base_a, cnt_a, nbmax, wpb = _packed_stack(shards, S)
    tf_arr = np.zeros((S, nbmax), dtype=np.int32)
    tc_arr = np.zeros((S, nbmax), dtype=np.int32)
    offs_a = np.zeros((S, W + 1), dtype=np.int32)
    norm_a = np.zeros((S, dmax), dtype=np.float32)
    for s, ix in enumerate(shards):
        nb = int(ix.packed.shape[0])
        tf_s, tc_s = layouts._block_tile_routing(
            _np(ix.block_min), _np(ix.block_max), dmax, tile)
        tf_arr[s, :nb] = tf_s
        tc_arr[s, :nb] = tc_s
        offs_a[s] = _np(ix.block_offsets)
        lo, hi = bounds[s], bounds[s + 1]
        norm_a[s, :hi - lo] = host.norm[lo:hi]
    sh, dfg = _replicated_vocab(host, S)
    return PackedDocShardedIndex(
        sorted_hash=sh, df_global=dfg,
        block_offsets=offs_a, packed=pk, block_tfs=bt, block_bits=bits_a,
        block_base=base_a, block_count=cnt_a,
        tile_first=tf_arr, tile_count=tc_arr, norm=norm_a,
        doc_base=bounds[:-1].astype(np.int32), n_shards=S,
        num_docs=host.num_docs, dmax=dmax, tile=tile,
        block=shards[0].block, words_per_block=wpb,
        max_blocks_per_term=max(ix.max_blocks_per_term for ix in shards),
        route_span_max=max(int(np.max(tc_arr[s])) if nbmax else 0
                           for s in range(S)),
        route_pairs_max=max(int(np.sum(tc_arr[s])) for s in range(S)),
    )


def build_doc_sharded_fused(host: PostingsHost, n_shards: int, *,
                            tile: int | None = None,
                            layout: str | None = None, policy=None):
    """Layout-ladder front door for the bulk doc-sharded fused engine:
    ``explicit layout > policy (size_model.LayoutCostModel over the
    host's aggregate stats) > "hor"``.  Returns ``(index, reason)``."""
    stats = size_model.SegmentStats(
        num_docs=int(host.num_docs),
        num_postings=int(host.num_postings),
        num_terms=int(np.count_nonzero(np.asarray(host.df))))
    layout, reason = size_model.resolve_layout(layout, policy, stats, "hor")
    if layout == "packed":
        return build_doc_sharded_packed(host, n_shards, tile=tile), reason
    if layout == "hor":
        return build_doc_sharded_blocked(host, n_shards, tile=tile), reason
    if layout == "banded":
        raise ValueError(
            "banded is not a bulk doc-sharded layout: banded segments "
            "doc-shard through the segment-stack serving tier "
            "(stack_segment_shards / make_doc_sharded_segment_scorer), "
            "which carries both bands per group slot")
    raise ValueError(f"unknown layout: {layout!r}")


def make_doc_sharded_fused_scorer(
        index: BlockedDocShardedIndex | PackedDocShardedIndex,
        mesh: shmap.Mesh, axis: str, k: int = 10):
    """fn(query_hashes u32[T]) -> (scores[k], global doc ids[k]).

    Every shard runs its layout's fused candidate kernel over its local
    posting blocks (``ops.fused_topk_blocked``, HOR blocks read in
    place, or ``ops.fused_topk_packed``, packed blocks decoded in the
    kernel): each doc tile reduced to its top k_tile, shifted to global
    ids by the shard's doc_base, then the all-gather candidate merge.
    The tile is pinned by the sharded routing arrays; the routing-free
    geometry (q_pad, k_pad, k_tile, reducer, pairs per step) follows the
    tuning table for the mesh's device type."""
    shmap.check_axis(mesh, axis, index.n_shards)
    packed_layout = isinstance(index, PackedDocShardedIndex)
    arrs = index.device_arrays(mesh)
    dmax, tile = index.dmax, index.tile
    n_tiles = max(-(-dmax // tile), 1)
    num_docs = index.num_docs
    block = (index.block if packed_layout
             else int(index.block_docs.shape[-1]))
    m_blocks = max(index.max_blocks_per_term, 1)
    cfg = autotune.lookup(mesh.devices[0].type, dmax,
                          "packed" if packed_layout else "hor")
    q_pad, pps = cfg.q_pad, cfg.pairs_per_step
    k_tile = _k_tile(cfg, tile, k)

    def shard(s, sq, qh):
        qh = query.dedup_query_hashes(qh)
        t = qh.shape[0]
        tid, hit, pos = _lookup(sq["sorted_hash"], qh)
        # idf uses GLOBAL df: scoring must match the single-node engine
        w = query.idf(torch.where(hit, sq["df_global"][pos], 0), num_docs)
        cb, cv, cq, cw, _ = ops.expand_block_candidates(
            sq["block_offsets"], tid[None], w[None], m_blocks, block)
        max_pairs = _pair_budget(index.route_pairs_max, t, m_blocks,
                                 index.route_span_max)
        if pps > 1:
            # run-aligned padding inserts up to pps-1 no-op pairs per tile
            max_pairs += n_tiles * (pps - 1)
        max_pairs = ops.round_up_pairs(max_pairs, pps)
        pb, pt, pqw, pcap, ovf = ops.build_batched_pairs(
            cb, cv, cq, cw, sq["tile_first"], sq["tile_count"], n_tiles, 1,
            max_pairs, pairs_per_step=pps)
        pqw = _pad_lanes(pqw, q_pad)
        qn = _qn(row_norm(w), q_pad)
        zeros = torch.zeros_like(sq["norm"])
        if packed_layout:
            vals, ids = ops.fused_topk_packed(
                sq["packed"], sq["block_tfs"], pb, pt, pqw, pcap,
                *_decode(sq, pb), sq["norm"], zeros, qn, dmax, block,
                k_tile, tile=tile, reducer=cfg.reducer)
        else:
            vals, ids = ops.fused_topk_blocked(
                sq["block_docs"], sq["block_tfs"], pb, pt, pqw, pcap,
                sq["norm"], zeros, qn, dmax, k_tile, tile=tile,
                reducer=cfg.reducer)
        gids = torch.where(ids[0] >= 0, ids[0] + sq["doc_base"], -1)
        return vals[0], gids, ovf

    def scorer(query_hashes):
        parts = shmap.run(mesh, shard, arrs, _query_row(query_hashes))
        out = topk.local_candidate_merge([p[0] for p in parts],
                                         [p[1] for p in parts], k, mesh)
        # the budget is exact, so this fires only if it is ever loosened
        _warn_overflow(mesh, [p[2] for p in parts],
                       "doc-sharded fused engine")
        return out

    return scorer


# ---------------------------------------------------------------------------
# document-partitioned segment stacks (the live index's serving tier)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StackGroupMeta:
    """Static signature of one ``(size_class, layout)`` group of sealed
    segments in a sharded stack.  ``n_slots`` (the group's per-shard
    stack depth) is pow2-quantized; empty slots are inert."""
    layout: str              # "hor" | "packed" | "banded"
    w_pad: int               # vocab slots per segment (size class)
    nb_pad: int              # posting-block rows per segment
    d_pad: int               # padded local doc span
    block: int
    words_per_block: int     # packed word lanes (0 for hor)
    n_slots: int             # G: per-shard stack depth (pow2, inert pads)
    max_blocks_per_term: int
    route_span_max: int
    route_pairs_max: int
    # banded only: the HOR band's statics beside the packed band's
    # (which use the fields above); 0 for hor / packed groups
    hor_nb_pad: int = 0
    hor_max_blocks_per_term: int = 0
    hor_route_span_max: int = 0
    hor_route_pairs_max: int = 0


def _segment_group_key(ix) -> StackGroupMeta:
    """The (size_class, layout) bucket a sealed segment stacks into
    (``n_slots`` is a property of the stack, filled in later)."""
    if isinstance(ix, layouts.BandedCsrIndex):
        p, h = ix.packed, ix.hor
        return StackGroupMeta(
            layout="banded", w_pad=int(p.sorted_hash.shape[0]),
            nb_pad=int(p.packed.shape[0]), d_pad=int(p.docs.num_docs),
            block=p.block, words_per_block=p.words_per_block, n_slots=0,
            max_blocks_per_term=p.max_blocks_per_term,
            route_span_max=p.route_span_max,
            route_pairs_max=p.route_pairs_max,
            hor_nb_pad=int(h.block_docs.shape[0]),
            hor_max_blocks_per_term=h.max_blocks_per_term,
            hor_route_span_max=h.route_span_max,
            hor_route_pairs_max=h.route_pairs_max)
    if isinstance(ix, layouts.PackedCsrIndex):
        return StackGroupMeta(
            layout="packed", w_pad=int(ix.sorted_hash.shape[0]),
            nb_pad=int(ix.packed.shape[0]), d_pad=int(ix.docs.num_docs),
            block=ix.block, words_per_block=ix.words_per_block, n_slots=0,
            max_blocks_per_term=ix.max_blocks_per_term,
            route_span_max=ix.route_span_max,
            route_pairs_max=ix.route_pairs_max)
    if isinstance(ix, layouts.BlockedIndex):
        return StackGroupMeta(
            layout="hor", w_pad=int(ix.sorted_hash.shape[0]),
            nb_pad=int(ix.block_docs.shape[0]), d_pad=int(ix.docs.num_docs),
            block=ix.block, words_per_block=0, n_slots=0,
            max_blocks_per_term=ix.max_blocks_per_term,
            route_span_max=ix.route_span_max,
            route_pairs_max=ix.route_pairs_max)
    raise ValueError(f"unknown sealed-segment layout: {type(ix).__name__}")


def _group_array_names(layout: str) -> tuple:
    common = ("sorted_hash", "block_offsets", "tile_first", "tile_count",
              "norm", "doc_base")
    packed = ("packed", "block_tfs", "block_bits", "block_base",
              "block_count")
    if layout == "banded":
        # the un-prefixed block arrays are the packed band's (both bands
        # carry the full hash-sorted vocabulary)
        return common + packed + ("hor_block_offsets", "hor_block_docs",
                                  "hor_block_tfs", "hor_tile_first",
                                  "hor_tile_count")
    if layout == "packed":
        return common + packed
    return common + ("block_docs", "block_tfs")


def _empty_group_arrays(meta: StackGroupMeta, n_shards: int,
                        device) -> dict:
    """Inert [S, G, ...] tensors for one group on ``device``: absent-hash
    vocab slots (0xFFFFFFFF), tile_count 0 (never routed), and for
    packed blocks bit width 1 with count 0, so a padding slot is
    in-distribution for the decoder and contributes nothing."""
    S, G = n_shards, meta.n_slots
    w, nb, b = meta.w_pad, meta.nb_pad, meta.block
    i32 = torch.int32

    def z(*shape, dtype=i32, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=device)
    arrays = {
        "sorted_hash": z(S, G, w, fill=layouts.HASH_EMPTY),
        "block_offsets": z(S, G, w + 1),
        "tile_first": z(S, G, nb),
        "tile_count": z(S, G, nb),
        "norm": z(S, G, meta.d_pad, dtype=torch.float32),
        "doc_base": z(S, G),
    }
    if meta.layout in ("packed", "banded"):
        arrays.update({
            "packed": z(S, G, nb, meta.words_per_block),
            "block_tfs": z(S, G, nb, b, dtype=torch.float16),
            "block_bits": z(S, G, nb, fill=1),
            "block_base": z(S, G, nb),
            "block_count": z(S, G, nb),
        })
    else:
        arrays.update({
            "block_docs": z(S, G, nb, b, fill=-1),
            "block_tfs": z(S, G, nb, b, dtype=torch.float32),
        })
    if meta.layout == "banded":
        hnb = meta.hor_nb_pad
        arrays.update({
            "hor_block_offsets": z(S, G, w + 1),
            "hor_block_docs": z(S, G, hnb, b, fill=-1),
            "hor_block_tfs": z(S, G, hnb, b, dtype=torch.float32),
            "hor_tile_first": z(S, G, hnb),
            "hor_tile_count": z(S, G, hnb),
        })
    return arrays


def _fill_group_slot(arrays: dict, s: int, g: int, seg) -> None:
    ix = seg.index
    if isinstance(ix, layouts.BandedCsrIndex):
        h = ix.hor
        arrays["hor_block_offsets"][s, g] = h.block_offsets
        arrays["hor_block_docs"][s, g] = h.block_docs
        arrays["hor_block_tfs"][s, g] = h.block_tfs
        arrays["hor_tile_first"][s, g] = h.tile_first
        arrays["hor_tile_count"][s, g] = h.tile_count
        ix = ix.packed        # the un-prefixed arrays are the packed band
    arrays["sorted_hash"][s, g] = ix.sorted_hash
    arrays["block_offsets"][s, g] = ix.block_offsets
    arrays["tile_first"][s, g] = ix.tile_first
    arrays["tile_count"][s, g] = ix.tile_count
    arrays["norm"][s, g] = ix.docs.norm
    arrays["doc_base"][s, g] = int(seg.doc_base)
    if isinstance(ix, layouts.PackedCsrIndex):
        for n in ("packed", "block_tfs", "block_bits", "block_base",
                  "block_count"):
            arrays[n][s, g] = getattr(ix, n)
    else:
        arrays["block_docs"][s, g] = ix.block_docs
        arrays["block_tfs"][s, g] = ix.block_tfs


@dataclasses.dataclass
class SegmentStackShards:
    """Per-shard stacks of sealed live-index segments, grouped by
    ``(size_class, layout)`` and stacked ``[S, G, ...]`` per group on
    the segments' device (G = the group's deepest per-shard stack,
    pow2-padded; empty slots inert).  Each shard owns WHOLE segments, so
    a query runs one fused engine call per local segment and the global
    answer is a candidate merge: the single-node live path with shards
    in the role of stacks.  HOR, packed and banded segments mix freely;
    the candidate lists are canonicalized (ascending doc id) before the
    merge, so ties still break on the lowest global id."""
    groups: list               # [(StackGroupMeta, {name: Tensor [S, G, ...]})]
    vocab_hash: np.ndarray     # u32[Wp] unified, hash-sorted (replicated)
    vocab_df: np.ndarray       # i32[Wp] LIVE global df (replicated)
    n_shards: int
    live_docs: int             # D behind idf
    tile: int

    def signature(self) -> tuple:
        """The static structure: one ``StackGroupMeta`` per group."""
        return tuple(meta for meta, _ in self.groups)

    def device_arrays(self, mesh: shmap.Mesh) -> list:
        """Each shard's slots ``[s]`` on its device, beside the
        replicated vocabulary."""
        out = []
        for s, dev in enumerate(mesh.devices):
            out.append({
                "groups": [{n: v[s].to(dev) for n, v in arrays.items()}
                           for _, arrays in self.groups],
                "vocab_hash": _tensor(self.vocab_hash, dev),
                "vocab_df": _tensor(self.vocab_df, dev),
            })
        return out


def stack_segment_shards(live_index, n_shards: int) -> SegmentStackShards:
    """Distribute a SegmentedIndex's sealed stack across ``n_shards``.
    The delta must be sealed first: the serving tier replicates
    immutable runs only.

    Also accepts an epoch-pinned ``LiveView``: the sharded tier then
    snapshots a consistent epoch, and the sharded scorer answers exactly
    as the single-node pinned view does.  Sealed segments may be HOR,
    packed or banded, in any mixture: segments stack into per-
    ``(size_class, layout)`` groups."""
    from repro_torch.core.live_index import LiveView
    if isinstance(live_index, LiveView):
        if live_index.delta_n_docs:
            raise ValueError("pin a view with a sealed delta before "
                             "sharding the stack")
        segs = list(live_index.segments)
        vocab_hashes = live_index.hashes
        vocab_df = np.asarray(live_index.df)
        live_docs = live_index.live_docs
    else:
        if live_index.delta_postings or live_index._delta.n_docs:
            raise ValueError("seal() the delta before sharding the stack")
        segs = live_index.segments()
        vocab_hashes = live_index.term_hashes
        vocab_df = np.asarray(live_index._df)
        live_docs = live_index.live_doc_count
    if not segs:
        raise ValueError("no sealed segments to shard")
    tiles = {s.index.route_tile for s in segs}
    if len(tiles) != 1:
        raise ValueError(f"segments disagree on route_tile: {tiles}")
    # contiguous runs per shard (NOT round-robin): the all-gather
    # candidate merge concatenates shard 0's candidates first, so shards
    # must cover ascending doc-id ranges for exact score ties to break
    # on the lowest global doc id, like the single-node live index
    splits = np.array_split(np.arange(len(segs)), n_shards)
    shards = [[segs[i] for i in idx] for idx in splits]
    device = segs[0].index.device

    # bucket by (size_class, layout); G = pow2-padded deepest stack
    keys = sorted({_segment_group_key(s.index) for s in segs},
                  key=lambda m: dataclasses.astuple(m))
    groups = []
    for key in keys:
        depth = max(sum(1 for s in stack
                        if _segment_group_key(s.index) == key)
                    for stack in shards)
        meta = dataclasses.replace(
            key, n_slots=layouts.size_class(depth, base=1))
        arrays = _empty_group_arrays(meta, n_shards, device)
        for s, stack in enumerate(shards):
            g = 0
            for seg in stack:
                if _segment_group_key(seg.index) == key:
                    _fill_group_slot(arrays, s, g, seg)
                    g += 1
        groups.append((meta, arrays))

    order = np.argsort(vocab_hashes, kind="stable")
    w = len(vocab_hashes)
    w_pad = layouts.size_class(max(w, 1), base=256)
    vh = np.full(w_pad, 0xFFFFFFFF, np.uint32)
    vh[:w] = vocab_hashes[order].astype(np.uint32)
    vdf = np.zeros(w_pad, np.int32)
    vdf[:w] = vocab_df[order].astype(np.int32)
    return SegmentStackShards(
        groups=groups, vocab_hash=vh, vocab_df=vdf, n_shards=n_shards,
        live_docs=live_docs, tile=segs[0].index.route_tile)


def _stack_shard_program(metas: tuple, cfgs: tuple, k: int, tile: int,
                         live_docs: float):
    """The shard program of the segment-stack scorer: one shard's
    candidates (canonicalized) and its slots' routing overflows."""

    def slot_terms(sq, g, qh):
        return _lookup(sq["sorted_hash"][g], qh)[0]

    def banded_slot(meta, cfg, sq, g, qh, w, qnorm, k_tile, n_tiles):
        # per-band dense partials summed BEFORE extraction (scores add
        # over terms, so per-band candidates could not merge): one
        # lookup, two dense launches, the scoring tail, per-tile
        # candidates, as the single-node banded engine
        t = qh.shape[0]
        m_p = max(meta.max_blocks_per_term, 1)
        m_h = max(meta.hor_max_blocks_per_term, 1)
        tid = slot_terms(sq, g, qh)
        cb, cv, cq, cw, _ = ops.expand_block_candidates(
            sq["block_offsets"][g], tid[None], w[None], m_p, meta.block)
        pb, pt, pqw, pcap, ov_p = ops.build_batched_pairs(
            cb, cv, cq, cw, sq["tile_first"][g], sq["tile_count"][g],
            n_tiles, 1, _pair_budget(meta.route_pairs_max, t, m_p,
                                     meta.route_span_max))
        acc = ops.fused_score_packed(
            sq["packed"][g], sq["block_tfs"][g], pb, pt,
            _pad_lanes(pqw, cfg.q_pad), pcap, *_decode(sq, pb, g),
            meta.d_pad, meta.block, tile=tile)[0]
        cb, cv, cq, cw, _ = ops.expand_block_candidates(
            sq["hor_block_offsets"][g], tid[None], w[None], m_h, meta.block)
        pb, pt, pqw, pcap, ov_h = ops.build_batched_pairs(
            cb, cv, cq, cw, sq["hor_tile_first"][g], sq["hor_tile_count"][g],
            n_tiles, 1, _pair_budget(meta.hor_route_pairs_max, t, m_h,
                                     meta.hor_route_span_max))
        acc = acc + ops.fused_score_blocked(
            sq["hor_block_docs"][g], sq["hor_block_tfs"][g], pb, pt,
            _pad_lanes(pqw, cfg.q_pad), pcap, meta.d_pad, tile=tile)[0]
        vals, ids = ops.extract_tile_candidates(
            _tail(acc, sq["norm"][g], qnorm)[None], tile, k_tile)
        return vals[0], ids[0], (ov_p, ov_h)

    def single_slot(meta, cfg, sq, g, qh, w, qn, k_tile, n_tiles):
        t = qh.shape[0]
        pps = cfg.pairs_per_step
        m_blocks = max(meta.max_blocks_per_term, 1)
        max_pairs = _pair_budget(meta.route_pairs_max, t, m_blocks,
                                 meta.route_span_max)
        if pps > 1:
            max_pairs += n_tiles * (pps - 1)
        max_pairs = ops.round_up_pairs(max_pairs, pps)
        tid = slot_terms(sq, g, qh)
        cb, cv, cq, cw, _ = ops.expand_block_candidates(
            sq["block_offsets"][g], tid[None], w[None], m_blocks, meta.block)
        pb, pt, pqw, pcap, ovf = ops.build_batched_pairs(
            cb, cv, cq, cw, sq["tile_first"][g], sq["tile_count"][g],
            n_tiles, 1, max_pairs, pairs_per_step=pps)
        pqw = _pad_lanes(pqw, cfg.q_pad)
        norm = sq["norm"][g]
        zeros = torch.zeros_like(norm)
        if meta.layout == "packed":
            vals, ids = ops.fused_topk_packed(
                sq["packed"][g], sq["block_tfs"][g], pb, pt, pqw, pcap,
                *_decode(sq, pb, g), norm, zeros, qn, meta.d_pad,
                meta.block, k_tile, tile=tile, reducer=cfg.reducer)
        else:
            vals, ids = ops.fused_topk_blocked(
                sq["block_docs"][g], sq["block_tfs"][g], pb, pt, pqw, pcap,
                norm, zeros, qn, meta.d_pad, k_tile, tile=tile,
                reducer=cfg.reducer)
        return vals[0], ids[0], (ovf,)

    def program(s, ix, qh):
        qh = query.dedup_query_hashes(qh)
        # global idf from the replicated LIVE vocabulary stats, the live
        # index's op sequence
        _, vhit, vpos = _lookup(ix["vocab_hash"], qh)
        w = query.idf(torch.where(vhit, ix["vocab_df"][vpos], 0), live_docs)
        qnorm = row_norm(w)
        all_v, all_i, ovfs = [], [], []
        for meta, cfg, sq in zip(metas, cfgs, ix["groups"]):
            n_tiles = max(-(-meta.d_pad // tile), 1)
            k_tile = _k_tile(cfg, tile, k)
            for g in range(meta.n_slots):        # inert slots run too
                if meta.layout == "banded":
                    v, i, o = banded_slot(meta, cfg, sq, g, qh, w, qnorm,
                                          k_tile, n_tiles)
                else:
                    v, i, o = single_slot(meta, cfg, sq, g, qh, w,
                                          _qn(qnorm, cfg.q_pad), k_tile,
                                          n_tiles)
                all_v.append(v)
                all_i.append(torch.where(i >= 0, i + sq["doc_base"][g], -1))
                ovfs.extend(o)
        # group-major concatenation interleaves doc ranges (mixed layouts,
        # several classes): canonicalize so the merge tie-breaks on the
        # lowest global doc id whatever the group order
        cv, ci = topk.canonicalize_candidates(torch.cat(all_v),
                                              torch.cat(all_i))
        return cv, ci, ovfs

    return program


def make_doc_sharded_segment_scorer(index: SegmentStackShards,
                                    mesh: shmap.Mesh, axis: str,
                                    k: int = 10):
    """fn(query_hashes u32[T], trace=None) -> (scores[k], global doc
    ids[k]).

    Every shard walks its local segment stack: per slot one fused
    candidate launch (``ops.fused_topk_blocked`` / ``_packed``), or for
    a banded slot one dense launch per band (``ops.fused_score_packed``
    + ``ops.fused_score_blocked``) and a per-tile extraction, with idf
    from the replicated LIVE global df, so a shard scores exactly as the
    single-node live index does.  Tile candidates shift to global ids by
    each slot's doc_base, and the all-gather candidate merge gives the
    global top-k.  Deleted docs ride in as norm 0.  Inert slots run
    their launches too, as the reference's static program does.

    The tuning table (for the mesh's device type) resolves each group's
    geometry when the scorer is made.  ``trace`` records the reference's
    ``shard_fanout`` and ``shard_sync`` spans."""
    shmap.check_axis(mesh, axis, index.n_shards)
    metas = index.signature()
    cfgs = tuple(autotune.lookup(mesh.devices[0].type, m.d_pad, m.layout)
                 for m in metas)
    arrs = index.device_arrays(mesh)
    program = _stack_shard_program(metas, cfgs, k, index.tile,
                                   float(np.float32(index.live_docs)))
    groups = [{"size_class": m.d_pad, "layout": m.layout} for m in metas]

    def scorer(query_hashes, trace=None):
        def run():
            parts = shmap.run(mesh, program, arrs, _query_row(query_hashes))
            out = topk.local_candidate_merge([p[0] for p in parts],
                                             [p[1] for p in parts], k, mesh)
            return out, [o for p in parts for o in p[2]]
        (vv, ii), ovfs = _traced(mesh, run, trace, n_shards=index.n_shards,
                                 k=k, groups=groups)
        _warn_overflow(mesh, ovfs, "doc-sharded segment stack")
        return vv, ii

    return scorer


# ---------------------------------------------------------------------------
# term-partitioned, fused engine (HOR, packed or banded per vocab shard)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockedTermShardedIndex:
    """Stacked per-vocab-shard HOR arrays for the fused engine: each
    shard owns a contiguous hash range of the vocabulary as whole
    posting lists in 128-lane blocks with GLOBAL doc ids (the doc/tile
    space is the whole corpus on every shard), plus the routing cache."""
    sorted_hash: np.ndarray    # u32[S, Wmax]  (padded with 0xFFFFFFFF)
    df: np.ndarray             # i32[S, Wmax]  global df (terms are whole)
    block_offsets: np.ndarray  # i32[S, Wmax+1]
    block_docs: np.ndarray     # i32[S, NBmax, BLOCK]  GLOBAL doc ids
    block_tfs: np.ndarray      # f32[S, NBmax, BLOCK]
    tile_first: np.ndarray     # i32[S, NBmax]
    tile_count: np.ndarray     # i32[S, NBmax]
    norm: np.ndarray           # f32[D] (replicated)
    n_shards: int
    num_docs: int
    tile: int
    max_blocks_per_term: int
    route_span_max: int
    route_pairs_max: int

    def device_arrays(self, mesh: shmap.Mesh) -> list:
        return _shard_arrays(self, mesh, replicated=("norm",))


def _term_shard_subhosts(host: PostingsHost, n_shards: int):
    """Slice the global posting lists into per-vocab-shard PostingsHost
    sub-indexes (contiguous hash ranges, whole lists, GLOBAL doc ids):
    the one slicing every term-sharded fused builder shares."""
    order = np.argsort(host.term_hashes, kind="stable")
    W = host.num_terms
    bounds = np.linspace(0, W, n_shards + 1).astype(np.int64)
    subs = []
    for s in range(n_shards):
        terms = order[bounds[s]:bounds[s + 1]]
        lens = (host.offsets[terms + 1] - host.offsets[terms]).astype(np.int64)
        offs = np.zeros(len(terms) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        docs, tfs = _term_slab(host, terms, offs)
        subs.append(PostingsHost(term_hashes=host.term_hashes[terms],
                                 df=host.df[terms].astype(np.int32),
                                 offsets=offs, doc_ids=docs, tfs=tfs,
                                 num_docs=host.num_docs,
                                 norm=host.norm, rank=host.rank))
    wmax = int(np.max(np.diff(bounds)))
    return subs, wmax


def _vocab_slots(ix, s: int, wmax: int, sh_a, df_a, offs_a, df,
                 block_offsets) -> None:
    """Shard s's hash range into the padded vocabulary rows."""
    w = int(ix.sorted_hash.shape[0])
    sh_a[s, :w] = _u32(ix.sorted_hash)
    df_a[s, :w] = _np(df)
    offs_a[s, :w + 1] = _np(block_offsets)
    offs_a[s, w + 1:] = offs_a[s, w]


def build_term_sharded_blocked(host: PostingsHost, n_shards: int
                               ) -> BlockedTermShardedIndex:
    subs, wmax = _term_shard_subhosts(host, n_shards)
    shards = [layouts.build_blocked(sub, device="cpu") for sub in subs]
    block = shards[0].block
    nbmax = max(int(ix.block_docs.shape[0]) for ix in shards)
    S = n_shards
    sh_a = np.full((S, wmax), 0xFFFFFFFF, np.uint32)
    df_a = np.zeros((S, wmax), np.int32)
    offs_a = np.zeros((S, wmax + 1), np.int32)
    bd = np.full((S, nbmax, block), -1, np.int32)
    bt = np.zeros((S, nbmax, block), np.float32)
    tf_a = np.zeros((S, nbmax), np.int32)
    tc_a = np.zeros((S, nbmax), np.int32)
    for s, ix in enumerate(shards):
        nb = int(ix.block_docs.shape[0])
        _vocab_slots(ix, s, wmax, sh_a, df_a, offs_a, ix.df,
                     ix.block_offsets)
        bd[s, :nb] = _np(ix.block_docs)
        bt[s, :nb] = _np(ix.block_tfs)
        tf_a[s, :nb] = _np(ix.tile_first)
        tc_a[s, :nb] = _np(ix.tile_count)
    return BlockedTermShardedIndex(
        sorted_hash=sh_a, df=df_a, block_offsets=offs_a,
        block_docs=bd, block_tfs=bt, tile_first=tf_a, tile_count=tc_a,
        norm=host.norm.astype(np.float32), n_shards=S,
        num_docs=host.num_docs, tile=layouts.ROUTE_TILE,
        max_blocks_per_term=max(ix.max_blocks_per_term for ix in shards),
        route_span_max=max(ix.route_span_max for ix in shards),
        route_pairs_max=max(ix.route_pairs_max for ix in shards),
    )


@dataclasses.dataclass
class PackedTermShardedIndex:
    """Stacked per-vocab-shard delta+bit-packed arrays for the fused
    engine: the compressed twin of ``BlockedTermShardedIndex`` (GLOBAL
    doc ids, per-block widths, f16 tfs, decode scalars, routing)."""
    sorted_hash: np.ndarray    # u32[S, Wmax]  (padded with 0xFFFFFFFF)
    df: np.ndarray             # i32[S, Wmax]  global df (terms are whole)
    block_offsets: np.ndarray  # i32[S, Wmax+1]
    packed: np.ndarray         # u32[S, NBmax, WPB]  bit-packed deltas
    block_tfs: np.ndarray      # f16[S, NBmax, BLOCK]
    block_bits: np.ndarray     # i32[S, NBmax]  (1 on padding blocks)
    block_base: np.ndarray     # i32[S, NBmax]
    block_count: np.ndarray    # i32[S, NBmax]  (0 on padding blocks)
    tile_first: np.ndarray     # i32[S, NBmax]
    tile_count: np.ndarray     # i32[S, NBmax]
    norm: np.ndarray           # f32[D] (replicated)
    n_shards: int
    num_docs: int
    tile: int
    block: int
    words_per_block: int
    max_blocks_per_term: int
    route_span_max: int
    route_pairs_max: int

    def device_arrays(self, mesh: shmap.Mesh) -> list:
        return _shard_arrays(self, mesh, replicated=("norm",))


def _routing_stack(bands: list, S: int, nbmax: int):
    """(tile_first, tile_count) of per-shard indexes stacked [S, NBmax]."""
    tf_a = np.zeros((S, nbmax), np.int32)
    tc_a = np.zeros((S, nbmax), np.int32)
    for s, ix in enumerate(bands):
        nb = int(ix.tile_first.shape[0])
        tf_a[s, :nb] = _np(ix.tile_first)
        tc_a[s, :nb] = _np(ix.tile_count)
    return tf_a, tc_a


def build_term_sharded_packed(host: PostingsHost, n_shards: int
                              ) -> PackedTermShardedIndex:
    """Per-vocab-shard re-compression: slice the global posting lists
    per hash range, then delta+bit-pack each shard's lists."""
    subs, wmax = _term_shard_subhosts(host, n_shards)
    shards = [layouts.build_packed_csr(sub, device="cpu") for sub in subs]
    S = n_shards
    pk, bt, bits_a, base_a, cnt_a, nbmax, wpb = _packed_stack(shards, S)
    sh_a = np.full((S, wmax), 0xFFFFFFFF, np.uint32)
    df_a = np.zeros((S, wmax), np.int32)
    offs_a = np.zeros((S, wmax + 1), np.int32)
    for s, ix in enumerate(shards):
        _vocab_slots(ix, s, wmax, sh_a, df_a, offs_a, ix.df,
                     ix.block_offsets)
    tf_a, tc_a = _routing_stack(shards, S, nbmax)
    return PackedTermShardedIndex(
        sorted_hash=sh_a, df=df_a, block_offsets=offs_a, packed=pk,
        block_tfs=bt, block_bits=bits_a, block_base=base_a,
        block_count=cnt_a, tile_first=tf_a, tile_count=tc_a,
        norm=host.norm.astype(np.float32), n_shards=S,
        num_docs=host.num_docs, tile=layouts.ROUTE_TILE,
        block=shards[0].block, words_per_block=wpb,
        max_blocks_per_term=max(ix.max_blocks_per_term for ix in shards),
        route_span_max=max(ix.route_span_max for ix in shards),
        route_pairs_max=max(ix.route_pairs_max for ix in shards),
    )


@dataclasses.dataclass
class BandedTermShardedIndex:
    """Stacked per-vocab-shard BANDED arrays for the fused engine: each
    shard re-bands its hash range with the byte model
    (``layouts.build_banded``).  Terms are whole, so a query term's
    postings live in one band of one shard; the scorer sums the two
    dense band partials locally BEFORE the cross-shard psum.  The
    un-prefixed block arrays are the packed band's; the HOR band rides
    under ``hor_*``."""
    sorted_hash: np.ndarray        # u32[S, Wmax]  (padded with 0xFFFFFFFF)
    df: np.ndarray                 # i32[S, Wmax]  global df (whole terms)
    block_offsets: np.ndarray      # i32[S, Wmax+1]   packed band
    packed: np.ndarray             # u32[S, NBmax, WPB]
    block_tfs: np.ndarray          # f16[S, NBmax, BLOCK]
    block_bits: np.ndarray         # i32[S, NBmax]  (1 on padding blocks)
    block_base: np.ndarray         # i32[S, NBmax]
    block_count: np.ndarray        # i32[S, NBmax]  (0 on padding blocks)
    tile_first: np.ndarray         # i32[S, NBmax]
    tile_count: np.ndarray         # i32[S, NBmax]
    hor_block_offsets: np.ndarray  # i32[S, Wmax+1]   hor band
    hor_block_docs: np.ndarray     # i32[S, HNBmax, BLOCK]
    hor_block_tfs: np.ndarray      # f32[S, HNBmax, BLOCK]
    hor_tile_first: np.ndarray     # i32[S, HNBmax]
    hor_tile_count: np.ndarray     # i32[S, HNBmax]
    norm: np.ndarray               # f32[D] (replicated)
    n_shards: int
    num_docs: int
    tile: int
    block: int
    words_per_block: int
    max_blocks_per_term: int
    route_span_max: int
    route_pairs_max: int
    hor_max_blocks_per_term: int
    hor_route_span_max: int
    hor_route_pairs_max: int

    def device_arrays(self, mesh: shmap.Mesh) -> list:
        return _shard_arrays(self, mesh, replicated=("norm",))


def build_term_sharded_banded(host: PostingsHost, n_shards: int
                              ) -> BandedTermShardedIndex:
    """Per-vocab-shard banding over the SAME slicing as the hor/packed
    term-sharded builders, so a query term resolves to the same shard
    whatever the layout."""
    subs, wmax = _term_shard_subhosts(host, n_shards)
    shards = [layouts.build_banded(sub, device="cpu") for sub in subs]
    block = shards[0].block
    hnbmax = max(int(ix.hor.block_docs.shape[0]) for ix in shards)
    S = n_shards
    pk, bt, bits_a, base_a, cnt_a, nbmax, wpb = _packed_stack(
        [ix.packed for ix in shards], S)
    sh_a = np.full((S, wmax), 0xFFFFFFFF, np.uint32)
    df_a = np.zeros((S, wmax), np.int32)
    offs_a = np.zeros((S, wmax + 1), np.int32)
    h_offs_a = np.zeros((S, wmax + 1), np.int32)
    h_bd = np.full((S, hnbmax, block), -1, np.int32)
    h_bt = np.zeros((S, hnbmax, block), np.float32)
    for s, ix in enumerate(shards):
        p, h = ix.packed, ix.hor
        hnb = int(h.block_docs.shape[0])
        _vocab_slots(p, s, wmax, sh_a, df_a, offs_a, ix.df, p.block_offsets)
        w = int(p.sorted_hash.shape[0])
        h_offs_a[s, :w + 1] = _np(h.block_offsets)
        h_offs_a[s, w + 1:] = h_offs_a[s, w]
        h_bd[s, :hnb] = _np(h.block_docs)
        h_bt[s, :hnb] = _np(h.block_tfs)
    tf_a, tc_a = _routing_stack([ix.packed for ix in shards], S, nbmax)
    h_tf_a, h_tc_a = _routing_stack([ix.hor for ix in shards], S, hnbmax)
    return BandedTermShardedIndex(
        sorted_hash=sh_a, df=df_a, block_offsets=offs_a, packed=pk,
        block_tfs=bt, block_bits=bits_a, block_base=base_a,
        block_count=cnt_a, tile_first=tf_a, tile_count=tc_a,
        hor_block_offsets=h_offs_a, hor_block_docs=h_bd,
        hor_block_tfs=h_bt, hor_tile_first=h_tf_a, hor_tile_count=h_tc_a,
        norm=host.norm.astype(np.float32), n_shards=S,
        num_docs=host.num_docs, tile=layouts.ROUTE_TILE, block=block,
        words_per_block=wpb,
        max_blocks_per_term=max(ix.packed.max_blocks_per_term
                                for ix in shards),
        route_span_max=max(ix.packed.route_span_max for ix in shards),
        route_pairs_max=max(ix.packed.route_pairs_max for ix in shards),
        hor_max_blocks_per_term=max(ix.hor.max_blocks_per_term
                                    for ix in shards),
        hor_route_span_max=max(ix.hor.route_span_max for ix in shards),
        hor_route_pairs_max=max(ix.hor.route_pairs_max for ix in shards),
    )


TERM_BUILDERS = {"hor": build_term_sharded_blocked,
                 "packed": build_term_sharded_packed,
                 "banded": build_term_sharded_banded}


def build_term_sharded_from_view(view, n_shards: int,
                                 layout: str = "hor"):
    """Term-partition an epoch-pinned ``LiveView``: bulk-build the
    view's live corpus and shard the vocabulary.  Returns ``(index,
    live_ids)``: the fused term-sharded index over the COMPACT live-doc
    space, and the ascending global ids that map compact results back
    (ascending, so exact-score ties still break on the lowest global
    id).  It rebuilds per epoch: the right trade only when the corpus
    is near-static between handoffs."""
    tc_live, live_ids = view.export_live_corpus()
    builder = TERM_BUILDERS.get(layout, build_term_sharded_blocked)
    host = build.bulk_build(tc_live)
    return builder(host, n_shards), np.asarray(live_ids, np.int64)


def make_term_sharded_fused_scorer(
        index: (BlockedTermShardedIndex | PackedTermShardedIndex
                | BandedTermShardedIndex),
        mesh: shmap.Mesh, axis: str, k: int = 10, cap: int | None = None,
        return_stats: bool = False):
    """fn(query_hashes u32[T], trace=None) -> (scores[k], global doc
    ids[k]).

    Each shard scores the query terms it owns through its layout's
    dense fused kernel (``ops.fused_score_blocked`` / ``_packed``; a
    banded shard runs both and adds the packed and HOR partials locally)
    over the GLOBAL doc space; the term-sharding tax follows, a full [D]
    psum of partials in shard order, and then every shard reduces its
    1/S slice of the doc-tile grid to per-tile candidates and the
    all-gather candidate merge gives the global top-k.

    ``cap`` bounds postings read per term; with ``return_stats=True``
    the scorer returns ``((scores, ids), stats)`` where
    ``stats["truncated_terms"]`` counts query terms whose posting list
    exceeded ``cap``, summed over the shards."""
    shmap.check_axis(mesh, axis, index.n_shards)
    packed_layout = isinstance(index, PackedTermShardedIndex)
    banded_layout = isinstance(index, BandedTermShardedIndex)
    lay = ("banded" if banded_layout
           else "packed" if packed_layout else "hor")
    arrs = index.device_arrays(mesh)
    num_docs, tile = index.num_docs, index.tile
    n_tiles = max(-(-num_docs // tile), 1)
    S = index.n_shards
    block = (index.block if packed_layout or banded_layout
             else int(index.block_docs.shape[-1]))
    m_blocks = max(index.max_blocks_per_term, 1)
    m_blocks_h = (max(index.hor_max_blocks_per_term, 1) if banded_layout
                  else 0)
    if cap is not None:
        m_blocks = max(min(m_blocks, -(-cap // block)), 1)
        m_blocks_h = max(min(m_blocks_h, -(-cap // block)), 1)
    # dense kernels: only the routing-free geometry (query-lane pad and
    # candidate quantum) follows the tuning table here
    cfg = autotune.lookup(mesh.devices[0].type, num_docs, lay)
    q_pad = cfg.q_pad
    k_tile = _k_tile(cfg, tile, k)
    # per-shard slice of the tile grid for candidate extraction
    chunk = -(-n_tiles // S) * tile

    def band(sq, prefix, tid, w, t, m, pairs_max, span_max, packed):
        cb, cv, cq, cw, ccap = ops.expand_block_candidates(
            sq[prefix + "block_offsets"], tid[None], w[None], m, block,
            cap=cap)
        pb, pt, pqw, pcap, ovf = ops.build_batched_pairs(
            cb, cv, cq, cw, sq[prefix + "tile_first"],
            sq[prefix + "tile_count"], n_tiles, 1,
            _pair_budget(pairs_max, t, m, span_max), cand_cap=ccap)
        pqw = _pad_lanes(pqw, q_pad)
        if packed:
            part = ops.fused_score_packed(
                sq["packed"], sq["block_tfs"], pb, pt, pqw, pcap,
                *_decode(sq, pb), num_docs, block, tile=tile)[0]
        else:
            part = ops.fused_score_blocked(
                sq[prefix + "block_docs"], sq[prefix + "block_tfs"], pb, pt,
                pqw, pcap, num_docs, tile=tile)[0]
        return part, ovf

    def shard(s, sq, qh):
        qh = query.dedup_query_hashes(qh)
        t = qh.shape[0]
        tid, hit, pos = _lookup(sq["sorted_hash"], qh)  # others' terms miss
        df = torch.where(hit, sq["df"][pos], 0)
        w = query.idf(df, num_docs)
        trunc = ((hit & (df > cap)).sum() if cap is not None
                 else torch.zeros((), dtype=torch.int64, device=qh.device))
        part, ovf = band(sq, "", tid, w, t, m_blocks, index.route_pairs_max,
                         index.route_span_max,
                         packed_layout or banded_layout)
        ovfs = [ovf]
        if banded_layout:
            # every term is wholly in one band, so the HOR band scores
            # exactly the terms the packed band skipped; the two partials
            # add locally BEFORE the cross-shard psum
            part_h, ovf_h = band(sq, "hor_", tid, w, t, m_blocks_h,
                                 index.hor_route_pairs_max,
                                 index.hor_route_span_max, False)
            part = part + part_h
            ovfs.append(ovf_h)
        return part, w, trunc, ovfs

    def extract(s, local):
        v, ids = ops.extract_tile_candidates(local[None], tile, k_tile)
        return v[0], torch.where(ids[0] >= 0, ids[0] + s * chunk, -1)

    def run(qh):
        parts = shmap.run(mesh, shard, arrs, qh)
        # THE term-partitioned cost: a full [D] psum across shards
        scores = shmap.psum(mesh, [p[0] for p in parts])
        final = _tail(scores, arrs[0]["norm"],
                      _psum_norm(mesh, [p[1] for p in parts]))
        fpad = torch.nn.functional.pad(final, (0, S * chunk - num_docs),
                                       value=NEG_INF)
        locals_ = [fpad[s * chunk:(s + 1) * chunk].to(dev)
                   for s, dev in enumerate(mesh.devices)]
        cands = shmap.run(mesh, extract, locals_)
        vv, ii = topk.local_candidate_merge([c[0] for c in cands],
                                            [c[1] for c in cands], k, mesh)
        trunc = shmap.psum(mesh, [p[2] for p in parts])
        return vv, ii, trunc, [o for p in parts for o in p[3]]

    def scorer_stats(query_hashes, trace=None):
        qh = _query_row(query_hashes)
        vv, ii, trunc, ovfs = _traced(
            mesh, lambda: run(qh), trace, n_shards=S, k=k, sharding="term",
            layout=lay)
        _warn_overflow(mesh, ovfs, "term-sharded fused engine")
        return vv, ii, int(trunc)

    if return_stats:
        def with_stats(query_hashes, trace=None):
            vv, ii, trunc = scorer_stats(query_hashes, trace=trace)
            ops.record_truncated(trunc)
            return (vv, ii), {"truncated_terms": trunc}
        return with_stats

    def scorer(query_hashes, trace=None):
        return scorer_stats(query_hashes, trace=trace)[:2]
    return scorer
