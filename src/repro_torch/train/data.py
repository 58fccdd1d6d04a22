"""Synthetic, shardable, deterministic-by-step data pipelines: the
port's own copy of ``repro.train.data`` (numpy only, so the two packages
make the same arrays from the same seeds).

Every batch is a pure function of (seed, step) — after a crash/restart
the pipeline replays exactly, which is what makes checkpoint/restart
byte-identical (fault tolerance contract).  A small background
prefetcher overlaps host batch synthesis with device compute.

Includes the REAL neighbor sampler required by the GNN ``minibatch_lg``
cell: uniform fanout sampling over a CSR adjacency, emitting fixed-shape
padded subgraphs.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np

# ---------------------------------------------------------------------------
# prefetcher
# ---------------------------------------------------------------------------


class Prefetcher:
    """Background-thread batch prefetch (depth-bounded)."""

    def __init__(self, make_batch: Callable[[int], dict], start_step: int,
                 depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        s = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self._make(s), timeout=0.1)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int) -> dict:
    rng = np.random.default_rng((seed, step))
    toks = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


# ---------------------------------------------------------------------------
# recsys
# ---------------------------------------------------------------------------


def sasrec_batch(seed: int, step: int, batch: int, seq: int, n_items: int,
                 n_neg: int) -> dict:
    rng = np.random.default_rng((seed, step))
    hist = rng.integers(1, n_items, size=(batch, seq)).astype(np.int32)
    pos = rng.integers(1, n_items, size=(batch, seq)).astype(np.int32)
    neg = rng.integers(1, n_items, size=(batch, seq, n_neg)).astype(np.int32)
    return {"hist": hist, "pos": pos, "neg": neg}


def bert4rec_batch(seed: int, step: int, batch: int, seq: int, n_items: int,
                   n_neg: int, mask_frac: float = 0.2) -> dict:
    rng = np.random.default_rng((seed, step))
    hist = rng.integers(1, n_items, size=(batch, seq)).astype(np.int32)
    maskpos = rng.random((batch, seq)) < mask_frac
    targets = np.where(maskpos, hist, 0).astype(np.int32)
    hist = np.where(maskpos, n_items, hist).astype(np.int32)   # [MASK] id
    neg = rng.integers(1, n_items, size=(batch, seq, n_neg)).astype(np.int32)
    return {"hist": hist, "targets": targets, "neg": neg}


def dien_batch(seed: int, step: int, batch: int, seq: int, n_items: int
               ) -> dict:
    rng = np.random.default_rng((seed, step))
    return {
        "hist": rng.integers(1, n_items, size=(batch, seq)).astype(np.int32),
        "target": rng.integers(1, n_items, size=(batch,)).astype(np.int32),
        "label": rng.integers(0, 2, size=(batch,)).astype(np.float32),
        "aux_neg": rng.integers(1, n_items,
                                size=(batch, seq)).astype(np.int32),
    }


def xdeepfm_batch(seed: int, step: int, batch: int, n_fields: int,
                  vocab: int, n_hot: int = 1) -> dict:
    rng = np.random.default_rng((seed, step))
    shape = (batch, n_fields) if n_hot == 1 else (batch, n_fields, n_hot)
    return {
        "sparse": rng.integers(0, vocab, size=shape).astype(np.int32),
        "label": rng.integers(0, 2, size=(batch,)).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------


class CsrGraph:
    """Host-side CSR adjacency (the paper's layout, applied to graphs)."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 feats: np.ndarray, labels: np.ndarray):
        self.indptr = indptr
        self.indices = indices
        self.feats = feats
        self.labels = labels

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)


def make_synthetic_graph(n_nodes: int, n_edges: int, d_feat: int,
                         n_classes: int, seed: int = 0) -> CsrGraph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return CsrGraph(indptr, dst.astype(np.int32), feats, labels)


class NeighborSampler:
    """Uniform fanout sampler over CSR: the minibatch_lg training path.

    Emits FIXED-SHAPE padded subgraphs: seeds + fanout[0] 1-hop +
    fanout[0]*fanout[1] 2-hop neighbors; missing neighbors are padded
    with edge endpoints == n_sub (dropped by segment ops).
    """

    def __init__(self, graph: CsrGraph, batch_nodes: int,
                 fanout: tuple[int, ...], seed: int = 0):
        self.g = graph
        self.batch_nodes = batch_nodes
        self.fanout = fanout

    def sample(self, step: int) -> dict:
        # the reference's seed, kept as it is: Python salts str hashes
        # per process, so a block repeats only within one process (and
        # the two packages agree only there); ``seed`` is not used
        rng = np.random.default_rng((hash("sampler") & 0xFFFF, step))
        g = self.g
        seeds = rng.integers(0, g.num_nodes, self.batch_nodes)
        frontier = seeds
        all_src, all_dst = [], []
        nodes = [seeds]
        for f in self.fanout:
            deg = g.indptr[frontier + 1] - g.indptr[frontier]
            # sample f neighbors per frontier node (with repl.; deg==0 pads)
            offs = rng.integers(0, np.maximum(deg, 1)[:, None],
                                size=(len(frontier), f))
            nbr = g.indices[np.minimum(g.indptr[frontier, None] + offs,
                                       len(g.indices) - 1)]
            valid = (deg > 0)[:, None] & np.ones_like(offs, bool)
            nbr = np.where(valid, nbr, -1)
            src = nbr.reshape(-1)
            dst = np.repeat(frontier, f)
            keep = src >= 0
            all_src.append(np.where(keep, src, 0))
            all_dst.append(np.where(keep, dst, -1))
            nodes.append(np.where(keep, src, 0))
            frontier = nbr.reshape(-1)
            frontier = np.where(frontier >= 0, frontier, 0)

        # relabel global ids -> compact local ids (vectorized searchsorted)
        all_nodes = np.concatenate(nodes)
        uniq = np.unique(all_nodes)
        cap = self.batch_nodes          # static node capacity of a block
        m = self.batch_nodes
        for f in self.fanout:
            m = m * f
            cap += m
        src = np.concatenate(all_src)
        dst = np.concatenate(all_dst)
        loc_src = np.searchsorted(uniq, src).astype(np.int32)
        loc_dst = np.where(dst >= 0,
                           np.searchsorted(uniq, np.maximum(dst, 0)),
                           -1).astype(np.int32)
        n_sub = len(uniq)
        seed_loc = np.searchsorted(uniq, seeds)
        feats = np.zeros((cap, g.feats.shape[1]), np.float32)
        feats[:n_sub] = g.feats[uniq]
        labels = np.zeros((cap,), np.int32)
        labels[:n_sub] = g.labels[uniq]
        mask = np.zeros((cap,), bool)
        mask[seed_loc] = True
        # pad edge arrays to fixed size
        e_cap = sum(self.batch_nodes * int(np.prod(self.fanout[:i + 1]))
                    for i in range(len(self.fanout)))
        es = np.full((e_cap,), cap, np.int32)
        ed = np.full((e_cap,), cap, np.int32)
        keep = loc_dst >= 0
        es[:keep.sum()] = loc_src[keep]
        ed[:keep.sum()] = loc_dst[keep]
        return {"feats": feats, "src": es, "dst": ed, "labels": labels,
                "mask": mask}


def molecule_batch(seed: int, step: int, n_graphs: int, nodes_per: int,
                   edges_per: int, d_feat: int, n_classes: int) -> dict:
    rng = np.random.default_rng((seed, step))
    n = n_graphs * nodes_per
    e = n_graphs * edges_per
    base = np.repeat(np.arange(n_graphs) * nodes_per, edges_per)
    src = (rng.integers(0, nodes_per, e) + base).astype(np.int32)
    dst = (rng.integers(0, nodes_per, e) + base).astype(np.int32)
    return {
        "feats": rng.normal(size=(n, d_feat)).astype(np.float32),
        "src": src, "dst": dst,
        "graph_ids": np.repeat(np.arange(n_graphs), nodes_per
                               ).astype(np.int32),
        "g_labels": rng.integers(0, n_classes, n_graphs).astype(np.int32),
    }


def fullgraph_batch(graph: CsrGraph, train_frac: float = 0.5,
                    seed: int = 0) -> dict:
    """Full-batch node-classification inputs from a CSR graph."""
    g = graph
    src = np.repeat(np.arange(g.num_nodes, dtype=np.int32),
                    np.diff(g.indptr).astype(np.int32))
    rng = np.random.default_rng(seed)
    return {"feats": g.feats, "src": src, "dst": g.indices,
            "labels": g.labels,
            "mask": rng.random(g.num_nodes) < train_frac}
