"""Epoch-pinned snapshots + host serialize/restore of a SegmentedIndex
(the port of ``repro.serve.snapshot``; the same format, so a snapshot
written by either package restores in the other).

Two consistency mechanisms, two lifetimes:

  * ``pin``: an in-process ``LiveView`` (core/live_index.py), so
    queries score a consistent index at one epoch while writes land.
    This is what the QueryServer batches against.

  * ``serialize_segmented`` / ``restore_segmented``: a host-side flat
    ``{name: ndarray}`` state (savez-compatible) holding the canonical
    postings, global scoring state, delta tail, policy, and rng state.
    Restore rebuilds every sealed segment on ``device`` through the
    SAME bulk build + size-class padding path as live sealing, so a
    restored index answers bit-identically to the one that was saved,
    and, because the rank rng state (numpy's PCG64) rides along, keeps
    answering identically under identical future mutation schedules.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from repro_torch.core import compaction, size_model
from repro_torch.core.live_index import (LiveIndexStats, LiveView,
                                         SegmentedIndex, _Delta)

# v2 adds the layout policy + per-segment chooser provenance
# (size_class, num_terms, chooser_reason); v3 adds the per-segment band
# descriptor (band_cut) so banded segments restore with the EXACT band
# membership they sealed with.  v1/v2 snapshots still restore (no
# policy / band_cut re-derived by the builder): the arrays are
# identical either way.
_FORMAT_VERSION = 3
_READ_VERSIONS = (1, 2, 3)


def pin(index: SegmentedIndex) -> LiveView:
    """The current epoch's immutable view (see ``LiveView``).  Callers
    running writers concurrently must hold their write lock for this
    call; the serving tier does (and only for the pin, never the
    query)."""
    return index.view()


def serialize_segmented(index: SegmentedIndex, lock=None) -> dict:
    """Flat ``{name: np.ndarray}`` snapshot of the full index state.

    Layout: a JSON manifest (uint8 bytes under ``"meta"``) for scalars
    and per-segment shapes, plus one array per global table and per
    segment postings column.  Everything needed to rebuild: vocabulary,
    live df, live mask, ranks, norms, per-segment canonical triples, the
    delta tail, compaction policy, and the rank rng state.  All of it is
    host state: nothing is read back from the device.

    The state is gathered in several passes, so like ``view()`` this
    must run serially with writers: pass the serving tier's write lock
    as ``lock`` (held for the whole gather), or otherwise guarantee no
    ingest/maintenance runs concurrently.
    """
    if lock is not None:
        with lock:
            return serialize_segmented(index, lock=None)
    dl = index._delta
    n_p = dl.n_postings
    pol = index.layout_policy
    meta = {
        "version": _FORMAT_VERSION,
        "live_docs": int(index._live_docs),
        "epoch": int(index._epoch),
        "seal_layout": index._seal_layout,
        "delta": {"doc_cap": dl.doc_cap, "post_cap": dl.post_cap,
                  "doc_base": dl.doc_base, "n_docs": dl.n_docs},
        "policy": {"size_ratio": index._policy.size_ratio,
                   "min_run": index._policy.min_run},
        "rng_state": index._rng.bit_generator.state,
        "stats": dataclasses.asdict(index.stats),
        # only LayoutCostModel policies serialize; a custom policy
        # object restores as None
        "layout_policy": (pol.to_dict()
                          if isinstance(pol, size_model.LayoutCostModel)
                          else None),
        # each segment restores in its ORIGINAL layout, with the chooser
        # decision that produced it
        "segments": [{"doc_base": s.doc_base, "doc_span": s.doc_span,
                      "n_postings": s.n_postings, "layout": s.layout,
                      "size_class": s.size_class,
                      "num_terms": s.num_terms,
                      "chooser_reason": s.chooser_reason,
                      "band_cut": int(s.band_cut)}
                     for s in index._segments],
    }
    state = {
        "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        "hashes": index._hashes.copy(),
        "df": index._df.copy(),
        "live": index._live.copy(),
        "rank": index._rank.copy(),
        "norm": index._norm.copy(),
        "delta_terms": dl.terms[:n_p].copy(),
        "delta_tfs": dl.tfs[:n_p].copy(),
        "delta_lens": np.diff(dl.doc_offsets[:dl.n_docs + 1]),
    }
    for i, s in enumerate(index._segments):
        state[f"seg{i}_doc_of"] = s.doc_of.copy()
        state[f"seg{i}_terms"] = s.terms.copy()
        state[f"seg{i}_tfs"] = s.tfs.copy()
    return state


def restore_segmented(state: dict, device="cuda") -> SegmentedIndex:
    """Rebuild a SegmentedIndex on ``device`` from ``serialize_segmented``
    output (either package's).

    Global tables restore verbatim; sealed segments rebuild through
    ``_build_segment`` (bulk build + size-class pad) from their stored
    canonical triples, the same path live sealing takes, so device
    structures come out identical up to vocabulary width (terms added
    after a segment sealed appear as posting-less vocab entries, which
    gate nothing and change no result bit).
    """
    meta = json.loads(bytes(np.asarray(state["meta"])).decode())
    if meta["version"] not in _READ_VERSIONS:
        raise ValueError(f"unknown snapshot version {meta['version']}")
    pol = meta.get("layout_policy")
    si = SegmentedIndex(
        term_hashes=np.asarray(state["hashes"], np.uint32),
        delta_doc_capacity=meta["delta"]["doc_cap"],
        delta_posting_capacity=meta["delta"]["post_cap"],
        policy=compaction.TieredPolicy(**meta["policy"]),
        seal_layout=meta["seal_layout"],
        layout_policy=(size_model.LayoutCostModel.from_dict(pol)
                       if pol is not None else None),
        device=device)
    si._df = np.asarray(state["df"], np.int64).copy()
    si._live = np.asarray(state["live"], bool).copy()
    si._rank = np.asarray(state["rank"], np.float32).copy()
    si._norm = np.asarray(state["norm"], np.float32).copy()
    si._live_docs = int(meta["live_docs"])
    si._rng.bit_generator.state = meta["rng_state"]
    # norms are already restored, so segment builds pad the exact values
    for i, sm in enumerate(meta["segments"]):
        # the stored layout restores as an EXPLICIT arg (top of the
        # ladder), so the roundtrip stays bitwise whatever the restored
        # policy would choose today; the original chooser reason is
        # re-attached as provenance (v1: "default")
        seg = si._build_segment(
            int(sm["doc_base"]), int(sm["doc_span"]),
            np.asarray(state[f"seg{i}_doc_of"], np.int64),
            np.asarray(state[f"seg{i}_terms"], np.int64),
            np.asarray(state[f"seg{i}_tfs"], np.float32),
            layout=sm.get("layout", meta["seal_layout"]),
            band_cut=sm.get("band_cut") or None)
        seg.chooser_reason = sm.get("chooser_reason", "default")
        si._segments.append(seg)
    dl = _Delta(meta["delta"]["doc_cap"], meta["delta"]["post_cap"],
                meta["delta"]["doc_base"])
    lens = np.asarray(state["delta_lens"], np.int64)
    if lens.size:
        dl.append(lens, np.asarray(state["delta_terms"], np.int32),
                  np.asarray(state["delta_tfs"], np.float32))
    si._delta = dl
    si._delta_dirty = True
    si.stats = LiveIndexStats(**meta["stats"])
    si._epoch = int(meta["epoch"])
    # the per-segment rebuilds above go through _build_segment directly
    # (no per-segment seal events); one restore event marks the cutover
    si.events.emit("restore", epoch=si._epoch,
                   segments=len(si._segments),
                   snapshot_version=int(meta["version"]))
    return si


def save_segmented(index: SegmentedIndex, path, lock=None) -> None:
    """Snapshot to an ``.npz`` file (compressed).  ``lock`` as in
    ``serialize_segmented``: hold the write lock when writers may be
    live (only the state gather runs under it, not the file write)."""
    t0 = time.perf_counter()
    state = serialize_segmented(index, lock=lock)
    np.savez_compressed(path, **state)
    index.events.emit("snapshot_save", epoch=index.epoch,
                      segments=index.num_segments, path=str(path),
                      duration_us=(time.perf_counter() - t0) * 1e6)


def load_segmented(path, device="cuda") -> SegmentedIndex:
    """Restore from ``save_segmented`` output (either package's), on
    ``device``."""
    with np.load(path) as z:
        return restore_segmented({k: z[k] for k in z.files}, device=device)
