"""The roofline count on a hand-worked case."""
import numpy as np
import pytest

import _tiny  # noqa: F401
from portbench.yardstick import peaks, work


def layout(kind):
    # 3 terms: term 0 owns blocks 0-1, term 1 none, term 2 block 2;
    # 2,000 docs in tiles of 512 (4 tiles)
    c = dict(block_offsets=[0, 2, 2, 3],
             tile_first=np.array([0, 1, 3]), tile_count=np.array([2, 1, 1]),
             block_min=np.array([0, 600, 1600]),
             block_max=np.array([900, 1000, 1700]),
             num_docs=2000, route_tile=512, block=128)
    if kind == "hor":
        return work.hor_layout(lanes=128, **c)
    return work.packed_layout(words_per_block=16, lanes=128, **c)


def test_routed_counts_blocks_pairs_and_tiles():
    lay = layout("hor")
    assert work.routed(lay, [0, 2, 2, -1], 512) == (3, 4, 3)
    assert work.routed(lay, [1], 512) == (0, 0, 0)
    # another tile width: spans from each block's doc range
    assert work.routed(lay, [0], 1024) == (2, 2, 1)


def test_candidate_call_by_hand():
    lay = layout("hor")
    w = work.candidate_call(lay, [0, 2], tile=512, k_tile=16, q=8, q_real=5)
    blocks, pairs, tiles, n_tiles = 3, 4, 3, 4
    want_bytes = (blocks * 1024 + pairs * (12 + 32) + tiles * 512 * 8
                  + 8 * 4 + 8 * n_tiles * 16 * 8)
    want_ops = blocks * 128 * 2 * 5 + 5 * tiles * 512 * (5 + 16)
    assert (w.bytes, w.ops) == (want_bytes, want_ops)
    assert w.least_s() == max(want_bytes / peaks.HBM_BW,
                              want_ops / peaks.PEAK_FLOPS_F32)


def test_dense_call_by_hand():
    lay = layout("packed")
    w = work.dense_call(lay, [0, 2], tile=512, q=8, q_real=8)
    want_bytes = 3 * (16 * 4 + 128 * 2) + 4 * (12 + 32 + 12) + 8 * 2000 * 4
    assert (w.bytes, w.ops) == (want_bytes, 4 * 128 * 2 * 8)


def test_roofline_share():
    w = work.Work(bytes=3.35e9, ops=0.0)
    assert work.roofline_pct(w, 0.002) == pytest.approx(50.0)
    assert work.roofline_pct(w, 0.0) is None
