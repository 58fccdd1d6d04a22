"""Reads the posting layout of one of the port's indexes into the host
arrays the work count takes (``yardstick.work``): the vocabulary's
sorted hashes, each term's block range, each block's doc range and
routing span, and the widths of a block."""
from __future__ import annotations

import numpy as np

from portbench.yardstick import work


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _common(ix) -> dict:
    return dict(block_offsets=_np(ix.block_offsets),
                tile_first=_np(ix.tile_first), tile_count=_np(ix.tile_count),
                block_min=_np(ix.block_min), block_max=_np(ix.block_max),
                num_docs=int(ix.docs.num_docs), route_tile=int(ix.route_tile),
                block=int(ix.block))


def band(ix) -> dict:
    """One HOR (``BlockedIndex``) or packed (``PackedCsrIndex``) index."""
    c = _common(ix)
    if hasattr(ix, "words_per_block"):
        lay = work.packed_layout(words_per_block=int(ix.packed.shape[1]),
                                 lanes=int(ix.block_tfs.shape[1]), **c)
    else:
        lay = work.hor_layout(lanes=int(ix.block_docs.shape[1]), **c)
    lay["sorted_hash"] = _np(ix.sorted_hash).view(np.uint32)
    return lay


def bands(ix) -> list[dict]:
    """A banded segment's two bands, or the one band of a plain index."""
    if hasattr(ix, "hor") and hasattr(ix, "packed") \
            and not hasattr(ix, "words_per_block"):
        return [band(ix.packed), band(ix.hor)]
    return [band(ix)]


def term_ids(layout: dict, hashes) -> np.ndarray:
    """This layout's term ids of u32 ``hashes`` (-1 where absent): a
    term's id is its position among the unsigned-sorted hashes."""
    srt = layout["sorted_hash"]
    h = np.asarray(hashes, np.uint32).reshape(-1)
    h = h[h != 0]
    pos = np.minimum(np.searchsorted(srt, h), len(srt) - 1)
    return np.where(srt[pos] == h, pos, -1)
