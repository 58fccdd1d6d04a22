"""CPU mirrors of the dense fused scorers' device-side walk
(``csrc/run_walk.cuh`` and ``csrc/fused_score.cuh``), which no CPU can
run: each CTA's run search against ``tile_starts``, and the chunked
``cp.async`` pipeline's schedule, which must hand every pair of a run to
the accumulate once, in order, from buffers no later copy has
overwritten.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_decode_score as tfds  # noqa: E402

# fused_score.cuh's pipeline constants
CHUNK, META_BUFS, RING_BUFS = 16, 3, 2


def _warp_lower_bound(a, key):
    """``run_walk::warp_lower_bound``: one warp's 32-ary search of sorted
    ``a`` for the first index whose value is >= key; returns the bound
    and the dependent loads it took, and checks that the lanes below the
    key form a prefix, as the ballot count assumes."""
    lane = np.arange(32)
    lo, hi, loads = 0, len(a), 0

    def below(idx):
        ok = idx < hi
        b = np.zeros(32, bool)
        b[ok] = a[idx[ok]] < key
        assert not (b[1:] & ~b[:-1]).any()
        return int(b.sum())
    while hi - lo > 32:
        step = (hi - lo + 31) // 32
        lo += below(lo + (lane + 1) * step - 1) * step
        hi = min(hi, lo + step - 1)
        loads += 1
    return lo + below(lo + lane), loads + 1


def _find_run(pair_tile, t):
    """``run_walk::find_run``: warp 0 searches for t, warp 1 for t + 1."""
    (p0, l0), (p1, l1) = (_warp_lower_bound(pair_tile, t + w)
                          for w in (0, 1))
    return p0, p1, max(l0, l1)


def _sorted_tiles(rng, case, n_tiles):
    """Random tile-sorted pair tiles of one kind; padding at n_tiles."""
    if case == "random":
        tiles = rng.integers(0, n_tiles + 1, 5000)
    elif case == "empty_runs":                  # most tiles unvisited
        tiles = rng.choice([0, 3, 17, n_tiles - 1, n_tiles], 700)
    elif case == "trash_only":                  # every pair is padding
        tiles = np.full(4096, n_tiles)
    elif case == "no_pairs":
        tiles = np.zeros(0, np.int64)
    else:                                       # runs past 32 * 32 pairs
        tiles = np.concatenate([np.full(n, t) for t, n in zip(
            rng.choice(n_tiles, 6, replace=False),
            [1023, 1024, 1025, 3000, 32 * 32 * 3 + 1, 17])]
            + [np.full(50, n_tiles)])
    return np.sort(tiles).astype(np.int32)


@pytest.mark.parametrize("case", ["random", "empty_runs", "trash_only",
                                  "no_pairs", "long_runs"])
def test_dense_run_search_equals_tile_starts(case):
    """Every CTA's run [p0, p1), found by the two warp searches on the
    card, is ``tile_starts``' [start[t], start[t + 1]): for random sorted
    pair tiles, unvisited tiles, pairs that are all padding, no pairs,
    and runs longer than 32 * 32 pairs."""
    rng = np.random.default_rng(len(case))
    n_tiles = 64
    pair_tile = _sorted_tiles(rng, case, n_tiles)
    want = tfds.tile_starts(torch.from_numpy(pair_tile), n_tiles).numpy()
    for t in range(n_tiles):
        p0, p1, loads = _find_run(pair_tile, t)
        assert (p0, p1) == (want[t], want[t + 1])
        assert loads <= 4


def _pipeline_schedule(n_run):
    """The order of ``score_kernel``'s copies, lane-map writes and reads
    for a run of ``n_run`` pairs, as (event, chunk, buffer) tuples:
    "meta"/"blocks" start copies into a buffer, "wait" waits for every
    copy issued so far and ends on a barrier, "clear" clears a lane map
    for a chunk, "scatter" fills chunk's map (then a barrier), the
    "read_*" events are the reads that issue, scatter or add a chunk,
    "done" ends a chunk's adds."""
    n_chunks = -(-n_run // CHUNK)
    ev = []
    if n_chunks == 0:
        return ev
    ev += [("meta", 0, 0 % META_BUFS), ("clear", 0, 0), ("clear", 1, 1),
           ("wait",)]
    ev += [("read_meta", 0, 0), ("blocks", 0, 0 % RING_BUFS)]
    if n_chunks > 1:
        ev.append(("meta", 1, 1 % META_BUFS))
    for k in range(n_chunks):
        ev.append(("wait",))
        if k > 0:
            ev.append(("clear", k + 1, (k + 1) % 2))
        if k + 1 < n_chunks:
            ev += [("read_meta", k + 1, (k + 1) % META_BUFS),
                   ("blocks", k + 1, (k + 1) % RING_BUFS)]
        if k + 2 < n_chunks:
            ev.append(("meta", k + 2, (k + 2) % META_BUFS))
        ev += [("read_meta", k, k % META_BUFS),
               ("read_blocks", k, k % RING_BUFS), ("scatter", k, k % 2),
               ("read_map", k, k % 2), ("read_meta", k, k % META_BUFS),
               ("read_blocks", k, k % RING_BUFS), ("done", k)]
    return ev


@pytest.mark.parametrize("n_run", [1, 15, 16, 17, 33, 48, 200, 1025])
def test_dense_pipeline_never_reads_a_stale_buffer(n_run):
    """The chunked pipeline of the dense kernels: every read finds its own
    chunk in its buffer, landed (a wait since its copy); no copy lands in
    a buffer whose chunk is still to be read; a lane map is cleared for a
    chunk, behind a barrier, before the chunk is scattered into it, and
    not again until the chunk's adds are done; the chunks are added once
    each, in order, and together cover the run."""
    holds, landed, pending = {}, set(), set()
    done, cleared, mapped = [], {}, {}
    for e in _pipeline_schedule(n_run):
        kind = e[0]
        if kind == "wait":
            landed |= pending
            pending.clear()
            cleared = {b: (k, True) for b, (k, _) in cleared.items()}
        elif kind == "clear":
            _, k, buf = e
            if buf in mapped:                   # its last chunk is done
                assert mapped[buf] in done, e
            cleared[buf] = (k, False)           # visible after a barrier
        elif kind == "scatter":
            _, k, buf = e
            assert cleared.get(buf) == (k, True), (e, cleared.get(buf))
            mapped[buf] = k
            del cleared[buf]
        elif kind == "read_map":
            assert mapped.get(e[2]) == e[1], e
        elif kind in ("meta", "blocks"):
            _, k, buf = e
            key = (kind, buf)
            if key in holds:                    # the old chunk is finished
                assert holds[key] in done, (e, holds[key])
            holds[key] = k
            pending.add((kind, k))
        else:
            if kind == "done":
                done.append(e[1])
                continue
            _, k, buf = e
            src = "meta" if kind == "read_meta" else "blocks"
            assert holds[(src, buf)] == k and (src, k) in landed, e
    assert done == list(range(-(-n_run // CHUNK)))
    sizes = [min(CHUNK, n_run - k * CHUNK) for k in done]
    assert sum(sizes) == n_run and all(s > 0 for s in sizes)


def _copy_rows_units(threads, n, bytes_, wide):
    """``run_walk::copy_rows``' (row, byte offset) of every thread's
    copies, thread by thread."""
    unit = 16 if wide else 4
    units = bytes_ // unit
    done = []
    for t in range(threads):
        if units > threads:
            done += [(j, off) for j in range(n)
                     for off in range(t * unit, bytes_, threads * unit)]
            continue
        step, j0 = threads // units, t // units
        if j0 >= step:
            continue
        off = (t - j0 * units) * unit
        done += [(j, off) for j in range(j0, n, step)]
    return done


@pytest.mark.parametrize("n,bytes_,wide", [
    (16, 512, True), (16, 512, False), (3, 256, True), (16, 288, True),
    (5, 76, False), (16, 4, False), (7, 4096, False), (1, 2048, True)])
def test_copy_rows_copies_every_unit_once(n, bytes_, wide):
    """The dense kernels' staging copies (512 threads): every 16- or
    4-byte unit of every row is copied by exactly one thread, HOR rows
    (512 B), packed words and tfs (288 B, 256 B), a 4-byte row, and rows
    wider than the CTA's threads."""
    unit = 16 if wide else 4
    got = _copy_rows_units(512, n, bytes_, wide)
    want = [(j, off) for j in range(n) for off in range(0, bytes_, unit)]
    assert sorted(got) == want
