"""CPU mirrors of the fused scorers' device-side walk (``csrc/run_walk.cuh``
and ``csrc/fused_score.cuh``, shared by the dense and the candidate
kernels), which no CPU can run: each CTA's run search against the run
starts a ``searchsorted`` of the pair tiles gives, the chunked
``cp.async`` pipeline's schedule, which must hand every pair of a run to
the accumulate once, in order, from buffers no later copy has
overwritten, the candidate epilogues' per-row reduction under both value
rules (the row's maximum at zeros and (NaN, -1) through a NaN row,
against the plain successive maxima; each lane's own bits, against the
plain bitonic reducer), and the bitonic epilogue's network (register and
shared-memory stages over every row of a tile) against the plain bitonic
reducer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


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
    card, is [start[t], start[t + 1]) of ``searchsorted``: for random sorted
    pair tiles, unvisited tiles, pairs that are all padding, no pairs,
    and runs longer than 32 * 32 pairs."""
    rng = np.random.default_rng(len(case))
    n_tiles = 64
    pair_tile = _sorted_tiles(rng, case, n_tiles)
    want = np.searchsorted(pair_tile, np.arange(n_tiles + 1))
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


# fused_score.cuh's key constants, and the k_tile up to which the bitonic
# epilogue selects (kBitonicSelectUpTo)
NEG_INF_KEY, ZERO_KEY = 0x007FFFFF, 0x80000000
BITONIC_SELECT_UP_TO = 64


def _order_key(v):
    """``fused_score::order_key``: f32 -> u32 whose order is the floats'."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return np.where(u >> 31, ~u, u | np.uint32(1 << 31)).astype(np.uint32)


def _select_key(v):
    """``fused_score::select_key``: ``order_key``, -0.0 given +0.0's key
    (the two zeros tie and go by lane)."""
    v = np.asarray(v, np.float32)
    return np.where(v == 0, np.uint32(ZERO_KEY), _order_key(v))


def _key_value(k):
    k = np.uint32(k)
    u = k & np.uint32(0x7FFFFFFF) if k >> 31 else ~k
    return np.array([u], np.uint32).view(np.float32)[0]


def _lane_best(row, lo, hi):
    """``TopkOut::lane_best``: 16 keys a step, a tree of compares where
    the later position wins only on a larger key; (0, lo) if none."""
    best, at = 0, lo
    for p0 in range(lo, hi, 16):
        k = [int(row[p]) if p < hi else 0 for p in range(p0, p0 + 16)]
        idx = list(range(16))
        w = 1
        while w < 16:
            for u in range(0, 16, 2 * w):
                if k[u + w] > k[u]:
                    k[u], idx[u] = k[u + w], idx[u + w]
            w *= 2
        if k[0] > best:
            best, at = k[0], p0 + idx[0]
    return best, at


def _warp_sort(key, pos):
    """``TopkOut::warp_sort<R, true>``: the bitonic network over 32 * R
    elements, element e = 32 * r + lane; strides below 32 by
    ``__shfl_xor_sync``, the stride of 32 within a lane.  Element e ends
    as the e-th (key descending, pos ascending)."""
    key, pos = list(key), list(pos)
    n = len(key)
    size = 2
    while size <= n:
        stride = size // 2
        while stride:
            new_k, new_p = key[:], pos[:]
            for e in range(n):
                f = e ^ stride
                first = key[f] > key[e] or (key[f] == key[e]
                                            and pos[f] < pos[e])
                forward, lower = (e & size) == 0, e < f
                if first == (lower == forward):
                    new_k[e], new_p[e] = key[f], pos[f]
            key, pos = new_k, new_p
            stride //= 2
        size *= 2
    return key, pos


def _select_few(row, bounds, k_tile, base, tile):
    """``TopkOut::select_few``: T, the k_tile-th largest of the lanes'
    largest finite keys (of their two largest when more than 64 keys pass
    the first); the row's finite keys >= T gathered in lane order and
    sorted by the warp, 32 or 64 at once; None where more than 64 still
    pass."""
    tops = []
    for lo, hi in bounds:
        ks = sorted((int(row[p]) for p in range(lo, hi)
                     if row[p] > NEG_INF_KEY), reverse=True) + [0, 0]
        tops.append(ks[:2])

    def passing(thr):
        return [(int(row[p]), p) for lo, hi in bounds for p in range(lo, hi)
                if NEG_INF_KEY < row[p] and row[p] >= thr]
    got = passing(sorted((t[0] for t in tops), reverse=True)[k_tile - 1])
    if len(got) > 64:
        got = passing(sorted((x for t in tops for x in t),
                             reverse=True)[k_tile - 1])
    if len(got) > 64:
        return None
    n = 32 if len(got) <= 32 else 64
    key = [k for k, _ in got] + [0] * (n - len(got))
    pos = [p for _, p in got] + [tile + e for e in range(len(got), n)]
    key, pos = _warp_sort(key, pos)
    vals = [_key_value(key[j]) if j < len(got) else np.float32(-np.inf)
            for j in range(k_tile)]
    ids = [base + pos[j] if np.isfinite(vals[j]) else -1
           for j in range(k_tile)]
    return np.array(vals, np.float32), np.array(ids, np.int32), f"sort{n}"


def _fix_zeros(vals, ids, final, width, base, rule):
    """``TopkOut::fix_zeros`` (in a CTA whose vote found a zero): a slot
    that selected a zero, written +0.0 by its shared key, takes the
    rule's value: "max", +0.0 if the row's last +0.0 (noted by the
    owners) lies at its lane or after it; "own", its lane's sign."""
    plus = np.flatnonzero((final[:width] == 0) & ~np.signbit(final[:width]))
    last = plus[-1] if len(plus) else -1
    for j in np.flatnonzero(vals == 0):
        p = ids[j] - base
        neg = p > last if rule == "max" else np.signbit(final[p])
        vals[j] = np.float32(-0.0) if neg else np.float32(0.0)
    return vals


def _warp_topk(final, k_tile, base, width=None, rule="max"):
    """The candidate epilogues' reduction of one row, by value rule:
    "max" (``TopkOut``: the row's maximum at zeros, (NaN, -1) throughout
    in a row holding a NaN) or "own" (``BitonicOut``: each lane's own
    bits; a NaN or a k_tile past ``BITONIC_SELECT_UP_TO`` sends the CTA to
    the network, ``_bitonic_sort_rows``).  Lane l holds positions
    [l * per, (l + 1) * per) of the first ``width`` (the docs below
    num_docs; the rest of the row is -inf).  ``select_few`` where it
    applies; else each step takes the warp's largest key
    (``__reduce_max_sync``) from the lowest lane holding it (a ballot),
    which emits it, zeroes it and rescans; then ``_fix_zeros``.  Returns
    (vals, ids, the path: "nan", "network", "sort32", "sort64" or
    "maxima")."""
    tile = len(final)
    width = tile if width is None else width     # docs below num_docs
    nan = np.isnan(final[:width])
    if rule == "own" and (nan.any() or k_tile > BITONIC_SELECT_UP_TO):
        v, l = _bitonic_sort_rows(np.asarray(final, np.float32)[None], tile)
        v, l = v[0, :k_tile], l[0, :k_tile]
        return v, np.where(np.isfinite(v), base + l, -1).astype(np.int32), \
            "network"
    if nan.any():
        first = final[:width][nan][0]
        return np.full(k_tile, first, np.float32), \
            np.full(k_tile, -1, np.int32), "nan"
    row = _select_key(final).copy()
    per = -(-width // 32)
    bounds = [(min(l * per, width), min(min(l * per, width) + per, width))
              for l in range(32)]
    few = None
    if k_tile <= 32 and per <= 16 and tile >= 128:
        few = _select_few(row, bounds, k_tile, base, tile)
    if few is None:
        lanes = [_lane_best(row, lo, hi) for lo, hi in bounds]
        vals, ids = [], []
        for _ in range(k_tile):
            m = max(b for b, _ in lanes)
            w = min(l for l in range(32) if lanes[l][0] == m)
            at = lanes[w][1]
            v = _key_value(m) if m else np.float32(-np.inf)
            vals.append(v)
            ids.append(base + at if np.isfinite(v) else -1)
            if m:
                row[at] = 0
                lanes[w] = _lane_best(row, *bounds[w])
        few = np.array(vals, np.float32), np.array(ids, np.int32), "maxima"
    vals, ids, path = few
    return _fix_zeros(vals, ids, final, width, base, rule), ids, path


def _plain_reducer(rule):
    """The plain reducer each value rule is held to."""
    from repro_torch.kernels import fused_decode_score as tfds
    return tfds._tile_topk if rule == "max" else tfds._tile_topk_bitonic


def _assert_rows_equal_plain(rows, k_tile, base, rule, widths=None):
    """Each row's mirrored reduction by ``rule`` equals the plain
    reducer's, ids and value bits; returns the paths taken."""
    want_v, want_i = _plain_reducer(rule)(
        torch.from_numpy(rows), torch.full((len(rows),), base,
                                           dtype=torch.int32),
        k_tile, rows.shape[1])
    paths = []
    for r in range(len(rows)):
        got_v, got_i, path = _warp_topk(
            rows[r], k_tile, base, None if widths is None else widths[r],
            rule)
        paths.append(path)
        np.testing.assert_array_equal(got_i, want_i[r].numpy())
        np.testing.assert_array_equal(got_v.view(np.int32),
                                      want_v[r].numpy().view(np.int32))
    return paths


def _zero_rows(rng, tile):
    """Rows of signed zeros: at the top of a row, behind one positive
    value, across the threshold of the k_tile best (zeros below many
    positives), across two lanes' ranges (a run of zeros over a lane
    boundary, signs alternating), with +inf and -inf beside them, and a
    row of zeros only, both signs."""
    z = np.float32([0.0, -0.0])
    rows = np.full((6, tile), -np.inf, np.float32)
    rows[0, ::3] = rng.choice(z, len(rows[0, ::3]))
    rows[1] = rng.choice(z, tile)
    rows[1, tile // 3] = 2.0
    rows[2, :] = rng.choice(z, tile)
    rows[2, rng.choice(tile, min(tile, 24), replace=False)] = \
        rng.random(min(tile, 24)).astype(np.float32) + 1.0
    lo = max(tile // 32 - 3, 0)
    rows[3, lo:lo + 7] = np.resize(z, 7)
    rows[3, tile - 1] = -0.0
    rows[4] = rng.choice(np.float32([0.0, -0.0, np.inf, -np.inf, 1.0]),
                         tile)
    rows[5] = rng.choice(z, tile)
    return rows


RULE_CASES = [(tile, k_tile) for tile, k_tile in [
    (512, 16), (512, 1), (512, 32), (512, 512), (256, 16), (1024, 32),
    (128, 16), (100, 100), (97, 10)]]


@pytest.mark.parametrize("tile,k_tile,rule", [
    pytest.param(t, k, r, id=f"{t}-{k}" + ("" if r == "max" else "-own"))
    for t, k in RULE_CASES for r in ("max", "own")
    if r == "max" or t & (t - 1) == 0])
def test_candidate_reduction_equals_successive_maxima(tile, k_tile, rule):
    """The candidate epilogues' per-row reduction, mirrored, by each
    value rule: the order of ``_tile_topk`` (value descending, +0.0 and
    -0.0 tied, lowest lane first, id -1 where not finite) from both of
    its paths, the "max" rule's values held to ``_tile_topk`` and the
    "own" rule's to ``_tile_topk_bitonic`` (power-of-two tiles), over
    rows of distinct values (the gather-and-sort path), a row of one
    value (successive maxima), rows of few values with many ties, -inf
    lanes (deleted docs, zero sums), a row with one finite value, a row
    whose large values crowd into a quarter of the lanes, rows of signed
    zeros and infinities (``_zero_rows``), tiles that are not a multiple
    of 32 or 4, and k_tile up to the whole tile."""
    rng = np.random.default_rng(tile + k_tile)
    rows = rng.choice(np.float32([0.5, 0.25, 1.5, 3.0, 1e-30, 7e20]),
                      (5, tile))
    rows[0] = rng.random(tile).astype(np.float32)
    rows[1] = 1.0                       # one tie over the whole row
    rows[:3, rng.random(tile) < 0.3] = -np.inf
    rows[2, :] = -np.inf
    rows[2, tile // 2] = 2.0
    rows[3] = rng.random(tile).astype(np.float32)
    rows[4] = rng.random(tile).astype(np.float32)
    rows[4, :tile // 4] += 1.0          # the largest in the first lanes
    rows = np.concatenate([rows, _zero_rows(rng, tile)])
    paths = set(_assert_rows_equal_plain(rows, k_tile, 7 * tile, rule))
    if k_tile <= 32 and tile in (128, 256, 512):
        assert "maxima" in paths and "sort32" in paths   # both paths ran


@pytest.mark.parametrize("rule", ["max", "own"])
def test_candidate_reduction_sorts_64_keys(rule):
    """Between 33 and 64 keys pass the threshold (half the lanes hold
    three large keys each): the gathered keys take the 64-element sort,
    in ``_tile_topk``'s order; in a tile clipped to 242 docs the lanes
    share those docs; and where the finite keys sit in the first 242 of
    512 positions (padding docs of norm 0), T from the lanes' two largest
    keys lets 64 or fewer through.  At k_tile 32, 50 keys pass where the
    threshold is a zero: 20 positive lanes, 30 zeros of both signs over
    the other lanes' ranges, 12 of them emitted."""
    tile, base = 512, 1024
    rng = np.random.default_rng(3)
    rows = rng.random((2, tile)).astype(np.float32)
    for lane in range(16):
        rows[0, lane * 16 + rng.choice(16, 3, replace=False)] = \
            np.float32([300, 300.5, 300.25]) + lane
    rows[1, 242:] = -np.inf                        # docs past num_docs
    rows = np.concatenate([rows, rows[1:]])        # ... or padding docs
    paths = _assert_rows_equal_plain(rows, 16, base, rule, [tile, 242, tile])
    assert paths == ["sort64", "sort32", "sort32"]
    zeros = np.full((1, tile), -np.inf, np.float32)
    zeros[0, 16 * np.arange(20) + 3] = 5.0 + np.arange(20)
    at = np.concatenate([16 * np.arange(10, 32), 16 * np.arange(24, 32) + 9])
    zeros[0, at] = np.resize(np.float32([-0.0, 0.0, -0.0]), len(at))
    assert _assert_rows_equal_plain(zeros, 32, base, rule) == ["sort64"]


@pytest.mark.parametrize("width,k_tile,rule", [
    pytest.param(w, k, r, id=f"{w}-{k}" + ("" if r == "max" else "-own"))
    for w, k in [(20, 40), (5, 16), (1, 1), (33, 5)] for r in ("max", "own")])
def test_candidate_reduction_in_a_short_tile(width, k_tile, rule):
    """A tile clipped to fewer docs than k_tile: the reduction walks only
    the docs below num_docs, and the rest of the k_tile slots are
    (-inf, -1), as successive maxima over the whole -inf-padded row give
    them; zeros of both signs among its docs."""
    tile, base = 512, 4096
    rng = np.random.default_rng(width)
    row = np.full(tile, -np.inf, np.float32)
    row[:width] = rng.choice(np.float32([0.5, 2.0, 3.0, 0.0, -0.0]), width)
    row[: width // 3] = -np.inf                    # deleted docs
    _assert_rows_equal_plain(row[None], k_tile, base, rule, [width])


@pytest.mark.parametrize("k_tile", [1, 5, 32])
def test_candidate_reduction_all_zero_rows(k_tile):
    """Rows of zeros only, of mixed signs (one +0.0 first, last, in the
    middle, or none): successive maxima write +0.0 up to the row's last
    +0.0 and -0.0 after it, the sort each lane's own bits; ids in lane
    order either way."""
    tile = 256
    rows = np.full((5, tile), -0.0, np.float32)
    rows[0, 0] = 0.0
    rows[1, tile - 1] = 0.0
    rows[2, 2] = 0.0
    rows[3, ::2] = 0.0
    for rule in ("max", "own"):
        _assert_rows_equal_plain(rows, k_tile, 0, rule)


def test_candidate_reduction_nan_rows():
    """A row holding a NaN (positive or negative, alone, among zeros or
    as its last lane): the "max" rule writes (NaN, -1) in every slot, as
    ``_tile_topk``, whose maximum is then NaN, does; the "own" rule sends
    the CTA to the network, whose output at a NaN depends on positions,
    and the network as the CTA runs it equals ``_tile_topk_bitonic``."""
    tile = 256
    rng = np.random.default_rng(5)
    rows = rng.choice(np.float32([0.5, 2.0, 0.0, -0.0, -np.inf]),
                      (4, tile)).astype(np.float32)
    rows[0, 17] = np.nan
    rows[1, tile - 1] = np.nan
    rows[2, rng.choice(tile, 9, replace=False)] = -np.float32(np.nan)
    rows[3, :] = np.nan
    for k_tile in (1, 16, 64):
        for rule, path in (("max", "nan"), ("own", "network")):
            assert set(_assert_rows_equal_plain(rows, k_tile, 512, rule)) \
                == {path}


try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # pragma: no cover - optional dependency
    st = None

if st is not None:

    @st.composite
    def zero_tiles(draw):
        tile = draw(st.sampled_from([128, 256, 512, 1024]))
        k_tile = draw(st.integers(1, 32))
        width = draw(st.integers(1, tile))
        pool = np.float32([0.0, -0.0, np.inf, -np.inf]
                          + draw(st.lists(st.sampled_from(
                              [0.5, 1.0, 2.0, 1e-30, 3e20]), min_size=1,
                              max_size=3)))
        rng = np.random.default_rng(draw(st.integers(0, 2**16)))
        row = np.full(tile, -np.inf, np.float32)
        row[:width] = rng.choice(pool, width)
        return row, k_tile, width

    @settings(max_examples=25, deadline=None)
    @given(case=zero_tiles(), rule=st.sampled_from(["max", "own"]))
    def test_candidate_reduction_property(case, rule):
        """PROPERTY: rows of 128-1,024 lanes drawn from signed zeros,
        infinities and a few repeated finite values, clipped to a random
        width, at k_tile 1-32: each value rule equals its plain reducer,
        ids and value bits."""
        row, k_tile, width = case
        _assert_rows_equal_plain(row[None], k_tile, 0, rule, [width])


def _keeps(v, l, pv, pl, lo, desc):
    """``BitonicOut::keeps``: whether each position keeps its own element
    rather than take its partner's, by the reference's rule."""
    first = (v > pv) | ((v == pv) & (l < pl))
    return np.where(lo == desc, first, ~first)


def _bitonic_warp_pass(v, l, n, tile, size_lo, size_hi):
    """``BitonicOut::warp_pass``: the flat [q * tile] elements in chunks
    of 32, one per lane; the stages of sizes size_lo..size_hi whose
    strides are below 32 exchange lane with lane ^ stride in a chunk."""
    m = -(-n // 32) * 32
    f = np.arange(m)
    live = f < n
    x = np.zeros(m, np.float32)
    y = np.zeros(m, np.int64)
    x[live], y[live] = v, l
    i = f & (tile - 1)
    size = size_lo
    while size <= size_hi:
        desc = (i & size) == 0
        s = min(size // 2, 16)
        while s >= 1:
            px, py = x[f ^ s], y[f ^ s]
            keep = _keeps(x, y, px, py, (i & s) == 0, desc)
            x, y = np.where(keep, x, px), np.where(keep, y, py)
            s //= 2
        size *= 2
    return x[live], y[live]


def _bitonic_smem_stage(v, l, n, tile, size, stride):
    """``BitonicOut::smem_stage``: pair p joins positions f and f +
    stride, f = ((p >> sh) << (sh + 1)) | (p & (stride - 1)); both read
    before either is written."""
    sh = stride.bit_length() - 1
    p = np.arange(n // 2)
    f = ((p >> sh) << (sh + 1)) | (p & (stride - 1))
    g = f + stride
    desc = ((f & (tile - 1)) & size) == 0
    va, vb, la, lb = v[f], v[g], l[f], l[g]
    ka = _keeps(va, la, vb, lb, True, desc)
    kb = _keeps(vb, lb, va, la, False, desc)
    v, l = v.copy(), l.copy()
    v[f], l[f] = np.where(ka, va, vb), np.where(ka, la, lb)
    v[g], l[g] = np.where(kb, vb, va), np.where(kb, lb, la)
    return v, l


def _bitonic_sort_rows(rows, tile):
    """``BitonicOut::sort_rows`` over [q, tile] rows: block sizes up to 32
    in one register pass, then per larger size its strides >= 32 in
    shared memory and its strides 16..1 in a register pass.  Returns the
    sorted values and lanes [q, tile]."""
    q = rows.shape[0]
    n = q * tile
    v = rows.reshape(-1).copy()
    l = np.arange(n) & (tile - 1)
    v, l = _bitonic_warp_pass(v, l, n, tile, 2, min(tile, 32))
    size = 64
    while size <= tile:
        stride = size // 2
        while stride >= 32:
            v, l = _bitonic_smem_stage(v, l, n, tile, size, stride)
            stride //= 2
        v, l = _bitonic_warp_pass(v, l, n, tile, size, size)
        size *= 2
    return v.reshape(q, tile), l.reshape(q, tile)


@pytest.mark.parametrize("q", [1, 3, 8, 16])
@pytest.mark.parametrize("tile", [1, 2, 8, 32, 64, 256, 512, 1024])
def test_bitonic_epilogue_network_equals_plain(q, tile):
    """The bitonic epilogue's network as the CTA runs it (register passes
    for strides under 32, shared-memory stages above, every row of the
    [q, tile] block at once, chunks that cross rows at tiles under 32)
    equals the plain ``_tile_topk_bitonic`` over the whole tile, values
    to the bit and lanes: over distinct values, ties, -inf lanes and
    zeros of both signs."""
    from repro_torch.kernels import fused_decode_score as tfds
    rng = np.random.default_rng(q * 4096 + tile)
    rows = rng.choice(np.float32([0.5, 0.25, 1.5, 0.0, -0.0, -np.inf]),
                      (q, tile)).astype(np.float32)
    rows[0] = rng.standard_normal(tile).astype(np.float32)
    v, l = _bitonic_sort_rows(rows, tile)
    want_v, want_i = tfds._tile_topk_bitonic(
        torch.from_numpy(rows), torch.zeros(q, dtype=torch.int32), tile,
        tile)
    np.testing.assert_array_equal(v.view(np.int32),
                                  want_v.numpy().view(np.int32))
    np.testing.assert_array_equal(np.where(np.isfinite(v), l, -1),
                                  want_i.numpy())
