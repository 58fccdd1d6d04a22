"""CPU mirrors of two kernels' arithmetic that no CPU can run.

* ``csrc/flash_attention.cu``'s f32 kernel takes its products on the
  tensor cores as 3xTF32: each operand split into hi = tf32(x) (round to
  nearest, ties away: ``cvt.rna.tf32.f32``) and lo = x - hi, of which the
  tensor cores read the top 19 bits, and each product issued as
  lo*hi + hi*lo + hi*hi.  The mirror shows why the split is there: one
  TF32 pass misses the reference's 2e-4 tolerance, three passes keep it,
  also when the logits are 30 times wider.
* ``csrc/unpack_blocks.cu`` stages only the ``ceil(block * bits / 32)``
  words a block holds and decodes ``L`` consecutive lanes per thread of
  a warp, which walks batches of ``G`` blocks with a stride.  The mirror
  checks, for every width 1-1,024 and every bit width 1-32, that each
  lane's words lie inside the staged words and the 16-byte copies inside
  the stage and the row, and that the walk decodes every block once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.layouts import unpack_words  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain)

TOL = 2e-4          # the reference's f32 attention tolerance


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, to nearest,
    ties away from zero (the low 13 bits of the result are 0)."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def tf32_trunc(x):
    """What the tensor cores read of an f32 register given as TF32: its
    top 19 bits."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def split(x):
    """The kernel's ``split_tf32``: hi = tf32(x), lo = x - hi (exact), as
    the tensor cores read them."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def mm_3x(a, b):
    """a @ b from split operands, the small sum apart as in the kernel's
    S = Q K^T; each product of two TF32 values is exact in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_1x(a, b):
    """a @ b in one TF32 pass."""
    return tf32_rna(a) @ tf32_rna(b)


def attention(q, k, v, causal, window, mm):
    """The plain version's attention with its two products taken by
    ``mm``."""
    _, hq, s, d = q.shape
    group = hq // k.shape[1]
    k = k.repeat_interleave(group, 1)
    v = v.repeat_interleave(group, 1)
    logits = mm(q, k.transpose(-1, -2)) * d ** -0.5
    i = torch.arange(s)
    live = torch.ones(s, s, dtype=torch.bool)
    if causal:
        live &= i[None] <= i[:, None]
    if window:
        live &= i[None] > i[:, None] - window
    p = torch.softmax(logits.masked_fill(~live, float("-inf")), -1)
    return mm(torch.nan_to_num(p), v)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 3 * ulp / 2, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         -0.0], dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(100_000)
                         .astype(np.float32) * 1e3)
    hi = tf32_rna(r)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert bool(((hi - r).abs() <= r.abs() * 2.0 ** -11).all())


def test_split_holds_x_to_2e_21():
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(100_000)
                         .astype(np.float32) * 30)
    hi, lo = split(r)
    assert bool(((hi + lo - r).abs() <= r.abs() * 2.0 ** -21).all())
    # one pass keeps only 2^-11 of the value
    assert float(((tf32_rna(r) - r).abs() / r.abs()).max()) > 2.0 ** -13


@pytest.mark.parametrize("wide", [1.0, 30.0])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 4, 2, 256, 64, True, 0),
    (1, 2, 1, 300, 128, True, 100),
    (2, 4, 2, 200, 32, True, 24),
    (1, 2, 2, 130, 16, False, 0)])
def test_three_tf32_passes_keep_the_tolerance_one_does_not(
        b, hq, hkv, s, d, causal, window, wide):
    """Against the plain version in f32: three passes within 2e-4, one
    pass outside it; ``wide`` scales q and k by its root (logits that
    many times wider)."""
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d))
                                .astype(np.float32)) for h in (hq, hkv, hkv))
    q, k = q * wide ** 0.5, k * wide ** 0.5
    want = flash_attention_plain(q, k, v, causal, window)
    three = attention(q, k, v, causal, window, mm_3x)
    torch.testing.assert_close(three, want, rtol=TOL, atol=TOL)
    one = attention(q, k, v, causal, window, mm_1x)
    assert not bool(((one - want).abs() <= TOL + TOL * want.abs()).all())


# ---------------------------------------------------------------------------
# the decoder's word staging and walk
# ---------------------------------------------------------------------------


def lanes_per_thread(block):
    """``unpack_blocks_launch``: the power of two L with block <= 32 L."""
    return next(x for x in (1, 2, 4, 8, 16, 32) if block <= 32 * x)


def blocks_per_step(block):
    """``unpack_blocks_launch``: G blocks per warp step."""
    return {1: 4, 2: 4, 4: 4, 8: 2}.get(lanes_per_thread(block), 1)


def words_read(block, bits, wpb):
    """``load_meta``'s n for each bit width: min(ceil(block bits / 32),
    Wpb), at least 1."""
    need = (block * bits + 31) // 32
    return np.clip(need, 1, wpb)


@pytest.mark.parametrize("first", range(1, 1025, 128))
def test_decode_reads_only_staged_words(first):
    """For widths first..first+127 and bits 1-32, with the row as narrow
    as the widest block needs (Wpb = ceil(block bits / 32) at bits 32,
    and at the block's own bits): every lane's first word lies inside the
    n staged words unclamped; a second word past them is read only by a
    lane that ends inside its first (masked to nothing); the 16-byte
    copies stay inside the stage and the row; the threads' lanes cover
    the block once."""
    bits = np.arange(1, 33)[:, None]
    for block in range(first, first + 128):
        lane = np.arange(block)[None, :]
        big = lanes_per_thread(block)
        cover = np.arange(32)[:, None] * big + np.arange(big)[None, :]
        cover = cover[cover < block]
        assert np.array_equal(np.sort(cover), np.arange(block))
        for wpb in (block, None):
            w = (block * bits + 31) // 32 if wpb is None else \
                np.full_like(bits, wpb)
            n = words_read(block, bits, w)
            assert (n <= block).all() and (n <= w).all()
            bitpos = lane * bits
            wi = bitpos >> 5
            off = bitpos & 31
            assert (wi <= n - 1).all()
            past = (off > 0) & (wi + 1 > n - 1)
            assert ((off + bits <= 32) | ~past).all()
            cap = (np.minimum(w, block) + 3) // 4 * 4
            copied = (n + 3) // 4 * 4
            assert (copied <= cap).all()
            assert ((copied <= w) | (w % 4 != 0)).all()


@pytest.mark.parametrize("block", [1, 7, 33, 100, 128, 1000, 1024])
def test_staged_decode_equals_plain(block):
    """The decode from only the staged words, with its clamp to them, and
    the threads' partial sums plus a warp's exclusive scan equal the
    plain version on the whole row, for every bit width 1-32 (random
    words, bases that wrap int32, counts from 0 to the width)."""
    rng = np.random.default_rng(block)
    nb = 4
    wpb = block + 3
    big = lanes_per_thread(block)
    for bits in range(1, 33):
        words = rng.integers(0, 2**32, size=(nb, wpb), dtype=np.uint32)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
        args = (t(np.full(nb, bits, np.int32)),
                t(np.array([-5, 7, 2**31 - 3, 1000], np.int32)),
                t(np.array([0, block, block // 2, 1], np.int32)))
        want = unpack_words(t(words.view(np.int32)), *args, block)
        n = int(words_read(block, np.array(bits), wpb))
        staged = unpack_words(t(words[:, :n].copy().view(np.int32)), *args,
                              block)
        assert torch.equal(staged, want)
        # per-thread running sums, then the shuffle scan of their totals
        full = unpack_words(t(words.view(np.int32)), args[0], args[1],
                            t(np.full(nb, block, np.int32)), block)
        deltas = (np.diff(full.numpy().astype(np.int64), axis=1,
                          prepend=args[1].numpy()[:, None].astype(np.int64))
                  & 0xFFFFFFFF)
        pad = np.zeros((nb, 32 * big), np.int64)
        pad[:, :block] = deltas
        per = pad.reshape(nb, 32, big)
        run = np.cumsum(per, axis=2)
        excl = np.cumsum(run[:, :, -1], axis=1) - run[:, :, -1]
        docs = (args[1].numpy()[:, None, None].astype(np.int64)
                + excl[:, :, None] + run) & 0xFFFFFFFF
        docs = docs.reshape(nb, -1)[:, :block]
        docs = np.where(docs >= 2**31, docs - 2**32, docs)
        assert np.array_equal(docs, full.numpy())


@pytest.mark.parametrize("nb,ctas,block", [(1, 1, 128), (31, 2, 128),
                                           (200_003, 396, 128),
                                           (30_000, 396, 1000),
                                           (1_000, 3, 256)])
def test_decode_walk_visits_every_block_once(nb, ctas, block):
    """Warp w of the grid starts at batch w and steps by every warp's
    batch: each block of nb is decoded once, also when the walk wraps."""
    warps, g = 8, blocks_per_step(block)
    seen = np.zeros(nb, np.int64)
    stride = ctas * warps * g
    for w in range(ctas * warps):
        for b0 in range(w * g, nb, stride):
            seen[b0:min(b0 + g, nb)] += 1
    assert (seen == 1).all()
