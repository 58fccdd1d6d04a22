"""The port's model kernels against the reference, on the CPU.

``embedding_bag_plain`` and ``pna_multi_agg_plain`` (the plain versions
of the CUDA kernels) must equal ``embedding_bag_pallas`` and
``pna_multi_agg_pallas`` in interpret mode to the bit, and the reference
functions (``ref_embedding_bag``, ``ref_pna_multi_agg``, the model's
ragged ``segments.embedding_bag``) within their own tests' tolerances.
``flash_attention_plain`` must hold to ``ref_attention``, to
``flash_attention_pallas`` in interpret mode and to the model's
``chunked_attention`` within 2e-4 in f32 and 3e-2 in bf16.  Inputs are
made with numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.segment_multi_agg import pna_multi_agg_pallas  # noqa: E402
from repro.models import recsys  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro.train.data import xdeepfm_batch  # noqa: E402
from repro_torch.kernels import embedding_bag as tbag  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import segment_multi_agg as tpna  # noqa: E402


def _bits(x):
    """f32 bit pattern of a torch or jax array (bf16 widened exactly)."""
    a = x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x).astype(np.float32)
    return a.view(np.int32)


def _torch(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _jax(a, dtype):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if dtype == "bf16" else x


# ---------------------------------------------------------------------------
# embedding bag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v,d,b,h,dtype", [
    (100, 8, 32, 4, "f32"),
    (500, 16, 64, 7, "f32"),
    (50, 32, 16, 2, "bf16"),
    (300, 10, 48, 8, "bf16"),
])
def test_bag_plain_equals_pallas(v, d, b, h, dtype):
    """Bit-equal to the Pallas kernel (slot order, one rounding to the
    table's dtype per add), with rows of mixed magnitude so that bf16
    rounds often, a bag of padding only and a bag with no padding."""
    rng = np.random.default_rng(v + b)
    tab = (rng.normal(size=(v, d)) * rng.choice(
        [1.0, 300.0, 1e-3], size=(v, 1))).astype(np.float32)
    idx = rng.integers(-1, v, size=(b, h)).astype(np.int32)
    idx[0] = -1
    idx[1] = rng.integers(0, v, size=h)
    want = embedding_bag_pallas(_jax(tab, dtype), jnp.asarray(idx),
                                tile_b=16, interpret=True)
    got = tbag.embedding_bag(_torch(tab, dtype), torch.from_numpy(idx))
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not _bits(got)[0].any()                 # +0.0, not -0.0
    if dtype == "f32":
        ref = rref.ref_embedding_bag(jnp.asarray(tab), jnp.asarray(idx))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


def test_bag_matches_xdeepfm_multihot_embedding():
    """The port's bag over xDeepFM's fused field table equals the model's
    ragged EmbeddingBag (``segments.embedding_bag`` inside
    ``_xdeepfm_embed``) on a smoke table and a multi-hot batch; the
    table's row padding and the field offsets are the model's."""
    cfg = recsys.XDeepFmConfig(n_fields=6, field_vocab=100, embed_dim=8,
                               cin_layers=(12, 12), mlp_dims=(16, 8),
                               n_hot=4)
    params = recsys.init_xdeepfm(jax.random.PRNGKey(0), cfg)
    table = np.array(params["tables"])
    assert table.shape[0] == tbag.padded_rows(6 * 100) == \
        recsys.padded_rows(6 * 100)
    sparse = xdeepfm_batch(0, 3, 16, 6, 100, n_hot=4)["sparse"]
    want, _ = recsys._xdeepfm_embed(params, cfg, jnp.asarray(sparse))
    ids = tbag.field_ids(torch.from_numpy(sparse), 100)
    np.testing.assert_array_equal(
        ids.numpy(), sparse + (np.arange(6) * 100)[None, :, None])
    got = tops.embedding_bag(torch.from_numpy(table), ids.reshape(16 * 6, 4))
    np.testing.assert_allclose(got.reshape(16, 6, 8).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    one_hot = tbag.field_ids(torch.from_numpy(sparse[:, :, 0]), 100)
    np.testing.assert_array_equal(one_hot.numpy(), ids[:, :, 0].numpy())


# ---------------------------------------------------------------------------
# PNA aggregation
# ---------------------------------------------------------------------------


def _graph(n, k, d, nsrc, seed):
    rng = np.random.default_rng(seed)
    feats = (rng.normal(size=(nsrc, d)) * rng.choice(
        [1.0, 7.0, 1e-2], size=(nsrc, 1))).astype(np.float32)
    nbr = rng.integers(-1, nsrc, size=(n, k)).astype(np.int32)
    nbr[3] = -1                                    # a node with no neighbour
    return feats, nbr


@pytest.mark.parametrize("n,k,d,nsrc", [(32, 5, 8, 100), (64, 9, 16, 64),
                                        (32, 16, 75, 200)])
def test_pna_plain_equals_pallas(n, k, d, nsrc):
    """Bit-equal to the Pallas kernel, a node with no neighbour included
    (0 for min and max, sqrt(eps) for std), and within 1e-5 of
    ``ref_pna_multi_agg``."""
    feats, nbr = _graph(n, k, d, nsrc, n + k)
    want = pna_multi_agg_pallas(jnp.asarray(feats), jnp.asarray(nbr),
                                tile_n=32, interpret=True)
    got = tops.pna_multi_agg(torch.from_numpy(feats), torch.from_numpy(nbr))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    row = got[3].numpy()
    assert not row[:3 * d].any()
    np.testing.assert_array_equal(row[3 * d:], np.float32(np.sqrt(
        np.float32(1e-5))))
    ref = rref.ref_pna_multi_agg(jnp.asarray(feats), jnp.asarray(nbr))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_pna_pins_xla_fma_contraction():
    """XLA contracts both multiply-adds of the Pallas kernel on the CPU,
    ``ssq + row * row`` and ``ssq / n - mean * mean``: the same sums with
    the products rounded first differ from the kernel on this input, and
    the port's plain version (two FMAs) does not."""
    feats, nbr = _graph(64, 9, 16, 100, 0)
    want = _bits(pna_multi_agg_pallas(jnp.asarray(feats), jnp.asarray(nbr),
                                      tile_n=32, interpret=True))
    got = tpna.pna_multi_agg_plain(torch.from_numpy(feats),
                                   torch.from_numpy(nbr))
    np.testing.assert_array_equal(_bits(got), want)
    # the std column with either product rounded before its add
    x = feats[np.maximum(nbr, 0)]
    ok = (nbr >= 0)[..., None]
    s = np.zeros((64, 16), np.float32)
    ssq_fma, ssq_mul = s.copy(), s.copy()
    for h in range(9):
        row, o = x[:, h], ok[:, h]
        s = np.where(o, s + row, s)
        ssq_fma = np.where(o, (row.astype(np.float64) ** 2 + ssq_fma)
                           .astype(np.float32), ssq_fma)
        ssq_mul = np.where(o, ssq_mul + row * row, ssq_mul)
    n = np.maximum(ok.sum(1), 1).astype(np.float32)
    mean = s / n

    def std(ssq, fuse_var):
        a = ssq / n
        var = ((a.astype(np.float64) - mean.astype(np.float64) ** 2)
               .astype(np.float32) if fuse_var else a - mean * mean)
        return np.sqrt(np.maximum(var, 0) + np.float32(1e-5))
    col = want.reshape(64, 64)[:, 48:]
    assert (std(ssq_mul, True).view(np.int32) != col).any()
    assert (std(ssq_fma, False).view(np.int32) != col).any()


def test_pna_signed_zeros_and_chunks(monkeypatch):
    """min and max order -0.0 below +0.0, as XLA does, and the plain
    version gives the same bits in node chunks as in one piece."""
    feats = np.array([[0.0, -0.0, 1.0], [-0.0, 0.0, -0.0]], np.float32)
    nbr = np.array([[0, 1], [1, 0], [-1, 1], [0, -1]], np.int32)
    want = pna_multi_agg_pallas(jnp.asarray(feats), jnp.asarray(nbr),
                                tile_n=4, interpret=True)
    got = tpna.pna_multi_agg_plain(torch.from_numpy(feats),
                                   torch.from_numpy(nbr))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.signbit(got[0, 3:5].numpy()).all()
    assert not np.signbit(got[0, 6:8].numpy()).any()
    feats, nbr = _graph(40, 6, 8, 50, 1)
    whole = tpna.pna_multi_agg_plain(torch.from_numpy(feats),
                                     torch.from_numpy(nbr))
    monkeypatch.setattr(tpna, "CHUNK_BYTES", 6 * 8 * 4 * 7)   # 7 nodes
    parts = tpna.pna_multi_agg_plain(torch.from_numpy(feats),
                                     torch.from_numpy(nbr))
    np.testing.assert_array_equal(_bits(parts), _bits(whole))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _qkv(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("causal,window,b,hq,hkv,s,d,dtype", [
    (True, 0, 2, 4, 2, 64, 16, "f32"),
    (True, 24, 2, 4, 4, 64, 16, "f32"),
    (False, 0, 2, 2, 1, 32, 32, "f32"),
    (False, 16, 1, 4, 2, 48, 16, "f32"),
    (True, 16, 1, 8, 2, 64, 16, "bf16"),
    (True, 0, 2, 2, 1, 32, 32, "bf16"),
])
def test_attention_plain_matches_reference(causal, window, b, hq, hkv, s, d,
                                           dtype):
    """Within 2e-4 (f32) or 3e-2 (bf16) of ``ref_attention`` and of the
    Pallas kernel in interpret mode, over causal, windowed, non-causal
    and GQA cases; the output keeps q's dtype."""
    q, k, v = _qkv(b, hq, hkv, s, d, s + hq)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    got = tops.attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == (b, hq, s, d)
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    tol = 3e-2 if dtype == "bf16" else 2e-4
    for want in (rref.ref_attention(jq, jk, jv, causal=causal, window=window),
                 flash_attention_pallas(jq, jk, jv, causal=causal,
                                        window=window, block_q=16,
                                        block_k=16, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("window", [0, 24])
def test_attention_plain_matches_chunked_model_attention(window,
                                                         monkeypatch):
    """Within 2e-4 of the transformers' ``chunked_attention``; the plain
    version's query chunks give the same bits as one piece."""
    q, k, v = _qkv(2, 4, 2, 64, 16, 0)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window, chunk=16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    monkeypatch.setattr(tfa, "CHUNK_BYTES", 2 * 4 * 64 * 4 * 16)  # 16 rows
    parts = tfa.flash_attention_plain(tq, tk, tv, True, window)
    np.testing.assert_array_equal(_bits(parts), _bits(got))


def _wgmma_tiling_mirror(q, k, v, causal, window, split=True):
    """A mirror of the bf16 kernel's arithmetic (``flash_bf16_kernel``):
    64-row query tiles, each over the 64-key tiles of its live frontier;
    logits in f32 scaled by log2(e) / sqrt(D), masked to -1e30; the
    online softmax in f32 in log2 units (p = 2^(x - m), masked p = 0,
    per-tile sums); p split into hi = bf16(p) and lo = bf16(p - hi), both
    multiplied by V with f32 accumulation (``split=False``: hi alone);
    out = acc / max(l, 1e-30) rounded to bf16.  q, k, v: bf16 torch
    tensors [B, H, S, D]."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale_log2 = np.float32(1.4426950408889634 / np.sqrt(d))
    neg = torch.tensor(-1e30)
    out = torch.empty(b, hq, s, d)
    for q0 in range(0, s, 64):
        rows = torch.arange(q0, min(q0 + 64, s))[:, None]
        hi = min(s, q0 + 64) if causal else s
        lo = max(0, q0 - window + 1) if window > 0 else 0
        m = torch.full((b, hq, rows.shape[0], 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, hq, rows.shape[0], d)
        for k0 in range(lo // 64 * 64, hi, 64):
            keys = torch.arange(k0, min(k0 + 64, s))[None, :]
            x = (qf[:, :, q0:q0 + 64] @ kf[:, :, k0:k0 + 64].transpose(-1, -2)
                 ) * scale_log2
            live = torch.ones(rows.shape[0], keys.shape[1], dtype=torch.bool)
            if causal:
                live &= keys <= rows
            if window > 0:
                live &= keys > rows - window
            x = torch.where(live, x, neg)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.where(live, torch.exp2(x - m_new), 0.0)
            l = alpha * l + p.sum(-1, keepdim=True)
            p_hi = p.bfloat16().float()
            p_lo = (p - p_hi).bfloat16().float() if split else 0 * p
            vt = vf[:, :, k0:k0 + 64]
            acc = acc * alpha + p_hi @ vt + p_lo @ vt
            m = m_new
        out[:, :, q0:q0 + 64] = acc / l.clamp_min(1e-30)
    return out.bfloat16()


@pytest.mark.parametrize("causal,window,s,d", [
    (True, 0, 192, 64),
    (True, 64, 200, 64),
    (True, 0, 200, 256),
    (True, 64, 192, 256),
    (False, 64, 200, 64),
])
def test_bf16_tensor_core_tiling_matches_reference(causal, window, s, d):
    """The bf16 kernel's tiling and arithmetic, mirrored on the CPU (GQA
    2:1): within 3e-2 of ``ref_attention`` and of the Pallas kernel in
    interpret mode, and within one bf16 rounding (rtol 8e-3, atol 1e-3)
    of the plain version run in f32, the check the kernel is held to on
    the card.  P rounded to bf16 alone would not pass the last one at
    S = 4,096; its two bf16 halves hold it within a rounding."""
    q, k, v = _qkv(1, 4, 2, s, d, s + d + window)
    tq, tk, tv = (_torch(a, "bf16") for a in (q, k, v))
    got = _wgmma_tiling_mirror(tq, tk, tv, causal, window).float().numpy()
    jq, jk, jv = (_jax(a, "bf16") for a in (q, k, v))
    blk = 64 if s % 64 == 0 else 40     # the Pallas grid needs S % blk == 0
    for want in (rref.ref_attention(jq, jk, jv, causal=causal, window=window),
                 flash_attention_pallas(jq, jk, jv, causal=causal,
                                        window=window, block_q=blk,
                                        block_k=blk, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=3e-2, atol=3e-2)
    f32 = tfa.flash_attention_plain(tq.float(), tk.float(), tv.float(),
                                    causal=causal, window=window)
    np.testing.assert_allclose(got, f32.bfloat16().float().numpy(),
                               rtol=8e-3, atol=1e-3)


def test_bf16_p_needs_both_halves_at_qwen3_length():
    """Why the kernel issues two P V products: at S = 4,096 (Qwen3's
    train_4k, D = 128, two heads) p rounded to bf16 alone moves some
    outputs by more than one bf16 rounding of the f32 result; hi + lo
    moves none."""
    q, k, v = _qkv(1, 2, 1, 4096, 128, 4096)
    tq, tk, tv = (_torch(a, "bf16") for a in (q, k, v))
    f32 = tfa.flash_attention_plain(tq.float(), tk.float(), tv.float(),
                                    causal=True).bfloat16().float()
    limit = 1e-3 + 8e-3 * f32.abs()
    for split, want_over in ((True, False), (False, True)):
        got = _wgmma_tiling_mirror(tq, tk, tv, True, 0, split).float()
        assert bool(((got - f32).abs() > limit).any()) == want_over, split


# ---------------------------------------------------------------------------
# the entry points take any view, as the reference's do
# ---------------------------------------------------------------------------


def test_entry_points_take_views_like_the_reference():
    """``ops.embedding_bag``, ``ops.pna_multi_agg`` and ``ops.attention``
    on transposed and offset views give the reference entry points'
    results on the same values, to the bit (bag, PNA) or within 2e-4
    (attention, f32); on the CPU ``kernel_ready`` passes a tensor through
    as it is (the card's copies are tested in ``test_torch_cuda.py``)."""
    from repro.kernels import ops as rops
    rng = np.random.default_rng(5)
    table = rng.normal(size=(24, 80)).astype(np.float32).T     # [80, 24]
    idx = rng.integers(-1, 80, size=(6, 40)).astype(np.int32).T
    feats, nbr = _graph(40, 6, 12, 90, 1)
    q = rng.normal(size=(1, 70, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(1, 70, 2, 32)).astype(np.float32)
            for _ in range(2))
    views = {
        "bag": (torch.from_numpy(table.T).t(), torch.from_numpy(idx.T).t()),
        "pna": (torch.from_numpy(np.concatenate(
            [np.zeros((1, 12), np.float32), feats]))[1:],
            torch.from_numpy(nbr.T.copy()).t()),
        "attn": tuple(torch.from_numpy(x).transpose(1, 2)
                      for x in (q, k, v))}
    assert not views["bag"][0].is_contiguous()
    assert all(tops.kernel_ready(t) is t for vs in views.values()
               for t in vs)
    got = tops.embedding_bag(*views["bag"])
    want = rops.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                              backend="xla")
    np.testing.assert_array_equal(_bits(got), _bits(want))
    got = tops.pna_multi_agg(*views["pna"])
    want = pna_multi_agg_pallas(jnp.asarray(feats), jnp.asarray(nbr),
                                tile_n=8, interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    got = tops.attention(*views["attn"], causal=True, window=0)
    want = rops.attention(*(jnp.asarray(x).transpose(0, 2, 1, 3)
                            for x in (q, k, v)), causal=True, window=0,
                          backend="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
