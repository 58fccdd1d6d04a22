"""Port vs reference for the language-model serving path:
``repro_torch.models`` (layers, attention, transformer) and
``repro_torch.configs`` against ``repro.models`` and ``repro.configs``.

Inputs are made from a seed with numpy; the reference's params travel to
the port through ``params_from_numpy`` and its caches through
``cache_from_numpy``.  On the CPU every attention call takes the plain
chunked path (the flash kernel runs only on CUDA tensors).

Tolerances: f32 within 1e-5 relative for the layers and rel-to-max 1e-4
for the models.  bf16 models within rel-to-max 2e-2, against the
reference compiled with ``xla_allow_excess_precision`` off: by default
XLA on the CPU drops the round trips f32 -> bf16 -> f32 between fused
ops (bf16 arithmetic runs in f32 there), so it skips roundings that the
reference's own casts, and the port, make (up to 2.1e-2 apart at the
MLA config); with the option off the two agree to the bit but where a
reduction's order flips one rounding.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

LM_ARCHS = ["gemma3-4b", "minicpm3-4b", "qwen3-0.6b", "mixtral-8x7b",
            "mixtral-8x22b"]
STRICT = {"xla_allow_excess_precision": False}
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, S = 2, 15                       # prefill 15 tokens, decode the 16th


def _t(x, dtype=None):
    t = ttfm.tensor_from_numpy(x, "cpu")
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.float().numpy()


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_layers_match_reference_f32():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    g = rng.normal(size=(16,)).astype(np.float32) * 0.1
    beta = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(3, 5)).astype(np.int32)
    sw = {k: rng.normal(size=sh).astype(np.float32) * 0.2 for k, sh in
          (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    m = jax.tree.map(np.asarray, jax.jit(lambda k: rlayers.init_mlp(
        k, [16, 12, 4]))(jax.random.PRNGKey(3)))
    bases = (10_000.0, 1_000_000.0)

    @jax.jit
    def ref(x, g, beta, sw, m):
        return (rlayers.rms_norm(x, g), rlayers.layer_norm(x, g, beta),
                rlayers.swiglu(sw, x, jnp.float32), rlayers.mlp(m, x))
    # the rotary tables op by op: inside a jit XLA computes ``base **
    # exps`` with its own pow, an ulp off some freqs (7.8e-4 at position
    # 4,096), which the models' tolerances hold
    want = [*ref(x, g, beta, sw, m),
            *[rlayers.rope_freqs(16, b) for b in bases],
            *[rlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), b)
              for b in bases]]
    tx = _t(x)
    got = [tlayers.rms_norm(tx, _t(g)),
           tlayers.layer_norm(tx, _t(g), _t(beta)),
           tlayers.swiglu(ttfm.params_from_numpy(sw, "cpu"), tx,
                          torch.float32),
           tlayers.mlp(ttfm.params_from_numpy(m, "cpu"), tx),
           *[tlayers.rope_freqs(16, b) for b in bases],
           *[tlayers.apply_rope(tx, _t(pos), b) for b in bases]]
    for gv, wv in zip(got, want):
        _close(_np(gv), wv, atol=1e-5)
    assert tlayers.cast(tx, torch.float32) is tx
    assert tlayers.cast(tx, torch.bfloat16).dtype == torch.bfloat16


def test_gru_matches_reference_f32():
    rng = np.random.default_rng(1)
    prm = {k: rng.normal(size=sh).astype(np.float32) * 0.4 for k, sh in
           (("w_x", (6, 24)), ("w_h", (8, 24)), ("b", (24,)))}
    xs = rng.normal(size=(3, 5, 6)).astype(np.float32)
    atts = rng.random(size=(3, 5)).astype(np.float32)
    h0 = rng.normal(size=(3, 8)).astype(np.float32)
    tprm = ttfm.params_from_numpy(prm, "cpu")
    for a in (None, atts):
        want = jax.jit(rlayers.gru_scan)(prm, xs, h0, a)
        got = tlayers.gru_scan(tprm, _t(xs), _t(h0),
                               None if a is None else _t(a))
        for gv, wv in zip(got, want):
            _close(_np(gv), wv)


def test_dense_and_embed_init_scales():
    """The reference's shapes, dtypes and scales (values are the
    generator's own)."""
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(gen, 256, 512)
    e = tlayers.embed_init(gen, 1000, 64)
    assert w.shape == (256, 512) and w.dtype == torch.float32
    assert e.shape == (1000, 64) and e.dtype == torch.float32
    assert abs(float(w.std()) - 256 ** -0.5) < 0.02 * 256 ** -0.5
    assert abs(float(e.std()) - 0.02) < 0.02 * 0.02
    assert abs(float(tlayers.dense_init(gen, 64, 64, scale=3.0).std())
               - 3.0) < 0.1


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,dv", [(True, 0, 16), (True, 5, 16),
                                              (False, 0, 16), (True, 0, 8)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_chunked_attention_plain_path(causal, window, dv, dt):
    """GQA (4 query heads on 2 kv heads), a window, no mask, and Dk != Dv
    (MLA), over 3 query chunks (and the reference's odd-length chunk
    rule at 15)."""
    rdt, tdt, _ = DTYPES[dt]
    rng = np.random.default_rng(2)
    for s, chunk in ((24, 8), (15, 4)):
        q = rng.normal(size=(2, 4, s, 16)).astype(np.float32)
        k = rng.normal(size=(2, 2, s, 16)).astype(np.float32)
        v = rng.normal(size=(2, 2, s, dv)).astype(np.float32)
        want = jax.jit(lambda q, k, v: rattn.chunked_attention(
            q, k, v, causal=causal, window=window, chunk=chunk),
            compiler_options=STRICT)(*(jnp.asarray(x, rdt)
                                       for x in (q, k, v)))
        got = tattn.chunked_attention(*(_t(x, tdt) for x in (q, k, v)),
                                      causal=causal, window=window,
                                      chunk=chunk)
        assert got.dtype == tdt and got.shape == (2, 4, s, dv)
        tol = 1e-5 if dt == "f32" else 1e-2
        _close(_np(got), want, rtol=tol, atol=tol)


def test_chunked_attention_takes_the_kernel_only_on_cuda():
    """The shape rule: CUDA tensors with Dk == Dv go to the flash kernel;
    CPU tensors, and Dk != Dv anywhere, take the plain path and count no
    launch."""
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 1, 8, 16)
    assert not tattn.uses_kernel(q, k, k)
    before = tfa.flash_attention.launches
    tattn.chunked_attention(q, k, k)
    tattn.chunked_attention(q, k, torch.zeros(1, 1, 8, 8))
    assert tfa.flash_attention.launches == before
    meta = torch.empty(1, 2, 8, 16, device="meta")
    assert not tattn.uses_kernel(meta, meta, meta)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_matches_reference(window, dt):
    rdt, tdt, _ = DTYPES[dt]
    rng = np.random.default_rng(3)
    q = rng.normal(size=(3, 4, 1, 16)).astype(np.float32)
    kc = rng.normal(size=(3, 2, 20, 16)).astype(np.float32)
    vc = rng.normal(size=(3, 2, 20, 16)).astype(np.float32)
    cl = np.array([4, 12, 19], np.int32)
    want = jax.jit(lambda q, k, v, c: rattn.decode_attention(
        q, k, v, c, window=window), compiler_options=STRICT)(
        *(jnp.asarray(x, rdt) for x in (q, kc, vc)), jnp.asarray(cl))
    got = tattn.decode_attention(*(_t(x, tdt) for x in (q, kc, vc)),
                                 _t(cl), window=window)
    assert got.dtype == tdt
    tol = 1e-5 if dt == "f32" else 1e-2
    _close(_np(got), want, rtol=tol, atol=tol)


def test_decode_scores_are_f32_products():
    """bf16 operands give f32 scores (as ``preferred_element_type``), not
    bf16-rounded ones."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(1, 1, 1, 64)).astype(
        np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.normal(size=(1, 1, 7, 64)).astype(
        np.float32)).to(torch.bfloat16)
    got = tattn.decode_scores(q, k)
    exact = q.double() @ k.double().transpose(-1, -2)
    assert got.dtype == torch.float32
    assert float((got.double() - exact).abs().max()) < 1e-4
    assert not torch.equal(got, got.to(torch.bfloat16).float())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mla_matches_reference(dt):
    rdt, tdt, _ = DTYPES[dt]
    dims = rattn.MlaDims(n_heads=4, q_lora=32, kv_lora=16, nope=16, rope=8,
                         v_dim=16)
    prm = jax.tree.map(np.asarray, jax.jit(lambda k: rattn.init_mla(
        k, 64, dims))(jax.random.PRNGKey(5)))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    want = jax.jit(lambda p, x: rattn.mla_qkv(p, x, jnp.asarray(pos), dims,
                                              1e4, rdt),
                   compiler_options=STRICT)(prm, jnp.asarray(x))
    tdims = tattn.MlaDims(*dims)
    tprm = ttfm.params_from_numpy(prm, "cpu")
    got = tattn.mla_qkv(tprm, _t(x), _t(pos), tdims, 1e4, tdt)
    tol = 1e-5 if dt == "f32" else 2e-2
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(_np(g), w, rtol=tol, atol=tol)
    c = rng.normal(size=(2, 12, 16)).astype(np.float32)
    kr = rng.normal(size=(2, 12, 8)).astype(np.float32)
    cl = np.array([5, 11], np.int32)
    want = jax.jit(lambda p, x, c, kr, cl: rattn.mla_decode(
        p, x, c, kr, cl, dims, 1e4, rdt), compiler_options=STRICT)(
        prm, jnp.asarray(x[:, :1]), jnp.asarray(c, rdt),
        jnp.asarray(kr, rdt), jnp.asarray(cl))
    got = tattn.mla_decode(tprm, _t(x[:, :1]), _t(c, tdt), _t(kr, tdt),
                           _t(cl), tdims, 1e4, tdt)
    _close(_np(got), want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_params(seed, d=8, e=2, f=16, router=None):
    rng = np.random.default_rng(seed)
    return {"router": (np.eye(d, e, dtype=np.float32) * 10
                       if router is None else router),
            "w_gate": rng.normal(size=(e, d, f)).astype(np.float32),
            "w_up": rng.normal(size=(e, d, f)).astype(np.float32),
            "w_down": rng.normal(size=(e, f, d)).astype(np.float32)}


@pytest.mark.parametrize("case", ["capacity_drop", "gate_ties", "groups",
                                  "groups_not_dividing", "dropless",
                                  "bf16"])
def test_moe_ffn_matches_reference(case):
    """The reference's capacity-drop case (most tokens dropped to zero),
    a zero router (every gate ties: lowest expert first, as
    ``jax.lax.top_k``), two dispatch groups, three groups over 16 tokens
    (not a divisor: one group), decode's dropless path, and bf16."""
    e = 4 if case in ("gate_ties", "groups", "groups_not_dividing",
                      "dropless") else 2
    router = np.zeros((8, e), np.float32) if case == "gate_ties" else (
        np.random.default_rng(9).normal(size=(8, e)).astype(np.float32)
        if e == 4 else None)
    prm = _moe_params(0, e=e, router=router)
    cfg = dict(n_experts=e, top_k=1 if case == "capacity_drop" else 2,
               capacity_factor=0.25 if case == "capacity_drop" else 1.25,
               groups={"groups": 2, "groups_not_dividing": 3}.get(case, 1))
    x = np.random.default_rng(3).normal(size=(16, 8)).astype(np.float32)
    rdt, tdt = (jnp.bfloat16, torch.bfloat16) if case == "bf16" else \
        (jnp.float32, torch.float32)
    dropless = case == "dropless"
    want = jax.jit(lambda p, x: rtfm._moe_ffn(
        p, x, rtfm.MoeConfig(**cfg), rdt, dropless=dropless),
        compiler_options=STRICT)(prm, jnp.asarray(x))
    got = ttfm._moe_ffn(ttfm.params_from_numpy(prm, "cpu"), _t(x),
                        ttfm.MoeConfig(**cfg), tdt, dropless=dropless)
    assert got.shape == x.shape and got.dtype == torch.float32
    tol = 2e-2 if case == "bf16" else 1e-5
    _close(_np(got), want, rtol=tol, atol=tol)
    if case == "capacity_drop":
        # 0.25 * 16 / 2 = 2 slots an expert: most tokens dropped (zero)
        assert int((got.abs().sum(-1) == 0).sum()) >= 8


def test_top_k_stable_breaks_ties_lowest_index_first():
    x = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]])
    v, i = ttfm.top_k_stable(x, 2)
    rv, ri = jax.lax.top_k(jnp.asarray(x.numpy()), 2)
    assert i.tolist() == np.asarray(ri).tolist() == [[0, 1], [1, 2]]
    assert v.tolist() == np.asarray(rv).tolist()


# ---------------------------------------------------------------------------
# the models, per arch
# ---------------------------------------------------------------------------


_REF_PARAMS = {}


def _ref_params(arch_id, seed):
    """The reference's smoke params (f32 masters, whatever the compute
    dtype), as numpy, made once per (arch, seed)."""
    if (arch_id, seed) not in _REF_PARAMS:
        cfg = rconfigs.get_arch(arch_id).make_config("smoke")
        _REF_PARAMS[arch_id, seed] = jax.tree.map(np.asarray, jax.jit(
            lambda k: rtfm.init_params(k, cfg))(jax.random.PRNGKey(seed)))
    return _REF_PARAMS[arch_id, seed]


def _cfgs(arch_id, dt):
    rdt, tdt, _ = DTYPES[dt]
    rcfg = dataclasses.replace(
        rconfigs.get_arch(arch_id).make_config("smoke"), dtype=rdt)
    tcfg = dataclasses.replace(
        tconfigs.get_arch(arch_id).make_config("smoke"), dtype=tdt)
    return rcfg, tcfg


@pytest.fixture(scope="module")
def served():
    """Per (arch, dtype): both packages' prefill of 15 tokens and one
    decode step of the 16th from the REFERENCE's padded prefill cache,
    the same weights on both sides."""
    memo = {}

    def get(arch_id, dt):
        if (arch_id, dt) in memo:
            return memo[arch_id, dt]
        rcfg, tcfg = _cfgs(arch_id, dt)
        co = STRICT if dt == "bf16" else None
        rp = _ref_params(arch_id, 1)
        tp = ttfm.params_from_numpy(rp, "cpu")
        toks = np.random.default_rng(2).integers(
            0, rcfg.vocab, (B, S + 1)).astype(np.int32)

        def ref(p, t):
            pre = rtfm.prefill(p, rcfg, t[:, :S])
            cache = rtfm.pad_cache(pre.cache, S + 1, rcfg)
            return pre, cache, rtfm.decode_step(p, rcfg, cache, t[:, S:],
                                                pre.cache_len)
        rpre, rcache, rdec = jax.jit(ref, compiler_options=co)(
            rp, jnp.asarray(toks))
        tpre = ttfm.prefill(tp, tcfg, _t(toks[:, :S]))
        tcache = ttfm.cache_from_numpy([np.asarray(c) for c in rcache],
                                       "cpu")
        tdec = ttfm.decode_step(tp, tcfg, tcache, _t(toks[:, S:]),
                                _t(np.asarray(rpre.cache_len)))
        memo[arch_id, dt] = (rpre, rdec, tpre, tdec, rcfg, tcfg)
        return memo[arch_id, dt]
    return get


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_prefill_matches_reference(served, arch_id, dt):
    rpre, _, tpre, _, _, tcfg = served(arch_id, dt)
    tol = DTYPES[dt][2]
    assert tpre.logits.dtype == torch.float32
    assert tpre.logits.shape == rpre.logits.shape
    assert _rel(_np(tpre.logits), rpre.logits) < tol, arch_id
    assert np.isfinite(_np(tpre.logits)).all()
    assert tpre.cache_len.tolist() == np.asarray(rpre.cache_len).tolist()
    for got, want in zip(tpre.cache, rpre.cache):
        assert got.dtype == tcfg.dtype and tuple(got.shape) == want.shape
        assert _rel(_np(got), want) < tol, arch_id


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_decode_step_matches_reference(served, arch_id, dt):
    _, rdec, _, tdec, _, _ = served(arch_id, dt)
    tol = DTYPES[dt][2]
    logits, cache, cache_len = tdec
    assert _rel(_np(logits), rdec[0]) < tol, arch_id
    assert cache_len.tolist() == np.asarray(rdec[2]).tolist()
    for got, want in zip(cache, rdec[1]):
        assert _rel(_np(got), want) < tol, arch_id


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_prefill_then_decode_equals_longer_prefill(arch_id):
    """The reference's serving smoke protocol on the port: prefill(16)
    against prefill(15) + pad_cache + decode_step (MoE capacity raised so
    it does not bind), within 1e-3 (GQA) or 2e-2 (MLA's absorbed
    decode)."""
    cfg = tconfigs.get_arch(arch_id).make_config("smoke", "decode_32k")
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    params = ttfm.init_params(1, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    full = ttfm.prefill(params, cfg, toks)
    part = ttfm.prefill(params, cfg, toks[:, :15])
    cache = ttfm.pad_cache(part.cache, 16, cfg)
    logits, _, _ = ttfm.decode_step(params, cfg, cache, toks[:, 15:16],
                                    part.cache_len)
    tol = 2e-2 if cfg.attn == "mla" else 1e-3
    assert _rel(_np(logits), _np(full.logits)) < tol, arch_id
    assert torch.isfinite(logits).all()


def test_embed_scale_is_rounded_to_the_model_dtype():
    """sqrt(2560) multiplies the rows as the bf16 value 50.5 (the
    reference's ``jnp.asarray(embed_scale, dtype)``), not as 50.596."""
    cfg = dataclasses.replace(
        tconfigs.get_arch("gemma3-4b").make_config("smoke"),
        embed_scale=2560 ** 0.5)
    params = {"embed": torch.from_numpy(np.random.default_rng(6).normal(
        size=(64, 8)).astype(np.float32))}
    toks = torch.arange(64).reshape(8, 8)
    got = ttfm._embed(params, cfg, toks)
    rows = np.asarray(jnp.asarray(params["embed"].numpy(), jnp.bfloat16))
    want = np.asarray((jnp.asarray(rows)[toks.numpy()] *
                       jnp.asarray(2560 ** 0.5, jnp.bfloat16)
                       ).astype(jnp.float32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    unrounded = (torch.from_numpy(rows.astype(np.float32))[toks]
                 * 2560 ** 0.5).to(torch.bfloat16).float()
    assert not torch.equal(got, unrounded)


def test_loss_matches_reference_f32():
    rcfg, tcfg = _cfgs("qwen3-0.6b", "f32")
    rp = _ref_params("qwen3-0.6b", 4)
    tp = ttfm.params_from_numpy(rp, "cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, rcfg.vocab, (2, 40)).astype(np.int32)
    labels = rng.integers(0, rcfg.vocab, (2, 40)).astype(np.int32)
    want = jax.jit(lambda p: rtfm.loss_fn(
        p, rcfg, {"tokens": jnp.asarray(toks),
                  "labels": jnp.asarray(labels)}))(rp)
    got = ttfm.loss_fn(tp, tcfg, {"tokens": _t(toks), "labels": _t(labels)})
    _close(float(got), float(want), rtol=1e-5)
    # chunked_xent alone, at the reference's odd-length chunk rule
    h = rng.normal(size=(2, 12, 64)).astype(np.float32)
    w = rng.normal(size=(64, 512)).astype(np.float32)
    want = rtfm.chunked_xent(jnp.asarray(h), jnp.asarray(w),
                             jnp.asarray(labels[:, :12]), 8, jnp.float32)
    got = ttfm.chunked_xent(_t(h), _t(w), _t(labels[:, :12]), 8,
                            torch.float32)
    _close(float(got), float(want), rtol=1e-5)


def test_ring_cache_matches_full_cache():
    """The reference's protocol on the port: a window-sized ring cache
    decodes as a full-length cache once the window wraps (24 steps,
    window 8), within 2e-3."""
    cfg_full = ttfm.TransformerConfig(
        name="swa", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
        head_dim=16, d_ff=64, vocab=128, window=8, global_every=0,
        chunk_q=8, loss_chunk=8, ring_cache=False)
    cfg_ring = dataclasses.replace(cfg_full, ring_cache=True)
    params = ttfm.init_params(0, cfg_full, device="cpu")
    steps = 24
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 128, (2, steps)).astype(np.int32))

    def run(cfg):
        cache = ttfm.init_cache(cfg, 2, steps, device="cpu")
        cl = torch.zeros(2, dtype=torch.int32)
        outs = []
        for i in range(steps):
            logits, cache, cl = ttfm.decode_step(params, cfg, cache,
                                                 toks[:, i:i + 1], cl)
            outs.append(logits)
        return torch.stack(outs), cache

    full, _ = run(cfg_full)
    ring, ring_cache = run(cfg_ring)
    assert ttfm.cache_slots(cfg_ring, steps) == 8
    assert ring_cache[0].shape[3] == 8
    np.testing.assert_allclose(ring.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_gemma3_local_global_pattern():
    cfg = tconfigs.get_arch("gemma3-4b").make_config("full")
    pat = cfg.layer_is_global()
    assert isinstance(pat, list) and len(pat) == 34
    assert sum(pat) == 34 // 6                # every 6th layer is global
    assert not any(pat[:5]) and pat[5]        # 5 local then 1 global
    ref = rconfigs.get_arch("gemma3-4b").make_config("full")
    assert pat == np.asarray(ref.layer_is_global()).tolist()
    for arch_id in LM_ARCHS:
        for scale in ("full", "smoke"):
            assert tconfigs.get_arch(arch_id).make_config(
                scale).layer_is_global() == np.asarray(
                rconfigs.get_arch(arch_id).make_config(
                    scale).layer_is_global()).tolist()


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_init_params_shapes_dtypes_scales(arch_id):
    """The reference's tree, leaf for leaf: names, shapes, dtypes; zero
    leaves zero, drawn leaves at the reference's scale."""
    rcfg = rconfigs.get_arch(arch_id).make_config("smoke")
    tcfg = tconfigs.get_arch(arch_id).make_config("smoke")
    rp = _ref_params(arch_id, 1)
    tp = ttfm.init_params(0, tcfg, device="cpu")
    rpaths = dict(tbase._paths(rp))
    tpaths = dict(tbase._paths(tp))
    assert sorted(rpaths) == sorted(tpaths)
    for path, want in rpaths.items():
        got = tpaths[path]
        assert tuple(got.shape) == want.shape, path
        assert got.dtype == torch.float32 and want.dtype == np.float32
        if not want.any():
            assert not got.any(), path
        else:
            ws, gs = float(want.std()), float(got.std())
            assert abs(gs - ws) < 0.15 * ws, (path, gs, ws)
    assert tcfg.param_count(tp) == sum(x.size for x in rpaths.values())
    assert tbase.lm_active_params(tp, tcfg) == \
        tbase.lm_active_params(rp, tcfg)


def test_lm_active_params_matches_reference():
    """Active parameters of each full config, counted from the shapes of
    the reference's tree (``jax.eval_shape``), as the reference counts
    them."""
    from repro.configs import base as rbase
    for arch_id in LM_ARCHS:
        rcfg = rconfigs.get_arch(arch_id).make_config("full")
        tcfg = tconfigs.get_arch(arch_id).make_config("full")
        p_abs = jax.eval_shape(lambda: rtfm.init_params(
            jax.random.PRNGKey(0), rcfg))
        assert tbase.lm_active_params(p_abs, tcfg) == \
            rbase.lm_active_params(p_abs, rcfg)


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in ("dtype", "residual_dtype"):
            v = str(v).replace("torch.", "").replace("<class 'jax.numpy.",
                                                     "").strip("'>")
            v = {"float32": "float32", "bfloat16": "bfloat16"}.get(v, v)
        elif dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        elif isinstance(v, tuple):
            v = tuple(v)
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_arch_configs_match_reference(arch_id):
    """``make_config`` at both scales, field by field, and each ArchDef's
    shapes, smoke shapes, kind and source."""
    rarch, tarch = rconfigs.get_arch(arch_id), tconfigs.get_arch(arch_id)
    assert list(tconfigs.ARCHS) == list(rconfigs.ARCHS)   # all ten archs
    for scale in ("full", "smoke"):
        assert _fields(tarch.make_config(scale)) == \
            _fields(rarch.make_config(scale))
    assert (tarch.arch_id, tarch.kind, tarch.shapes, tarch.smoke_shapes,
            tarch.source) == (rarch.arch_id, rarch.kind, rarch.shapes,
                              rarch.smoke_shapes, rarch.source)
    assert tarch.shape_ids() == rarch.shape_ids()


def test_paper_index_config_matches_reference():
    from repro.configs import paper_index as rpaper
    from repro_torch.configs import paper_index as tpaper
    r, t = rpaper.PAPER, tpaper.PAPER
    assert dataclasses.asdict(t.collection) == \
        dataclasses.asdict(r.collection)
    assert dataclasses.asdict(t.bench_spec) == \
        dataclasses.asdict(r.bench_spec)
    for f in ("representations", "query_terms", "query_df_band", "topk",
              "repeats"):
        assert getattr(t, f) == getattr(r, f)


def test_params_from_numpy_carries_bf16_bits():
    x = jnp.asarray(np.random.default_rng(8).normal(size=(5, 7)),
                    jnp.bfloat16)
    got = ttfm.params_from_numpy({"a": {"w": x}, "b": [x[0]]}, "cpu")
    assert got["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["a"]["w"].view(torch.int16).numpy(),
        np.asarray(x).view(np.int16))
    assert isinstance(got["b"], list) and got["b"][0].shape == (7,)


def test_transformer_module_wraps_the_functions():
    """The module registers the stacked tensors under the reference's
    names, its methods equal the functions on the same dict, and asking
    for CUDA without a card raises."""
    cfg = tconfigs.get_arch("qwen3-0.6b").make_config("smoke")
    model = ttfm.Transformer(cfg, seed=3, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert {"embed", "attn.wq", "attn.q_gamma", "mlp.w_gate",
            "pre_attn_norm", "final_norm"} <= names
    assert not any(p.requires_grad for p in model.parameters())
    params = model.params()
    assert params["attn"]["wq"] is model.attn["wq"]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 9)).astype(np.int32))
    got = model.prefill(toks)
    want = ttfm.prefill(params, cfg, toks)
    assert torch.equal(got.logits, want.logits)
    cache = ttfm.pad_cache(got.cache, 12, cfg)
    logits, _, n = model.decode_step(cache, toks[:, :1], got.cache_len)
    assert logits.shape == (2, cfg.vocab) and n.tolist() == [10, 10]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ttfm.Transformer(cfg)
        with pytest.raises(RuntimeError):
            ttfm.init_params(0, cfg)
