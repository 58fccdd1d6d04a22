"""Port vs reference for the recsys models (``repro_torch.models.recsys``
against ``repro.models.recsys``) and the bodies of the recsys cells
(``configs.base.recsys_serve_fn`` / ``recsys_retrieval_fn`` against the
reference cell's ``fn``), at the smoke configs, on the CPU, where
xDeepFM's lookups run ``embedding_bag_plain``.

The reference's params travel to the port through
``transformer.params_from_numpy``.  Tolerances: hidden states, logits,
user vectors and loss values within rel-to-max 1e-4 (f32: XLA and torch
order a matmul's adds differently); top-k ids equal and their scores
within rtol 1e-5, but where the cells' user vectors (computed by each
library) meet adjacent scores within 1e-5 relative, which may swap.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.configs import base as rbase  # noqa: E402
from repro.models import recsys as rrec  # noqa: E402
from repro.train import data as rdata  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import embedding_bag as tbag  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

REC_ARCHS = ["sasrec", "bert4rec", "dien", "xdeepfm"]
TOL = 1e-4


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _cfgs(arch_id, n_hot=1):
    r = rconfigs.get_arch(arch_id).make_config("smoke", "serve_p99")
    t = tconfigs.get_arch(arch_id).make_config("smoke", "serve_p99")
    if n_hot != 1:
        r = dataclasses.replace(r, n_hot=n_hot)
        t = dataclasses.replace(t, n_hot=n_hot)
    return r, t


def _params(arch_id, rcfg, seed=3):
    rp = rbase._REC_INIT[arch_id](jax.random.PRNGKey(seed), rcfg)
    return rp, ttfm.params_from_numpy(rp, "cpu")


def _inputs(arch_id, cfg, b, seed=0):
    """Serve inputs for ``b`` users: histories with padding (item 0) at
    the front of some rows and, past one user, a row of padding only;
    BERT4Rec's last position is [MASK]."""
    rng = np.random.default_rng(seed)
    if arch_id == "xdeepfm":
        return {"sparse": rdata.xdeepfm_batch(
            seed, 0, b, cfg.n_fields, cfg.field_vocab, cfg.n_hot)["sparse"]}
    hist = rng.integers(1, cfg.n_items, size=(b, cfg.seq_len))
    hist[:, :2] = np.where(rng.random((b, 1)) < 0.5, 0, hist[:, :2])
    if b > 1:
        hist[1] = 0
    if arch_id == "bert4rec":
        hist[:, -1] = cfg.n_items
    out = {"hist": hist.astype(np.int32)}
    if arch_id == "dien":
        out["target"] = rng.integers(1, cfg.n_items, size=b).astype(np.int32)
    return out


def _train_batch(arch_id, cfg, b=4):
    if arch_id == "sasrec":
        return rdata.sasrec_batch(0, 1, b, cfg.seq_len, cfg.n_items,
                                  cfg.n_negatives)
    if arch_id == "bert4rec":
        return rdata.bert4rec_batch(0, 1, b, cfg.seq_len, cfg.n_items,
                                    cfg.n_negatives)
    if arch_id == "dien":
        return rdata.dien_batch(0, 1, b, cfg.seq_len, cfg.n_items)
    return rdata.xdeepfm_batch(0, 1, b, cfg.n_fields, cfg.field_vocab,
                               cfg.n_hot)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("arch_id", REC_ARCHS)
def test_configs_and_trees_match_reference(arch_id):
    """Configs field for field (``dtype`` is each library's f32), shapes
    of both scales, and ``init_*``'s tree: names, nesting, shapes."""
    ra, ta = rconfigs.get_arch(arch_id), tconfigs.get_arch(arch_id)
    assert (ta.shapes, ta.smoke_shapes, ta.kind, ta.source) == \
        (ra.shapes, ra.smoke_shapes, ra.kind, ra.source)
    for scale in ("full", "smoke"):
        r = dataclasses.asdict(ra.make_config(scale, "serve_p99"))
        t = dataclasses.asdict(ta.make_config(scale, "serve_p99"))
        assert r.pop("dtype") == jnp.float32
        assert t.pop("dtype") == torch.float32
        assert r == t
    rcfg, tcfg = _cfgs(arch_id)
    theirs = jax.eval_shape(lambda: rbase._REC_INIT[arch_id](
        jax.random.PRNGKey(0), rcfg))
    mine = tbase._REC_INIT[arch_id](0, tcfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert len(flat) == len(ttfm.tree_leaves(mine))
    for path, leaf in flat:
        t = mine
        for p in path:
            t = t[p.key if hasattr(p, "key") else p.idx]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
    assert isinstance(mine.get("cin", []), list)


def test_list_cells_and_archs_match_reference():
    assert tconfigs.list_cells() == rconfigs.list_cells()
    assert list(tconfigs.ARCHS) == list(rconfigs.ARCHS)
    assert trec.padded_rows(1_000_001) == rrec.padded_rows(1_000_001) == \
        tbag.padded_rows(1_000_001) == 1_000_448


@pytest.mark.parametrize("arch_id", ["sasrec", "bert4rec"])
def test_encoder_hidden_and_user_vec_match_reference(arch_id):
    rcfg, tcfg = _cfgs(arch_id)
    rp, tp = _params(arch_id, rcfg)
    hist = _inputs(arch_id, rcfg, 6)["hist"]
    hidden = {"sasrec": (rrec.sasrec_hidden, trec.sasrec_hidden),
              "bert4rec": (rrec.bert4rec_hidden, trec.bert4rec_hidden)}
    rf, tf = hidden[arch_id]
    want = jax.jit(rf, static_argnums=(1,))(rp, rcfg, jnp.asarray(hist))
    got = tf(tp, tcfg, torch.from_numpy(hist))
    assert _rel(got, want) < TOL
    assert torch.isfinite(got).all()          # padding-only row included
    assert _rel(tbase._REC_USER[arch_id](tp, tcfg, torch.from_numpy(hist)),
                rbase._REC_USER[arch_id](rp, rcfg, jnp.asarray(hist))) < TOL


def test_dien_forward_and_user_vec_match_reference():
    rcfg, tcfg = _cfgs("dien")
    rp, tp = _params("dien", rcfg)
    inp = _inputs("dien", rcfg, 6)
    want = jax.jit(rrec.dien_forward, static_argnums=(1,))(
        rp, rcfg, jnp.asarray(inp["hist"]), jnp.asarray(inp["target"]))
    got = trec.dien_forward(tp, tcfg, *map(torch.from_numpy,
                                          (inp["hist"], inp["target"])))
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL
    assert _rel(trec.dien_user_vec(tp, tcfg, torch.from_numpy(inp["hist"])),
                rrec.dien_user_vec(rp, rcfg, jnp.asarray(inp["hist"]))) < TOL


@pytest.mark.parametrize("n_hot", [1, 3])
def test_xdeepfm_logit_and_user_vec_match_reference(n_hot):
    """One-hot (bags of one) and multi-hot (bags of 3) lookups."""
    rcfg, tcfg = _cfgs("xdeepfm", n_hot)
    rp, tp = _params("xdeepfm", rcfg)
    sparse = _inputs("xdeepfm", rcfg, 8)["sparse"]
    e_want, lin_want = rrec._xdeepfm_embed(rp, rcfg, jnp.asarray(sparse))
    e_got, lin_got = trec._xdeepfm_embed(tp, tcfg, torch.from_numpy(sparse))
    # a bag sums from +0.0: values equal to the gather's (no -0.0 here)
    np.testing.assert_allclose(e_got.numpy(), np.asarray(e_want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(lin_got.numpy(), np.asarray(lin_want))
    want = jax.jit(rrec.xdeepfm_logit, static_argnums=(1,))(
        rp, rcfg, jnp.asarray(sparse))
    got = trec.xdeepfm_logit(tp, tcfg, torch.from_numpy(sparse))
    assert got.shape == want.shape and _rel(got, want) < TOL
    assert _rel(trec.xdeepfm_user_vec(tp, tcfg, torch.from_numpy(sparse)),
                rrec.xdeepfm_user_vec(rp, rcfg, jnp.asarray(sparse))) < TOL


@pytest.mark.parametrize("arch_id", REC_ARCHS)
def test_loss_values_match_reference(arch_id):
    rcfg, tcfg = _cfgs(arch_id)
    rp, tp = _params(arch_id, rcfg)
    batch = _train_batch(arch_id, rcfg)
    want = float(jax.jit(rbase._REC_LOSS[arch_id], static_argnums=(1,))(
        rp, rcfg, _j(batch)))
    got = float(tbase._REC_LOSS[arch_id](tp, tcfg, _t(batch)))
    assert np.isfinite(got) and abs(got - want) <= TOL * abs(want)


def test_sampled_softmax_chunks_match_reference():
    """Sequence inputs in chunks (a chunk that does not divide S takes
    the gcd), flat inputs in one piece, a ``valid`` mask."""
    rng = np.random.default_rng(8)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    uv = rng.normal(size=(3, 10, 6)).astype(np.float32)
    pos = rng.integers(0, 50, size=(3, 10)).astype(np.int32)
    neg = rng.integers(0, 50, size=(3, 10, 4)).astype(np.int32)
    valid = rng.random((3, 10)) < 0.7
    for args, kw in (((uv, pos, neg, table, valid), {"seq_chunk": 4}),
                     ((uv[:, 0], pos[:, 0], neg[:, 0], table), {})):
        want = float(rrec.sampled_softmax_loss(*map(jnp.asarray, args), **kw))
        got = float(trec.sampled_softmax_loss(
            *map(lambda a: torch.from_numpy(np.array(a)), args), **kw))
        assert abs(got - want) <= 1e-6 * abs(want)


def _same_topk(got, want, near_tie=0.0):
    """Top-k ids equal and scores within rtol 1e-5.  With ``near_tie``,
    an id may differ where the reference's score at that rank is within
    ``near_tie`` relative of an adjacent rank's: there the user vectors'
    rounding (not the same in the two libraries) may swap two items."""
    gv, gi = (x.reshape(-1, x.shape[-1]).numpy() for x in got)
    wv, wi = (np.asarray(x).reshape(-1, x.shape[-1]) for x in want)
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=0)
    for q, j in zip(*np.nonzero(gi != wi)):
        s = wv[q]
        near = [i for i in (j - 1, j + 1) if 0 <= i < len(s)
                and abs(s[j] - s[i]) <= near_tie * abs(s[j])]
        assert near, (q, j, gi[q, j], wi[q, j], s[j])


def test_iterative_topk_matches_reference():
    """k rounds of max / first argmax / mask, ties included, and a row
    with fewer finite scores than k (later rounds repeat the first -inf
    index, as the reference's do)."""
    rng = np.random.default_rng(9)
    sc = rng.integers(0, 20, size=(4, 64)).astype(np.float32)   # ties
    sc[2, 5:] = -np.inf
    want = jax.jit(rrec.iterative_topk, static_argnums=(1,))(
        jnp.asarray(sc), 12)
    _same_topk(trec.iterative_topk(torch.from_numpy(sc), 12), want)


@pytest.mark.parametrize("c,chunk,k", [(512, 8192, 16), (3000, 512, 32),
                                       (4096, 512, 32), (1000, 256, 300)])
def test_retrieval_topk_matches_reference(c, chunk, k):
    """Exact at ``c <= chunk``; the bucketed scheme past it (slabs that
    divide c, a padded last bucket, ``kb`` capped at the slab)."""
    rng = np.random.default_rng(c + k)
    uv = rng.normal(size=(5, 8)).astype(np.float32)
    cand = rng.normal(size=(c, 8)).astype(np.float32)
    want = rrec.retrieval_topk(jnp.asarray(uv), jnp.asarray(cand), k=k,
                               chunk=chunk)
    _same_topk(trec.retrieval_topk(torch.from_numpy(uv),
                                   torch.from_numpy(cand), k=k, chunk=chunk),
               want)


def test_retrieval_layout_at_full_width():
    """The bucketed geometry over the full item table, 1,000,448 rows =
    2^10 x 977: 128 slabs of 7,816 rows, 100 buckets of 79, pad 84."""
    c = trec.padded_rows(1_000_001)
    assert trec.retrieval_layout(c, 100, 8192) == {
        "n": 128, "chunk": 7816, "kb": 100, "width": 79, "pad": 84}


def test_bucketed_retrieval_recall():
    """The port's counterpart of the reference's recall test, with no
    mesh: the bucketed top-k keeps recall@32 >= 0.85 against the exact
    top-k, every returned score is its id's true score, and
    ``iterative_topk`` is exact."""
    rng = np.random.default_rng(0)
    uv = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    cand = torch.from_numpy(rng.normal(size=(4096, 16)).astype(np.float32))
    k = 32
    full = uv @ cand.T
    exact_v, exact_i = ttfm.top_k_stable(full, k)
    it_v, it_i = trec.iterative_topk(full, k)
    torch.testing.assert_close(it_v, exact_v, rtol=1e-6, atol=0)
    assert torch.equal(it_i.long(), exact_i)
    bk_v, bk_i = trec.retrieval_topk(uv, cand, k=k, chunk=512,
                                     batch_axes=("data",))
    recall = np.mean([len(set(bk_i[b].tolist()) & set(exact_i[b].tolist()))
                      / k for b in range(8)])
    assert recall >= 0.85, recall
    np.testing.assert_allclose(bk_v.numpy(),
                               full.gather(1, bk_i.long()).numpy(),
                               rtol=1e-5)


def _leaves(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


NEAR_TIE = 1e-5        # the cells' user vectors differ by rounding


def _compare_out(got, want, arch):
    if arch in ("sasrec", "bert4rec"):
        _same_topk(got, want, NEAR_TIE)
    else:
        assert _rel(got, want) < TOL


@pytest.mark.parametrize("user_chunk", [None, 4])
@pytest.mark.parametrize("arch_id", REC_ARCHS)
def test_serve_fn_matches_reference_cell(arch_id, user_chunk):
    """``recsys_serve_fn`` against the body of the reference's serve
    cell at smoke serve_bulk (32 users): one chunk, and 8 chunks of 4
    (stacked on a chunk axis, as ``jax.lax.map`` stacks them)."""
    rcfg, tcfg = _cfgs(arch_id)
    shp = dict(rconfigs.get_arch(arch_id).smoke_shapes["serve_bulk"])
    if user_chunk:
        shp["user_chunk"] = user_chunk
    cell = rbase._recsys_cell(arch_id, rcfg, "serve_bulk", shp)
    layout = tbase.rec_serve_inputs(arch_id, tcfg, shp)
    assert {k: s for k, (s, _) in layout.items()} == \
        {k: v.shape for k, v in cell.abstract_args[1].items()}
    rp, tp = _params(arch_id, rcfg)
    flat = _inputs(arch_id, rcfg, shp["batch"])
    inp = {k: v.reshape(layout[k][0]) for k, v in flat.items()}
    want = jax.jit(cell.fn)(rp, _j(inp))
    got = tbase.recsys_serve_fn(arch_id, tcfg, shp)(tp, _t(inp))
    for g, w in zip(_leaves(got), _leaves(want)):
        assert tuple(g.shape) == w.shape
    _compare_out(got, want, arch_id)


@pytest.mark.parametrize("arch_id", REC_ARCHS)
def test_retrieval_fn_matches_reference_cell(arch_id):
    """``recsys_retrieval_fn`` against the reference's retrieval cell
    (``ARCH.cell("retrieval_cand", scale="smoke").fn``): one user against
    512 candidate rows, k 100."""
    rcfg, tcfg = _cfgs(arch_id)
    cell = rconfigs.get_arch(arch_id).cell("retrieval_cand", scale="smoke")
    shp = tconfigs.get_arch(arch_id).smoke_shapes["retrieval_cand"]
    rp, tp = _params(arch_id, rcfg)
    inp = _inputs(arch_id, rcfg, 1, seed=2)
    d = rcfg.embed_dim
    cand = np.random.default_rng(3).normal(
        size=(trec.padded_rows(shp["n_candidates"]), d)).astype(np.float32)
    assert cell.abstract_args[2].shape == cand.shape
    want = jax.jit(cell.fn)(rp, _j(inp), jnp.asarray(cand))
    got = tbase.recsys_retrieval_fn(arch_id, tcfg, shp)(
        tp, _t(inp), torch.from_numpy(cand))
    _same_topk(got, want, NEAR_TIE)
