"""Gradients of the port against ``jax.value_and_grad`` of the
reference, on the CPU: the seven training losses at their smoke
configs, and the backward rules of the three kernel calls
(``kernels.ops.attention``, ``embedding_bag``, ``pna_multi_agg``), which
are one code path in torch ops on both devices, so that these tests hold
the card's backward code too.

The reference's params and inputs travel to the port as numpy arrays.
Each reference function is jitted once.

Tolerances, each leaf's gradient rel-to-max (max |got - want| over max
|want|):
  * f32 losses 1e-4, the value 1e-5 relative: the same arithmetic, but
    XLA and torch order a matmul's and a reduction's adds differently;
  * the bf16 LM 2e-2 (its value 2e-3), against the reference compiled
    with ``xla_allow_excess_precision`` off (as ``test_torch_models``):
    bf16 products round where the two libraries order adds differently;
  * attention's rule 1e-5 in f32, 2e-2 in bf16 (per tensor);
  * the bag's rule, and PNA's for its mean, min and max outputs, to the
    bit: the same operations in the same order (a min's or max's
    gradient split evenly among the rows equal to it, as ``jax.grad``
    splits it: ``[0, 0, -1]`` gives ``[.5, .5, 0]`` to max, ``[0, 0, 1]``
    to min, and std at the crafted ties); PNA's std output over random
    rows and all four outputs together 1e-5 rel-to-max: the terms add in
    another order, and they cancel near a zero variance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.configs import base as rbase  # noqa: E402
from repro.core import segments as rseg  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import gnn as rgnn  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro.train import data as rdata  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import segments as tseg  # noqa: E402
from repro_torch.kernels import embedding_bag as tbag  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import segment_multi_agg as tpna  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.core import tree  # noqa: E402

STRICT = {"xla_allow_excess_precision": False}


def _rel(got, want):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _check_tree(loss, grads, rloss, rgrads, tol_value, tol_grad):
    """The value within ``tol_value`` relative, every leaf's gradient
    within ``tol_grad`` rel-to-max, finite and of the param's shape."""
    want_leaves, _ = jax.tree.flatten(rgrads)
    got_leaves = tree.leaves(grads)
    assert len(got_leaves) == len(want_leaves)
    assert abs(float(loss) - float(rloss)) <= tol_value * abs(float(rloss))
    worst = max(_rel(g, w) for g, w in zip(got_leaves, want_leaves))
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(w.shape)
        assert torch.isfinite(g.float()).all()
    assert worst < tol_grad, worst


# ---------------------------------------------------------------------------
# the seven losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lm_loss_grad_matches_reference(dt):
    """``transformer.loss_fn`` at qwen3-0.6b's smoke config (GQA with
    qk-norm), every leaf's gradient."""
    rcfg = rconfigs.get_arch("qwen3-0.6b").make_config("smoke")
    tcfg = tconfigs.get_arch("qwen3-0.6b").make_config("smoke")
    if dt == "f32":
        rcfg = dataclasses.replace(rcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    rp = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    batch = rdata.lm_batch(0, 0, 2, 32, rcfg.vocab)
    co = STRICT if dt == "bf16" else None
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: rtfm.loss_fn(p, rcfg, b)), compiler_options=co)(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = topt.value_and_grad(
        lambda p, b: ttfm.loss_fn(p, tcfg, b),
        ttfm.params_from_numpy(rp, "cpu"), _t(batch))
    tol = (1e-5, 1e-4) if dt == "f32" else (2e-3, 2e-2)
    _check_tree(loss, grads, rloss, rgrads, *tol)


def _rec_batch(arch_id, cfg, b=4):
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


@pytest.mark.parametrize("arch_id,n_hot", [("sasrec", 1), ("bert4rec", 1),
                                           ("dien", 1), ("xdeepfm", 1),
                                           ("xdeepfm", 3)])
def test_recsys_loss_grad_matches_reference(arch_id, n_hot):
    """The four recsys losses at their train_batch smoke configs (and
    xDeepFM's multi-hot bags), every leaf's gradient: xDeepFM's table
    through the bag's backward rule."""
    rcfg = rconfigs.get_arch(arch_id).make_config("smoke", "train_batch")
    tcfg = tconfigs.get_arch(arch_id).make_config("smoke", "train_batch")
    if n_hot != 1:
        rcfg = dataclasses.replace(rcfg, n_hot=n_hot)
        tcfg = dataclasses.replace(tcfg, n_hot=n_hot)
    rp = rbase._REC_INIT[arch_id](jax.random.PRNGKey(3), rcfg)
    batch = _rec_batch(arch_id, rcfg)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: rbase._REC_LOSS[arch_id](p, rcfg, b)))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = topt.value_and_grad(
        lambda p, b: tbase._REC_LOSS[arch_id](p, tcfg, b),
        ttfm.params_from_numpy(rp, "cpu"), _t(batch))
    _check_tree(loss, grads, rloss, rgrads, 1e-5, 1e-4)


def _gnn_batch(shape_id):
    from repro.configs import pna as rpna_cfg
    shp = rpna_cfg.SMOKE_SHAPES[shape_id]
    cfg = rpna_cfg.make_config("smoke", shape_id)
    if shp.get("graph_level"):
        return cfg, rdata.molecule_batch(0, 0, shp["n_graphs"],
                                         shp["n_nodes"] // shp["n_graphs"],
                                         shp["n_edges"] // shp["n_graphs"],
                                         cfg.d_feat, cfg.n_classes)
    g = rdata.make_synthetic_graph(shp["n_nodes"], shp["n_edges"],
                                   cfg.d_feat, cfg.n_classes, 0)
    return cfg, rdata.fullgraph_batch(g, seed=0)


@pytest.mark.parametrize("shape_id", ["full_graph_sm", "molecule"])
def test_gnn_loss_grad_matches_reference(shape_id):
    """``gnn.node_loss`` (cora's smoke graph) and ``graph_loss`` (the
    molecule batch), every leaf's gradient: each layer's aggregation
    through PNA's backward rule."""
    cfg, batch = _gnn_batch(shape_id)
    lname = "graph_loss" if shape_id == "molecule" else "node_loss"
    rp = rgnn.init_params(jax.random.PRNGKey(1), cfg)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: getattr(rgnn, lname)(p, cfg, b)))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    tcfg = tgnn.PnaConfig(**dataclasses.asdict(cfg))
    loss, grads = topt.value_and_grad(
        lambda p, b: getattr(tgnn, lname)(p, tcfg, b),
        ttfm.params_from_numpy(rp, "cpu"), _t(batch))
    _check_tree(loss, grads, rloss, rgrads, 1e-5, 1e-4)


# ---------------------------------------------------------------------------
# the backward rules of the three kernel calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt,causal,window", [
    ("f32", True, 0), ("f32", True, 5), ("f32", False, 0), ("bf16", True, 0),
    ("bf16", True, 7)])
def test_attention_backward_matches_reference(dt, causal, window):
    """``ops.attention``'s gradient against ``jax.grad`` of the
    reference's ``chunked_attention`` (GQA, 4 query heads over 2)."""
    rng = np.random.default_rng(0)
    b, hq, hkv, s, d = 2, 4, 2, 24, 16
    q, k, v, do = (rng.standard_normal(sh).astype(np.float32) for sh in
                   ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                    (b, hq, s, d)))
    jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, 1e-5),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dt]

    def f(q, k, v):
        return rattn.chunked_attention(q, k, v, causal=causal, window=window,
                                       chunk=8)

    want = jax.jit(lambda *a: jax.vjp(f, *a[:3])[1](a[3]),
                   compiler_options=STRICT)(
        *(jnp.asarray(x, jdt) for x in (q, k, v, do)))
    ts = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = tops.attention(*ts, causal=causal, window=window)
    out.backward(torch.from_numpy(do).to(tdt))
    for t, w in zip(ts, want):
        assert t.grad.dtype == tdt
        assert _rel(t.grad, np.asarray(w.astype(jnp.float32))) < tol


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bag_backward_matches_reference(mode, dt):
    """``ops.embedding_bag``'s table gradient against ``jax.grad`` of
    ``ref_embedding_bag``, to the bit: padding slots give nothing, rows
    hit twice add in slot order, a mean divides by max(valid, 1)."""
    rng = np.random.default_rng(1)
    v, d, b, h = 13, 6, 9, 5
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(-1, v, (b, h)).astype(np.int32)
    idx[0] = -1                                   # a bag of padding only
    idx[1] = 4                                    # one row five times
    g = rng.standard_normal((b, d)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    want = jax.jit(lambda t, i, g: jax.vjp(
        lambda x: rref.ref_embedding_bag(x, i, mode), t)[1](g)[0])(
        jnp.asarray(table, jdt), idx, jnp.asarray(g, jdt))
    tt = torch.from_numpy(table).to(tdt).requires_grad_()
    tops.embedding_bag(tt, torch.from_numpy(idx), mode).backward(
        torch.from_numpy(g).to(tdt))
    got = tt.grad.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dt == "f32":
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) < 1e-2
    assert not got[np.setdiff1d(np.arange(v), idx[idx >= 0])].any()


def _ref_agg(n, eps=1e-5):
    """The reference model's aggregation over edge rows (``gnn._pna_layer``:
    the four segment reductions, min and max behind ``isfinite``)."""
    def agg(m, dst):
        mean = rseg.segment_mean(m, dst, n, sorted_ids=False)
        mn = rseg.segment_min(m, dst, n, sorted_ids=False)
        mx = rseg.segment_max(m, dst, n, sorted_ids=False)
        std = rseg.segment_std(m, dst, n, sorted_ids=False, eps=eps)
        return jnp.concatenate([mean, jnp.where(jnp.isfinite(mn), mn, 0.0),
                                jnp.where(jnp.isfinite(mx), mx, 0.0), std],
                               axis=-1)
    return agg


def _pna_case(kind):
    """(edge rows m [E, D], dst [E] sorted, nodes): random rows with relu
    zeros, or crafted ties: ``[0, 0, -1]`` on a node, all-equal rows, a
    one-neighbour node, signed zeros, a node with no neighbour."""
    rng = np.random.default_rng(2)
    if kind == "random":
        n, e, d = 9, 60, 5
        dst = np.sort(rng.integers(0, n - 1, e)).astype(np.int32)
        m = np.maximum(rng.standard_normal((e, d)), 0).astype(np.float32)
        return m, dst, n
    rows = [[0.0, 2.0], [0.0, 2.0], [-1.0, 2.0],        # node 0
            [3.0, -0.0], [3.0, 0.0], [3.0, 0.0],        # node 1
            [-4.5, 1.5],                                # node 2
            [0.0, -0.0], [0.0, -0.0]]                   # node 3
    dst = [0, 0, 0, 1, 1, 1, 2, 3, 3]                   # node 4: empty
    return (np.asarray(rows, np.float32), np.asarray(dst, np.int32), 5)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("part", ["mean", "min", "max", "std", "all"])
def test_pna_backward_matches_reference(kind, part):
    """``ops.pna_multi_agg``'s feats gradient against ``jax.grad`` of the
    reference model's aggregation, one output part at a time and all
    four: mean, min and max to the bit (ties split as JAX splits them),
    and std at the crafted ties (``max(var, 0)``'s half at a zero
    variance); std over random rows and all four together within 1e-5
    rel-to-max (std's gradient near a zero variance is ``0.5 /
    sqrt(eps)``, 158, times terms that cancel: their order shows)."""
    m, dst, n = _pna_case(kind)
    d = m.shape[1]
    rng = np.random.default_rng(3)
    g = rng.standard_normal((n, 4 * d)).astype(np.float32)
    if part != "all":
        i = ("mean", "min", "max", "std").index(part)
        keep = np.zeros_like(g)
        keep[:, i * d:(i + 1) * d] = g[:, i * d:(i + 1) * d]
        g = keep
    want = np.asarray(jax.jit(lambda m, i, g: jax.vjp(
        lambda x: _ref_agg(n)(x, i), m)[1](g)[0])(m, dst, g))
    edges = tgnn.build_edges(torch.zeros(len(dst), dtype=torch.int32),
                             torch.from_numpy(dst), n)
    mt = torch.from_numpy(m).requires_grad_()
    tops.pna_multi_agg(mt, edges.nbr).backward(torch.from_numpy(g))
    got = mt.grad.numpy()
    if part in ("mean", "min", "max") or (kind, part) == ("ties", "std"):
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) < 1e-5
    if kind == "ties" and part == "max":
        gmx = g[0, 2 * d:3 * d][0]
        np.testing.assert_array_equal(got[:3, 0], [gmx * np.float32(0.5),
                                                   gmx * np.float32(0.5), 0])


def test_backward_rules_in_fixed_order():
    """The card's fixed-order segment sum (``ordered_segment_sum``, which
    every backward scatter and every card ``segment_sum`` runs) gives the
    bits of ``index_add_``'s entry order, 1-D and 2-D."""
    rng = np.random.default_rng(4)
    for shape in ((500,), (500, 7)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        ids = torch.from_numpy(rng.integers(0, 11, 500))
        want = torch.zeros((11,) + shape[1:]).index_add_(0, ids, x)
        got = tseg.ordered_segment_sum(x, ids, 11)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("which", ["attention", "bag", "pna"])
def test_raw_launchers_refuse_inputs_that_require_grad(which):
    """A raw launch would write a tensor autograd cannot see: an input
    that requires grad is refused (checked before the device), and the
    ``ops`` entry point takes it."""
    x = torch.zeros(1, 2, 16, 16, requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        if which == "attention":
            tfa._launch_flash_cuda(x, x, x, True, 0)
        elif which == "bag":
            tbag._launch_embedding_bag_cuda(
                torch.zeros(4, 8, requires_grad=True),
                torch.zeros(2, 3, dtype=torch.int32))
        else:
            tpna._launch_pna_cuda(torch.zeros(4, 8, requires_grad=True),
                                  torch.zeros(2, 3, dtype=torch.int32))
    with torch.no_grad():     # no gradient to lose: past the grad check
        with pytest.raises(ValueError, match="CUDA tensors only"):
            tfa._launch_flash_cuda(x, x, x, True, 0)
