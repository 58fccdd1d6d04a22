"""Port vs reference for PNA (``repro_torch.models.gnn`` against
``repro.models.gnn``) at the smoke configs of ``configs.pna``, on the
CPU, where each layer's aggregation runs ``pna_multi_agg_plain`` over
the neighbour lists the kernel would take on the card.

The reference's params travel to the port through
``transformer.params_from_numpy``; graphs come from the data generators
of both packages (the neighbour sampler within this one process).
Tolerance: rel-to-max 1e-4 (f32; the reference's segment reductions and
the kernel's fused aggregation add in the same order, but XLA and torch
order a matmul's adds differently).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import pna as rpna_cfg  # noqa: E402
from repro.models import gnn as rgnn  # noqa: E402
from repro.train import data as rdata  # noqa: E402
from repro_torch.configs import pna as tpna_cfg  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402

TOL = 1e-4


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _batch(shape_id, seed=0):
    """The shape's smoke batch from the reference's generators (the
    sampler's block too: both packages' samplers agree in a process)."""
    shp = rpna_cfg.SMOKE_SHAPES[shape_id]
    cfg = rpna_cfg.make_config("smoke", shape_id)
    if shp.get("graph_level"):
        return rdata.molecule_batch(seed, 0, shp["n_graphs"],
                                    shp["n_nodes"] // shp["n_graphs"],
                                    shp["n_edges"] // shp["n_graphs"],
                                    cfg.d_feat, cfg.n_classes)
    if "full_graph" in shp:
        fg = shp["full_graph"]
        g = rdata.make_synthetic_graph(fg["n_nodes"], fg["n_edges"],
                                       cfg.d_feat, cfg.n_classes, seed)
        block = rdata.NeighborSampler(g, fg["batch_nodes"],
                                      fg["fanout"]).sample(seed)
        tg = tdata.make_synthetic_graph(fg["n_nodes"], fg["n_edges"],
                                        cfg.d_feat, cfg.n_classes, seed)
        mine = tdata.NeighborSampler(tg, fg["batch_nodes"],
                                     fg["fanout"]).sample(seed)
        for k in block:
            np.testing.assert_array_equal(mine[k], block[k])
        return block
    g = rdata.make_synthetic_graph(shp["n_nodes"], shp["n_edges"],
                                   cfg.d_feat, cfg.n_classes, seed)
    return rdata.fullgraph_batch(g, seed=seed)


@pytest.fixture(scope="module")
def ref():
    """The reference's functions, each jitted once."""
    return {
        "layer": jax.jit(rgnn._pna_layer, static_argnums=(5, 6, 7)),
        "logits": jax.jit(rgnn.node_logits, static_argnums=(1, 5)),
        "node_loss": jax.jit(rgnn.node_loss, static_argnums=(1,)),
        "graph_loss": jax.jit(rgnn.graph_loss, static_argnums=(1,)),
    }


def _params(cfg, seed=1):
    rp = rgnn.init_params(jax.random.PRNGKey(seed), cfg)
    return rp, ttfm.params_from_numpy(rp, "cpu")


def test_configs_match_reference():
    for shape_id in rpna_cfg.SHAPES:
        for scale in ("full", "smoke"):
            assert dataclasses.asdict(tpna_cfg.make_config(scale, shape_id)) \
                == dataclasses.asdict(rpna_cfg.make_config(scale, shape_id))
    assert tpna_cfg.SHAPES == rpna_cfg.SHAPES
    assert tpna_cfg.SMOKE_SHAPES == rpna_cfg.SMOKE_SHAPES


def test_init_params_has_the_reference_tree():
    cfg = tpna_cfg.make_config("full", "ogb_products")
    mine = tgnn.init_params(0, cfg, device="cpu")
    theirs = jax.eval_shape(lambda: rgnn.init_params(jax.random.PRNGKey(0),
                                                     cfg))
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert len(flat) == len(ttfm.tree_leaves(mine))
    for path, leaf in flat:
        t = mine
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32


@pytest.mark.parametrize("shape_id", ["full_graph_sm", "minibatch_lg",
                                      "ogb_products", "molecule"])
def test_pna_layer_matches_reference(ref, shape_id):
    """One layer on the shape's batch, h made from the batch's features."""
    cfg = rpna_cfg.make_config("smoke", shape_id)
    rp, tp = _params(cfg)
    b = _batch(shape_id)
    n = b["feats"].shape[0]
    h = b["feats"] @ np.asarray(rp["enc"])
    deg = np.zeros(n, np.float32)
    np.add.at(deg, b["dst"][b["dst"] < n], 1.0)
    lp = jax.tree.map(lambda x: x[0], rp["layers"])
    want = ref["layer"](lp, jnp.asarray(h), jnp.asarray(b["src"]),
                        jnp.asarray(b["dst"]), jnp.asarray(deg), n,
                        cfg.delta, cfg.eps)
    tb = _t(b)
    got = tgnn._pna_layer(tgnn.layer_params(tp, 0), torch.from_numpy(h),
                          tb["src"], tb["dst"], torch.from_numpy(deg), n,
                          cfg.delta, cfg.eps)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("shape_id", ["full_graph_sm", "minibatch_lg",
                                      "ogb_products"])
def test_node_logits_and_loss_match_reference(ref, shape_id):
    cfg = rpna_cfg.make_config("smoke", shape_id)
    rp, tp = _params(cfg)
    b = _batch(shape_id)
    n = b["feats"].shape[0]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = _t(b)
    want = ref["logits"](rp, cfg, jb["feats"], jb["src"], jb["dst"], n)
    got = tgnn.node_logits(tp, cfg, tb["feats"], tb["src"], tb["dst"], n)
    assert got.shape == want.shape
    assert _rel(got, want) < TOL
    loss = tgnn.node_loss(tp, cfg, tb)
    assert abs(float(loss) - float(ref["node_loss"](rp, cfg, jb))) < \
        TOL * abs(float(loss))


def test_graph_loss_matches_reference(ref):
    cfg = rpna_cfg.make_config("smoke", "molecule")
    rp, tp = _params(cfg)
    b = _batch("molecule")
    want = float(ref["graph_loss"](rp, cfg,
                                   {k: jnp.asarray(v) for k, v in b.items()}))
    got = float(tgnn.graph_loss(tp, cfg, _t(b)))
    assert abs(got - want) < TOL * abs(want)


def _numpy_nbr(src, dst, n):
    """Each node's in-edges, in edge order, from a plain Python walk."""
    lists = [[] for _ in range(n)]
    kept = []
    for e, (s, t) in enumerate(zip(src, dst)):
        if 0 <= t < n:
            kept.append(e)
    order = sorted(kept, key=lambda e: dst[e])         # stable
    for pos, e in enumerate(order):
        lists[dst[e]].append(pos)
    k = max((len(x) for x in lists), default=0)
    nbr = np.full((n, k), -1, np.int32)
    for i, x in enumerate(lists):
        nbr[i, :len(x)] = x
    return np.array(order, np.int64), nbr


def test_edges_against_numpy_build():
    """``build_edges`` against an independent build: pad edges (dst N,
    past N, negative) dropped, each node's edges in edge order, K the
    largest in-degree, src of a kept edge read as JAX clamps it."""
    rng = np.random.default_rng(5)
    n, e = 40, 300
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    dst[rng.random(e) < 0.1] = n
    dst[rng.random(e) < 0.05] = n + 7
    dst[rng.random(e) < 0.05] = -3
    src[::17] = n                                  # clamps to n - 1
    dst[(dst == 5) | (dst == 9)] = n               # isolated nodes
    order, nbr = _numpy_nbr(src, dst, n)
    got = tgnn.build_edges(torch.from_numpy(src.astype(np.int32)),
                           torch.from_numpy(dst.astype(np.int32)), n)
    np.testing.assert_array_equal(got.nbr.numpy(), nbr)
    np.testing.assert_array_equal(got.dst.numpy(), dst[order])
    np.testing.assert_array_equal(got.src.numpy(),
                                  np.minimum(src[order], n - 1))
    np.testing.assert_array_equal(got.deg.numpy(), (nbr >= 0).sum(1))
    assert got.nbr.dtype == got.src.dtype == torch.int32
    assert not got.deg[[5, 9]].any()


@pytest.mark.parametrize("eps", [1e-5, 0.25])
def test_isolated_nodes_pad_edges_and_eps(ref, eps):
    """A graph with isolated nodes, src == dst == N pad edges, and a pad
    edge whose src is in range; the default eps and another one."""
    cfg = dataclasses.replace(rpna_cfg.make_config("smoke", "full_graph_sm"),
                              eps=eps)
    rp, tp = _params(cfg, seed=4)
    rng = np.random.default_rng(6)
    n, e = 50, 160
    feats = rng.normal(size=(n, cfg.d_feat)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[np.isin(dst, [3, 17, 30])] = n
    src[dst == n] = n
    src[-20:] = n
    dst[-20:] = n
    dst[7] = n                                      # src in range, dropped
    args = (feats, src, dst)
    want = ref["logits"](rp, cfg, *map(jnp.asarray, args), n)
    got = tgnn.node_logits(tp, cfg, *map(torch.from_numpy, args), n)
    assert _rel(got, want) < TOL
    # eps reaches the aggregation: an isolated node's std is sqrt(eps)
    agg = tgnn.ops.pna_multi_agg(torch.zeros(2, 3),
                                 torch.full((1, 2), -1, dtype=torch.int32),
                                 eps=eps)
    np.testing.assert_array_equal(agg[0, 9:].numpy(),
                                  np.sqrt(np.float32(eps), dtype=np.float32)
                                  * np.ones(3, np.float32))


def test_relu_turns_negative_zero_positive():
    x = torch.tensor([-0.0, 0.0, -2.0, 3.0, float("nan")])
    out = tgnn.relu(x.clone())
    assert not torch.signbit(out[:3]).any()
    assert out[3] == 3.0 and torch.isnan(out[4])
    assert not np.signbit(np.asarray(jax.nn.relu(jnp.float32(-0.0))))
