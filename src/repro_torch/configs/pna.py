"""pna [arXiv:2004.05718; paper]: 4 layers, d_hidden=75, aggregators
mean/max/min/std, scalers identity/amplification/attenuation.

Input feature dim / class count are SHAPE properties (each cell is a
different public dataset): cora (full_graph_sm), reddit (minibatch_lg,
real fanout-15,10 neighbor sampler), ogbn-products (full-batch-large),
ogbg-mol-style batched small graphs (molecule).
"""
from repro_torch.configs.base import ArchDef
from repro_torch.models import gnn

# minibatch_lg block capacity: seeds + 15*seeds + 150*seeds (fanout 15,10)
_MB_NODES = 1024 + 1024 * 15 + 1024 * 150
_MB_EDGES = 1024 * 15 + 1024 * 150

def _p512(n):
    """Pad to a 512 multiple: jit input shardings need the leading dim
    divisible by the mesh axis product; the data pipeline pads with
    trash-node edges (dropped by segment ops)."""
    return -(-n // 512) * 512


SHAPES = {
    "full_graph_sm": {"n_nodes": _p512(2708), "n_edges": _p512(10556),
                      "d_feat": 1433, "n_classes": 7, "delta": 1.6},
    "minibatch_lg":  {"n_nodes": _p512(_MB_NODES), "n_edges": _p512(_MB_EDGES),
                      "d_feat": 602, "n_classes": 41, "delta": 5.0,
                      "full_graph": {"n_nodes": 232_965,
                                     "n_edges": 114_615_892,
                                     "batch_nodes": 1024,
                                     "fanout": (15, 10)}},
    "ogb_products":  {"n_nodes": _p512(2_449_029), "n_edges": _p512(61_859_140),
                      "d_feat": 100, "n_classes": 47, "delta": 3.3},
    "molecule":      {"n_nodes": _p512(128 * 30), "n_edges": _p512(128 * 64),
                      "d_feat": 9, "n_classes": 2, "n_graphs": 128,
                      "graph_level": True, "delta": 1.2},
}
SMOKE_SHAPES = {
    "full_graph_sm": {"n_nodes": 64, "n_edges": 256, "d_feat": 16,
                      "n_classes": 4, "delta": 1.6},
    "minibatch_lg":  {"n_nodes": 8 + 8 * 3 + 8 * 6, "n_edges": 8 * 3 + 8 * 6,
                      "d_feat": 16, "n_classes": 4, "delta": 1.6,
                      "full_graph": {"n_nodes": 500, "n_edges": 4000,
                                     "batch_nodes": 8, "fanout": (3, 2)}},
    "ogb_products":  {"n_nodes": 128, "n_edges": 512, "d_feat": 16,
                      "n_classes": 4, "delta": 1.6},
    "molecule":      {"n_nodes": 8 * 6, "n_edges": 8 * 10, "d_feat": 9,
                      "n_classes": 2, "n_graphs": 8, "graph_level": True,
                      "delta": 1.2},
}


def make_config(scale: str, shape_id: str | None = None):
    shapes = SHAPES if scale == "full" else SMOKE_SHAPES
    shp = shapes[shape_id or "full_graph_sm"]
    d_hidden = 75 if scale == "full" else 16
    n_layers = 4 if scale == "full" else 2
    return gnn.PnaConfig(name="pna", n_layers=n_layers, d_hidden=d_hidden,
                         d_feat=shp["d_feat"], n_classes=shp["n_classes"],
                         delta=shp["delta"])


ARCH = ArchDef("pna", "gnn", make_config, SHAPES, SMOKE_SHAPES,
               source="arXiv:2004.05718")
