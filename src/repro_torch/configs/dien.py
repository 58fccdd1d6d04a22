"""dien [arXiv:1809.03672; unverified]: embed_dim=18, seq_len=100,
GRU(108) interest extractor + AUGRU interest evolution, MLP 200-80."""
from repro_torch.configs.base import ArchDef
from repro_torch.models import recsys

SHAPES = {
    "train_batch":    {"step": "train", "batch": 65536},
    "serve_p99":      {"step": "serve", "batch": 512},
    "serve_bulk":     {"step": "serve", "batch": 262144},
    "retrieval_cand": {"step": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}
SMOKE_SHAPES = {
    "train_batch":    {"step": "train", "batch": 16},
    "serve_p99":      {"step": "serve", "batch": 8},
    "serve_bulk":     {"step": "serve", "batch": 32},
    "retrieval_cand": {"step": "retrieval", "batch": 1,
                       "n_candidates": 512},
}


def make_config(scale: str, shape_id: str | None = None):
    if scale == "full":
        return recsys.DienConfig(n_items=1_000_000, embed_dim=18,
                                 seq_len=100, gru_dim=108,
                                 mlp_dims=(200, 80))
    return recsys.DienConfig(n_items=1000, embed_dim=8, seq_len=10,
                             gru_dim=12, mlp_dims=(16, 8))


ARCH = ArchDef("dien", "recsys", make_config, SHAPES, SMOKE_SHAPES,
               source="arXiv:1809.03672")
