"""xdeepfm [arXiv:1803.05170; paper]: 39 sparse fields, embed_dim=10,
CIN 200-200-200, DNN 400-400; 1M rows per field (EmbeddingBag path)."""
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
        return recsys.XDeepFmConfig(n_fields=39, field_vocab=1_000_000,
                                    embed_dim=10,
                                    cin_layers=(200, 200, 200),
                                    mlp_dims=(400, 400))
    return recsys.XDeepFmConfig(n_fields=6, field_vocab=100, embed_dim=8,
                                cin_layers=(12, 12), mlp_dims=(16, 8))


ARCH = ArchDef("xdeepfm", "recsys", make_config, SHAPES, SMOKE_SHAPES,
               source="arXiv:1803.05170")
