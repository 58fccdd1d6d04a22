"""sasrec [arXiv:1808.09781; paper]: embed_dim=50, 2 blocks, 1 head,
seq_len=50, causal self-attention over item history; 1M-item table."""
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
        return recsys.SasRecConfig(n_items=1_000_000, embed_dim=50,
                                   n_blocks=2, n_heads=1, seq_len=50,
                                   n_negatives=128)
    return recsys.SasRecConfig(n_items=1000, embed_dim=16, n_blocks=2,
                               n_heads=1, seq_len=10, n_negatives=8)


ARCH = ArchDef("sasrec", "recsys", make_config, SHAPES, SMOKE_SHAPES,
               source="arXiv:1808.09781")
