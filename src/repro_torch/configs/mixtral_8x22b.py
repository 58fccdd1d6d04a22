"""mixtral-8x22b [arXiv:2401.04088; hf]: 56L d=6144 48H (GQA kv=8)
d_ff=16384 vocab=32768; 8-expert top-2 MoE; sliding-window attention."""
from repro_torch.configs.base import ArchDef
from repro_torch.models import transformer as tfm

SHAPES = {
    "train_4k":    {"step": "train",   "batch": 256, "seq": 4096,
                    "microbatches": 8},
    "prefill_32k": {"step": "prefill", "batch": 32,  "seq": 32768},
    "decode_32k":  {"step": "decode",  "batch": 128, "seq": 32768},
    "long_500k":   {"step": "decode",  "batch": 1,   "seq": 524288},
}
SMOKE_SHAPES = {
    "train_4k":    {"step": "train",   "batch": 2, "seq": 32},
    "prefill_32k": {"step": "prefill", "batch": 2, "seq": 32},
    "decode_32k":  {"step": "decode",  "batch": 2, "seq": 64},
    "long_500k":   {"step": "decode",  "batch": 1, "seq": 64},
}


def make_config(scale: str, shape_id: str | None = None):
    if scale == "full":
        return tfm.TransformerConfig(
            name="mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48,
            n_kv_heads=8, head_dim=128, d_ff=16384, vocab=32768,
            window=4096, global_every=0, rope_base=1_000_000.0,
            moe=tfm.MoeConfig(n_experts=8, top_k=2),
            tie_embeddings=False, ring_cache=True)
    return tfm.TransformerConfig(
        name="mixtral-8x22b-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, window=16,
        global_every=0, rope_base=1_000_000.0,
        moe=tfm.MoeConfig(n_experts=4, top_k=2), tie_embeddings=False,
        ring_cache=True, chunk_q=16, loss_chunk=16)


ARCH = ArchDef("mixtral-8x22b", "lm", make_config, SHAPES, SMOKE_SHAPES,
               source="arXiv:2401.04088")
