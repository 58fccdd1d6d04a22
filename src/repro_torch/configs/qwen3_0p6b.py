"""qwen3-0.6b [hf:Qwen/Qwen3-0.6B; hf]: 28L d=1024 16H (GQA kv=8)
head_dim=128 d_ff=3072 vocab=151936; qk-norm; rope theta 1M."""
from repro_torch.configs.base import ArchDef
from repro_torch.models import transformer as tfm

SHAPES = {
    "train_4k":    {"step": "train",   "batch": 256, "seq": 4096},
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
            name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16,
            n_kv_heads=8, head_dim=128, d_ff=3072, vocab=152064,  # 151936 padded to 512-lane multiple
            qk_norm=True, rope_base=1_000_000.0, tie_embeddings=True)
    return tfm.TransformerConfig(
        name="qwen3-0.6b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, qk_norm=True,
        rope_base=1_000_000.0, tie_embeddings=True, chunk_q=16,
        loss_chunk=16)


ARCH = ArchDef("qwen3-0.6b", "lm", make_config, SHAPES, SMOKE_SHAPES,
               source="hf:Qwen/Qwen3-0.6B")
