"""minicpm3-4b [hf:openbmb/MiniCPM3-4B; hf]: 62L d=2560 40H d_ff=6400
vocab=73448; MLA (q_lora=768, kv_lora=256, nope=64, rope=32, v=64);
mup-style embed scale 12 and depth-scaled residuals 1.4/sqrt(L)."""
from repro_torch.configs.base import ArchDef
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import MlaDims

SHAPES = {
    "train_4k":    {"step": "train",   "batch": 256, "seq": 4096,
                    "microbatches": 2},
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
            name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40,
            n_kv_heads=40, head_dim=96, d_ff=6400, vocab=73728,  # 73448 padded to 512-lane multiple
            attn="mla",
            mla=MlaDims(n_heads=40, q_lora=768, kv_lora=256, nope=64,
                        rope=32, v_dim=64),
            embed_scale=12.0, residual_scale=1.4 / (62 ** 0.5),
            tie_embeddings=True)
    return tfm.TransformerConfig(
        name="minicpm3-4b-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=24, d_ff=128, vocab=512, attn="mla",
        mla=MlaDims(n_heads=4, q_lora=32, kv_lora=16, nope=16, rope=8,
                    v_dim=16),
        embed_scale=12.0, residual_scale=1.4 / (3 ** 0.5),
        tie_embeddings=True, chunk_q=16, loss_chunk=16)


ARCH = ArchDef("minicpm3-4b", "lm", make_config, SHAPES, SMOKE_SHAPES,
               source="hf:openbmb/MiniCPM3-4B")
