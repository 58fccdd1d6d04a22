"""gemma3-4b [hf:google/gemma-3-4b-pt; unverified]: 34L d=2560 8H(kv=4)
d_ff=10240 vocab=262144; 5:1 local(1024-window):global interleave with
RoPE 10k local / 1M global; qk-norm; sandwich norms; 128k context."""
from repro_torch.configs.base import ArchDef
from repro_torch.models import transformer as tfm

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
            name="gemma3-4b", n_layers=34, d_model=2560, n_heads=8,
            n_kv_heads=4, head_dim=256, d_ff=10240, vocab=262144,
            qk_norm=True, window=1024, global_every=6,
            rope_base=1_000_000.0, rope_base_local=10_000.0,
            post_norm=True, embed_scale=2560 ** 0.5, tie_embeddings=True)
    return tfm.TransformerConfig(
        name="gemma3-4b-smoke", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        qk_norm=True, window=8, global_every=6,
        rope_base=1_000_000.0, rope_base_local=10_000.0,
        post_norm=True, embed_scale=8.0, tie_embeddings=True,
        chunk_q=16, loss_chunk=16)


ARCH = ArchDef("gemma3-4b", "lm", make_config, SHAPES, SMOKE_SHAPES,
               source="hf:google/gemma-3-4b-pt")
