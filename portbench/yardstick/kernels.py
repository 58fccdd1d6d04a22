"""The port's hand-written kernels as the profiler names their device
activity (symbol substrings), frozen here with the benchmark: every
other device operation in a trace is a PyTorch op or a copy."""

FUSED = {
    "fused_topk_blocked": "score_kernel<fused_score::TopkOut, fused_score::HorBlocks",
    "fused_topk_packed": "score_kernel<fused_score::TopkOut, fused_score::PackedBlocks",
    "fused_score_blocked": "score_kernel<fused_score::DenseOut, fused_score::HorBlocks",
    "fused_score_packed": "score_kernel<fused_score::DenseOut, fused_score::PackedBlocks",
    "fused_topk_blocked_bitonic": "score_kernel<fused_score::BitonicOut, fused_score::HorBlocks",
    "fused_topk_packed_bitonic": "score_kernel<fused_score::BitonicOut, fused_score::PackedBlocks",
}
OTHER = {
    "idf": "idf_kernel",
    "query_norm": "norm_kernel",
    "posting_score": "posting_score_kernel",
    "unpack_blocks": "unpack_kernel",
    "embedding_bag": "bag_kernel",
    "pna_multi_agg": "pna_kernel",
    "flash_attention": "flash_",
}
HAND_WRITTEN = {**FUSED, **OTHER}

