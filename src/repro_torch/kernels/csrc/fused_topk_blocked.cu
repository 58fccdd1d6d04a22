// HOR candidate kernel: replaces fused_topk_blocked_pallas
// (repro/kernels/fused_decode_score.py).  Each routed pair reads one raw
// 128-lane block: i32 doc ids and f32 tfs (1 KB).  See fused_topk.cuh.
#include "fused_topk.cuh"

extern "C" int fused_topk_blocked_launch(
    const int* docs, const float* tfs, const int* pair_block,
    const int* pair_cap, const float* pair_qw, const int* tile_start,
    const float* norm, const float* rank, const float* qnorm, float* out_vals,
    int* out_ids, int n_tiles, int num_docs, int q, int tile, int k_tile,
    float rank_blend, void* stream) {
  const tile_acc::BlockedLoader ld{docs, tfs, pair_block};
  return fused_topk::launch(ld, pair_cap, pair_qw, tile_start, norm, rank,
                            qnorm, out_vals, out_ids, n_tiles, num_docs, q,
                            tile, k_tile, rank_blend, stream);
}
