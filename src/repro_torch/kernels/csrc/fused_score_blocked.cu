// HOR dense kernel: replaces fused_score_blocked_pallas
// (repro/kernels/fused_decode_score.py, body _fused_blocked_kernel).  Each
// routed pair reads one raw 128-lane block: i32 doc ids and f32 tfs (1 KB).
// See fused_score.cuh.
#include "fused_score.cuh"

extern "C" int fused_score_blocked_launch(
    const int* docs, const float* tfs, const int* pair_block,
    const int* pair_cap, const float* pair_qw, const int* tile_start,
    float* out, int n_tiles, int num_docs, int q, int tile, void* stream) {
  const tile_acc::BlockedLoader ld{docs, tfs, pair_block};
  return fused_score::launch(ld, pair_cap, pair_qw, tile_start, out, n_tiles,
                             num_docs, q, tile, stream);
}
