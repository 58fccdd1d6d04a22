// HOR dense kernel: replaces fused_score_blocked_pallas
// (repro/kernels/fused_decode_score.py, body _fused_blocked_kernel).  Each
// routed pair reads one raw 128-lane block: i32 doc ids and f32 tfs (1 KB),
// staged into shared memory with cp.async.  See fused_score.cuh.
#include "fused_score.cuh"

extern "C" int fused_score_blocked_launch(
    const int* docs, const float* tfs, const int* pair_block,
    const int* pair_tile, const int* pair_cap, const float* pair_qw,
    int n_pairs, float* out, int n_tiles, int num_docs, int q, int tile,
    void* stream) {
  const fused_score::HorBlocks bl{docs, tfs};
  const fused_score::Pairs pr{pair_block, pair_tile, pair_cap, pair_qw,
                              nullptr,    nullptr,   nullptr,  n_pairs};
  const fused_score::DenseOut epi{out};
  return fused_score::launch(bl, pr, epi, n_tiles, num_docs, q, tile, stream);
}

extern "C" int fused_score_blocked_occupancy(int q, int tile, int* smem) {
  const fused_score::HorBlocks bl{nullptr, nullptr};
  return fused_score::occupancy<fused_score::DenseOut>(bl, q, tile, smem);
}
