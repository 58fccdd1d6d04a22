// HOR candidate kernel: replaces fused_topk_blocked_pallas
// (repro/kernels/fused_decode_score.py, body _fused_blocked_topk_kernel).
// The dense HOR kernel's walk (each routed pair reads one raw 128-lane
// block, i32 doc ids and f32 tfs, staged with cp.async) with a candidate
// epilogue: TopkOut (_tile_topk, reducer="successive"), or BitonicOut
// (_tile_topk_bitonic, reducer="bitonic") through the _bitonic entry
// points.  See fused_score.cuh.
#include "fused_score.cuh"

namespace {

template <class Epi>
int launch_topk(const int* docs, const float* tfs, const int* pair_block,
                const int* pair_tile, const int* pair_cap,
                const float* pair_qw, int n_pairs, const float* norm,
                const float* rank, const float* qnorm, float* out_vals,
                int* out_ids, int n_tiles, int num_docs, int q, int tile,
                int k_tile, float rank_blend, void* stream) {
  const fused_score::HorBlocks bl{docs, tfs};
  const fused_score::Pairs pr{pair_block, pair_tile, pair_cap, pair_qw,
                              nullptr,    nullptr,   nullptr,  n_pairs};
  const fused_score::TopkOut topk{norm,    rank,    qnorm,  out_vals,
                                  out_ids, n_tiles, k_tile, rank_blend};
  const Epi epi(topk);
  return fused_score::launch(bl, pr, epi, n_tiles, num_docs, q, tile, stream);
}

template <class Epi>
int occupancy_of(int q, int tile, int* smem) {
  const fused_score::HorBlocks bl{nullptr, nullptr};
  return fused_score::occupancy<Epi>(bl, q, tile, smem);
}

}  // namespace

#define FUSED_TOPK_BLOCKED_ARGS                                              \
  const int *docs, const float *tfs, const int *pair_block,                  \
      const int *pair_tile, const int *pair_cap, const float *pair_qw,       \
      int n_pairs, const float *norm, const float *rank, const float *qnorm, \
      float *out_vals, int *out_ids, int n_tiles, int num_docs, int q,       \
      int tile, int k_tile, float rank_blend, void *stream
#define FUSED_TOPK_BLOCKED_CALL                                              \
  docs, tfs, pair_block, pair_tile, pair_cap, pair_qw, n_pairs, norm, rank,  \
      qnorm, out_vals, out_ids, n_tiles, num_docs, q, tile, k_tile,          \
      rank_blend, stream

extern "C" int fused_topk_blocked_launch(FUSED_TOPK_BLOCKED_ARGS) {
  return launch_topk<fused_score::TopkOut>(FUSED_TOPK_BLOCKED_CALL);
}

extern "C" int fused_topk_blocked_bitonic_launch(FUSED_TOPK_BLOCKED_ARGS) {
  return launch_topk<fused_score::BitonicOut>(FUSED_TOPK_BLOCKED_CALL);
}

extern "C" int fused_topk_blocked_occupancy(int q, int tile, int* smem) {
  return occupancy_of<fused_score::TopkOut>(q, tile, smem);
}

extern "C" int fused_topk_blocked_bitonic_occupancy(int q, int tile,
                                                    int* smem) {
  return occupancy_of<fused_score::BitonicOut>(q, tile, smem);
}
