// Packed candidate kernel: replaces fused_topk_packed_pallas
// (repro/kernels/fused_decode_score.py, body _fused_packed_topk_kernel,
// decode _unpack_block_vmem).  The dense packed kernel's walk (each routed
// pair reads one delta+bit-packed block, staged compressed with cp.async
// and decoded in shared memory, one warp per pair) with a candidate
// epilogue: TopkOut (_tile_topk, reducer="successive"), or BitonicOut
// (_tile_topk_bitonic, reducer="bitonic") through the _bitonic entry
// points.  See fused_score.cuh.
#include "fused_score.cuh"

namespace {

template <class Epi>
int launch_topk(const unsigned* words, const unsigned short* tfs, int wpb,
                const int* pair_block, const int* pair_tile,
                const int* pair_cap, const float* pair_qw,
                const int* pair_bits, const int* pair_base,
                const int* pair_count, int n_pairs, const float* norm,
                const float* rank, const float* qnorm, float* out_vals,
                int* out_ids, int n_tiles, int num_docs, int q, int tile,
                int k_tile, float rank_blend, void* stream) {
  const fused_score::PackedBlocks bl{words, tfs, wpb};
  const fused_score::Pairs pr{pair_block, pair_tile, pair_cap,  pair_qw,
                              pair_bits,  pair_base, pair_count, n_pairs};
  const fused_score::TopkOut topk{norm,    rank,    qnorm,  out_vals,
                                  out_ids, n_tiles, k_tile, rank_blend};
  const Epi epi(topk);
  return fused_score::launch(bl, pr, epi, n_tiles, num_docs, q, tile, stream);
}

template <class Epi>
int occupancy_of(int wpb, int q, int tile, int* smem) {
  const fused_score::PackedBlocks bl{nullptr, nullptr, wpb};
  return fused_score::occupancy<Epi>(bl, q, tile, smem);
}

}  // namespace

#define FUSED_TOPK_PACKED_ARGS                                               \
  const unsigned *words, const unsigned short *tfs, int wpb,                 \
      const int *pair_block, const int *pair_tile, const int *pair_cap,      \
      const float *pair_qw, const int *pair_bits, const int *pair_base,      \
      const int *pair_count, int n_pairs, const float *norm,                 \
      const float *rank, const float *qnorm, float *out_vals, int *out_ids,  \
      int n_tiles, int num_docs, int q, int tile, int k_tile,                \
      float rank_blend, void *stream
#define FUSED_TOPK_PACKED_CALL                                               \
  words, tfs, wpb, pair_block, pair_tile, pair_cap, pair_qw, pair_bits,      \
      pair_base, pair_count, n_pairs, norm, rank, qnorm, out_vals, out_ids,  \
      n_tiles, num_docs, q, tile, k_tile, rank_blend, stream

extern "C" int fused_topk_packed_launch(FUSED_TOPK_PACKED_ARGS) {
  return launch_topk<fused_score::TopkOut>(FUSED_TOPK_PACKED_CALL);
}

extern "C" int fused_topk_packed_bitonic_launch(FUSED_TOPK_PACKED_ARGS) {
  return launch_topk<fused_score::BitonicOut>(FUSED_TOPK_PACKED_CALL);
}

extern "C" int fused_topk_packed_occupancy(int wpb, int q, int tile,
                                           int* smem) {
  return occupancy_of<fused_score::TopkOut>(wpb, q, tile, smem);
}

extern "C" int fused_topk_packed_bitonic_occupancy(int wpb, int q, int tile,
                                                   int* smem) {
  return occupancy_of<fused_score::BitonicOut>(wpb, q, tile, smem);
}
