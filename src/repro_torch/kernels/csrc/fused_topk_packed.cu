// Packed candidate kernel: replaces fused_topk_packed_pallas
// (repro/kernels/fused_decode_score.py), whose in-VMEM decode is
// _unpack_block_vmem.  Each routed pair reads one delta+bit-packed block
// (4*words_per_block B of u32 words + 256 B of f16 tfs) and decodes it in
// registers and shared memory (tile_accumulate.cuh's PackedLoader).  See
// fused_topk.cuh for the scoring and reduction body.
#include "fused_topk.cuh"

extern "C" int fused_topk_packed_launch(
    const unsigned* words, const unsigned short* tfs, const int* pair_block,
    const int* pair_cap, const float* pair_qw, const int* pair_bits,
    const int* pair_base, const int* pair_count, int wpb,
    const int* tile_start, const float* norm, const float* rank,
    const float* qnorm, float* out_vals, int* out_ids, int n_tiles,
    int num_docs, int q, int tile, int k_tile, float rank_blend,
    void* stream) {
  const tile_acc::PackedLoader ld{words, tfs, pair_block, pair_bits,
                                  pair_base, pair_count, wpb};
  return fused_topk::launch(ld, pair_cap, pair_qw, tile_start, norm, rank,
                            qnorm, out_vals, out_ids, n_tiles, num_docs, q,
                            tile, k_tile, rank_blend, stream);
}
