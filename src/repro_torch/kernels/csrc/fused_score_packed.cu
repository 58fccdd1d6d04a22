// Packed dense kernel: replaces fused_score_packed_pallas
// (repro/kernels/fused_decode_score.py, body _fused_packed_kernel, decode
// _unpack_block_vmem).  Each routed pair reads one delta+bit-packed block
// and decodes it in registers and shared memory (tile_accumulate.cuh's
// PackedLoader).  See fused_score.cuh.
#include "fused_score.cuh"

extern "C" int fused_score_packed_launch(
    const unsigned* words, const unsigned short* tfs, const int* pair_block,
    const int* pair_cap, const float* pair_qw, const int* pair_bits,
    const int* pair_base, const int* pair_count, int wpb,
    const int* tile_start, float* out, int n_tiles, int num_docs, int q,
    int tile, void* stream) {
  const tile_acc::PackedLoader ld{words, tfs, pair_block, pair_bits,
                                  pair_base, pair_count, wpb};
  return fused_score::launch(ld, pair_cap, pair_qw, tile_start, out, n_tiles,
                             num_docs, q, tile, stream);
}
