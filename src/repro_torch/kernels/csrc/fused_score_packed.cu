// Packed dense kernel: replaces fused_score_packed_pallas
// (repro/kernels/fused_decode_score.py, body _fused_packed_kernel, decode
// _unpack_block_vmem).  Each routed pair reads one delta+bit-packed block,
// staged compressed into shared memory with cp.async and decoded there,
// one warp per pair.  See fused_score.cuh.
#include "fused_score.cuh"

extern "C" int fused_score_packed_launch(
    const unsigned* words, const unsigned short* tfs, int wpb,
    const int* pair_block, const int* pair_tile, const int* pair_cap,
    const float* pair_qw, const int* pair_bits, const int* pair_base,
    const int* pair_count, int n_pairs, float* out, int n_tiles,
    int num_docs, int q, int tile, void* stream) {
  const fused_score::PackedBlocks bl{words, tfs, wpb};
  const fused_score::Pairs pr{pair_block, pair_tile, pair_cap,  pair_qw,
                              pair_bits,  pair_base, pair_count, n_pairs};
  const fused_score::DenseOut epi{out};
  return fused_score::launch(bl, pr, epi, n_tiles, num_docs, q, tile, stream);
}

extern "C" int fused_score_packed_occupancy(int wpb, int q, int tile,
                                            int* smem) {
  const fused_score::PackedBlocks bl{nullptr, nullptr, wpb};
  return fused_score::occupancy<fused_score::DenseOut>(bl, q, tile, smem);
}
