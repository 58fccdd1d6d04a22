// Packed candidate kernel: replaces fused_topk_packed_pallas
// (repro/kernels/fused_decode_score.py), whose in-VMEM decode is
// _unpack_block_vmem.  Each routed pair reads one delta+bit-packed block
// (4*words_per_block B of u32 words + 256 B of f16 tfs) and decodes it in
// registers and shared memory: only compressed posting bytes cross device
// memory.  See fused_topk.cuh for the shared scoring and reduction body.
#include "fused_topk.cuh"

namespace {

struct PackedLoader {
  const unsigned* words;        // [NB, wpb] u32
  const unsigned short* tfs;    // [NB, 128] f16 bits
  const int* pair_block;        // [NP]
  const int* pair_bits;         // [NP]
  const int* pair_base;         // [NP]
  const int* pair_count;        // [NP]
  int wpb;

  // Lane `lane`'s delta sits at bit lane*bits and spans the next word when
  // the bit offset is nonzero.  Shifts by 32 are undefined in C, so the
  // second word is read only for off > 0 and the mask is all ones for
  // bits >= 32 (the reference's guards).  Doc id = base + inclusive prefix
  // sum of the deltas over the 128 lanes, in wrapping 32-bit arithmetic.
  __device__ __forceinline__ void load(int p, int lane, unsigned* warp_sums,
                                       int& doc, float& tf) const {
    const size_t b = (size_t)pair_block[p];
    const unsigned bits = (unsigned)pair_bits[p];
    const unsigned* w = words + b * wpb;
    const unsigned bitpos = (unsigned)lane * bits;
    const int wi = min((int)(bitpos >> 5), wpb - 1);
    const unsigned off = bitpos & 31u;
    const unsigned lo = w[wi] >> off;
    const unsigned hi = off ? (w[min(wi + 1, wpb - 1)] << (32u - off)) : 0u;
    const unsigned mask = bits >= 32u ? 0xffffffffu : ((1u << bits) - 1u);
    unsigned x = (lo | hi) & mask;

    const int wl = lane % 32;
    const int warp = lane / 32;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
      if (wl >= o) x += y;
    }
    if (wl == 31) warp_sums[warp] = x;
    __syncthreads();   // the caller's per-pair barrier orders the next write
    unsigned pre = 0;
    for (int i = 0; i < warp; ++i) pre += warp_sums[i];
    doc = lane < pair_count[p] ? (int)((unsigned)pair_base[p] + pre + x) : -1;
    tf = __half2float(__ushort_as_half(tfs[b * fused_topk::kLanes + lane]));
  }
};

}  // namespace

extern "C" int fused_topk_packed_launch(
    const unsigned* words, const unsigned short* tfs, const int* pair_block,
    const int* pair_cap, const float* pair_qw, const int* pair_bits,
    const int* pair_base, const int* pair_count, int wpb,
    const int* tile_start, const float* norm, const float* rank,
    const float* qnorm, float* out_vals, int* out_ids, int n_tiles,
    int num_docs, int q, int tile, int k_tile, float rank_blend,
    void* stream) {
  const PackedLoader ld{words, tfs, pair_block, pair_bits, pair_base,
                        pair_count, wpb};
  return fused_topk::launch(ld, pair_cap, pair_qw, tile_start, norm, rank,
                            qnorm, out_vals, out_ids, n_tiles, num_docs, q,
                            tile, k_tile, rank_blend, stream);
}
