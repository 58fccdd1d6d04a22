// The packed-block decode shared by the port's packed kernels, for
// sm_90a: each lane's delta (packed_delta: the fused packed scorers of
// fused_score.cuh and unpack_blocks.cu) and the CTA-wide prefix sum that
// turns deltas into doc ids (block_inclusive_scan: unpack_blocks.cu).
// Replaces the decode of the Pallas kernels in
// repro/kernels/fused_decode_score.py (_unpack_block_vmem) and
// repro/kernels/packed_postings.py.
#pragma once

#include <cuda_runtime.h>

namespace tile_acc {

// Lane `lane`'s delta in a delta+bit-packed block of `wpb` u32 words at
// `bits` bits per lane: it sits at bit lane*bits and spans the next word
// when the bit offset is nonzero.  Shifts by 32 are undefined in C, so the
// second word is read only for off > 0 and the mask is all ones for
// bits >= 32 (the reference's guards); both word indices are clamped to the
// block.  The decode of the fused packed kernels and of unpack_blocks.cu.
__device__ __forceinline__ unsigned packed_delta(const unsigned* w, int wpb,
                                                 unsigned bits, int lane) {
  const unsigned bitpos = (unsigned)lane * bits;
  const int wi = min((int)(bitpos >> 5), wpb - 1);
  const unsigned off = bitpos & 31u;
  const unsigned lo = w[wi] >> off;
  const unsigned hi = off ? (w[min(wi + 1, wpb - 1)] << (32u - off)) : 0u;
  const unsigned mask = bits >= 32u ? 0xffffffffu : ((1u << bits) - 1u);
  return (lo | hi) & mask;
}

// Inclusive prefix sum of x over the CTA's threads (a multiple of 32, at
// most 1024), in wrapping 32-bit arithmetic: a shuffle scan within each
// warp, then each thread adds the totals of the warps before it.
// `warp_sums` holds one slot per warp.  Every thread of the CTA must call
// it (it holds a barrier); the caller orders the next write to warp_sums.
__device__ __forceinline__ unsigned block_inclusive_scan(unsigned x,
                                                         unsigned* warp_sums) {
  const int wl = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (wl >= o) x += y;
  }
  if (wl == 31) warp_sums[warp] = x;
  __syncthreads();
  unsigned pre = 0;
  for (int i = 0; i < warp; ++i) pre += warp_sums[i];
  return pre + x;
}

}  // namespace tile_acc
