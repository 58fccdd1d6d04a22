// The packed-block decode of the port's fused packed kernels, for sm_90a:
// each lane's delta (packed_delta, fused_score.cuh; unpack_blocks.cu does
// the same arithmetic as a funnel shift from a running bit position).
// Replaces the decode of the Pallas kernels in
// repro/kernels/fused_decode_score.py (_unpack_block_vmem).
#pragma once

#include <cuda_runtime.h>

namespace tile_acc {

// Lane `lane`'s delta in a delta+bit-packed block of `wpb` u32 words at
// `bits` bits per lane: it sits at bit lane*bits and spans the next word
// when the bit offset is nonzero.  Shifts by 32 are undefined in C, so the
// second word is read only for off > 0 and the mask is all ones for
// bits >= 32 (the reference's guards); both word indices are clamped to the
// block.
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

}  // namespace tile_acc
