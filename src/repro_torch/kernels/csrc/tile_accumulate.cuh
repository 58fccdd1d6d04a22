// Shared body of the port's fused decode-and-score kernels, for sm_90a:
// the posting-block loaders and the per-tile accumulation loop that both
// kernel families run (fused_topk.cuh: per-tile candidates; fused_score.cuh:
// dense [Q, num_docs] scores).  Replaces the per-step scoring body of the
// Pallas kernels in repro/kernels/fused_decode_score.py
// (_tile_contribution, and _unpack_block_vmem for packed blocks).
//
// One CTA of 128 threads (thread == block lane) owns one doc tile and walks
// that tile's run [p0, p1) of the tile-sorted routing pairs.  Each pair
// loads ONE 128-lane posting block and adds qw[q] * tf into the [Q, tile]
// f32 accumulator in shared memory.  Doc ids are unique within a block, so
// one pair's lanes never collide: plain adds, no atomics, and a barrier
// between pairs keeps the adds in pair order, which is the reference's
// order.  The reference's XLA lowering contracts `acc + qw*tf` into a fused
// multiply-add; so does this loop (__fmaf_rn, built with -fmad=false so
// nothing else contracts).
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace tile_acc {

constexpr int kLanes = 128;          // posting block width == threads per CTA
constexpr int kWarps = kLanes / 32;

// HOR block: raw i32 doc ids and f32 tfs (1 KB per block).
struct BlockedLoader {
  const int* docs;        // [NB, 128]
  const float* tfs;       // [NB, 128]
  const int* pair_block;  // [NP]

  __device__ __forceinline__ void load(int p, int lane, unsigned*, int& doc,
                                       float& tf) const {
    const size_t at = (size_t)pair_block[p] * kLanes + lane;
    doc = docs[at];
    tf = tfs[at];
  }
};

// Packed block: delta+bit-packed u32 words and f16 tfs, decoded in
// registers and shared memory, so only compressed posting bytes cross
// device memory.
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
  // Every thread of the CTA must call it (it holds a barrier).
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
    tf = __half2float(__ushort_as_half(tfs[b * kLanes + lane]));
  }
};

// Zero the [q][tile] accumulator `acc`, then add the pairs [p0, p1) in
// order: each pair's lanes that fall in the tile (based at tile_base) and
// below the pair's cap add qw[qi] * tf with one rounding.  Ends on a
// barrier, so `acc` is complete when it returns.  Every thread calls it.
template <class Loader>
__device__ __forceinline__ void accumulate_run(
    const Loader& ld, const int* __restrict__ pair_cap,
    const float* __restrict__ pair_qw, int p0, int p1, int tile_base, int q,
    int tile, float* acc, unsigned* warp_sums) {
  const int lane = threadIdx.x;
  for (int i = lane; i < q * tile; i += kLanes) acc[i] = 0.0f;
  __syncthreads();
  for (int p = p0; p < p1; ++p) {
    int doc;
    float tf;
    ld.load(p, lane, warp_sums, doc, tf);
    const int local = doc - tile_base;
    if (doc >= 0 && local >= 0 && local < tile && lane < pair_cap[p]) {
      const float* qw = pair_qw + (size_t)p * q;
      for (int qi = 0; qi < q; ++qi) {
        float* a = acc + qi * tile + local;
        *a = __fmaf_rn(qw[qi], tf, *a);
      }
    }
    __syncthreads();
  }
}

// Allow `smem` bytes of dynamic shared memory for `kernel` (above the
// 48 KB default only on request); returns the cudaError_t as an int.
template <class Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace tile_acc
