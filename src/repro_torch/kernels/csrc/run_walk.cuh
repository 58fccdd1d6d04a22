// A CTA's run of tile-sorted routing pairs, found on the device, and the
// asynchronous copies that stage a run into shared memory, for sm_90a.
// Shared by the single-query posting scorer (posting_score.cu) and the
// four fused scorers (fused_score.cuh).
//
// The pair arrays are sorted by doc tile; padding pairs sit at tile
// n_tiles, past every CTA.  CTA t owns the pairs [p0, p1) with
// pair_tile == t.  It finds both bounds itself, so a launch needs no
// array of run starts made before it (an arange, a searchsorted and a
// cast: three device launches): warp 0 searches for t and warp 1 for
// t + 1, each a 32-ary search.  Every lane loads one sample,
// __ballot_sync counts the samples below the key, and the range shrinks
// 32-fold per step: 5 dependent loads at 2^25 pairs, 6 at 2^27.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace run_walk {

// The first index in [0, n) whose a[] is >= key (n if none), over sorted
// a, by one whole warp: 32 samples per step; the lanes whose sample is
// below key come first, so the ballot's count places the bound between
// two samples.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a,
                                                int n, int key) {
  const int lane = threadIdx.x % 32;
  int lo = 0, hi = n;                  // the bound lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + (lane + 1) * step - 1;
    const bool below = idx < hi && a[idx] < key;
    lo += __popc(__ballot_sync(0xffffffffu, below)) * step;
    hi = min(hi, lo + step - 1);
  }
  const int idx = lo + lane;
  const bool below = idx < hi && a[idx] < key;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// Tile t's run [p0, p1) of the n sorted pair tiles: warps 0 and 1 search
// at once and meet in `run` (two ints of shared memory).  Every thread of
// the CTA (at least 64) calls it: it ends on a barrier.
__device__ __forceinline__ int2 find_run(const int* __restrict__ pair_tile,
                                         int n, int t, int* run) {
  const int warp = threadIdx.x / 32;
  if (warp < 2) {
    const int bound = warp_lower_bound(pair_tile, n, t + warp);
    if (threadIdx.x % 32 == 0) run[warp] = bound;
  }
  __syncthreads();
  return make_int2(run[0], run[1]);
}

// cp.async: a copy from device memory into shared memory that the
// thread does not wait for.  Copies issued since the last commit form a
// group; wait_all waits for every group of the thread, and a barrier
// after it makes all threads' copies visible to the CTA.
__device__ __forceinline__ void copy4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows rows[0..n) of `bytes` bytes each, from src + rows[j] * bytes to
// dst + j * dst_stride, by all `threads` threads of the CTA, in 16-byte
// copies where src and the row size allow them, else 4-byte ones.
// `bytes` is a multiple of 4; dst and dst_stride are multiples of 16.
// While a row has at most `threads` copy units, a thread copies one unit
// of every (threads / units)-th row: one division per call, none per copy.
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_stride,
                                          const unsigned char* src,
                                          const int* rows, int n, int bytes,
                                          int threads) {
  const bool wide = ((reinterpret_cast<uintptr_t>(src) | bytes) & 15) == 0;
  const int unit = wide ? 16 : 4;
  const int units = bytes / unit;
  if (units > threads) {             // a row wider than the CTA
    for (int j = 0; j < n; ++j)
      for (int off = threadIdx.x * unit; off < bytes; off += threads * unit) {
        const unsigned char* s = src + (size_t)rows[j] * bytes + off;
        if (wide)
          copy16(dst + j * dst_stride + off, s);
        else
          copy4(dst + j * dst_stride + off, s);
      }
    return;
  }
  const int step = threads / units;            // rows at once
  const int j0 = threadIdx.x / units;
  if (j0 >= step) return;
  const int off = (threadIdx.x - j0 * units) * unit;
  for (int j = j0; j < n; j += step) {
    unsigned char* d = dst + j * dst_stride + off;
    const unsigned char* s = src + (size_t)rows[j] * bytes + off;
    if (wide)
      copy16(d, s);
    else
      copy4(d, s);
  }
}

// `bytes` contiguous bytes (a multiple of 4) from src to dst (16-byte
// aligned) by all `threads` threads, in 16-byte copies where src and
// the size allow them, else 4-byte ones.
__device__ __forceinline__ void copy_span(unsigned char* dst,
                                          const unsigned char* src,
                                          int bytes, int threads) {
  const bool wide = ((reinterpret_cast<uintptr_t>(src) | bytes) & 15) == 0;
  const int unit = wide ? 16 : 4;
  for (int off = threadIdx.x * unit; off < bytes; off += threads * unit) {
    if (wide)
      copy16(dst + off, src + off);
    else
      copy4(dst + off, src + off);
  }
}

}  // namespace run_walk
