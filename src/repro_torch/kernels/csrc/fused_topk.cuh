// Fused decode-and-score with in-kernel per-tile top-k, for sm_90a.
//
// Replaces the Pallas candidate kernels of repro/kernels/fused_decode_score.py
// (fused_topk_blocked_pallas, fused_topk_packed_pallas).  The loaders and the
// accumulation loop are shared with the dense kernels (tile_accumulate.cuh);
// the two .cu files differ only in the loader they pass.
//
// What bounds it: posting bytes read.  Every routed (block, tile) pair reads
// one 128-lane posting block (HOR: 512 B doc ids + 512 B f32 tfs; packed:
// 4*words_per_block B + 256 B f16 tfs), and the per-doc metadata (norm, rank)
// of every visited tile; only Q*k_tile candidates per tile are written.  At
// the 1M-doc tier that is tens of MB in, ~2 MB out, and a handful of flops
// per posting byte: far below the card's ops:byte ridge.
//
// Design: one CTA of 128 threads per doc tile; the wrapper hands CTA t its
// pair range [tile_start[t], tile_start[t+1]) of the tile-sorted routing
// pairs, so the [Q, tile] f32 accumulator lives in shared memory for the
// tile's whole run and the dense score row never reaches device memory (the
// TPU kernel's VMEM-resident accumulator).  The candidate reduction is
// k_tile warp-wide argmax passes per query row (value descending, lowest
// lane on ties).
//
// Bit parity with the reference: its XLA lowering contracts
// `cosine + rank_blend*rank` into a fused multiply-add, so that is
// __fmaf_rn here; the denominator product and the IEEE division
// (__fmul_rn, __fdiv_rn) are never contracted, and the tail is the
// reference's op sequence (query.final_scores).
#pragma once

#include <math_constants.h>

#include "tile_accumulate.cuh"

namespace fused_topk {

using tile_acc::kLanes;
using tile_acc::kWarps;

template <class Loader>
__global__ void __launch_bounds__(kLanes)
topk_kernel(Loader ld, const int* __restrict__ pair_cap,
            const float* __restrict__ pair_qw,
            const int* __restrict__ tile_start,
            const float* __restrict__ norm, const float* __restrict__ rank,
            const float* __restrict__ qnorm, float* __restrict__ out_vals,
            int* __restrict__ out_ids, int n_tiles, int num_docs, int q,
            int tile, int k_tile, float rank_blend) {
  extern __shared__ float acc[];     // [q][tile]
  __shared__ unsigned warp_sums[kWarps];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int p0 = tile_start[t];
  const int p1 = tile_start[t + 1];
  const size_t out_row = (size_t)n_tiles * k_tile;

  if (p0 == p1) {                    // no pair visits this tile
    for (int i = lane; i < q * k_tile; i += kLanes) {
      const size_t o = (i / k_tile) * out_row + (size_t)t * k_tile + i % k_tile;
      out_vals[o] = -CUDART_INF_F;
      out_ids[o] = -1;
    }
    return;
  }

  const int tile_base = t * tile;
  tile_acc::accumulate_run(ld, pair_cap, pair_qw, p0, p1, tile_base, q, tile,
                           acc, warp_sums);

  // scoring tail (query.final_scores): cosine + rank blend; deleted
  // (norm == 0, incl. lanes past num_docs) and zero scores -> -inf
  for (int i = lane; i < q * tile; i += kLanes) {
    const int qi = i / tile;
    const int doc = tile_base + i % tile;
    const float nm = doc < num_docs ? norm[doc] : 0.0f;
    const float rk = doc < num_docs ? rank[doc] : 0.0f;
    const float s = acc[i];
    const float denom = __fmul_rn(fmaxf(nm, 1e-12f), qnorm[qi]);
    const float fin = __fmaf_rn(rank_blend, rk, __fdiv_rn(s, denom));
    acc[i] = (nm > 0.0f && s > 0.0f) ? fin : -CUDART_INF_F;
  }
  __syncthreads();

  // k_tile successive maxima per query row, one warp per row
  const int warp = lane / 32;
  const int wl = lane % 32;
  for (int qi = warp; qi < q; qi += kWarps) {
    float* row = acc + qi * tile;
    for (int j = 0; j < k_tile; ++j) {
      float best = -CUDART_INF_F;
      int bl = tile;
      for (int l = wl; l < tile; l += 32) {
        const float v = row[l];
        if (v > best || (v == best && l < bl)) { best = v; bl = l; }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, o);
        const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
        if (ov > best || (ov == best && ol < bl)) { best = ov; bl = ol; }
      }
      if (wl == 0) {
        const size_t o = qi * out_row + (size_t)t * k_tile + j;
        out_vals[o] = best;
        out_ids[o] = isfinite(best) ? tile_base + bl : -1;
      }
      if (bl < tile && bl % 32 == wl) row[bl] = -CUDART_INF_F;
      __syncwarp();
    }
  }
}

template <class Loader>
int launch(const Loader& ld, const int* pair_cap, const float* pair_qw,
           const int* tile_start, const float* norm, const float* rank,
           const float* qnorm, float* out_vals, int* out_ids, int n_tiles,
           int num_docs, int q, int tile, int k_tile, float rank_blend,
           void* stream) {
  const size_t smem = (size_t)q * tile * sizeof(float);
  const int e = tile_acc::allow_smem(topk_kernel<Loader>, smem);
  if (e != 0) return e;
  topk_kernel<Loader><<<n_tiles, kLanes, smem, (cudaStream_t)stream>>>(
      ld, pair_cap, pair_qw, tile_start, norm, rank, qnorm, out_vals, out_ids,
      n_tiles, num_docs, q, tile, k_tile, rank_blend);
  return (int)cudaGetLastError();
}

}  // namespace fused_topk
