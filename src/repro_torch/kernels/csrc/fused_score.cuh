// Fused decode-and-score to dense per-query scores, for sm_90a.
//
// Replaces the dense Pallas kernels of repro/kernels/fused_decode_score.py
// (fused_score_blocked_pallas, body _fused_blocked_kernel;
// fused_score_packed_pallas, body _fused_packed_kernel).  They carry
// mode="dense" and both bands of every banded segment, whose two partial
// score arrays the engine sums before the scoring tail.
//
// What bounds it: bytes.  Every routed (block, tile) pair reads one posting
// block (HOR 1 KB; packed 4*words_per_block B + 256 B), and the kernel
// writes the whole f32 [Q, num_docs] score array (8 queries x 1M docs =
// 32 MB at the 1M-doc tier, more than the posting bytes of a batch); a
// handful of flops per byte, far below the card's ops:byte ridge.
//
// Design: one CTA of 128 threads per doc tile walks that tile's run of
// tile-sorted pairs into a shared-memory [Q, tile] accumulator
// (tile_accumulate.cuh, shared with the candidate kernels), then writes the
// tile's Q rows straight into out[Q, num_docs], coalesced along the docs and
// clipped at num_docs.  The Pallas kernel writes (n_tiles + 1, Q, tile)
// blocks that a transpose turns into [Q, num_docs]; here the layout is
// written directly.  A tile no pair visits writes zeros (the reference's
// _finish), and the pad tile n_tiles of overflow and padding pairs has no
// CTA, so it is never written.
#pragma once

#include "tile_accumulate.cuh"

namespace fused_score {

using tile_acc::kLanes;
using tile_acc::kWarps;

template <class Loader>
__global__ void __launch_bounds__(kLanes)
score_kernel(Loader ld, const int* __restrict__ pair_cap,
             const float* __restrict__ pair_qw,
             const int* __restrict__ tile_start, float* __restrict__ out,
             int num_docs, int q, int tile) {
  extern __shared__ float acc[];     // [q][tile]
  __shared__ unsigned warp_sums[kWarps];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int p0 = tile_start[t];
  const int p1 = tile_start[t + 1];
  const int tile_base = t * tile;
  const int width = min(tile, num_docs - tile_base);   // clipped last tile

  if (p0 == p1) {                    // no pair visits this tile: zeros
    for (int i = lane; i < q * width; i += kLanes)
      out[(size_t)(i / width) * num_docs + tile_base + i % width] = 0.0f;
    return;
  }
  tile_acc::accumulate_run(ld, pair_cap, pair_qw, p0, p1, tile_base, q, tile,
                           acc, warp_sums);
  for (int i = lane; i < q * width; i += kLanes) {
    const int qi = i / width;
    const int l = i % width;
    out[(size_t)qi * num_docs + tile_base + l] = acc[qi * tile + l];
  }
}

template <class Loader>
int launch(const Loader& ld, const int* pair_cap, const float* pair_qw,
           const int* tile_start, float* out, int n_tiles, int num_docs,
           int q, int tile, void* stream) {
  const size_t smem = (size_t)q * tile * sizeof(float);
  const int e = tile_acc::allow_smem(score_kernel<Loader>, smem);
  if (e != 0) return e;
  score_kernel<Loader><<<n_tiles, kLanes, smem, (cudaStream_t)stream>>>(
      ld, pair_cap, pair_qw, tile_start, out, num_docs, q, tile);
  return (int)cudaGetLastError();
}

}  // namespace fused_score
