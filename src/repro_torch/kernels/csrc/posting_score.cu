// Single-query posting scorer, for sm_90a.  Replaces posting_score_pallas
// (repro/kernels/posting_score.py, body _score_kernel, and the finish that
// zeroes the tiles no pair visits), the dense scorer behind
// ops.blocked_query_scores.
//
// What it computes: tile-sorted (block, tile, weight) routing pairs over a
// BlockedIndex's i32 [NB, block] doc ids and f32 tfs; for each pair, the
// block's lanes whose doc falls in the tile add tf * w into an f32
// [num_docs] score vector.  Tiles no pair visits come out as 0.
//
// What bounds it: bytes.  Each routed pair reads one posting block (8 B per
// lane) and the kernel writes the whole f32 score vector (4 MB at the
// 1M-doc tier, more than a query's posting bytes); one multiply and one add
// per lane, far below the card's ops:byte ridge.
//
// Design: one CTA of 128 threads per doc tile walks that tile's run
// [tile_start[t], tile_start[t+1]) of the pairs into a [tile] f32
// accumulator in shared memory, then writes the tile straight into the
// score vector, clipped at num_docs.  A block's doc ids are unique, so one
// pair's lanes never collide: plain adds, no atomics, and a barrier between
// pairs keeps the adds in pair order, the reference's order.  The Pallas
// kernel rounds w = tf * pair_w first and adds it to the accumulator through
// a one-hot matmul: XLA does not contract that into a fused multiply-add
// (checked on the CPU against the kernel in interpret mode), so this kernel
// multiplies then adds (__fmul_rn, __fadd_rn; built with -fmad=false).
// Blocks of any width are read, threads striding over the lanes.  The pad
// tile n_tiles of padding pairs has no CTA.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
posting_score_kernel(const int* __restrict__ docs,
                     const float* __restrict__ tfs, int block,
                     const int* __restrict__ pair_block,
                     const float* __restrict__ pair_w,
                     const int* __restrict__ tile_start,
                     float* __restrict__ out, int num_docs, int tile) {
  extern __shared__ float acc[];     // [tile]
  const int t = blockIdx.x;
  const int p0 = tile_start[t];
  const int p1 = tile_start[t + 1];
  const int tile_base = t * tile;
  const int width = min(tile, num_docs - tile_base);   // clipped last tile

  if (p0 == p1) {                    // no pair visits this tile: zeros
    for (int i = threadIdx.x; i < width; i += kThreads)
      out[tile_base + i] = 0.0f;
    return;
  }
  for (int i = threadIdx.x; i < tile; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  for (int p = p0; p < p1; ++p) {
    const size_t row = (size_t)pair_block[p] * block;
    const float w = pair_w[p];
    for (int lane = threadIdx.x; lane < block; lane += kThreads) {
      const int doc = docs[row + lane];
      const int local = doc - tile_base;
      if (doc >= 0 && local >= 0 && local < tile)
        acc[local] = __fadd_rn(acc[local], __fmul_rn(tfs[row + lane], w));
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < width; i += kThreads)
    out[tile_base + i] = acc[i];
}

}  // namespace

extern "C" int posting_score_launch(const int* docs, const float* tfs,
                                    int block, const int* pair_block,
                                    const float* pair_w,
                                    const int* tile_start, float* out,
                                    int n_tiles, int num_docs, int tile,
                                    void* stream) {
  const size_t smem = (size_t)tile * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        posting_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  posting_score_kernel<<<n_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      docs, tfs, block, pair_block, pair_w, tile_start, out, num_docs, tile);
  return (int)cudaGetLastError();
}
