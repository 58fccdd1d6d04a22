// Fused PNA multi-aggregator, for sm_90a.  Replaces pna_multi_agg_pallas
// (repro/kernels/segment_multi_agg.py, body _pna_kernel), the kernel behind
// ops.pna_multi_agg.
//
// What it computes: feats f32 [Nsrc, D], nbr i32 [N, K] (-1 = padding) ->
// f32 [N, 4D] = [mean | min | max | std] of each node's valid neighbour
// rows, the neighbours taken in list order.  The arithmetic is the Pallas
// kernel's as XLA runs it on the CPU, which contracts two multiply-adds
// (checked against the kernel in interpret mode): ssq = fma(row, row, ssq)
// and var = fma(-mean, mean, ssq / n).  Here they are __fmaf_rn; the build
// has -fmad=false, so nothing else is contracted.  n = max(cnt, 1); division
// and square root are correctly rounded; min and max order -0.0 below +0.0
// as XLA does; a node with no valid neighbour gets 0 for min and max.
//
// What bounds it: bytes.  Each valid neighbour reads one D-wide f32 row at
// a random place (300 B at d_hidden 75), each node writes 4D floats; a
// handful of operations per element read.  The least traffic reads each
// feats row once, but every neighbour list reads its rows again: at
// ogbn-products' mean degree that is ~50 row reads per node, most from
// device memory, since the 735 MB feature table does not fit in L2.
//
// Design: one thread per (node, column), threads laid flat over [N, D], so
// a row is read by neighbouring threads in one piece and a warp spans
// parts of two nodes when D is not a multiple of 32.  The threads of a node
// read the same neighbour id (a broadcast load).  Each thread keeps its
// four accumulators in registers and writes its four outputs, each
// coalesced across the warp.  No shared memory, no atomics.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;    // under std's square root (EPS in Python)

__global__ void __launch_bounds__(kThreads)
pna_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
           float* __restrict__ out, long long total, int k, int dim) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= total) return;
  const long long node = g / dim;
  const int col = (int)(g - node * dim);
  const int* list = nbr + node * k;
  float s = 0.0f, ssq = 0.0f, cnt = 0.0f;
  float mn = __int_as_float(0x7f800000), mx = __int_as_float(0xff800000);
  for (int h = 0; h < k; ++h) {
    const int j = list[h];
    if (j < 0) continue;
    const float row = feats[(long long)j * dim + col];
    s = __fadd_rn(s, row);
    ssq = __fmaf_rn(row, row, ssq);
    if (row < mn || (row == mn && signbit(row))) mn = row;
    if (row > mx || (row == mx && !signbit(row))) mx = row;
    cnt = __fadd_rn(cnt, 1.0f);
  }
  const float n = fmaxf(cnt, 1.0f);
  const float mean = __fdiv_rn(s, n);
  const float var = fmaxf(__fmaf_rn(-mean, mean, __fdiv_rn(ssq, n)), 0.0f);
  const float std = __fsqrt_rn(__fadd_rn(var, kEps));
  float* o = out + node * 4 * dim + col;
  o[0] = mean;
  o[dim] = isfinite(mn) ? mn : 0.0f;
  o[2 * dim] = isfinite(mx) ? mx : 0.0f;
  o[3 * dim] = std;
}

}  // namespace

extern "C" int pna_multi_agg_launch(const float* feats, const int* nbr,
                                    float* out, int nodes, int k, int dim,
                                    void* stream) {
  const long long total = (long long)nodes * dim;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  pna_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      feats, nbr, out, total, k, dim);
  return (int)cudaGetLastError();
}
