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
// as XLA does; a node with no valid neighbour gets 0 for min and max; std
// is sqrt(var + eps), eps an argument (PnaConfig.eps, 1e-5 by default).  An
// id >= Nsrc is refused here: the group that reads it prints the id and
// traps before any row is read, which fails the launch (the next
// synchronising call raises).
//
// What bounds it: bytes, and the latency of a gather.  Each valid
// neighbour reads one D-wide f32 row at a random place in a table far
// larger than L2 (735 MB at ogbn-products), 300 B at d_hidden 75, which
// touches 10 or 11 32-byte sectors; each node writes 4D floats.  A handful
// of operations per element read.  A 300-byte stride is not a multiple of
// 16 bytes, so TMA cannot describe the table: rows come by plain loads.
//
// Design: a warp owns one node at a time; the warps of the grid walk the
// nodes with a stride, as many CTAs as fit on the card at once, so no CTA
// waits on its slowest node.  The warp reads the node's list once,
// coalesced, kChunk slots at a time, checks the ids' range with one
// ballot, and compacts the valid ids in list order into shared memory (a
// ballot and a prefix count), so padding costs no load and no step
// wherever it sits.  Lane l owns columns c0 + l + 32 p for the P passes of
// a column block, so a row is read by neighbouring lanes in one piece.
// kSlots neighbours' rows are loaded before the first of them is added, so
// each lane keeps kSlots * P loads in flight; the adds then run in list
// order, which keeps the bits.  On the card 4 rows in flight (48
// registers) tie 8 and 16 rows and a half warp per node at ogbn-products,
// within 1.3x of the gather floor, and beat them where few nodes leave
// warps idle (PERF.md §6).  All index math is 32-bit except the row and
// output offsets; there is no division.  The output is written with
// streaming stores, coalesced across the lanes.
#include <cstdio>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kChunk = 64;       // list slots compacted per step of a node
constexpr int kSlots = 4;        // neighbour rows loaded before their adds

__device__ __noinline__ void report_id(int id, int node, int slot,
                                       long long rows) {
  printf("pna_multi_agg: nbr holds id %d (node %d, slot %d), past the %lld "
         "rows it indexes\n", id, node, slot, rows);
}

struct Agg {
  float s, ssq, mn, mx;
};

__device__ __forceinline__ void add(Agg& a, float row) {
  a.s = __fadd_rn(a.s, row);
  a.ssq = __fmaf_rn(row, row, a.ssq);
  if (row < a.mn || (row == a.mn && signbit(row))) a.mn = row;
  if (row > a.mx || (row == a.mx && !signbit(row))) a.mx = row;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
pna_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
           float* __restrict__ out, int nodes, int k, int dim,
           long long rows, float eps) {
  __shared__ int valid_ids[kWarps][kChunk];
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  int* ids = valid_ids[threadIdx.x / 32];
  for (int node = blockIdx.x * kWarps + threadIdx.x / 32; node < nodes;
       node += gridDim.x * kWarps) {
    const int* list = nbr + (size_t)node * k;
    float* o = out + (size_t)node * 4 * dim;
    for (int c0 = 0; c0 < dim; c0 += P * 32) {
      const int col = c0 + lane;
      Agg a[P];
#pragma unroll
      for (int p = 0; p < P; ++p)
        a[p] = {0.0f, 0.0f, __int_as_float(0x7f800000),
                __int_as_float(0xff800000)};
      int cnt = 0;
      for (int h0 = 0; h0 < k; h0 += kChunk) {
        // the chunk's valid ids, compacted in list order
        int n = 0;
#pragma unroll
        for (int j = 0; j < kChunk; j += 32) {
          const int h = h0 + j + lane;
          const int id = h < k ? __ldg(list + h) : -1;
          const unsigned bad = __ballot_sync(kAll, id >= rows);
          if (bad) {
            if (lane == __ffs(bad) - 1) report_id(id, node, h, rows);
            __syncwarp();
            __trap();
          }
          const unsigned ok = __ballot_sync(kAll, id >= 0);
          if (id >= 0) ids[n + __popc(ok & below)] = id;
          n += __popc(ok);
        }
        __syncwarp();
        for (int i = 0; i < n; i += kSlots) {
          float v[kSlots][P];
#pragma unroll
          for (int u = 0; u < kSlots; ++u) {
            if (i + u < n) {
              const float* r = feats + (size_t)ids[i + u] * dim + col;
#pragma unroll
              for (int p = 0; p < P; ++p)
                v[u][p] = col + 32 * p < dim ? __ldg(r + 32 * p) : 0.0f;
            }
          }
#pragma unroll
          for (int u = 0; u < kSlots; ++u) {
            if (i + u < n) {
#pragma unroll
              for (int p = 0; p < P; ++p) add(a[p], v[u][p]);
            }
          }
        }
        cnt += n;
        __syncwarp();
      }
      const float nn = fmaxf((float)cnt, 1.0f);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int c = col + 32 * p;
        if (c >= dim) continue;
        const float mean = __fdiv_rn(a[p].s, nn);
        const float var =
            fmaxf(__fmaf_rn(-mean, mean, __fdiv_rn(a[p].ssq, nn)), 0.0f);
        __stcs(o + c, mean);
        __stcs(o + dim + c, isfinite(a[p].mn) ? a[p].mn : 0.0f);
        __stcs(o + 2 * dim + c, isfinite(a[p].mx) ? a[p].mx : 0.0f);
        __stcs(o + 3 * dim + c, __fsqrt_rn(__fadd_rn(var, eps)));
      }
    }
  }
}

template <int P>
int launch(const float* feats, const int* nbr, float* out, int nodes, int k,
           int dim, long long rows, float eps, cudaStream_t stream) {
  // CTAs resident on the card at once, found once per process
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pna_kernel<P>,
                                                  kThreads, 0);
    resident = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const int need = (int)(((long long)nodes + kWarps - 1) / kWarps);
  pna_kernel<P><<<need < resident ? need : resident, kThreads, 0, stream>>>(
      feats, nbr, out, nodes, k, dim, rows, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// P column passes of 32 per block of columns: ceil(dim / 32), at most 4
extern "C" int pna_multi_agg_launch(const float* feats, const int* nbr,
                                    float* out, int nodes, int k, int dim,
                                    long long rows, float eps,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch ((dim + 31) / 32) {
    case 1: return launch<1>(feats, nbr, out, nodes, k, dim, rows, eps, s);
    case 2: return launch<2>(feats, nbr, out, nodes, k, dim, rows, eps, s);
    case 3: return launch<3>(feats, nbr, out, nodes, k, dim, rows, eps, s);
    default: return launch<4>(feats, nbr, out, nodes, k, dim, rows, eps, s);
  }
}
