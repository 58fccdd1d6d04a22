// Fixed-arity multi-hot EmbeddingBag, for sm_90a.  Replaces
// embedding_bag_pallas (repro/kernels/embedding_bag.py, body _bag_kernel),
// the kernel behind ops.embedding_bag.
//
// What it computes: table [V, D] (f32 or bf16), indices i32 [B, H] with -1
// as padding -> out [B, D] in the table's dtype, out[b] = the sum of the
// bag's H rows added in slot order h = 0..H-1.  Like the Pallas kernel's
// accumulator, the sum is kept in the table's dtype: each add is computed
// in f32 and rounded to the table's dtype (one bf16 rounding per slot for
// a bf16 table).  A padding slot adds +0.0.  An id >= V is refused here:
// the thread that reads it prints the id and traps before reading the row,
// which fails the launch (the next synchronising call raises).
//
// What bounds it: bytes, and the latency of a gather.  Each valid slot
// reads one D-wide row at a random place in a table far larger than L2
// (1.56 GB for xDeepFM's fused field table), 40 B for its f32 rows of 10,
// which always touch two 32-byte sectors; each bag writes one row.  One
// add per element read.  A 40-byte stride is not a multiple of 16 bytes,
// so TMA cannot describe the table: rows come by plain vector loads.
//
// Design: one thread per (bag, vector) item of the output, where a vector
// is the widest of 16, 8, 4 or 2 bytes that divides the row's bytes and
// the table's address (8 bytes for a 40-byte row: 5 items per bag).  A
// warp takes 32 * ITEMS consecutive items, interleaved by 32, so each
// load and store instruction covers 32 consecutive items: a row is read
// by neighbouring lanes (the sectors they share are requested once) and
// the output is written fully coalesced, with no staging.  Each thread
// loads its items' G slots' ids, then issues all ITEMS * G row loads
// before the first add; the adds then run in slot order, which keeps the
// bits.  ITEMS is 4, or 1 where the batch is too small to fill the card;
// G is 1 for one-hot bags, else 8.  Measured on the card against a thread
// per bag (five 8-byte loads of one lane per row, outputs staged through
// shared memory), against 8 items per thread, and against either single
// path: one item per thread at every size is 3% slower at serve_bulk
// (4 items at multi-hot run 98 CTAs on 132 SMs), G = 8 for one-hot bags
// 2.5x slower (PERF.md §6).  All index math is 32-bit except the row offsets;
// one 32-bit division per item.
#include <cstdio>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int VW> struct VecOf;
template <> struct VecOf<2> { using type = unsigned short; };
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __noinline__ void report_id(int id, int bag, int slot,
                                       long long rows) {
  printf("embedding_bag: indices holds id %d (bag %d, slot %d), past the "
         "%lld rows it indexes\n", id, bag, slot, rows);
}

// acc[0..kEv) += the kEv elements of x, each add in f32 rounded to T
template <typename T, int VW, typename V>
__device__ __forceinline__ void add(float* acc, const V& x) {
  constexpr int kEv = VW / (int)sizeof(T);
  T e[kEv];
  memcpy(e, &x, VW);
#pragma unroll
  for (int q = 0; q < kEv; ++q)
    acc[q] = to_f32(from_f32<T>(__fadd_rn(acc[q], to_f32(e[q]))));
}

template <typename T, int VW>
__device__ __forceinline__ typename VecOf<VW>::type pack(const float* acc) {
  constexpr int kEv = VW / (int)sizeof(T);
  T e[kEv];
#pragma unroll
  for (int q = 0; q < kEv; ++q) e[q] = from_f32<T>(acc[q]);
  typename VecOf<VW>::type y;
  memcpy(&y, e, VW);
  return y;
}

// item i is output vector i: bag i / nv, vector i % nv of its row
template <typename T, int VW, int G, int ITEMS>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const T* __restrict__ table, const int* __restrict__ indices,
           T* __restrict__ out, int items, int hot, int nv,
           long long rows) {
  using V = typename VecOf<VW>::type;
  constexpr int kEv = VW / (int)sizeof(T);
  const int lane = threadIdx.x % 32;
  const int first = (blockIdx.x * kThreads + threadIdx.x - lane) * ITEMS
                    + lane;
  const size_t row_bytes = (size_t)nv * VW;
  const unsigned char* tb = reinterpret_cast<const unsigned char*>(table);
  int bag[ITEMS], vec[ITEMS];
  float acc[ITEMS][kEv];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int it = first + 32 * i;
    bag[i] = it < items ? it / nv : -1;
    vec[i] = it - bag[i] * nv;
#pragma unroll
    for (int q = 0; q < kEv; ++q) acc[i][q] = 0.0f;
  }
  for (int h0 = 0; h0 < hot; h0 += G) {
    int id[ITEMS][G];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
#pragma unroll
      for (int u = 0; u < G; ++u)
        id[i][u] = bag[i] >= 0 && h0 + u < hot
                       ? __ldg(indices + (size_t)bag[i] * hot + h0 + u)
                       : -1;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
#pragma unroll
      for (int u = 0; u < G; ++u)
        if (id[i][u] >= rows) {
          report_id(id[i][u], bag[i], h0 + u, rows);
          __trap();
        }
    V x[ITEMS][G];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
#pragma unroll
      for (int u = 0; u < G; ++u)
        x[i][u] = id[i][u] >= 0
                      ? __ldg(reinterpret_cast<const V*>(
                                  tb + (size_t)id[i][u] * row_bytes) + vec[i])
                      : V{};
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (h0 + u >= hot) break;
        add<T, VW>(acc[i], x[i][u]);
      }
  }
  V* o = reinterpret_cast<V*>(out);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (bag[i] >= 0) o[first + 32 * i] = pack<T, VW>(acc[i]);
}

template <typename T, int VW, int ITEMS>
int launch_items(const void* table, const int* indices, void* out, int items,
                 int hot, int nv, long long rows, cudaStream_t s) {
  const int per_cta = kThreads * ITEMS;
  const unsigned grid = (unsigned)((items + per_cta - 1) / per_cta);
  if (hot == 1)
    bag_kernel<T, VW, 1, ITEMS><<<grid, kThreads, 0, s>>>(
        (const T*)table, indices, (T*)out, items, hot, nv, rows);
  else
    bag_kernel<T, VW, 8, ITEMS><<<grid, kThreads, 0, s>>>(
        (const T*)table, indices, (T*)out, items, hot, nv, rows);
  return (int)cudaGetLastError();
}

// a batch too small to fill the card takes one item per thread
constexpr int kFillItems = 1 << 20;

template <typename T, int VW>
int launch(const void* table, const int* indices, void* out, int bags,
           int hot, int dim, long long rows, cudaStream_t s) {
  const int nv = dim * (int)sizeof(T) / VW;
  if ((long long)bags * nv + 32LL * 4 * kThreads >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int items = bags * nv;
  if (items < kFillItems)
    return launch_items<T, VW, 1>(table, indices, out, items, hot, nv, rows,
                                  s);
  return launch_items<T, VW, 4>(table, indices, out, items, hot, nv, rows,
                                s);
}

template <typename T>
int by_width(const void* table, const int* indices, void* out, int bags,
             int hot, int dim, long long rows, cudaStream_t s) {
  const int row_bytes = dim * (int)sizeof(T);
  int vw = 16;
  while (vw > (int)sizeof(T) &&
         (row_bytes % vw || (size_t)table % (size_t)vw))
    vw /= 2;
  switch (vw) {
    case 16: return launch<T, 16>(table, indices, out, bags, hot, dim, rows,
                                  s);
    case 8: return launch<T, 8>(table, indices, out, bags, hot, dim, rows, s);
    case 4: return launch<T, 4>(table, indices, out, bags, hot, dim, rows, s);
    default:
      if constexpr (sizeof(T) == 2)
        return launch<T, 2>(table, indices, out, bags, hot, dim, rows, s);
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 f32, 1 bf16
extern "C" int embedding_bag_launch(const void* table, const int* indices,
                                    void* out, int bags, int hot, int dim,
                                    long long rows, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? by_width<float>(table, indices, out, bags, hot, dim,
                                      rows, s)
                    : by_width<__nv_bfloat16>(table, indices, out, bags, hot,
                                              dim, rows, s);
}
