// Fixed-arity multi-hot EmbeddingBag, for sm_90a.  Replaces
// embedding_bag_pallas (repro/kernels/embedding_bag.py, body _bag_kernel),
// the kernel behind ops.embedding_bag.
//
// What it computes: table [V, D] (f32 or bf16), indices i32 [B, H] with -1
// as padding -> out [B, D] in the table's dtype, out[b] = the sum of the
// bag's H rows added in slot order h = 0..H-1.  Like the Pallas kernel's
// accumulator, the sum is kept in the table's dtype: each add is computed
// in f32 and rounded to the table's dtype (one bf16 rounding per slot for
// a bf16 table).  A padding slot adds +0.0.
//
// What bounds it: bytes.  Each valid slot reads one D-wide row at a random
// place in the table (40 B for xDeepFM's f32 rows of 10), each bag writes
// one row; there is one add per element read, far below the ops:byte
// ridge.  A 40-byte row spans two or three 32-byte sectors, so the bytes
// moved exceed the bytes used.
//
// Design: one thread per output element (bag b, column c), threads laid
// flat over [B, D], so a warp covers several bags when D is small (three
// bags of 10 columns) and a row is read by neighbouring threads in one
// piece; the output is written fully coalesced.  The threads of a bag read
// the same index (one broadcast load).  No shared memory, no atomics: the
// H adds of an element stay in one thread, in slot order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void round_to(float x, float* out) { *out = x; }
__device__ __forceinline__ void round_to(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const T* __restrict__ table, const int* __restrict__ indices,
           T* __restrict__ out, long long total, int hot, int dim) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= total) return;
  const long long bag = g / dim;
  const int col = (int)(g - bag * dim);
  const int* idx = indices + bag * hot;
  T acc;
  round_to(0.0f, &acc);
  for (int h = 0; h < hot; ++h) {
    const int row = idx[h];
    const float v = row >= 0 ? to_f32(table[(long long)row * dim + col])
                             : 0.0f;
    round_to(__fadd_rn(to_f32(acc), v), &acc);
  }
  out[g] = acc;
}

}  // namespace

extern "C" int embedding_bag_launch(const void* table, const int* indices,
                                    void* out, int bags, int hot, int dim,
                                    int dtype, void* stream) {
  const long long total = (long long)bags * dim;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    bag_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)table, indices, (float*)out, total, hot, dim);
  else
    bag_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)table, indices, (__nv_bfloat16*)out, total,
        hot, dim);
  return (int)cudaGetLastError();
}
