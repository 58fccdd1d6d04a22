// Query weights, for sm_90a: the idf weights and the query norms that
// every score of a batch is scaled by.  Replaces no Pallas kernel: the
// reference computes both in one XLA jit (repro/core/live_index.py,
// _query_weights; repro/core/query.py, idf and the oracle's qnorm), and
// these kernels give its CPU bits, as core/query.py's plain versions do.
//
// What bounds them: the launch.  A batch holds a few dozen weights; the
// kernels read 4 B and write 4 B per slot.  The plain versions take ~250
// elementwise tensor ops for the same values, each a launch of its own.
//
// idf_kernel, one thread per slot: idf = ln(1 + D/df), 0 where df == 0.
// D/df is an f32 division and ln(x + 1) is log_f32, the mirror of XLA's
// CPU log (Cephes' logf, Eigen's plog_float): x = m * 2^e with m in
// [sqrt(1/2), sqrt(2)), a degree-8 polynomial in m - 1 as three Horner
// chains, e * ln 2 added in two parts.  Each multiply XLA's backend
// contracts into an add is an __fmaf_rn here; the rest are plain f32 ops,
// which -fmad=false keeps uncontracted.
//
// norm_kernel, one thread per query: sqrt(max(sum_t w_t^2, 1e-12)) in
// slot order, each square fused into the add (an FMA chain) at widths 1-4
// and 9+, rounded on its own and then added at widths 5-8, as XLA's
// vectorised row loop computes it; the square root correctly rounded
// through f64, as the plain version takes it.
#include <cuda_runtime.h>

namespace {

constexpr float kFltMin = 1.17549435e-38f;
constexpr float kSqrtHalf = 0.707106781186547524f;

__device__ float log_f32(float x) {
  if (fabsf(x) < kFltMin) x = 0.0f;         // a subnormal counts as 0
  const float xc = x < kFltMin ? kFltMin : x;
  const int bits = __float_as_int(xc);
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);  // [.5,1)
  float e = (float)((bits >> 23) - 127) + 1.0f;
  const bool low = m < kSqrtHalf;
  e = e - (low ? 1.0f : 0.0f);
  const float r = (m - 1.0f) + (low ? m : 0.0f);  // m - 1
  const float r2 = r * r;
  const float r3 = r2 * r;
  float y = __fmaf_rn(r, 7.0376836292e-2f, -1.1514610310e-1f);
  float y1 = __fmaf_rn(r, -1.2420140846e-1f, 1.4249322787e-1f);
  float y2 = __fmaf_rn(r, 2.0000714765e-1f, -2.4999993993e-1f);
  y = __fmaf_rn(y, r, 1.1676998740e-1f);
  y1 = __fmaf_rn(y1, r, -1.6668057665e-1f);
  y2 = __fmaf_rn(y2, r, 3.3333331174e-1f);
  y = __fmaf_rn(y, r3, y1);
  y = __fmaf_rn(y, r3, y2);
  y = __fmaf_rn(y, r3, e * -2.12194440e-4f);
  const float out = __fmaf_rn(e, 0.693359375f, (r - r2 * 0.5f) + y);
  if (x == __int_as_float(0x7F800000)) return x;              // inf
  if (x == 0.0f) return __int_as_float(0xFF800000);           // -inf
  return x > 0.0f ? out : __int_as_float(0x7FC00000);         // NaN
}

__global__ void idf_kernel(const int* __restrict__ df, int n, float num_docs,
                           float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int d = df[i];
  const float x = num_docs / (float)(d > 1 ? d : 1);
  out[i] = d > 0 ? log_f32(x + 1.0f) : 0.0f;
}

__global__ void norm_kernel(const float* __restrict__ w, int rows, int width,
                            float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* row = w + (size_t)r * width;
  const bool rounded = width >= 5 && width <= 8;
  float acc = 0.0f;
  for (int t = 0; t < width; ++t) {
    const float v = row[t];
    acc = rounded ? acc + v * v : __fmaf_rn(v, v, acc);
  }
  acc = acc < 1e-12f ? 1e-12f : acc;        // a NaN passes, as clamp_min
  out[r] = __double2float_rn(__dsqrt_rn((double)acc));
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int query_idf_launch(const int* df, int n, float num_docs,
                                float* out, void* stream) {
  idf_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
               (cudaStream_t)stream>>>(df, n, num_docs, out);
  return (int)cudaGetLastError();
}

extern "C" int query_norm_launch(const float* w, int rows, int width,
                                 float* out, void* stream) {
  norm_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                (cudaStream_t)stream>>>(w, rows, width, out);
  return (int)cudaGetLastError();
}
