// Flash attention (causal and/or sliding window, GQA), for sm_90a.
// Replaces flash_attention_pallas (repro/kernels/flash_attention.py, body
// _flash_kernel), the kernel behind ops.attention.
//
// What it computes: q [B, Hq, S, D], k/v [B, Hkv, S, D] (f32 or bf16, all
// one type) -> o [B, Hq, S, D] in q's type, softmax(q k^T / sqrt(D)) v over
// the live keys of each query: causal keeps kpos <= qpos, a window > 0
// keeps kpos > qpos - window.  As in the Pallas kernel: the products and
// the online softmax run in f32; a masked logit is -1e30 (not -inf) and
// its p is set to 0; the running max starts at -1e30; the output is
// acc / max(l, 1e-30), cast to q's type.  Query head h reads KV head
// (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv): the repeated K/V of GQA is
// never formed.
//
// What bounds it: operations.  4 * D flops per live (query, key) pair
// against 2 * D * (size of q, k, v and o) bytes: at S = 4096 the card
// must do ~1,000 flops per byte, well above its ridge.  This kernel does
// them as f32 FMAs on the CUDA cores (67 TFLOP/s), not on the tensor
// cores (989 TFLOP/s in bf16): wgmma is later work.
//
// Design: one CTA of 256 threads per (batch x q-head, 64-query tile); a
// loop over 64-key tiles replaces the Pallas grid's sequential third axis
// and runs only over the tiles that hold a live entry (the causal and
// window bounds of the query tile), so skipped tiles cost nothing.  The
// heaviest (latest) query tiles are launched first.  Shared memory holds
// the query tile, one key-or-value tile (K, then V over it) and the
// [64 x 64] probabilities, all in f32 (inputs converted as they load;
// rows past S load as zeros); rows are padded by 4 floats against bank
// conflicts.  Thread (ty, tx) owns query rows 4ty..4ty+3: it computes their
// logits for keys tx + 16c, keeps their running max and sum in registers
// (a row's 16 threads share them through warp shuffles) and accumulates
// D/16 columns of each row's output in registers.  Shared memory per CTA:
// 52 KB at D = 64, 83 KB at D = 128, 147 KB at D = 256.
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // queries per CTA
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16: 4 query rows x 4 keys each
constexpr int kPStride = kBK + 4;
constexpr float kNegInf = -1e30f;

template <int D>
__host__ __device__ constexpr int row_stride() { return D + 4; }

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(kBQ * row_stride<D>() + kBK * row_stride<D>() +
                  kBQ * kPStride) * sizeof(float);
}

// Rows [row0, row0 + 64) of a [S, D] matrix into dst [64][D + 4] as f32.
template <int D>
__device__ __forceinline__ void load_tile(const float* src, int row0, int s,
                                          float* dst) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < 64 * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < s)
      v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * row_stride<D>() + c) = v;
  }
}

template <int D>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src, int row0,
                                          int s, float* dst) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < 64 * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (row0 + r < s) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * D + c);
      const __nv_bfloat162* h =
          reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 e = __bfloat1622float2(h[2]), f = __bfloat1622float2(h[3]);
      lo = make_float4(a.x, a.y, b.x, b.y);
      hi = make_float4(e.x, e.y, f.x, f.y);
    }
    float* d = dst + r * row_stride<D>() + c;
    *reinterpret_cast<float4*>(d) = lo;
    *reinterpret_cast<float4*>(d + 4) = hi;
  }
}

__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

// Reduce over the 16 lanes that share a query row (xor offsets < 16 stay
// inside each half of the warp).
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Output column of a thread's e-th accumulator: float4 runs of 64-wide
// stripes when D allows, else a stride of 16.
template <int D>
__device__ __forceinline__ int out_col(int tx, int e) {
  if constexpr (D % 64 == 0) return (e / 4) * 64 + tx * 4 + (e % 4);
  else return tx + 16 * e;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
             int s, float scale, int causal, int window) {
  static_assert(D % 16 == 0 && D <= 256, "D must be a multiple of 16");
  constexpr int kStride = row_stride<D>();
  constexpr int kCols = D / 16;  // output columns per thread and row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kv = qs + kBQ * kStride;
  float* ps = kv + kBK * kStride;

  const int nq = (s + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;  // latest tiles first
  const int bh = blockIdx.y;
  const int bkv = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  // keys with a live entry for some query of this tile: [k_lo, k_hi)
  const int k_hi = causal ? min(s, q0 + kBQ) : s;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[i][e] = 0.f;
  }
  load_tile<D>(q + (size_t)bh * s * D, q0, s, qs);
  const T* kh = k + (size_t)bkv * s * D;
  const T* vh = v + (size_t)bkv * s * D;

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();                       // the last tile's V and P are read
    load_tile<D>(kh, k0, s, kv);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * kStride + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kk[c] = *reinterpret_cast<const float4*>(kv + (tx + 16 * c) * kStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float a = sc[i][c];
          a = __fmaf_rn(qv[i].x, kk[c].x, a);
          a = __fmaf_rn(qv[i].y, kk[c].y, a);
          a = __fmaf_rn(qv[i].z, kk[c].z, a);
          a = __fmaf_rn(qv[i].w, kk[c].w, a);
          sc[i][c] = a;
        }
    }

    // mask, online softmax, P into shared memory, rescale the output
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool live[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        live[c] = kpos < s && (!causal || kpos <= qpos) &&
                  (window <= 0 || kpos > qpos - window);
        sc[i][c] = live[c] ? __fmul_rn(sc[i][c], scale) : kNegInf;
        mx = fmaxf(mx, sc[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(__fsub_rn(m[i], m_new));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = live[c] ? expf(__fsub_rn(sc[i][c], m_new)) : 0.f;
        ps[(ty * 4 + i) * kPStride + tx + 16 * c] = p;
        sum = __fadd_rn(sum, p);
      }
      l[i] = __fmaf_rn(alpha, l[i], row_sum(sum));
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[i][e] = __fmul_rn(acc[i][e], alpha);
    }
    __syncthreads();                       // P written, K no longer read
    load_tile<D>(vh, k0, s, kv);
    __syncthreads();

#pragma unroll 2
    for (int kk0 = 0; kk0 < kBK; kk0 += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kPStride + kk0);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = kv + (kk0 + t) * kStride;
        float vv[kCols];
        if constexpr (D % 64 == 0) {
#pragma unroll
          for (int j = 0; j < kCols / 4; ++j) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + j * 64 + tx * 4);
            vv[4 * j] = x.x; vv[4 * j + 1] = x.y;
            vv[4 * j + 2] = x.z; vv[4 * j + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < kCols; ++e) vv[e] = vrow[tx + 16 * e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = t == 0 ? p4[i].x : t == 1 ? p4[i].y
                        : t == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int e = 0; e < kCols; ++e)
            acc[i][e] = __fmaf_rn(p, vv[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * s + qpos) * D;
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      store(__fdiv_rn(acc[i][e], denom), orow + out_col<D>(tx, e));
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int s, int causal, int window,
             cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const float scale = (float)(1.0 / sqrt((double)D));
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s + kBQ - 1) / kBQ, b * hq);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, hq, hkv, s, scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int s, int d, int causal, int window,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch_d<T, 16>(q, k, v, o, b, hq, hkv, s, causal, window, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, b, hq, hkv, s, causal, window, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, b, hq, hkv, s, causal, window, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, b, hq, hkv, s, causal, window, stream);
    case 256: return launch_d<T, 256>(q, k, v, o, b, hq, hkv, s, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int s, int d, int causal,
                                      int window, int dtype,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_t<float>(q, k, v, o, b, hq, hkv, s, d, causal, window, st);
  return launch_t<__nv_bfloat16>(q, k, v, o, b, hq, hkv, s, d, causal, window,
                                 st);
}
