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
// must do ~1,000 flops per byte, well above its ridge.
//
// Two kernels, chosen by dtype in flash_attention_launch:
//
// * bf16: flash_bf16_kernel, on the tensor cores.  One CTA per (batch x
//   q-head, query tile) holds one or two consumer warpgroups (64 query
//   rows each; one at D = 256, where two would not fit the registers) and
//   one producer warp.  The producer's lane 0 loads the Q tile once and
//   streams K and V tiles of 64 keys through a two-stage ring in shared
//   memory with TMA (cp.async.bulk.tensor, a CUtensorMap per tensor as a
//   __grid_constant__), each stage's arrival counted by an mbarrier
//   ("full") and its release by the consumers by another ("empty").  The
//   tiles stay bf16, in the swizzled layout the wgmma descriptors read:
//   64-row chunks of min(2D, 128) bytes per row.  Rows past S load as
//   zeros (TMA's out-of-bounds fill), which masking then ignores.
//   S = Q K^T is wgmma.mma_async m64n64k16 bf16 -> f32 with Q and K from
//   shared memory; the mask, the running max and sum (in log2 units: the
//   logits are scaled by log2(e) / sqrt(D), p = 2^(x - m)) and the rescale
//   of the O accumulator stay in registers, in the wgmma accumulator
//   layout.  O += P V is wgmma with P from registers (the accumulator's
//   layout is the A fragment's) and V from shared memory (MN-major, the
//   transposed-B form).  P in bf16 alone loses up to 2^-9 of each weight,
//   which moves outputs by two bf16 roundings of the f32 result; so P is
//   split into hi = bf16(p) and lo = bf16(p - hi) and both products are
//   issued (f32 accumulation), which keeps the kernel within one output
//   rounding of attention computed in f32.  Only the key tiles that hold
//   a live entry for the query tile are loaded; a warpgroup whose own 64
//   rows have no live key in a loaded tile skips its products; tiles fully
//   inside the live region skip the mask.  The heaviest (latest) query
//   tiles launch first, across all heads.  Shared memory per CTA: Q
//   64 * D * 2 bytes per warpgroup and two stages of K and V, 48 KB at
//   D = 64, 96 KB at D = 128, 160 KB at D = 256, plus 1 KB of alignment
//   slack (flash_attention_shape reports it).
//
// * f32: flash_f32_kernel, its products on the tensor cores as 3xTF32.
//   One TF32 product keeps 11 bits of each operand, 2^-11 of the value,
//   which misses the 2e-4 tolerance even at unit-variance inputs; so each
//   operand is split, x = hi + lo with hi = tf32(x) (cvt.rna) and lo =
//   x - hi, of which the tensor cores read the top 19 bits, and each
//   product is issued as lo*hi + hi*lo + hi*hi with f32 accumulation:
//   2^-21 of the value.  That is 3 TF32 passes at 495 TFLOP/s, the least
//   time in which this card can do f32-accurate products, against 67
//   TFLOP/s for f32 FMAs on the CUDA cores.  The tensor cores truncate
//   each step of a sum to its largest term, so S's hi*hi products and its
//   small ones go to separate sums, and each tile's P V starts from zero
//   and is added to O in f32.  The instruction is mma.sync.m16n8k8
//   (tf32): it takes its fragments from registers in any order, so both
//   products read plain row-major tiles; wgmma takes tf32 only with B
//   K-major, which V (stored [keys, D]) is not.  mma.sync's own rate on
//   this card, ~300 TFLOP/s, bounds the design, not the 495.
//   One CTA per (batch x q-head, query tile): 8 warps of 16 query rows (4
//   warps and 32-key tiles at D = 256, for shared memory).  Q's tile is
//   staged once; K and V get separate buffers in a two-stage ring filled
//   by cp.async, the next tile's copy issued right after the one barrier
//   per tile, so it overlaps the current tile's products.  S = Q K^T: a
//   thread reads one float4 of its Q rows and of a K row per 16 columns
//   (the k order within them permuted alike in A and B; rows padded to 16
//   mod 32 floats, no bank conflict) and splits both.  The mask (edge
//   tiles only), the online softmax in log2 units (as the bf16 kernel)
//   and the rescale run in f32 registers in the accumulator layout, which
//   is P V's A fragment once each 8-key block's keys 2t and 2t + 1 take
//   slots t and t + 4; V's rows are read in that order, from a layout
//   whose 16-byte chunks are XOR-swizzled by row, and O's column n of
//   block nb is D column n * D/8 + nb, so a thread's V loads and O stores
//   are float4s.  A warp with no live key in a tile skips it.  Shared
//   memory per CTA: 115 KB at D = 64, 213 KB at D = 128, 205 KB at D =
//   256.
#include <cmath>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: 3xTF32 products on the tensor cores (mma.sync m16n8k8)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct F32Cfg {
  static constexpr int kWarps = D == 256 ? 4 : 8;   // 16 query rows each
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowsQ = 16 * kWarps;        // query rows per CTA
  static constexpr int kKeys = D == 256 ? 32 : 64;  // keys per K/V tile
  // Q and K rows padded to 16 mod 32 floats: the 8 lanes of a quarter
  // warp read rows g and g + 1 at columns 4t as float4s, 8 bank groups
  static constexpr int kStride = D % 32 == 0 ? D + 16 : D;
  static constexpr int kNB = D / 8;                 // 8-column blocks of O
  static constexpr int kVW = kNB >= 4 ? 4 : kNB;    // floats per V load
  static constexpr size_t kSmem =
      ((size_t)kRowsQ * kStride + 2 * (size_t)kKeys * kStride +
       2 * (size_t)kKeys * D) * sizeof(float);
};

// A 16-byte cp.async that fills zeros when ok is false.
__device__ __forceinline__ void copy16z(float* smem, const float* gmem,
                                        bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [row0, row0 + rows) of a [S, D] f32 matrix into shared memory at
// `stride` floats per row, rows past s as zeros, by all kThreads threads.
// kSwz (V's layout): row r's 16-byte chunk c lands at chunk c ^ (r / 2 % 4).
template <int D, int kThreads, bool kSwz>
__device__ __forceinline__ void stage_rows(float* dst, int stride,
                                           const float* src, int row0,
                                           int rows, int s) {
  constexpr int kC = D / 4;
  for (int i = threadIdx.x; i < rows * kC; i += kThreads) {
    const int r = i / kC, c = i % kC;
    const int pc = kSwz ? c ^ ((r >> 1) & 3) : c;
    const bool ok = row0 + r < s;
    copy16z(dst + r * stride + 4 * pc,
            ok ? src + (size_t)(row0 + r) * D + 4 * c : src, ok);
  }
}

// x = hi + lo: hi = tf32(x), rounded to nearest (ties away from zero), and
// lo = x - hi (exact), of which the tensor cores read the top 19 bits: the
// pair holds x to 2^-21 of its value.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d[16 x 8] += a[16 x 8] b[8 x 8], TF32 products, f32 accumulation.
// Fragments (g = lane / 4, t = lane % 4): a = (g, t), (g + 8, t), (g,
// t + 4), (g + 8, t + 4); b = (t, g), (t + 4, g); d = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b to f32 accuracy from split operands: lo hi + hi lo + hi hi (the
// small terms first; lo lo, below 2^-22 of the product, is dropped).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::kThreads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq,
                 int hkv, int s, float scale_log2, int causal, int window) {
  using C = F32Cfg<D>;
  static_assert(D % 16 == 0 && D <= 256, "D must be a multiple of 16");
  constexpr int kNT = C::kKeys / 8;           // 8-key blocks of a tile
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);        // [kRowsQ][kStride]
  float* ks = qs + C::kRowsQ * C::kStride;            // [2][kKeys][kStride]
  float* vs = ks + 2 * C::kKeys * C::kStride;         // [2][kKeys][D]

  const int bh = blockIdx.x;
  const int bkv = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  // the latest (heaviest) query tiles first, across all heads
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * C::kRowsQ;
  // keys with a live entry for some query of this CTA: [k_lo, k_hi)
  const int k_hi = causal ? min(s, q0 + C::kRowsQ) : s;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_start = (k_lo / C::kKeys) * C::kKeys;
  const int n_tiles = (k_hi - k_start + C::kKeys - 1) / C::kKeys;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = q0 + 16 * warp;              // the warp's first query row
  const int my_hi = causal ? min(s, w0 + 16) : s;
  const int my_lo = window > 0 ? max(0, w0 - window + 1) : 0;
  const float* kh = k + (size_t)bkv * s * D;
  const float* vh = v + (size_t)bkv * s * D;

  stage_rows<D, C::kThreads, false>(qs, C::kStride, q + (size_t)bh * s * D,
                                    q0, C::kRowsQ, s);
  stage_rows<D, C::kThreads, false>(ks, C::kStride, kh, k_start, C::kKeys,
                                    s);
  stage_rows<D, C::kThreads, true>(vs, D, vh, k_start, C::kKeys, s);
  cp_commit();

  float acc[C::kNB][4];
#pragma unroll
  for (int nb = 0; nb < C::kNB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // this thread's Q rows g and g + 8 of the warp's 16, columns 16c + 4t
  const float* qa = qs + (16 * warp + g) * C::kStride + 4 * t;

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = k_start + i * C::kKeys;
    cp_wait_all();
    __syncthreads();      // tile i has landed; tile i - 1 is no longer read
    if (i + 1 < n_tiles) {
      const int st = (i + 1) & 1;
      stage_rows<D, C::kThreads, false>(ks + st * C::kKeys * C::kStride,
                                        C::kStride, kh, k0 + C::kKeys,
                                        C::kKeys, s);
      stage_rows<D, C::kThreads, true>(vs + st * C::kKeys * D, D, vh,
                                       k0 + C::kKeys, C::kKeys, s);
      cp_commit();
    }
    // a warp with no live key in this tile skips it
    if (w0 >= s || k0 >= my_hi || k0 + C::kKeys <= my_lo) continue;
    const float* kt = ks + (i & 1) * C::kKeys * C::kStride;
    const float* vt = vs + (i & 1) * C::kKeys * D;

    // S = Q K^T.  Within 16 columns c, k step 2c takes d = 16c + 4t (slot
    // t) and 16c + 4t + 1 (slot t + 4), step 2c + 1 the next two: the same
    // order in A and B, so a thread reads one float4 of each row.  The hi
    // hi products (sc) and the two small ones (sm) go to separate sums: the
    // tensor cores truncate each step of a sum to its largest term, and
    // small terms added to a large sum lose what they carry.
    float sc[kNT][4], sm[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = sm[nt][e] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float4 x0 = *reinterpret_cast<const float4*>(qa + 16 * c);
      const float4 x1 =
          *reinterpret_cast<const float4*>(qa + 8 * C::kStride + 16 * c);
      uint32_t ah[2][4], al[2][4];
      split_tf32(x0.x, ah[0][0], al[0][0]);
      split_tf32(x1.x, ah[0][1], al[0][1]);
      split_tf32(x0.y, ah[0][2], al[0][2]);
      split_tf32(x1.y, ah[0][3], al[0][3]);
      split_tf32(x0.z, ah[1][0], al[1][0]);
      split_tf32(x1.z, ah[1][1], al[1][1]);
      split_tf32(x0.w, ah[1][2], al[1][2]);
      split_tf32(x1.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float4 y = *reinterpret_cast<const float4*>(
            kt + (8 * nt + g) * C::kStride + 16 * c + 4 * t);
        uint32_t bh[4], bl[4];
        split_tf32(y.x, bh[0], bl[0]);
        split_tf32(y.y, bh[1], bl[1]);
        split_tf32(y.z, bh[2], bl[2]);
        split_tf32(y.w, bh[3], bl[3]);
        mma_tf32(sm[nt], al[0], bh[0], bh[1]);
        mma_tf32(sm[nt], ah[0], bl[0], bl[1]);
        mma_tf32(sc[nt], ah[0], bh[0], bh[1]);
        mma_tf32(sm[nt], al[1], bh[2], bh[3]);
        mma_tf32(sm[nt], ah[1], bl[2], bl[3]);
        mma_tf32(sc[nt], ah[1], bh[2], bh[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[nt][e] = __fadd_rn(sc[nt][e], sm[nt][e]);

    // mask (edge tiles only), online softmax in log2 units, rescale O
    const bool interior = k0 + C::kKeys <= s &&
                          (!causal || k0 + C::kKeys - 1 <= w0) &&
                          (window <= 0 || k0 > w0 + 15 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float x = __fmul_rn(sc[nt][e], scale_log2);
        if (!interior) {
          const int qpos = w0 + g + 8 * r;
          const int kpos = k0 + 8 * nt + 2 * t + (e % 2);
          const bool live = kpos < s && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
          x = live ? x : kNegInf;
        }
        sc[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2(__fsub_rn(m[r], m_new));
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float p = ex2(__fsub_rn(sc[nt][e], m[r]));
        if (!interior && sc[nt][e] == kNegInf) p = 0.f;
        sc[nt][e] = p;
        sum[r] = __fadd_rn(sum[r], p);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(alpha[r], l[r], sum[r]);

    // O = alpha O + P V.  P's accumulator layout is the A fragment's once
    // key block j's keys 2t and 2t + 1 take slots t and t + 4; V's B
    // fragment reads rows 8j + 2t and 8j + 2t + 1 to match.  Column n of O
    // block nb is D column n * kNB + nb, so a thread reads kNB consecutive
    // floats of each V row and writes 2 kNB consecutive floats of each O
    // row.  A tile's P V starts from zero and is added to the rescaled O in
    // f32 (truncation again).
    uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      split_tf32(sc[j][0], ph[j][0], pl[j][0]);
      split_tf32(sc[j][2], ph[j][1], pl[j][1]);
      split_tf32(sc[j][1], ph[j][2], pl[j][2]);
      split_tf32(sc[j][3], ph[j][3], pl[j][3]);
    }
#pragma unroll
    for (int qq = 0; qq < C::kNB / C::kVW; ++qq) {
      const int col = g * C::kNB + qq * C::kVW;
      const int off = (((col >> 2) ^ t) << 2) + (col & 3);   // swizzled by t
      float pv[C::kVW][4];
#pragma unroll
      for (int e = 0; e < C::kVW; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) pv[e][x] = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* v0 = vt + (8 * j + 2 * t) * D + off;
        float b0[C::kVW], b1[C::kVW];
        if constexpr (C::kVW == 4) {
          const float4 y0 = *reinterpret_cast<const float4*>(v0);
          const float4 y1 = *reinterpret_cast<const float4*>(v0 + D);
          b0[0] = y0.x; b0[1] = y0.y; b0[2] = y0.z; b0[3] = y0.w;
          b1[0] = y1.x; b1[1] = y1.y; b1[2] = y1.z; b1[3] = y1.w;
        } else {
          const float2 y0 = *reinterpret_cast<const float2*>(v0);
          const float2 y1 = *reinterpret_cast<const float2*>(v0 + D);
          b0[0] = y0.x; b0[1] = y0.y;
          b1[0] = y1.x; b1[1] = y1.y;
        }
#pragma unroll
        for (int e = 0; e < C::kVW; ++e) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b0[e], bh0, bl0);
          split_tf32(b1[e], bh1, bl1);
          mma_3xtf32(pv[e], ph[j], pl[j], bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int e = 0; e < C::kVW; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          acc[qq * C::kVW + e][x] =
              __fmaf_rn(acc[qq * C::kVW + e][x], alpha[x / 2], pv[e][x]);
    }
  }

  // a row's sum is spread over the 4 threads of its quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tot = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    tot = __fadd_rn(tot, __shfl_xor_sync(0xffffffffu, tot, 2));
    const float denom = fmaxf(tot, 1e-30f);
    const int qpos = w0 + g + 8 * r;
    if (qpos >= s) continue;
    // D columns 2t kNB + c: c < kNB from block c's d[2r], else from block
    // c - kNB's d[2r + 1]
    float* orow = o + ((size_t)bh * s + qpos) * D + 2 * t * C::kNB;
#pragma unroll
    for (int c = 0; c < 2 * C::kNB; c += 4) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = __fdiv_rn(c + e < C::kNB ? acc[c + e][2 * r]
                                        : acc[c + e - C::kNB][2 * r + 1],
                         denom);
      *reinterpret_cast<float4*>(orow + c) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int s, int causal, int window,
               cudaStream_t stream) {
  using C = F32Cfg<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b * hq, (s + C::kRowsQ - 1) / C::kRowsQ);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_f32_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, hq, hkv,
      s, scale_log2, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA into an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kRows = 64;      // query rows per consumer warpgroup (wgmma M)
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kStages = 2;     // depth of the K/V ring

template <int D>
struct Cfg {
  // a tile is kChunks chunks of [64 rows][kSw bytes], each swizzled over
  // kSw bytes (TMA writes it so; the wgmma descriptors read it so)
  static constexpr int kSw = D >= 64 ? 128 : 2 * D;
  static constexpr int kChunkCols = kSw / 2;
  static constexpr int kChunks = D / kChunkCols;
  static constexpr int kChunkBytes = 64 * kSw;
  static constexpr int kTileBytes = kChunks * kChunkBytes;   // 64 x D bf16
  static constexpr int kConsumers = D == 256 ? 1 : 2;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kN = D >= 64 ? 64 : D;   // N of one P V wgmma
  static constexpr int kNBlocks = D / kN;
  static constexpr int kKPerChunk = kSw / 32;   // k16 steps in a chunk row
  static constexpr size_t kBars =
      (size_t)(kConsumers + 2 * kStages) * kTileBytes;
  static constexpr size_t kSmem = 1024 + kBars + (2 * kStages + 1) * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Box (c0, c1, c2) of a 3-D tensor map into shared memory at dst,
// completion counted in bytes on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B,
// 3: 32 B).
template <int SW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t kMode = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (kMode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Pin registers that a wgmma reads or writes asynchronously in program
// order: writes before wgmma.fence stay before it, reads after the wait
// stay after it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] B[16 x N]: A from registers (four bf16 pairs per
// thread), B MN-major in shared memory (transposed-B form).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// p's pair (x, y) as hi = bf16(p) and lo = bf16(p - hi) (p - hi is exact).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(x, hf.x), __fsub_rn(y, hf.y));
}

// One consumer's online-softmax step on a tile's logits s (the wgmma
// accumulator: s[4j + e] is row r0, key 8j + 2t + e; s[4j + 2 + e] row
// r0 + 8).  Turns s into p, updates m and the per-thread partial sums l,
// and returns the two rows' rescale factors.
template <bool kMask>
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, int qpos0,
                                             int kpos0, int len, int causal,
                                             int window) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i / 2) % 2;
    float x = __fmul_rn(s[i], scale_log2);
    if constexpr (kMask) {
      const int qpos = qpos0 + 8 * r;
      const int kpos = kpos0 + 8 * (i / 4) + (i % 2);
      const bool live = kpos < len && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
      x = live ? x : kNegInf;
    }
    s[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2(__fsub_rn(m[r], m_new));
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i / 2) % 2;
    float p = ex2(__fsub_rn(s[i], m[r]));
    if constexpr (kMask) p = s[i] == kNegInf ? 0.f : p;
    s[i] = p;
    sum[r] = __fadd_rn(sum[r], p);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(alpha[r], l[r], sum[r]);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, int hq, int hkv, int s,
                  float scale_log2, int causal, int window) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment in the shared address space
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t qs = smem_u32(base);
  const uint32_t ks = qs + C::kConsumers * C::kTileBytes;
  const uint32_t vs = ks + kStages * C::kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + C::kBars);
  const uint32_t full = smem_u32(bars);                 // [kStages]
  const uint32_t empty = full + 8 * kStages;            // [kStages]
  const uint32_t qbar = empty + 8 * kStages;

  const int bh = blockIdx.x;
  const int bkv = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  constexpr int kCtaRows = kRows * C::kConsumers;
  // the latest (heaviest) query tiles first
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kCtaRows;
  // keys with a live entry for some query of this CTA: [k_lo, k_hi)
  const int k_hi = causal ? min(s, q0 + kCtaRows) : s;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_start = (k_lo / kKeys) * kKeys;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 128 * C::kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C::kConsumers) {
    // producer: lane 0 issues every copy
    if (threadIdx.x % 32 != 0) return;
    mbar_expect_tx(qbar, C::kConsumers * C::kTileBytes);
    for (int w = 0; w < C::kConsumers; ++w)
      for (int c = 0; c < C::kChunks; ++c)
        tma_load(qs + w * C::kTileBytes + c * C::kChunkBytes, &tq, qbar,
                 c * C::kChunkCols, q0 + kRows * w, bh);
    int i = 0;
    for (int k0 = k_start; k0 < k_hi; k0 += kKeys, ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(empty + 8 * st, ((i / kStages) - 1) & 1);
      mbar_expect_tx(full + 8 * st, 2 * C::kTileBytes);
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load(ks + st * C::kTileBytes + c * C::kChunkBytes, &tk,
                 full + 8 * st, c * C::kChunkCols, k0, bkv);
        tma_load(vs + st * C::kTileBytes + c * C::kChunkBytes, &tv,
                 full + 8 * st, c * C::kChunkCols, k0, bkv);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64)
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int row0 = 16 * (warp % 4) + lane / 4;     // and row0 + 8
  const int col0 = 2 * (lane % 4);                 // and + 1, + 8j
  const int my_q0 = q0 + kRows * wg;
  const int qpos0 = my_q0 + row0;
  const int my_hi = causal ? min(s, my_q0 + kRows) : s;
  const int my_lo = window > 0 ? max(0, my_q0 - window + 1) : 0;
  const uint32_t my_qs = qs + wg * C::kTileBytes;

  float acc[C::kNBlocks][C::kN / 2];
#pragma unroll
  for (int nb = 0; nb < C::kNBlocks; ++nb)
#pragma unroll
    for (int i = 0; i < C::kN / 2; ++i) acc[nb][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;

  mbar_wait(qbar, 0);
  int i = 0;
  for (int k0 = k_start; k0 < k_hi; k0 += kKeys, ++i) {
    const int st = i % kStages;
    mbar_wait(full + 8 * st, (i / kStages) & 1);
    if (k0 < my_hi && k0 + kKeys > my_lo) {
      const uint32_t kt = ks + st * C::kTileBytes;
      const uint32_t vt = vs + st * C::kTileBytes;
      // S = Q K^T
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / C::kKPerChunk) * C::kChunkBytes +
                             (kk % C::kKPerChunk) * 32;
        wgmma_ss_n64(sc, smem_desc<C::kSw>(my_qs + off, 16, 8 * C::kSw),
                     smem_desc<C::kSw>(kt + off, 16, 8 * C::kSw), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // mask (edge tiles only), online softmax, rescale O
      const bool interior = k0 + kKeys <= s &&
                            (!causal || k0 + kKeys - 1 <= my_q0) &&
                            (window <= 0 || k0 > my_q0 + kRows - 1 - window);
      float alpha[2];
      if (interior)
        softmax_step<false>(sc, m, l, alpha, scale_log2, qpos0, k0 + col0,
                            s, causal, window);
      else
        softmax_step<true>(sc, m, l, alpha, scale_log2, qpos0, k0 + col0,
                           s, causal, window);
#pragma unroll
      for (int nb = 0; nb < C::kNBlocks; ++nb)
#pragma unroll
        for (int j = 0; j < C::kN / 2; ++j)
          acc[nb][j] = __fmul_rn(acc[nb][j], alpha[(j / 2) % 2]);
#pragma unroll
      for (int nb = 0; nb < C::kNBlocks; ++nb) fence_regs(acc[nb]);

      // P as hi + lo bf16 A fragments, 16 keys per k step
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r],
                     pl[kk][r]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }

      // O += P V; one 64-column block of V lies in one swizzle atom, so
      // the descriptor's two offsets are both the 8-key group stride
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nb = 0; nb < C::kNBlocks; ++nb) {
          const uint64_t dv = smem_desc<C::kSw>(
              vt + nb * C::kChunkBytes + kk * 16 * C::kSw, 8 * C::kSw,
              8 * C::kSw);
          wgmma_rs<C::kN>(acc[nb], ph[kk], dv);
          wgmma_rs<C::kN>(acc[nb], pl[kk], dv);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int nb = 0; nb < C::kNBlocks; ++nb) fence_regs(acc[nb]);
    }
    mbar_arrive(empty + 8 * st);
  }

  // a row's sum is spread over the 4 threads of its quad
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, 2));
    denom[r] = fmaxf(t, 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + 8 * r;
    if (qpos >= s) continue;
    __nv_bfloat16* orow = o + ((size_t)bh * s + qpos) * D;
#pragma unroll
    for (int nb = 0; nb < C::kNBlocks; ++nb)
#pragma unroll
      for (int j = 0; j < C::kN / 8; ++j) {
        const int col = nb * C::kN + 8 * j + col0;
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(__fdiv_rn(acc[nb][4 * j + 2 * r], denom[r]),
                      __fdiv_rn(acc[nb][4 * j + 2 * r + 1], denom[r]));
      }
  }
}

// A 3-D map of a [heads, s, d] bf16 tensor, boxes of [1, 64, kSw / 2].
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int heads, int s) {
  using C = Cfg<D>;
  cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)s, (cuuint64_t)heads};
  cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)s * D * 2};
  cuuint32_t box[3] = {(cuuint32_t)C::kChunkCols, 64, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      C::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : C::kSw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // a driver error, told apart from the runtime's cudaError codes
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int hq, int hkv, int s, int causal, int window,
                cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  int e = make_map<D>(&tq, q, b * hq, s);
  if (!e) e = make_map<D>(&tk, k, b * hkv, s);
  if (!e) e = make_map<D>(&tv, v, b * hkv, s);
  if (e) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (a != cudaSuccess) return (int)a;
  constexpr int kCtaRows = kRows * C::kConsumers;
  const dim3 grid(b * hq, (s + kCtaRows - 1) / kCtaRows);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_bf16_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, hq, hkv, s, scale_log2, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int s, int causal, int window, int dtype,
             cudaStream_t st) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, b, hq, hkv, s, causal, window, st);
  return launch_bf16<D>(q, k, v, o, b, hq, hkv, s, causal, window, st);
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int s, int d, int causal,
                                      int window, int dtype,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch_d<16>(q, k, v, o, b, hq, hkv, s, causal, window, dtype, st);
    case 32: return launch_d<32>(q, k, v, o, b, hq, hkv, s, causal, window, dtype, st);
    case 64: return launch_d<64>(q, k, v, o, b, hq, hkv, s, causal, window, dtype, st);
    case 128: return launch_d<128>(q, k, v, o, b, hq, hkv, s, causal, window, dtype, st);
    case 256: return launch_d<256>(q, k, v, o, b, hq, hkv, s, causal, window, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory (bytes) and threads per CTA of the kernel for
// head width d and dtype code (0 f32, 1 bf16), for reports.
extern "C" int flash_attention_shape(int d, int dtype, int* smem,
                                     int* threads) {
  switch (d * 2 + (dtype != 0)) {
#define SHAPE(D)                                                        \
    case 2 * D: *smem = (int)F32Cfg<D>::kSmem; *threads = F32Cfg<D>::kThreads; return 0; \
    case 2 * D + 1: *smem = (int)Cfg<D>::kSmem; *threads = Cfg<D>::kThreads; return 0;
    SHAPE(16) SHAPE(32) SHAPE(64) SHAPE(128) SHAPE(256)
#undef SHAPE
    default: return (int)cudaErrorInvalidValue;
  }
}
