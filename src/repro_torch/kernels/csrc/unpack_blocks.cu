// Packed-block decoder, for sm_90a.  Replaces unpack_blocks_pallas
// (repro/kernels/packed_postings.py, body _unpack_kernel), behind
// ops.unpack_postings: every block of a PackedCsrIndex decoded to i32
// [NB, block] doc ids, -1 at or past each block's count.
//
// What bounds it: bytes, most of them the output.  Each block reads its
// (bits, base, count) and the ceil(block * bits / 32) packed words it
// holds, and writes 4 B per lane: on the 1M tier (434,816 blocks of 128
// lanes, 8.9 bits on average) 67 MB in and 223 MB out.  A shift, an or, a
// mask and an add per lane.
//
// What held the first design back was latency, not bytes: one CTA per
// block, each a chain of dependent loads (bits, then the words), a scan
// across warps with a barrier, then the stores, some 200 waves of CTAs
// each paying a DRAM round trip or two.  So:
//
// * A warp per block, persistent: as many CTAs as fit on the card at once,
//   their warps walking the blocks with a stride.  No waves, no barrier.
// * Only the words a block holds are read: n = min(ceil(block * bits /
//   32), Wpb), copied coalesced into the warp's staging area in shared
//   memory (16-byte copies when every row starts on a 16-byte boundary).
// * A warp takes G blocks per step (4 up to 128 lanes, fewer for wider
//   blocks), two stages of them: while one batch decodes, the next
//   batch's words are in flight (cp.async), and the metadata of the one
//   after it (lane k loads block k's; plain loads whose first use is a
//   step later), so the copy of a block never waits on its own bits.
// * Thread t decodes the L = ceil(block / 32) consecutive lanes [tL, tL +
//   L) (L rounded up to a power of two) with tile_accumulate.cuh's
//   packed_delta arithmetic, the fused packed kernels' decode, written
//   as one funnel shift of the lane's two words from a bit position
//   carried from lane to lane; it sums them, and a 5-step shuffle scan
//   gives each thread the sum of the lanes before its own.  Doc id =
//   base + the wrapping 32-bit inclusive sum, as the reference's int32
//   cumsum.
// * At L >= 4 and a width that is a multiple of 4 a thread stores 16
//   bytes at a time (a 128-lane block is one 512-byte store of the warp);
//   otherwise 4.
//
// Staging changes no bit: a lane reads words bitpos / 32 and the next one,
// both clamped to the n staged words.  Every bit of a lane at most 32 bits
// wide lies in [0, n), and a second word at index n is read only when the
// lane ends inside the first, where the mask drops it.  A block whose
// lanes need more than `block` words (a bit width above 32, which the
// index never writes) decodes from device memory instead, clamped to Wpb,
// exactly as the reference reads it.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;             // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void copy4(unsigned* smem, const unsigned* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem) : "memory");
}
__device__ __forceinline__ void copy16(unsigned* smem, const unsigned* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A block's metadata and the words its lanes read; lane k of a warp holds
// the k-th block of the warp's current batch.
struct Meta {
  unsigned bits;
  int base, count, n;   // n: words the lanes read (at most Wpb)
};

// Lane k < G loads the metadata of block b0 + k (none past nb).
template <int G>
__device__ __forceinline__ Meta load_meta(const int* bits, const int* base,
                                          const int* count, long long b0,
                                          int nb, int wpb, int block,
                                          int lane) {
  Meta m = {0u, 0, 0, 0};
  if (lane < G && b0 + lane < nb) {
    m.bits = (unsigned)bits[b0 + lane];
    m.base = base[b0 + lane];
    m.count = count[b0 + lane];
    const long long need = ((long long)block * m.bits + 31) >> 5;
    m.n = (int)(need < wpb ? (need > 0 ? need : 1) : wpb);
  }
  return m;
}

// Copy the n words of each block of the batch at b0 into its slot of the
// stage (none for a block that decodes from device memory).
template <int G>
__device__ __forceinline__ void stage_batch(unsigned* stage, int cap,
                                            const unsigned* words, int wpb,
                                            long long b0, int nb,
                                            const Meta& m, int block,
                                            bool vec, int lane) {
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int n = __shfl_sync(kAll, m.n, k);
    if (b0 + k >= nb || n > block) continue;
    const unsigned* row = words + (size_t)(b0 + k) * wpb;
    unsigned* dst = stage + k * cap;
    if (vec) {
      for (int c = lane; 4 * c < n; c += 32) copy16(dst + 4 * c, row + 4 * c);
    } else {
      for (int i = lane; i < n; i += 32) copy4(dst + i, row + i);
    }
  }
}

// L lanes per thread (block <= 32 L), G blocks per batch.  A warp walks
// the batches with a stride; `cap` words of stage per block, two stages
// of G blocks per warp.
template <int L, int G>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const unsigned* __restrict__ words, int wpb,
              const int* __restrict__ bits, const int* __restrict__ base,
              const int* __restrict__ count, int* __restrict__ out, int nb,
              int block, int cap) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  unsigned* stages = smem + (size_t)warp * 2 * G * cap;
  const long long stride = (long long)gridDim.x * kWarps * G;
  const bool vec = wpb % 4 == 0 && (size_t)words % 16 == 0;
  long long b0 = ((long long)blockIdx.x * kWarps + warp) * G;
  if (b0 >= nb) return;

  Meta cur = load_meta<G>(bits, base, count, b0, nb, wpb, block, lane);
  stage_batch<G>(stages, cap, words, wpb, b0, nb, cur, block, vec, lane);
  commit();
  long long nx = b0 + stride;
  Meta next = load_meta<G>(bits, base, count, nx, nb, wpb, block, lane);

  for (int s = 0;; s ^= 1) {
    stage_batch<G>(stages + (s ^ 1) * G * cap, cap, words, wpb, nx, nb, next,
                   block, vec, lane);
    commit();
    const Meta after =
        load_meta<G>(bits, base, count, nx + stride, nb, wpb, block, lane);
    wait_one();            // this batch's words have landed
    __syncwarp();

#pragma unroll
    for (int k = 0; k < G; ++k) {
      const long long b = b0 + k;
      if (b >= nb) break;
      const unsigned kbits = __shfl_sync(kAll, cur.bits, k);
      const int kbase = __shfl_sync(kAll, cur.base, k);
      const int kcount = __shfl_sync(kAll, cur.count, k);
      const int kn = __shfl_sync(kAll, cur.n, k);
      const bool staged = kn <= block;
      const unsigned* src = staged ? stages + (s * G + k) * cap
                                   : words + (size_t)b * wpb;
      const int n_src = staged ? kn : wpb;
      unsigned x[L];
      unsigned run = 0;
      const unsigned mask = kbits >= 32u ? 0xffffffffu : ((1u << kbits) - 1u);
      unsigned bp = (unsigned)(lane * L) * kbits;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int j = lane * L + i;
        if (j < block) {
          const int wi = min((int)(bp >> 5), n_src - 1);
          const int w1 = min(wi + 1, n_src - 1);
          run += __funnelshift_r(src[wi], src[w1], bp & 31u) & mask;
        }
        bp += kbits;
        x[i] = run;
      }
      unsigned incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(kAll, incl, o);
        if (lane >= o) incl += y;
      }
      const unsigned first = (unsigned)kbase + (incl - run);
      int* orow = out + (size_t)b * block;
      bool wide = false;
      if constexpr (L >= 4) wide = block % 4 == 0;
      if (wide) {
#pragma unroll
        for (int i = 0; i + 3 < L; i += 4) {
          const int j = lane * L + i;
          if (j < block) {
            int4 v;
            v.x = j < kcount ? (int)(first + x[i]) : -1;
            v.y = j + 1 < kcount ? (int)(first + x[i + 1]) : -1;
            v.z = j + 2 < kcount ? (int)(first + x[i + 2]) : -1;
            v.w = j + 3 < kcount ? (int)(first + x[i + 3]) : -1;
            *reinterpret_cast<int4*>(orow + j) = v;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const int j = lane * L + i;
          if (j < block) orow[j] = j < kcount ? (int)(first + x[i]) : -1;
        }
      }
    }
    __syncwarp();          // this stage is read before it is refilled
    if (nx >= nb) break;
    b0 = nx;
    cur = next;
    nx += stride;
    next = after;
  }
}

template <int L, int G>
int launch(const unsigned* words, int wpb, const int* bits, const int* base,
           const int* count, int* out, int nb, int block,
           cudaStream_t stream) {
  // words staged per block, a multiple of 4 (16-byte copies)
  const int cap = ((wpb < block ? wpb : block) + 3) / 4 * 4;
  const int smem = kWarps * 2 * G * cap * (int)sizeof(unsigned);
  // CTAs resident on the card at once, found once per stage size
  static int resident = 0, for_smem = -1;
  if (for_smem != smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaError_t e = cudaFuncSetAttribute(
        unpack_kernel<L, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, unpack_kernel<L, G>, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    resident = sms * per_sm > 0 ? sms * per_sm : 1;
    for_smem = smem;
  }
  const long long per_cta = (long long)kWarps * G;
  const long long need = ((long long)nb + per_cta - 1) / per_cta;
  unpack_kernel<L, G><<<need < resident ? (int)need : resident, kThreads,
                        smem, stream>>>(words, wpb, bits, base, count, out,
                                        nb, block, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int unpack_blocks_launch(const unsigned* words, int wpb,
                                    const int* bits, const int* base,
                                    const int* count, int* out, int nb,
                                    int block, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (block <= 32) return launch<1, 4>(words, wpb, bits, base, count, out, nb, block, s);
  if (block <= 64) return launch<2, 4>(words, wpb, bits, base, count, out, nb, block, s);
  if (block <= 128) return launch<4, 4>(words, wpb, bits, base, count, out, nb, block, s);
  if (block <= 256) return launch<8, 2>(words, wpb, bits, base, count, out, nb, block, s);
  if (block <= 512) return launch<16, 1>(words, wpb, bits, base, count, out, nb, block, s);
  if (block <= 1024) return launch<32, 1>(words, wpb, bits, base, count, out, nb, block, s);
  return (int)cudaErrorInvalidValue;
}
