// Packed-block decoder, for sm_90a.  Replaces unpack_blocks_pallas
// (repro/kernels/packed_postings.py, body _unpack_kernel), behind
// ops.unpack_postings: every block of a PackedCsrIndex decoded to i32
// [NB, block] doc ids, -1 at or past each block's count.
//
// What bounds it: bytes.  It reads each block's packed words and its
// (bits, base, count) once and writes 4 B per lane; a shift, an or, a mask
// and a scan step per lane.
//
// Design: one CTA per posting block, one thread per lane (the CTA is the
// block width rounded up to a warp, at most 1024 threads; lanes past the
// width decode nothing).  The decode is tile_accumulate.cuh's, shared with
// the fused packed kernels: packed_delta extracts each lane's delta,
// block_inclusive_scan sums them, and doc id = base + the wrapping 32-bit
// inclusive sum, as the reference's int32 cumsum.
#include "tile_accumulate.cuh"

namespace {

__global__ void __launch_bounds__(1024)
unpack_kernel(const unsigned* __restrict__ words, int wpb,
              const int* __restrict__ bits, const int* __restrict__ base,
              const int* __restrict__ count, int* __restrict__ out,
              int block) {
  __shared__ unsigned warp_sums[32];
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned x =
      lane < block
          ? tile_acc::packed_delta(words + b * wpb, wpb, (unsigned)bits[b],
                                   lane)
          : 0u;
  const unsigned sum = tile_acc::block_inclusive_scan(x, warp_sums);
  if (lane < block)
    out[b * block + lane] =
        lane < count[b] ? (int)((unsigned)base[b] + sum) : -1;
}

}  // namespace

extern "C" int unpack_blocks_launch(const unsigned* words, int wpb,
                                    const int* bits, const int* base,
                                    const int* count, int* out, int nb,
                                    int block, void* stream) {
  const int threads = (block + 31) / 32 * 32;
  unpack_kernel<<<nb, threads, 0, (cudaStream_t)stream>>>(
      words, wpb, bits, base, count, out, block);
  return (int)cudaGetLastError();
}
