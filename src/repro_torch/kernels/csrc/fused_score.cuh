// Fused decode-and-score to dense per-query scores, for sm_90a.
//
// Replaces the dense Pallas kernels of repro/kernels/fused_decode_score.py
// (fused_score_blocked_pallas, body _fused_blocked_kernel;
// fused_score_packed_pallas, body _fused_packed_kernel).  They carry
// mode="dense" and both bands of every banded segment, whose two partial
// score arrays the engine sums before the scoring tail.
//
// What it computes: for each tile-sorted (block, tile) routing pair, the
// block's lanes whose doc falls in the tile and lies below the pair's cap
// add qw[q] * tf into f32 out[Q, num_docs] (one fused multiply-add, as the
// reference's XLA lowering contracts it), the pairs in order.  Tiles no
// pair visits come out as 0.0 (the reference's _finish); padding pairs
// sit at tile n_tiles, which has no CTA, so nothing is written for them.
//
// What bounds it: bytes.  Every routed pair reads one posting block (HOR
// 1 KB; packed 4 * words_per_block B + 256 B) and the kernel writes the
// whole f32 [Q, num_docs] array (32 MB for 8 queries at 1M docs, more than
// a batch's posting bytes); a handful of flops per byte, far below the
// card's ops:byte ridge.  A tile's pairs are few (~34 at the 1M tier's
// packed band), so the latency of a CTA's walk over its run, not the
// bytes, sets the time unless the walk is taken off a serial chain.
//
// Design: one launch per call, one CTA of 512 threads per doc tile.
//   1. The CTA finds its run [p0, p1) of pairs itself (run_walk.cuh).
//   2. It stages the run in chunks of kChunk pairs through shared memory
//      with cp.async: a chunk's metadata (block, cap, the qw row, and for
//      packed blocks bits, base and count) two chunks ahead, its posting
//      blocks one chunk ahead, so the copies of chunk k + 1 are in flight
//      while chunk k is added.
//   3. Each chunk is scattered into a map lane[j][local] (the lane of pair
//      j whose doc sits at `local` in the tile, -1 if none; the cap and the
//      tile test applied): HOR lanes straight from the staged blocks, four
//      pairs at once, packed blocks decoded first, one warp per pair (four
//      lanes per thread and a warp scan of the deltas), 16 pairs at once.
//   4. The adds keep the reference's order without a barrier per pair:
//      each thread owns the tile positions tid, tid + 512, ... and walks
//      the chunk's pairs in order for them, adding qw[q] * tf with
//      __fmaf_rn (built with -fmad=false, so nothing else contracts).  A
//      doc's adds all come from its owner, in pair order; no atomics.
//      This keeps each launch equal to its plain version, to the bit.  The
//      map is double-buffered: chunk k's is cleared while chunk k + 1 is
//      mapped.  Q = 8 and 16 (tiles of up to 512 docs) have kernels of
//      their own: the owner's one position keeps its Q sums in registers
//      and stores them to the shared [Q, tile] accumulator at the end;
//      any other Q or tile adds into that accumulator directly.
//   5. The tile's Q rows are written with 16-byte stores, coalesced along
//      the docs, clipped at num_docs (a row that does not start on a
//      16-byte boundary takes up to three scalar stores at each end).  An
//      unvisited tile writes its zeros the same way, without staging.
#pragma once

#include <cstdint>

#include "run_walk.cuh"
#include "tile_accumulate.cuh"

namespace fused_score {

constexpr int kThreads = 512;        // CTA size: one thread per tile doc
constexpr int kLanes = 128;          // posting block width
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;           // pairs per pipeline stage
constexpr int kMetaBufs = 3;         // metadata of chunks k, k + 1, k + 2
constexpr int kRingBufs = 2;         // blocks of chunks k and k + 1
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// The tile-sorted routing pairs, n of them with the padding.
struct Pairs {
  const int* block;
  const int* tile;
  const int* cap;
  const float* qw;       // [n, q]
  const int* bits;       // packed blocks only
  const int* base;
  const int* count;
  int n;
};

// HOR blocks: raw i32 doc ids and f32 tfs; a ring slot holds both rows.
struct HorBlocks {
  static constexpr bool kPacked = false;
  static constexpr int kMetaInts = 2;            // block, cap
  const int* docs;       // [NB, 128]
  const float* tfs;      // [NB, 128]

  __host__ __device__ int slot_bytes() const { return kLanes * 8; }

  // Start the copies of rows[0..n)'s blocks into `ring`.
  __device__ __forceinline__ void issue(unsigned char* ring, const int* rows,
                                        int n) const {
    run_walk::copy_rows(ring, slot_bytes(),
                        reinterpret_cast<const unsigned char*>(docs), rows, n,
                        kLanes * 4, kThreads);
    run_walk::copy_rows(ring + kLanes * 4, slot_bytes(),
                        reinterpret_cast<const unsigned char*>(tfs), rows, n,
                        kLanes * 4, kThreads);
  }
};

// Packed blocks: delta+bit-packed u32 words and f16 tfs; a ring slot holds
// the words (padded to 16 bytes) and then the tfs, still compressed.
struct PackedBlocks {
  static constexpr bool kPacked = true;
  static constexpr int kMetaInts = 5;  // block, cap, bits, base, count
  const unsigned* words;       // [NB, wpb]
  const unsigned short* tfs;   // [NB, 128] f16 bits
  int wpb;

  __host__ __device__ int words_bytes() const { return round16(wpb * 4); }
  __host__ __device__ int slot_bytes() const {
    return words_bytes() + kLanes * 2;
  }

  __device__ __forceinline__ void issue(unsigned char* ring, const int* rows,
                                        int n) const {
    run_walk::copy_rows(ring, slot_bytes(),
                        reinterpret_cast<const unsigned char*>(words), rows, n,
                        wpb * 4, kThreads);
    run_walk::copy_rows(ring + words_bytes(), slot_bytes(),
                        reinterpret_cast<const unsigned char*>(tfs), rows, n,
                        kLanes * 2, kThreads);
  }
};

// Dynamic shared memory, every part on a 16-byte boundary: the [q, tile]
// accumulator, two [kChunk, tile] lane maps (i8), kMetaBufs metadata
// buffers (kMetaInts rows of kChunk ints, then kChunk qw rows of q
// floats), kRingBufs block buffers of kChunk slots, and for packed blocks
// the chunk's decoded tfs [kChunk, 128] f32.
template <class Blocks>
struct Plan {
  int q, tile, slot;
  __host__ __device__ Plan(const Blocks& bl, int q_, int tile_)
      : q(q_), tile(tile_), slot(bl.slot_bytes()) {}
  __host__ __device__ int acc_bytes() const { return round16(q * tile * 4); }
  __host__ __device__ int map_bytes() const {     // one of the two maps
    return round16(kChunk * tile);
  }
  __host__ __device__ int meta_bytes() const {
    return round16(kChunk * (Blocks::kMetaInts + q) * 4);
  }
  __host__ __device__ int ring_bytes() const { return kChunk * slot; }
  __host__ __device__ int tf_bytes() const {
    return Blocks::kPacked ? kChunk * kLanes * 4 : 0;
  }
  // each part's offset from the base, in the order above
  __host__ __device__ int map_off() const { return acc_bytes(); }
  __host__ __device__ int meta_off() const {
    return map_off() + 2 * map_bytes();
  }
  __host__ __device__ int ring_off() const {
    return meta_off() + kMetaBufs * meta_bytes();
  }
  __host__ __device__ int tf_off() const {
    return ring_off() + kRingBufs * ring_bytes();
  }
  __host__ __device__ size_t total() const {
    return (size_t)tf_off() + tf_bytes();
  }
};

// Start the copies of the metadata of pairs [c0, c0 + n) into `meta`.
template <class Blocks>
__device__ __forceinline__ void issue_meta(const Pairs& pr,
                                           unsigned char* meta, int c0,
                                           int n, int q) {
  int* mi = reinterpret_cast<int*>(meta);
  const int i = threadIdx.x;
  if (i < n) {
    run_walk::copy4(mi + i, pr.block + c0 + i);
    run_walk::copy4(mi + kChunk + i, pr.cap + c0 + i);
    if (Blocks::kPacked) {
      run_walk::copy4(mi + 2 * kChunk + i, pr.bits + c0 + i);
      run_walk::copy4(mi + 3 * kChunk + i, pr.base + c0 + i);
      run_walk::copy4(mi + 4 * kChunk + i, pr.count + c0 + i);
    }
  }
  run_walk::copy_span(
      reinterpret_cast<unsigned char*>(mi + Blocks::kMetaInts * kChunk),
      reinterpret_cast<const unsigned char*>(pr.qw + (size_t)c0 * q),
      n * q * 4, kThreads);
}

// Map the n staged HOR blocks of a chunk: thread t takes lane t % 128 of
// pairs t / 128, t / 128 + 4, ...  A block's doc ids are unique, so no two
// lanes of a pair meet.
__device__ __forceinline__ void scatter_chunk(const HorBlocks& bl,
                                              const unsigned char* ring,
                                              const int* mi, int n,
                                              int tile_base, int tile,
                                              signed char* map, float*) {
  constexpr int kStep = kThreads / kLanes;      // pairs at once
  const int i = threadIdx.x % kLanes;
  const int j0 = threadIdx.x / kLanes;
  int doc[kChunk / kStep];
#pragma unroll
  for (int r = 0; r < kChunk / kStep; ++r) {
    const int j = j0 + r * kStep;
    doc[r] = j < n && i < mi[kChunk + j]
                 ? reinterpret_cast<const int*>(ring + j * bl.slot_bytes())[i]
                 : -1;
  }
#pragma unroll
  for (int r = 0; r < kChunk / kStep; ++r) {
    const int loc = doc[r] - tile_base;
    if (doc[r] >= 0 && loc >= 0 && loc < tile)
      map[(j0 + r * kStep) * tile + loc] = (signed char)i;
  }
}

// Decode and map the n staged packed blocks of a chunk; their tfs go to
// tf[j][lane] as f32.  Warp w decodes pairs w, w + kWarps, ...; a thread
// takes four consecutive lanes.  Doc id = base + the inclusive prefix sum
// of the deltas, in wrapping 32-bit arithmetic (any order of the adds
// gives the same bits); -1 at or past the block's count.
__device__ __forceinline__ void scatter_chunk(const PackedBlocks& bl,
                                              const unsigned char* ring,
                                              const int* mi, int n,
                                              int tile_base, int tile,
                                              signed char* map, float* tf) {
  const int wl = threadIdx.x % 32;
  const int lane0 = 4 * wl;
  for (int j = threadIdx.x / 32; j < n; j += kWarps) {
    const unsigned char* slot = ring + j * bl.slot_bytes();
    const unsigned* w = reinterpret_cast<const unsigned*>(slot);
    const unsigned short* tf16 =
        reinterpret_cast<const unsigned short*>(slot + bl.words_bytes());
    const unsigned bits = (unsigned)mi[2 * kChunk + j];
    unsigned s[4];
    unsigned run = 0;
    for (int i = 0; i < 4; ++i) {
      run += tile_acc::packed_delta(w, bl.wpb, bits, lane0 + i);
      s[i] = run;
    }
    unsigned incl = run;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
      if (wl >= o) incl += y;
    }
    const unsigned before = (unsigned)mi[3 * kChunk + j] + (incl - run);
    const int count = mi[4 * kChunk + j];
    const int cap = mi[kChunk + j];
    for (int i = 0; i < 4; ++i) {
      const int lane = lane0 + i;
      const int doc = lane < count ? (int)(before + s[i]) : -1;
      const int loc = doc - tile_base;
      if (doc >= 0 && loc >= 0 && loc < tile && lane < cap)
        map[j * tile + loc] = (signed char)lane;
      tf[j * kLanes + lane] = __half2float(__ushort_as_half(tf16[lane]));
    }
  }
}

// The tf of pair j's lane in a chunk.
__device__ __forceinline__ float tf_of(const HorBlocks& bl,
                                       const unsigned char* ring,
                                       const float*, int j, int lane) {
  return reinterpret_cast<const float*>(ring + j * bl.slot_bytes() +
                                        kLanes * 4)[lane];
}

__device__ __forceinline__ float tf_of(const PackedBlocks&,
                                       const unsigned char*, const float* tf,
                                       int j, int lane) {
  return tf[j * kLanes + lane];
}

// Add the n mapped pairs of a chunk, in pair order, for the positions this
// thread owns.  kQ > 0 (q == kQ, a multiple of 4; tile <= kThreads): the
// thread's one position `tid` adds into its registers `sum`, the weight
// row loaded 16 bytes at a time.  kQ == 0: every position tid,
// tid + kThreads, ... adds into acc[q][tile].
template <class Blocks, int kQ>
__device__ __forceinline__ void add_chunk(const Blocks& bl,
                                          const unsigned char* ring,
                                          const unsigned char* meta,
                                          const float* tf, int n, int q,
                                          int tile, const signed char* map,
                                          float* acc, float* sum) {
  const float* qw = reinterpret_cast<const float*>(
      reinterpret_cast<const int*>(meta) + Blocks::kMetaInts * kChunk);
  if constexpr (kQ > 0) {
    const int loc = threadIdx.x;
    if (loc >= tile) return;
    // every load of the chunk first (map entries, then the hits' tfs),
    // then the adds in pair order: one wait per chunk, not per pair
    const signed char* m = map + loc;
    int lane[kChunk];
    float tv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) lane[j] = j < n ? m[j * tile] : -1;
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      tv[j] = lane[j] >= 0 ? tf_of(bl, ring, tf, j, lane[j]) : 0.0f;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (lane[j] < 0) continue;
      const float* w = qw + j * kQ;
#pragma unroll
      for (int qi = 0; qi < kQ; qi += 4) {
        const float4 x = *reinterpret_cast<const float4*>(w + qi);
        sum[qi] = __fmaf_rn(x.x, tv[j], sum[qi]);
        sum[qi + 1] = __fmaf_rn(x.y, tv[j], sum[qi + 1]);
        sum[qi + 2] = __fmaf_rn(x.z, tv[j], sum[qi + 2]);
        sum[qi + 3] = __fmaf_rn(x.w, tv[j], sum[qi + 3]);
      }
    }
  } else {
    for (int j = 0; j < n; ++j) {
      const float* w = qw + j * q;
      for (int loc = threadIdx.x; loc < tile; loc += kThreads) {
        const int lane = map[j * tile + loc];
        if (lane < 0) continue;
        const float t = tf_of(bl, ring, tf, j, lane);
        for (int qi = 0; qi < q; ++qi)
          acc[qi * tile + loc] = __fmaf_rn(w[qi], t, acc[qi * tile + loc]);
      }
    }
  }
}

// Set `bytes` (a multiple of 16) of lane map to -1, 16 bytes a store.
__device__ __forceinline__ void clear_map(signed char* map, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
    reinterpret_cast<int4*>(map)[i] = make_int4(-1, -1, -1, -1);
}

// Write the tile's q rows of `acc` (zeros where acc is null) into
// out[q, num_docs] at tile_base, `width` docs each: 16-byte stores along
// the docs, and scalar ones for the up to three docs before a row's first
// 16-byte boundary and after its last.
__device__ __forceinline__ void write_tile(const float* acc,
                                           float* __restrict__ out,
                                           int num_docs, int q, int tile,
                                           int tile_base, int width) {
  constexpr int kGroup = 128;         // threads per row
  const int i = threadIdx.x % kGroup;
  for (int qi = threadIdx.x / kGroup; qi < q; qi += kThreads / kGroup) {
    float* dst = out + (size_t)qi * num_docs + tile_base;
    const float* src = acc ? acc + (size_t)qi * tile : nullptr;
    const int mis = (int)(reinterpret_cast<uintptr_t>(dst) & 15u) >> 2;
    const int head = min(width, (4 - mis) & 3);
    const int nvec = (width - head) >> 2;
    float4* dv = reinterpret_cast<float4*>(dst + head);
    for (int v = i; v < nvec; v += kGroup) {
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (acc) {
        const float* s = src + head + 4 * v;
        x = make_float4(s[0], s[1], s[2], s[3]);
      }
      dv[v] = x;
    }
    const int tail = head + 4 * nvec;
    if (i < head) dst[i] = acc ? src[i] : 0.0f;
    if (i < width - tail) dst[tail + i] = acc ? src[tail + i] : 0.0f;
  }
}

// kQ > 0: compiled for q == kQ; kQ == 0: any q.
template <class Blocks, int kQ>
__global__ void __launch_bounds__(kThreads, 3)
score_kernel(Blocks bl, Pairs pr, float* __restrict__ out, int num_docs,
             int q, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int run[2];
  const Plan<Blocks> plan(bl, q, tile);
  const int t = blockIdx.x;
  const int2 bounds = run_walk::find_run(pr.tile, pr.n, t, run);
  const int tile_base = t * tile;
  const int width = min(tile, num_docs - tile_base);   // clipped last tile
  if (bounds.x == bounds.y) {        // no pair visits this tile: zeros
    write_tile(nullptr, out, num_docs, q, tile, tile_base, width);
    return;
  }
  float* acc = reinterpret_cast<float*>(smem);
  signed char* map = reinterpret_cast<signed char*>(smem + plan.map_off());
  unsigned char* meta = smem + plan.meta_off();
  unsigned char* ring = smem + plan.ring_off();
  float* tf = reinterpret_cast<float*>(smem + plan.tf_off());
  const int p0 = bounds.x;
  const int n_run = bounds.y - p0;
  const int n_chunks = (n_run + kChunk - 1) / kChunk;
  auto meta_of = [&](int k) {
    return meta + (k % kMetaBufs) * plan.meta_bytes();
  };
  auto ring_of = [&](int k) {
    return ring + (k % kRingBufs) * plan.ring_bytes();
  };
  auto len_of = [&](int k) { return min(kChunk, n_run - k * kChunk); };
  auto map_of = [&](int k) { return map + (k % 2) * plan.map_bytes(); };

  // prologue: chunk 0's metadata, then its blocks and chunk 1's metadata
  issue_meta<Blocks>(pr, meta_of(0), p0, len_of(0), q);
  run_walk::commit();
  if constexpr (kQ == 0)
    for (int i = threadIdx.x; i < q * tile; i += kThreads) acc[i] = 0.0f;
  float sum[kQ > 0 ? kQ : 1];
#pragma unroll
  for (int qi = 0; qi < (kQ > 0 ? kQ : 1); ++qi) sum[qi] = 0.0f;
  clear_map(map, 2 * plan.map_bytes());
  run_walk::wait_all();
  __syncthreads();
  bl.issue(ring_of(0), reinterpret_cast<const int*>(meta_of(0)), len_of(0));
  if (n_chunks > 1)
    issue_meta<Blocks>(pr, meta_of(1), p0 + kChunk, len_of(1), q);
  run_walk::commit();

  for (int k = 0; k < n_chunks; ++k) {
    // chunk k's blocks and chunk k + 1's metadata are in; every read of
    // the buffers the copies below overwrite, of the map cleared below and
    // of the tfs came before this barrier
    run_walk::wait_all();
    __syncthreads();
    if (k > 0) clear_map(map_of(k + 1), plan.map_bytes());
    if (k + 1 < n_chunks)
      bl.issue(ring_of(k + 1), reinterpret_cast<const int*>(meta_of(k + 1)),
               len_of(k + 1));
    if (k + 2 < n_chunks)
      issue_meta<Blocks>(pr, meta_of(k + 2), p0 + (k + 2) * kChunk,
                         len_of(k + 2), q);
    run_walk::commit();
    scatter_chunk(bl, ring_of(k), reinterpret_cast<const int*>(meta_of(k)),
                  len_of(k), tile_base, tile, map_of(k), tf);
    __syncthreads();
    add_chunk<Blocks, kQ>(bl, ring_of(k), meta_of(k), tf, len_of(k), q, tile,
                          map_of(k), acc, sum);
  }
  if constexpr (kQ > 0) {
    if (threadIdx.x < tile) {
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) acc[qi * tile + threadIdx.x] = sum[qi];
    }
  }
  __syncthreads();
  write_tile(acc, out, num_docs, q, tile, tile_base, width);
}

// Allow score_kernel<Blocks, kQ> `smem` bytes of dynamic shared memory:
// the opt-in above 48 KB, asked once per device and size.
template <class Blocks, int kQ>
cudaError_t allow_smem(size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static size_t allowed[16] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || smem <= 48 * 1024 ||
      (dev < 16 && smem <= allowed[dev]))
    return e;
  e = cudaFuncSetAttribute(score_kernel<Blocks, kQ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < 16) allowed[dev] = smem;
  return e;
}

template <class Blocks, int kQ>
int launch_q(const Blocks& bl, const Pairs& pr, float* out, int n_tiles,
             int num_docs, int q, int tile, void* stream) {
  const size_t smem = Plan<Blocks>(bl, q, tile).total();
  const cudaError_t e = allow_smem<Blocks, kQ>(smem);
  if (e != cudaSuccess) return (int)e;
  score_kernel<Blocks, kQ>
      <<<n_tiles, kThreads, smem, (cudaStream_t)stream>>>(bl, pr, out,
                                                          num_docs, q, tile);
  return (int)cudaGetLastError();
}

// The engines pad Q to a multiple of 8: 8 and 16 (batches of up to 16
// queries) at tiles of up to 512 docs run the kernel compiled for their Q,
// anything else the generic one.
template <class Blocks>
int launch(const Blocks& bl, const Pairs& pr, float* out, int n_tiles,
           int num_docs, int q, int tile, void* stream) {
  if (tile > kThreads)
    return launch_q<Blocks, 0>(bl, pr, out, n_tiles, num_docs, q, tile,
                               stream);
  if (q == 8)
    return launch_q<Blocks, 8>(bl, pr, out, n_tiles, num_docs, q, tile,
                               stream);
  if (q == 16)
    return launch_q<Blocks, 16>(bl, pr, out, n_tiles, num_docs, q, tile,
                                stream);
  return launch_q<Blocks, 0>(bl, pr, out, n_tiles, num_docs, q, tile,
                             stream);
}

template <class Blocks, int kQ>
int occupancy_q(const Blocks& bl, int q, int tile, int* smem) {
  const size_t bytes = Plan<Blocks>(bl, q, tile).total();
  *smem = (int)bytes;
  cudaError_t e = allow_smem<Blocks, kQ>(bytes);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, score_kernel<Blocks, kQ>, kThreads, bytes);
  return e == cudaSuccess ? ctas : -(int)e;
}

// CTAs of the kernel `launch` picks for (q, tile) that fit on one SM, and
// the dynamic shared memory each takes (*smem); a negative cudaError_t if
// the runtime refuses.
template <class Blocks>
int occupancy(const Blocks& bl, int q, int tile, int* smem) {
  if (tile > kThreads) return occupancy_q<Blocks, 0>(bl, q, tile, smem);
  if (q == 8) return occupancy_q<Blocks, 8>(bl, q, tile, smem);
  if (q == 16) return occupancy_q<Blocks, 16>(bl, q, tile, smem);
  return occupancy_q<Blocks, 0>(bl, q, tile, smem);
}

}  // namespace fused_score
