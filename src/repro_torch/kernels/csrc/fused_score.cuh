// Fused decode-and-score, for sm_90a: one walk over a tile's routing
// pairs, with two epilogues.
//
// Replaces the four Pallas kernels of repro/kernels/fused_decode_score.py
// and the bitonic tile reducer of the candidate ones (_tile_topk_bitonic):
// the dense ones (fused_score_blocked_pallas, body _fused_blocked_kernel;
// fused_score_packed_pallas, body _fused_packed_kernel), which carry
// mode="dense" and both bands of every banded segment, and the candidate
// ones (fused_topk_blocked_pallas, body _fused_blocked_topk_kernel;
// fused_topk_packed_pallas, body _fused_packed_topk_kernel), which carry
// mode="candidates" over HOR and packed segments.
//
// What the walk computes: for each tile-sorted (block, tile) routing pair,
// the block's lanes whose doc falls in the tile and lies below the pair's
// cap add qw[q] * tf into the tile's f32 [Q, tile] sums (one fused
// multiply-add, as the reference's XLA lowering contracts it), the pairs
// in order.  Padding pairs sit at tile n_tiles, which has no CTA.  Then:
//   - DenseOut writes the sums into f32 out[Q, num_docs]; tiles no pair
//     visits come out as 0.0 (the reference's _finish);
//   - TopkOut applies the scoring tail (_final_from_acc: the cosine
//     sum / (max(norm, 1e-12) * qnorm), then rank_blend * rank added as
//     one fused multiply-add; -inf where norm == 0, the sum is 0 or the
//     lane is past num_docs) and keeps each query's k_tile best lanes
//     (_tile_topk: value descending, +0.0 and -0.0 tied, lowest lane
//     first, id -1 where the value is not finite; a zero slot writes the
//     row's maximum, +0.0 while one is left; a row holding a NaN gives
//     (NaN, -1) throughout), written tile-major into [Q, n_tiles *
//     k_tile]; an unvisited tile gives (-inf, -1) throughout;
//   - BitonicOut applies the same tail and gives _tile_topk_bitonic's
//     first k_tile columns of each row sorted by (value descending,
//     lowest lane first) with the reference's network: the same ids, each
//     slot with its lane's own bits.
//
// What bounds it: bytes.  Every routed pair reads one posting block (HOR
// 1 KB; packed 4 * words_per_block B + 256 B); DenseOut writes the whole
// f32 [Q, num_docs] array (32 MB for 8 queries at 1M docs), the candidate
// epilogues only Q * k_tile candidates per tile.  A handful of flops per
// byte, far below the card's ops:byte ridge.  A tile's pairs are few (~34
// at the 1M tier's packed band), so the latency of a CTA's walk over its
// run, not the bytes, sets the time unless the walk is taken off a serial
// chain; after the walk, a candidate CTA's time is one warp's selection
// per row (a few dozen dependent shuffles and shared-memory loads).
//
// Design: one launch per call, one CTA of 512 threads per doc tile.
//   1. The CTA finds its run [p0, p1) of pairs itself (run_walk.cuh).
//   2. It stages the run in chunks of kChunk pairs through shared memory
//      with cp.async: a chunk's metadata (block, cap, the qw row, and for
//      packed blocks bits, base and count) two chunks ahead, its posting
//      blocks one chunk ahead, so the copies of chunk k + 1 are in flight
//      while chunk k is added.  At Q = 8 and 16, TopkOut stages the
//      tile's norm and rank with chunk 0's metadata.
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
//      their own: the owner's one position keeps its Q sums in registers;
//      any other Q or tile adds into the shared [Q, tile] accumulator.
//   5. DenseOut: the sums go to the accumulator, and the tile's Q rows are
//      written with 16-byte stores, coalesced along the docs, clipped at
//      num_docs.  An unvisited tile writes its zeros the same way.
//   6. The candidate epilogues: each owner turns its sums into final
//      scores in registers (__fdiv_rn, __fmul_rn, __fmaf_rn: the
//      reference's op sequence) and stores them into the accumulator as
//      order-preserving u32 keys, one pass, in which -0.0 takes +0.0's
//      key (select_key): the two zeros tie and go by lane, as the
//      reference's float comparisons order them.  What the shared key
//      loses the owner notes aside, rarely (a zero's final score needs a
//      tail that underflows or a blend that cancels): TopkOut each row's
//      last +0.0, BitonicOut a bit per -0.0, in shared memory the walk
//      no longer uses.  The barrier that ends the pass votes whether any
//      score is a zero or a NaN.  One warp per query row then keeps the
//      row's k_tile best; lane l holds the positions [l * per, (l + 1) *
//      per) of the tile's docs below num_docs.  The k_tile-th largest of
//      the lanes' bests (or of their two largest) bounds the answer from
//      below; when at most 64 keys pass it, they are gathered and sorted
//      by one warp-wide bitonic sort (select_few).  Otherwise (ties,
//      k_tile > 32, tiles > 512) the warp takes successive maxima: each
//      step one __reduce_max_sync finds the row's largest key, the lowest
//      lane holding it (a ballot) emits it and rescans its positions.
//      Both keep _tile_topk's order: value descending, the lowest doc
//      first on ties.  Only a CTA that voted pays for the rest: its slots
//      that selected a zero take their value by the epilogue's rule
//      (fix_zeros): TopkOut's, the row's maximum (+0.0 if the row's last
//      +0.0 lies at or after the slot's lane: zeros are taken in lane
//      order, so those are the zeros left), BitonicOut's, the lane's own
//      bits; and TopkOut's warps first look for a NaN in their row and,
//      finding one, write (NaN, -1) throughout, as successive maxima
//      whose maximum is NaN do.
//   7. BitonicOut: for rows without NaN, the reference's network is a
//      sort by a strict total order on (value, lane), values never
//      recomputed, so its first k_tile columns are the selection's, each
//      with its lane's own bits: a CTA without NaN selects, up to k_tile
//      kBitonicSelectUpTo (past it the selection's successive maxima, one
//      dependent step a slot, take longer than the network's 55 fixed
//      stages at tile 512: scripts/profile_bitonic.py).  A CTA holding a
//      NaN (a second vote, where the first found one), where the
//      network's output depends on positions, and one above that k_tile,
//      turns its keys back into f32 scores, each zero with its sign,
//      beside a u16 [Q, tile] array of lanes and sorts every row with the
//      network, stage by stage: at each stage every position keeps itself
//      or its partner (position ^ stride) by the reference's float
//      comparisons, values moved, not recomputed.  Strides under 32 run
//      in registers, one element per lane of a warp, by shuffles (several
//      stages per load); longer ones in shared memory, one pair per thread
//      and a barrier per stage.
#pragma once

#include <cstdint>
#include <cuda_fp16.h>
#include <math_constants.h>

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
// floats), kRingBufs block buffers of kChunk slots, for packed blocks
// the chunk's decoded tfs [kChunk, 128] f32, and for an epilogue that
// sorts (`lanes`) a u16 [q, tile] lane array.
template <class Blocks>
struct Plan {
  int q, tile, slot;
  bool lanes;
  __host__ __device__ Plan(const Blocks& bl, int q_, int tile_, bool lanes_)
      : q(q_), tile(tile_), slot(bl.slot_bytes()), lanes(lanes_) {}
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
  __host__ __device__ int lane_off() const { return tf_off() + tf_bytes(); }
  __host__ __device__ int lane_bytes() const {
    return lanes ? round16(q * tile * 2) : 0;
  }
  __host__ __device__ size_t total() const {
    return (size_t)lane_off() + lane_bytes();
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

// The dense epilogue: the tile's sums into out[q, num_docs].
struct DenseOut {
  static constexpr bool kLaneArray = false;
  float* out;

  template <int kQ>
  __device__ __forceinline__ void stage(unsigned char*, int, int, int) const {
  }

  __device__ __forceinline__ void empty(int t, int num_docs, int q,
                                        int tile) const {
    const int base = t * tile;
    write_tile(nullptr, out, num_docs, q, tile, base,
               min(tile, num_docs - base));
  }

  // `sum`: the owner's Q sums (kQ > 0); else `acc` holds them
  template <int kQ>
  __device__ __forceinline__ void finish(float* acc, const float* sum, int t,
                                         int num_docs, int q, int tile,
                                         unsigned char*,
                                         unsigned char*) const {
    if constexpr (kQ > 0) {
      if (threadIdx.x < tile) {
#pragma unroll
        for (int qi = 0; qi < kQ; ++qi) acc[qi * tile + threadIdx.x] = sum[qi];
      }
    }
    __syncthreads();
    const int base = t * tile;
    write_tile(acc, out, num_docs, q, tile, base, min(tile, num_docs - base));
  }
};

// A final score as a u32 key whose unsigned order is the floats' order
// (-inf lowest); 0 lies below every key of a float that is not NaN.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

constexpr unsigned kNegInfKey = 0x007fffffu;      // order_key(-inf)
constexpr unsigned kPosInfKey = 0xff800000u;      // order_key(+inf)
constexpr unsigned kZeroKey = 0x80000000u;        // order_key(+0.0f)

// The key the candidate epilogues select by: order_key, but -0.0 takes
// +0.0's key, so that the two zeros tie and go by lane, as the
// reference's float comparisons order them.  What the shared key loses,
// a zero's sign, the owners note aside (note_zero).
__device__ __forceinline__ unsigned select_key(float v) {
  return v == 0.0f ? kZeroKey : order_key(v);
}

// The bitonic epilogue selects each row's first k_tile, as the candidate
// epilogue does, up to this k_tile; above it the CTA runs the network.
constexpr int kBitonicSelectUpTo = 64;

// The candidate epilogue: the scoring tail and each query's k_tile best
// lanes, into vals / ids [q, n_tiles * k_tile], tile-major.  A slot
// holding a zero writes the row's maximum (_tile_topk): +0.0 while a
// +0.0 is left in the row.  A row holding a NaN writes (NaN, -1) in
// every slot.
struct TopkOut {
  static constexpr bool kLaneArray = false;
  const float* norm;     // [num_docs]
  const float* rank;     // [num_docs]
  const float* qnorm;    // [q]
  float* vals;
  int* ids;
  int n_tiles, k_tile;
  float rank_blend;

  // kQ > 0: the norm and rank of the tile's `width` docs from `base` into
  // the accumulator (unused by the walk there), in the caller's first
  // copy group
  template <int kQ>
  __device__ __forceinline__ void stage(unsigned char* acc, int base,
                                        int tile, int width) const {
    if constexpr (kQ > 0) {
      const int i = threadIdx.x;
      if (i < width) {
        float* a = reinterpret_cast<float*>(acc);
        run_walk::copy4(a + i, norm + base + i);
        run_walk::copy4(a + tile + i, rank + base + i);
      }
    }
  }

  __device__ __forceinline__ void empty(int t, int, int q, int) const {
    const size_t row = (size_t)n_tiles * k_tile;
    for (int i = threadIdx.x; i < q * k_tile; i += kThreads) {
      const size_t o = (i / k_tile) * row + (size_t)t * k_tile + i % k_tile;
      vals[o] = -CUDART_INF_F;
      ids[o] = -1;
    }
  }

  // the reference's tail (query.final_scores), never contracted further
  __device__ __forceinline__ float final_score(float s, float nm, float rk,
                                               int qi) const {
    const float denom = __fmul_rn(fmaxf(nm, 1e-12f), qnorm[qi]);
    const float fin = __fmaf_rn(rank_blend, rk, __fdiv_rn(s, denom));
    return (nm > 0.0f && s > 0.0f) ? fin : -CUDART_INF_F;
  }

  // `spare`: a metadata buffer the walk no longer uses, which holds
  // each row's last +0.0 (zero_words)
  template <int kQ>
  __device__ __forceinline__ void finish(float* acc, const float* sum, int t,
                                         int num_docs, int q, int tile,
                                         unsigned char*,
                                         unsigned char* spare) const {
    int* zeros = reinterpret_cast<int*>(spare);
    const bool rare = write_keys<kQ, false>(acc, sum, t, num_docs, q, tile,
                                            zeros) != 0;
    select_rows<false>(reinterpret_cast<unsigned*>(acc), t, num_docs, q,
                       tile, rare, zeros);
  }

  // Where a row's zeros keep what their shared key loses, `words` ints a
  // row: with the row's maximum (kOwn false) the position of its last
  // +0.0 (-1 if none), with own bits (kOwn) one bit a lane set at -0.0.
  template <bool kOwn>
  static __device__ __forceinline__ int zero_words(int tile) {
    return kOwn ? (tile + 31) / 32 : 1;
  }

  template <bool kOwn>
  static __device__ __forceinline__ void note_zero(int* zeros, int qi,
                                                   int loc, int tile,
                                                   float f) {
    if (kOwn) {
      if (signbit(f))
        atomicOr(reinterpret_cast<unsigned*>(zeros) +
                     qi * zero_words<true>(tile) + loc / 32,
                 1u << (loc % 32));
    } else if (!signbit(f)) {
      atomicMax(zeros + qi, loc);
    }
  }

  // The value a slot that selected a zero at position p of row qi writes.
  template <bool kOwn>
  static __device__ __forceinline__ float zero_value(const int* zeros,
                                                     int qi, int p,
                                                     int tile) {
    if (kOwn) {
      const unsigned bits = reinterpret_cast<const unsigned*>(
          zeros)[qi * zero_words<true>(tile) + p / 32];
      return (bits >> (p % 32)) & 1u ? -0.0f : 0.0f;
    }
    // zeros are taken in lane order, so the zeros left are p and after
    return p <= zeros[qi] ? 0.0f : -0.0f;
  }

  // The owners turn their sums into final scores in registers and store
  // their selection keys in place of the sums (kQ > 0: of the staged norm
  // and rank), one pass; a zero is noted in `zeros`, cleared before the
  // pass.  Returns the CTA's vote, on the barrier that ends the pass:
  // bit 0 a zero or a NaN anywhere, bit 1 a NaN in this thread's scores.
  template <int kQ, bool kOwn>
  __device__ __forceinline__ int write_keys(float* acc, const float* sum,
                                            int t, int num_docs, int q,
                                            int tile, int* zeros) const {
    const int base = t * tile;
    const int width = min(tile, num_docs - base);
    unsigned* keys = reinterpret_cast<unsigned*>(acc);
    for (int i = threadIdx.x; i < q * zero_words<kOwn>(tile); i += kThreads)
      zeros[i] = kOwn ? 0 : -1;
    bool nan = false, zero = false;
    if constexpr (kQ > 0) {
      const int loc = threadIdx.x;
      const float nm = loc < width ? acc[loc] : 0.0f;
      const float rk = loc < width ? acc[tile + loc] : 0.0f;
      __syncthreads();
      if (loc < tile) {
#pragma unroll
        for (int qi = 0; qi < kQ; ++qi) {
          const float f = final_score(sum[qi], nm, rk, qi);
          nan |= isnan(f);
          if (f == 0.0f) {
            zero = true;
            note_zero<kOwn>(zeros, qi, loc, tile, f);
          }
          keys[qi * tile + loc] = select_key(f);
        }
      }
    } else {
      __syncthreads();
      for (int loc = threadIdx.x; loc < tile; loc += kThreads) {
        const float nm = loc < width ? norm[base + loc] : 0.0f;
        const float rk = loc < width ? rank[base + loc] : 0.0f;
        for (int qi = 0; qi < q; ++qi) {
          const float f = final_score(acc[qi * tile + loc], nm, rk, qi);
          nan |= isnan(f);
          if (f == 0.0f) {
            zero = true;
            note_zero<kOwn>(zeros, qi, loc, tile, f);
          }
          keys[qi * tile + loc] = select_key(f);
        }
      }
    }
    return (__syncthreads_or(nan || zero) ? 1 : 0) | (nan ? 2 : 0);
  }

  // Each row's k_tile best, one warp per row, over the tile's `width`
  // docs (every lane past num_docs is -inf: any of them, or none, gives
  // the (-inf, -1) that fills a row with fewer finite keys).  `rare`: the
  // CTA voted a zero or a NaN: a TopkOut row holding a NaN writes (NaN,
  // -1) throughout, and slots that selected a zero are given its value
  // by the rule (fix_zeros).
  template <bool kOwn>
  __device__ __forceinline__ void select_rows(unsigned* keys, int t,
                                              int num_docs, int q, int tile,
                                              bool rare,
                                              const int* zeros) const {
    const int base = t * tile;
    const int width = min(tile, num_docs - base);
    const int wl = threadIdx.x % 32;
    const int per = (width + 31) / 32;
    const int lo = min(wl * per, width), hi = min(lo + per, width);
    const bool wide = ((tile | width | per) & 3) == 0;
    const bool few = k_tile <= 32 && per <= 16 && tile >= 128;
    const size_t row_out = (size_t)n_tiles * k_tile;
    for (int qi = threadIdx.x / 32; qi < q; qi += kWarps) {
      unsigned* row = keys + qi * tile;
      const size_t o = qi * row_out + (size_t)t * k_tile;
      if (!kOwn && rare && fill_nan(row, lo, hi, vals + o, ids + o))
        continue;
      if (!(few && select_few(row, lo, hi, wide, base, tile, vals + o,
                              ids + o)))
        maxima(row, lo, hi, wide, base, vals + o, ids + o);
      if (rare) fix_zeros<kOwn>(zeros, qi, base, tile, vals + o, ids + o);
    }
  }

  // k_tile successive maxima (0 once the row's keys are spent): each step
  // one __reduce_max_sync finds the row's largest key, the lowest lane
  // holding it (a ballot) emits it and rescans its positions.
  __device__ __forceinline__ void maxima(unsigned* row, int lo, int hi,
                                         bool wide, int base, float* ov,
                                         int* oi) const {
    const int wl = threadIdx.x % 32;
    int at = lo;
    unsigned best = lane_best(row, lo, hi, wide, at);
    for (int j = 0; j < k_tile; ++j) {
      const unsigned m = __reduce_max_sync(0xffffffffu, best);
      const unsigned holders = __ballot_sync(0xffffffffu, best == m);
      if (wl == __ffs(holders) - 1) {
        const float v = m ? key_value(m) : -CUDART_INF_F;
        ov[j] = v;
        oi[j] = isfinite(v) ? base + at : -1;
        if (m) {
          row[at] = 0u;
          best = lane_best(row, lo, hi, wide, at);
        }
      }
    }
  }

  // The row's slots that selected a zero (written +0.0, its shared key's
  // value) get the value of the rule.
  template <bool kOwn>
  __device__ __forceinline__ void fix_zeros(const int* zeros, int qi,
                                            int base, int tile, float* ov,
                                            const int* oi) const {
    __syncwarp();                      // every lane's slots are written
    for (int j = threadIdx.x % 32; j < k_tile; j += 32)
      if (ov[j] == 0.0f) ov[j] = zero_value<kOwn>(zeros, qi, oi[j] - base,
                                                  tile);
  }

  // If the row holds a NaN's key, writes (NaN, -1) through its k_tile
  // slots, the NaN the first of them, and returns true.  Scalar loads:
  // it runs only in a CTA that voted.
  __device__ __forceinline__ bool fill_nan(const unsigned* row, int lo,
                                           int hi, float* ov,
                                           int* oi) const {
    unsigned first = 0u;
    int p = lo;
    for (; p < hi; ++p) {
      first = row[p];
      if (first < kNegInfKey || first > kPosInfKey) break;
    }
    const unsigned holders = __ballot_sync(0xffffffffu, p < hi);
    if (!holders) return false;
    const float v =
        key_value(__shfl_sync(0xffffffffu, first, __ffs(holders) - 1));
    for (int j = threadIdx.x % 32; j < k_tile; j += 32) {
      ov[j] = v;
      oi[j] = -1;
    }
    return true;
  }

  // A row's k_tile best when k_tile <= 32 and a lane holds <= 16 keys.
  // T, the k_tile-th largest of the lanes' largest finite keys, is at
  // most the row's k_tile-th largest key, so the row's best are among
  // its finite keys >= T (every finite key when fewer than k_tile lanes
  // hold one).  When more than 64 pass (the row's finite keys in few
  // lanes: deleted or padding docs, clipped tiles), T is taken again
  // from the lanes' two largest.  When at most 64 pass, each lane writes
  // its own (a prefix sum of the lanes' counts places them) into the
  // row's first 128 words, one warp-wide bitonic sort of 32 (or 64)
  // orders them, and the k_tile first are the row's best, (-inf, -1)
  // past the last.  Returns false and writes nothing when more than 64
  // keys still pass (ties): the caller then takes successive maxima.
  __device__ __forceinline__ bool select_few(unsigned* row, int lo, int hi,
                                             bool wide, int base, int tile,
                                             float* ov, int* oi) const {
    const unsigned neg_inf = order_key(-CUDART_INF_F);
    const int wl = threadIdx.x % 32;
    unsigned k[16];
    load16(row, lo, hi, wide, k);
    unsigned key[2] = {0u, 0u};        // the lane's two largest finite keys
    int pos[2] = {0, 0};
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const unsigned x = k[u] > neg_inf ? k[u] : 0u;
      if (x > key[0]) {
        key[1] = key[0];
        key[0] = x;
      } else if (x > key[1]) {
        key[1] = x;
      }
    }
    unsigned thr = key[0];
    warp_sort<1, false>(&thr, pos);
    thr = __shfl_sync(0xffffffffu, thr, k_tile - 1);
    int n = count_from(k, thr, neg_inf);
    int total = __reduce_add_sync(0xffffffffu, n);
    if (total > 64) {                  // T from the lanes' two largest
      warp_sort<2, false>(key, pos);
      thr = __shfl_sync(0xffffffffu, key[0], k_tile - 1);
      n = count_from(k, thr, neg_inf);
      total = __reduce_add_sync(0xffffffffu, n);
      if (total > 64) return false;
    }
    int w = n;                         // inclusive prefix sum, then less n
    for (int d = 1; d < 32; d *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (wl >= d) w += y;
    }
    w -= n;
    __syncwarp();                      // every lane has read its keys
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (k[u] > neg_inf && k[u] >= thr) {
        row[2 * w] = k[u];
        row[2 * w + 1] = lo + u;
        ++w;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = 32 * r + wl;
      key[r] = e < total ? row[2 * e] : 0u;
      pos[r] = e < total ? (int)row[2 * e + 1] : tile + e;
    }
    if (total <= 32)
      warp_sort<1, true>(key, pos);
    else
      warp_sort<2, true>(key, pos);
    if (wl < k_tile) {
      const float v = wl < total ? key_value(key[0]) : -CUDART_INF_F;
      ov[wl] = v;
      oi[wl] = isfinite(v) ? base + pos[0] : -1;
    }
    return true;
  }

  // How many of the 16 keys k are finite and >= thr.
  static __device__ __forceinline__ int count_from(const unsigned* k,
                                                   unsigned thr,
                                                   unsigned neg_inf) {
    int n = 0;
#pragma unroll
    for (int u = 0; u < 16; ++u) n += k[u] > neg_inf && k[u] >= thr;
    return n;
  }

  // Orders the warp's 32 * R keys, element e = 32 * r + lane in key[r],
  // so that element e is the e-th: key descending, and with kPos, pos[r]
  // ascending on equal keys (the pairs must differ); without kPos, pos
  // is neither read nor moved.  A bitonic sort: shuffles across lanes, a
  // compare within a lane for the stride of 32.
  template <int R, bool kPos>
  static __device__ __forceinline__ void warp_sort(unsigned* key, int* pos) {
    const int wl = threadIdx.x % 32;
#pragma unroll
    for (int size = 2; size <= 32 * R; size *= 2) {
#pragma unroll
      for (int stride = size / 2; stride > 0; stride /= 2) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          // the pair's lower element keeps the first of the two where
          // this block of `size` elements runs forward, the later where
          // it runs backward
          const bool forward = ((32 * r + wl) & size) == 0;
          if (stride >= 32) {          // elements r and r + 1 of a lane
            if (r % 2 == 0 && r + 1 < R) {
              const bool later_first =
                  key[r + 1] > key[r] ||
                  (kPos && key[r + 1] == key[r] && pos[r + 1] < pos[r]);
              if (later_first == forward) {
                const unsigned tk = key[r];
                key[r] = key[r + 1];
                key[r + 1] = tk;
                if (kPos) {
                  const int tp = pos[r];
                  pos[r] = pos[r + 1];
                  pos[r + 1] = tp;
                }
              }
            }
          } else {
            const unsigned ok = __shfl_xor_sync(0xffffffffu, key[r], stride);
            const int op =
                kPos ? __shfl_xor_sync(0xffffffffu, pos[r], stride) : 0;
            const bool other_first =
                ok > key[r] || (kPos && ok == key[r] && op < pos[r]);
            const bool lower = (wl & stride) == 0;
            if (other_first == (lower == forward)) {
              key[r] = ok;
              if (kPos) pos[r] = op;
            }
          }
        }
      }
    }
  }

  // The 16 keys of row[p0, p0 + 16) below hi into k (0 past hi): four
  // 16-byte loads where `wide` (p0, hi and the rows' stride multiples of
  // 4), else 16 scalar ones; all issued before any is used.
  static __device__ __forceinline__ void load16(const unsigned* row, int p0,
                                                int hi, bool wide,
                                                unsigned* k) {
    if (wide) {
      const uint4* r = reinterpret_cast<const uint4*>(row + p0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint4 x = p0 + 4 * u < hi ? r[u] : make_uint4(0, 0, 0, 0);
        k[4 * u] = x.x;
        k[4 * u + 1] = x.y;
        k[4 * u + 2] = x.z;
        k[4 * u + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 16; ++u) k[u] = p0 + u < hi ? row[p0 + u] : 0u;
    }
  }

  // The largest key of row[lo, hi) (0 if none) and, in `at`, its
  // position, the lowest on ties: 16 keys a step (load16), then a tree of
  // compares, so a step waits on one load's latency, not on 16.
  static __device__ __forceinline__ unsigned lane_best(const unsigned* row,
                                                       int lo, int hi,
                                                       bool wide, int& at) {
    unsigned best = 0u;
    for (int p0 = lo; p0 < hi; p0 += 16) {
      unsigned k[16];
      load16(row, p0, hi, wide, k);
      // pairwise: the later of two positions wins only on a larger key
      int idx[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) idx[u] = u;
#pragma unroll
      for (int w = 1; w < 16; w *= 2) {
#pragma unroll
        for (int u = 0; u < 16; u += 2 * w) {
          if (k[u + w] > k[u]) {
            k[u] = k[u + w];
            idx[u] = idx[u + w];
          }
        }
      }
      if (k[0] > best) {
        best = k[0];
        at = p0 + idx[0];
      }
    }
    return best;
  }
};

// The bitonic candidate epilogue: TopkOut's scoring tail, then the
// reference's _tile_topk_bitonic over each query row of the tile, into
// the same tile-major vals / ids.  A CTA whose final scores hold no NaN,
// at k_tile <= kBitonicSelectUpTo, takes TopkOut's selection, each slot
// writing its lane's own bits: the network's first k_tile columns.  A
// CTA holding a NaN, whose network output depends on positions, or
// above that k_tile, sorts its rows with the network.  `scratch` is the
// plan's u16 [q, tile] lane array; before the network it holds the
// -0.0 bits of the rows' zeros.
struct BitonicOut : TopkOut {
  static constexpr bool kLaneArray = true;

  explicit BitonicOut(const TopkOut& t) : TopkOut(t) {}

  template <int kQ>
  __device__ __forceinline__ void finish(float* acc, const float* sum, int t,
                                         int num_docs, int q, int tile,
                                         unsigned char* scratch,
                                         unsigned char*) const {
    int* zeros = reinterpret_cast<int*>(scratch);
    unsigned* keys = reinterpret_cast<unsigned*>(acc);
    const int vote = write_keys<kQ, true>(acc, sum, t, num_docs, q, tile,
                                          zeros);
    // a NaN anywhere: a second vote, only where the first found one
    const bool nan = (vote & 1) && __syncthreads_or(vote & 2);
    if (!nan && k_tile <= kBitonicSelectUpTo) {
      select_rows<true>(keys, t, num_docs, q, tile, vote & 1, zeros);
      return;
    }
    // the network: the keys back to their f32 scores in place, each zero
    // with its sign (lanes past num_docs are -inf), then their lanes
    const int base = t * tile;
    unsigned short* lanes = reinterpret_cast<unsigned short*>(scratch);
    const int n = q * tile;
    for (int f = threadIdx.x; f < n; f += kThreads) {
      const unsigned k = keys[f];
      acc[f] = k == kZeroKey ? zero_value<true>(zeros, f / tile, f % tile,
                                                tile)
                             : key_value(k);
    }
    __syncthreads();                   // every zero's bit is read
    for (int f = threadIdx.x; f < n; f += kThreads)
      lanes[f] = (unsigned short)(f & (tile - 1));
    __syncthreads();
    sort_rows(acc, lanes, n, tile);
    // each row's first k_tile, tile-major; id -1 where not finite
    const size_t row_out = (size_t)n_tiles * k_tile;
    for (int i = threadIdx.x; i < q * k_tile; i += kThreads) {
      const int qi = i / k_tile, j = i - qi * k_tile;
      const float v = acc[qi * tile + j];
      const size_t o = qi * row_out + (size_t)t * k_tile + j;
      vals[o] = v;
      ids[o] = isfinite(v) ? base + lanes[qi * tile + j] : -1;
    }
  }

  // Whether the element (v, l) at a position keeps itself rather than
  // take its partner's (pv, pl): the reference's rule, `first` being
  // "(v, l) comes first in (value descending, lane ascending)".
  static __device__ __forceinline__ bool keeps(float v, int l, float pv,
                                               int pl, bool lo, bool desc) {
    const bool first = v > pv || (v == pv && l < pl);
    return lo == desc ? first : !first;
  }

  // Every row's stages of block sizes size_lo..size_hi whose strides are
  // below 32, one element per lane: warp w takes the 32-element chunks
  // w, w + kWarps, ... of the [q, tile] rows (a row's positions are
  // f & (tile - 1), tile a power of two, so a partner stays in its row).
  static __device__ __forceinline__ void warp_pass(float* v,
                                                   unsigned short* l, int n,
                                                   int tile, int size_lo,
                                                   int size_hi) {
    const int wl = threadIdx.x % 32;
    for (int c = threadIdx.x / 32; c * 32 < n; c += kWarps) {
      const int f = c * 32 + wl;
      const bool in = f < n;
      float x = in ? v[f] : 0.0f;
      int y = in ? l[f] : 0;
      const int i = f & (tile - 1);
      for (int size = size_lo; size <= size_hi; size *= 2) {
        const bool desc = (i & size) == 0;
        for (int s = min(size / 2, 16); s >= 1; s /= 2) {
          const float px = __shfl_xor_sync(0xffffffffu, x, s);
          const int py = __shfl_xor_sync(0xffffffffu, y, s);
          if (!keeps(x, y, px, py, (i & s) == 0, desc)) {
            x = px;
            y = py;
          }
        }
      }
      if (in) {
        v[f] = x;
        l[f] = (unsigned short)y;
      }
    }
  }

  // One stage of stride >= 32 of block size `size` over every row in
  // shared memory: thread p takes the pairs p, p + kThreads, ... (a pair's
  // two positions read before either is written).
  static __device__ __forceinline__ void smem_stage(float* v,
                                                    unsigned short* l, int n,
                                                    int tile, int size,
                                                    int stride) {
    const int sh = __ffs(stride) - 1;
    for (int p = threadIdx.x; p < n / 2; p += kThreads) {
      const int f = ((p >> sh) << (sh + 1)) | (p & (stride - 1));
      const int g = f + stride;
      const bool desc = ((f & (tile - 1)) & size) == 0;
      const float va = v[f], vb = v[g];
      const int la = l[f], lb = l[g];
      const bool ka = keeps(va, la, vb, lb, true, desc);
      const bool kb = keeps(vb, lb, va, la, false, desc);
      v[f] = ka ? va : vb;
      l[f] = (unsigned short)(ka ? la : lb);
      v[g] = kb ? vb : va;
      l[g] = (unsigned short)(kb ? lb : la);
    }
  }

  // The whole network over the n = q * tile elements: block sizes up to 32
  // in one register pass; then for each larger size its strides >= 32 in
  // shared memory and its strides 16..1 in one register pass.
  static __device__ __forceinline__ void sort_rows(float* v,
                                                   unsigned short* l, int n,
                                                   int tile) {
    warp_pass(v, l, n, tile, 2, min(tile, 32));
    __syncthreads();
    for (int size = 64; size <= tile; size *= 2) {
      for (int stride = size / 2; stride >= 32; stride /= 2) {
        smem_stage(v, l, n, tile, size, stride);
        __syncthreads();
      }
      warp_pass(v, l, n, tile, size, size);
      __syncthreads();
    }
  }
};

// kQ > 0: compiled for q == kQ; kQ == 0: any q.
template <class Epi, class Blocks, int kQ>
__global__ void __launch_bounds__(kThreads, 3)
score_kernel(Blocks bl, Pairs pr, Epi epi, int num_docs, int q, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int run[2];
  const Plan<Blocks> plan(bl, q, tile, Epi::kLaneArray);
  const int t = blockIdx.x;
  const int2 bounds = run_walk::find_run(pr.tile, pr.n, t, run);
  if (bounds.x == bounds.y) {        // no pair visits this tile
    epi.empty(t, num_docs, q, tile);
    return;
  }
  const int tile_base = t * tile;
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

  // prologue: chunk 0's metadata (and what the epilogue stages), then its
  // blocks and chunk 1's metadata
  issue_meta<Blocks>(pr, meta_of(0), p0, len_of(0), q);
  epi.template stage<kQ>(smem, tile_base, tile,
                         min(tile, num_docs - tile_base));
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
  // the epilogue's lane array, and the metadata buffer of the chunk past
  // the last, which no copy fills and no add reads
  epi.template finish<kQ>(acc, sum, t, num_docs, q, tile,
                          smem + plan.lane_off(), meta_of(n_chunks));
}

// Allow score_kernel<Epi, Blocks, kQ> `smem` bytes of dynamic shared
// memory: the opt-in above 48 KB, asked once per device and size.
template <class Epi, class Blocks, int kQ>
cudaError_t allow_smem(size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static size_t allowed[16] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || smem <= 48 * 1024 ||
      (dev < 16 && smem <= allowed[dev]))
    return e;
  e = cudaFuncSetAttribute(score_kernel<Epi, Blocks, kQ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < 16) allowed[dev] = smem;
  return e;
}

template <class Epi, class Blocks, int kQ>
int launch_q(const Blocks& bl, const Pairs& pr, const Epi& epi, int n_tiles,
             int num_docs, int q, int tile, void* stream) {
  const size_t smem = Plan<Blocks>(bl, q, tile, Epi::kLaneArray).total();
  const cudaError_t e = allow_smem<Epi, Blocks, kQ>(smem);
  if (e != cudaSuccess) return (int)e;
  score_kernel<Epi, Blocks, kQ>
      <<<n_tiles, kThreads, smem, (cudaStream_t)stream>>>(bl, pr, epi,
                                                          num_docs, q, tile);
  return (int)cudaGetLastError();
}

// The engines pad Q to a multiple of 8: 8 and 16 (batches of up to 16
// queries) at tiles of up to 512 docs run the kernel compiled for their Q,
// anything else the generic one.
template <class Epi, class Blocks>
int launch(const Blocks& bl, const Pairs& pr, const Epi& epi, int n_tiles,
           int num_docs, int q, int tile, void* stream) {
  if (tile <= kThreads && q == 8)
    return launch_q<Epi, Blocks, 8>(bl, pr, epi, n_tiles, num_docs, q, tile,
                                    stream);
  if (tile <= kThreads && q == 16)
    return launch_q<Epi, Blocks, 16>(bl, pr, epi, n_tiles, num_docs, q, tile,
                                     stream);
  return launch_q<Epi, Blocks, 0>(bl, pr, epi, n_tiles, num_docs, q, tile,
                                  stream);
}

template <class Epi, class Blocks, int kQ>
int occupancy_q(const Blocks& bl, int q, int tile, int* smem) {
  const size_t bytes = Plan<Blocks>(bl, q, tile, Epi::kLaneArray).total();
  *smem = (int)bytes;
  cudaError_t e = allow_smem<Epi, Blocks, kQ>(bytes);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, score_kernel<Epi, Blocks, kQ>, kThreads, bytes);
  return e == cudaSuccess ? ctas : -(int)e;
}

// CTAs of the kernel `launch` picks for (q, tile) that fit on one SM, and
// the dynamic shared memory each takes (*smem); a negative cudaError_t if
// the runtime refuses.
template <class Epi, class Blocks>
int occupancy(const Blocks& bl, int q, int tile, int* smem) {
  if (tile <= kThreads && q == 8)
    return occupancy_q<Epi, Blocks, 8>(bl, q, tile, smem);
  if (tile <= kThreads && q == 16)
    return occupancy_q<Epi, Blocks, 16>(bl, q, tile, smem);
  return occupancy_q<Epi, Blocks, 0>(bl, q, tile, smem);
}

}  // namespace fused_score
