// Segment-reduction machinery shared by the port's CUDA sources
// (segtiles.cu, segsum.cu, fused.cu).  Included into each source, so
// every shared library carries its own copy; ops/kernels.py hashes this
// header into each library's name, so editing it rebuilds them all.
//
// A "Rows" functor describes what one edge slot adds to its segment's
// F partial sums (`static constexpr int F` and
// `__device__ void add(int64_t slot, T* acc) const`; the slot-tile shape
// also needs `__device__ void term(int64_t slot, T* t) const`, the F
// values alone, which `add` adds).  The launch shapes below walk the CSR
// offsets seg_ptr[nS + 1] of a segment-sorted slot stream and write sum f
// of segment s through `store_sum`: to out[f * nS + s], unless the Rows
// type has an overload of its own (segtiles.cu's JtjRows keeps the upper
// triangle of a symmetric block and writes each sum to both halves):
//
//   - reduce_block_per_segment, for long segments (cameras: thousands
//     of slots each), the fused kernels: one 256-thread block per
//     segment;
//   - reduce_thread_per_segment, for short segments (points: ~5 slots
//     each), kernels 1 and 3 (segtiles.cu), and 4 (segsum.cu) where
//     every segment is under kBlock slots: one thread walks one segment;
//   - reduce_slot_tiles, for short segments, the fused kernels
//     (fused.cu): one block per tile of consecutive slots, lane i
//     computing slot i's terms, and one thread per segment summing them
//     from shared memory;
//   - reduce_split_segments, for long segments, kernels 1 and 3
//     (segtiles.cu) and 4 (segsum.cu): one block per chunk of at most
//     ~2048 slots of a segment, the chunks of one segment combined in
//     chunk order by the block that finishes last (its note below,
//     `split_chunk_sum`).
//
// Kernel 4 (segsum.cu, `seg_reduce_tiles`) walks a side of short
// segments in windows of kBlock slots, a few tiles a block, its grid
// also carrying the split chunks of that side's segments over
// SPLIT_ABOVE slots, so that no thread and no block of it owns an
// unbounded run of slots; where every segment is under kBlock slots it
// runs a thread per segment, which sums them in the same order.

// Why a third shape.  All three are bound by HBM bytes: a slot's terms
// read its rows once (F to 27 values) and do ~1 flop per byte.  With a
// thread per segment, the 32 lanes of a warp own 32 neighbouring
// segments, so one row load touches 32 addresses ~5 slots apart: ~640
// bytes of the row for 128 useful ones, which are useful only if they
// survive in L1 until the lane's next slot.  With 24-27 rows in flight a
// warp, they do not, and the sectors come again from HBM: the fused
// kernels' cam->pt direction ran at ~18 % of its byte bound that way.
// In a slot tile, a warp's row load is 32 consecutive slots (128 bytes at
// f32, 64 at bf16), each byte used once; the per-slot terms go through
// shared memory (term[F][kBlock]: 3 KB at F = 3, f32) to the thread that
// owns their segment.  The summation order of a segment shorter than
// kBlock is the thread-per-segment one: from 0, its slot terms in
// ascending order, so the two shapes give bitwise the same sums from the
// same terms; a segment of kBlock slots or more is summed in the
// block-per-segment order.
//
// Determinism: no atomics on values.  A segment's sum is formed by one
// thread, or by one block with a fixed strided split, a fixed
// warp-shuffle tree and a fixed sum over warps, or (split segments) by
// such blocks over fixed chunks whose sums one thread per value adds in
// chunk order, so for a given launch shape the output is
// bitwise-reproducible from run to run.  The split shape's one atomic
// counts finished chunks, to elect the block that adds them up; it
// orders no sum.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int64_t kMaxGrid = 2147483647;

// Where sum f of segment s goes: row f of out.  A Rows type may overload
// it (found by argument-dependent lookup where a launch shape is
// instantiated).
template <class Rows, typename T>
__device__ __forceinline__ void store_sum(const Rows&, T* __restrict__ out,
                                          int64_t num_segments, int64_t s,
                                          int f, T v) {
  out[f * num_segments + s] = v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Segment s = [lo, hi) summed by the whole block: threads stride over its
// slots, each keeping its F partial sums in registers; a warp-shuffle
// tree and a fixed-order sum over the warps' shared-memory partials
// finish it through store_sum.
template <typename T, class Rows>
__device__ __forceinline__ void block_segment_sum(
    const Rows& rows, int64_t lo, int64_t hi, T (*partial)[Rows::F],
    T* __restrict__ out, int64_t num_segments, int64_t s) {
  constexpr int F = Rows::F;
  T acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = T(0);
  for (int64_t e = lo + threadIdx.x; e < hi; e += kBlock) rows.add(e, acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const T v = warp_sum(acc[f]);
    if (lane == 0) partial[warp][f] = v;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += kBlock) {
    T v = partial[0][f];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += partial[w][f];
    store_sum(rows, out, num_segments, s, f, v);
  }
}

// One block per segment, for long segments (cameras: thousands of edges
// each).
template <typename T, class Rows>
__global__ void __launch_bounds__(kBlock)
reduce_block_per_segment(Rows rows, const int64_t* __restrict__ seg_ptr,
                         T* __restrict__ out, int64_t num_segments) {
  __shared__ T partial[kWarps][Rows::F];
  const int64_t s = blockIdx.x;
  block_segment_sum<T>(rows, seg_ptr[s], seg_ptr[s + 1], partial, out,
                       num_segments, s);
}

// One thread per segment, for short segments (points: a handful of edges
// each).  Neighbouring threads own neighbouring segments, whose edge
// ranges are adjacent in the sorted stream, and write neighbouring outputs.
template <typename T, class Rows>
__global__ void __launch_bounds__(kBlock)
reduce_thread_per_segment(Rows rows, const int64_t* __restrict__ seg_ptr,
                          T* __restrict__ out, int64_t num_segments) {
  constexpr int F = Rows::F;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (s >= num_segments) return;
  T acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = T(0);
  const int64_t hi = seg_ptr[s + 1];
  for (int64_t e = seg_ptr[s]; e < hi; ++e) rows.add(e, acc);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    store_sum(rows, out, num_segments, s, f, acc[f]);
  }
}

// One block per tile of consecutive slots, for short segments with
// per-slot terms worth coalescing (the fused kernels' cam->pt direction).
// The plan (ops/fused.slot_tiles) gives tile b the segments
// [tile_ptr[b], tile_ptr[b + 1]): those whose first slot lies in
// [b * K, (b + 1) * K) for a tile size K <= kBlock, empty segments by
// their offset, and the trailing empty ones (offset n) in the last tile.
// The block walks its segments' slots from base = seg_ptr[s_lo] in
// chunks of kBlock: lane i computes slot base + i's F terms into shared
// memory, and after a barrier the thread that owns segment s adds its
// slots' terms from 0 in ascending order, as reduce_thread_per_segment
// would.  Every owned segment starts in the first chunk (K <= kBlock)
// and all but the last end in it.  The last one may reach past it:
//   - by less than kBlock slots (it starts near the tile's end): its
//     owner adds the rest from one more chunk, in the same order;
//   - a segment of kBlock slots or more (a long track) is summed by the
//     whole block as reduce_block_per_segment sums it, so that no thread
//     walks thousands of slots alone.
// Either way a segment's summation order depends on the segment alone,
// not on the tile that owns it.
template <typename T, class Rows>
__device__ __forceinline__ void stage_terms(const Rows& rows, int64_t base,
                                            int64_t end,
                                            T (*term)[kBlock]) {
  constexpr int F = Rows::F;
  const int64_t e = base + threadIdx.x;
  if (e < end) {
    T t[F];
    rows.term(e, t);
#pragma unroll
    for (int f = 0; f < F; ++f) term[f][threadIdx.x] = t[f];
  }
}

template <typename T, int F>
__device__ __forceinline__ void add_staged(const T (*term)[kBlock],
                                           int64_t lo, int64_t hi, T* acc) {
  for (int64_t i = lo; i < hi; ++i) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += term[f][i];
  }
}

template <typename T, class Rows>
__global__ void __launch_bounds__(kBlock)
reduce_slot_tiles(Rows rows, const int64_t* __restrict__ seg_ptr,
                  const int64_t* __restrict__ tile_ptr, T* __restrict__ out,
                  int64_t num_segments) {
  constexpr int F = Rows::F;
  __shared__ T term[F][kBlock];
  __shared__ T partial[kWarps][F];
  const int64_t s_lo = tile_ptr[blockIdx.x];
  const int64_t s_hi = tile_ptr[blockIdx.x + 1];
  if (s_lo == s_hi) return;  // the whole block: no segment starts here
  const int64_t base = seg_ptr[s_lo];
  const int64_t last_lo = seg_ptr[s_hi - 1];
  const int64_t e_hi = seg_ptr[s_hi];
  const bool long_last = e_hi - last_lo >= kBlock;  // the same for all
  const int64_t chunk_end = base + kBlock < e_hi ? base + kBlock : e_hi;
  stage_terms<T>(rows, base, long_last ? last_lo : chunk_end, term);
  __syncthreads();
  const int64_t s_short = long_last ? s_hi - 1 : s_hi;
  T last[F];  // the last segment's sums, if it reaches past this chunk
  bool owns_last = false;
  for (int64_t s = s_lo + threadIdx.x; s < s_short; s += kBlock) {
    const int64_t end = seg_ptr[s + 1];
    T acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = T(0);
    add_staged<T, F>(term, seg_ptr[s] - base,
                     (end < chunk_end ? end : chunk_end) - base, acc);
    if (end > chunk_end) {
      owns_last = true;
#pragma unroll
      for (int f = 0; f < F; ++f) last[f] = acc[f];
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        store_sum(rows, out, num_segments, s, f, acc[f]);
      }
    }
  }
  if (long_last) {
    block_segment_sum<T>(rows, last_lo, e_hi, partial, out, num_segments,
                         s_hi - 1);
    return;
  }
  if (chunk_end < e_hi) {  // a short last segment's rest: one chunk
    __syncthreads();  // every owner has read the first chunk
    stage_terms<T>(rows, chunk_end, e_hi, term);
    __syncthreads();
    if (owns_last) {
      add_staged<T, F>(term, 0, e_hi - chunk_end, last);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        store_sum(rows, out, num_segments, s_hi - 1, f, last[f]);
      }
    }
  }
}

// A block per segment (the launch of long segments).
template <typename T, class Rows>
int launch_block_reduce(Rows rows, const int64_t* seg_ptr, T* out,
                        int64_t num_segments, cudaStream_t stream) {
  if (num_segments == 0) return static_cast<int>(cudaSuccess);
  if (num_segments > kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  reduce_block_per_segment<T, Rows>
      <<<static_cast<unsigned>(num_segments), kBlock, 0, stream>>>(
          rows, seg_ptr, out, num_segments);
  return static_cast<int>(cudaGetLastError());
}

// A thread per segment (the launch of short segments).
template <typename T, class Rows>
int launch_thread_reduce(Rows rows, const int64_t* seg_ptr, T* out,
                         int64_t num_segments, cudaStream_t stream) {
  if (num_segments == 0) return static_cast<int>(cudaSuccess);
  const int64_t grid = (num_segments + kBlock - 1) / kBlock;
  if (grid > kMaxGrid) return static_cast<int>(cudaErrorInvalidConfiguration);
  reduce_thread_per_segment<T, Rows>
      <<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
          rows, seg_ptr, out, num_segments);
  return static_cast<int>(cudaGetLastError());
}

// The fused kernels' launch: slot tiles (a plan's `num_tiles` tiles of
// at most kBlock slots) where the segments are short, else a block per
// segment (so the fused kernels never instantiate the thread per
// segment).
template <typename T, class Rows>
int launch_tiled_reduce(Rows rows, const int64_t* seg_ptr, T* out,
                        int64_t num_segments, int per_thread,
                        const int64_t* tile_ptr, int64_t num_tiles,
                        cudaStream_t stream) {
  if (!per_thread) {
    return launch_block_reduce<T>(rows, seg_ptr, out, num_segments, stream);
  }
  if (num_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (num_segments == 0) return static_cast<int>(cudaSuccess);
  if (num_tiles > kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  reduce_slot_tiles<T, Rows>
      <<<static_cast<unsigned>(num_tiles), kBlock, 0, stream>>>(
          rows, seg_ptr, tile_ptr, out, num_segments);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Split segments (kernels 1, 3 and 4 where segments are long; kernel 4
// also for the segments over SPLIT_ABOVE slots of a short-segment side).
//
// Why.  A block per segment gives a segment of L slots one block however
// long it is: the pose prior's point side (all 200,000 edges on one dummy
// point) ran on one of the card's 132 SMs.  Here the plan
// (ops/segtiles.split_table, built once with the plan from its host
// offsets) cuts a segment of L slots into m chunks of near-equal length
// (chunk k of a segment starting at lo is [lo + k L / m,
// lo + (k + 1) L / m)): m = 1 up to L = 4096 (a camera), else
// m = ceil(L / 2048); the grid has one block per chunk.  The boundaries
// relative to a segment's start depend on L alone, so a segment's
// summation order does not depend on where it sits in the stream, on the
// shard or on the other segments.  On a short-segment side (kernel 4)
// the table lists only the segments over 4096 slots: every other segment
// has no chunk (seg_chunk[s + 1] == seg_chunk[s]), and the slot tiles
// sum it.
//
// A block sums its chunk as block_segment_sum sums a segment (a strided
// loop, the warp-shuffle tree, a fixed sum over warps), with the loop
// unrolled so that a thread issues the loads of up to Rows::kUnroll load
// steps (at most four slots) before it adds them, in the same order.  A one-chunk segment
// (an empty one included: its chunk is empty and it stores zeros) stores
// its sums directly, bitwise what reduce_block_per_segment gives when
// Rows::kSlots is 1.  Otherwise the block writes its F sums to the
// launch's workspace partials[chunk][F], fences, and counts itself
// finished on the segment's counter; the block that finds the others
// done adds the segment's partials in chunk order (read past L1) and
// stores them through store_sum, then resets the counter to 0.
//
// The counters (one per segment) belong to the plan: zeroed once when it
// is built, left zero by every launch.  That relies on the launches that
// share a plan being ordered, which they are: the port issues every
// launch on the device's current stream (ops/kernels.current_stream).
//
// A Rows type taken by this shape also has
//   static constexpr int kSlots       slots a load step covers (1, or 2
//                                     for bf16 rows loaded in pairs);
//   struct Slot                       the values of one load step;
//   load<kAligned>(e, Slot&), accumulate(const Slot&, acc)
//                                     load step e..e + kSlots - 1 (in one
//                                     load a row where kAligned), and add
//                                     it as add() would, slot by slot;
//   aligned(lo)                       (kSlots 2) whether the steps of a
//                                     chunk starting at lo are aligned;
//   static constexpr int kUnroll      load steps a thread has in flight.
// A chunk's steps go to the threads in turn (step i to thread i mod
// kBlock); its last L mod kSlots slots, to the thread whose next step
// would have been the first missing one, through add().
// ---------------------------------------------------------------------------

// The split-segment table of one plan, in one int64 array:
// chunk_ptr[num_chunks + 1] (slot offsets: chunk c starts at
// chunk_ptr[c] and ends at chunk_ptr[c + 1], or, the last chunk of its
// segment, at the segment's end, which a short side's table, with no
// chunk for most segments, needs), chunk_seg[num_chunks] (the segment
// of each chunk), seg_chunk[nS + 1] (the first chunk of each segment);
// the plan's counters, and its CSR offsets seg_ptr[nS + 1].
struct SplitTable {
  const int64_t* __restrict__ chunk_ptr;
  const int64_t* __restrict__ chunk_seg;
  const int64_t* __restrict__ seg_chunk;
  unsigned int* __restrict__ counters;
  const int64_t* __restrict__ seg_ptr;
  int64_t num_chunks;
};

__host__ inline SplitTable split_table(const int64_t* table,
                                       unsigned int* counters,
                                       int64_t num_chunks,
                                       const int64_t* seg_ptr) {
  return SplitTable{table, table + num_chunks + 1,
                    table + 2 * num_chunks + 1, counters, seg_ptr,
                    num_chunks};
}

// How many load steps a thread issues before it adds them (its unroll
// depth, Rows::kUnroll): as many as fit beside its F sums in a budget of
// registers, at least one, and at most kSplitMaxSlots slots in flight (a
// deeper unroll costs registers at the wide shapes).
constexpr int kSplitMaxSlots = 4;
constexpr int kSplitRegisters = 96;

constexpr int split_unroll(size_t acc_bytes, size_t slot_bytes, int slots) {
  const int left = kSplitRegisters - static_cast<int>(acc_bytes / 4);
  const int u = left / static_cast<int>(slot_bytes < 4 ? 1 : slot_bytes / 4);
  const int most = kSplitMaxSlots / slots;
  return u < 1 ? 1 : (u > most ? (most < 1 ? 1 : most) : u);
}

// The slots [lo, hi) of one chunk added into this thread's acc, in load
// steps of Rows::kSlots slots, kUnroll steps loaded before they are added.
// kAligned: every step's pair of slots is 4-byte aligned in every row
// (Rows::aligned(lo), the same for the whole block), so that a pair is
// one load a row; otherwise a step loads its slots one by one, the same
// values summed in the same order.
template <typename T, class Rows, bool kAligned>
__device__ __forceinline__ void chunk_steps(const Rows& rows, int64_t lo,
                                            int64_t hi, T* acc) {
  constexpr int S = Rows::kSlots;
  constexpr int U = Rows::kUnroll;
  const int64_t steps = (hi - lo) / S;
  int64_t i = threadIdx.x;
  for (; i + (U - 1) * kBlock < steps; i += U * kBlock) {
    typename Rows::Slot v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      rows.template load<kAligned>(lo + (i + u * kBlock) * S, v[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) rows.accumulate(v[u], acc);
  }
  if (U > 1 && i < steps) {  // the last (fewer than U) steps, masked
    typename Rows::Slot v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u * kBlock < steps) {
        rows.template load<kAligned>(lo + (i + u * kBlock) * S, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u * kBlock < steps) rows.accumulate(v[u], acc);
    }
    i += ((steps - 1 - i) / kBlock + 1) * kBlock;
  }
  // i is now this thread's first step past the chunk's last full one.
  if (S > 1 && i == steps) {
    for (int64_t e = lo + steps * S; e < hi; ++e) rows.add(e, acc);
  }
}

template <typename T, class Rows>
__device__ __forceinline__ void chunk_slots(const Rows& rows, int64_t lo,
                                            int64_t hi, T* acc) {
  if constexpr (Rows::kSlots > 1) {
    if (rows.aligned(lo)) {
      chunk_steps<T, Rows, true>(rows, lo, hi, acc);
      return;
    }
  }
  chunk_steps<T, Rows, false>(rows, lo, hi, acc);
}

// Chunk c of a split table summed by the calling block (the whole block
// calls it; `partial` and `finisher` in its shared memory).
template <typename T, class Rows>
__device__ __forceinline__ void split_chunk_sum(
    const Rows& rows, const SplitTable& tab, T* __restrict__ partials,
    T* __restrict__ out, int64_t num_segments, int64_t c,
    T (*partial)[Rows::F], bool& finisher) {
  constexpr int F = Rows::F;
  const int64_t s = tab.chunk_seg[c];
  const int64_t c0 = tab.seg_chunk[s];
  const int64_t m = tab.seg_chunk[s + 1] - c0;
  T acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = T(0);
  const int64_t hi =
      c + 1 < c0 + m ? tab.chunk_ptr[c + 1] : tab.seg_ptr[s + 1];
  chunk_slots<T>(rows, tab.chunk_ptr[c], hi, acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const T v = warp_sum(acc[f]);
    if (lane == 0) partial[warp][f] = v;
  }
  __syncthreads();
  if (m == 1) {
    for (int f = threadIdx.x; f < F; f += kBlock) {
      T v = partial[0][f];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += partial[w][f];
      store_sum(rows, out, num_segments, s, f, v);
    }
    return;
  }
  for (int f = threadIdx.x; f < F; f += kBlock) {
    T v = partial[0][f];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += partial[w][f];
    partials[c * F + f] = v;
  }
  __threadfence();  // this chunk's sums before its count
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int done = atomicAdd(&tab.counters[s], 1u);
    finisher = done + 1 == static_cast<unsigned int>(m);
  }
  __syncthreads();
  if (!finisher) return;
  __threadfence();  // the other chunks' sums after their counts
  for (int f = threadIdx.x; f < F; f += kBlock) {
    T v = __ldcg(&partials[c0 * F + f]);
    for (int64_t k = 1; k < m; ++k) v += __ldcg(&partials[(c0 + k) * F + f]);
    store_sum(rows, out, num_segments, s, f, v);
  }
  if (threadIdx.x == 0) tab.counters[s] = 0u;
}

template <typename T, class Rows>
__global__ void __launch_bounds__(kBlock)
reduce_split_segments(Rows rows, SplitTable tab, T* __restrict__ partials,
                      T* __restrict__ out, int64_t num_segments) {
  __shared__ T partial[kWarps][Rows::F];
  __shared__ bool finisher;
  split_chunk_sum<T>(rows, tab, partials, out, num_segments, blockIdx.x,
                     partial, finisher);
}

// A block per chunk (the launch of long segments in kernels 1, 3 and 4).
// `partials` holds Rows::F values a chunk.
template <typename T, class Rows>
int launch_split_reduce(Rows rows, const SplitTable& tab, T* partials,
                        T* out, int64_t num_segments, cudaStream_t stream) {
  if (tab.num_chunks == 0) return static_cast<int>(cudaSuccess);
  if (tab.num_chunks > kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  reduce_split_segments<T, Rows>
      <<<static_cast<unsigned>(tab.num_chunks), kBlock, 0, stream>>>(
          rows, tab, partials, out, num_segments);
  return static_cast<int>(cudaGetLastError());
}

// Negated code of an error already pending before a launch, or 0.
int pending_error() {
  return -static_cast<int>(cudaPeekAtLastError());
}

}  // namespace
