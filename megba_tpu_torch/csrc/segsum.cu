// Kernel 4 of the port, the plain segment sum (seg_reduce), hand-written
// for Hopper (sm_90a).  Built by megba_tpu_torch/ops/kernels.py with nvcc
// into a shared library of its own with a plain C interface (beside
// csrc/segtiles.cu's kernels 1-3 and 5, so that the two build in
// parallel), loaded with ctypes; the Python wrapper is `seg_reduce` in
// megba_tpu_torch/ops/segtiles.py.
//
// It replaces the Pallas kernel `_reduce_kernel` of the JAX package
// (megba_tpu/ops/segtiles.py, body :238, pallas_call :279): out[:, s] is
// the sum of data[:, slot] over the slots of segment s, data [F, n] in
// plan slot order (F = 1..16, the MEGBA_WIDTH lines of
// csrc/fused_shapes.cuh, f32 and f64), an empty segment summing to
// exactly 0.  It is the segment sum around the per-edge W contraction of
// the unfused explicit-Schur S.p product, and the sums of SCHUR_DIAG's
// corrections and of the coarse builds.  Bound by HBM bytes: it reads
// each slot's F values once and adds them, no multiply.
//
// The launch checks the tables it is given and returns
// cudaErrorInvalidValue without launching if one is missing; an error
// left by an earlier launch is returned negated, as in segtiles.cu.

#include <cuda_pipeline.h>

#include "segreduce.cuh"

namespace {

// Per-edge rows of the data itself (F values): the plain segment sum.
// The split shape loads one slot's F values a step.
template <typename T, int F_>
struct SumRows {
  static constexpr int F = F_;
  static constexpr int kSlots = 1;
  struct Slot {
    T v[F_];
  };
  static constexpr int kUnroll =
      split_unroll(F * sizeof(T), sizeof(Slot), kSlots);
  const T* __restrict__ data;  // [F, n]
  int64_t n;

  __device__ __forceinline__ void add(int64_t e, T* acc) const {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += data[f * n + e];
  }

  template <bool kAligned>
  __device__ __forceinline__ void load(int64_t e, Slot& v) const {
#pragma unroll
    for (int f = 0; f < F; ++f) v.v[f] = data[f * n + e];
  }

  __device__ __forceinline__ void accumulate(const Slot& v, T* acc) const {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += v.v[f];
  }
};

// ---------------------------------------------------------------------------
// Kernel 4 (seg_reduce): no thread and no block walks an unbounded run of
// slots.  The wrapper picks one of three shapes per side from its plan
// (`SegShape`; ops/segtiles.py `seg_reduce_shape_of`).
//
// A side of long segments (SegPlan.per_thread false: cameras) runs the
// split shape (segreduce.cuh, reduce_split_segments) over the plan's
// chunk table: a segment of up to SPLIT_ABOVE = 4096 slots is one chunk,
// summed by one block as reduce_block_per_segment sums it (bitwise), a
// longer one is cut into chunks of ~2048 slots added in chunk order.
//
// A side of short segments all under kBlock slots (SegPlan.all_short:
// venice's points, the pose prior's poses) runs reduce_thread_per_segment:
// a thread adds its segment's at most 255 slots from 0 in ascending order.
//
// Any other side of short segments (the fleet union's cameras and
// points, whose lanes' padding sits on their last camera and point; Zipf
// tracks) runs seg_reduce_tiles.  Its blocks [0, tile_blocks) each walk
// kSegWindows consecutive slot tiles of the plan's tile table (tile w
// owns the segments that start in slots [256 w, 256 w + 256)); blocks
// tile_blocks onwards are the split chunks of the side's segments over
// SPLIT_ABOVE slots (its table lists only those).  A block takes its
// tiles kStepTiles at a time: it stages each tile that owns a segment,
// and each that follows one (the rest of a short segment may lie there),
// [F][256] in shared memory, a warp loading 32 neighbouring slots of a
// row, with the offsets of the step's segments; then the thread that
// owns a segment adds its staged values from 0 in ascending order.  The
// last segment of a step may run on past it (it is shorter than kBlock):
// its partial sums go through shared memory to thread 0, which adds the
// rest in the same order in the next step (the step after the block's
// last tile, for its last segment).  A tile's last segment of kBlock
// slots or more is summed by the whole block (block_segment_sum),
// unless it is split, when the chunks' blocks sum it.  So a thread adds
// at most 255 staged slots or 16 strided ones a segment, and a block
// reads at most its tiles, one more for a carried rest, and the
// segments of kBlock to SPLIT_ABOVE slots that start in its tiles.
//
// Why steps of several tiles: on venice's points (~5 slots a segment) a
// 256-slot tile holds ~51 segments, so a block that staged and summed
// one tile at a time kept 51 of its 256 threads busy between two
// barriers, and ran at a third of the byte bound whether at f32 or f64;
// a step of 8 tiles gives each thread a segment or two.  kStepTiles is
// as many tiles as kStepBytes of shared memory holds for F values and an
// offset a slot (8 at F <= 3 in f32, 1 at F >= 10 in f64).  Even so a
// step's barriers cost more than a thread per segment where every
// segment is short, hence the third shape.
//
// A segment's summation order depends on its length alone (and the
// side's shape, which the side's mean length sets): under kBlock slots
// on a short side, from 0 in ascending slot order, in the thread and the
// tile shape alike; kBlock to SPLIT_ABOVE slots, and any segment of a
// long side up to SPLIT_ABOVE, block_segment_sum's order; longer, the
// split chunks.  Not its offset, its neighbours, the tile, step or block
// that owns it, the lane count or the shard.
//
// The staging goes through cp.async (one 4- or 8-byte copy a value and
// offset: a tile of a row has any alignment), so all of a step's loads
// are in flight at once with no register to hold them: through
// registers the short sides ran longer by device time on the H100, and 4
// or 16 tiles a block or 20 KB steps were no faster (PERF.md section 6).
// ---------------------------------------------------------------------------

// Tiles a block of seg_reduce_tiles walks (ops/segtiles.py SEG_WINDOWS).
constexpr int kSegWindows = 8;
// Shared memory a step's staged values and offsets may take.
constexpr int kStepBytes = 40960;

// Kernel 4's launch shapes (ops/segtiles.py SEG_SHAPES, in this order).
enum SegShape : int {
  kSplitChunks = 0,
  kSlotTiles = 1,
  kThreadPerSegment = 2,
};

// Tiles a step stages: as many as kStepBytes holds, 1 to kSegWindows.
template <typename T, int F>
__host__ __device__ constexpr int step_tiles() {
  const int s = kStepBytes / ((F * static_cast<int>(sizeof(T)) + 8) * kBlock);
  return s < 1 ? 1 : (s > kSegWindows ? kSegWindows : s);
}

template <typename T, int F>
__global__ void __launch_bounds__(kBlock)
seg_reduce_tiles(SumRows<T, F> rows, const int64_t* __restrict__ seg_ptr,
                 const int64_t* __restrict__ tile_ptr, int64_t num_tiles,
                 int64_t tile_blocks, SplitTable tab,
                 T* __restrict__ partials, T* __restrict__ out,
                 int64_t num_segments) {
  constexpr int S = step_tiles<T, F>();
  constexpr int SK = S * kBlock;  // slots a step may stage
  __shared__ T term[F][SK];
  __shared__ int64_t sp[SK];  // seg_ptr[s_lo + i] of the step's segments
  __shared__ T partial[kWarps][F];
  __shared__ T carry[2][F];  // a step's last segment, by step parity
  __shared__ int64_t tp[kSegWindows + 1];
  __shared__ int64_t carry_seg;
  __shared__ int carry_step;
  __shared__ bool finisher;
  const int64_t b = blockIdx.x;
  if (b >= tile_blocks) {
    split_chunk_sum<T>(rows, tab, partials, out, num_segments,
                       b - tile_blocks, partial, finisher);
    return;
  }
  const T* __restrict__ data = rows.data;
  const int64_t n = rows.n;
  const int64_t w0 = b * kSegWindows;
  const int nw = static_cast<int>(
      num_tiles - w0 < kSegWindows ? num_tiles - w0 : kSegWindows);
  if (threadIdx.x <= nw) tp[threadIdx.x] = tile_ptr[w0 + threadIdx.x];
  if (threadIdx.x == 0) carry_step = -1;
  __syncthreads();
  if (tp[0] == tp[nw]) return;  // no segment starts in these tiles
  auto owns = [&](int k) { return k >= 0 && k < nw && tp[k] < tp[k + 1]; };
  int64_t cs = -1;  // the segment carried into this step, if any
  for (int step = 0, j0 = 0; j0 < nw || cs >= 0; ++step, j0 += S) {
    // Tiles [ja, jb) of the block; past its last, a carried rest alone.
    const int ja = j0 < nw ? j0 : nw;
    const int jb = j0 + S < nw ? j0 + S : nw;
    const int64_t s_lo = tp[ja];
    const int64_t s_hi = tp[jb];
    if (s_lo == s_hi && cs < 0) continue;  // the same for all threads
    const int64_t lo = (w0 + ja) * kBlock;
    const int64_t end = (w0 + jb) * kBlock < n ? (w0 + jb) * kBlock : n;
    const int64_t hi = s_lo < s_hi ? end : seg_ptr[cs + 1];
    const int64_t cnt = s_hi - s_lo;
    // Stage tile ja + k if it owns a segment or follows one that does
    // (the block's first only if it owns: the block before stages the
    // rest of a segment it carries).
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int64_t e = lo + k * kBlock + threadIdx.x;
      if (e < hi && (owns(ja + k) || (ja + k > 0 && owns(ja + k - 1)))) {
#pragma unroll
        for (int f = 0; f < F; ++f) {
          __pipeline_memcpy_async(&term[f][k * kBlock + threadIdx.x],
                                  data + f * n + e, sizeof(T));
        }
      }
    }
    for (int64_t i = threadIdx.x; i <= cnt && i < SK; i += kBlock) {
      __pipeline_memcpy_async(&sp[i], seg_ptr + s_lo + i,
                              sizeof(int64_t));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    // Offset i of the step's segments (i <= cnt): staged for the first
    // SK, read from seg_ptr past them (a step of more than SK segments,
    // most of them empty).
    auto bound = [&](int64_t i) {
      return i < SK ? sp[i] : seg_ptr[s_lo + i];
    };
    // The values of slots [a, z) of the step, in ascending order.
    auto add = [&](int64_t a, int64_t z, T* acc) {
      for (int64_t e = a - lo; e < z - lo; ++e) {
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += term[f][e];
      }
    };
    const int par = step & 1;
    if (cs >= 0 && threadIdx.x == 0) {  // the carried segment's rest
      T acc[F];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = carry[par ^ 1][f];
      add(lo, cnt > 0 ? sp[0] : hi, acc);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        store_sum(rows, out, num_segments, cs, f, acc[f]);
      }
    }
    for (int64_t i = threadIdx.x; i < cnt; i += kBlock) {
      const int64_t a = bound(i);
      const int64_t z = bound(i + 1);
      if (z - a >= kBlock) continue;  // a tile's last one: the block's
      T acc[F];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = T(0);
      add(a, z < hi ? z : hi, acc);
      if (z > hi) {  // the step's last segment runs on into the next
#pragma unroll
        for (int f = 0; f < F; ++f) carry[par][f] = acc[f];
        carry_seg = s_lo + i;
        carry_step = step;
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) {
          store_sum(rows, out, num_segments, s_lo + i, f, acc[f]);
        }
      }
    }
    for (int k = ja; k < jb; ++k) {  // long last segments, whole
      if (!owns(k)) continue;
      const int64_t s = tp[k + 1] - 1;
      const int64_t a = bound(s - s_lo);
      const int64_t z = bound(s + 1 - s_lo);
      if (z - a >= kBlock && tab.seg_chunk[s + 1] == tab.seg_chunk[s]) {
        block_segment_sum<T>(rows, a, z, partial, out, num_segments, s);
        __syncthreads();  // its partials read before the next one's
      }
    }
    __syncthreads();  // this step's reads of term and sp, and its carry
    cs = carry_step == step ? carry_seg : -1;
  }
}

template <typename T, int F>
int launch_seg_reduce(SumRows<T, F> rows, const int64_t* seg_ptr,
                      const int64_t* tile_ptr, int64_t num_tiles,
                      const SplitTable& tab, void* partials, T* out,
                      int64_t num_segments, int shape, cudaStream_t stream) {
  if (num_segments == 0) return static_cast<int>(cudaSuccess);
  if (tab.chunk_ptr == nullptr ||
      (tab.num_chunks > 0 &&
       (tab.counters == nullptr || partials == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (shape) {
    case kSplitChunks:
      return launch_split_reduce<T>(rows, tab, static_cast<T*>(partials),
                                    out, num_segments, stream);
    case kThreadPerSegment:
      if (tab.num_chunks > 0) return static_cast<int>(cudaErrorInvalidValue);
      return launch_thread_reduce<T>(rows, seg_ptr, out, num_segments,
                                     stream);
    case kSlotTiles:
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile_ptr == nullptr || num_tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tile_blocks = (num_tiles + kSegWindows - 1) / kSegWindows;
  const int64_t grid = tile_blocks + tab.num_chunks;
  if (grid > kMaxGrid) return static_cast<int>(cudaErrorInvalidConfiguration);
  seg_reduce_tiles<T, F><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
      rows, seg_ptr, tile_ptr, num_tiles, tile_blocks, tab,
      static_cast<T*>(partials), out, num_segments);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int seg_reduce_typed(int F, const void* data, const int64_t* seg_ptr,
                     const int64_t* tile_ptr, int64_t num_tiles,
                     const SplitTable& tab, void* partials, void* out,
                     int64_t n, int64_t num_segments, int shape,
                     cudaStream_t stream) {
  const T* dt = static_cast<const T*>(data);
  T* o = static_cast<T*>(out);
#define MEGBA_COUPLING(CD, PD, OD)
#define MEGBA_WIDTH(W)                                                     \
  if (F == (W)) {                                                          \
    return launch_seg_reduce<T, (W)>(SumRows<T, (W)>{dt, n}, seg_ptr,      \
                                     tile_ptr, num_tiles, tab, partials,   \
                                     o, num_segments, shape, stream);      \
  }
#include "fused_shapes.cuh"
#undef MEGBA_WIDTH
#undef MEGBA_COUPLING
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out [F, nS] = per segment: the sum of its slots' F-value rows, in the
// launch shape `shape` (SegShape).  Every side takes the plan's split
// table (`split`, num_chunks chunks: every segment on a long side, those
// over SPLIT_ABOVE slots on a short one, none where all are short), its
// counters and a workspace of F values a chunk; the slot tiles also the
// tile table tiles[num_tiles + 1].
int megba_seg_reduce(int is_double, int F, const void* data,
                     const int64_t* seg_ptr, const int64_t* tiles,
                     int64_t num_tiles, const int64_t* split,
                     unsigned int* counters, int64_t num_chunks,
                     void* partials, void* out, int64_t n,
                     int64_t num_segments, int shape, void* stream) {
  if (const int prior = pending_error()) return prior;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SplitTable tab = split_table(split, counters, num_chunks, seg_ptr);
  return is_double
             ? seg_reduce_typed<double>(F, data, seg_ptr, tiles, num_tiles,
                                        tab, partials, out, n, num_segments,
                                        shape, st)
             : seg_reduce_typed<float>(F, data, seg_ptr, tiles, num_tiles,
                                       tab, partials, out, n, num_segments,
                                       shape, st);
}

const char* megba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
