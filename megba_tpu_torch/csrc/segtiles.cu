// Segment kernels of the Schur solve path, hand-written for Hopper (sm_90a).
// Built by megba_tpu_torch/ops/kernels.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes; the Python wrappers live in
// megba_tpu_torch/ops/segtiles.py.
//
// They replace four Pallas kernels of the JAX package
// (megba_tpu/ops/segtiles.py):
//
//   megba_jtj_grad_reduce  <- _jtj_kernel            (body :404, pallas_call :469)
//   megba_coupling_expand  <- _expand_matvec_kernel  (body :577, pallas_call :624)
//   megba_coupling_reduce  <- _matvec_reduce_kernel  (body :632, pallas_call :688)
//   megba_seg_expand       <- _expand_kernel         (body :305, pallas_call :336)
//
// and the fifth, megba_seg_reduce (<- _reduce_kernel, body :238,
// pallas_call :279), lives in csrc/segsum.cu, a library of its own built
// beside this one.
//
// The first three carry the implicit-Schur path (and the LM gain ratio);
// seg_expand and seg_reduce are the gather and the segment sum around the
// per-edge W contraction of the unfused explicit-Schur S.p product
// (megba_tpu/solver/pcg.py:336-349).
//
// What is ported is what the Pallas kernels compute, not how the TPU did it.
// The TPU kernels turned every scatter into a one-hot matmul over padded,
// block-aligned edge tiles.  Here the edge stream of one vertex kind is
// sorted by segment (camera or point) and described by CSR offsets
// seg_ptr[nS + 1]; a reduction walks each segment's contiguous edge range
// (segreduce.cuh).  jtj_grad_reduce and coupling_reduce run one thread
// per point, and split segments, one block per chunk of ~2048 slots, on
// long sides (cameras), whose plans carry the chunk table.
//
// Block shapes: kernels 1-3 are instantiated for every (od, d) of
// block_shapes.cuh, the one list of the shapes the registered factor
// families use (BAL's (2, 9) / (2, 3), planar's (1, 4) / (1, 2), the
// rig's (2, 7), pinhole_radial's (2, 12), the pose prior's (6, 6) /
// (6, 3), and (2, 6) for a Problem edge on a pose camera), in every
// precision arm.  A library built with -DMEGBA_ONE_BLOCK_OD / _D holds
// one other shape (ops/segtiles.py builds it at first use).  JtjRows keeps
// the upper triangle of J^T J only, which keeps its sums in registers up
// to d = 12 (its note below).
//
// Widths: kernel 5 (and kernel 4, in segsum.cu) is instantiated for
// every row count F of csrc/fused_shapes.cuh (MEGBA_WIDTH: 1 to 16), in
// f32 and f64.  The
// callers group rows by the families' block widths (the EXPLICIT
// products, SCHUR_DIAG and the precision rungs' equilibration at cd and
// pd) and nine to a launch (the coarse builds, whose last launch takes
// the remainder), so every width up to 12 occurs, and a Problem edge's
// block up to 16.
//
// Layout: feature-major, row f of a [F, n] array starts at f * n.
//
// Bound on the H100: every kernel reads its per-edge rows once and does at
// most a few multiply-adds per byte (seg_reduce and seg_expand none), far
// below the card's ~20 FLOP/byte float32 balance point, so all five are
// bound by HBM bytes.  The design keeps the byte count at the minimum: one
// pass over the per-edge rows, no per-edge intermediate (the outer-product
// or J^T u rows) ever written to device memory, and coalesced loads and
// stores (neighbouring threads touch neighbouring edges of a row).  The
// gathers read a vertex table that stays in the 50 MB L2 (cameras 64 KB,
// points 12 MB at venice, f32).
//
// Precision arms of the two coupling kernels (precision.cuh), after the
// JAX package's unfused lowering of each rung: f32 and f64; mixed (bf16 J
// rows beside an f32 table or u, upcast before each multiply, as the
// Pallas kernels' `.astype(jnp.float32)` at segtiles.py:599 and :646);
// mixed64 (the same beside an f64 table, sums in double: the XLA `up`
// lowering of mixed_precision_pcg at float64); bf16 (bf16 products with
// f32 sums, `_edge_precision`'s `vec` / `acc` casts).  In the bf16 arm
// coupling_expand rounds the gathered table values to bf16, sums the two
// residual rows' bf16 products in f32 and stores u rounded to bf16 in an
// f32 array (the output keeps the accumulator's dtype, so the cross
// permute between the kernels is unchanged); coupling_reduce rounds u on
// read, which leaves such a u as it is.  The bf16 rows halve the J bytes,
// the dominant term of both kernels' bound.
//
// Every entry point first peeks at the CUDA error state: an error left
// by an earlier launch (of any kernel) is returned negated, without
// launching, so the wrapper does not report it as its own.  Otherwise it
// returns cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for a block shape it was not built for; the
// Python wrapper raises on any non-zero code.

#include "precision.cuh"
#include "segreduce.cuh"

namespace {

// Index of entry (a, b), a <= b, of the upper triangle of a D x D block,
// row by row, and the triangle's size.
__host__ __device__ constexpr int tri_index(int a, int b, int D) {
  return a * (2 * D - a + 1) / 2 + (b - a);
}
__host__ __device__ constexpr int tri_size(int D) { return D * (D + 1) / 2; }

// Per-edge rows of J^T J and -J^T r: the fused Hessian-block + gradient
// build.  J^T J is symmetric, so only its upper triangle is summed
// (D(D+1)/2 sums, then the D of the gradient: F = 90 in place of 156 at
// D = 12), and `store_sum` below writes each triangle sum to row a*D+b
// and to its mirror b*D+a of the [D*D + D, nS] output.  The mirror is
// bitwise the sum the full form would give: its terms
// j[b]*j[a] + j[D+b]*j[D+a] + ... are products of the same factors (IEEE
// products and fused multiply-adds are commutative in their factors),
// added in the same order.  What the triangle saves is registers: each
// thread keeps F sums, and at D = 12 in f64 the full 156 would need 312
// 32-bit registers, past the 255 a thread may have.
template <typename T, int OD, int D>
struct JtjRows {
  static constexpr int F = tri_size(D) + D;
  static constexpr int kSlots = 1;
  struct Slot {
    T j[OD * D];
    T rr[OD];
  };
  // At D = 12 in f64 the 90 sums take ~180 registers: one slot in flight.
  static constexpr int kUnroll =
      split_unroll(F * sizeof(T), sizeof(Slot), kSlots);
  const T* __restrict__ J;  // [OD*D, n]
  const T* __restrict__ r;  // [OD, n]
  int64_t n;

  template <bool kAligned>
  __device__ __forceinline__ void load(int64_t e, Slot& v) const {
#pragma unroll
    for (int k = 0; k < OD * D; ++k) v.j[k] = J[k * n + e];
#pragma unroll
    for (int o = 0; o < OD; ++o) v.rr[o] = r[o * n + e];
  }

  __device__ __forceinline__ void accumulate(const Slot& v, T* acc) const {
#pragma unroll
    for (int a = 0; a < D; ++a) {
#pragma unroll
      for (int b = a; b < D; ++b) {
        T t = v.j[a] * v.j[b];
#pragma unroll
        for (int o = 1; o < OD; ++o) t += v.j[o * D + a] * v.j[o * D + b];
        acc[tri_index(a, b, D)] += t;
      }
    }
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T t = v.j[a] * v.rr[0];
#pragma unroll
      for (int o = 1; o < OD; ++o) t += v.j[o * D + a] * v.rr[o];
      acc[tri_size(D) + a] -= t;
    }
  }

  // One slot (the thread-per-segment shape's step: points).
  __device__ __forceinline__ void add(int64_t e, T* acc) const {
    Slot v;
    load<false>(e, v);
    accumulate(v, acc);
  }
};

// Sum f of a JtjRows segment: a triangle entry goes to (a, b) and (b, a),
// a gradient entry to row D*D + a.
template <typename T, int OD, int D>
__device__ __forceinline__ void store_sum(const JtjRows<T, OD, D>&,
                                          T* __restrict__ out,
                                          int64_t num_segments, int64_t s,
                                          int f, T v) {
  if (f >= tri_size(D)) {
    out[(D * D + f - tri_size(D)) * num_segments + s] = v;
    return;
  }
  int a = 0;
  while (f >= tri_index(a + 1, a + 1, D)) ++a;
  const int b = a + f - tri_index(a, a, D);
  out[(a * D + b) * num_segments + s] = v;
  if (b != a) out[(b * D + a) * num_segments + s] = v;
}

// Per-edge rows of J^T u (D values): the reduce half of a coupling product.
// In the split shape, bf16 rows (the mixed, mixed64 and bf16 arms) are
// loaded two neighbouring slots at a time: one __nv_bfloat162 a row where
// a chunk's pairs are 4-byte aligned in every row (n even and the chunk's
// first slot at an even bf16 offset; with n odd every other row is not),
// else two bf16 loads a row.  A pair's slots are added one after the
// other, as add() would.  add() keeps the form the thread-per-segment
// shape runs (points).
template <typename T, typename R, bool BF16, int OD, int D>
struct JtuRows {
  static constexpr int F = D;
  static constexpr int kSlots = sizeof(R) == 2 ? 2 : 1;
  struct Slot {
    R j[kSlots][OD * D];
    T uu[kSlots][OD];
  };
  static constexpr int kUnroll =
      split_unroll(F * sizeof(T), sizeof(Slot), kSlots);
  const R* __restrict__ J;  // [OD*D, n]
  const T* __restrict__ u;  // [OD, n]
  int64_t n;

  __device__ __forceinline__ void add(int64_t e, T* acc) const {
    T uu[OD];
#pragma unroll
    for (int o = 0; o < OD; ++o) uu[o] = operand<BF16>(u[o * n + e]);
#pragma unroll
    for (int b = 0; b < D; ++b) {
      T t = product<BF16>(J[b * n + e], uu[0]);
#pragma unroll
      for (int o = 1; o < OD; ++o) {
        t += product<BF16>(J[(o * D + b) * n + e], uu[o]);
      }
      acc[b] += t;
    }
  }

  __device__ __forceinline__ bool aligned(int64_t lo) const {
    return n % 2 == 0 && (reinterpret_cast<uintptr_t>(J + lo) & 3) == 0;
  }

  template <bool kAligned>
  __device__ __forceinline__ void load(int64_t e, Slot& v) const {
#pragma unroll
    for (int k = 0; k < OD * D; ++k) {
      const R* p = J + k * n + e;
      if constexpr (kSlots == 2 && kAligned) {
        const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(p);
        v.j[0][k] = q.x;
        v.j[1][k] = q.y;
      } else {
#pragma unroll
        for (int q = 0; q < kSlots; ++q) v.j[q][k] = p[q];
      }
    }
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
#pragma unroll
      for (int o = 0; o < OD; ++o) v.uu[q][o] = u[o * n + e + q];
    }
  }

  // acc += J_e^T u_e for each slot of a step, in the arithmetic of add().
  __device__ __forceinline__ void accumulate(const Slot& v, T* acc) const {
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      T uu[OD];
#pragma unroll
      for (int o = 0; o < OD; ++o) uu[o] = operand<BF16>(v.uu[q][o]);
#pragma unroll
      for (int b = 0; b < D; ++b) {
        T t = product<BF16>(v.j[q][b], uu[0]);
#pragma unroll
        for (int o = 1; o < OD; ++o) {
          t += product<BF16>(v.j[q][o * D + b], uu[o]);
        }
        acc[b] += t;
      }
    }
  }
};

// Kernels 1 and 3's launch: a thread per segment where segments are
// short, split segments where they are long (the plan's chunk table and
// counters, `partials` F values a chunk).
template <typename T, class Rows>
int launch_segment_sums(Rows rows, const int64_t* seg_ptr,
                        const SplitTable& tab, void* partials, T* out,
                        int64_t num_segments, int per_thread,
                        cudaStream_t stream) {
  if (per_thread) {
    return launch_thread_reduce<T>(rows, seg_ptr, out, num_segments, stream);
  }
  if (num_segments > 0 && (tab.chunk_ptr == nullptr ||
                           tab.counters == nullptr || partials == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_split_reduce<T>(rows, tab, static_cast<T*>(partials), out,
                                num_segments, stream);
}

// One thread per edge slot: gather the segment's D-row vertex vector and
// take the OD x D per-edge matvec u = J_e x[seg(e)].
template <typename T, typename R, bool BF16, int OD, int D>
__global__ void __launch_bounds__(kBlock)
expand_matvec(const T* __restrict__ table, const R* __restrict__ J,
              const int32_t* __restrict__ seg, T* __restrict__ u, int64_t n,
              int64_t num_segments) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (e >= n) return;
  const int64_t s = seg[e];
  T x[D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    x[a] = operand<BF16>(table[a * num_segments + s]);
  }
#pragma unroll
  for (int o = 0; o < OD; ++o) {
    T t = product<BF16>(J[(o * D) * n + e], x[0]);
#pragma unroll
    for (int a = 1; a < D; ++a) {
      t += product<BF16>(J[(o * D + a) * n + e], x[a]);
    }
    u[o * n + e] = operand<BF16>(t);
  }
}

template <typename T>
int jtj_typed(int od, int d, const void* J, const void* r,
              const int64_t* seg_ptr, const SplitTable& tab, void* partials,
              void* out, int64_t n, int64_t num_segments, int per_thread,
              cudaStream_t stream) {
  const T* Jt = static_cast<const T*>(J);
  const T* rt = static_cast<const T*>(r);
  T* o = static_cast<T*>(out);
#define MEGBA_BLOCK(OD, D)                                                   \
  if (od == (OD) && d == (D)) {                                              \
    return launch_segment_sums<T>(JtjRows<T, (OD), (D)>{Jt, rt, n},          \
                                  seg_ptr, tab, partials, o, num_segments,   \
                                  per_thread, stream);                       \
  }
#include "block_shapes.cuh"
#undef MEGBA_BLOCK
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename R, bool BF16>
int reduce_typed(int od, int d, const void* J, const void* u,
                 const int64_t* seg_ptr, const SplitTable& tab,
                 void* partials, void* out, int64_t n, int64_t num_segments,
                 int per_thread, cudaStream_t stream) {
  const R* Jt = static_cast<const R*>(J);
  const T* ut = static_cast<const T*>(u);
  T* o = static_cast<T*>(out);
#define MEGBA_BLOCK(OD, D)                                                   \
  if (od == (OD) && d == (D)) {                                              \
    return launch_segment_sums<T>(JtuRows<T, R, BF16, (OD), (D)>{Jt, ut, n}, \
                                  seg_ptr, tab, partials, o, num_segments,   \
                                  per_thread, stream);                       \
  }
#include "block_shapes.cuh"
#undef MEGBA_BLOCK
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename R, bool BF16, int OD, int D>
int launch_expand(const void* table, const void* J, const int32_t* seg,
                  void* u, int64_t n, int64_t num_segments,
                  cudaStream_t stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t grid = (n + kBlock - 1) / kBlock;
  if (grid > kMaxGrid) return static_cast<int>(cudaErrorInvalidConfiguration);
  expand_matvec<T, R, BF16, OD, D>
      <<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
          static_cast<const T*>(table), static_cast<const R*>(J), seg,
          static_cast<T*>(u), n, num_segments);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename R, bool BF16>
int expand_typed(int od, int d, const void* table, const void* J,
                 const int32_t* seg, void* u, int64_t n, int64_t num_segments,
                 cudaStream_t stream) {
#define MEGBA_BLOCK(OD, D)                                                \
  if (od == (OD) && d == (D)) {                                           \
    return launch_expand<T, R, BF16, (OD), (D)>(table, J, seg, u, n,      \
                                                num_segments, stream);    \
  }
#include "block_shapes.cuh"
#undef MEGBA_BLOCK
  return static_cast<int>(cudaErrorInvalidValue);
}

// One thread per edge slot: copy the F values of the slot's segment row.
// Each store instruction of a warp writes 32 neighbouring slots of a row.
template <typename T, int F>
__global__ void __launch_bounds__(kBlock)
seg_expand_kernel(const T* __restrict__ table, const int32_t* __restrict__ seg,
                  T* __restrict__ out, int64_t n, int64_t num_segments) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (e >= n) return;
  const int64_t s = seg[e];
#pragma unroll
  for (int f = 0; f < F; ++f) out[f * n + e] = table[f * num_segments + s];
}

template <typename T, int F>
int launch_seg_expand(const void* table, const int32_t* seg, void* out,
                      int64_t n, int64_t num_segments, cudaStream_t stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t grid = (n + kBlock - 1) / kBlock;
  if (grid > kMaxGrid) return static_cast<int>(cudaErrorInvalidConfiguration);
  seg_expand_kernel<T, F><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
      static_cast<const T*>(table), seg, static_cast<T*>(out), n,
      num_segments);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int seg_expand_typed(int F, const void* table, const int32_t* seg, void* out,
                     int64_t n, int64_t num_segments, cudaStream_t stream) {
#define MEGBA_COUPLING(CD, PD, OD)
#define MEGBA_WIDTH(W)                                                  \
  if (F == (W)) {                                                       \
    return launch_seg_expand<T, (W)>(table, seg, out, n, num_segments,  \
                                     stream);                           \
  }
#include "fused_shapes.cuh"
#undef MEGBA_WIDTH
#undef MEGBA_COUPLING
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out [d*d + d, nS] = per segment: sum_e J_e^T J_e rows, then -sum_e J_e^T r_e.
// Long segments (per_thread 0) take the plan's split table (`split`, the
// int64 array of segreduce.cuh's SplitTable, num_chunks chunks), its
// counters, and a workspace `partials` of d(d+1)/2 + d values a chunk.
int megba_jtj_grad_reduce(int is_double, int od, int d, const void* J,
                          const void* r, const int64_t* seg_ptr,
                          const int64_t* split, unsigned int* counters,
                          int64_t num_chunks, void* partials, void* out,
                          int64_t n, int64_t num_segments, int per_thread,
                          void* stream) {
  if (const int prior = pending_error()) return prior;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SplitTable tab = split_table(split, counters, num_chunks, seg_ptr);
  return is_double
             ? jtj_typed<double>(od, d, J, r, seg_ptr, tab, partials, out, n,
                                 num_segments, per_thread, st)
             : jtj_typed<float>(od, d, J, r, seg_ptr, tab, partials, out, n,
                                num_segments, per_thread, st);
}

// u [od, n] = per edge: J_e table[:, seg(e)], in the arm's arithmetic.
int megba_coupling_expand(int arm, int od, int d, const void* table,
                          const void* J, const int32_t* seg, void* u,
                          int64_t n, int64_t num_segments, void* stream) {
  if (const int prior = pending_error()) return prior;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case kF32:
      return expand_typed<float, float, false>(od, d, table, J, seg, u, n,
                                               num_segments, st);
    case kF64:
      return expand_typed<double, double, false>(od, d, table, J, seg, u, n,
                                                 num_segments, st);
    case kMixed:
      return expand_typed<float, __nv_bfloat16, false>(od, d, table, J, seg,
                                                       u, n, num_segments, st);
    case kBf16:
      return expand_typed<float, __nv_bfloat16, true>(od, d, table, J, seg, u,
                                                      n, num_segments, st);
    case kMixed64:
      return expand_typed<double, __nv_bfloat16, false>(
          od, d, table, J, seg, u, n, num_segments, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [d, nS] = per segment: sum_e J_e^T u_e, in the arm's arithmetic.
// Long segments take the split table as megba_jtj_grad_reduce does, with a
// workspace of d values a chunk.
int megba_coupling_reduce(int arm, int od, int d, const void* J,
                          const void* u, const int64_t* seg_ptr,
                          const int64_t* split, unsigned int* counters,
                          int64_t num_chunks, void* partials, void* out,
                          int64_t n, int64_t num_segments, int per_thread,
                          void* stream) {
  if (const int prior = pending_error()) return prior;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SplitTable tab = split_table(split, counters, num_chunks, seg_ptr);
  switch (arm) {
    case kF32:
      return reduce_typed<float, float, false>(
          od, d, J, u, seg_ptr, tab, partials, out, n, num_segments,
          per_thread, st);
    case kF64:
      return reduce_typed<double, double, false>(
          od, d, J, u, seg_ptr, tab, partials, out, n, num_segments,
          per_thread, st);
    case kMixed:
      return reduce_typed<float, __nv_bfloat16, false>(
          od, d, J, u, seg_ptr, tab, partials, out, n, num_segments,
          per_thread, st);
    case kBf16:
      return reduce_typed<float, __nv_bfloat16, true>(
          od, d, J, u, seg_ptr, tab, partials, out, n, num_segments,
          per_thread, st);
    case kMixed64:
      return reduce_typed<double, __nv_bfloat16, false>(
          od, d, J, u, seg_ptr, tab, partials, out, n, num_segments,
          per_thread, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [F, n] = per slot: table[:, seg(e)].
int megba_seg_expand(int is_double, int F, const void* table,
                     const int32_t* seg, void* out, int64_t n,
                     int64_t num_segments, void* stream) {
  if (const int prior = pending_error()) return prior;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? seg_expand_typed<double>(F, table, seg, out, n,
                                              num_segments, st)
                   : seg_expand_typed<float>(F, table, seg, out, n,
                                             num_segments, st);
}

const char* megba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
