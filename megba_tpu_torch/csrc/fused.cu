// Fused kernels of the Schur PCG solve path, hand-written for Hopper
// (sm_90a).  Built by megba_tpu_torch/ops/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes; the Python wrappers
// live in megba_tpu_torch/ops/fused.py.
//
// They replace three Pallas kernels of the JAX package
// (megba_tpu/ops/fused.py):
//
//   megba_fused_coupling_apply  <- _fused_w_kernel     (body :387, pallas_call :500)
//   megba_fused_implicit_apply  <- _fused_j_kernel     (body :412, pallas_call :526)
//   megba_block_diag_apply      <- _block_diag_kernel  (body :443, pallas_call :647)
//
// megba_fused_coupling_apply: one direction of the explicit-Schur coupling
// product, out[:, o] = sum over the edges e with output vertex o of
// W_e . table[:, in(e)], with W_e the stored per-edge coupling block
// (rows a*pd+b of W = Jc^T Jp; input-major when the input is the camera).
// megba_fused_implicit_apply: one direction of the implicit-Schur coupling
// product from the stored Jacobian rows, out[:, o] = sum over the edges e
// with output vertex o of Jout_e^T (Jin_e . table[:, in(e)]), with
// Jin rows o*DIN+a and Jout rows o*DOUT+b (OD residual rows).
// The TPU kernels one-hot-gathered and one-hot-scattered bucket-padded edge
// tiles so that the per-edge rows never left VMEM.  Here the rows of a
// direction are in the OUTPUT side's segment-sorted slot order (the point
// order for cam->pt, permuted once per PCG solve; the canonical camera
// order for pt->cam), with the input vertex of each slot in `in_idx`, and
// the product is a segment reduction (segreduce.cuh) whose per-slot term
// (`term`) gathers DIN table values and contracts them with the slot's
// rows in registers (for the implicit product: the OD values
// u = Jin_e x, then Jout_e^T u).  No per-edge [cd, n], [pd, n] or [od, n]
// row and no cross permute touches device memory.
//
// Block shapes: every (cd, pd, od) of csrc/fused_shapes.cuh, the one list
// of the registered factor families' shapes (BAL (9, 3, 2), planar
// (4, 2, 1), the rig's (7, 3, 2), pinhole_radial's (12, 3, 2), the pose
// prior's (6, 3, 6) and a Problem edge on a pose camera, (6, 3, 2)), in
// every precision arm: kernel 8 in both directions of each (cd, pd),
// kernel 7 in both directions of each (cd, pd, od), kernel 6 at each cd.
// A library built with -DMEGBA_ONE_FUSED_CD / _PD / _OD holds one other
// shape (ops/fused.py builds it at first use).  The per-slot term keeps
// the JAX kernels' order at every shape: u[o] summed over a ascending,
// then t[b] summed over o ascending; at BAL's (9, 3, 2) it is the code
// of the od = 2 kernel before OD became a template parameter, so those
// outputs are bitwise what they were.
//
// Bound on the H100: bytes.  At BAL's shapes each slot reads its 27 W
// values (or 18 + 6 Jacobian values), its input index and DIN table
// values (from L1 or L2) for 2*27 (2*24) flops: < 0.5 flop per HBM byte,
// against the card's ~20 f32 flop/byte balance (the widest family,
// pinhole_radial, 36 W or 24 + 6 J values a slot, the same ratio).  So the design reads each row once, with
// every byte of a warp's load used, and writes only the [DOUT, nS]
// result.  Launch shapes (segreduce.cuh):
//   - cam->pt (output = points, ~5 slots each): slot tiles.  Block b
//     owns the points whose first slot lies in [b*256, (b+1)*256) (the
//     plan's tile_ptr, ops/fused.slot_tiles); lane i computes slot
//     base+i's DOUT terms, so each of a warp's 27 (24) row loads is 32
//     consecutive values, 128 bytes at f32 and 64 at bf16, coalesced;
//     the terms go through shared memory (term[3][256]: 3 KB at f32, 6 KB
//     at f64) to the thread that owns their point, which sums them from 0
//     in slot order, the order of the earlier thread-per-point shape, so
//     the two give bitwise the same sums.  A track of 256 slots or more
//     is summed by its whole block, strided, as a camera is: walked by
//     one thread, such tracks held this launch to 23-24 % of its bound on
//     chip_smoke.py's ~1e6-slot Zipf test graph, summed so 31-33 % (H100,
//     PERF.md).
//     The 9-value camera gathers read a table of 64 KB (f32, venice) that
//     stays in L1 and L2; staging it in shared memory measured only
//     8-12 % faster on the thread-per-point shape (PERF.md).
//   - pt->cam (output = cameras, thousands of edges each): one 256-thread
//     block per camera over the camera-sorted stream, whose strided loop
//     already reads consecutive slots per warp; the 3-value point gather
//     reads a table that stays in L2 (12 MB at venice).  A short-camera
//     graph (mean under 64 slots a camera) takes slot tiles here too
//     (term[9][256]: 9 KB at f32, 18 KB at f64).
// Resources of the slot-tile launch (nvcc -Xptxas -v, sm_90a, 256
// threads a block): cam->pt 40-42 registers and 3.1 KB of shared memory
// a block at f32, 32-44 and 3.1 KB in the bf16-row arms beside an f32
// table, 48-62 and 6.2 KB at f64 and mixed64 (8 bytes of spill in the
// f64 and mixed W instantiations); a short-camera pt->cam 44 and 9.3 KB
// at f32 and bf16 rows, 64-66 and 18.6 KB at f64 and mixed64.  At the
// families' widest shapes: pt->cam slot tiles at DOUT = 12 (pinhole_radial)
// 78 registers and 25.3 KB at f64 and mixed64; the pose prior's pt->cam
// (3, 6, 6) on the block-per-segment launch 98 registers at f64; no
// spill but the two 8-byte ones above (nvcc -Xptxas -v for sm_90a).
//
// megba_block_diag_apply: out[:, c] = M^-1_c x[:, c] with the inverted
// block diagonal laid out feature-major ([d*d, Nc], row i*d+j).  One thread
// per output value (row i, camera c): d + d coalesced loads, one store.  At
// Nc = 1778 (0.7 MB in all) it is bound by launch latency, not bytes: the
// 0.7 MB take ~0.2 us at the HBM rate, well under the few microseconds a
// launch takes.  A thread per value (16,002 threads, 63 blocks) rather
// than per camera (1778 threads, 7 blocks on 7 of 132 SMs) keeps the
// loads' latency from adding to that.
//
// Precision arms (precision.cuh): the coupling applies take f32, f64,
// mixed (bf16 rows, f32 table), mixed64 (bf16 rows, f64 table) and bf16
// (bf16 products) arms; the block-diagonal apply all but mixed64 (the
// mixed rungs apply M^-1 in the table's dtype).  The bf16 rows halve the
// bytes each slot reads, the bound's dominant term.
//
// Determinism: no atomics; every output is formed by one thread, or by one
// block in a fixed order (segreduce.cuh), so results are bitwise repeatable
// for a given launch shape.
//
// Every entry point first peeks at the CUDA error state and returns an
// error pending from an earlier launch negated, without launching; then it
// returns cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for a block shape or arm it was not built for.

#include "precision.cuh"
#include "segreduce.cuh"

namespace {

// Per-slot term of one explicit fused direction: gather the input
// vertex's DIN values, contract with the slot's W block, add the DOUT
// results.
template <typename T, typename R, bool BF16, int DIN, int DOUT, bool IN_MAJOR>
struct WRows {
  static constexpr int F = DOUT;
  const R* __restrict__ W;             // [DIN*DOUT, n]
  const T* __restrict__ table;         // [DIN, num_in]
  const int32_t* __restrict__ in_idx;  // [n]
  int64_t n;
  int64_t num_in;

  // The DOUT values slot e adds to its output vertex.
  __device__ __forceinline__ void term(int64_t e, T* t) const {
    const int64_t i = in_idx[e];
    T x[DIN];
#pragma unroll
    for (int a = 0; a < DIN; ++a) x[a] = operand<BF16>(table[a * num_in + i]);
#pragma unroll
    for (int b = 0; b < DOUT; ++b) {
      t[b] = product<BF16>(W[(IN_MAJOR ? b : b * DIN) * n + e], x[0]);
#pragma unroll
      for (int a = 1; a < DIN; ++a) {
        const int row = IN_MAJOR ? a * DOUT + b : b * DIN + a;
        t[b] += product<BF16>(W[row * n + e], x[a]);
      }
    }
  }

  __device__ __forceinline__ void add(int64_t e, T* acc) const {
    T t[DOUT];
    term(e, t);
#pragma unroll
    for (int b = 0; b < DOUT; ++b) acc[b] += t[b];
  }
};

// Per-slot term of one implicit fused direction: gather the input
// vertex's DIN values, u = Jin_e x (OD values, in registers), add
// Jout_e^T u.
template <typename T, typename R, bool BF16, int DIN, int DOUT, int OD>
struct JRows {
  static constexpr int F = DOUT;
  const R* __restrict__ Jin;           // [OD*DIN, n], row o*DIN+a
  const R* __restrict__ Jout;          // [OD*DOUT, n], row o*DOUT+b
  const T* __restrict__ table;         // [DIN, num_in]
  const int32_t* __restrict__ in_idx;  // [n]
  int64_t n;
  int64_t num_in;

  // The DOUT values slot e adds to its output vertex.
  __device__ __forceinline__ void term(int64_t e, T* t) const {
    const int64_t i = in_idx[e];
    T x[DIN];
#pragma unroll
    for (int a = 0; a < DIN; ++a) x[a] = operand<BF16>(table[a * num_in + i]);
    T u[OD];
#pragma unroll
    for (int o = 0; o < OD; ++o) {
      T s = product<BF16>(Jin[(o * DIN) * n + e], x[0]);
#pragma unroll
      for (int a = 1; a < DIN; ++a) {
        s += product<BF16>(Jin[(o * DIN + a) * n + e], x[a]);
      }
      u[o] = operand<BF16>(s);
    }
#pragma unroll
    for (int b = 0; b < DOUT; ++b) {
      t[b] = product<BF16>(Jout[b * n + e], u[0]);
#pragma unroll
      for (int o = 1; o < OD; ++o) {
        t[b] += product<BF16>(Jout[(o * DOUT + b) * n + e], u[o]);
      }
    }
  }

  __device__ __forceinline__ void add(int64_t e, T* acc) const {
    T t[DOUT];
    term(e, t);
#pragma unroll
    for (int b = 0; b < DOUT; ++b) acc[b] += t[b];
  }
};

struct Launch {
  const void* table;
  const int32_t* in_idx;
  const int64_t* seg_ptr;
  const int64_t* tile_ptr;
  void* out;
  int64_t n;
  int64_t num_in;
  int64_t num_out;
  int64_t num_tiles;
  int per_thread;
  cudaStream_t stream;
};

template <typename T, class Rows>
int launch(const Rows& rows, const Launch& l) {
  return launch_tiled_reduce<T>(rows, l.seg_ptr, static_cast<T*>(l.out),
                                l.num_out, l.per_thread, l.tile_ptr,
                                l.num_tiles, l.stream);
}

// A shape with a zero width (a MEGBA_COUPLING line with pd = 0 or
// od = 0) instantiates no kernel: its dispatch test never matches a call.
template <typename T, typename R, bool BF16, int DIN, int DOUT, bool IN_MAJOR>
int w_shape(const void* W, const Launch& l) {
  if constexpr (DIN == 0 || DOUT == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    WRows<T, R, BF16, DIN, DOUT, IN_MAJOR> rows{
        static_cast<const R*>(W), static_cast<const T*>(l.table), l.in_idx,
        l.n, l.num_in};
    return launch<T>(rows, l);
  }
}

template <typename T, typename R, bool BF16>
int w_directions(int d_in, int d_out, int w_in_major, const void* W,
                 const Launch& l) {
#define MEGBA_WIDTH(F)
#define MEGBA_COUPLING(CD, PD, OD)                              \
  if (d_in == (CD) && d_out == (PD) && w_in_major) {            \
    return w_shape<T, R, BF16, (CD), (PD), true>(W, l);         \
  }                                                             \
  if (d_in == (PD) && d_out == (CD) && !w_in_major) {           \
    return w_shape<T, R, BF16, (PD), (CD), false>(W, l);        \
  }
#include "fused_shapes.cuh"
#undef MEGBA_COUPLING
#undef MEGBA_WIDTH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename R, bool BF16, int DIN, int DOUT, int OD>
int j_shape(const void* Jin, const void* Jout, const Launch& l) {
  if constexpr (DIN == 0 || DOUT == 0 || OD == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    JRows<T, R, BF16, DIN, DOUT, OD> rows{
        static_cast<const R*>(Jin), static_cast<const R*>(Jout),
        static_cast<const T*>(l.table), l.in_idx, l.n, l.num_in};
    return launch<T>(rows, l);
  }
}

template <typename T, typename R, bool BF16>
int j_directions(int d_in, int d_out, int od, const void* Jin,
                 const void* Jout, const Launch& l) {
#define MEGBA_WIDTH(F)
#define MEGBA_COUPLING(CD, PD, OD)                                    \
  if (d_in == (CD) && d_out == (PD) && od == (OD)) {                  \
    return j_shape<T, R, BF16, (CD), (PD), (OD)>(Jin, Jout, l);       \
  }                                                                   \
  if (d_in == (PD) && d_out == (CD) && od == (OD)) {                  \
    return j_shape<T, R, BF16, (PD), (CD), (OD)>(Jin, Jout, l);       \
  }
#include "fused_shapes.cuh"
#undef MEGBA_COUPLING
#undef MEGBA_WIDTH
  return static_cast<int>(cudaErrorInvalidValue);
}

// One thread per (output row i, camera c): out[i, c] = sum_j H[i*D+j, c]
// * x[j, c].  Threads of a warp own neighbouring cameras of one row, so
// each of the D + D loads and the store is coalesced.
template <typename T, typename R, bool BF16, int D>
__global__ void __launch_bounds__(kBlock)
block_diag_kernel(const R* __restrict__ H, const T* __restrict__ x,
                  T* __restrict__ out, int64_t nc) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (k >= D * nc) return;
  const int64_t i = k / nc;
  const int64_t c = k - i * nc;
  T t = product<BF16>(H[(i * D) * nc + c], operand<BF16>(x[c]));
#pragma unroll
  for (int j = 1; j < D; ++j) {
    t += product<BF16>(H[(i * D + j) * nc + c], operand<BF16>(x[j * nc + c]));
  }
  out[k] = t;
}

template <typename T, typename R, bool BF16, int D>
int block_diag_shape(const void* H, const void* x, void* out, int64_t nc,
                     cudaStream_t stream) {
  if (nc == 0) return static_cast<int>(cudaSuccess);
  const int64_t grid = (D * nc + kBlock - 1) / kBlock;
  if (grid > kMaxGrid) return static_cast<int>(cudaErrorInvalidConfiguration);
  block_diag_kernel<T, R, BF16, D>
      <<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
          static_cast<const R*>(H), static_cast<const T*>(x),
          static_cast<T*>(out), nc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename R, bool BF16>
int block_diag_typed(int d, const void* H, const void* x, void* out,
                     int64_t nc, cudaStream_t stream) {
#define MEGBA_WIDTH(F)
#define MEGBA_COUPLING(CD, PD, OD)                                      \
  if (d == (CD)) {                                                      \
    return block_diag_shape<T, R, BF16, (CD)>(H, x, out, nc, stream);   \
  }
#include "fused_shapes.cuh"
#undef MEGBA_COUPLING
#undef MEGBA_WIDTH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out [d_out, num_out] = per output segment: sum over its slots e of
// W_e . table[:, in_idx[e]].  With per_thread (short output segments) the
// launch is the plan's num_tiles slot tiles of at most kBlock slots
// (tile_ptr [num_tiles + 1]); otherwise a block per output segment.
int megba_fused_coupling_apply(int arm, int d_in, int d_out, int w_in_major,
                               const void* W, const void* table,
                               const int32_t* in_idx, const int64_t* seg_ptr,
                               const int64_t* tile_ptr, void* out, int64_t n,
                               int64_t num_in, int64_t num_out,
                               int64_t num_tiles, int per_thread,
                               void* stream) {
  if (const int prior = pending_error()) return prior;
  const Launch l{table,     in_idx, seg_ptr, tile_ptr,
                 out,       n,      num_in,  num_out,
                 num_tiles, per_thread, static_cast<cudaStream_t>(stream)};
  switch (arm) {
    case kF32:
      return w_directions<float, float, false>(d_in, d_out, w_in_major, W, l);
    case kF64:
      return w_directions<double, double, false>(d_in, d_out, w_in_major, W,
                                                 l);
    case kMixed:
      return w_directions<float, __nv_bfloat16, false>(d_in, d_out,
                                                       w_in_major, W, l);
    case kBf16:
      return w_directions<float, __nv_bfloat16, true>(d_in, d_out,
                                                      w_in_major, W, l);
    case kMixed64:
      return w_directions<double, __nv_bfloat16, false>(d_in, d_out,
                                                        w_in_major, W, l);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [d_out, num_out] = per output segment: sum over its slots e of
// Jout_e^T (Jin_e . table[:, in_idx[e]]), od residual rows; the launch as
// above.
int megba_fused_implicit_apply(int arm, int d_in, int d_out, int od,
                               const void* Jin,
                               const void* Jout, const void* table,
                               const int32_t* in_idx, const int64_t* seg_ptr,
                               const int64_t* tile_ptr, void* out, int64_t n,
                               int64_t num_in, int64_t num_out,
                               int64_t num_tiles, int per_thread,
                               void* stream) {
  if (const int prior = pending_error()) return prior;
  const Launch l{table,     in_idx, seg_ptr, tile_ptr,
                 out,       n,      num_in,  num_out,
                 num_tiles, per_thread, static_cast<cudaStream_t>(stream)};
  switch (arm) {
    case kF32:
      return j_directions<float, float, false>(d_in, d_out, od, Jin, Jout,
                                               l);
    case kF64:
      return j_directions<double, double, false>(d_in, d_out, od, Jin, Jout,
                                                 l);
    case kMixed:
      return j_directions<float, __nv_bfloat16, false>(d_in, d_out, od, Jin,
                                                       Jout, l);
    case kBf16:
      return j_directions<float, __nv_bfloat16, true>(d_in, d_out, od, Jin,
                                                      Jout, l);
    case kMixed64:
      return j_directions<double, __nv_bfloat16, false>(d_in, d_out, od, Jin,
                                                        Jout, l);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [d, Nc] = per camera: H_c x[:, c], H in [d*d, Nc] rows.
int megba_block_diag_apply(int arm, int d, const void* H, const void* x,
                           void* out, int64_t nc, void* stream) {
  if (const int prior = pending_error()) return prior;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case kF32:
      return block_diag_typed<float, float, false>(d, H, x, out, nc, st);
    case kF64:
      return block_diag_typed<double, double, false>(d, H, x, out, nc, st);
    case kMixed:
      return block_diag_typed<float, __nv_bfloat16, false>(d, H, x, out, nc,
                                                            st);
    case kBf16:
      return block_diag_typed<float, __nv_bfloat16, true>(d, H, x, out, nc,
                                                          st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* megba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
