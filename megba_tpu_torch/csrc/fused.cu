// Fused kernels of the explicit-Schur solve path, hand-written for Hopper
// (sm_90a).  Built by megba_tpu_torch/ops/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes; the Python wrappers
// live in megba_tpu_torch/ops/fused.py.
//
// They replace two Pallas kernels of the JAX package
// (megba_tpu/ops/fused.py):
//
//   megba_fused_coupling_apply  <- _fused_w_kernel     (body :387, pallas_call :500)
//   megba_block_diag_apply      <- _block_diag_kernel  (body :443, pallas_call :647)
//
// megba_fused_coupling_apply: one direction of the explicit-Schur coupling
// product, out[:, o] = sum over the edges e with output vertex o of
// W_e . table[:, in(e)], with W_e the stored per-edge coupling block
// (rows a*pd+b of W = Jc^T Jp; input-major when the input is the camera).
// The TPU kernel one-hot-gathered and one-hot-scattered bucket-padded edge
// tiles so that the per-edge rows never left VMEM.  Here the W rows of a
// direction are in the OUTPUT side's segment-sorted slot order (the point
// order for cam->pt, permuted once per PCG solve; the canonical camera
// order for pt->cam), with the input vertex of each slot in `in_idx`, and
// the product is a segment reduction (segreduce.cuh) whose per-slot term
// gathers DIN table values and contracts them with the slot's W block in
// registers.  No per-edge [cd, n] or [pd, n] row and no cross permute
// touches device memory.
//   - cam->pt (output = points, ~5 edges each): one thread per point.  The
//     9-value camera gathers read a table of 64 KB (f32, venice) that stays
//     in L1 and L2.  Staging it in shared memory instead (64 KB a block)
//     caps occupancy at three blocks an SM and measured slower on the
//     H100 (PERF.md).
//   - pt->cam (output = cameras, thousands of edges each): one 256-thread
//     block per camera over the camera-sorted stream; the 3-value point
//     gather reads a table that stays in L2 (12 MB at venice).
// Bound on the H100: bytes.  Each slot reads its 27 W values, its input
// index and DIN table values (from L1 or L2) for 2*27 flops:
// < 0.5 flop per HBM byte, against the card's ~20 f32 flop/byte balance.
// The design reads W once, coalesced along each row (neighbouring threads
// own neighbouring slots or neighbouring short segments), and writes only
// the [DOUT, nS] result.
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
// Determinism: no atomics; every output is formed by one thread, or by one
// block in a fixed order (segreduce.cuh), so results are bitwise repeatable
// for a given launch shape.
//
// Every entry point first peeks at the CUDA error state and returns an
// error pending from an earlier launch negated, without launching; then it
// returns cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for a block shape it was not built for.

#include "segreduce.cuh"

namespace {

// Per-slot term of one fused direction: gather the input vertex's DIN
// values, contract with the slot's W block, add the DOUT results.
template <typename T, int DIN, int DOUT, bool IN_MAJOR>
struct WRows {
  static constexpr int F = DOUT;
  const T* __restrict__ W;             // [DIN*DOUT, n]
  const T* __restrict__ table;         // [DIN, num_in]
  const int32_t* __restrict__ in_idx;  // [n]
  int64_t n;
  int64_t num_in;

  __device__ __forceinline__ void add(int64_t e, T* acc) const {
    const int64_t i = in_idx[e];
    T x[DIN];
#pragma unroll
    for (int a = 0; a < DIN; ++a) x[a] = table[a * num_in + i];
#pragma unroll
    for (int b = 0; b < DOUT; ++b) {
      T t = T(0);
#pragma unroll
      for (int a = 0; a < DIN; ++a) {
        const int row = IN_MAJOR ? a * DOUT + b : b * DIN + a;
        t += W[row * n + e] * x[a];
      }
      acc[b] += t;
    }
  }
};

template <typename T, int DIN, int DOUT, bool IN_MAJOR>
int fused_shape(const void* W, const void* table, const int32_t* in_idx,
                const int64_t* seg_ptr, void* out, int64_t n, int64_t num_in,
                int64_t num_out, int per_thread, cudaStream_t stream) {
  WRows<T, DIN, DOUT, IN_MAJOR> rows{static_cast<const T*>(W),
                                     static_cast<const T*>(table), in_idx, n,
                                     num_in};
  return launch_reduce<T>(rows, seg_ptr, static_cast<T*>(out), num_out,
                         per_thread, stream);
}

template <typename T>
int fused_typed(int d_in, int d_out, int w_in_major, const void* W,
                const void* table, const int32_t* in_idx,
                const int64_t* seg_ptr, void* out, int64_t n, int64_t num_in,
                int64_t num_out, int per_thread, cudaStream_t stream) {
  if (d_in == 9 && d_out == 3 && w_in_major) {
    return fused_shape<T, 9, 3, true>(W, table, in_idx, seg_ptr, out, n,
                                      num_in, num_out, per_thread, stream);
  }
  if (d_in == 3 && d_out == 9 && !w_in_major) {
    return fused_shape<T, 3, 9, false>(W, table, in_idx, seg_ptr, out, n,
                                       num_in, num_out, per_thread, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// One thread per (output row i, camera c): out[i, c] = sum_j H[i*D+j, c]
// * x[j, c].  Threads of a warp own neighbouring cameras of one row, so
// each of the D + D loads and the store is coalesced.
template <typename T, int D>
__global__ void __launch_bounds__(kBlock)
block_diag_kernel(const T* __restrict__ H, const T* __restrict__ x,
                  T* __restrict__ out, int64_t nc) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (k >= D * nc) return;
  const int64_t i = k / nc;
  const int64_t c = k - i * nc;
  T t = H[(i * D) * nc + c] * x[c];
#pragma unroll
  for (int j = 1; j < D; ++j) t += H[(i * D + j) * nc + c] * x[j * nc + c];
  out[k] = t;
}

template <typename T>
int block_diag_typed(int d, const void* H, const void* x, void* out,
                     int64_t nc, cudaStream_t stream) {
  if (d != 9) return static_cast<int>(cudaErrorInvalidValue);
  if (nc == 0) return static_cast<int>(cudaSuccess);
  const int64_t grid = (9 * nc + kBlock - 1) / kBlock;
  if (grid > kMaxGrid) return static_cast<int>(cudaErrorInvalidConfiguration);
  block_diag_kernel<T, 9><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
      static_cast<const T*>(H), static_cast<const T*>(x),
      static_cast<T*>(out), nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out [d_out, num_out] = per output segment: sum over its slots e of
// W_e . table[:, in_idx[e]].
int megba_fused_coupling_apply(int is_double, int d_in, int d_out,
                               int w_in_major, const void* W,
                               const void* table, const int32_t* in_idx,
                               const int64_t* seg_ptr, void* out, int64_t n,
                               int64_t num_in, int64_t num_out,
                               int per_thread, void* stream) {
  if (const int prior = pending_error()) return prior;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double
             ? fused_typed<double>(d_in, d_out, w_in_major, W, table, in_idx,
                                   seg_ptr, out, n, num_in, num_out,
                                   per_thread, st)
             : fused_typed<float>(d_in, d_out, w_in_major, W, table, in_idx,
                                  seg_ptr, out, n, num_in, num_out,
                                  per_thread, st);
}

// out [d, Nc] = per camera: H_c x[:, c], H in [d*d, Nc] rows.
int megba_block_diag_apply(int is_double, int d, const void* H,
                           const void* x, void* out, int64_t nc,
                           void* stream) {
  if (const int prior = pending_error()) return prior;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? block_diag_typed<double>(d, H, x, out, nc, st)
                   : block_diag_typed<float>(d, H, x, out, nc, st);
}

const char* megba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
