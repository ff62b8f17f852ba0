// Segment kernels of the implicit-Schur solve path, hand-written for Hopper
// (sm_90a).  Built by megba_tpu_torch/ops/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes; the Python wrappers
// live in megba_tpu_torch/ops/segtiles.py.
//
// They replace the three Pallas kernels the JAX package runs on this path
// (megba_tpu/ops/segtiles.py):
//
//   megba_jtj_grad_reduce  <- _jtj_kernel            (body :404, pallas_call :469)
//   megba_coupling_expand  <- _expand_matvec_kernel  (body :577, pallas_call :624)
//   megba_coupling_reduce  <- _matvec_reduce_kernel  (body :632, pallas_call :688)
//
// What is ported is what the Pallas kernels compute, not how the TPU did it.
// The TPU kernels turned every scatter into a one-hot matmul over padded,
// block-aligned edge tiles.  Here the edge stream of one vertex kind is
// sorted by segment (camera or point) and described by CSR offsets
// seg_ptr[nS + 1]; a reduction walks each segment's contiguous edge range.
//
// Layout: feature-major, row f of a [F, n] array starts at f * n.
//
// Bound on the H100: every kernel reads the Jacobian rows once and does a
// few multiply-adds per byte, far below the card's ~20 FLOP/byte float32
// balance point, so all three are bound by HBM bytes.  The design keeps the
// byte count at the minimum: one pass over J, no per-edge intermediate
// (the outer-product or J^T u rows) ever written to device memory, and
// coalesced loads (neighbouring threads read neighbouring edges of a row).
//
// Determinism: no atomics.  A segment's sum is formed by one thread, or by
// one block with a fixed strided split, a fixed warp-shuffle tree and a
// fixed sum over warps, so for a given launch shape the output is
// bitwise-reproducible from run to run.
//
// Every entry point first peeks at the CUDA error state: an error left
// by an earlier launch (of any kernel) is returned negated, without
// launching, so the wrapper does not report it as its own.  Otherwise it
// returns cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for an (od, d) pair it was not built for; the
// Python wrapper raises on any non-zero code.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Per-edge rows of J^T J (D*D values, row a*D+b) and -J^T r (D values),
// added into acc: the fused Hessian-block + gradient build.
template <typename T, int OD, int D>
struct JtjRows {
  static constexpr int F = D * D + D;
  const T* __restrict__ J;  // [OD*D, n]
  const T* __restrict__ r;  // [OD, n]
  int64_t n;

  __device__ __forceinline__ void add(int64_t e, T* acc) const {
    T j[OD * D];
    T rr[OD];
#pragma unroll
    for (int k = 0; k < OD * D; ++k) j[k] = J[k * n + e];
#pragma unroll
    for (int o = 0; o < OD; ++o) rr[o] = r[o * n + e];
#pragma unroll
    for (int a = 0; a < D; ++a) {
#pragma unroll
      for (int b = 0; b < D; ++b) {
        T t = j[a] * j[b];
#pragma unroll
        for (int o = 1; o < OD; ++o) t += j[o * D + a] * j[o * D + b];
        acc[a * D + b] += t;
      }
    }
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T t = j[a] * rr[0];
#pragma unroll
      for (int o = 1; o < OD; ++o) t += j[o * D + a] * rr[o];
      acc[D * D + a] -= t;
    }
  }
};

// Per-edge rows of J^T u (D values): the reduce half of a coupling product.
template <typename T, int OD, int D>
struct JtuRows {
  static constexpr int F = D;
  const T* __restrict__ J;  // [OD*D, n]
  const T* __restrict__ u;  // [OD, n]
  int64_t n;

  __device__ __forceinline__ void add(int64_t e, T* acc) const {
    T uu[OD];
#pragma unroll
    for (int o = 0; o < OD; ++o) uu[o] = u[o * n + e];
#pragma unroll
    for (int b = 0; b < D; ++b) {
      T t = J[b * n + e] * uu[0];
#pragma unroll
      for (int o = 1; o < OD; ++o) t += J[(o * D + b) * n + e] * uu[o];
      acc[b] += t;
    }
  }
};

// One block per segment, for long segments (cameras: thousands of edges
// each).  Threads stride over the segment's edges, each keeping its F
// partial sums in registers; a warp-shuffle tree and a fixed-order sum
// over the warps' shared-memory partials finish the segment.
template <typename T, class Rows>
__global__ void __launch_bounds__(kBlock)
reduce_block_per_segment(Rows rows, const int64_t* __restrict__ seg_ptr,
                         T* __restrict__ out, int64_t num_segments) {
  constexpr int F = Rows::F;
  __shared__ T partial[kWarps][F];
  const int64_t s = blockIdx.x;
  const int64_t lo = seg_ptr[s];
  const int64_t hi = seg_ptr[s + 1];
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
    out[f * num_segments + s] = v;
  }
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
  for (int f = 0; f < F; ++f) out[f * num_segments + s] = acc[f];
}

// One thread per edge slot: gather the segment's D-row vertex vector and
// take the OD x D per-edge matvec u = J_e x[seg(e)].
template <typename T, int OD, int D>
__global__ void __launch_bounds__(kBlock)
expand_matvec(const T* __restrict__ table, const T* __restrict__ J,
              const int32_t* __restrict__ seg, T* __restrict__ u, int64_t n,
              int64_t num_segments) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (e >= n) return;
  const int64_t s = seg[e];
  T x[D];
#pragma unroll
  for (int a = 0; a < D; ++a) x[a] = table[a * num_segments + s];
#pragma unroll
  for (int o = 0; o < OD; ++o) {
    T t = J[(o * D) * n + e] * x[0];
#pragma unroll
    for (int a = 1; a < D; ++a) t += J[(o * D + a) * n + e] * x[a];
    u[o * n + e] = t;
  }
}

constexpr int64_t kMaxGrid = 2147483647;

template <typename T, class Rows>
int launch_reduce(Rows rows, const int64_t* seg_ptr, T* out,
                  int64_t num_segments, int per_thread, cudaStream_t stream) {
  if (num_segments == 0) return static_cast<int>(cudaSuccess);
  if (per_thread) {
    const int64_t grid = (num_segments + kBlock - 1) / kBlock;
    if (grid > kMaxGrid) return static_cast<int>(cudaErrorInvalidConfiguration);
    reduce_thread_per_segment<T, Rows>
        <<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
            rows, seg_ptr, out, num_segments);
  } else {
    if (num_segments > kMaxGrid) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    reduce_block_per_segment<T, Rows>
        <<<static_cast<unsigned>(num_segments), kBlock, 0, stream>>>(
            rows, seg_ptr, out, num_segments);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int jtj_typed(int od, int d, const void* J, const void* r,
              const int64_t* seg_ptr, void* out, int64_t n,
              int64_t num_segments, int per_thread, cudaStream_t stream) {
  const T* Jt = static_cast<const T*>(J);
  const T* rt = static_cast<const T*>(r);
  T* o = static_cast<T*>(out);
  if (od == 2 && d == 9) {
    return launch_reduce<T>(JtjRows<T, 2, 9>{Jt, rt, n}, seg_ptr, o,
                            num_segments, per_thread, stream);
  }
  if (od == 2 && d == 3) {
    return launch_reduce<T>(JtjRows<T, 2, 3>{Jt, rt, n}, seg_ptr, o,
                            num_segments, per_thread, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int reduce_typed(int od, int d, const void* J, const void* u,
                 const int64_t* seg_ptr, void* out, int64_t n,
                 int64_t num_segments, int per_thread, cudaStream_t stream) {
  const T* Jt = static_cast<const T*>(J);
  const T* ut = static_cast<const T*>(u);
  T* o = static_cast<T*>(out);
  if (od == 2 && d == 9) {
    return launch_reduce<T>(JtuRows<T, 2, 9>{Jt, ut, n}, seg_ptr, o,
                            num_segments, per_thread, stream);
  }
  if (od == 2 && d == 3) {
    return launch_reduce<T>(JtuRows<T, 2, 3>{Jt, ut, n}, seg_ptr, o,
                            num_segments, per_thread, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int OD, int D>
int launch_expand(const void* table, const void* J, const int32_t* seg,
                  void* u, int64_t n, int64_t num_segments,
                  cudaStream_t stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t grid = (n + kBlock - 1) / kBlock;
  if (grid > kMaxGrid) return static_cast<int>(cudaErrorInvalidConfiguration);
  expand_matvec<T, OD, D><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const T*>(J), seg,
      static_cast<T*>(u), n, num_segments);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int expand_typed(int od, int d, const void* table, const void* J,
                 const int32_t* seg, void* u, int64_t n, int64_t num_segments,
                 cudaStream_t stream) {
  if (od == 2 && d == 9) {
    return launch_expand<T, 2, 9>(table, J, seg, u, n, num_segments, stream);
  }
  if (od == 2 && d == 3) {
    return launch_expand<T, 2, 3>(table, J, seg, u, n, num_segments, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Negated code of an error already pending before a launch, or 0.
int pending_error() {
  return -static_cast<int>(cudaPeekAtLastError());
}

}  // namespace

extern "C" {

// out [d*d + d, nS] = per segment: sum_e J_e^T J_e rows, then -sum_e J_e^T r_e.
int megba_jtj_grad_reduce(int is_double, int od, int d, const void* J,
                          const void* r, const int64_t* seg_ptr, void* out,
                          int64_t n, int64_t num_segments, int per_thread,
                          void* stream) {
  if (const int prior = pending_error()) return prior;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? jtj_typed<double>(od, d, J, r, seg_ptr, out, n,
                                       num_segments, per_thread, st)
                   : jtj_typed<float>(od, d, J, r, seg_ptr, out, n,
                                      num_segments, per_thread, st);
}

// u [od, n] = per edge: J_e table[:, seg(e)].
int megba_coupling_expand(int is_double, int od, int d, const void* table,
                          const void* J, const int32_t* seg, void* u,
                          int64_t n, int64_t num_segments, void* stream) {
  if (const int prior = pending_error()) return prior;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? expand_typed<double>(od, d, table, J, seg, u, n,
                                          num_segments, st)
                   : expand_typed<float>(od, d, table, J, seg, u, n,
                                         num_segments, st);
}

// out [d, nS] = per segment: sum_e J_e^T u_e.
int megba_coupling_reduce(int is_double, int od, int d, const void* J,
                          const void* u, const int64_t* seg_ptr, void* out,
                          int64_t n, int64_t num_segments, int per_thread,
                          void* stream) {
  if (const int prior = pending_error()) return prior;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? reduce_typed<double>(od, d, J, u, seg_ptr, out, n,
                                          num_segments, per_thread, st)
                   : reduce_typed<float>(od, d, J, u, seg_ptr, out, n,
                                         num_segments, per_thread, st);
}

const char* megba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
