// Segment kernels of the Schur solve path, hand-written for Hopper (sm_90a).
// Built by megba_tpu_torch/ops/kernels.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes; the Python wrappers live in
// megba_tpu_torch/ops/segtiles.py.
//
// They replace five Pallas kernels of the JAX package
// (megba_tpu/ops/segtiles.py):
//
//   megba_jtj_grad_reduce  <- _jtj_kernel            (body :404, pallas_call :469)
//   megba_coupling_expand  <- _expand_matvec_kernel  (body :577, pallas_call :624)
//   megba_coupling_reduce  <- _matvec_reduce_kernel  (body :632, pallas_call :688)
//   megba_seg_reduce       <- _reduce_kernel         (body :238, pallas_call :279)
//   megba_seg_expand       <- _expand_kernel         (body :305, pallas_call :336)
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
// (segreduce.cuh: one 256-thread block per camera, one thread per point).
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
// Every entry point first peeks at the CUDA error state: an error left
// by an earlier launch (of any kernel) is returned negated, without
// launching, so the wrapper does not report it as its own.  Otherwise it
// returns cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for a block shape it was not built for; the
// Python wrapper raises on any non-zero code.

#include "segreduce.cuh"

namespace {

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

// Per-edge rows of the data itself (F values): the plain segment sum.
template <typename T, int F_>
struct SumRows {
  static constexpr int F = F_;
  const T* __restrict__ data;  // [F, n]
  int64_t n;

  __device__ __forceinline__ void add(int64_t e, T* acc) const {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += data[f * n + e];
  }
};

template <typename T>
int seg_reduce_typed(int F, const void* data, const int64_t* seg_ptr,
                     void* out, int64_t n, int64_t num_segments,
                     int per_thread, cudaStream_t stream) {
  const T* dt = static_cast<const T*>(data);
  T* o = static_cast<T*>(out);
  if (F == 9) {
    return launch_reduce<T>(SumRows<T, 9>{dt, n}, seg_ptr, o, num_segments,
                            per_thread, stream);
  }
  if (F == 3) {
    return launch_reduce<T>(SumRows<T, 3>{dt, n}, seg_ptr, o, num_segments,
                            per_thread, stream);
  }
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
  if (F == 9) {
    return launch_seg_expand<T, 9>(table, seg, out, n, num_segments, stream);
  }
  if (F == 3) {
    return launch_seg_expand<T, 3>(table, seg, out, n, num_segments, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// out [F, nS] = per segment: the sum of its slots' F-value rows.
int megba_seg_reduce(int is_double, int F, const void* data,
                     const int64_t* seg_ptr, void* out, int64_t n,
                     int64_t num_segments, int per_thread, void* stream) {
  if (const int prior = pending_error()) return prior;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? seg_reduce_typed<double>(F, data, seg_ptr, out, n,
                                              num_segments, per_thread, st)
                   : seg_reduce_typed<float>(F, data, seg_ptr, out, n,
                                             num_segments, per_thread, st);
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
