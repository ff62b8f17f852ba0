// Segment-reduction machinery shared by the port's CUDA sources
// (segtiles.cu, fused.cu).  Included into each source, so every shared
// library carries its own copy; ops/kernels.py hashes this header into
// each library's name, so editing it rebuilds both.
//
// A "Rows" functor describes what one edge slot adds to its segment's
// F partial sums (`static constexpr int F` and
// `__device__ void add(int64_t slot, T* acc) const`).  The two launch
// shapes below walk the CSR offsets seg_ptr[nS + 1] of a segment-sorted
// slot stream and write out[f * nS + s].
//
// Determinism: no atomics.  A segment's sum is formed by one thread, or
// by one block with a fixed strided split, a fixed warp-shuffle tree and
// a fixed sum over warps, so for a given launch shape the output is
// bitwise-reproducible from run to run.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int64_t kMaxGrid = 2147483647;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

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

// Negated code of an error already pending before a launch, or 0.
int pending_error() {
  return -static_cast<int>(cudaPeekAtLastError());
}

}  // namespace
