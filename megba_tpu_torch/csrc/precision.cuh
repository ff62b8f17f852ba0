// Precision arms shared by the port's CUDA sources (segtiles.cu, fused.cu):
// the arm codes and the per-product arithmetic of each arm.  Included into
// each source; ops/kernels.py hashes this header into each library's name,
// so editing it rebuilds both.
//
// The contract is the JAX package's: `_edge_precision`
// (megba_tpu/solver/pcg.py:133-163) on the unfused products,
// `_contract_rows` / `_acc_dtype` (megba_tpu/ops/fused.py:321-384) in the
// fused kernels.  The accumulator and output type T is float or double;
// the stored rows have type R:
//   kF32 / kF64  R = T: float x float or double x double products;
//   kMixed       R = __nv_bfloat16, T = float: each row value is upcast
//                and the product taken in float
//                (ProblemOption.mixed_precision_pcg);
//   kMixed64     R = __nv_bfloat16, T = double: the same beside a double
//                table, products and sums in double (mixed_precision_pcg
//                at float64: the upcast bf16 value is exact in float and
//                in double);
//   kBf16        R = __nv_bfloat16, T = float: the vector operand (the
//                gathered table value, an intermediate u) is rounded to
//                bf16 and every product row * x is rounded to bf16 once,
//                then upcast (SolverOption.bf16).  The float product of
//                two bf16 values is exact, so __fmul_rn followed by
//                __float2bfloat16_rn rounds exactly once, as a bf16
//                multiply does; __fmul_rn is never contracted into an FMA.
// Within a slot, sums are taken in ascending index order starting from the
// first term; in the bf16 arm no product can be contracted into an FMA, so
// every per-slot term is bitwise the plain PyTorch version's and only the
// segment-sum order differs.

#pragma once

#include <cuda_bf16.h>

namespace {

// Arm codes, shared with ops/kernels.py (`ARMS`).
enum Arm : int { kF32 = 0, kF64 = 1, kMixed = 2, kBf16 = 3, kMixed64 = 4 };

__device__ __forceinline__ float upcast(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float upcast(float v) { return v; }
__device__ __forceinline__ double upcast(double v) { return v; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The vector operand of a product: rounded to bf16 in the bf16 arm.
template <bool BF16, typename T>
__device__ __forceinline__ T operand(T v) {
  if constexpr (BF16) {
    return round_bf16(v);
  } else {
    return v;
  }
}

// One product row * x in the arm's arithmetic.
template <bool BF16, typename T, typename R>
__device__ __forceinline__ T product(R row, T x) {
  if constexpr (BF16) {
    return round_bf16(__fmul_rn(upcast(row), x));
  } else {
    return static_cast<T>(upcast(row)) * x;
  }
}

}  // namespace
