// The storage types of the kernels' tensor operands and outputs: float or __nv_bfloat16.
//
// Every kernel of #2-#5 is a template on its storage type T. A load widens to f32
// (to_f32), every softmax, row statistic, GRU gate, sum and cross-CTA partial is f32, and
// so is every scratch buffer; a store rounds to T to nearest even (from_f32). With T =
// float both are the identity. The products run on the tensor cores with f32 sums in the
// step kernels (#4/#5, tarmac_step_common.cuh: f32 operands as 3xTF32, each split into two
// tf32 parts, bf16 operands as they are, an f32 scratch operand of a bf16 call as a bf16
// hi/lo pair) and in #2/#3's slot tiles (flash_gat_tile.cuh: tf32, a bf16 operand exact in
// one pass, an f32 one split); they are f32 FMAs in #1 and in #2/#3's warp-per-(row, head)
// body.

#pragma once
#include <cuda_bf16.h>
#include <cstring>
#include <type_traits>

namespace {

__device__ __forceinline__ unsigned float_bits(float v) {
  unsigned u;
  memcpy(&u, &v, sizeof u);
  return u;
}

__device__ __forceinline__ float bits_float(unsigned u) {
  float v;
  memcpy(&v, &u, sizeof v);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

}  // namespace
