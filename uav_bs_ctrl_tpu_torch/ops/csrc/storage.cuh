// The storage types of the kernels' tensor operands and outputs: float or __nv_bfloat16.
//
// Every kernel of #2-#5 is a template on its storage type T. A load widens to f32
// (to_f32), every product, softmax, row statistic, GRU gate and cross-CTA partial is
// f32, and so is every scratch buffer; a store rounds to T to nearest even (from_f32).
// With T = float both are the identity, so the f32 instantiations compute what the
// kernels computed before they were templated, bit for bit.

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
