// The warp-level tensor-core instructions the products use, one named function each; no
// other source writes inline PTX.
//
//   mma_bf16_16816   D[16x8] += A[16x16] B[16x8], bf16 operands, f32 sums
//                    (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32)
//   mma_tf32_1688    D[16x8] += A[16x8] B[8x8], tf32 operands (an f32's sign, exponent and
//                    top 10 mantissa bits; the low 13 are not read), f32 sums
//                    (mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32; HMMA.1688.F32.TF32)
//   mma_tf32_1684    D[16x8] += A[16x4] B[4x8], the same with a depth of 4
//                    (mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32; HMMA.1684.F32.TF32)
//   to_tf32          an f32 rounded to tf32, to nearest with ties away from zero, its low 13
//                    bits cleared (cvt.rna.tf32.f32)
//   ldmatrix<N, T>   N (1, 2 or 4) 8x8 matrices of 16-bit values from shared memory into
//                    fragments, transposed with T (ldmatrix.sync.aligned.m8n8.xN[.trans])
//   cp_async_16      a 16-byte copy from global to shared memory that does not block
//                    (cp.async.cg), cp_async_commit / cp_async_wait<N> group and await them
//   cp_async_4       the same for one 4-byte word, of which the first `bytes` (1 to 4) are
//                    read and the rest zero-filled (cp.async.ca with a source size)
//
// Fragment layouts (the PTX ISA's, lane l, g = l / 4, t = l % 4). m16n8k16 bf16: each 32-bit
// register holds two 16-bit values, the lower column or row first:
//   A  a[0] (row g, cols 2t, 2t+1)  a[1] (row g+8, same)  a[2] (row g, cols 2t+8, +9)
//      a[3] (row g+8, cols 2t+8, +9)
//   B  b[0] (rows 2t, 2t+1, col g)  b[1] (rows 2t+8, 2t+9, col g)
//   D  d[0], d[1] (row g, cols 2t, 2t+1)  d[2], d[3] (row g+8, same)
// m16n8k8 tf32: each register one value; D as m16n8k16's:
//   A  a[0] (row g, col t)  a[1] (row g+8, col t)  a[2] (row g, col t+4)  a[3] (row g+8, col t+4)
//   B  b[0] (row t, col g)  b[1] (row t+4, col g)
// m16n8k4 tf32: A  a[0] (row g, col t)  a[1] (row g+8, col t);  B  b[0] (row t, col g)
// ldmatrix: lanes 8i..8i+7 give the addresses of the 8 rows (16 bytes each, 16-byte aligned)
// of matrix i; register i of lane l receives row g, cols 2t, 2t+1 of matrix i, or with
// .trans rows 2t, 2t+1 of col g. All 32 lanes of the warp execute each of them together.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const unsigned (&a)[4],
                                              const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32_1684(float (&d)[4], const unsigned (&a)[2],
                                              const unsigned (&b)[1]) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b[0]));
}

// The bits of v rounded to tf32.
__device__ __forceinline__ unsigned to_tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

template <int N, bool Trans>
__device__ __forceinline__ void ldmatrix(unsigned (&r)[N], const void* row) {
  static_assert(N == 1 || N == 2 || N == 4, "ldmatrix loads 1, 2 or 4 matrices");
  const unsigned p = shared_address(row);
  if constexpr (N == 4 && Trans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(p) : "memory");
  } else if constexpr (N == 4) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(p) : "memory");
  } else if constexpr (N == 2 && Trans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(p) : "memory");
  } else if constexpr (N == 2) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(p) : "memory");
  } else if constexpr (Trans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
                 : "=r"(r[0]) : "r"(p) : "memory");
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
                 : "=r"(r[0]) : "r"(p) : "memory");
  }
}

__device__ __forceinline__ void cp_async_16(void* shared, const void* global) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(shared_address(shared)), "l"(global) : "memory");
}

__device__ __forceinline__ void cp_async_4(void* shared, const void* global, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(shared_address(shared)), "l"(global), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace
