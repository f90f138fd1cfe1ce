// What the GATv2 kernels flash_gat.cu (#1), flash_gat_fused.cu (#2) and
// flash_gat_fused_bwd.cu (#3) share: one warp a (destination row, head).
//
// A CTA has one warp per head (H warps) and takes a destination row; warp h computes
// head h. Lane L holds the head's columns col = h*F + L + 32c (c < C = F/32), so that
// every load and store of a row of HF floats is a whole 128-byte line a warp, and a
// (slot, head) sum is one 5-step butterfly over the warp. The warp copies the row's x
// into its own shared memory and turns the mask into its own ordered list of the valid
// slots (__ballot_sync/__popc over 32-slot words), so masked slots cost nothing and no
// warp waits for another: the forward has no block barrier at all.
//
// Why this layout (clock64 inside the kernels on an H100 at 700 W, 256 CTAs of 128
// threads): at these sizes a call is a chain of latencies, not arithmetic. A block
// barrier took about 400 cycles, a device-memory round trip about 550, each step of a
// dependent load-then-store chain about 300, and 40 loads a lane at a 32-byte lane
// stride (a lane's slice of 8 contiguous columns) 3,300, against 1,100 for 8 coalesced
// ones. Splitting a row's slots over the warps of a CTA needed a barrier for every
// exchange (the max, the sums) and strided loads; one warp per head needs neither.
//
// No atomics anywhere: a repeated call is bit-identical. The helpers take their tensor
// operands in a storage type T (storage.cuh: float or __nv_bfloat16) and widen each load
// to f32; the staging areas in shared memory and the registers are f32.

#pragma once
#include <cuda_runtime.h>

#include "storage.cuh"

namespace {

constexpr int kMaxChunk = 256;        // slots staged at a time (8 mask words)
constexpr int kMaxD = 8;              // source features, as the wrapper checks
constexpr float kNegBig = -1e30f;     // the masked score; a max below kNegBig/2 shifts by 0
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStageBatch = 8;        // x loads a lane keeps in flight while staging
constexpr int kSmemBudget = 48 * 1024;   // bytes of the warps' staging areas together

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The lane's C columns of a row of HF values, in f32 (zero beyond C).
template <int CM, class T>
__device__ __forceinline__ void row_slice(const T* __restrict__ row, int col0, int C,
                                          float (&v)[CM]) {
#pragma unroll
  for (int c = 0; c < CM; ++c) v[c] = c < C ? to_f32(row[col0 + 32 * c]) : 0.f;
}

// The lane's register slice of W (DM x CM), b and attn: zero beyond C and D, so padded
// columns and features add exactly 0.
template <int CM, int DM>
struct HeadSlice {
  float w[DM][CM], b[CM], attn[CM];

  template <class T>
  __device__ __forceinline__ void load(const T* __restrict__ w_g, const T* __restrict__ b_g,
                                       const T* __restrict__ attn_g, int col0, int C, int D,
                                       int HF) {
#pragma unroll
    for (int d = 0; d < DM; ++d) {
      if (d < D) {
        row_slice<CM>(w_g + (size_t)d * HF, col0, C, w[d]);
      } else {
#pragma unroll
        for (int c = 0; c < CM; ++c) w[d][c] = 0.f;
      }
    }
    row_slice<CM>(b_g, col0, C, b);
    row_slice<CM>(attn_g, col0, C, attn);    // attn [H, F] is laid out as a row of HF
  }

  // el = x W + b of the lane's columns for one slot's features xd.
  __device__ __forceinline__ void project(const float* xd, float (&el)[CM]) const {
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      float v = b[c];
#pragma unroll
      for (int d = 0; d < DM; ++d) v = fmaf(xd[d], w[d][c], v);
      el[c] = v;
    }
  }
};

// The lane's mask entries of slots [j0, j0 + len), len <= kMaxChunk: word w holds slot
// w * 32 + lane (0 beyond len).
template <class T>
__device__ __forceinline__ void load_mask_words(const T* __restrict__ mask_row, int j0, int len,
                                                int lane, float (&mv)[kMaxChunk / 32]) {
#pragma unroll
  for (int w = 0; w < kMaxChunk / 32; ++w) {
    const int j = w * 32 + lane;
    mv[w] = j < len ? to_f32(mask_row[j0 + j]) : 0.f;
  }
}

// The chunk positions of the valid slots (mask > 0), in order, into the warp's s_list
// (__ballot_sync/__popc a mask word); returns their count (the same in every lane). The
// caller __syncwarp()s before the list is read.
__device__ __forceinline__ int list_valid(const float (&mv)[kMaxChunk / 32], int len,
                                          int* s_list, int lane) {
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < kMaxChunk / 32; ++w) {
    if (w * 32 >= len) break;                      // uniform over the warp
    const bool valid = mv[w] > 0.f;
    const unsigned bits = __ballot_sync(kFull, valid);
    if (valid) s_list[cnt + __popc(bits & ((1u << lane) - 1u))] = w * 32 + lane;
    cnt += __popc(bits);
  }
  return cnt;
}

// The warp stages slots [j0, j0 + len) of its row: x into s_x [len, DM] in f32 (zero-padded
// beyond D) and the valid slots' chunk positions, in order, into s_list. Returns their
// count (the same in every lane).
template <int DM, class T>
__device__ __forceinline__ int stage_chunk(const T* __restrict__ x_row,
                                           const T* __restrict__ mask_row, int j0, int len,
                                           int D, float* s_x, int* s_list, int lane) {
  float mv[kMaxChunk / 32];
  load_mask_words(mask_row, j0, len, lane, mv);
  __syncwarp();                                    // the warp is done with the last chunk
  for (int i0 = 0; i0 < len * DM; i0 += 32 * kStageBatch) {
    float v[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int i = i0 + 32 * k + lane, j = i / DM, d = i % DM;
      v[k] = i < len * DM && d < D ? to_f32(x_row[(size_t)(j0 + j) * D + d]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int i = i0 + 32 * k + lane;
      if (i < len * DM) s_x[i] = v[k];
    }
  }
  const int cnt = list_valid(mv, len, s_list, lane);
  __syncwarp();
  return cnt;
}

// Slots staged per chunk: a whole number of mask words, at most kMaxChunk, and few
// enough that the H warps' staging areas of `per_slot` floats a slot fit kSmemBudget.
inline int chunk_for(int M, int H, int per_slot) {
  const int words = (M + 31) / 32;
  int chunk = words == 0 ? 32 : (words * 32 < kMaxChunk ? words * 32 : kMaxChunk);
  const int fit = kSmemBudget / (4 * H * per_slot) / 32 * 32;
  if (chunk > fit) chunk = fit < 32 ? 32 : fit;
  return chunk;
}

// D rounded up to the register width DM the kernels are instantiated for.
inline int dm_for(int D) { return D <= 2 ? 2 : (D <= 4 ? 4 : kMaxD); }

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
