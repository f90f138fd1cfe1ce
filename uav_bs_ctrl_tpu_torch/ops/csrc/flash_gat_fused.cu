// Projection-fused GATv2 attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel uav_bs_ctrl_tpu/ops/pallas_kernels.py:flash_gat_fused (:329;
// body _flash_gat_fused_kernel, :192). For each destination row n:
//
//   el[j]   = x[n, j, :] @ W + b                      (projected in-kernel, never stored)
//   s[j, h] = attn[h] . LeakyReLU(el[j] + er[n])[h]  (per head, over F features)
//   out[n]  = sum_j softmax_j(s[:, h]) * el[j]        (over the valid slots j)
//
// plus the f32 row statistics m[n, h] (the max) and l[n, h] (the denominator) that the
// backward rebuilds alpha from. All-masked rows give out = 0, m = -1e30 and l = 0: the
// shift is 0 when the max is <= -1e30/2 and the denominator is max(l, 1e-30).
//
// What bounds it: at the update's inputs (N = 256 rows, M = 50 or 7 slots, D = 4 or 2,
// H*F = 4*64) about (2D+7)*HF f32 operations per valid slot: 0.28 and 0.17 us on an
// H100 at 67 TFLOP/s and 3.35 TB/s, far less than one launch. What a call costs is the
// latency of its chain of dependent steps.
//
// What the first design lost (this file up to commit 70ab6d5): one CTA a row, one thread a
// column, walking the row's slots one at a time, masked or not, each slot a 5-step shuffle, a
// barrier and a sum over the head's warps, then the valid ones again for an online
// softmax carried over 32-slot chunks from the TPU's sequential grid axis: 0.45 us a
// slot, 0.024 ms a call at the update's 'seen' inputs.
//
// Design (flash_gat_common.cuh): a CTA of H warps a row (256 CTAs of 4 warps at
// training's N = 256, 320 when serving 40 worlds); warp h takes head h, compacts the
// row's valid slots and walks them twice, the softmax exact in two passes:
//   1. scores: per valid slot a lane projects its F/32 columns (D FMAs each), the
//      head's score is one butterfly over the warp, into the warp's table; the max in
//      registers, four slots in flight;
//   2. p = exp(s - shift) from the table, l = sum p and out = sum p * el / max(l,
//      1e-30), el recomputed, in registers.
// A row of more slots than a chunk holds is staged in chunks: pass 1 takes the max over
// every chunk, pass 2 recomputes each chunk's scores, so the softmax stays exact.

#include "flash_gat_common.cuh"

namespace {

// The head's scores of the warp's staged slots into s_sc, and their max into m.
template <int CM, int DM>
__device__ __forceinline__ void chunk_scores(const HeadSlice<CM, DM>& sl, const float (&er)[CM],
                                             const float* s_x, const int* s_list, int cnt,
                                             float slope, float* s_sc, int lane, float& m) {
#pragma unroll 4
  for (int k = 0; k < cnt; ++k) {
    float el[CM];
    sl.project(s_x + s_list[k] * DM, el);
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      const float z = el[c] + er[c];
      v = fmaf(z >= 0.f ? z : slope * z, sl.attn[c], v);
    }
    v = warp_sum(v);
    if (lane == 0) s_sc[k] = v;
    m = fmaxf(m, v);
  }
}

template <int CM, int DM, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads) flash_gat_fused_fwd_rows(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ er, const float* __restrict__ attn, const float* __restrict__ mask,
    float* __restrict__ out, float* __restrict__ mstat, float* __restrict__ lstat, int M,
    int D, int HF, int H, int chunk, float slope) {
  extern __shared__ float smem[];
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31, n = blockIdx.x;
  const int F = HF / H, C = F / 32, col0 = h * F + lane;
  float* s_x = smem + (size_t)h * chunk * (DM + 2);         // this warp's [chunk, DM]
  float* s_sc = s_x + chunk * DM;                             // its scores [chunk]
  int* s_list = reinterpret_cast<int*>(s_sc + chunk);         // its valid slots [chunk]
  const float* x_row = x + (size_t)n * M * D;
  const float* mask_row = mask + (size_t)n * M;

  HeadSlice<CM, DM> sl;
  sl.load(w, b, attn, col0, C, D, HF);
  float erl[CM];
  row_slice<CM>(er + (size_t)n * HF, col0, C, erl);

  float m = kNegBig;
  int cnt = 0;
  for (int j0 = 0; j0 < M; j0 += chunk) {         // 1. scores and the max
    cnt = stage_chunk<DM>(x_row, mask_row, j0, min(chunk, M - j0), D, s_x, s_list, lane);
    chunk_scores<CM, DM>(sl, erl, s_x, s_list, cnt, slope, s_sc, lane, m);
  }
  const float shift = m <= kNegBig / 2 ? 0.f : m;

  float l = 0.f, acc[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) acc[c] = 0.f;
  for (int j0 = 0; j0 < M; j0 += chunk) {         // 2. p, l and sum p * el
    if (M > chunk) {                              // the table holds the last chunk only
      float unused = kNegBig;
      cnt = stage_chunk<DM>(x_row, mask_row, j0, min(chunk, M - j0), D, s_x, s_list, lane);
      chunk_scores<CM, DM>(sl, erl, s_x, s_list, cnt, slope, s_sc, lane, unused);
    }
    __syncwarp();                                 // lane 0's table entries are written
#pragma unroll 4
    for (int k = 0; k < cnt; ++k) {
      const float p = expf(s_sc[k] - shift);
      l += p;
      float el[CM];
      sl.project(s_x + s_list[k] * DM, el);
#pragma unroll
      for (int c = 0; c < CM; ++c) acc[c] = fmaf(p, el[c], acc[c]);
    }
  }
  const float inv = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < CM; ++c)
    if (c < C) out[(size_t)n * HF + col0 + 32 * c] = acc[c] / inv;
  if (lane == 0) {
    mstat[(size_t)n * H + h] = m;
    lstat[(size_t)n * H + h] = l;
  }
}

template <int CM, int DM, int MaxThreads>
cudaError_t launch_forward(const float* x, const float* w, const float* b, const float* er,
                           const float* attn, const float* mask, float* out, float* mstat,
                           float* lstat, int N, int M, int D, int HF, int H, float slope,
                           cudaStream_t stream) {
  const int chunk = chunk_for(M, H, DM + 2);
  const size_t smem = sizeof(float) * (size_t)H * chunk * (DM + 2);
  auto kernel = flash_gat_fused_fwd_rows<CM, DM, MaxThreads>;
  cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<N, 32 * H, smem, stream>>>(x, w, b, er, attn, mask, out, mstat, lstat, M, D, HF, H,
                                      chunk, slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_gat_fused_forward(
    const float* x, const float* w, const float* b, const float* er, const float* attn,
    const float* mask, float* out, float* mstat, float* lstat,
    int N, int M, int D, int HF, int H, float slope, cudaStream_t stream) {
  if (D > kMaxD || HF % 32 != 0 || HF > 1024 || H <= 0 || HF % H != 0 || (HF / H) % 32 != 0)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const int C = HF / H / 32;                      // columns a lane
#define FGF_ARGS x, w, b, er, attn, mask, out, mstat, lstat, N, M, D, HF, H, slope, stream
  if (H > 8)                                      // more than 256 threads: F is 32, 64 or 96
    return C <= 2 ? launch_forward<2, kMaxD, 1024>(FGF_ARGS)
                  : launch_forward<4, kMaxD, 1024>(FGF_ARGS);
  if (C > 8) return launch_forward<32, kMaxD, 256>(FGF_ARGS);
  if (C > 4) return launch_forward<8, kMaxD, 256>(FGF_ARGS);
  if (C > 2) return launch_forward<4, kMaxD, 256>(FGF_ARGS);
  switch (dm_for(D)) {                            // the runs' F = 64: two columns a lane
    case 2: return launch_forward<2, 2, 256>(FGF_ARGS);
    case 4: return launch_forward<2, 4, 256>(FGF_ARGS);
    default: return launch_forward<2, kMaxD, 256>(FGF_ARGS);
  }
#undef FGF_ARGS
}

extern "C" const char* flash_gat_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
