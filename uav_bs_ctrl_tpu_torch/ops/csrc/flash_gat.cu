// GATv2 attention over pre-projected sources for Hopper (sm_90a), inference only.
//
// Replaces the TPU kernel uav_bs_ctrl_tpu/ops/pallas_kernels.py:flash_gat (:138; body
// _flash_gat_kernel, :73), the gat_backend='pallas' path of the encoder. For each
// destination row n, with el[n, j] = W_src x_j + b projected before the call:
//
//   s[j, h] = attn[h] . LeakyReLU(el[n, j] + er[n])[h]   (per head, over F features)
//   out[n]  = sum_j softmax_j(s[:, h]) * el[n, j]          (over the valid slots j)
//
// A row with no valid slot gives exactly 0.
//
// What bounds it: reading the valid slots' rows of el once (a masked slot does not reach
// the output) at 3.35 TB/s; the arithmetic, about 7 operations an element, is far below
// the f32 peak. Serving the 4-UBS policy over 40 worlds (N = 160, M = 50 GT slots, H*F =
// 4*64) that is about 0.0010 ms at step 25 of the episode (38 % of the slots valid) and
// 0.00014 ms at step 0 (1.3 %): less than a launch.
//
// What the first design lost (this file up to commit a9537c2): one CTA a row, one thread
// a column, walking every slot masked or not (8.2 MB of el at N = 160, M = 50), with two
// block barriers, 16 shuffle sums written to shared memory and a sum over the head's
// warps for each 16-slot chunk: 0.0144 ms a call, whatever the share of valid slots.
//
// Design, as #2's (flash_gat_common.cuh): a CTA of H warps takes a row, warp h head h.
// Lane L holds the head's columns h*F + L + 32c for c < ceil(F/32), guarded by
// L + 32c < F: a lane beyond F holds zeros of er, attn and el, adds exactly 0 to every
// score and stores nothing, so any F works. The warp lists its row's valid slots with
// ballots (kMaxChunk at a time, in its own shared memory) and walks them once, in blocks
// of S (4 at F = 64): the next block's el slices are loaded (a whole 128-byte line a warp
// when F >= 32) while this block's S scores, S independent butterflies, run; the softmax
// is online in registers: l and acc are rescaled once a block by exp(m_old - m_new),
// which is exactly 0 while m_old is -1e30, before p = exp(s - m_new) and p * el are
// added. At the end out = acc / max(l, 1e-30): 0 for a row with no valid slot. There is
// no block barrier, and a head's scores and statistics never leave its warp. This is the
// JAX kernel's online softmax over the TPU's sequential M grid axis, carried over blocks
// of valid slots inside a warp; el is read once, not twice as #2's exact two passes
// would. Small blocks keep a lane at 56 registers, so that 9 CTAs of 4 warps fit an SM
// when N is large. On an H100 at 700 W, in turns: blocks of 16 slots (114 registers, 4
// CTAs an SM) took 0.0043 ms a call at N = 160 with 1 % of the slots valid and 0.029 at
// N = 2048 with 38 %, blocks of 4 without the prefetch 0.0033 and 0.021; the prefetch
// then took 0.0067 to 0.0054 ms at N = 160 with 38 %.

#include "flash_gat_common.cuh"

namespace {

// The lane's columns of el for the valid slots k0 .. k0 + S - 1 of the warp's list (zeros
// past cnt and beyond F).
template <int S, int CM>
__device__ __forceinline__ void load_block(const float* __restrict__ el_row, const int* s_list,
                                           int j0, int k0, int cnt, int HF, int col0,
                                           const bool (&live)[CM], float (&v)[S][CM]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool in = k0 + s < cnt;
    const float* row = el_row + (size_t)(j0 + (in ? s_list[k0 + s] : 0)) * HF + col0;
#pragma unroll
    for (int c = 0; c < CM; ++c) v[s][c] = in && live[c] ? row[32 * c] : 0.f;
  }
}

template <int CM, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads) flash_gat_rows(
    const float* __restrict__ el, const float* __restrict__ er, const float* __restrict__ attn,
    const float* __restrict__ mask, float* __restrict__ out, int M, int HF, int H, int chunk,
    float slope) {
  constexpr int S = CM >= 8 ? 1 : 8 / CM;          // valid slots a block: 8 el registers
  extern __shared__ float smem[];
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31, n = blockIdx.x;
  const int F = HF / H, col0 = h * F + lane;
  int* s_list = reinterpret_cast<int*>(smem) + (size_t)h * chunk;   // this warp's list
  const float* el_row = el + (size_t)n * M * HF;
  const float* mask_row = mask + (size_t)n * M;

  bool live[CM];
  float erl[CM], at[CM], acc[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    live[c] = lane + 32 * c < F;
    erl[c] = live[c] ? er[(size_t)n * HF + col0 + 32 * c] : 0.f;
    at[c] = live[c] ? attn[col0 + 32 * c] : 0.f;    // attn [H, F] is laid out as a row of HF
    acc[c] = 0.f;
  }

  float m = kNegBig, l = 0.f;
  for (int j0 = 0; j0 < M; j0 += chunk) {
    const int len = min(chunk, M - j0);
    float mv[kMaxChunk / 32];
    load_mask_words(mask_row, j0, len, lane, mv);
    __syncwarp();                                   // the warp is done with the last list
    const int cnt = list_valid(mv, len, s_list, lane);
    __syncwarp();
    float v[S][CM];
    load_block<S, CM>(el_row, s_list, j0, 0, cnt, HF, col0, live, v);
    for (int k0 = 0; k0 < cnt; k0 += S) {
      float nv[S][CM];                              // the next block's el, in flight meanwhile
      load_block<S, CM>(el_row, s_list, j0, k0 + S, cnt, HF, col0, live, nv);
      float sc[S], m_new = m;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          const float z = v[s][c] + erl[c];
          p = fmaf(z >= 0.f ? z : slope * z, at[c], p);
        }
        sc[s] = warp_sum(p);
        if (k0 + s < cnt) m_new = fmaxf(m_new, sc[s]);
      }
      const float scale = expf(m - m_new);          // 0 while m is -1e30
      l *= scale;
#pragma unroll
      for (int c = 0; c < CM; ++c) acc[c] *= scale;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (k0 + s < cnt) {
          const float p = expf(sc[s] - m_new);
          l += p;
#pragma unroll
          for (int c = 0; c < CM; ++c) acc[c] = fmaf(p, v[s][c], acc[c]);
        }
#pragma unroll
        for (int c = 0; c < CM; ++c) v[s][c] = nv[s][c];
      }
      m = m_new;
    }
  }
  const float inv = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < CM; ++c)
    if (live[c]) out[(size_t)n * HF + col0 + 32 * c] = acc[c] / inv;
}

template <int CM, int MaxThreads>
cudaError_t launch(const float* el, const float* er, const float* attn, const float* mask,
                   float* out, int N, int M, int HF, int H, float slope, cudaStream_t stream) {
  const int chunk = chunk_for(M, H, 1);
  const size_t smem = sizeof(int) * (size_t)H * chunk;
  auto kernel = flash_gat_rows<CM, MaxThreads>;
  cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<N, 32 * H, smem, stream>>>(el, er, attn, mask, out, M, HF, H, chunk, slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_gat_forward(const float* el, const float* er, const float* attn,
                                 const float* mask, float* out, int N, int M, int HF, int H,
                                 float slope, cudaStream_t stream) {
  if (H <= 0 || HF % H != 0) return cudaErrorInvalidValue;
  const int C = (HF / H + 31) / 32;                // columns a lane
  if (H * C * 32 > 1024) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
#define FG_ARGS el, er, attn, mask, out, N, M, HF, H, slope, stream
  if (H > 8)                                        // more than 256 threads: C is 1, 2 or 3
    return C <= 1 ? launch<1, 1024>(FG_ARGS)
                  : (C <= 2 ? launch<2, 1024>(FG_ARGS) : launch<4, 1024>(FG_ARGS));
  if (C > 8) return launch<32, 256>(FG_ARGS);
  if (C > 4) return launch<8, 256>(FG_ARGS);
  if (C > 2) return launch<4, 256>(FG_ARGS);
  if (C > 1) return launch<2, 256>(FG_ARGS);        // the runs' F = 64
  return launch<1, 256>(FG_ARGS);
#undef FG_ARGS
}

extern "C" const char* flash_gat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
