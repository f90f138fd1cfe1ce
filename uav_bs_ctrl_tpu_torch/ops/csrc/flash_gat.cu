// GATv2 attention over pre-projected sources for Hopper (sm_90a), inference only.
//
// Replaces the TPU kernel uav_bs_ctrl_tpu/ops/pallas_kernels.py:flash_gat (body
// _flash_gat_kernel), the gat_backend='pallas' path of the encoder. For each
// destination row n, with el[n, j] = W_src x_j + b projected before the call:
//
//   s[j, h] = attn[h] . LeakyReLU(el[n, j] + er[n])[h]   (per head, over F features)
//   out[n]  = sum_j softmax_j(s[:, h]) * el[n, j]          (masked, online over slot chunks)
//
// All-masked rows give exactly 0: the running max starts at -1e30, the shift is 0
// while it is <= -1e30/2, masked slots add nothing and the denominator is
// max(l, 1e-30).
//
// Design. One CTA per destination row, one thread per output column. Each head is
// padded to whole warps (blockDim = H * ceil(F/32) * 32; padding threads hold zeros
// and store nothing), so every warp lies inside one head for any F. Per chunk of
// kChunk slots a thread loads its column of el once into registers (coalesced: a warp
// reads 128 consecutive bytes per slot), the per-head score of each slot is a
// warp-shuffle sum plus a fixed-order sum over the head's warps in shared memory, and
// the online softmax runs redundantly in every thread of the head. The Mosaic body's
// static head loop and broadcast-multiply reductions are TPU lowering limits and are
// not carried over.
// What bounds it: reading the valid slots' rows of el once (a masked row does not
// reach the output), at 3.35 TB/s; the arithmetic, about 8 operations per element, is
// far below the f32 peak. This first version reads every row, N*M*HF*4 bytes (8.2 MB
// at N=160, M=50, HF=256), and with one CTA per row and N of a few hundred the card is
// under-filled and the per-chunk syncs expose memory latency: skipping masked rows and
// tiling come later.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;          // slots per online-softmax chunk (el held in registers)
constexpr float kNegBig = -1e30f;

__global__ void flash_gat_fwd_kernel(
    const float* __restrict__ el, const float* __restrict__ er, const float* __restrict__ attn,
    const float* __restrict__ mask, float* __restrict__ out,
    int M, int HF, int F, int f_pad, float slope) {
  extern __shared__ float smem[];
  const int n_warps = blockDim.x >> 5;
  float* s_part = smem;                        // [kChunk, n_warps] per-warp score partials
  float* s_mask = s_part + kChunk * n_warps;   // [kChunk]

  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const int head = t / f_pad;
  const int f = t - head * f_pad;
  const bool active = f < F;
  const int col = head * F + f;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int warps_per_head = f_pad >> 5;
  const int first_warp = head * warps_per_head;

  const float er_t = active ? er[(size_t)n * HF + col] : 0.f;
  const float a_t = active ? attn[col] : 0.f;  // attn is [H, F] row-major: column col
  const float* el_n = el + (size_t)n * M * HF;
  const float* mask_n = mask + (size_t)n * M;

  float m_run = kNegBig, l_run = 0.f, acc = 0.f;
  float v[kChunk];
  float s[kChunk];
  for (int j0 = 0; j0 < M; j0 += kChunk) {
    const int tm = min(kChunk, M - j0);
    __syncthreads();                           // the previous chunk's readers are done
    if (t < kChunk) s_mask[t] = t < tm ? mask_n[j0 + t] : 0.f;
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj)
      v[jj] = (jj < tm && active) ? el_n[(size_t)(j0 + jj) * HF + col] : 0.f;
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      float e = v[jj] + er_t;
      e = e >= 0.f ? e : slope * e;
      float p = e * a_t;                       // 0 on padding threads
      for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) s_part[jj * n_warps + warp] = p;
    }
    __syncthreads();

    float m_blk = kNegBig;
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      float sc = kNegBig;
      if (jj < tm && s_mask[jj] > 0.f) {
        sc = 0.f;
        for (int k = 0; k < warps_per_head; ++k) sc += s_part[jj * n_warps + first_warp + k];
      }
      s[jj] = sc;
      m_blk = fmaxf(m_blk, sc);
    }
    const float m_new = fmaxf(m_run, m_blk);
    const float shift = m_new <= kNegBig / 2 ? 0.f : m_new;
    // Nothing valid seen yet: l and acc are 0, so the rescale is 0 (never inf * 0).
    const float scale = m_run <= kNegBig / 2 ? 0.f : expf(m_run - shift);
    l_run *= scale;
    acc *= scale;
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      if (jj < tm && s_mask[jj] > 0.f) {
        const float p = expf(s[jj] - shift);
        l_run += p;
        acc = fmaf(p, v[jj], acc);
      }
    }
    m_run = m_new;
  }
  if (active) out[(size_t)n * HF + col] = acc / fmaxf(l_run, 1e-30f);
}

}  // namespace

extern "C" int flash_gat_forward(const float* el, const float* er, const float* attn,
                                 const float* mask, float* out, int N, int M, int HF, int H,
                                 float slope, cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  const int F = HF / H;
  const int f_pad = (F + 31) / 32 * 32;
  const int threads = H * f_pad;
  const size_t smem = sizeof(float) * ((size_t)kChunk * (threads / 32) + kChunk);
  flash_gat_fwd_kernel<<<N, threads, smem, stream>>>(el, er, attn, mask, out, M, HF, F, f_pad,
                                                     slope);
  return cudaGetLastError();
}

extern "C" const char* flash_gat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
