// Projection-fused GATv2 attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel uav_bs_ctrl_tpu/ops/pallas_kernels.py:flash_gat_fused
// (body _flash_gat_fused_kernel). For each destination row n:
//
//   el[j]   = x[n, j, :] @ W + b                      (projected in-kernel, never stored)
//   s[j, h] = attn[h] . LeakyReLU(el[j] + er[n])[h]  (per head, over F features)
//   out[n]  = sum_j softmax_j(s[:, h]) * el[j]        (masked, online over slot chunks)
//
// plus the f32 row statistics m[n, h] (running max) and l[n, h] (denominator)
// that the flash-style backward rebuilds alpha from. All-masked rows give 0:
// the shift is 0 when the max is <= -1e30/2 and the denominator is max(l, 1e-30).
//
// Design. One CTA per destination row, one thread per output column (blockDim = H*F),
// so each warp lies inside one head (F % 32 == 0, checked by the wrapper). W and b stay
// in shared memory/registers; per slot chunk a thread projects its column, the per-head
// score is a warp-shuffle reduction plus a sum over the head's warps in shared memory,
// and the online softmax runs redundantly in every thread of the head (no extra sync).
// What bounds it: at the serving shapes (N=320 rows, M=50 or 7 slots, D=4 or 2, HF=256)
// the f32 arithmetic, about (2D+7)*HF operations per valid slot, outside the tensor
// cores; the bytes moved (x, er, out) are a fraction of that time at 3.35 TB/s.
// The kernel is a correct first version; wgmma/TMA tiling is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;          // slots per online-softmax chunk
constexpr float kNegBig = -1e30f;

__global__ void flash_gat_fused_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ er, const float* __restrict__ attn, const float* __restrict__ mask,
    float* __restrict__ out, float* __restrict__ mstat, float* __restrict__ lstat,
    int M, int D, int HF, int H, float slope) {
  extern __shared__ float smem[];
  const int n_warps = HF / 32;
  float* s_w = smem;                        // [D, HF]
  float* s_x = s_w + D * HF;                // [kChunk, D]
  float* s_mask = s_x + kChunk * D;         // [kChunk]
  float* s_part = s_mask + kChunk;          // [kChunk, n_warps] per-warp score partials
  float* s_score = s_part + kChunk * n_warps;  // [kChunk, H]

  const int n = blockIdx.x;
  const int t = threadIdx.x;                // output column
  const int F = HF / H;
  const int head = t / F;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int warps_per_head = F / 32;

  for (int i = t; i < D * HF; i += blockDim.x) s_w[i] = w[i];
  const float b_t = b[t];
  const float er_t = er[(size_t)n * HF + t];
  const float a_t = attn[t];                // attn is [H, F] row-major: column t
  const float* x_n = x + (size_t)n * M * D;
  const float* mask_n = mask + (size_t)n * M;

  float m_run = kNegBig, l_run = 0.f, acc = 0.f;
  for (int j0 = 0; j0 < M; j0 += kChunk) {
    const int tm = min(kChunk, M - j0);
    __syncthreads();                        // the previous chunk's readers are done
    for (int i = t; i < tm * D; i += blockDim.x) s_x[i] = x_n[(size_t)j0 * D + i];
    for (int i = t; i < kChunk; i += blockDim.x) s_mask[i] = i < tm ? mask_n[j0 + i] : 0.f;
    __syncthreads();

    for (int jj = 0; jj < tm; ++jj) {
      float el = b_t;
      for (int d = 0; d < D; ++d) el = fmaf(s_x[jj * D + d], s_w[d * HF + t], el);
      float e = el + er_t;
      e = e >= 0.f ? e : slope * e;
      float v = e * a_t;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) s_part[jj * n_warps + warp] = v;
    }
    __syncthreads();
    for (int i = t; i < tm * H; i += blockDim.x) {
      const int jj = i / H, hh = i % H;
      float s = 0.f;
      for (int k = 0; k < warps_per_head; ++k) s += s_part[jj * n_warps + hh * warps_per_head + k];
      s_score[i] = s_mask[jj] > 0.f ? s : kNegBig;
    }
    __syncthreads();

    float m_blk = kNegBig;
    for (int jj = 0; jj < tm; ++jj) m_blk = fmaxf(m_blk, s_score[jj * H + head]);
    const float m_new = fmaxf(m_run, m_blk);
    const float shift = m_new <= kNegBig / 2 ? 0.f : m_new;
    // Nothing valid seen yet: l and acc are 0, so the rescale is 0 (never inf * 0).
    const float scale = m_run <= kNegBig / 2 ? 0.f : expf(m_run - shift);
    l_run *= scale;
    acc *= scale;
    for (int jj = 0; jj < tm; ++jj) {
      if (s_mask[jj] > 0.f) {
        const float p = expf(s_score[jj * H + head] - shift);
        float el = b_t;
        for (int d = 0; d < D; ++d) el = fmaf(s_x[jj * D + d], s_w[d * HF + t], el);
        l_run += p;
        acc = fmaf(p, el, acc);
      }
    }
    m_run = m_new;
  }
  out[(size_t)n * HF + t] = acc / fmaxf(l_run, 1e-30f);
  if (t % F == 0) {
    mstat[(size_t)n * H + head] = m_run;
    lstat[(size_t)n * H + head] = l_run;
  }
}

}  // namespace

extern "C" int flash_gat_fused_forward(
    const float* x, const float* w, const float* b, const float* er, const float* attn,
    const float* mask, float* out, float* mstat, float* lstat,
    int N, int M, int D, int HF, int H, float slope, cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * ((size_t)D * HF + kChunk * D + kChunk +
                                       kChunk * (HF / 32) + kChunk * H);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_gat_fused_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  flash_gat_fused_fwd_kernel<<<N, HF, smem, stream>>>(x, w, b, er, attn, mask, out, mstat, lstat,
                                                      M, D, HF, H, slope);
  return cudaGetLastError();
}

extern "C" const char* flash_gat_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
