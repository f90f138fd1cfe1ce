// Backward of the projection-fused GATv2 attention for Hopper (sm_90a).
//
// Replaces the TPU kernel uav_bs_ctrl_tpu/ops/pallas_kernels.py:_fgf_bwd
// (body _flash_gat_fused_bwd_kernel). Recompute style: el = x @ W + b, the scores
// and alpha are rebuilt from the forward's row statistics m, l; nothing of the
// forward but (out, m, l) is kept. With g = dL/dout, per head h:
//
//   D[n,h]  = sum_f g*out                    d_alpha = sum_f g*el
//   d_s     = alpha * (d_alpha - D)          d_z     = d_s * attn * leaky'(z)
//   d_el    = alpha * g + d_z                der[n]  = sum_m d_z
//   dattn   = sum_{n,m} d_s * leaky(z)       dW = x^T d_el, db = sum d_el, dx = d_el W^T
//
// The all-masked rule: a row with no valid slot has m = -1e30 (shift 0) and l = 0, so
// alpha = p / max(l, 1e-30) = 0 on every slot and the row adds exactly 0 to every
// gradient, der included. Masked slots have alpha = 0 and are skipped.
//
// Design. Pass 1, one CTA per destination row, one thread per output column
// (blockDim = H*F, each warp inside one head as in the forward). Per chunk of 32 slots a
// thread projects its column, the two per-head sums (score and d_alpha) are warp
// shuffles plus a sum over the head's warps in shared memory, then every thread forms
// its column of d_el and accumulates der, dattn, db and dW in registers. der is
// row-owned and written directly; the thread's dW/db/dattn contributions go to a
// per-row partial buffer [N, (D+2)*HF]. Pass 2 sums the partials over the rows in a
// fixed order (no atomics), so two runs give bit-identical gradients. dx, when asked
// for, is a block reduction per slot over the H*F columns.
// What bounds it: at the training shapes (N=256 rows, M=50 or 7 slots, D=4 or 2,
// HF=256) the f32 arithmetic outside the tensor cores, about (4D+16)*HF operations per
// valid slot; the bytes moved are a fraction of that time. Simple and correct first.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;          // slots per chunk
constexpr int kMaxD = 8;            // source feature width held in registers
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void flash_gat_fused_bwd_rows(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ er, const float* __restrict__ attn,
    const float* __restrict__ mask, const float* __restrict__ g,
    const float* __restrict__ out, const float* __restrict__ mstat,
    const float* __restrict__ lstat, float* __restrict__ der, float* __restrict__ dx,
    float* __restrict__ partial, int M, int D, int HF, int H, float slope) {
  extern __shared__ float smem[];
  const int n_warps = HF / 32;
  float* s_w = smem;                              // [D, HF]
  float* s_x = s_w + D * HF;                      // [kChunk, D]
  float* s_mask = s_x + kChunk * D;               // [kChunk]
  float* s_part = s_mask + kChunk;                // [kChunk, n_warps, 2] score, d_alpha
  float* s_score = s_part + kChunk * n_warps * 2; // [kChunk, H]
  float* s_dalpha = s_score + kChunk * H;         // [kChunk, H]
  float* s_dvec = s_dalpha + kChunk * H;          // [H]
  float* s_dxp = s_dvec + H;                      // [kChunk, n_warps, D] (dx only)

  const int n = blockIdx.x;
  const int t = threadIdx.x;                      // output column
  const int F = HF / H;
  const int head = t / F;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int warps_per_head = F / 32;

  for (int i = t; i < D * HF; i += blockDim.x) s_w[i] = w[i];
  const float b_t = b[t];
  const float er_t = er[(size_t)n * HF + t];
  const float a_t = attn[t];                      // attn [H, F] row-major: column t
  const float g_t = g[(size_t)n * HF + t];
  const float* x_n = x + (size_t)n * M * D;
  const float* mask_n = mask + (size_t)n * M;

  // D[n, h] = sum over the head's columns of g * out.
  float v = warp_sum(g_t * out[(size_t)n * HF + t]);
  if (lane == 0) s_part[warp] = v;
  __syncthreads();
  if (t < H) {
    float s = 0.f;
    for (int k = 0; k < warps_per_head; ++k) s += s_part[t * warps_per_head + k];
    s_dvec[t] = s;
  }
  const float m_h = mstat[(size_t)n * H + head];
  const float shift = m_h <= kNegBig / 2 ? 0.f : m_h;
  const float l_h = fmaxf(lstat[(size_t)n * H + head], 1e-30f);

  float acc_dw[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) acc_dw[d] = 0.f;
  float acc_db = 0.f, acc_der = 0.f, acc_dattn = 0.f;

  for (int j0 = 0; j0 < M; j0 += kChunk) {
    const int tm = min(kChunk, M - j0);
    __syncthreads();                              // the previous chunk's readers are done
    for (int i = t; i < tm * D; i += blockDim.x) s_x[i] = x_n[(size_t)j0 * D + i];
    for (int i = t; i < kChunk; i += blockDim.x) s_mask[i] = i < tm ? mask_n[j0 + i] : 0.f;
    __syncthreads();

    for (int jj = 0; jj < tm; ++jj) {
      if (!(s_mask[jj] > 0.f)) continue;          // uniform over the CTA
      float el = b_t;
      for (int d = 0; d < D; ++d) el = fmaf(s_x[jj * D + d], s_w[d * HF + t], el);
      const float z = el + er_t;
      const float lz = z >= 0.f ? z : slope * z;
      const float sc = warp_sum(lz * a_t);
      const float da = warp_sum(g_t * el);
      if (lane == 0) {
        s_part[(jj * n_warps + warp) * 2] = sc;
        s_part[(jj * n_warps + warp) * 2 + 1] = da;
      }
    }
    __syncthreads();
    for (int i = t; i < tm * H; i += blockDim.x) {
      const int jj = i / H, hh = i % H;
      if (!(s_mask[jj] > 0.f)) continue;
      float s = 0.f, da = 0.f;
      for (int k = 0; k < warps_per_head; ++k) {
        s += s_part[(jj * n_warps + hh * warps_per_head + k) * 2];
        da += s_part[(jj * n_warps + hh * warps_per_head + k) * 2 + 1];
      }
      s_score[i] = s;
      s_dalpha[i] = da;
    }
    __syncthreads();

    const float dvec = s_dvec[head];
    for (int jj = 0; jj < tm; ++jj) {
      const bool valid = s_mask[jj] > 0.f;        // uniform over the CTA
      float del = 0.f;
      if (valid) {
        float el = b_t;
        for (int d = 0; d < D; ++d) el = fmaf(s_x[jj * D + d], s_w[d * HF + t], el);
        const float z = el + er_t;
        const float lz = z >= 0.f ? z : slope * z;
        const float alpha = expf(s_score[jj * H + head] - shift) / l_h;
        const float ds = alpha * (s_dalpha[jj * H + head] - dvec);
        const float dz = ds * a_t * (z >= 0.f ? 1.f : slope);
        del = alpha * g_t + dz;
        acc_der += dz;
        acc_dattn = fmaf(ds, lz, acc_dattn);
        acc_db += del;
#pragma unroll
        for (int d = 0; d < kMaxD; ++d)
          if (d < D) acc_dw[d] = fmaf(s_x[jj * D + d], del, acc_dw[d]);
      }
      if (dx != nullptr) {
        for (int d = 0; d < D; ++d) {
          const float pd = warp_sum(del * s_w[d * HF + t]);
          if (lane == 0) s_dxp[(jj * n_warps + warp) * D + d] = pd;
        }
      }
    }
    if (dx != nullptr) {
      __syncthreads();
      for (int i = t; i < tm * D; i += blockDim.x) {
        const int jj = i / D, d = i % D;
        float s = 0.f;
        for (int k = 0; k < n_warps; ++k) s += s_dxp[(jj * n_warps + k) * D + d];
        dx[((size_t)n * M + j0 + jj) * D + d] = s;
      }
    }
  }

  der[(size_t)n * HF + t] = acc_der;
  float* part_n = partial + (size_t)n * (D + 2) * HF;
  for (int d = 0; d < D; ++d) part_n[d * HF + t] = acc_dw[d];
  part_n[D * HF + t] = acc_db;
  part_n[(D + 1) * HF + t] = acc_dattn;
}

// Pass 2: column k of the partials summed over the N rows, in a fixed order. A CTA is
// 32 columns x 8 row lanes; lane r sums rows r, r+8, ...; the 8 lane sums are added in
// order through shared memory.
constexpr int kRedCols = 32;
constexpr int kRedLanes = 8;

__global__ void flash_gat_fused_bwd_reduce(const float* __restrict__ partial,
                                           float* __restrict__ dw, float* __restrict__ db,
                                           float* __restrict__ dattn, int N, int D, int HF) {
  __shared__ float s_sum[kRedLanes][kRedCols];
  const int P = (D + 2) * HF;
  const int k = blockIdx.x * kRedCols + threadIdx.x;
  float s = 0.f;
  if (k < P)
    for (int r = threadIdx.y; r < N; r += kRedLanes) s += partial[(size_t)r * P + k];
  s_sum[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && k < P) {
    float tot = 0.f;
    for (int r = 0; r < kRedLanes; ++r) tot += s_sum[r][threadIdx.x];
    if (k < D * HF) dw[k] = tot;
    else if (k < (D + 1) * HF) db[k - D * HF] = tot;
    else dattn[k - (D + 1) * HF] = tot;
  }
}

}  // namespace

extern "C" int flash_gat_fused_backward(
    const float* x, const float* w, const float* b, const float* er, const float* attn,
    const float* mask, const float* g, const float* out, const float* mstat,
    const float* lstat, float* dw, float* db, float* der, float* dattn, float* dx,
    float* partial, int N, int M, int D, int HF, int H, float slope, cudaStream_t stream) {
  if (D > kMaxD || HF % 32 != 0 || HF > 1024 || H <= 0 || (HF / H) % 32 != 0)
    return cudaErrorInvalidValue;
  const int n_warps = HF / 32;
  if (N > 0) {
    const size_t smem = sizeof(float) * ((size_t)D * HF + kChunk * D + kChunk +
                                         kChunk * n_warps * 2 + 2 * kChunk * H + H +
                                         (dx != nullptr ? kChunk * n_warps * D : 0));
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(flash_gat_fused_bwd_rows,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return e;
    }
    flash_gat_fused_bwd_rows<<<N, HF, smem, stream>>>(x, w, b, er, attn, mask, g, out, mstat,
                                                      lstat, der, dx, partial, M, D, HF, H,
                                                      slope);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int P = (D + 2) * HF;
  flash_gat_fused_bwd_reduce<<<(P + kRedCols - 1) / kRedCols, dim3(kRedCols, kRedLanes), 0,
                               stream>>>(partial, dw, db, dattn, N, D, HF);
  return cudaGetLastError();
}

extern "C" const char* flash_gat_fused_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
