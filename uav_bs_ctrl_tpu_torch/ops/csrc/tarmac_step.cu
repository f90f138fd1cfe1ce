// Fused recurrent step for Hopper (sm_90a): TarMAC attention + GRU cell + Q head.
//
// Replaces the TPU kernel uav_bs_ctrl_tpu/ops/step_kernels.py:tarmac_step
// (body _step_fwd_kernel). Rows are (world, agent) pairs, world-major. For world w:
//
//   [v | s | q] = [x | h] @ [wv | ws | wq] + b         (h is only read, never updated here)
//   alpha[s, d] = softmax over sources s of (s_s . q_d) / key_size, where adjf[w*A+s, d] > 0
//   c[d]        = sum_s alpha[s, d] * v[s]             (a destination with no in-edges: c = 0)
//   h2          = GRUCell([x | c], h)                   gate order r, z, n; h2 = (1-z) n + z h
//   q           = h2 @ wo + bo, or with dueling  (h2 @ wvh + bvh) + adv - mean(adv)
//
// Design. One CTA per world, 256 threads. The world's x and h rows sit in shared memory;
// v/s/q, the A x A scores and the aggregation are computed directly per (row, column)
// pair: the TPU's block-diagonal R x R trick is a device for its matrix unit and is not
// needed here. The GRU gives each thread one hidden column for up to 8 rows at once, so
// every weight element read from L2 serves 8 rows. Weights stay in global memory (about
// 2 MB at the serving width, L2-resident across CTAs).
// What bounds it: f32 arithmetic outside the tensor cores, dominated by the GRU's
// (H+MSG)*3H + H*3H multiply-adds per row; with one CTA per world only W of the 132 SMs
// work at the serving batch (W=40). wgmma and a row-tiled grid are later work.

#include <cuda_runtime.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr int kRows = 8;            // rows per register group in the GRU
constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

__global__ void __launch_bounds__(kThreads) tarmac_step_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ h, const float* __restrict__ adjf,
    const float* __restrict__ wv, const float* __restrict__ bv,
    const float* __restrict__ ws, const float* __restrict__ bs,
    const float* __restrict__ wq, const float* __restrict__ bq,
    const float* __restrict__ wi, const float* __restrict__ wh,
    const float* __restrict__ bi, const float* __restrict__ bh,
    const float* __restrict__ wo, const float* __restrict__ bo,
    const float* __restrict__ wvh, const float* __restrict__ bvh,
    float* __restrict__ q_out, float* __restrict__ h2_out,
    int A, int H, int MSG, int K, int NACT, int dueling, float key_size) {
  extern __shared__ float smem[];
  const int H2 = 2 * H, H3 = 3 * H;
  float* s_in = smem;                 // [A, 2H]   row a = [x_a | h_a]
  float* s_v = s_in + A * H2;         // [A, MSG]
  float* s_s = s_v + A * MSG;         // [A, K]    signatures
  float* s_q = s_s + A * K;           // [A, K]    queries
  float* s_alpha = s_q + A * K;       // [A(src), A(dst)]
  float* s_c = s_alpha + A * A;       // [A, MSG]
  float* s_h2 = s_c + A * MSG;        // [A, H]
  float* s_adv = s_h2 + A * H;        // [A, NACT]
  float* s_val = s_adv + A * NACT;    // [A]

  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * A;

  for (int i = tid; i < A * H; i += blockDim.x) {
    const int a = i / H, k = i % H;
    s_in[a * H2 + k] = x[(row0 + a) * H + k];
    s_in[a * H2 + H + k] = h[(row0 + a) * H + k];
  }
  __syncthreads();

  // v, s, q: one (row, output column) pair per thread iteration.
  const int P = MSG + 2 * K;
  for (int i = tid; i < A * P; i += blockDim.x) {
    const int a = i / P, c = i % P;
    const float* W;
    const float* B;
    float* dst;
    int ld, col;
    if (c < MSG) {
      W = wv; B = bv; ld = MSG; col = c; dst = s_v + a * MSG + col;
    } else if (c < MSG + K) {
      W = ws; B = bs; ld = K; col = c - MSG; dst = s_s + a * K + col;
    } else {
      W = wq; B = bq; ld = K; col = c - MSG - K; dst = s_q + a * K + col;
    }
    const float* in = s_in + a * H2;
    float acc = 0.f;
    for (int k = 0; k < H2; ++k) acc = fmaf(in[k], W[(size_t)k * ld + col], acc);
    *dst = acc + B[col];
  }
  __syncthreads();

  // Masked softmax over SOURCES for each destination d (column of adjf).
  for (int d = tid; d < A; d += blockDim.x) {
    float mx = kNegBig;
    for (int s = 0; s < A; ++s) {
      float sc = 0.f;
      for (int k = 0; k < K; ++k) sc = fmaf(s_s[s * K + k], s_q[d * K + k], sc);
      sc = sc / key_size;
      sc = adjf[(row0 + s) * A + d] > 0.f ? sc : kNegBig;
      s_alpha[s * A + d] = sc;
      mx = fmaxf(mx, sc);
    }
    const float shift = mx <= kNegBig / 2 ? 0.f : mx;
    float den = 0.f;
    for (int s = 0; s < A; ++s) {
      const float p = adjf[(row0 + s) * A + d] > 0.f ? expf(s_alpha[s * A + d] - shift) : 0.f;
      s_alpha[s * A + d] = p;
      den += p;
    }
    den = fmaxf(den, 1e-30f);
    for (int s = 0; s < A; ++s) s_alpha[s * A + d] = s_alpha[s * A + d] / den;
  }
  __syncthreads();

  for (int i = tid; i < A * MSG; i += blockDim.x) {
    const int d = i / MSG, m = i % MSG;
    float acc = 0.f;
    for (int s = 0; s < A; ++s) acc = fmaf(s_alpha[s * A + d], s_v[s * MSG + m], acc);
    s_c[i] = acc;
  }
  __syncthreads();

  // GRU: thread owns hidden column j; rows in groups of kRows share each weight load.
  for (int j = tid; j < H; j += blockDim.x) {
    for (int a0 = 0; a0 < A; a0 += kRows) {
      float ir[kRows], iz[kRows], in_[kRows], hr[kRows], hz[kRows], hn[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        ir[r] = iz[r] = in_[r] = hr[r] = hz[r] = hn[r] = 0.f;
      }
      for (int k = 0; k < H; ++k) {           // x part of wi
        const float* wrow = wi + (size_t)k * H3;
        const float w_r = wrow[j], w_z = wrow[H + j], w_n = wrow[2 * H + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (a0 + r < A) {
            const float v = s_in[(a0 + r) * H2 + k];
            ir[r] = fmaf(v, w_r, ir[r]);
            iz[r] = fmaf(v, w_z, iz[r]);
            in_[r] = fmaf(v, w_n, in_[r]);
          }
        }
      }
      for (int k = 0; k < MSG; ++k) {         // c part of wi
        const float* wrow = wi + (size_t)(H + k) * H3;
        const float w_r = wrow[j], w_z = wrow[H + j], w_n = wrow[2 * H + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (a0 + r < A) {
            const float v = s_c[(a0 + r) * MSG + k];
            ir[r] = fmaf(v, w_r, ir[r]);
            iz[r] = fmaf(v, w_z, iz[r]);
            in_[r] = fmaf(v, w_n, in_[r]);
          }
        }
      }
      for (int k = 0; k < H; ++k) {           // h part: wh
        const float* wrow = wh + (size_t)k * H3;
        const float w_r = wrow[j], w_z = wrow[H + j], w_n = wrow[2 * H + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (a0 + r < A) {
            const float v = s_in[(a0 + r) * H2 + H + k];
            hr[r] = fmaf(v, w_r, hr[r]);
            hz[r] = fmaf(v, w_z, hz[r]);
            hn[r] = fmaf(v, w_n, hn[r]);
          }
        }
      }
      const float bir = bi[j], biz = bi[H + j], bin = bi[2 * H + j];
      const float bhr = bh[j], bhz = bh[H + j], bhn = bh[2 * H + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (a0 + r < A) {
          const float rg = sigmoidf_((ir[r] + bir) + (hr[r] + bhr));
          const float zg = sigmoidf_((iz[r] + biz) + (hz[r] + bhz));
          const float ng = tanhf((in_[r] + bin) + rg * (hn[r] + bhn));
          const float hp = s_in[(a0 + r) * H2 + H + j];
          const float h2 = (1.f - zg) * ng + zg * hp;
          s_h2[(a0 + r) * H + j] = h2;
          h2_out[(row0 + a0 + r) * H + j] = h2;
        }
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < A * NACT; i += blockDim.x) {
    const int a = i / NACT, o = i % NACT;
    float acc = 0.f;
    for (int k = 0; k < H; ++k) acc = fmaf(s_h2[a * H + k], wo[(size_t)k * NACT + o], acc);
    s_adv[i] = acc + bo[o];
  }
  if (dueling) {
    for (int a = tid; a < A; a += blockDim.x) {
      float acc = 0.f;
      for (int k = 0; k < H; ++k) acc = fmaf(s_h2[a * H + k], wvh[k], acc);
      s_val[a] = acc + bvh[0];
    }
  }
  __syncthreads();

  for (int i = tid; i < A * NACT; i += blockDim.x) {
    const int a = i / NACT;
    float qv = s_adv[i];
    if (dueling) {
      float mean = 0.f;
      for (int o = 0; o < NACT; ++o) mean += s_adv[a * NACT + o];
      mean = mean / NACT;
      qv = s_val[a] + (qv - mean);
    }
    q_out[(row0 + a) * NACT + (i % NACT)] = qv;
  }
}

}  // namespace

extern "C" int tarmac_step_forward(
    const float* x, const float* h, const float* adjf,
    const float* wv, const float* bv, const float* ws, const float* bs,
    const float* wq, const float* bq, const float* wi, const float* wh,
    const float* bi, const float* bh, const float* wo, const float* bo,
    const float* wvh, const float* bvh, float* q_out, float* h2_out,
    int W, int A, int H, int MSG, int K, int NACT, int dueling, float key_size,
    cudaStream_t stream) {
  if (W == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (size_t)A *
                      (2 * H + MSG + 2 * K + A + MSG + H + NACT + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(tarmac_step_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  tarmac_step_fwd_kernel<<<W, kThreads, smem, stream>>>(
      x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo, wvh, bvh, q_out, h2_out,
      A, H, MSG, K, NACT, dueling, key_size);
  return cudaGetLastError();
}

extern "C" const char* tarmac_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
