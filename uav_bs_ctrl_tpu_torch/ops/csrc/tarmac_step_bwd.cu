// Backward of the fused recurrent step (TarMAC + GRU + Q head) for Hopper (sm_90a).
//
// Replaces the TPU kernel uav_bs_ctrl_tpu/ops/step_kernels.py:_tst_bwd (body
// _step_bwd_kernel). Recompute style: from the step's inputs (x, h, adjf, weights) and
// the cotangents gq, gh2 it rebuilds v/s/q, alpha, c and the GRU gates, then runs the
// head, GRU and attention backwards in the TPU kernel's order:
//
//   head       dadv = gq (dueling: gq - mean(gq), dvh = sum(gq)); dh2 = dadv wo^T (+ dvh wvh^T) + gh2
//   GRU        dn = dh2 (1-z), dz = dh2 (h-n), dpre_n = dn (1-n^2), dhn = dpre_n r,
//              dpre_z = dz z (1-z), dpre_r = dpre_n hn r (1-r);  dgi = [dpre_r|dpre_z|dpre_n],
//              dgh = [dpre_r|dpre_z|dhn];  [dx|dc] = dgi wi^T;  dh = dh2 z + dgh wh^T
//   attention  dalpha[s,d] = v_s . dc_d; dv = alpha dc; dscore = alpha (dalpha - colsum);
//              ds = dscore q / key, dq = dscore^T s / key;  dx += dv wv_x^T + ds ws_x^T + dq wq_x^T
//
// h is stop-gradient into v/s/q (reference TarMAC), so dh carries the GRU path only, but
// the v/s/q weight grads still see h as an input. Without dueling dwvh, dbvh are 0.
// A destination with no in-edge has an all-zero alpha column: c = 0 and its attention
// cotangents are 0.
//
// Design. Two launches. Pass 1, one CTA per world (256 threads): the recompute as in
// csrc/tarmac_step.cu, then the backward above. The transposed products (dgi wi^T,
// dgh wh^T, dv wv^T, ...) give one warp to each output column k: its lanes walk row k of
// the weight (coalesced) for every row of the world at once, then a warp sum. Pass 1
// writes dx and dh and, per row, the cotangents the weight grads need (dpre_r|dpre_z|
// dpre_n|dhn, c, h2, dv, ds, dq, dadv, dvh) to a scratch buffer. Pass 2 forms every
// weight gradient X^T G (and every bias, a column sum) with one CTA per 64x64 output
// tile looping over all W*A rows in order: no atomics, so the result is bit-identical
// from run to run. What bounds it: f32 arithmetic outside the tensor cores (the GRU's
// recompute and its two transposed products dominate), with one CTA per world in pass
// 1 (W=32 at the training batch). wgmma and a row-tiled pass 1 are later work.

#include <cuda_runtime.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr int kRows = 8;            // rows of a world handled together
constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Scratch {                    // per-row cotangents handed to pass 2
  float* dg;                        // [R, 4H]  dpre_r | dpre_z | dpre_n | dhn
  float* c2;                        // [R, MSG]
  float* h2;                        // [R, H]
  float* dv;                        // [R, MSG]
  float* ds;                        // [R, K]
  float* dq;                        // [R, K]
  float* dadv;                      // [R, NACT]
  float* dvh;                       // [R]
};

__global__ void __launch_bounds__(kThreads) tarmac_step_bwd_worlds(
    const float* __restrict__ x, const float* __restrict__ h, const float* __restrict__ adjf,
    const float* __restrict__ wv, const float* __restrict__ bv,
    const float* __restrict__ ws, const float* __restrict__ bs,
    const float* __restrict__ wq, const float* __restrict__ bq,
    const float* __restrict__ wi, const float* __restrict__ wh,
    const float* __restrict__ bi, const float* __restrict__ bh,
    const float* __restrict__ wo, const float* __restrict__ wvh,
    const float* __restrict__ gq, const float* __restrict__ gh2,
    float* __restrict__ dx, float* __restrict__ dh, Scratch sc,
    int A, int H, int MSG, int K, int NACT, int dueling, float key_size) {
  extern __shared__ float smem[];
  const int H2 = 2 * H, H3 = 3 * H, H4 = 4 * H;
  float* s_in = smem;                 // [A, 2H]  row a = [x_a | h_a]
  float* s_v = s_in + A * H2;         // [A, MSG]
  float* s_s = s_v + A * MSG;         // [A, K]
  float* s_q = s_s + A * K;           // [A, K]
  float* s_alpha = s_q + A * K;       // [A(src), A(dst)]
  float* s_c = s_alpha + A * A;       // [A, MSG]
  float* s_g = s_c + A * MSG;         // [A, 4H]  r|z|n|hn, then dpre_r|dpre_z|dpre_n|dhn
  float* s_dadv = s_g + A * H4;       // [A, NACT]
  float* s_dvh = s_dadv + A * NACT;   // [A]
  float* s_dh = s_dvh + A;            // [A, H]
  float* s_dc = s_dh + A * H;         // [A, MSG]
  float* s_dsc = s_dc + A * MSG;      // [A(src), A(dst)] dalpha, then dscore
  float* s_dv = s_dsc + A * A;        // [A, MSG]
  float* s_ds = s_dv + A * MSG;       // [A, K]
  float* s_dq = s_ds + A * K;         // [A, K]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, n_warps = blockDim.x >> 5;
  const size_t row0 = (size_t)blockIdx.x * A;

  for (int i = tid; i < A * H; i += blockDim.x) {
    const int a = i / H, k = i % H;
    s_in[a * H2 + k] = x[(row0 + a) * H + k];
    s_in[a * H2 + H + k] = h[(row0 + a) * H + k];
  }
  __syncthreads();

  // ---- forward recompute: v, s, q ----
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

  // alpha: masked softmax over sources for each destination d.
  for (int d = tid; d < A; d += blockDim.x) {
    float mx = kNegBig;
    for (int s = 0; s < A; ++s) {
      float sc_ = 0.f;
      for (int k = 0; k < K; ++k) sc_ = fmaf(s_s[s * K + k], s_q[d * K + k], sc_);
      sc_ = sc_ / key_size;
      sc_ = adjf[(row0 + s) * A + d] > 0.f ? sc_ : kNegBig;
      s_alpha[s * A + d] = sc_;
      mx = fmaxf(mx, sc_);
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
    sc.c2[(row0 + d) * MSG + m] = acc;
  }
  __syncthreads();

  // GRU gates: thread owns hidden column j, rows in groups of kRows (as the forward).
  for (int j = tid; j < H; j += blockDim.x) {
    for (int a0 = 0; a0 < A; a0 += kRows) {
      float ir[kRows], iz[kRows], in_[kRows], hr[kRows], hz[kRows], hn[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) ir[r] = iz[r] = in_[r] = hr[r] = hz[r] = hn[r] = 0.f;
      for (int k = 0; k < H; ++k) {
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
      for (int k = 0; k < MSG; ++k) {
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
      for (int k = 0; k < H; ++k) {
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
          const int a = a0 + r;
          const float rg = sigmoidf_((ir[r] + bir) + (hr[r] + bhr));
          const float zg = sigmoidf_((iz[r] + biz) + (hz[r] + bhz));
          const float hnb = hn[r] + bhn;
          const float ng = tanhf((in_[r] + bin) + rg * hnb);
          const float hp = s_in[a * H2 + H + j];
          s_g[a * H4 + j] = rg;
          s_g[a * H4 + H + j] = zg;
          s_g[a * H4 + 2 * H + j] = ng;
          s_g[a * H4 + 3 * H + j] = hnb;
          sc.h2[(row0 + a) * H + j] = (1.f - zg) * ng + zg * hp;
        }
      }
    }
  }

  // ---- head backward ----
  for (int i = tid; i < A * NACT; i += blockDim.x) {
    const int a = i / NACT;
    float g = gq[(row0 + a) * NACT + (i % NACT)];
    if (dueling) {
      float mean = 0.f;
      for (int o = 0; o < NACT; ++o) mean += gq[(row0 + a) * NACT + o];
      g = g - mean / NACT;
    }
    s_dadv[i] = g;
    sc.dadv[row0 * NACT + i] = g;
  }
  for (int a = tid; a < A; a += blockDim.x) {
    float v = 0.f;
    if (dueling)
      for (int o = 0; o < NACT; ++o) v += gq[(row0 + a) * NACT + o];
    s_dvh[a] = v;
    sc.dvh[row0 + a] = v;
  }
  __syncthreads();

  // ---- GRU backward, elementwise ----
  for (int i = tid; i < A * H; i += blockDim.x) {
    const int a = i / H, k = i % H;
    float dh2 = 0.f;
    for (int o = 0; o < NACT; ++o) dh2 = fmaf(s_dadv[a * NACT + o], wo[(size_t)k * NACT + o], dh2);
    if (dueling) dh2 = fmaf(s_dvh[a], wvh[k], dh2);
    dh2 += gh2[(row0 + a) * H + k];
    float* g = s_g + a * H4;
    const float rg = g[k], zg = g[H + k], ng = g[2 * H + k], hnb = g[3 * H + k];
    const float hp = s_in[a * H2 + H + k];
    const float dn = dh2 * (1.f - zg);
    const float dz = dh2 * (hp - ng);
    const float dpre_n = dn * (1.f - ng * ng);
    const float dr = dpre_n * hnb;
    const float dhn = dpre_n * rg;
    const float dpre_z = dz * zg * (1.f - zg);
    const float dpre_r = dr * rg * (1.f - rg);
    g[k] = dpre_r;
    g[H + k] = dpre_z;
    g[2 * H + k] = dpre_n;
    g[3 * H + k] = dhn;
    float* out = sc.dg + (row0 + a) * H4;
    out[k] = dpre_r;
    out[H + k] = dpre_z;
    out[2 * H + k] = dpre_n;
    out[3 * H + k] = dhn;
    s_dh[i] = dh2 * zg;
  }
  __syncthreads();

  // dc = dgi wi[H:]^T and dh += dgh wh^T: one warp per output column.
  for (int task = warp; task < MSG + H; task += n_warps) {
    const bool is_dc = task < MSG;
    const float* wrow = is_dc ? wi + (size_t)(H + task) * H3 : wh + (size_t)(task - MSG) * H3;
    for (int a0 = 0; a0 < A; a0 += kRows) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int j = lane; j < H3; j += 32) {
        const float w = wrow[j];
        const int gcol = (is_dc || j < 2 * H) ? j : j + H;   // dgh's n part is dhn
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (a0 + r < A) acc[r] = fmaf(s_g[(a0 + r) * H4 + gcol], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = warp_sum(acc[r]);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (a0 + r < A) {
            if (is_dc) s_dc[(a0 + r) * MSG + task] = acc[r];
            else s_dh[(a0 + r) * H + task - MSG] += acc[r];
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- attention backward ----
  for (int i = tid; i < A * A; i += blockDim.x) {
    const int s = i / A, d = i % A;
    float acc = 0.f;
    for (int m = 0; m < MSG; ++m) acc = fmaf(s_v[s * MSG + m], s_dc[d * MSG + m], acc);
    s_dsc[i] = acc;
  }
  __syncthreads();
  for (int d = tid; d < A; d += blockDim.x) {
    float col = 0.f;
    for (int s = 0; s < A; ++s) col = fmaf(s_alpha[s * A + d], s_dsc[s * A + d], col);
    for (int s = 0; s < A; ++s) s_dsc[s * A + d] = s_alpha[s * A + d] * (s_dsc[s * A + d] - col);
  }
  __syncthreads();
  for (int i = tid; i < A * MSG; i += blockDim.x) {
    const int s = i / MSG, m = i % MSG;
    float acc = 0.f;
    for (int d = 0; d < A; ++d) acc = fmaf(s_alpha[s * A + d], s_dc[d * MSG + m], acc);
    s_dv[i] = acc;
    sc.dv[row0 * MSG + i] = acc;
  }
  for (int i = tid; i < A * K; i += blockDim.x) {
    const int r = i / K, k = i % K;
    float acc_s = 0.f, acc_q = 0.f;
    for (int o = 0; o < A; ++o) {
      acc_s = fmaf(s_dsc[r * A + o], s_q[o * K + k], acc_s);   // ds[r] = sum_d dscore[r,d] q_d
      acc_q = fmaf(s_dsc[o * A + r], s_s[o * K + k], acc_q);   // dq[r] = sum_s dscore[s,r] s_s
    }
    s_ds[i] = acc_s / key_size;
    s_dq[i] = acc_q / key_size;
    sc.ds[row0 * K + i] = acc_s / key_size;
    sc.dq[row0 * K + i] = acc_q / key_size;
  }
  __syncthreads();

  // dx = dgi wi[:H]^T + dv wv[:H]^T + ds ws[:H]^T + dq wq[:H]^T: one warp per column.
  for (int k = warp; k < H; k += n_warps) {
    const float* wrow = wi + (size_t)k * H3;
    for (int a0 = 0; a0 < A; a0 += kRows) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int j = lane; j < H3; j += 32) {
        const float w = wrow[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (a0 + r < A) acc[r] = fmaf(s_g[(a0 + r) * H4 + j], w, acc[r]);
      }
      for (int j = lane; j < P; j += 32) {
        float w;
        const float* gsrc;
        int ld, col;
        if (j < MSG) {
          w = wv[(size_t)k * MSG + j]; gsrc = s_dv; ld = MSG; col = j;
        } else if (j < MSG + K) {
          w = ws[(size_t)k * K + j - MSG]; gsrc = s_ds; ld = K; col = j - MSG;
        } else {
          w = wq[(size_t)k * K + j - MSG - K]; gsrc = s_dq; ld = K; col = j - MSG - K;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (a0 + r < A) acc[r] = fmaf(gsrc[(a0 + r) * ld + col], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = warp_sum(acc[r]);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (a0 + r < A) dx[(row0 + a0 + r) * H + k] = acc[r];
      }
    }
  }
  for (int i = tid; i < A * H; i += blockDim.x) dh[row0 * H + i] = s_dh[i];
}

// ---- pass 2: weight gradients out = X^T G over all rows, one CTA per 64x64 tile ----

constexpr int kTile = 64;
constexpr int kRowChunk = 32;
constexpr int kMaxJobs = 24;

struct XtGJob {
  const float* X;                   // [R, ldx], first xcols columns; nullptr: a ones column
  const float* G;                   // [R, ldg], first gcols columns
  float* out;                       // [xcols, ldo]
  int ldx, xcols, ldg, gcols, ldo, tile0, tiles_j;
};

struct XtGJobs {
  XtGJob job[kMaxJobs];
  int n_jobs;
  int R;
};

__global__ void __launch_bounds__(kThreads) tarmac_step_bwd_xtg(const XtGJobs jobs) {
  __shared__ float s_x[kRowChunk][kTile];
  __shared__ float s_g[kRowChunk][kTile];
  int jb = 0;
  while (jb + 1 < jobs.n_jobs && (int)blockIdx.x >= jobs.job[jb + 1].tile0) ++jb;
  const XtGJob J = jobs.job[jb];
  const int local = blockIdx.x - J.tile0;
  const int i0 = (local / J.tiles_j) * kTile, j0 = (local % J.tiles_j) * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;

  for (int r0 = 0; r0 < jobs.R; r0 += kRowChunk) {
    __syncthreads();
    for (int e = tid; e < kRowChunk * kTile; e += blockDim.x) {
      const int r = e / kTile, c = e % kTile, row = r0 + r;
      float xv = 0.f, gv = 0.f;
      if (row < jobs.R) {
        if (i0 + c < J.xcols)
          xv = J.X != nullptr ? J.X[(size_t)row * J.ldx + i0 + c] : 1.f;
        if (j0 + c < J.gcols) gv = J.G[(size_t)row * J.ldg + j0 + c];
      }
      s_x[r][c] = xv;
      s_g[r][c] = gv;
    }
    __syncthreads();
    for (int r = 0; r < kRowChunk; ++r) {
      float xv[4], gv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) xv[ii] = s_x[r][ty + 16 * ii];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) gv[jj] = s_g[r][tx + 16 * jj];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(xv[ii], gv[jj], acc[ii][jj]);
    }
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = i0 + ty + 16 * ii;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + tx + 16 * jj;
      if (i < J.xcols && j < J.gcols) J.out[(size_t)i * J.ldo + j] = acc[ii][jj];
    }
  }
}

}  // namespace

extern "C" int tarmac_step_backward(
    const float* x, const float* h, const float* adjf,
    const float* wv, const float* bv, const float* ws, const float* bs,
    const float* wq, const float* bq, const float* wi, const float* wh,
    const float* bi, const float* bh, const float* wo, const float* bo,
    const float* wvh, const float* bvh, const float* gq, const float* gh2,
    float* dx, float* dh, float* dwv, float* dbv, float* dws, float* dbs,
    float* dwq, float* dbq, float* dwi, float* dwh, float* dbi, float* dbh,
    float* dwo, float* dbo, float* dwvh, float* dbvh, float* scratch,
    int W, int A, int H, int MSG, int K, int NACT, int dueling, float key_size,
    cudaStream_t stream) {
  (void)bo;
  (void)bvh;
  const int R = W * A;
  Scratch sc;
  sc.dg = scratch;
  sc.c2 = sc.dg + (size_t)R * 4 * H;
  sc.h2 = sc.c2 + (size_t)R * MSG;
  sc.dv = sc.h2 + (size_t)R * H;
  sc.ds = sc.dv + (size_t)R * MSG;
  sc.dq = sc.ds + (size_t)R * K;
  sc.dadv = sc.dq + (size_t)R * K;
  sc.dvh = sc.dadv + (size_t)R * NACT;

  if (W > 0) {
    const size_t smem = sizeof(float) * (size_t)A *
                        (2 * H + 4 * MSG + 4 * K + 2 * A + 4 * H + NACT + 1 + H);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(tarmac_step_bwd_worlds,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return e;
    }
    tarmac_step_bwd_worlds<<<W, kThreads, smem, stream>>>(
        x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, wvh, gq, gh2, dx, dh, sc,
        A, H, MSG, K, NACT, dueling, key_size);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }

  XtGJobs jobs;
  jobs.n_jobs = 0;
  jobs.R = R;
  int tiles = 0;
  auto add = [&](const float* X, int ldx, int xcols, const float* G, int ldg, int gcols,
                 float* out, int ldo) {
    XtGJob& j = jobs.job[jobs.n_jobs++];
    j.X = X; j.ldx = ldx; j.xcols = xcols; j.G = G; j.ldg = ldg; j.gcols = gcols;
    j.out = out; j.ldo = ldo; j.tile0 = tiles;
    j.tiles_j = (gcols + kTile - 1) / kTile;
    tiles += ((xcols + kTile - 1) / kTile) * j.tiles_j;
  };
  const int H3 = 3 * H, H4 = 4 * H;
  // [x|h]^T dv, ds, dq and their biases
  add(x, H, H, sc.dv, MSG, MSG, dwv, MSG);
  add(h, H, H, sc.dv, MSG, MSG, dwv + (size_t)H * MSG, MSG);
  add(x, H, H, sc.ds, K, K, dws, K);
  add(h, H, H, sc.ds, K, K, dws + (size_t)H * K, K);
  add(x, H, H, sc.dq, K, K, dwq, K);
  add(h, H, H, sc.dq, K, K, dwq + (size_t)H * K, K);
  // [x|c]^T dgi, h^T dgh (dgh = dpre_r|dpre_z|dhn)
  add(x, H, H, sc.dg, H4, H3, dwi, H3);
  add(sc.c2, MSG, MSG, sc.dg, H4, H3, dwi + (size_t)H * H3, H3);
  add(h, H, H, sc.dg, H4, 2 * H, dwh, H3);
  add(h, H, H, sc.dg + H3, H4, H, dwh + 2 * H, H3);
  // head
  add(sc.h2, H, H, sc.dadv, NACT, NACT, dwo, NACT);
  add(sc.h2, H, H, sc.dvh, 1, 1, dwvh, 1);
  // biases: column sums
  add(nullptr, 0, 1, sc.dv, MSG, MSG, dbv, MSG);
  add(nullptr, 0, 1, sc.ds, K, K, dbs, K);
  add(nullptr, 0, 1, sc.dq, K, K, dbq, K);
  add(nullptr, 0, 1, sc.dg, H4, H3, dbi, H3);
  add(nullptr, 0, 1, sc.dg, H4, 2 * H, dbh, H3);
  add(nullptr, 0, 1, sc.dg + H3, H4, H, dbh + 2 * H, H3);
  add(nullptr, 0, 1, sc.dadv, NACT, NACT, dbo, NACT);
  add(nullptr, 0, 1, sc.dvh, 1, 1, dbvh, 1);
  tarmac_step_bwd_xtg<<<tiles, kThreads, 0, stream>>>(jobs);
  return cudaGetLastError();
}

extern "C" const char* tarmac_step_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
