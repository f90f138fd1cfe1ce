// Backward of the fused recurrent step (TarMAC + GRU + Q head) for Hopper (sm_90a).
//
// Replaces the TPU kernel uav_bs_ctrl_tpu/ops/step_kernels.py:_tst_bwd (:379; body
// _step_bwd_kernel, :154). Recompute style: from the step's inputs (x, h, adjf, weights)
// and the cotangents gq, gh2 it rebuilds v/s/q, alpha, c and the GRU gates, then runs the
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
// Design. Seven launches per call, in dependency order, all on the caller's stream:
//   (a) products   [v|s|q] = [x|h] [wv|ws|wq] + b                      -> scratch
//   (b) per world  scores, masked softmax over sources, c = alpha^T v  -> scratch
//   (c) products   gi = [x|c] wi + bi, gh = h wh + bh                  -> scratch
//   (d) per (row, hidden column): gates, h2, the head backward, the GRU backward -> dg, dh = dh2 z
//   (e) products   dx = dgi wi[:H]^T, dc = dgi wi[H:]^T, dh += dgh wh^T
//   (f) per world  alpha again (same code as (b)), dalpha, dscore, dv, ds, dq
//   (g) products   dx += [dv|ds|dq] [wv|ws|wq][:H]^T, and the 14 weight gradients X^T G
//                  (a bias gradient is a ones column times G)
// Only the A x A attention is tied to a world. Everything else is a dense product over
// all R = W*A rows, so it is tiled by rows and columns across the whole card: at the
// training batch (R = 256) one CTA per world would keep 32 of the 132 SMs busy and
// stream every weight from L2 for 8 rows. One generic kernel runs every product from a
// job table (a job is C = sum over up to 3 segments of A_s B_s, + bias, + C), each
// launch holding the independent products of its step so that their tiles fill the card
// together. A CTA computes a 32 x 64 tile, 4 x 4 outputs a thread; the A and B slabs
// (32 deep) are staged in shared memory, double-buffered, the next slab's loads in
// flight in registers while the current one is summed. A transposed operand (G W^T,
// X^T G) differs only in how a slab is loaded. Every output element is summed by one
// thread in a fixed k order: no atomics and no split of a sum across CTAs, so a repeated
// call is bit-identical. Any A and any R work (ragged tiles are masked).
// What bounds it: f32 arithmetic outside the tensor cores, about 0.0112 ms at R = 256
// (the 8-UBS training inputs) on an H100 at 67 TFLOP/s. Split-precision 3xTF32 mma.sync
// products are the route to the tensor cores at f32 accuracy, and later work.

#include <cuda_runtime.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr int kWorldThreads = 128;
constexpr int kGateThreads = 256;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// ---- the tiled product: C[M, N] = sum_s A_s B_s (+ bias) (+ C) ----

constexpr int kBM = 32, kBN = 64, kBK = 32;
constexpr int kProdThreads = kBM * kBN / 16;           // 4 x 4 outputs a thread
constexpr int kLoadA = kBM * kBK / kProdThreads;       // slab values a thread loads
constexpr int kLoadB = kBK * kBN / kProdThreads;
constexpr int kMaxSeg = 3;
constexpr int kMaxJobs = 22;

struct Seg {
  const float* a;    // A(m, k) = a[m*lda + k], or a[k*lda + m] with trans_a; nullptr: all ones
  const float* b;    // B(k, n) = b[k*ldb + n], or b[n*ldb + k] with trans_b
  int lda, ldb, k;
};

struct Job {
  Seg seg[kMaxSeg];
  float* c;              // [M, ldc]
  const float* bias;     // [N], or nullptr
  int n_seg, trans_a, trans_b, ldc, accumulate, M, N, tile0, tiles_n;
};

struct Jobs {
  Job job[kMaxJobs];
  int n_jobs;
};
static_assert(sizeof(Jobs) <= 4096, "a job table must fit in the kernel's parameters");

// The slab of segment `sg` at depth k0 into registers; ragged edges read as 0. Each
// operand is walked along its contiguous dimension, so a warp's loads coalesce.
__device__ __forceinline__ void load_slab(const Job& J, int sg, int k0, int m0, int n0,
                                          float (&ra)[kLoadA], float (&rb)[kLoadB]) {
  const Seg& S = J.seg[sg];
#pragma unroll
  for (int i = 0; i < kLoadA; ++i) {
    const int e = threadIdx.x + i * kProdThreads;
    const int m = J.trans_a ? e % kBM : e / kBK, k = J.trans_a ? e / kBM : e % kBK;
    const int gm = m0 + m, gk = k0 + k;
    float v = 0.f;
    if (gm < J.M && gk < S.k) {
      if (S.a == nullptr) v = 1.f;
      else v = J.trans_a ? S.a[(size_t)gk * S.lda + gm] : S.a[(size_t)gm * S.lda + gk];
    }
    ra[i] = v;
  }
#pragma unroll
  for (int i = 0; i < kLoadB; ++i) {
    const int e = threadIdx.x + i * kProdThreads;
    const int n = J.trans_b ? e / kBK : e % kBN, k = J.trans_b ? e % kBK : e / kBN;
    const int gn = n0 + n, gk = k0 + k;
    float v = 0.f;
    if (gn < J.N && gk < S.k)
      v = J.trans_b ? S.b[(size_t)gn * S.ldb + gk] : S.b[(size_t)gk * S.ldb + gn];
    rb[i] = v;
  }
}

__device__ __forceinline__ void store_slab(const Job& J, const float (&ra)[kLoadA],
                                           const float (&rb)[kLoadB],
                                           float (*s_a)[kBM + 1], float (*s_b)[kBN + 1]) {
#pragma unroll
  for (int i = 0; i < kLoadA; ++i) {
    const int e = threadIdx.x + i * kProdThreads;
    const int m = J.trans_a ? e % kBM : e / kBK, k = J.trans_a ? e / kBM : e % kBK;
    s_a[k][m] = ra[i];
  }
#pragma unroll
  for (int i = 0; i < kLoadB; ++i) {
    const int e = threadIdx.x + i * kProdThreads;
    const int n = J.trans_b ? e / kBK : e % kBN, k = J.trans_b ? e % kBK : e / kBN;
    s_b[k][n] = rb[i];
  }
}

__global__ void __launch_bounds__(kProdThreads) tarmac_step_bwd_products(
    const __grid_constant__ Jobs jobs) {
  // +1 columns: a slab stored along k (row-major A, transposed B) hits 32 banks.
  __shared__ float s_a[2][kBK][kBM + 1];
  __shared__ float s_b[2][kBK][kBN + 1];
  int jb = 0;
  while (jb + 1 < jobs.n_jobs && (int)blockIdx.x >= jobs.job[jb + 1].tile0) ++jb;
  const Job& J = jobs.job[jb];
  const int local = blockIdx.x - J.tile0;
  const int m0 = (local / J.tiles_n) * kBM, n0 = (local % J.tiles_n) * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  int n_slabs = 0;
  for (int s = 0; s < J.n_seg; ++s) n_slabs += (J.seg[s].k + kBK - 1) / kBK;
  int sg = 0, k0 = 0;                     // the next slab to load
  auto skip_done = [&]() {
    while (sg < J.n_seg && k0 >= J.seg[sg].k) {
      k0 = 0;
      ++sg;
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float ra[kLoadA], rb[kLoadB];

  skip_done();
  if (n_slabs > 0) {
    load_slab(J, sg, k0, m0, n0, ra, rb);
    k0 += kBK;
    skip_done();
    store_slab(J, ra, rb, s_a[0], s_b[0]);
  }
  __syncthreads();
  for (int t = 0; t < n_slabs; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < n_slabs;
    if (more) {
      load_slab(J, sg, k0, m0, n0, ra, rb);
      k0 += kBK;
      skip_done();
    }
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s_a[buf][kk][ty + 8 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s_b[buf][kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store_slab(J, ra, rb, s_a[buf ^ 1], s_b[buf ^ 1]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= J.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= J.N) continue;
      float v = acc[i][j];
      if (J.bias != nullptr) v += J.bias[n];
      float* out = J.c + (size_t)m * J.ldc + n;
      if (J.accumulate) v = *out + v;
      *out = v;
    }
  }
}

// ---- per world: the A x A attention ----

// alpha[s*A + d] of one world: the masked softmax over sources s of (s_s . q_d) / key,
// from the world's [v|s|q] rows in s_vsq [A, P]; adj is the world's [A(src), A(dst)] block.
__device__ void world_alpha(const float* s_vsq, const float* __restrict__ adj, int A, int MSG,
                            int K, float key_size, float* s_alpha) {
  const int P = MSG + 2 * K;
  for (int d = threadIdx.x; d < A; d += blockDim.x) {
    const float* qd = s_vsq + d * P + MSG + K;
    float mx = kNegBig;
    for (int s = 0; s < A; ++s) {
      const float* ss = s_vsq + s * P + MSG;
      float sc = 0.f;
      for (int k = 0; k < K; ++k) sc = fmaf(ss[k], qd[k], sc);
      sc = sc / key_size;
      sc = adj[s * A + d] > 0.f ? sc : kNegBig;
      s_alpha[s * A + d] = sc;
      mx = fmaxf(mx, sc);
    }
    const float shift = mx <= kNegBig / 2 ? 0.f : mx;
    float den = 0.f;
    for (int s = 0; s < A; ++s) {
      const float p = adj[s * A + d] > 0.f ? expf(s_alpha[s * A + d] - shift) : 0.f;
      s_alpha[s * A + d] = p;
      den += p;
    }
    den = fmaxf(den, 1e-30f);
    for (int s = 0; s < A; ++s) s_alpha[s * A + d] = s_alpha[s * A + d] / den;
  }
}

// (b) c = alpha^T v for one world, written to c2 [R, MSG].
__global__ void __launch_bounds__(kWorldThreads) tarmac_step_bwd_attend(
    const float* __restrict__ adjf, const float* __restrict__ vsq, float* __restrict__ c2,
    int A, int MSG, int K, float key_size) {
  extern __shared__ float smem[];
  const int P = MSG + 2 * K;
  float* s_vsq = smem;                // [A, P]
  float* s_alpha = s_vsq + A * P;     // [A(src), A(dst)]
  const size_t row0 = (size_t)blockIdx.x * A;
  for (int i = threadIdx.x; i < A * P; i += blockDim.x) s_vsq[i] = vsq[row0 * P + i];
  __syncthreads();
  world_alpha(s_vsq, adjf + row0 * A, A, MSG, K, key_size, s_alpha);
  __syncthreads();
  for (int i = threadIdx.x; i < A * MSG; i += blockDim.x) {
    const int d = i / MSG, m = i % MSG;
    float acc = 0.f;
    for (int s = 0; s < A; ++s) acc = fmaf(s_alpha[s * A + d], s_vsq[s * P + m], acc);
    c2[row0 * MSG + i] = acc;
  }
}

// (f) the attention backward of one world, from dc: dv, ds, dq.
__global__ void __launch_bounds__(kWorldThreads) tarmac_step_bwd_attend_bwd(
    const float* __restrict__ adjf, const float* __restrict__ vsq,
    const float* __restrict__ dc, float* __restrict__ dv, float* __restrict__ ds,
    float* __restrict__ dq, int A, int MSG, int K, float key_size) {
  extern __shared__ float smem[];
  const int P = MSG + 2 * K;
  float* s_vsq = smem;                // [A, P]
  float* s_alpha = s_vsq + A * P;     // [A(src), A(dst)]
  float* s_dc = s_alpha + A * A;      // [A, MSG]
  float* s_dsc = s_dc + A * MSG;      // [A(src), A(dst)] dalpha, then dscore
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * A;
  for (int i = tid; i < A * P; i += blockDim.x) s_vsq[i] = vsq[row0 * P + i];
  for (int i = tid; i < A * MSG; i += blockDim.x) s_dc[i] = dc[row0 * MSG + i];
  __syncthreads();
  world_alpha(s_vsq, adjf + row0 * A, A, MSG, K, key_size, s_alpha);
  for (int i = tid; i < A * A; i += blockDim.x) {
    const int s = i / A, d = i % A;
    float acc = 0.f;
    for (int m = 0; m < MSG; ++m) acc = fmaf(s_vsq[s * P + m], s_dc[d * MSG + m], acc);
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
    dv[row0 * MSG + i] = acc;
  }
  for (int i = tid; i < A * K; i += blockDim.x) {
    const int r = i / K, k = i % K;
    float acc_s = 0.f, acc_q = 0.f;
    for (int o = 0; o < A; ++o) {
      acc_s = fmaf(s_dsc[r * A + o], s_vsq[o * P + MSG + K + k], acc_s);  // sum_d dscore[r,d] q_d
      acc_q = fmaf(s_dsc[o * A + r], s_vsq[o * P + MSG + k], acc_q);      // sum_s dscore[s,r] s_s
    }
    ds[row0 * K + i] = acc_s / key_size;
    dq[row0 * K + i] = acc_q / key_size;
  }
}

// ---- (d) per (row, hidden column): gates, head backward, GRU backward ----

struct Scratch {                    // per-row intermediates, each [R, width]
  float* dg;                        // 4H   dpre_r | dpre_z | dpre_n | dhn
  float* c2;                        // MSG  c
  float* h2;                        // H
  float* dv;                        // MSG
  float* ds;                        // K
  float* dq;                        // K
  float* dadv;                      // NACT
  float* dvh;                       // 1
  float* vsq;                       // MSG + 2K   v | s | q
  float* gi;                        // 3H   [x|c] wi + bi
  float* gh;                        // 3H   h wh + bh
  float* dc;                        // MSG
};

__global__ void __launch_bounds__(kGateThreads) tarmac_step_bwd_gates(
    const float* __restrict__ h, const float* __restrict__ wo, const float* __restrict__ wvh,
    const float* __restrict__ gq, const float* __restrict__ gh2, float* __restrict__ dh,
    Scratch sc, int R, int H, int NACT, int dueling) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * H) return;
  const size_t row = i / H;
  const int j = (int)(i % H);
  const float* gi = sc.gi + row * 3 * H;
  const float* gh = sc.gh + row * 3 * H;
  const float rg = sigmoidf_(gi[j] + gh[j]);
  const float zg = sigmoidf_(gi[H + j] + gh[H + j]);
  const float hnb = gh[2 * H + j];
  const float ng = tanhf(gi[2 * H + j] + rg * hnb);
  const float hp = h[i];
  sc.h2[i] = (1.f - zg) * ng + zg * hp;

  const float* g = gq + row * NACT;
  float sum = 0.f;
  if (dueling)
    for (int o = 0; o < NACT; ++o) sum += g[o];
  const float mean = sum / NACT;
  float dh2 = 0.f;
  for (int o = 0; o < NACT; ++o) {
    const float da = dueling ? g[o] - mean : g[o];
    dh2 = fmaf(da, wo[(size_t)j * NACT + o], dh2);
    if (j == 0) sc.dadv[row * NACT + o] = da;
  }
  if (dueling) dh2 = fmaf(sum, wvh[j], dh2);
  if (j == 0) sc.dvh[row] = sum;
  dh2 += gh2[i];

  const float dn = dh2 * (1.f - zg);
  const float dz = dh2 * (hp - ng);
  const float dpre_n = dn * (1.f - ng * ng);
  const float dr = dpre_n * hnb;
  float* out = sc.dg + row * 4 * H;
  out[j] = dr * rg * (1.f - rg);
  out[H + j] = dz * zg * (1.f - zg);
  out[2 * H + j] = dpre_n;
  out[3 * H + j] = dpre_n * rg;
  dh[i] = dh2 * zg;
}

// ---- host side ----

Job& add_job(Jobs& jobs, float* c, int ldc, int M, int N, int trans_a, int trans_b,
             const float* bias, int accumulate) {
  Job& j = jobs.job[jobs.n_jobs++];
  j = Job{};
  j.c = c;
  j.ldc = ldc;
  j.M = M;
  j.N = N;
  j.trans_a = trans_a;
  j.trans_b = trans_b;
  j.bias = bias;
  j.accumulate = accumulate;
  return j;
}

void add_seg(Job& j, const float* a, int lda, const float* b, int ldb, int k) {
  j.seg[j.n_seg++] = Seg{a, b, lda, ldb, k};
}

cudaError_t launch_products(Jobs& jobs, cudaStream_t stream) {
  int tiles = 0;
  for (int i = 0; i < jobs.n_jobs; ++i) {
    Job& j = jobs.job[i];
    j.tile0 = tiles;
    j.tiles_n = (j.N + kBN - 1) / kBN;
    tiles += ((j.M + kBM - 1) / kBM) * j.tiles_n;
  }
  if (tiles > 0) tarmac_step_bwd_products<<<tiles, kProdThreads, 0, stream>>>(jobs);
  return cudaGetLastError();
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  const int R = W * A, H3 = 3 * H, H4 = 4 * H, P = MSG + 2 * K;
  Scratch sc;
  sc.dg = scratch;
  sc.c2 = sc.dg + (size_t)R * H4;
  sc.h2 = sc.c2 + (size_t)R * MSG;
  sc.dv = sc.h2 + (size_t)R * H;
  sc.ds = sc.dv + (size_t)R * MSG;
  sc.dq = sc.ds + (size_t)R * K;
  sc.dadv = sc.dq + (size_t)R * K;
  sc.dvh = sc.dadv + (size_t)R * NACT;
  sc.vsq = sc.dvh + (size_t)R;
  sc.gi = sc.vsq + (size_t)R * P;
  sc.gh = sc.gi + (size_t)R * H3;
  sc.dc = sc.gh + (size_t)R * H3;
  cudaError_t e;

  if (R > 0) {
    {  // (a) [v|s|q] = [x|h] [wv|ws|wq] + [bv|bs|bq]
      Jobs jobs{};
      const float* w[3] = {wv, ws, wq};
      const float* b[3] = {bv, bs, bq};
      const int n[3] = {MSG, K, K}, col[3] = {0, MSG, MSG + K};
      for (int t = 0; t < 3; ++t) {
        Job& j = add_job(jobs, sc.vsq + col[t], P, R, n[t], 0, 0, b[t], 0);
        add_seg(j, x, H, w[t], n[t], H);
        add_seg(j, h, H, w[t] + (size_t)H * n[t], n[t], H);
      }
      if ((e = launch_products(jobs, stream)) != cudaSuccess) return e;
    }
    {  // (b) alpha and c, per world
      const size_t smem = sizeof(float) * (size_t)A * (P + A);
      if ((e = allow_smem((const void*)tarmac_step_bwd_attend, smem)) != cudaSuccess) return e;
      tarmac_step_bwd_attend<<<W, kWorldThreads, smem, stream>>>(adjf, sc.vsq, sc.c2, A, MSG,
                                                                 K, key_size);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    {  // (c) gi = [x|c] wi + bi, gh = h wh + bh
      Jobs jobs{};
      Job& gi = add_job(jobs, sc.gi, H3, R, H3, 0, 0, bi, 0);
      add_seg(gi, x, H, wi, H3, H);
      add_seg(gi, sc.c2, MSG, wi + (size_t)H * H3, H3, MSG);
      Job& gh = add_job(jobs, sc.gh, H3, R, H3, 0, 0, bh, 0);
      add_seg(gh, h, H, wh, H3, H);
      if ((e = launch_products(jobs, stream)) != cudaSuccess) return e;
    }
    {  // (d) gates, head and GRU backward; dh = dh2 z
      const size_t n = (size_t)R * H;
      const unsigned blocks = (unsigned)((n + kGateThreads - 1) / kGateThreads);
      tarmac_step_bwd_gates<<<blocks, kGateThreads, 0, stream>>>(h, wo, wvh, gq, gh2, dh, sc,
                                                                 R, H, NACT, dueling);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    {  // (e) dx = dgi wi[:H]^T, dc = dgi wi[H:]^T, dh += dgh wh^T (dgh = dpre_r|dpre_z|dhn)
      Jobs jobs{};
      Job& jdx = add_job(jobs, dx, H, R, H, 0, 1, nullptr, 0);
      add_seg(jdx, sc.dg, H4, wi, H3, H3);
      Job& jdc = add_job(jobs, sc.dc, MSG, R, MSG, 0, 1, nullptr, 0);
      add_seg(jdc, sc.dg, H4, wi + (size_t)H * H3, H3, H3);
      Job& jdh = add_job(jobs, dh, H, R, H, 0, 1, nullptr, 1);
      add_seg(jdh, sc.dg, H4, wh, H3, 2 * H);
      add_seg(jdh, sc.dg + H3, H4, wh + 2 * H, H3, H);
      if ((e = launch_products(jobs, stream)) != cudaSuccess) return e;
    }
    {  // (f) dv, ds, dq, per world
      const size_t smem = sizeof(float) * (size_t)A * (P + 2 * A + MSG);
      if ((e = allow_smem((const void*)tarmac_step_bwd_attend_bwd, smem)) != cudaSuccess)
        return e;
      tarmac_step_bwd_attend_bwd<<<W, kWorldThreads, smem, stream>>>(
          adjf, sc.vsq, sc.dc, sc.dv, sc.ds, sc.dq, A, MSG, K, key_size);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  }

  // (g) dx += [dv|ds|dq] [wv|ws|wq][:H]^T, and the weight gradients X^T G over all rows
  // (a bias gradient is a ones column, X = nullptr, times G). With R = 0 they are zeros.
  Jobs jobs{};
  Job& jdx = add_job(jobs, dx, H, R, H, 0, 1, nullptr, 1);
  add_seg(jdx, sc.dv, MSG, wv, MSG, MSG);
  add_seg(jdx, sc.ds, K, ws, K, K);
  add_seg(jdx, sc.dq, K, wq, K, K);
  auto xtg = [&](const float* X, int ldx, int xcols, const float* G, int ldg, int gcols,
                 float* out, int ldo) {
    Job& j = add_job(jobs, out, ldo, xcols, gcols, 1, 0, nullptr, 0);
    add_seg(j, X, ldx, G, ldg, R);
  };
  // [x|h]^T dv, ds, dq and their biases
  xtg(x, H, H, sc.dv, MSG, MSG, dwv, MSG);
  xtg(h, H, H, sc.dv, MSG, MSG, dwv + (size_t)H * MSG, MSG);
  xtg(x, H, H, sc.ds, K, K, dws, K);
  xtg(h, H, H, sc.ds, K, K, dws + (size_t)H * K, K);
  xtg(x, H, H, sc.dq, K, K, dwq, K);
  xtg(h, H, H, sc.dq, K, K, dwq + (size_t)H * K, K);
  // [x|c]^T dgi, h^T dgh
  xtg(x, H, H, sc.dg, H4, H3, dwi, H3);
  xtg(sc.c2, MSG, MSG, sc.dg, H4, H3, dwi + (size_t)H * H3, H3);
  xtg(h, H, H, sc.dg, H4, 2 * H, dwh, H3);
  xtg(h, H, H, sc.dg + H3, H4, H, dwh + 2 * H, H3);
  // head
  xtg(sc.h2, H, H, sc.dadv, NACT, NACT, dwo, NACT);
  xtg(sc.h2, H, H, sc.dvh, 1, 1, dwvh, 1);
  // biases: column sums
  xtg(nullptr, 0, 1, sc.dv, MSG, MSG, dbv, MSG);
  xtg(nullptr, 0, 1, sc.ds, K, K, dbs, K);
  xtg(nullptr, 0, 1, sc.dq, K, K, dbq, K);
  xtg(nullptr, 0, 1, sc.dg, H4, H3, dbi, H3);
  xtg(nullptr, 0, 1, sc.dg, H4, 2 * H, dbh, H3);
  xtg(nullptr, 0, 1, sc.dg + H3, H4, H, dbh + 2 * H, H3);
  xtg(nullptr, 0, 1, sc.dadv, NACT, NACT, dbo, NACT);
  xtg(nullptr, 0, 1, sc.dvh, 1, 1, dbvh, 1);
  return launch_products(jobs, stream);
}

extern "C" const char* tarmac_step_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
