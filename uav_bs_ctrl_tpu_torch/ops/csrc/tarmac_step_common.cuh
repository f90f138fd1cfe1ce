// Building blocks of the fused recurrent step (TarMAC + GRU + Q head) for Hopper (sm_90a),
// shared by its forward (tarmac_step.cu) and its recompute backward (tarmac_step_bwd.cu).
//
// Both start with the same three launches, in dependency order on the caller's stream:
//   (a) products   [v|s|q] = [x|h] [wv|ws|wq] + b                      -> vsq [R, MSG + 2K]
//   (b) per world  scores, masked softmax over sources, c = alpha^T v  -> c   [R, MSG]
//   (c) products   gi = [x|c] wi + bi, gh = h wh + bh                  -> gi, gh [R, 3H]
// Rows are (world, agent), world-major, R = W*A. Only the A x A attention is tied to a
// world; every dense product runs over all R rows through one generic kernel driven by a
// job table (a job is C = sum over up to 3 segments of A_s B_s, + bias, + C), each launch
// holding the independent products of its step so that their tiles fill the card
// together. A CTA computes a 32 x 64 tile, 4 x 4 outputs a thread; the A and B slabs (32
// deep) are staged in shared memory, double-buffered, the next slab's loads in flight in
// registers while the current one is summed. A transposed operand (G W^T, X^T G) differs
// only in how a slab is loaded. Every output element is summed by one thread in a fixed k
// order: no atomics and no split of a sum across CTAs, so a repeated call is
// bit-identical. Any A and any R work (ragged tiles are masked).
//
// Each .cu includes this header once, so everything here lives in the anonymous namespace
// of that translation unit. The kernels are templates on a tag type that the .cu defines
// (tarmac_step_fwd, tarmac_step_bwd), so a profiler's kernel names tell the forward's
// launches from the backward's.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr int kWorldThreads = 128;

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

template <class Tag>
__global__ void __launch_bounds__(kProdThreads) step_products(const __grid_constant__ Jobs jobs) {
  // +1 columns: a slab stored along k (row-major A, transposed B) hits 32 banks.
  __shared__ float s_a[2][kBK][kBM + 1];
  __shared__ float s_b[2][kBK][kBN + 1];
  // The CTA's job, copied out of the parameter space once: the slab loop then reads
  // its fields from shared memory (6 % less time a call than reading them through a
  // reference to the parameters, for both libraries, H100).
  __shared__ Job J;
  if (threadIdx.x == 0) {
    int jb = 0;
    while (jb + 1 < jobs.n_jobs && (int)blockIdx.x >= jobs.job[jb + 1].tile0) ++jb;
    J = jobs.job[jb];
  }
  __syncthreads();
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
// A destination with no in-edge gets an all-zero column.
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
template <class Tag>
__global__ void __launch_bounds__(kWorldThreads) step_attend(
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

// ---- per (row, hidden column): the GRU's gates from its pre-activations ----

struct Gates {
  float r, z, n, hn;                 // hn = (h wh + bh)'s n part, before r scales it
};

// gi, gh: one row's [3H] pre-activations (r | z | n), bias included.
__device__ __forceinline__ Gates gru_gates(const float* gi, const float* gh, int j, int H) {
  Gates g;
  g.r = sigmoidf_(gi[j] + gh[j]);
  g.z = sigmoidf_(gi[H + j] + gh[H + j]);
  g.hn = gh[2 * H + j];
  g.n = tanhf(gi[2 * H + j] + g.r * g.hn);
  return g;
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

template <class Tag>
cudaError_t launch_products(Jobs& jobs, cudaStream_t stream) {
  int tiles = 0;
  for (int i = 0; i < jobs.n_jobs; ++i) {
    Job& j = jobs.job[i];
    j.tile0 = tiles;
    j.tiles_n = (j.N + kBN - 1) / kBN;
    tiles += ((j.M + kBM - 1) / kBM) * j.tiles_n;
  }
  if (tiles > 0) step_products<Tag><<<tiles, kProdThreads, 0, stream>>>(jobs);
  return cudaGetLastError();
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launches (a), (b) and (c) for R = W*A > 0 rows, into vsq [R, MSG + 2K], c [R, MSG],
// gi and gh [R, 3H].
template <class Tag>
cudaError_t launch_up_to_gates(const float* x, const float* h, const float* adjf,
                               const float* wv, const float* bv, const float* ws,
                               const float* bs, const float* wq, const float* bq,
                               const float* wi, const float* wh, const float* bi,
                               const float* bh, float* vsq, float* c, float* gi, float* gh,
                               int W, int A, int H, int MSG, int K, float key_size,
                               cudaStream_t stream) {
  const int R = W * A, H3 = 3 * H, P = MSG + 2 * K;
  cudaError_t e;
  {  // (a) [v|s|q] = [x|h] [wv|ws|wq] + [bv|bs|bq]
    Jobs jobs{};
    const float* w[3] = {wv, ws, wq};
    const float* b[3] = {bv, bs, bq};
    const int n[3] = {MSG, K, K}, col[3] = {0, MSG, MSG + K};
    for (int t = 0; t < 3; ++t) {
      Job& j = add_job(jobs, vsq + col[t], P, R, n[t], 0, 0, b[t], 0);
      add_seg(j, x, H, w[t], n[t], H);
      add_seg(j, h, H, w[t] + (size_t)H * n[t], n[t], H);
    }
    if ((e = launch_products<Tag>(jobs, stream)) != cudaSuccess) return e;
  }
  {  // (b) alpha and c, per world
    const size_t smem = sizeof(float) * (size_t)A * (P + A);
    if ((e = allow_smem((const void*)step_attend<Tag>, smem)) != cudaSuccess) return e;
    step_attend<Tag><<<W, kWorldThreads, smem, stream>>>(adjf, vsq, c, A, MSG, K, key_size);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  // (c) gi = [x|c] wi + bi, gh = h wh + bh
  Jobs jobs{};
  Job& jgi = add_job(jobs, gi, H3, R, H3, 0, 0, bi, 0);
  add_seg(jgi, x, H, wi, H3, H);
  add_seg(jgi, c, MSG, wi + (size_t)H * H3, H3, MSG);
  Job& jgh = add_job(jobs, gh, H3, R, H3, 0, 0, bh, 0);
  add_seg(jgh, h, H, wh, H3, H);
  return launch_products<Tag>(jobs, stream);
}

}  // namespace
