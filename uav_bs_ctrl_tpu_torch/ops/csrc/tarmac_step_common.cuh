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
// launches from the backward's, and on the storage type T of the call's tensors
// (storage.cuh: float or __nv_bfloat16). A product's operands are the call's tensors (T)
// or f32 scratch, fixed where the job is made: each job has a kind, a Types naming the
// storage of its operands, and a launch of step_products<Tag, Kinds...> holds jobs of
// the kinds it names. A CTA picks its job's kind once and runs that kind's product,
// whose loads and stores are typed at compile time; a bf16 load widens to f32. The slabs
// in shared memory and the sums are f32; an output is rounded to its type once, where it
// is stored. With T = float every kind is all-f32, the same product as before.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "storage.cuh"

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
  const void* a;     // A(m, k) = a[m*lda + k], or a[k*lda + m] with trans_a; nullptr: all ones
  const void* b;     // B(k, n) = b[k*ldb + n], or b[n*ldb + k] with trans_b
  int lda, ldb, k;
};

struct Job {
  Seg seg[kMaxSeg];
  void* c;               // [M, ldc]
  const void* bias;      // [N], or nullptr
  int kind;              // the position of the job's Types in its launch's Kinds
  int n_seg, trans_a, trans_b, ldc, accumulate, M, N, tile0, tiles_n;
};

struct Jobs {
  Job job[kMaxJobs];
  int n_jobs;
};
static_assert(sizeof(Jobs) <= 4096, "a job table must fit in the kernel's parameters");

// The storage types of a kind of job: A of its first segment (A0) and of the others (A),
// B and the bias (B), and C; each float or __nv_bfloat16.
template <class A0_, class A_, class B_, class C_>
struct Types {
  using A0 = A0_;
  using A = A_;
  using B = B_;
  using C = C_;
};
template <class T> using Proj = Types<T, T, T, float>;           // call tensors -> f32 scratch
template <class T> using ProjC = Types<T, float, T, float>;      // [x|c] wi: x, then scratch c
template <class T> using Back = Types<float, float, T, float>;   // scratch x weights -> scratch
template <class T> using GradX = Types<T, T, float, T>;          // X^T G for a call tensor X
template <class T> using GradS = Types<float, float, float, T>;  // X^T G for scratch (or ones) X

// The position of Ty among Kinds (its first, where a kind repeats, as all do at f32).
template <class Ty, class... Kinds> struct KindOf;
template <class Ty, class... Rest> struct KindOf<Ty, Ty, Rest...> {
  static constexpr int value = 0;
};
template <class Ty, class Other, class... Rest> struct KindOf<Ty, Other, Rest...> {
  static constexpr int value = 1 + KindOf<Ty, Rest...>::value;
};

// A slab travels from global to shared memory as raw 32-bit words: an f32's bits, or a
// bf16's 16 bits as loaded. A bf16 word is widened (<< kWiden) only where store_slab
// writes the slab to shared memory, after the slab before it has been summed: no
// instruction waits on the loads in between, as with f32.
template <class T> using Raw =
    typename std::conditional<std::is_same<T, float>::value, float, unsigned short>::type;
template <class T> constexpr int kWiden = std::is_same<T, float>::value ? 0 : 16;

struct Slab {
  unsigned a[kLoadA], b[kLoadB];
  int seg;                          // the segment it was loaded from
};

template <class R>
__device__ __forceinline__ unsigned raw_bits(R v) {
  if constexpr (std::is_same<R, float>::value) {
    return float_bits(v);
  } else {
    return v;                       // a bf16's bits, loaded as an unsigned short
  }
}

// The A values of the slab at depth k0 from an operand stored as T; ragged edges read as
// 0, a missing A (a bias sum's ones column) as 1.
template <class T>
__device__ __forceinline__ void load_a(const Job& J, const Seg& S, int k0, int m0,
                                       unsigned (&ra)[kLoadA]) {
  const Raw<T>* a = static_cast<const Raw<T>*>(S.a);
  const unsigned one = float_bits(1.f) >> kWiden<T>;
#pragma unroll
  for (int i = 0; i < kLoadA; ++i) {
    const int e = threadIdx.x + i * kProdThreads;
    const int m = J.trans_a ? e % kBM : e / kBK, k = J.trans_a ? e / kBM : e % kBK;
    const int gm = m0 + m, gk = k0 + k;
    unsigned v = 0u;
    if (gm < J.M && gk < S.k) {
      if (a == nullptr) v = one;
      else v = raw_bits(J.trans_a ? a[(size_t)gk * S.lda + gm] : a[(size_t)gm * S.lda + gk]);
    }
    ra[i] = v;
  }
}

// The B values of the slab at depth k0 from an operand stored as T.
template <class T>
__device__ __forceinline__ void load_b(const Job& J, const Seg& S, int k0, int n0,
                                       unsigned (&rb)[kLoadB]) {
  const Raw<T>* b = static_cast<const Raw<T>*>(S.b);
#pragma unroll
  for (int i = 0; i < kLoadB; ++i) {
    const int e = threadIdx.x + i * kProdThreads;
    const int n = J.trans_b ? e / kBK : e % kBN, k = J.trans_b ? e % kBK : e / kBN;
    const int gn = n0 + n, gk = k0 + k;
    unsigned v = 0u;
    if (gn < J.N && gk < S.k)
      v = raw_bits(J.trans_b ? b[(size_t)gn * S.ldb + gk] : b[(size_t)gk * S.ldb + gn]);
    rb[i] = v;
  }
}

// The slab of segment `sg` at depth k0 into registers. Each operand is walked along its
// contiguous dimension, so a warp's loads coalesce.
template <class Ty>
__device__ __forceinline__ void load_slab(const Job& J, int sg, int k0, int m0, int n0,
                                          Slab& r) {
  const Seg& S = J.seg[sg];
  if (std::is_same<typename Ty::A0, typename Ty::A>::value || sg > 0)
    load_a<typename Ty::A>(J, S, k0, m0, r.a);
  else
    load_a<typename Ty::A0>(J, S, k0, m0, r.a);
  load_b<typename Ty::B>(J, S, k0, n0, r.b);
  r.seg = sg;
}

// The slab in f32 into shared memory (a bf16 word widened).
template <class Ty>
__device__ __forceinline__ void store_slab(const Job& J, const Slab& r, float (*s_a)[kBM + 1],
                                           float (*s_b)[kBN + 1]) {
  const int widen_a = r.seg > 0 ? kWiden<typename Ty::A> : kWiden<typename Ty::A0>;
#pragma unroll
  for (int i = 0; i < kLoadA; ++i) {
    const int e = threadIdx.x + i * kProdThreads;
    const int m = J.trans_a ? e % kBM : e / kBK, k = J.trans_a ? e / kBM : e % kBK;
    s_a[k][m] = bits_float(r.a[i] << widen_a);
  }
#pragma unroll
  for (int i = 0; i < kLoadB; ++i) {
    const int e = threadIdx.x + i * kProdThreads;
    const int n = J.trans_b ? e / kBK : e % kBN, k = J.trans_b ? e % kBK : e / kBN;
    s_b[k][n] = bits_float(r.b[i] << kWiden<typename Ty::B>);
  }
}

// The CTA's 4 x 4 outputs a thread: + bias, + the output's old value where the job
// accumulates, stored.
template <class Ty>
__device__ __forceinline__ void store_tile(const Job& J, const float (&acc)[4][4], int m0,
                                           int n0, int tx, int ty) {
  using C = typename Ty::C;
  C* c = static_cast<C*>(J.c);
  const typename Ty::B* bias = static_cast<const typename Ty::B*>(J.bias);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= J.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= J.N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += to_f32(bias[n]);
      C* out = c + (size_t)m * J.ldc + n;
      if (J.accumulate) v = to_f32(*out) + v;
      *out = from_f32<C>(v);
    }
  }
}

// The CTA's tile of a job of kind Ty, its slabs double-buffered in s_a, s_b.
template <class Ty>
__device__ __forceinline__ void product_tile(const Job& J, float (*s_a)[kBK][kBM + 1],
                                             float (*s_b)[kBK][kBN + 1]) {
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
  Slab slab;

  skip_done();
  if (n_slabs > 0) {
    load_slab<Ty>(J, sg, k0, m0, n0, slab);
    k0 += kBK;
    skip_done();
    store_slab<Ty>(J, slab, s_a[0], s_b[0]);
  }
  __syncthreads();
  for (int t = 0; t < n_slabs; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < n_slabs;
    if (more) {
      load_slab<Ty>(J, sg, k0, m0, n0, slab);
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
    if (more) store_slab<Ty>(J, slab, s_a[buf ^ 1], s_b[buf ^ 1]);
    __syncthreads();
  }
  store_tile<Ty>(J, acc, m0, n0, tx, ty);
}

// The CTA's job through its kind's product_tile; a kind that repeats an earlier one
// (every kind at f32) is never taken, so its copy is dead code.
template <class... Kinds, size_t... I>
__device__ __forceinline__ void run_kind(const Job& J, float (*s_a)[kBK][kBM + 1],
                                         float (*s_b)[kBK][kBN + 1], std::index_sequence<I...>) {
  ((KindOf<Kinds, Kinds...>::value == (int)I && J.kind == (int)I
        ? product_tile<Kinds>(J, s_a, s_b)
        : void()),
   ...);
}

template <class Tag, class... Kinds>
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
  run_kind<Kinds...>(J, s_a, s_b, std::index_sequence_for<Kinds...>{});
}

// ---- per world: the A x A attention ----

// alpha[s*A + d] of one world: the masked softmax over sources s of (s_s . q_d) / key,
// from the world's [v|s|q] rows in s_vsq [A, P]; adj is the world's [A(src), A(dst)] block.
// A destination with no in-edge gets an all-zero column.
template <class T>
__device__ void world_alpha(const float* s_vsq, const T* __restrict__ adj, int A, int MSG,
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
      sc = to_f32(adj[s * A + d]) > 0.f ? sc : kNegBig;
      s_alpha[s * A + d] = sc;
      mx = fmaxf(mx, sc);
    }
    const float shift = mx <= kNegBig / 2 ? 0.f : mx;
    float den = 0.f;
    for (int s = 0; s < A; ++s) {
      const float p = to_f32(adj[s * A + d]) > 0.f ? expf(s_alpha[s * A + d] - shift) : 0.f;
      s_alpha[s * A + d] = p;
      den += p;
    }
    den = fmaxf(den, 1e-30f);
    for (int s = 0; s < A; ++s) s_alpha[s * A + d] = s_alpha[s * A + d] / den;
  }
}

// (b) c = alpha^T v for one world, written to c2 [R, MSG].
template <class Tag, class T>
__global__ void __launch_bounds__(kWorldThreads) step_attend(
    const T* __restrict__ adjf, const float* __restrict__ vsq, float* __restrict__ c2,
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

// The jobs of one launch of step_products<Tag, Kinds...>, each of one of those kinds.
template <class Tag, class... Kinds>
struct Products {
  Jobs jobs{};

  template <class Ty>
  Job& add(typename Ty::C* c, int ldc, int M, int N, int trans_a, int trans_b,
           const typename Ty::B* bias, int accumulate) {
    Job& j = jobs.job[jobs.n_jobs++];
    j = Job{};
    j.c = c;
    j.bias = bias;
    j.kind = KindOf<Ty, Kinds...>::value;
    j.ldc = ldc;
    j.M = M;
    j.N = N;
    j.trans_a = trans_a;
    j.trans_b = trans_b;
    j.accumulate = accumulate;
    return j;
  }

  cudaError_t launch(cudaStream_t stream) {
    int tiles = 0;
    for (int i = 0; i < jobs.n_jobs; ++i) {
      Job& j = jobs.job[i];
      j.tile0 = tiles;
      j.tiles_n = (j.N + kBN - 1) / kBN;
      tiles += ((j.M + kBM - 1) / kBM) * j.tiles_n;
    }
    auto kernel = step_products<Tag, Kinds...>;
    if (tiles > 0) kernel<<<tiles, kProdThreads, 0, stream>>>(jobs);
    return cudaGetLastError();
  }
};

// A segment of a job of kind Ty: A of Ty's A0 (the first segment) or A (the others),
// nullptr for a column of ones.
template <class Ty, class TA>
void add_seg(Job& j, const TA* a, int lda, const typename Ty::B* b, int ldb, int k) {
  static_assert(std::is_same<TA, typename Ty::A0>::value ||
                std::is_same<TA, typename Ty::A>::value, "an A of the job's kind");
  Seg& s = j.seg[j.n_seg++];
  s = Seg{};
  s.a = a;
  s.b = b;
  s.lda = lda;
  s.ldb = ldb;
  s.k = k;
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launches (a), (b) and (c) for R = W*A > 0 rows, into vsq [R, MSG + 2K], c [R, MSG],
// gi and gh [R, 3H] (f32 scratch).
template <class Tag, class T>
cudaError_t launch_up_to_gates(const T* x, const T* h, const T* adjf, const T* wv,
                               const T* bv, const T* ws, const T* bs, const T* wq,
                               const T* bq, const T* wi, const T* wh, const T* bi,
                               const T* bh, float* vsq, float* c, float* gi, float* gh,
                               int W, int A, int H, int MSG, int K, float key_size,
                               cudaStream_t stream) {
  const int R = W * A, H3 = 3 * H, P = MSG + 2 * K;
  cudaError_t e;
  {  // (a) [v|s|q] = [x|h] [wv|ws|wq] + [bv|bs|bq]
    Products<Tag, Proj<T>> p;
    const T* w[3] = {wv, ws, wq};
    const T* b[3] = {bv, bs, bq};
    const int n[3] = {MSG, K, K}, col[3] = {0, MSG, MSG + K};
    for (int t = 0; t < 3; ++t) {
      Job& j = p.template add<Proj<T>>(vsq + col[t], P, R, n[t], 0, 0, b[t], 0);
      add_seg<Proj<T>>(j, x, H, w[t], n[t], H);
      add_seg<Proj<T>>(j, h, H, w[t] + (size_t)H * n[t], n[t], H);
    }
    if ((e = p.launch(stream)) != cudaSuccess) return e;
  }
  {  // (b) alpha and c, per world
    const size_t smem = sizeof(float) * (size_t)A * (P + A);
    auto attend = step_attend<Tag, T>;
    if ((e = allow_smem((const void*)attend, smem)) != cudaSuccess) return e;
    attend<<<W, kWorldThreads, smem, stream>>>(adjf, vsq, c, A, MSG, K, key_size);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  // (c) gi = [x|c] wi + bi, gh = h wh + bh
  Products<Tag, ProjC<T>> p;
  Job& jgi = p.template add<ProjC<T>>(gi, H3, R, H3, 0, 0, bi, 0);
  add_seg<ProjC<T>>(jgi, x, H, wi, H3, H);
  add_seg<ProjC<T>>(jgi, (const float*)c, MSG, wi + (size_t)H * H3, H3, MSG);
  Job& jgh = p.template add<ProjC<T>>(gh, H3, R, H3, 0, 0, bh, 0);
  add_seg<ProjC<T>>(jgh, h, H, wh, H3, H);
  return p.launch(stream);
}

}  // namespace
