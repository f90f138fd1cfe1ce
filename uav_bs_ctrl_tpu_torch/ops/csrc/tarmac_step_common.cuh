// Building blocks of the fused recurrent step (TarMAC + GRU + Q head) for Hopper (sm_90a),
// shared by its forward (tarmac_step.cu) and its recompute backward (tarmac_step_bwd.cu).
//
// Both start with the same three launches, in dependency order on the caller's stream:
//   (a) products   [v|s|q] = [x|h] [wv|ws|wq] + b                      -> vsq [R, MSG + 2K]
//   (b) per world  scores, masked softmax over sources, c = alpha^T v  -> c   [R, MSG]
//   (c) products   gi = [x|c] wi + bi, gh = h wh + bh                  -> gi, gh [R, 3H]
// A column-split call (an mp rank's share of the GRU, hidden columns [lo, hi) of each gate)
// runs (a) and (b) whole and (c) on its columns only (launch_gate_cols): gi, gh [R, 3w] for
// w = hi - lo, gate g's columns at g w.
// Rows are (world, agent), world-major, R = W*A. Only the A x A attention is tied to a
// world; every dense product runs over all R rows through one generic kernel driven by a
// job table (a job is C = sum over up to 3 segments of A_s B_s, + bias, + C), each launch
// holding the independent products of its step so that their tiles fill the card
// together. A CTA of 4 warps computes a 32 x 64 tile, walking k in slabs 32 deep; a
// transposed operand (G W^T, X^T G) differs only in how a slab is loaded. Any A and any R
// work (ragged tiles are masked). No atomics, so a repeated call is bit-identical.
//
// The kernels are templates on a tag type that the .cu defines (tarmac_step_fwd,
// tarmac_step_bwd), so a profiler's kernel names tell the forward's launches from the
// backward's, and on the storage type T of the call's tensors (storage.cuh: float or
// __nv_bfloat16). Every product runs on the tensor cores through mma.sync (mma_sm90.cuh),
// each warp a 16 x 32 quarter of the tile, its operands staged in shared memory in a ring of
// kStages slabs with one barrier a slab: slab s + 2 is fetched while slab s is summed. An
// operand row that is 16-byte aligned arrives by cp.async straight into the ring; anything
// else (a ragged or unaligned edge, a column of ones, and at bf16 f32 scratch) travels
// through registers and is stored after the slab before it is summed. Each layout pair (A
// stored [m][k] or [k][m], B [k][n] or [n][k]) is its own compiled loop. T picks the product:
//
// f32 (T = float): 3xTF32, m16n8k8 tf32 x tf32 -> f32. The ring holds f32; the fragments are
//   read with 32-bit shared loads (ldmatrix is 16-bit only), each row padded so that a warp's
//   32 reads hit 32 banks, and each value v is split in registers into big = tf32(v) and
//   small = tf32(v - big) (split_tf32). Every 8-deep step sums small A big B, big A small B,
//   then big A big B (mma_3xtf32) into a zeroed f32 sum, which is added to the tile's f32
//   sums, rounded to nearest: about 21-22 bits of each operand, where one tf32 pass keeps
//   11, and running sums that round as f32 FMAs' do. What bounds it: three tf32 passes, 3 x the
//   operations at 495 TFLOP/s, and per slab the fragment loads, splits and step sums the
//   warp issues itself (a 32-deep slab: 48 mma, 48 shared loads, 96 conversions a warp;
//   166 registers a thread, so 3 CTAs an SM). On an NVIDIA H100 80GB HBM3 at 700.00 W
//   (chip_ab.py, in turns with the f32 FMA tile this replaced): #4 0.0723 ms at R = 256
//   against 0.1066, #5 0.1472 against 0.2221; at R = 4096 0.2478 and 0.6977 against
//   0.3554 and 1.2228, below cuBLAS-based plain versions (0.3246, 1.7471).
// bf16 (T = __nv_bfloat16): mma.sync m16n8k16 bf16 x bf16 -> f32, the ring in bf16, the
//   fragments through ldmatrix (.trans for the layouts whose rows do not run along k), the
//   pad of 8 values a row keeping ldmatrix's 8 row reads on distinct banks. An f32 scratch
//   operand enters as two bf16 halves, hi = bf16(v) and lo = bf16(v - hi) (split_bf16): hi B
//   + lo B against a bf16 B, hi hi + hi lo + lo hi where both are f32. A product so keeps
//   about 16 bits of each f32 operand, and its output stays within about one bf16 ulp of the
//   f32 instantiation's, rounded. 64-row tiles were slower at R = 256 and no faster at 4096
//   (H100).
// A job may split its sum over k into `split` chunks of `krows` (the backward's X^T G over
// all R rows): each chunk's CTAs write f32 partials, which a later launch adds in a fixed
// order, so a repeated call stays bit-identical.
//
// A product's operands are the call's tensors (T) or f32 scratch, fixed where the job is
// made: each job has a kind, a Types naming the storage of its operands, and a launch of
// step_products<Tag, T, Kinds...> holds jobs of the kinds it names. A CTA picks its job's
// kind once and runs that kind's product, whose loads and stores are typed at compile
// time. The sums are f32; an output is rounded to its type once, where it is stored. With
// T = float every kind is all-f32.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>
#include <utility>

#include "mma_sm90.cuh"
#include "storage.cuh"

namespace {

constexpr float kNegBig = -1e30f;
constexpr int kWorldThreads = 128;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// ---- the tiled product: C[M, N] = sum_s A_s B_s (+ bias) (+ C) ----

constexpr int kBM = 32, kBN = 64, kBK = 32;   // a CTA's tile of rows x columns; a slab's depth
constexpr int kProdThreads = 128;             // 4 warps, 2 x 2 over the tile
constexpr int kMI = kBM / 32;                 // m16 blocks of a warp: each warp kBM/2 x 32
constexpr int kStages = 3;                    // the ring's slabs: two in flight while one is summed
constexpr int kMaxSeg = 3;
constexpr int kMaxJobs = 22;
static_assert(kProdThreads == 128 && kBK == 32 && kBN == 64 && kBM % 32 == 0,
              "4 warps, whole mma steps, 16-byte chunks");

struct Seg {
  const void* a;     // A(m, k) = a[m*lda + k], or a[k*lda + m] with trans_a; nullptr: all ones
  const void* b;     // B(k, n) = b[k*ldb + n], or b[n*ldb + k] with trans_b
  int lda, ldb, k;
};

constexpr int kWholeK = 1 << 30;   // the krows of a job whose sum is not split

struct Job {
  Seg seg[kMaxSeg];
  void* c;               // [M, ldc]; a split job's chunk i writes its partial at c + i M ldc
  const void* bias;      // [N], or nullptr
  int kind;              // the position of the job's Types in its launch's Kinds
  int n_seg, trans_a, trans_b, ldc, accumulate, M, N, tile0, tiles_n;
  int split, krows;      // chunk i of the k sum covers [i krows, (i + 1) krows)
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
template <class T> using GradXPart = Types<T, T, float, float>;  // X^T G's split partials, X a
                                                                 // call tensor
using GradSPart = Types<float, float, float, float>;             // X f32 scratch (or ones)

// The position of Ty among Kinds (its first, where a kind repeats, as all do at f32).
template <class Ty, class... Kinds> struct KindOf;
template <class Ty, class... Rest> struct KindOf<Ty, Ty, Rest...> {
  static constexpr int value = 0;
};
template <class Ty, class Other, class... Rest> struct KindOf<Ty, Other, Rest...> {
  static constexpr int value = 1 + KindOf<Ty, Rest...>::value;
};

template <class S> constexpr bool kIsF32 = std::is_same<S, float>::value;

// A value's raw bits: an f32's, or a bf16's 16 as loaded as an unsigned short.
template <class R>
__device__ __forceinline__ unsigned raw_bits(R v) {
  if constexpr (std::is_same<R, float>::value) {
    return float_bits(v);
  } else {
    return v;
  }
}

// p can be read 16 bytes at a time along rows of ld values, `per16` values to 16 bytes.
__device__ __forceinline__ bool aligned16(const void* p, int ld, int per16) {
  return p != nullptr && (reinterpret_cast<size_t>(p) & 15) == 0 && ld % per16 == 0;
}

// A CTA's tile, read out of the shared Job once so that the slab loop keeps it in registers.
struct Tile {
  int m0, n0, M, N, kbeg, krows, n_seg;
};

// The slab a tile's k walk is at: its segment's fields, in registers, and its depth.
struct Cursor {
  const void* a;
  const void* b;
  int lda, ldb, sg, k0, kend;
  bool a_aligned, b_aligned;
};

// Cursor c onto segment sg's first slab of the tile's k range, or past the last segment;
// segments with nothing in the range are skipped. Per16: the operands' values to 16 bytes.
template <int Per16>
__device__ __forceinline__ void enter_segment(const Job& J, const Tile& t, int sg, Cursor& c) {
  for (; sg < t.n_seg; ++sg) {
    const Seg& S = J.seg[sg];
    c.kend = min(S.k, t.kbeg + t.krows);
    if (c.kend > t.kbeg) {
      c.a = S.a;
      c.b = S.b;
      c.lda = S.lda;
      c.ldb = S.ldb;
      c.a_aligned = aligned16(S.a, S.lda, Per16);
      c.b_aligned = aligned16(S.b, S.ldb, Per16);
      break;
    }
  }
  c.sg = sg;
  c.k0 = t.kbeg;
}

template <int Per16>
__device__ __forceinline__ void next_slab(const Job& J, const Tile& t, Cursor& c) {
  c.k0 += kBK;
  if (c.k0 >= c.kend) enter_segment<Per16>(J, t, c.sg + 1, c);
}

// ---- the f32 product: 3xTF32 ----

// A slab's shared layout (f32), by whether the operand is stored transposed: A [m][k] or
// A^T [k][m], B [k][n] or B^T [n][k]; kLd32 is a row's length, rows run along the operand's
// contiguous dimension. A row along k is read 4 values deep (t) in 8 rows (g), so its
// length is 4 past a multiple of 32; a row along m or n 8 values wide (g) in 4 rows (t), so
// 8 past one: either way a warp's 32 fragment reads hit 32 banks.
template <bool TA> constexpr int kLdA32 = TA ? kBM + 8 : kBK + 4;
template <bool TB> constexpr int kLdB32 = TB ? kBK + 4 : kBN + 8;
constexpr int kTileA32 = kBM * kLdA32<false> > kBK * kLdA32<true> ? kBM * kLdA32<false>
                                                                 : kBK * kLdA32<true>;
constexpr int kTileB32 = kBK * kLdB32<false> > kBN * kLdB32<true> ? kBK * kLdB32<false>
                                                                 : kBN * kLdB32<true>;
constexpr int kChunksA32 = kBM * kBK / 4 / kProdThreads;   // 4-value chunks a thread fetches
constexpr int kChunksB32 = kBK * kBN / 4 / kProdThreads;

struct alignas(16) TfShared {                  // an f32 CTA's dynamic shared memory
  float a[kStages][kTileA32];
  float b[kStages][kTileB32];
  Job job;
};

// v as big + small, each the bits of a tf32: big = tf32(v), small = tf32(v - big). v - big is
// exact, so big + small is v to about 2^-22 of |v|.
__device__ __forceinline__ void split_tf32(float v, unsigned& big, unsigned& small) {
  big = to_tf32(v);
  small = to_tf32(v - bits_float(big));
}

// d += a b for f32 fragments given as their tf32 splits: small a big b, big a small b, then
// big a big b, into the f32 sums; small a small b (about 2^-22 of a b) is left out.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&a_big)[4],
                                           const unsigned (&a_small)[4],
                                           const unsigned (&b_big)[2],
                                           const unsigned (&b_small)[2]) {
  mma_tf32_1688(d, a_small, b_big);
  mma_tf32_1688(d, a_big, b_small);
  mma_tf32_1688(d, a_big, b_big);
}

// A chunk of 4 f32 values of a slab that travels through registers (their bits), landed in
// the ring after the slab before it is summed.
struct Staged32 {
  unsigned v[4];
  float* at;                 // where it lands; nullptr: nothing staged (none, or by cp.async)
};

// The 4 values at (outer, inner .. inner + 3) of an f32 operand, row-major along `outer`
// with leading dimension ld, into the ring at `at`: a 16-byte aligned chunk that lies
// wholly inside by cp.async; else through registers, values past the operand's edge
// (outer_ok false, or inner + j at inner_lim or beyond) 0 and a missing operand's (base
// nullptr: a bias sum's ones column) 1.
__device__ __forceinline__ void fetch_chunk32(const void* base, int ld, bool aligned, int outer,
                                              bool outer_ok, int inner, int inner_lim,
                                              float* at, Staged32& st) {
  const float* b = static_cast<const float*>(base) + (size_t)outer * ld + inner;
  if (aligned && outer_ok && inner + 4 <= inner_lim) {
    cp_async_16(at, b);
    st.at = nullptr;
    return;
  }
  st.at = at;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    unsigned v = 0u;
    if (outer_ok && inner + j < inner_lim) v = base == nullptr ? float_bits(1.f) : float_bits(b[j]);
    st.v[j] = v;
  }
}

__device__ __forceinline__ void land(const Staged32& st) {
  if (st.at != nullptr) *reinterpret_cast<uint4*>(st.at) = make_uint4(st.v[0], st.v[1], st.v[2],
                                                                        st.v[3]);
}

// The f32 slab at cursor c into ring stage `stage`: A's chunks of 4 values kChunksA32 a
// thread, B's kChunksB32, each along its operand's contiguous dimension, so a warp's
// copies coalesce. st[0, kChunksA32) take A's chunks and the rest B's where they travel
// through registers.
template <class Ty, bool TA, bool TB>
__device__ __forceinline__ void fetch_slab(const Tile& t, const Cursor& c, int stage,
                                           TfShared& sh, Staged32 (&st)[kChunksA32 + kChunksB32]) {
  constexpr int a_row = TA ? kBM / 4 : kBK / 4, b_row = TB ? kBK / 4 : kBN / 4;   // chunks
#pragma unroll
  for (int i = 0; i < kChunksA32; ++i) {
    const int e = threadIdx.x + i * kProdThreads, row = e / a_row, col = (e % a_row) * 4;
    const int outer = TA ? c.k0 + row : t.m0 + row, inner = TA ? t.m0 + col : c.k0 + col;
    fetch_chunk32(c.a, c.lda, c.a_aligned, outer, outer < (TA ? c.kend : t.M), inner,
                  TA ? t.M : c.kend, sh.a[stage] + row * kLdA32<TA> + col, st[i]);
  }
#pragma unroll
  for (int i = 0; i < kChunksB32; ++i) {
    const int e = threadIdx.x + i * kProdThreads, row = e / b_row, col = (e % b_row) * 4;
    const int outer = TB ? t.n0 + row : c.k0 + row, inner = TB ? c.k0 + col : t.n0 + col;
    fetch_chunk32(c.b, c.ldb, c.b_aligned, outer, outer < (TB ? t.N : c.kend), inner,
                  TB ? c.kend : t.N, sh.b[stage] + row * kLdB32<TB> + col, st[kChunksA32 + i]);
  }
}

// A warp's (16 kMI) x 32 part of the tile over one f32 slab: per 8-deep step kMI A fragments
// and four B fragments, each value read from the ring and split, then mma_3xtf32 into a
// zeroed f32 sum of the step, added to the f32 sums acc[m16 block][n8 block][fragment]. The
// tensor cores do not round their sums to nearest (they truncate as they align), so summed
// in place their error would grow with the running sum over every step of a long k walk;
// a step's own sum bounds it by that step's 8 products, and the running sums round to
// nearest as an f32 FMA's do.
template <bool TA, bool TB>
__device__ __forceinline__ void mma_slab32(const TfShared& sh, int stage,
                                           float (&acc)[kMI][4][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 16 * kMI, wn = (warp % 2) * 32, g = lane / 4, t = lane % 4;
  const float* sa = sh.a[stage];
  const float* sb = sh.b[stage];
  auto at_a = [&](int m, int k) { return TA ? sa[k * kLdA32<TA> + m] : sa[m * kLdA32<TA> + k]; };
  auto at_b = [&](int k, int n) { return TB ? sb[n * kLdB32<TB> + k] : sb[k * kLdB32<TB> + n]; };
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    unsigned a_big[kMI][4], a_small[kMI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int f = 0; f < 4; ++f)        // a[f]: row g (+8 for f odd), col t (+4 from f = 2)
        split_tf32(at_a(wm + 16 * mi + g + 8 * (f % 2), kk + t + 4 * (f / 2)), a_big[mi][f],
                   a_small[mi][f]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = wn + 8 * j + g;
      unsigned b_big[2], b_small[2];
      split_tf32(at_b(kk + t, n), b_big[0], b_small[0]);
      split_tf32(at_b(kk + t + 4, n), b_big[1], b_small[1]);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        float step[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(step, a_big[mi], a_small[mi], b_big, b_small);
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[mi][j][f] += step[f];
      }
    }
  }
}

// ---- the bf16 product ----

constexpr int kPad = 8;                        // values a shared row is padded by (16 bytes)
// A slab's shared layout (bf16), as the f32 one's.
template <bool TA> constexpr int kLdA = TA ? kBM + kPad : kBK + kPad;
template <bool TB> constexpr int kLdB = TB ? kBK + kPad : kBN + kPad;
constexpr int kTileA = kBM * kLdA<false> > kBK * kLdA<true> ? kBM * kLdA<false>
                                                            : kBK * kLdA<true>;
constexpr int kTileB = kBK * kLdB<false> > kBN * kLdB<true> ? kBK * kLdB<false>
                                                            : kBN * kLdB<true>;
constexpr int kChunksA = kBM * kBK / 8 / kProdThreads;   // 8-value chunks a thread fetches
constexpr int kChunksB = kBK * kBN / 8 / kProdThreads;

struct alignas(16) Bf16Shared {                // a bf16 CTA's dynamic shared memory
  unsigned short a[kStages][2][kTileA];        // [stage][hi, lo][slab]
  unsigned short b[kStages][2][kTileB];
  Job job;
};

__device__ __forceinline__ unsigned bf16_bits(__nv_bfloat16 v) {
  unsigned short u;
  memcpy(&u, &v, sizeof u);
  return u;
}

// v as hi + lo, each the bits of a bf16: hi = bf16(v), lo = bf16(v - hi). v - hi is exact,
// so hi + lo is v to about 2^-17 of |v|.
__device__ __forceinline__ void split_bf16(float v, unsigned& hi, unsigned& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  hi = bf16_bits(h);
  lo = bf16_bits(__float2bfloat16_rn(v - __bfloat162float(h)));
}

// A chunk of 8 values of a slab that travels through registers as raw 32-bit words (an
// f32's bits, or a bf16's 16 bits), landed in the ring after the slab before it is summed.
struct Staged {
  unsigned v[8];
  unsigned short* hi;        // where it lands; nullptr: nothing staged (none, or by cp.async)
  unsigned short* lo;        // where the lo halves of f32 values land; nullptr for bf16
};

// The 8 values at (outer, inner .. inner + 7) of an operand stored as S, row-major along
// `outer` with leading dimension ld, into the ring at hi (and lo): values past the operand's
// edge (outer_ok false, or inner + j at inner_lim or beyond) are 0, a missing operand (base
// nullptr: a bias sum's ones column) is 1. A 16-byte aligned chunk that lies wholly inside
// is copied by cp.async (bf16) or loaded 16 bytes at a time (f32).
template <class S>
__device__ __forceinline__ void fetch_chunk(const void* base, int ld, bool aligned, int outer,
                                            bool outer_ok, int inner, int inner_lim,
                                            unsigned short* hi, unsigned short* lo,
                                            Staged& st) {
  using Bits = typename std::conditional<kIsF32<S>, float, unsigned short>::type;
  const Bits* b = static_cast<const Bits*>(base) + (size_t)outer * ld + inner;
  const bool whole = aligned && outer_ok && inner + 8 <= inner_lim;
  if constexpr (!kIsF32<S>) {
    if (whole) {
      cp_async_16(hi, b);
      st.hi = nullptr;
      return;
    }
  }
  st.hi = hi;
  st.lo = kIsF32<S> ? lo : nullptr;
  if constexpr (kIsF32<S>) {
    if (whole) {
      const float4 v0 = reinterpret_cast<const float4*>(b)[0];
      const float4 v1 = reinterpret_cast<const float4*>(b)[1];
      const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) st.v[j] = float_bits(v[j]);
      return;
    }
  }
  const unsigned one = kIsF32<S> ? float_bits(1.f) : float_bits(1.f) >> 16;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    unsigned v = 0u;
    if (outer_ok && inner + j < inner_lim) v = base == nullptr ? one : raw_bits(b[j]);
    st.v[j] = v;
  }
}

__device__ __forceinline__ void land(const Staged& st) {
  if (st.hi == nullptr) return;
  unsigned hi[4], lo[4];
  if (st.lo != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned h0, l0, h1, l1;
      split_bf16(bits_float(st.v[2 * j]), h0, l0);
      split_bf16(bits_float(st.v[2 * j + 1]), h1, l1);
      hi[j] = h0 | h1 << 16;
      lo[j] = l0 | l1 << 16;
    }
    *reinterpret_cast<uint4*>(st.lo) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) hi[j] = st.v[2 * j] | st.v[2 * j + 1] << 16;
  }
  *reinterpret_cast<uint4*>(st.hi) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
}

// The bf16 slab at cursor c into ring stage `stage`: A's chunks of 8 values kChunksA a
// thread, B's kChunksB, each along its operand's contiguous dimension. st[0, kChunksA) take
// A's chunks and the rest B's where they travel through registers.
template <class Ty, bool TA, bool TB>
__device__ __forceinline__ void fetch_slab(const Tile& t, const Cursor& c, int stage,
                                           Bf16Shared& sh, Staged (&st)[kChunksA + kChunksB]) {
  constexpr int a_row = TA ? kBM / 8 : kBK / 8, b_row = TB ? kBK / 8 : kBN / 8;  // chunks
#pragma unroll
  for (int i = 0; i < kChunksA; ++i) {
    const int e = threadIdx.x + i * kProdThreads, row = e / a_row, col = (e % a_row) * 8;
    const int off = row * kLdA<TA> + col;
    const int outer = TA ? c.k0 + row : t.m0 + row, inner = TA ? t.m0 + col : c.k0 + col;
    const bool outer_ok = outer < (TA ? c.kend : t.M);
    const int inner_lim = TA ? t.M : c.kend;
    unsigned short *hi = sh.a[stage][0] + off, *lo = sh.a[stage][1] + off;
    if (c.sg == 0 && !std::is_same<typename Ty::A0, typename Ty::A>::value)
      fetch_chunk<typename Ty::A0>(c.a, c.lda, c.a_aligned, outer, outer_ok, inner, inner_lim,
                                   hi, lo, st[i]);
    else
      fetch_chunk<typename Ty::A>(c.a, c.lda, c.a_aligned, outer, outer_ok, inner, inner_lim,
                                  hi, lo, st[i]);
  }
#pragma unroll
  for (int i = 0; i < kChunksB; ++i) {
    const int e = threadIdx.x + i * kProdThreads, row = e / b_row, col = (e % b_row) * 8;
    const int off = row * kLdB<TB> + col;
    const int outer = TB ? t.n0 + row : c.k0 + row, inner = TB ? c.k0 + col : t.n0 + col;
    const bool outer_ok = outer < (TB ? t.N : c.kend);
    const int inner_lim = TB ? c.kend : t.N;
    fetch_chunk<typename Ty::B>(c.b, c.ldb, c.b_aligned, outer, outer_ok, inner, inner_lim,
                                sh.b[stage][0] + off, sh.b[stage][1] + off, st[kChunksA + i]);
  }
}

// A warp's (16 kMI) x 32 part of the tile over one bf16 slab: per 16-deep step kMI A
// fragments and four B fragments (two ldmatrix.x4), hi and, for an f32 operand, lo; then hi
// hi, hi lo (f32 B) and lo hi (f32 A) into the f32 sums acc[m16 block][n8 block][fragment].
// The pairs of a fragment run along k, a shared row of A [m][k] and of B^T [n][k]; the
// other layouts are read with ldmatrix's .trans.
template <bool TA, bool TB>
__device__ __forceinline__ void mma_slab(const Bf16Shared& sh, int stage, bool a_lo, bool b_lo,
                                         float (&acc)[kMI][4][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 16 * kMI, wn = (warp % 2) * 32;
  const int mat = lane / 8, r = lane % 8;      // the 8 x 8 matrix whose row this lane addresses
  const unsigned short* sa = sh.a[stage][0];
  const unsigned short* sb = sh.b[stage][0];
  constexpr int lo_a = kTileA, lo_b = kTileB;  // the lo half's offset from the hi half
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    unsigned a[kMI][2][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const int m = wm + 16 * mi;
      const int a_off = TA ? (kk + r + 8 * (mat / 2)) * kLdA<TA> + m + 8 * (mat % 2)
                           : (m + lane % 16) * kLdA<TA> + kk + 8 * (lane / 16);
      ldmatrix<4, TA>(a[mi][0], sa + a_off);
      if (a_lo) ldmatrix<4, TA>(a[mi][1], sa + lo_a + a_off);
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int n = wn + 16 * nb;
      const int b_off = TB ? (n + r + 8 * (mat / 2)) * kLdB<TB> + kk + 8 * (mat % 2)
                           : (kk + r + 8 * (mat % 2)) * kLdB<TB> + n + 8 * (mat / 2);
      unsigned b[2][4];                        // [hi, lo][n8 block 2nb: 0, 1; 2nb + 1: 2, 3]
      ldmatrix<4, !TB>(b[0], sb + b_off);
      if (b_lo) ldmatrix<4, !TB>(b[1], sb + lo_b + b_off);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const unsigned b_hi[2] = {b[0][2 * j], b[0][2 * j + 1]};
          float (&d)[4] = acc[mi][2 * nb + j];
          mma_bf16_16816(d, a[mi][0], b_hi);
          if (b_lo) {
            const unsigned b_lo_[2] = {b[1][2 * j], b[1][2 * j + 1]};
            mma_bf16_16816(d, a[mi][0], b_lo_);
          }
          if (a_lo) mma_bf16_16816(d, a[mi][1], b_hi);
        }
    }
  }
}

// ---- a CTA's tile, either type ----

// The warp's outputs of the tile: + bias, + the output's old value where the job
// accumulates, stored; a split job's chunk stores its f32 partial.
template <class Ty>
__device__ __forceinline__ void store_tile(const Job& J, const float (&acc)[kMI][4][4], int m0,
                                          int n0, int chunk) {
  using C = typename Ty::C;
  C* c = static_cast<C*>(J.c) + (size_t)chunk * J.M * J.ldc;
  const typename Ty::B* bias = static_cast<const typename Ty::B*>(J.bias);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row = m0 + (warp / 2) * 16 * kMI + lane / 4;
  const int col = n0 + (warp % 2) * 32 + 2 * (lane % 4);
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int m = row + 16 * mi + 8 * (f / 2), n = col + 8 * j + f % 2;
        if (m >= J.M || n >= J.N) continue;
        float v = acc[mi][j][f];
        if (bias != nullptr) v += to_f32(bias[n]);
        C* out = c + (size_t)m * J.ldc + n;
        if (J.accumulate) v = to_f32(*out) + v;
        *out = from_f32<C>(v);
      }
}

// The CTA's tile of a job of kind Ty (of its k chunk, for a split job), its operands
// stored transposed or not as TA, TB say, its slabs in a ring of kStages in shared memory Sh
// (TfShared: the f32 product, Bf16Shared: the bf16 one): slab s + 2 is fetched while slab s
// is summed, and what travels through registers lands after that.
template <class Ty, bool TA, bool TB, class Sh>
__device__ void product_tile(const Job& J, Sh& sh) {
  static_assert(kStages == 3, "slab s + 2 is fetched into the stage slab s - 1 freed");
  constexpr bool tf32 = std::is_same<Sh, TfShared>::value;
  constexpr int per16 = tf32 ? 4 : 8;           // a ring chunk's values
  const int tiles_n = J.tiles_n, tiles = ((J.M + kBM - 1) / kBM) * tiles_n;
  const int local = blockIdx.x - J.tile0, chunk = local / tiles, tile = local % tiles;
  const Tile t{(tile / tiles_n) * kBM, (tile % tiles_n) * kBN, J.M, J.N, chunk * J.krows,
               J.krows, J.n_seg};
  int n_slabs = 0;
  for (int s = 0; s < t.n_seg; ++s)
    n_slabs += (max(min(J.seg[s].k, t.kbeg + t.krows) - t.kbeg, 0) + kBK - 1) / kBK;
  Cursor fetch{}, sum{};                 // the next slab to fetch, and to sum
  enter_segment<per16>(J, t, 0, fetch);
  sum = fetch;
  float acc[kMI][4][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[mi][j][f] = 0.f;
  typename std::conditional<tf32, Staged32[kChunksA32 + kChunksB32],
                            Staged[kChunksA + kChunksB]>::type st;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slabs) {
      fetch_slab<Ty, TA, TB>(t, fetch, s, sh, st);
      for (auto& x : st) land(x);
      next_slab<per16>(J, t, fetch);
    }
    cp_async_commit();
  }
  int stage = 0;                         // slab s's
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<kStages - 2>();       // this thread's copies of slab s have landed,
    __syncthreads();                    // everyone's, and slab s - 1's stage is free
    const bool more = s + kStages - 1 < n_slabs;
    if (more) {
      fetch_slab<Ty, TA, TB>(t, fetch, stage == 0 ? kStages - 1 : stage - 1, sh, st);
      next_slab<per16>(J, t, fetch);
    }
    cp_async_commit();
    if constexpr (tf32) {
      mma_slab32<TA, TB>(sh, stage, acc);
    } else {
      const bool a_lo = sum.sg == 0 ? kIsF32<typename Ty::A0> : kIsF32<typename Ty::A>;
      mma_slab<TA, TB>(sh, stage, a_lo, kIsF32<typename Ty::B>, acc);
    }
    next_slab<per16>(J, t, sum);
    if (more)
      for (auto& x : st) land(x);
    stage = stage == kStages - 1 ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  store_tile<Ty>(J, acc, t.m0, t.n0, chunk);
}

// ---- the launch ----

// A CTA's dynamic shared memory at storage type T.
template <class T> using Ring = typename std::conditional<kIsF32<T>, TfShared, Bf16Shared>::type;

// The CTA's job (the one whose tiles hold blockIdx.x), copied out of the parameter space
// once: the slab loop then reads its fields from shared memory (6 % less time a call than
// reading them through a reference to the parameters, for both libraries, H100).
__device__ __forceinline__ void load_job(const Jobs& jobs, Job& J) {
  if (threadIdx.x == 0) {
    int jb = 0;
    while (jb + 1 < jobs.n_jobs && (int)blockIdx.x >= jobs.job[jb + 1].tile0) ++jb;
    J = jobs.job[jb];
  }
  __syncthreads();
}

// Through product_tile of the job's kind and of its operands' layouts. A kind that
// repeats an earlier one (every kind at f32) is never taken, so its copy is dead code.
template <class Ty, class Sh>
__device__ __forceinline__ void run_layout(const Job& J, Sh& sh) {
  if (J.trans_a) {
    if (J.trans_b) product_tile<Ty, true, true>(J, sh);
    else product_tile<Ty, true, false>(J, sh);
  } else {
    if (J.trans_b) product_tile<Ty, false, true>(J, sh);
    else product_tile<Ty, false, false>(J, sh);
  }
}

template <class... Kinds, class Sh, size_t... I>
__device__ __forceinline__ void run_kind(const Job& J, Sh& sh, std::index_sequence<I...>) {
  ((KindOf<Kinds, Kinds...>::value == (int)I && J.kind == (int)I ? run_layout<Kinds>(J, sh)
                                                                 : void()),
   ...);
}

template <class Tag, class T, class... Kinds>
__global__ void __launch_bounds__(kProdThreads) step_products(const __grid_constant__ Jobs jobs) {
  extern __shared__ float smem[];
  Ring<T>& sh = *reinterpret_cast<Ring<T>*>(smem);
  load_job(jobs, sh.job);
  run_kind<Kinds...>(sh.job, sh, std::index_sequence_for<Kinds...>{});
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

// The GRU's output of one column: h2 = (1 - z) n + z h.
__device__ __forceinline__ float gru_out(const Gates& g, float h) {
  return (1.f - g.z) * g.n + g.z * h;
}

// ---- host side ----

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The jobs of one launch of step_products<Tag, T, Kinds...>, each of one of those kinds.
template <class Tag, class T, class... Kinds>
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
    j.split = 1;
    j.krows = kWholeK;
    return j;
  }

  cudaError_t launch(cudaStream_t stream) {
    constexpr size_t smem = sizeof(Ring<T>);
    int tiles = 0;
    for (int i = 0; i < jobs.n_jobs; ++i) {
      Job& j = jobs.job[i];
      j.tile0 = tiles;
      j.tiles_n = (j.N + kBN - 1) / kBN;
      tiles += j.split * ((j.M + kBM - 1) / kBM) * j.tiles_n;
    }
    auto kernel = step_products<Tag, T, Kinds...>;
    cudaError_t e = allow_smem((const void*)kernel, smem);
    if (e != cudaSuccess) return e;
    if (tiles > 0) kernel<<<tiles, kProdThreads, smem, stream>>>(jobs);
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


// Launches (a) and (b) for R = W*A > 0 rows, into vsq [R, MSG + 2K] and c [R, MSG] (f32
// scratch).
template <class Tag, class T>
cudaError_t launch_attend(const T* x, const T* h, const T* adjf, const T* wv, const T* bv,
                          const T* ws, const T* bs, const T* wq, const T* bq, float* vsq,
                          float* c, int W, int A, int H, int MSG, int K, float key_size,
                          cudaStream_t stream) {
  const int R = W * A, P = MSG + 2 * K;
  cudaError_t e;
  {  // (a) [v|s|q] = [x|h] [wv|ws|wq] + [bv|bs|bq]
    Products<Tag, T, Proj<T>> p;
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
  // (b) alpha and c, per world
  const size_t smem = sizeof(float) * (size_t)A * (P + A);
  auto attend = step_attend<Tag, T>;
  if ((e = allow_smem((const void*)attend, smem)) != cudaSuccess) return e;
  attend<<<W, kWorldThreads, smem, stream>>>(adjf, vsq, c, A, MSG, K, key_size);
  return cudaGetLastError();
}

// (c) on the hidden columns [lo, lo + w) of each gate, into gi and gh [R, 3w] (f32 scratch):
// gi[:, g w + j] = ([x|c] wi + bi)[:, g H + lo + j], gh likewise from h wh + bh, for the
// gates g = r, z, n. All H columns (w = H) are the whole products, one job each; a slice
// is a job a gate and pre-activation, whose B starts at column g H + lo of wi or wh.
template <class Tag, class T>
cudaError_t launch_gate_cols(const T* x, const T* h, const float* c, const T* wi,
                             const T* wh, const T* bi, const T* bh, float* gi, float* gh,
                             int R, int H, int MSG, int lo, int w, cudaStream_t stream) {
  const int H3 = 3 * H;
  const int gates = w == H ? 1 : 3, n = w == H ? H3 : w;
  Products<Tag, T, ProjC<T>> p;
  for (int g = 0; g < gates; ++g) {
    const int col = g * H + lo;
    Job& jgi = p.template add<ProjC<T>>(gi + g * w, 3 * w, R, n, 0, 0, bi + col, 0);
    add_seg<ProjC<T>>(jgi, x, H, wi + col, H3, H);
    add_seg<ProjC<T>>(jgi, c, MSG, wi + (size_t)H * H3 + col, H3, MSG);
    Job& jgh = p.template add<ProjC<T>>(gh + g * w, 3 * w, R, n, 0, 0, bh + col, 0);
    add_seg<ProjC<T>>(jgh, h, H, wh + col, H3, H);
  }
  return p.launch(stream);
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
  cudaError_t e = launch_attend<Tag, T>(x, h, adjf, wv, bv, ws, bs, wq, bq, vsq, c, W, A, H,
                                        MSG, K, key_size, stream);
  if (e != cudaSuccess) return e;
  return launch_gate_cols<Tag, T>(x, h, c, wi, wh, bi, bh, gi, gh, W * A, H, MSG, 0, H, stream);
}

}  // namespace
