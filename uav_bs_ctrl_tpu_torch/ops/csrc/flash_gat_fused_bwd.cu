// Backward of the projection-fused GATv2 attention for Hopper (sm_90a).
//
// Replaces the TPU kernel uav_bs_ctrl_tpu/ops/pallas_kernels.py:_fgf_bwd (:623; body
// _flash_gat_fused_bwd_kernel, :425). Recompute style: el = x @ W + b, the scores and
// alpha are rebuilt from the forward's row statistics m, l; nothing of the forward but
// (out, m, l) is kept. With g = dL/dout, per head h:
//
//   D[n,h]  = sum_f g*out                    d_alpha = sum_f g*el
//   d_s     = alpha * (d_alpha - D)          d_z     = d_s * attn * leaky'(z)
//   d_el    = alpha * g + d_z                der[n]  = sum_m d_z
//   dattn   = sum_{n,m} d_s * leaky(z)       dW = x^T d_el, db = sum d_el, dx = d_el W^T
//
// The all-masked rule: a row with no valid slot has m = -1e30 (shift 0) and l = 0, so
// alpha = 0 on every slot and the row adds exactly 0 to every gradient, der included.
// Masked slots have alpha = 0 and are skipped (their dx is written as 0).
//
// Design. Rows of more than 16 slots ('seen') of heads of 32 or 64 columns take the slot
// tiles (flash_gat_tile.cuh:use_tiles), shorter rows ('near') and other widths the
// warp-per-(row, head) body below, which was faster on short rows (PERF.md). Launch 1 of the tiles: a CTA of H warps, warp h head h, over a grid of rows;
// per row the warp lists the valid slots of its staged mask and per tile of 8 slots
//   1. projects its head's columns on the tensor cores and, in the accumulator registers,
//      forms z = el + er and el - out; a slot's score and d_alpha - D = sum_f g (el - out)
//      (the plain version's form, which does not cancel) are the lanes' sums over their
//      columns, then over the 8 lanes that hold the slot;
//   2. alpha = exp(s - m) / l and d_s from them; with v = d_s leaky'(z) (d_s or slope d_s),
//      d_z = attn v, so per column and slot the lanes add v into der's sum and v z into
//      dattn's, and no product over the columns is left but one: since
//      leaky'(z) = slope + (1 - slope) [z >= 0],
//        x^T d_z = attn (slope Y + (1 - slope) [z >= 0]^T (x d_s)),  Y = sum_j x_j d_s_j,
//      an mma.sync product of the 0/1 indicator (exact in tf32) with the slots' (1 - slope)
//      x d_s (D values a slot, split into tf32 parts) over the tile's slots, as K. The rest
//      of dW and db is per row: x^T (alpha g) = g (sum_j alpha_j x_j) and db = sum_rows (g
//      sum_j alpha_j + der).
// z stays in registers from 1 to 2. The warp's dW, db and dattn, over its CTA's rows, are
// one partial row [(D+2)*HF] a CTA, with
// no exchange between warps. With dx (an instantiation of its own), the lanes also sum v
// attn W^T over their columns (D FMAs a column and slot) and the slot's alpha (W g) of the
// row; the heads' parts meet in shared memory and are added in head order after a barrier:
// the only barrier, and only with dx. The row body's design is flash_gat_common.cuh's (one
// warp a (row, head), two butterflies a slot, the heads' dx added after a barrier). Launch
// 2 sums the CTAs' partials, 16 row lanes a column and a fixed tree, so two runs give
// bit-identical gradients without atomics.
//
// What bounds it: at bench.py's hoisted B = 256 (N = 104,448 rows, 'seen' 70 % valid) the
// lanes' instructions per column and slot (about 10: two adds, the select, the score and
// d_alpha FMAs, der's and dattn's sums, the indicator) beside 4 (f32) or 1 (bf16) HMMA for
// the projection and 2 for the indicator product a 16 x 8 block, and per row; 3 CTAs of 4
// warps an SM (at most 170 registers). On an NVIDIA H100 80GB HBM3 at 700 W (chip_ab.py, in
// turns with the warp-per-(row, head) body alone): 'seen' 1.5067 ms at f32 and 1.3413 at
// bf16 against 2.4682 and 2.6389.
//
// Storage types (storage.cuh): a template on the type T of x, w, b, er, attn, mask, g, out
// and of the gradients dW, db, der, dattn and dx, float (flash_gat_fused_backward) or
// __nv_bfloat16 (flash_gat_fused_backward_bf16); the row statistics m, l and the partials
// are f32 in both. Every sum is f32, and each gradient is rounded to T once, where it is
// stored; the bf16 call is the f32 call on the widened operands, rounded. At bf16 it is the
// backward of the unrounded form (see flash_gat_fused.cu).

#include "flash_gat_tile.cuh"

namespace {

constexpr int kMaxCtas = 1024;      // launch 1's CTAs (and partial rows) at most
constexpr int kRedCols = 32;        // launch 2: columns a CTA ...
constexpr int kRedLanes = 16;       // ... and row lanes a column

// ---- The warp-per-(row, head) body, for rows of at most two tiles' worth of slots ----

// Lane L ends with the sum over the warp of v[L / (32 / DM)]: log2(DM) halving
// exchanges, then a butterfly over the 32 / DM lanes that hold the same feature.
template <int DM>
__device__ __forceinline__ float reduce_scatter(float (&v)[DM], int lane) {
  int off = 16;
#pragma unroll
  for (int half = DM / 2; half > 0; half /= 2, off /= 2) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
  float r = v[0];
  for (; off > 0; off /= 2) r += __shfl_xor_sync(kFull, r, off);
  return r;
}

template <class T, int CM, int DM, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads) flash_gat_fused_bwd_rows(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
    const T* __restrict__ er, const T* __restrict__ attn, const T* __restrict__ mask,
    const T* __restrict__ g, const T* __restrict__ out, const float* __restrict__ mstat,
    const float* __restrict__ lstat, T* __restrict__ der, T* __restrict__ dx,
    float* __restrict__ partial, int N, int M, int D, int HF, int H, int chunk, float slope) {
  extern __shared__ float smem[];
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int F = HF / H, C = F / 32, col0 = h * F + lane;
  float* s_x = smem + (size_t)h * chunk * (DM + 1);          // this warp's [chunk, DM]
  int* s_list = reinterpret_cast<int*>(s_x + chunk * DM);      // its valid slots [chunk]
  const int* s_list0 = reinterpret_cast<const int*>(smem + chunk * DM);   // warp 0's
  float* s_dx = smem + (size_t)H * chunk * (DM + 1);           // [chunk, H, DM], with dx

  HeadSlice<CM, DM> sl;
  sl.load(w, b, attn, col0, C, D, HF);
  float dw[DM][CM], db[CM], dattn[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) {
#pragma unroll
    for (int d = 0; d < DM; ++d) dw[d][c] = 0.f;
    db[c] = dattn[c] = 0.f;
  }

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const T* x_row = x + (size_t)n * M * D;
    const T* mask_row = mask + (size_t)n * M;
    float erl[CM], gl[CM], ol[CM], dr[CM];
    row_slice<CM>(er + (size_t)n * HF, col0, C, erl);
    row_slice<CM>(g + (size_t)n * HF, col0, C, gl);
    row_slice<CM>(out + (size_t)n * HF, col0, C, ol);
    const float m = mstat[(size_t)n * H + h];
    const float shift = m <= kNegBig / 2 ? 0.f : m;
    const float l = fmaxf(lstat[(size_t)n * H + h], 1e-30f);
    float dv = 0.f;                                 // D[n, h] = sum over the head of g*out
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      dv = fmaf(gl[c], ol[c], dv);
      dr[c] = 0.f;
    }
    dv = warp_sum(dv);

    for (int j0 = 0; j0 < M; j0 += chunk) {
      const int len = min(chunk, M - j0);
      const int cnt = stage_chunk<DM>(x_row, mask_row, j0, len, D, s_x, s_list, lane);
#pragma unroll 2
      for (int k = 0; k < cnt; ++k) {
        const float* xd = s_x + s_list[k] * DM;
        float el[CM], z[CM], lz[CM];
        sl.project(xd, el);
        float sc = 0.f, da = 0.f;                   // score, d_alpha
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          z[c] = el[c] + erl[c];
          lz[c] = z[c] >= 0.f ? z[c] : slope * z[c];
          sc = fmaf(lz[c], sl.attn[c], sc);
          da = fmaf(gl[c], el[c], da);
        }
        sc = warp_sum(sc);
        da = warp_sum(da);
        const float alpha = expf(sc - shift) / l;
        const float ds = alpha * (da - dv);
        float xr[DM], pdx[DM];
#pragma unroll
        for (int d = 0; d < DM; ++d) {
          xr[d] = xd[d];
          pdx[d] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          const float dz = ds * sl.attn[c] * (z[c] >= 0.f ? 1.f : slope);
          const float del = alpha * gl[c] + dz;
          dr[c] += dz;
          dattn[c] = fmaf(ds, lz[c], dattn[c]);
          db[c] += del;
#pragma unroll
          for (int d = 0; d < DM; ++d) {
            dw[d][c] = fmaf(xr[d], del, dw[d][c]);
            pdx[d] = fmaf(del, sl.w[d][c], pdx[d]);
          }
        }
        if (dx != nullptr) {
          const float v = reduce_scatter<DM>(pdx, lane);
          const int per = 32 / DM, d = lane / per;
          if (lane % per == 0) s_dx[((size_t)k * H + h) * DM + d] = v;
        }
      }
      if (dx != nullptr) {                          // the heads' parts, in head order
        __syncthreads();
        for (int i = threadIdx.x; i < cnt * D; i += blockDim.x) {
          const int k = i / D, d = i % D;
          float v = 0.f;
          for (int hh = 0; hh < H; ++hh) v += s_dx[((size_t)k * H + hh) * DM + d];
          dx[((size_t)n * M + j0 + s_list0[k]) * D + d] = from_f32<T>(v);
        }
        for (int i = threadIdx.x; i < len * D; i += blockDim.x)
          if (!(to_f32(mask_row[j0 + i / D]) > 0.f))
            dx[((size_t)n * M + j0) * D + i] = from_f32<T>(0.f);
        __syncthreads();                            // s_dx and the lists are free again
      }
    }
#pragma unroll
    for (int c = 0; c < CM; ++c)
      if (c < C) der[(size_t)n * HF + col0 + 32 * c] = from_f32<T>(dr[c]);
  }

  float* part = partial + (size_t)blockIdx.x * (D + 2) * HF + col0;
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    if (c >= C) continue;
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D) part[(size_t)d * HF + 32 * c] = dw[d][c];
    part[(size_t)D * HF + 32 * c] = db[c];
    part[(size_t)(D + 1) * HF + 32 * c] = dattn[c];
  }
}

template <class T, int CM, int DM, int MaxThreads>
cudaError_t launch_row_body(const T* x, const T* w, const T* b, const T* er, const T* attn,
                            const T* mask, const T* g, const T* out, const float* mstat,
                            const float* lstat, T* der, T* dx, float* partial, int N, int M,
                            int D, int HF, int H, float slope, cudaStream_t stream) {
  const int dx_floats = dx != nullptr ? DM : 0;   // a slot's share of s_dx, per warp
  const int chunk = chunk_for(M, H, DM + 1 + dx_floats);
  const size_t smem = sizeof(float) * (size_t)H * chunk * (DM + 1 + dx_floats);
  auto kernel = flash_gat_fused_bwd_rows<T, CM, DM, MaxThreads>;
  cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  const int grid = N < kMaxCtas ? N : kMaxCtas;
  kernel<<<grid, 32 * H, smem, stream>>>(x, w, b, er, attn, mask, g, out, mstat, lstat, der,
                                         dx, partial, N, M, D, HF, H, chunk, slope);
  return cudaGetLastError();
}

// The row body's launch 1 over N > 0 rows, min(N, kMaxCtas) CTAs.
template <class T>
cudaError_t rows_backward(const T* x, const T* w, const T* b, const T* er, const T* attn,
                          const T* mask, const T* g, const T* out, const float* mstat,
                          const float* lstat, T* der, T* dx, float* partial, int N, int M, int D,
                          int HF, int H, float slope, cudaStream_t stream) {
  const int C = HF / H / 32;                      // columns a lane
#define FGF_ARGS x, w, b, er, attn, mask, g, out, mstat, lstat, der, dx, partial, N, M, D, HF, \
                 H, slope, stream
  if (H > 8)                                      // more than 256 threads: F is 32, 64 or 96
    return C <= 2 ? launch_row_body<T, 2, kMaxD, 1024>(FGF_ARGS)
                  : launch_row_body<T, 4, kMaxD, 1024>(FGF_ARGS);
  if (C > 8) return launch_row_body<T, 32, kMaxD, 256>(FGF_ARGS);
  if (C > 4) return launch_row_body<T, 8, kMaxD, 256>(FGF_ARGS);
  if (C > 2) return launch_row_body<T, 4, kMaxD, 256>(FGF_ARGS);
  switch (dm_for(D)) {                            // the runs' F = 64: two columns a lane
    case 2: return launch_row_body<T, 2, 2, 256>(FGF_ARGS);
    case 4: return launch_row_body<T, 2, 4, 256>(FGF_ARGS);
    default: return launch_row_body<T, 2, kMaxD, 256>(FGF_ARGS);
  }
#undef FGF_ARGS
}

// ---- The slot tiles ----

// A lane's sums over its CTA's rows for its head's MT m16 tiles of columns: dw, dW's (1 -
// slope) attn [z >= 0]^T (x d_s) + g (sum_j alpha_j x_j) terms at (column g or g + 8,
// feature 2t or 2t + 1), the accumulator layout; dattn and dsum (the row's sum of v, der /
// attn) at columns g and g + 8 over the lane's slots 2t, 2t + 1; db at columns g and g + 8.
template <int MT>
struct Sums {
  float dw[MT][4], dattn[MT][2], dsum[MT][2], db[MT][2];
};

constexpr int kRowSlices = 3;       // the ring's per-column row slices: er, out, g
constexpr int kStats = 2;           // and the row's m and l

// A CTA's bounds: 3 CTAs of 4 warps an SM (at most 170 registers) where H <= 4.
template <int MaxThreads>
constexpr int kMinBlocks = MaxThreads <= 128 ? 3 : 1;

template <class T, int MT, int KD, bool DX, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads, kMinBlocks<MaxThreads>) flash_gat_fused_bwd_tiles(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
    const T* __restrict__ er, const T* __restrict__ attn, const T* __restrict__ mask,
    const T* __restrict__ g, const T* __restrict__ out, const float* __restrict__ mstat,
    const float* __restrict__ lstat, T* __restrict__ der, T* __restrict__ dx,
    float* __restrict__ partial, int N, int M, int D, int HF, int H, int chunk, float slope) {
  extern __shared__ float smem[];
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31, gi = lane >> 2, t = lane & 3;
  const int F = 16 * MT, c0 = h * F;
  const RingLayout L = ring_layout(chunk, D, F, sizeof(T), kRowSlices, kStats);
  unsigned* area = reinterpret_cast<unsigned*>(smem) + (size_t)h * L.total;
  int* list = reinterpret_cast<int*>(area + L.list);
  const int* list0 = reinterpret_cast<const int*>(reinterpret_cast<unsigned*>(smem) + L.list);
  float* wf = reinterpret_cast<float*>(area + L.wf);     // W rows and b of the head
  float* s_dx = smem + (size_t)H * L.total;               // [chunk, H, 8], with dx

  auto fetch = [&](const Unit& u, unsigned* buf) {
    const int len = min(chunk, M - u.j0);
    fetch_span(buf + L.mask, mask + (size_t)u.n * M + u.j0, len, lane);
    fetch_span(buf + L.x, x + ((size_t)u.n * M + u.j0) * D, len * D, lane);
    const T* rows[kRowSlices] = {er, out, g};
#pragma unroll
    for (int r = 0; r < kRowSlices; ++r)
      fetch_span(buf + L.row + r * span_words(F, sizeof(T)), rows[r] + (size_t)u.n * HF + c0, F,
                 lane);
    if (lane == 0) cp_async_4(buf + L.stat, mstat + (size_t)u.n * H + h, 4);
    if (lane == 1) cp_async_4(buf + L.stat + 1, lstat + (size_t)u.n * H + h, 4);
  };
  Unit u{(int)blockIdx.x, 0};
  if (u.n < N) fetch(u, area);
  cp_async_commit();
  stage_head(wf, w, b, c0, F, D, HF, lane);       // while the first unit is in flight
  Cols<T, MT, KD> cc;
  cc.load(w, attn, c0, D, HF, slope, gi, t);
  Sums<MT> acc = {};
  float y = 0.f;                                  // Y[gi] over the lane's slots
  float be[MT][2], bo[MT][2], gg[MT][2];          // b + er, b - out and g at the lane's columns
  float ax = 0.f, sa = 0.f;                       // the row's sum_j alpha_j x_j[gi], sum alpha_j
  float ud[KD];                                   // with dx: (W_h g_h)[d] of the row
  for (int buf = 0; u.n < N; buf ^= 1) {
    const Unit nu = u.j0 + chunk < M ? Unit{u.n, u.j0 + chunk} : Unit{u.n + (int)gridDim.x, 0};
    if (nu.n < N) fetch(nu, area + (buf ^ 1) * L.buf);
    cp_async_commit();
    cp_async_wait<1>();                           // this lane's copies of unit u have landed
    __syncwarp();                                 // and every lane's
    const unsigned* cur = area + buf * L.buf;
    const int len = min(chunk, M - u.j0);
    const T* m_s = span_at(cur + L.mask, mask + (size_t)u.n * M + u.j0);
    const T* x_s = span_at(cur + L.x, x + ((size_t)u.n * M + u.j0) * D);
    const float* st_s = reinterpret_cast<const float*>(cur + L.stat);
    const float mrow = st_s[0], shift = mrow <= kNegBig / 2 ? 0.f : mrow;
    const float l = fmaxf(st_s[1], 1e-30f);
    if (u.j0 == 0) {                              // a row's first unit
      ax = sa = 0.f;
      const T* g_s = span_at(cur + L.row + 2 * span_words(F, sizeof(T)), g + (size_t)u.n * HF + c0);
      float bv[MT][2];
      row_cols<MT>(wf + D * F, 0, gi, bv);
      row_cols<MT>(span_at(cur + L.row, er + (size_t)u.n * HF + c0), 0, gi, be);
      row_cols<MT>(span_at(cur + L.row + span_words(F, sizeof(T)), out + (size_t)u.n * HF + c0),
                   0, gi, bo);
      row_cols<MT>(g_s, 0, gi, gg);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          be[m][i] += bv[m][i];
          bo[m][i] = bv[m][i] - bo[m][i];
        }
      if constexpr (DX) {
#pragma unroll
        for (int d = 0; d < KD; ++d) ud[d] = 0.f;
#pragma unroll
        for (int f = lane; f < F; f += 32) {
          const float gv = to_f32(g_s[f]);
#pragma unroll
          for (int d = 0; d < KD; ++d)
            if (d < D) ud[d] = fmaf(gv, wf[d * F + f], ud[d]);
        }
#pragma unroll
        for (int d = 0; d < KD; ++d) ud[d] = warp_sum(ud[d]);
      }
    }
    const int cnt = list_staged(m_s, len, list, lane);
    __syncwarp();                                 // the list is written
    for (int k0 = 0; k0 < cnt; k0 += kSlots) {
      unsigned xb[KD / 4], xsm[KD / 4];
      x_fragment<T, KD>(x_s, list, k0, D, gi, t, xb, xsm);
      // 1. the scores and d_alpha - D of slots k0 + 2t, k0 + 2t + 1
      float zk[MT][4];                            // z, kept for 2
      float s0 = 0.f, s1 = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        project<T, KD>(p, cc.wa[m], cc.ws[m], xb, xsm);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = i >> 1;
          const float z = p[i] + be[m][col], eo = p[i] + bo[m][col];
          const float a = z >= 0.f ? cc.at[m][col] : cc.sat[m][col];
          if (i & 1) {
            s1 = fmaf(a, z, s1);
            a1 = fmaf(gg[m][col], eo, a1);
          } else {
            s0 = fmaf(a, z, s0);
            a0 = fmaf(gg[m][col], eo, a0);
          }
          zk[m][i] = z;
        }
      }
      // Lane (g, t) takes slot k0 + 2t + hi, hi = g >= 4, then swaps with lane ^ 16.
      const int hi = lane >> 4;
      const float sc = sum_pair_over_g(s0, s1, hi), dd = sum_pair_over_g(a0, a1, hi);
      const float al = k0 + 2 * t + hi < cnt ? expf(sc - shift) / l : 0.f, ds = al * dd;
      const float alo = __shfl_xor_sync(kFull, al, 16), dso = __shfl_xor_sync(kFull, ds, 16);
      const float al0 = hi ? alo : al, al1 = hi ? al : alo;
      const float ds0 = hi ? dso : ds, ds1 = hi ? ds : dso, sds0 = slope * ds0, sds1 = slope * ds1;
      const float x0 = x_at(x_s, list, k0 + 2 * t, gi, D);
      const float x1 = x_at(x_s, list, k0 + 2 * t + 1, gi, D);
      const float xd0 = x0 * ds0, xd1 = x1 * ds1;
      ax = fmaf(al0, x0, fmaf(al1, x1, ax));
      sa += al0 + al1;
      y += xd0 + xd1;
      unsigned yb[2], ysm[2];                     // B: (slot 2t | 2t + 1, feature gi) of
      split_operand<float>((1.f - slope) * xd0, yb[0], ysm[0]);   // (1 - slope) x d_s
      split_operand<float>((1.f - slope) * xd1, yb[1], ysm[1]);
      float dxa[2][KD];                           // with dx: sum over the lane's columns
      if constexpr (DX) {
#pragma unroll
        for (int d = 0; d < KD; ++d) dxa[0][d] = dxa[1][d] = 0.f;
      }
      // 2. the gradients' sums
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float v[4];                               // d_s leaky'(z): columns g, g, g+8, g+8
        unsigned ind[4];                          // A of the indicator: (column, k = slot)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool pos = zk[m][i] >= 0.f;
          v[i] = pos ? (i & 1 ? ds1 : ds0) : (i & 1 ? sds1 : sds0);
          ind[(i >> 1) + 2 * (i & 1)] = pos ? kOneBits : 0u;     // a0 (g, 2t) a1 (g+8, 2t) ..
        }
#pragma unroll
        for (int col = 0; col < 2; ++col) {
          acc.dattn[m][col] = fmaf(v[2 * col], zk[m][2 * col],
                                   fmaf(v[2 * col + 1], zk[m][2 * col + 1], acc.dattn[m][col]));
          acc.dsum[m][col] += v[2 * col] + v[2 * col + 1];
        }
        float st[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32_1688(st, ind, ysm);
        mma_tf32_1688(st, ind, yb);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc.dw[m][i] = fmaf(cc.at[m][i >> 1], st[i], acc.dw[m][i]);
        if constexpr (DX) {
#pragma unroll
          for (int col = 0; col < 2; ++col) {
            const int f = 16 * m + gi + 8 * col;
#pragma unroll
            for (int d = 0; d < KD; ++d) {
              if (d >= D) continue;
              const float aw = cc.at[m][col] * wf[d * F + f];
              dxa[0][d] = fmaf(v[2 * col], aw, dxa[0][d]);
              dxa[1][d] = fmaf(v[2 * col + 1], aw, dxa[1][d]);
            }
          }
        }
      }
      if constexpr (DX) {
#pragma unroll
        for (int d = 0; d < KD; ++d) {
          dxa[0][d] = sum_over_g(dxa[0][d]);
          dxa[1][d] = sum_over_g(dxa[1][d]);
        }
        if (gi == 0) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = k0 + 2 * t + j;
            if (k >= cnt) continue;
#pragma unroll
            for (int d = 0; d < KD; ++d)
              s_dx[((size_t)k * H + h) * 8 + d] = fmaf(j ? al1 : al0, ud[d], dxa[j][d]);
          }
        }
      }
    }
    if constexpr (DX) {                           // the heads' parts, in head order
      __syncthreads();
      for (int i = threadIdx.x; i < cnt * D; i += blockDim.x) {
        const int k = i / D, d = i % D;
        float v = 0.f;
        for (int hh = 0; hh < H; ++hh) v += s_dx[((size_t)k * H + hh) * 8 + d];
        dx[((size_t)u.n * M + u.j0 + list0[k]) * D + d] = from_f32<T>(v);
      }
      for (int i = threadIdx.x; i < len * D; i += blockDim.x)
        if (!(to_f32(mask[(size_t)u.n * M + u.j0 + i / D]) > 0.f))
          dx[((size_t)u.n * M + u.j0) * D + i] = from_f32<T>(0.f);
      __syncthreads();                            // s_dx and the lists are free again
    }
    if (nu.n != u.n) {                            // the row's der, db and g (alpha x) terms
      const float axr = sum_over_t(ax);           // lanes 4d .. 4d + 3: feature d
      const float sar = sum_over_t(sa);
      const float ax0 = __shfl_sync(kFull, axr, 8 * t), ax1 = __shfl_sync(kFull, axr, 8 * t + 4);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int col = 0; col < 2; ++col) {
          const float dr = cc.at[m][col] * sum_over_t(acc.dsum[m][col]);
          if (t == 0) der[(size_t)u.n * HF + c0 + 16 * m + gi + 8 * col] = from_f32<T>(dr);
          acc.db[m][col] = fmaf(sar, gg[m][col], acc.db[m][col] + dr);
          acc.dw[m][2 * col] = fmaf(gg[m][col], ax0, acc.dw[m][2 * col]);
          acc.dw[m][2 * col + 1] = fmaf(gg[m][col], ax1, acc.dw[m][2 * col + 1]);
          acc.dsum[m][col] = 0.f;
        }
    }
    __syncwarp();                                 // done with the buffer and the list
    u = nu;
  }
  cp_async_wait<0>();

  // The CTA's partial row: dW at (d, column), then db, then dattn.
  y = sum_over_t(y);
  const float y0 = __shfl_sync(kFull, y, 8 * t), y1 = __shfl_sync(kFull, y, 8 * t + 4);
  float* part = partial + (size_t)blockIdx.x * (D + 2) * HF;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      const int cw = c0 + 16 * m + gi + 8 * col;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = 2 * t + j;
        if (d < D)
          part[(size_t)d * HF + cw] =
              fmaf(cc.at[m][col] * slope, j ? y1 : y0, acc.dw[m][2 * col + j]);
      }
      const float da = sum_over_t(acc.dattn[m][col]);
      if (t == 0) {
        part[(size_t)D * HF + cw] = acc.db[m][col];
        part[(size_t)(D + 1) * HF + cw] = da;
      }
    }
}

// Launch 2: column k of the partials summed over their R rows (one a CTA of launch 1):
// row lane r sums rows r, r + kRedLanes, ..., then the lanes' sums meet in a fixed tree.
template <class T>
__global__ void __launch_bounds__(kRedCols * kRedLanes) flash_gat_fused_bwd_reduce(
    const float* __restrict__ partial, T* __restrict__ dw, T* __restrict__ db,
    T* __restrict__ dattn, int R, int D, int HF) {
  __shared__ float s_sum[kRedLanes][kRedCols];
  const int col = threadIdx.x % kRedCols, r = threadIdx.x / kRedCols;
  const int P = (D + 2) * HF;
  const int k = blockIdx.x * kRedCols + col;
  float s = 0.f;
  if (k < P)
    for (int row = r; row < R; row += kRedLanes) s += partial[(size_t)row * P + k];
  s_sum[r][col] = s;
  for (int half = kRedLanes / 2; half > 0; half /= 2) {
    __syncthreads();
    if (r < half) s_sum[r][col] += s_sum[r + half][col];
  }
  if (r == 0 && k < P) {
    const T tot = from_f32<T>(s_sum[0][col]);
    if (k < D * HF) dw[k] = tot;
    else if (k < (D + 1) * HF) db[k - D * HF] = tot;
    else dattn[k - (D + 1) * HF] = tot;
  }
}

// The tiles for heads of F = 16 MT columns and features of depth KD.
template <class T, int MT, int KD, int MaxThreads>
cudaError_t launch_tiles(const T* x, const T* w, const T* b, const T* er, const T* attn,
                         const T* mask, const T* g, const T* out, const float* mstat,
                         const float* lstat, T* der, T* dx, float* partial, int N, int M, int D,
                         int HF, int H, float slope, cudaStream_t stream, int& grid) {
  static GridCache cache[2];
  const bool with_dx = dx != nullptr;
  const int dx_words = with_dx ? 8 : 0;           // a slot's share of s_dx, per warp
  const int chunk = tile_chunk(M, H, D, 16 * MT, sizeof(T), kRowSlices, kStats);
  const size_t smem =
      4 * ((size_t)H * ring_layout(chunk, D, 16 * MT, sizeof(T), kRowSlices, kStats).total
           + (size_t)H * chunk * dx_words);
  auto kernel = with_dx ? flash_gat_fused_bwd_tiles<T, MT, KD, true, MaxThreads>
                        : flash_gat_fused_bwd_tiles<T, MT, KD, false, MaxThreads>;
  cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e == cudaSuccess)
    e = grid_for((const void*)kernel, 32 * H, smem, N, kMaxCtas, cache[with_dx], grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 32 * H, smem, stream>>>(x, w, b, er, attn, mask, g, out, mstat, lstat, der,
                                         dx, partial, N, M, D, HF, H, chunk, slope);
  return cudaGetLastError();
}

// The instantiation for F and D, H <= 8: 4 m16 tiles a head at F = 64, 2 at 32; depth 4 for D
// <= 4, else 8; 3 CTAs an SM where H <= 4.
template <class T, int MaxThreads>
cudaError_t tiles_for(const T* x, const T* w, const T* b, const T* er, const T* attn,
                      const T* mask, const T* g, const T* out, const float* mstat,
                      const float* lstat, T* der, T* dx, float* partial, int N, int M, int D,
                      int HF, int H, float slope, cudaStream_t stream, int& grid) {
#define FGF_ARGS x, w, b, er, attn, mask, g, out, mstat, lstat, der, dx, partial, N, M, D, HF, \
                 H, slope, stream, grid
  if (HF / H == 64)
    return D <= 4 ? launch_tiles<T, 4, 4, MaxThreads>(FGF_ARGS)
                  : launch_tiles<T, 4, 8, MaxThreads>(FGF_ARGS);
  return D <= 4 ? launch_tiles<T, 2, 4, MaxThreads>(FGF_ARGS)
                : launch_tiles<T, 2, 8, MaxThreads>(FGF_ARGS);
#undef FGF_ARGS
}

template <class T>
cudaError_t backward(const T* x, const T* w, const T* b, const T* er, const T* attn,
                     const T* mask, const T* g, const T* out, const float* mstat,
                     const float* lstat, T* dw, T* db, T* der, T* dattn, T* dx, float* partial,
                     int N, int M, int D, int HF, int H, float slope, cudaStream_t stream) {
  if (D > kMaxD || HF % 32 != 0 || HF > 1024 || H <= 0 || HF % H != 0 || (HF / H) % 32 != 0)
    return cudaErrorInvalidValue;
  int grid = N < kMaxCtas ? N : kMaxCtas;
  if (N > 0) {
#define FGF_ARGS x, w, b, er, attn, mask, g, out, mstat, lstat, der, dx, partial, N, M, D, HF, \
                 H, slope, stream
    const cudaError_t e = !use_tiles(M, HF / H, H) ? rows_backward<T>(FGF_ARGS)
                          : H <= 4                 ? tiles_for<T, 128>(FGF_ARGS, grid)
                                                   : tiles_for<T, kTileThreads>(FGF_ARGS, grid);
#undef FGF_ARGS
    if (e != cudaSuccess) return e;
  }
  const int P = (D + 2) * HF;
  auto reduce = flash_gat_fused_bwd_reduce<T>;
  reduce<<<(P + kRedCols - 1) / kRedCols, kRedCols * kRedLanes, 0, stream>>>(
      partial, dw, db, dattn, grid, D, HF);
  return cudaGetLastError();
}

}  // namespace

// partial: min(N, 1024) rows of (D + 2) * HF floats (one a CTA of launch 1; it may use fewer).
extern "C" int flash_gat_fused_backward(
    const float* x, const float* w, const float* b, const float* er, const float* attn,
    const float* mask, const float* g, const float* out, const float* mstat,
    const float* lstat, float* dw, float* db, float* der, float* dattn, float* dx,
    float* partial, int N, int M, int D, int HF, int H, float slope, cudaStream_t stream) {
  return backward<float>(x, w, b, er, attn, mask, g, out, mstat, lstat, dw, db, der, dattn, dx,
                         partial, N, M, D, HF, H, slope, stream);
}

extern "C" int flash_gat_fused_backward_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* b,
    const __nv_bfloat16* er, const __nv_bfloat16* attn, const __nv_bfloat16* mask,
    const __nv_bfloat16* g, const __nv_bfloat16* out, const float* mstat, const float* lstat,
    __nv_bfloat16* dw, __nv_bfloat16* db, __nv_bfloat16* der, __nv_bfloat16* dattn,
    __nv_bfloat16* dx, float* partial, int N, int M, int D, int HF, int H, float slope,
    cudaStream_t stream) {
  return backward<__nv_bfloat16>(x, w, b, er, attn, mask, g, out, mstat, lstat, dw, db, der,
                                 dattn, dx, partial, N, M, D, HF, H, slope, stream);
}

extern "C" const char* flash_gat_fused_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
