// Projection-fused GATv2 attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel uav_bs_ctrl_tpu/ops/pallas_kernels.py:flash_gat_fused (:329;
// body _flash_gat_fused_kernel, :192). For each destination row n:
//
//   el[j]   = x[n, j, :] @ W + b                      (projected in-kernel, never stored)
//   s[j, h] = attn[h] . LeakyReLU(el[j] + er[n])[h]  (per head, over F features)
//   out[n]  = sum_j softmax_j(s[:, h]) * el[j]        (over the valid slots j)
//
// plus the f32 row statistics m[n, h] (the max) and l[n, h] (the denominator) that the
// backward rebuilds alpha from. All-masked rows give out = 0, m = -1e30 and l = 0: the
// shift is 0 when the max is <= -1e30/2 and the denominator is max(l, 1e-30).
//
// Design. Rows of more than 16 slots ('seen', M = 50) of heads of 32 or 64 columns take the
// slot tiles of flash_gat_tile.cuh: a CTA of H warps, warp h head h, over a grid of rows. Per row the
// warp lists the valid slots of its staged mask, then per tile of 8 slots projects its
// head's columns on the tensor cores (tf32 mma.sync, 3xTF32 at f32, b + er entering with
// big x big), takes the LeakyReLU select and the attn FMA in the accumulator registers, and
// sums each slot's score over the 8 lanes that hold it. The softmax is online over the
// row's tiles (the max, l and the weights rescaled when a tile raises the max). Nothing is
// projected twice: in exact arithmetic out_h = (sum_j p_jh x_j) W_h / l_h + b_h, so the
// aggregation sums D features per slot and head (the lane of feature g), and each output
// column is D FMAs a row. Shorter rows ('near', M = 7; the host loop's exp1 rows of 10) and
// other widths take the warp-per-(row, head) body below (flash_gat_common.cuh: a CTA of H warps a row,
// warp h compacts the row's valid slots and walks them twice, the scores by one butterfly a
// slot, the softmax exact in two passes), which was faster there (PERF.md).
//
// What bounds it: at the update's inputs the bytes and operations take less than a launch;
// at bench.py's hoisted B = 256 (N = 104,448 rows, 'seen' 70 % valid) the instructions
// each lane issues per column and slot and per row (flash_gat_tile.cuh). On an NVIDIA H100
// 80GB HBM3 at 700 W (chip_ab.py, in turns with the warp-per-(row, head) body alone): 'seen'
// 0.8723 ms at f32 and 0.7511 at bf16 against 1.2959 and 1.3196; N = 256 0.0080 against 0.0105.
//
// Storage types (storage.cuh): the kernel is a template on the type T of x, w, b, er, attn,
// mask and out, float (flash_gat_fused_forward) or __nv_bfloat16
// (flash_gat_fused_forward_bf16). A bf16 load widens to f32, the projection (one exact tf32
// pass), scores, softmax and sums are f32, out is rounded to T once, and the row statistics
// m and l stay f32 in both; the bf16 call is the f32 call on the widened operands, rounded.
// At bf16 the kernel computes the unrounded form: JAX's pallas_fused_mxu also rounds the
// scores' input e and the weights p to bf16 before its dots (pallas_kernels.py:252-279),
// pallas_fused does not; one kernel serves both.

#include "flash_gat_tile.cuh"

namespace {

// ---- The warp-per-(row, head) body, for rows of at most two tiles' worth of slots ----

// The head's scores of the warp's staged slots into s_sc, and their max into m.
template <int CM, int DM>
__device__ __forceinline__ void chunk_scores(const HeadSlice<CM, DM>& sl, const float (&er)[CM],
                                             const float* s_x, const int* s_list, int cnt,
                                             float slope, float* s_sc, int lane, float& m) {
#pragma unroll 4
  for (int k = 0; k < cnt; ++k) {
    float el[CM];
    sl.project(s_x + s_list[k] * DM, el);
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      const float z = el[c] + er[c];
      v = fmaf(z >= 0.f ? z : slope * z, sl.attn[c], v);
    }
    v = warp_sum(v);
    if (lane == 0) s_sc[k] = v;
    m = fmaxf(m, v);
  }
}

template <class T, int CM, int DM, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads) flash_gat_fused_fwd_rows(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
    const T* __restrict__ er, const T* __restrict__ attn, const T* __restrict__ mask,
    T* __restrict__ out, float* __restrict__ mstat, float* __restrict__ lstat, int M,
    int D, int HF, int H, int chunk, float slope) {
  extern __shared__ float smem[];
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31, n = blockIdx.x;
  const int F = HF / H, C = F / 32, col0 = h * F + lane;
  float* s_x = smem + (size_t)h * chunk * (DM + 2);         // this warp's [chunk, DM]
  float* s_sc = s_x + chunk * DM;                             // its scores [chunk]
  int* s_list = reinterpret_cast<int*>(s_sc + chunk);         // its valid slots [chunk]
  const T* x_row = x + (size_t)n * M * D;
  const T* mask_row = mask + (size_t)n * M;

  HeadSlice<CM, DM> sl;
  sl.load(w, b, attn, col0, C, D, HF);
  float erl[CM];
  row_slice<CM>(er + (size_t)n * HF, col0, C, erl);

  float m = kNegBig;
  int cnt = 0;
  for (int j0 = 0; j0 < M; j0 += chunk) {         // 1. scores and the max
    cnt = stage_chunk<DM>(x_row, mask_row, j0, min(chunk, M - j0), D, s_x, s_list, lane);
    chunk_scores<CM, DM>(sl, erl, s_x, s_list, cnt, slope, s_sc, lane, m);
  }
  const float shift = m <= kNegBig / 2 ? 0.f : m;

  float l = 0.f, acc[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) acc[c] = 0.f;
  for (int j0 = 0; j0 < M; j0 += chunk) {         // 2. p, l and sum p * el
    if (M > chunk) {                              // the table holds the last chunk only
      float unused = kNegBig;
      cnt = stage_chunk<DM>(x_row, mask_row, j0, min(chunk, M - j0), D, s_x, s_list, lane);
      chunk_scores<CM, DM>(sl, erl, s_x, s_list, cnt, slope, s_sc, lane, unused);
    }
    __syncwarp();                                 // lane 0's table entries are written
#pragma unroll 4
    for (int k = 0; k < cnt; ++k) {
      const float p = expf(s_sc[k] - shift);
      l += p;
      float el[CM];
      sl.project(s_x + s_list[k] * DM, el);
#pragma unroll
      for (int c = 0; c < CM; ++c) acc[c] = fmaf(p, el[c], acc[c]);
    }
  }
  const float inv = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < CM; ++c)
    if (c < C) out[(size_t)n * HF + col0 + 32 * c] = from_f32<T>(acc[c] / inv);
  if (lane == 0) {
    mstat[(size_t)n * H + h] = m;
    lstat[(size_t)n * H + h] = l;
  }
}

template <class T, int CM, int DM, int MaxThreads>
cudaError_t launch_rows(const T* x, const T* w, const T* b, const T* er, const T* attn,
                        const T* mask, T* out, float* mstat, float* lstat, int N, int M, int D,
                        int HF, int H, float slope, cudaStream_t stream) {
  const int chunk = chunk_for(M, H, DM + 2);
  const size_t smem = sizeof(float) * (size_t)H * chunk * (DM + 2);
  auto kernel = flash_gat_fused_fwd_rows<T, CM, DM, MaxThreads>;
  cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<N, 32 * H, smem, stream>>>(x, w, b, er, attn, mask, out, mstat, lstat, M, D, HF, H,
                                      chunk, slope);
  return cudaGetLastError();
}

template <class T>
cudaError_t rows_forward(const T* x, const T* w, const T* b, const T* er, const T* attn,
                         const T* mask, T* out, float* mstat, float* lstat, int N, int M, int D,
                         int HF, int H, float slope, cudaStream_t stream) {
  const int C = HF / H / 32;                      // columns a lane
#define FGF_ARGS x, w, b, er, attn, mask, out, mstat, lstat, N, M, D, HF, H, slope, stream
  if (H > 8)                                      // more than 256 threads: F is 32, 64 or 96
    return C <= 2 ? launch_rows<T, 2, kMaxD, 1024>(FGF_ARGS)
                  : launch_rows<T, 4, kMaxD, 1024>(FGF_ARGS);
  if (C > 8) return launch_rows<T, 32, kMaxD, 256>(FGF_ARGS);
  if (C > 4) return launch_rows<T, 8, kMaxD, 256>(FGF_ARGS);
  if (C > 2) return launch_rows<T, 4, kMaxD, 256>(FGF_ARGS);
  switch (dm_for(D)) {                            // the runs' F = 64: two columns a lane
    case 2: return launch_rows<T, 2, 2, 256>(FGF_ARGS);
    case 4: return launch_rows<T, 2, 4, 256>(FGF_ARGS);
    default: return launch_rows<T, 2, kMaxD, 256>(FGF_ARGS);
  }
#undef FGF_ARGS
}

// ---- The slot tiles ----

template <class T, int MT, int KD>
__global__ void __launch_bounds__(kTileThreads) flash_gat_fused_fwd_tiles(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
    const T* __restrict__ er, const T* __restrict__ attn, const T* __restrict__ mask,
    T* __restrict__ out, float* __restrict__ mstat, float* __restrict__ lstat, int N, int M,
    int D, int HF, int H, int chunk, float slope) {
  extern __shared__ float smem[];
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int F = 16 * MT, c0 = h * F;
  const RingLayout L = ring_layout(chunk, D, F, sizeof(T), 1, 0);
  unsigned* area = reinterpret_cast<unsigned*>(smem) + (size_t)h * L.total;
  int* list = reinterpret_cast<int*>(area + L.list);
  float* wf = reinterpret_cast<float*>(area + L.wf);     // W rows and b of the head

  auto fetch = [&](const Unit& u, unsigned* buf) {
    const int len = min(chunk, M - u.j0);
    fetch_span(buf + L.mask, mask + (size_t)u.n * M + u.j0, len, lane);
    fetch_span(buf + L.x, x + ((size_t)u.n * M + u.j0) * D, len * D, lane);
    fetch_span(buf + L.row, er + (size_t)u.n * HF + c0, F, lane);
  };
  Unit u{(int)blockIdx.x, 0};
  if (u.n < N) fetch(u, area);
  cp_async_commit();
  stage_head(wf, w, b, c0, F, D, HF, lane);       // while the first unit is in flight
  Cols<T, MT, KD> cc;                             // the head's columns
  cc.load(w, attn, c0, D, HF, slope, g, t);
  float be[MT][2];                                // b + er at the lane's columns
  float mrun = kNegBig, l = 0.f, px = 0.f;        // the row's running max, l, sum p x[g]
  for (int buf = 0; u.n < N; buf ^= 1) {
    const Unit nu = u.j0 + chunk < M ? Unit{u.n, u.j0 + chunk} : Unit{u.n + (int)gridDim.x, 0};
    if (nu.n < N) fetch(nu, area + (buf ^ 1) * L.buf);
    cp_async_commit();
    cp_async_wait<1>();                           // this lane's copies of unit u have landed
    __syncwarp();                                 // and every lane's
    const unsigned* cur = area + buf * L.buf;
    const T* m_s = span_at(cur + L.mask, mask + (size_t)u.n * M + u.j0);
    const T* x_s = span_at(cur + L.x, x + ((size_t)u.n * M + u.j0) * D);
    if (u.j0 == 0) {                              // a row's first unit
      mrun = kNegBig;
      l = px = 0.f;
      float bv[MT][2];
      row_cols<MT>(wf + D * F, 0, g, bv);
      row_cols<MT>(span_at(cur + L.row, er + (size_t)u.n * HF + c0), 0, g, be);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i) be[m][i] += bv[m][i];
    }
    const int cnt = list_staged(m_s, min(chunk, M - u.j0), list, lane);
    __syncwarp();                                 // the list is written
    for (int k0 = 0; k0 < cnt; k0 += kSlots) {
      unsigned xb[KD / 4], xsm[KD / 4];
      x_fragment<T, KD>(x_s, list, k0, D, g, t, xb, xsm);
      float s0 = 0.f, s1 = 0.f;                   // slots k0 + 2t and k0 + 2t + 1
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // z = el + er: columns g, g, g + 8, g + 8 of slots 2t, 2t + 1, b + er added by the
        // tensor cores with big x big
        float z[4] = {be[m][0], be[m][0], be[m][1], be[m][1]};
        project<T, KD>(z, cc.wa[m], cc.ws[m], xb, xsm);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = i >> 1;
          const float a = z[i] >= 0.f ? cc.at[m][col] : cc.sat[m][col];
          if (i & 1) s1 = fmaf(a, z[i], s1);
          else s0 = fmaf(a, z[i], s0);
        }
      }
      // Lane (g, t) ends with the score of slot k0 + 2t + hi, hi = g >= 4 (lanes 16 .. 31).
      const int hi = lane >> 4;
      const float sc = sum_pair_over_g(s0, s1, hi);
      const bool valid = k0 + 2 * t + hi < cnt;
      float tmax = valid ? sc : kNegBig;
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 16));
      if (tmax > mrun) {                          // uniform over the warp
        const float scale = mrun <= kNegBig / 2 ? 0.f : expf(mrun - tmax);
        l *= scale;
        px *= scale;
        mrun = tmax;
      }
      const float p = valid ? expf(sc - mrun) : 0.f;
      const float q = __shfl_xor_sync(kFull, p, 16);          // the other slot's
      l += p;
      px = fmaf(hi ? q : p, x_at(x_s, list, k0 + 2 * t, g, D), px);
      px = fmaf(hi ? p : q, x_at(x_s, list, k0 + 2 * t + 1, g, D), px);
    }
    if (nu.n != u.n) {                            // the row's last unit: its outputs
      const float lr = sum_over_t(l + __shfl_xor_sync(kFull, l, 16));   // every lane: l
      const float pr = sum_over_t(px);            // lanes 4d .. 4d + 3: sum_j p_j x_j[d]
      float pxd[KD];
#pragma unroll
      for (int d = 0; d < KD; ++d) pxd[d] = __shfl_sync(kFull, pr, 4 * d);
      const float inv = fmaxf(lr, 1e-30f);
#pragma unroll
      for (int f = lane; f < F; f += 32) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < KD; ++d)
          if (d < D) acc = fmaf(pxd[d], wf[d * F + f], acc);
        out[(size_t)u.n * HF + c0 + f] = from_f32<T>(lr > 0.f ? acc / inv + wf[D * F + f] : 0.f);
      }
      if (lane == 0) {
        mstat[(size_t)u.n * H + h] = mrun;
        lstat[(size_t)u.n * H + h] = lr;
      }
    }
    __syncwarp();                                 // done with the buffer and the list
    u = nu;
  }
  cp_async_wait<0>();
}

// The tiles for heads of F = 16 MT columns and features of depth KD.
template <class T, int MT, int KD>
cudaError_t launch_forward(const T* x, const T* w, const T* b, const T* er, const T* attn,
                           const T* mask, T* out, float* mstat, float* lstat, int N, int M,
                           int D, int HF, int H, float slope, cudaStream_t stream) {
  static GridCache cache;
  const int chunk = tile_chunk(M, H, D, 16 * MT, sizeof(T), 1, 0);
  const size_t smem = 4 * (size_t)H * ring_layout(chunk, D, 16 * MT, sizeof(T), 1, 0).total;
  auto kernel = flash_gat_fused_fwd_tiles<T, MT, KD>;
  cudaError_t e = allow_smem((const void*)kernel, smem);
  int grid = 0;
  if (e == cudaSuccess) e = grid_for((const void*)kernel, 32 * H, smem, N, N, cache, grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 32 * H, smem, stream>>>(x, w, b, er, attn, mask, out, mstat, lstat, N, M, D,
                                         HF, H, chunk, slope);
  return cudaGetLastError();
}

template <class T>
cudaError_t forward(const T* x, const T* w, const T* b, const T* er, const T* attn,
                    const T* mask, T* out, float* mstat, float* lstat, int N, int M, int D,
                    int HF, int H, float slope, cudaStream_t stream) {
  if (D > kMaxD || HF % 32 != 0 || HF > 1024 || H <= 0 || HF % H != 0 || (HF / H) % 32 != 0)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
#define FGF_ARGS x, w, b, er, attn, mask, out, mstat, lstat, N, M, D, HF, H, slope, stream
  if (!use_tiles(M, HF / H, H)) return rows_forward<T>(FGF_ARGS);
  if (HF / H == 64)                               // F = 64: 4 m16 tiles a head; else 32: 2
    return D <= 4 ? launch_forward<T, 4, 4>(FGF_ARGS) : launch_forward<T, 4, 8>(FGF_ARGS);
  return D <= 4 ? launch_forward<T, 2, 4>(FGF_ARGS) : launch_forward<T, 2, 8>(FGF_ARGS);
#undef FGF_ARGS
}

}  // namespace

extern "C" int flash_gat_fused_forward(
    const float* x, const float* w, const float* b, const float* er, const float* attn,
    const float* mask, float* out, float* mstat, float* lstat,
    int N, int M, int D, int HF, int H, float slope, cudaStream_t stream) {
  return forward<float>(x, w, b, er, attn, mask, out, mstat, lstat, N, M, D, HF, H, slope,
                        stream);
}

extern "C" int flash_gat_fused_forward_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* b,
    const __nv_bfloat16* er, const __nv_bfloat16* attn, const __nv_bfloat16* mask,
    __nv_bfloat16* out, float* mstat, float* lstat,
    int N, int M, int D, int HF, int H, float slope, cudaStream_t stream) {
  return forward<__nv_bfloat16>(x, w, b, er, attn, mask, out, mstat, lstat, N, M, D, HF, H,
                                slope, stream);
}

// Whether a call's rows of M slots, H heads of HF / H columns take the slot tiles (1) or the
// warp-per-(row, head) body (0).
extern "C" int flash_gat_fused_uses_tiles(int M, int HF, int H) {
  return use_tiles(M, HF / H, H) ? 1 : 0;
}

extern "C" const char* flash_gat_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
