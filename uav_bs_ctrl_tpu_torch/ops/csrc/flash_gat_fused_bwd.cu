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
// What bounds it: at the update's inputs (N = 256 rows, M = 50 or 7 slots, D = 4 or 2,
// H*F = 4*64) about (4D+16)*HF f32 operations per valid slot: 0.60 and 0.32 us on an
// H100 at 67 TFLOP/s and 3.35 TB/s, far less than one launch. What a call costs is the
// latency of its chain of dependent steps.
//
// What the first design lost (this file up to commit 70ab6d5): one CTA a row, one thread a
// column, walking the row's slots one at a time, each valid slot two 5-step shuffle chains, a
// barrier and a sum over the head's warps, then a second walk with an expf and the
// d_el algebra: 0.027 ms a call at the update's 'seen' inputs.
//
// Design (flash_gat_common.cuh). Launch 1: a CTA of H warps takes a row at a time (one
// row a CTA at training's N = 256; at most kMaxCtas CTAs, then a CTA takes several),
// warp h head h. The warp compacts the row's valid slots and walks them once, two in
// flight: a lane projects its F/32 columns, the score and d_alpha are two butterflies
// over the warp, alpha comes from the forward's m and l, and the lane adds its columns'
// d_z, d_s*leaky(z), d_el and x*d_el into registers (der, dattn, db, dW). Each column
// belongs to one lane of one warp, so der is written straight from the registers, and
// at the end the CTA writes its dW, db and dattn, summed over its rows, as one partial
// row [(D+2)*HF], with no exchange between warps. With dx, a slot's d_el W^T is a
// reduce-scatter of the D lane partials over the warp (lanes 32/DM*d .. hold feature
// d), the heads' parts meet in shared memory and are added in head order after a
// barrier: the only barrier, and only with dx. Launch 2 sums the CTAs' partials, 16 row
// lanes a column and a fixed tree, so two runs give bit-identical gradients without
// atomics.
//
// Storage types (storage.cuh): a template on the type T of x, w, b, er, attn, mask, g, out
// and of the gradients dW, db, der, dattn and dx, float (flash_gat_fused_backward) or
// __nv_bfloat16 (flash_gat_fused_backward_bf16); the row statistics m, l and the partials
// are f32 in both. Every sum is f32, and each gradient is rounded to T once, where it is
// stored. At bf16 it is the backward of the unrounded form (see flash_gat_fused.cu).

#include "flash_gat_common.cuh"

namespace {

constexpr int kMaxCtas = 1024;      // launch 1's CTAs (and partial rows) at most
constexpr int kRedCols = 32;        // launch 2: columns a CTA ...
constexpr int kRedLanes = 16;       // ... and row lanes a column

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

template <class T, int CM, int DM, int MaxThreads>
cudaError_t launch_rows(const T* x, const T* w, const T* b, const T* er, const T* attn,
                        const T* mask, const T* g, const T* out, const float* mstat,
                        const float* lstat, T* der, T* dx, float* partial, int N, int M, int D,
                        int HF, int H, float slope, cudaStream_t stream) {
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

template <class T>
cudaError_t backward(const T* x, const T* w, const T* b, const T* er, const T* attn,
                     const T* mask, const T* g, const T* out, const float* mstat,
                     const float* lstat, T* dw, T* db, T* der, T* dattn, T* dx, float* partial,
                     int N, int M, int D, int HF, int H, float slope, cudaStream_t stream) {
  if (D > kMaxD || HF % 32 != 0 || HF > 1024 || H <= 0 || HF % H != 0 || (HF / H) % 32 != 0)
    return cudaErrorInvalidValue;
  if (N > 0) {
    const int C = HF / H / 32;                    // columns a lane
    cudaError_t e;
#define FGF_ARGS x, w, b, er, attn, mask, g, out, mstat, lstat, der, dx, partial, N, M, D, HF, \
                 H, slope, stream
    if (H > 8)                                    // more than 256 threads: F is 32, 64 or 96
      e = C <= 2 ? launch_rows<T, 2, kMaxD, 1024>(FGF_ARGS)
                 : launch_rows<T, 4, kMaxD, 1024>(FGF_ARGS);
    else if (C > 8)
      e = launch_rows<T, 32, kMaxD, 256>(FGF_ARGS);
    else if (C > 4)
      e = launch_rows<T, 8, kMaxD, 256>(FGF_ARGS);
    else if (C > 2)
      e = launch_rows<T, 4, kMaxD, 256>(FGF_ARGS);
    else if (dm_for(D) == 2)                      // the runs' F = 64: two columns a lane
      e = launch_rows<T, 2, 2, 256>(FGF_ARGS);
    else if (dm_for(D) == 4)
      e = launch_rows<T, 2, 4, 256>(FGF_ARGS);
    else
      e = launch_rows<T, 2, kMaxD, 256>(FGF_ARGS);
#undef FGF_ARGS
    if (e != cudaSuccess) return e;
  }
  const int P = (D + 2) * HF;
  auto reduce = flash_gat_fused_bwd_reduce<T>;
  reduce<<<(P + kRedCols - 1) / kRedCols, kRedCols * kRedLanes, 0, stream>>>(
      partial, dw, db, dattn, N < kMaxCtas ? N : kMaxCtas, D, HF);
  return cudaGetLastError();
}

}  // namespace

// partial: min(N, 1024) rows of (D + 2) * HF floats (one a CTA of launch 1).
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
