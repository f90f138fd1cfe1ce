// Fused recurrent step for Hopper (sm_90a): TarMAC attention + GRU cell + Q head.
//
// Replaces the TPU kernel uav_bs_ctrl_tpu/ops/step_kernels.py:tarmac_step (:314; body
// _step_fwd_kernel, :122, with _attention_fwd and _gru_fwd, :103). Rows are (world, agent)
// pairs, world-major, R = W*A. For world w:
//
//   [v | s | q] = [x | h] @ [wv | ws | wq] + b         (h is only read, never updated here)
//   alpha[s, d] = softmax over sources s of (s_s . q_d) / key_size, where adjf[w*A+s, d] > 0
//   c[d]        = sum_s alpha[s, d] * v[s]             (a destination with no in-edges: c = 0)
//   h2          = GRUCell([x | c], h)                   gate order r, z, n; h2 = (1-z) n + z h
//   q           = h2 @ wo + bo, or with dueling  (h2 @ wvh + bvh) + adv - mean(adv)
//
// What bounds it: arithmetic, about 0.99 MFLOP a row at the 8-UBS width (hidden 256, msg
// 64, key 16, 9 actions), nearly all of it the v/s/q and GRU products: 0.00379 ms at R =
// 256 (training), 0.0047 ms at R = 320 (serving 40 worlds) and 0.061 ms at R = 4096 (512
// worlds) on an H100's 67 TFLOP/s of f32 FMAs. Both instantiations run the products on the
// tensor cores. The f32 one as 3xTF32, three tf32 passes at 495 TFLOP/s that keep f32's
// accuracy: 0.00153 ms at R = 256. The bf16 one at 989 TFLOP/s: 0.00205 ms at R = 2048,
// where its bytes take about as long. On an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_ab.py): f32 0.0723 ms at R = 256 and 0.1454 at R = 2048 (on the CUDA cores before:
// 0.1066, 0.2089), bf16 0.0456 and 0.0785.
//
// What the first design lost: one CTA of 256 threads per world, so 32 CTAs on the 132 SMs
// at training's W = 32 (40 when serving); each CTA streamed about 2 MB of weights from L2
// for its 8 rows, one strided (row, column) dot product of depth 2H per thread for v/s/q
// and three dependent L2 loads per k-step for the GRU, with 8 warps on an SM to hide them.
// It took 0.319 ms at R = 256, 84x its bound and 2.1x its plain version.
//
// Design. Four launches per call, in dependency order, all on the caller's stream:
//   (a)-(c) tarmac_step_common.cuh's launch_up_to_gates, shared with the backward: the
//           v|s|q and gi/gh products tiled by rows and columns across the whole card
//           (mma.sync on the tensor cores: 3xTF32 at f32; bf16 at bf16, c entering as a
//           bf16 hi/lo pair), and the per-world masked softmax and c = alpha^T v, into the
//           caller's scratch
//   (d) gates and head: a CTA takes kHeadRows rows, computes the gates and h2 (written out
//       and kept in shared memory), then the head's sums, each split into kHeadSplit
//       chunks of k whose partials are added in a fixed order (no atomics, no warp
//       shuffles), so a repeated call is bit-identical.
// Any A and any R work; R = 0 launches nothing.
//
// Column split (tarmac_step_forward_cols, then tarmac_step_forward_head): an mp rank's share
// of the GRU. The first runs (a) and (b) whole, (c) on the hidden columns [lo, hi) of each
// gate only (tarmac_step_common.cuh:launch_gate_cols) and (d)'s gates on those columns,
// writing h2's columns in f32; the caller all-gathers them over the mp ranks into the full
// f32 h2, from which the second launch computes the head, q, and h2 in T. With lo = 0,
// hi = H the pair's q and h2 are tarmac_step_forward's bit for bit: the same products, the
// same gates, and the head summed in the same order from the same unrounded h2.
//
// Storage types (storage.cuh): every kernel is a template on the type T of x, h, adjf, the
// weights, q and h2, float (tarmac_step_forward) or __nv_bfloat16 (tarmac_step_forward_bf16),
// as JAX's kernel widens every bf16 input to f32 inside (step_kernels.py:126-137). The
// scratch (v|s|q, c, gi, gh) and every sum are f32; the bf16 products keep about 16 bits of
// an f32 scratch operand (its hi/lo pair); q and h2 are rounded to T once, and q is computed
// from the unrounded h2.

#include "tarmac_step_common.cuh"

namespace {

struct tarmac_step_fwd {};          // tags this library's kernels (see the header)
constexpr int kHeadRows = 4;        // rows per CTA in (d): 64 CTAs at R = 256
constexpr int kHeadSplit = 8;       // chunks of k per head output
constexpr int kHeadThreads = 256;

// The head of the CTA's rows from their f32 h2 in shared memory (s_h2 [rows, H]): q =
// h2 wo + bo, or with dueling (h2 wvh + bvh) + adv - mean(adv). Each sum is split into
// kHeadSplit chunks of k whose partials are added in a fixed order.
template <class T>
__device__ void head_rows(const float* s_h2, float* s_part, float* s_out,
                          const T* __restrict__ wo, const T* __restrict__ bo,
                          const T* __restrict__ wvh, const T* __restrict__ bvh,
                          T* __restrict__ q_out, int row0, int rows, int H, int NACT,
                          int dueling) {
  const int O = NACT + (dueling ? 1 : 0);               // the advantages, then the value
  const int chunk = (H + kHeadSplit - 1) / kHeadSplit;
  for (int i = threadIdx.x; i < rows * O * kHeadSplit; i += blockDim.x) {
    const int s = i % kHeadSplit, o = (i / kHeadSplit) % O, r = i / (kHeadSplit * O);
    const float* hr = s_h2 + r * H;
    const int k1 = min(H, (s + 1) * chunk);
    float acc = 0.f;
    if (o < NACT)
      for (int k = s * chunk; k < k1; ++k)
        acc = fmaf(hr[k], to_f32(wo[(size_t)k * NACT + o]), acc);
    else
      for (int k = s * chunk; k < k1; ++k) acc = fmaf(hr[k], to_f32(wvh[k]), acc);
    s_part[i] = acc;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * O; i += blockDim.x) {
    const int o = i % O;
    float acc = 0.f;
    for (int s = 0; s < kHeadSplit; ++s) acc += s_part[i * kHeadSplit + s];
    s_out[i] = acc + (o < NACT ? to_f32(bo[o]) : to_f32(bvh[0]));
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * NACT; i += blockDim.x) {
    const int r = i / NACT, o = i % NACT;
    const float* out = s_out + r * O;
    float qv = out[o];
    if (dueling) {
      float mean = 0.f;
      for (int p = 0; p < NACT; ++p) mean += out[p];
      qv = out[NACT] + (qv - mean / NACT);
    }
    q_out[(size_t)(row0 + r) * NACT + o] = from_f32<T>(qv);
  }
}

// (d) h2 = GRU gates of (gi, gh, h), and q from h2, for the CTA's rows.
template <class T>
__global__ void __launch_bounds__(kHeadThreads) tarmac_step_fwd_head(
    const T* __restrict__ h, const float* __restrict__ gi, const float* __restrict__ gh,
    const T* __restrict__ wo, const T* __restrict__ bo, const T* __restrict__ wvh,
    const T* __restrict__ bvh, T* __restrict__ q_out, T* __restrict__ h2_out, int R, int H,
    int NACT, int dueling) {
  extern __shared__ float smem[];
  const int O = NACT + (dueling ? 1 : 0);
  float* s_h2 = smem;                                    // [rows, H]
  float* s_part = s_h2 + kHeadRows * H;                  // [rows, O, kHeadSplit]
  float* s_out = s_part + kHeadRows * O * kHeadSplit;    // [rows, O]
  const int row0 = blockIdx.x * kHeadRows;
  const int rows = min(kHeadRows, R - row0);

  for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
    const int j = i % H;
    const size_t row = (size_t)row0 + i / H;
    const float h2 = gru_out(gru_gates(gi + row * 3 * H, gh + row * 3 * H, j, H),
                             to_f32(h[row * H + j]));
    s_h2[i] = h2;
    h2_out[row * H + j] = from_f32<T>(h2);
  }
  __syncthreads();
  head_rows(s_h2, s_part, s_out, wo, bo, wvh, bvh, q_out, row0, rows, H, NACT, dueling);
}

// A column split's (d), first half: h2's columns [lo, lo + w) in f32, h2c [R, w], from gi
// and gh [R, 3w]; a thread an entry.
template <class T>
__global__ void __launch_bounds__(kHeadThreads) tarmac_step_fwd_gates(
    const T* __restrict__ h, const float* __restrict__ gi, const float* __restrict__ gh,
    float* __restrict__ h2c, int R, int H, int lo, int w) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * w) return;
  const size_t row = i / w;
  const int j = (int)(i % w);
  h2c[i] = gru_out(gru_gates(gi + row * 3 * w, gh + row * 3 * w, j, w),
                   to_f32(h[row * H + lo + j]));
}

// A column split's (d), second half: q and h2 in T from the gathered f32 h2 [R, H].
template <class T>
__global__ void __launch_bounds__(kHeadThreads) tarmac_step_fwd_head_of(
    const float* __restrict__ h2f, const T* __restrict__ wo, const T* __restrict__ bo,
    const T* __restrict__ wvh, const T* __restrict__ bvh, T* __restrict__ q_out,
    T* __restrict__ h2_out, int R, int H, int NACT, int dueling) {
  extern __shared__ float smem[];
  const int O = NACT + (dueling ? 1 : 0);
  float* s_h2 = smem;
  float* s_part = s_h2 + kHeadRows * H;
  float* s_out = s_part + kHeadRows * O * kHeadSplit;
  const int row0 = blockIdx.x * kHeadRows;
  const int rows = min(kHeadRows, R - row0);
  for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
    const float h2 = h2f[(size_t)row0 * H + i];
    s_h2[i] = h2;
    h2_out[(size_t)row0 * H + i] = from_f32<T>(h2);
  }
  __syncthreads();
  head_rows(s_h2, s_part, s_out, wo, bo, wvh, bvh, q_out, row0, rows, H, NACT, dueling);
}

size_t head_smem(int H, int NACT, int dueling) {
  const int O = NACT + (dueling ? 1 : 0);
  return sizeof(float) * (size_t)kHeadRows * (H + O * (kHeadSplit + 1));
}

template <class T>
cudaError_t forward(const T* x, const T* h, const T* adjf, const T* wv, const T* bv,
                    const T* ws, const T* bs, const T* wq, const T* bq, const T* wi,
                    const T* wh, const T* bi, const T* bh, const T* wo, const T* bo,
                    const T* wvh, const T* bvh, T* q_out, T* h2_out, float* scratch, int W,
                    int A, int H, int MSG, int K, int NACT, int dueling, float key_size,
                    cudaStream_t stream) {
  const int R = W * A;
  if (R == 0) return cudaSuccess;
  float* vsq = scratch;
  float* c = vsq + (size_t)R * (MSG + 2 * K);
  float* gi = c + (size_t)R * MSG;
  float* gh = gi + (size_t)R * 3 * H;
  cudaError_t e = launch_up_to_gates<tarmac_step_fwd, T>(x, h, adjf, wv, bv, ws, bs, wq, bq,
                                                         wi, wh, bi, bh, vsq, c, gi, gh, W, A,
                                                         H, MSG, K, key_size, stream);
  if (e != cudaSuccess) return e;
  const size_t smem = head_smem(H, NACT, dueling);
  auto head = tarmac_step_fwd_head<T>;
  if ((e = allow_smem((const void*)head, smem)) != cudaSuccess) return e;
  const unsigned blocks = (unsigned)((R + kHeadRows - 1) / kHeadRows);
  head<<<blocks, kHeadThreads, smem, stream>>>(h, gi, gh, wo, bo, wvh, bvh, q_out, h2_out, R,
                                               H, NACT, dueling);
  return cudaGetLastError();
}

template <class T>
cudaError_t forward_cols(const T* x, const T* h, const T* adjf, const T* wv, const T* bv,
                         const T* ws, const T* bs, const T* wq, const T* bq, const T* wi,
                         const T* wh, const T* bi, const T* bh, float* h2c, float* scratch,
                         int W, int A, int H, int MSG, int K, int lo, int hi, float key_size,
                         cudaStream_t stream) {
  const int R = W * A, w = hi - lo;
  if (lo < 0 || hi > H || w <= 0) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  float* vsq = scratch;
  float* c = vsq + (size_t)R * (MSG + 2 * K);
  float* gi = c + (size_t)R * MSG;
  float* gh = gi + (size_t)R * 3 * w;
  cudaError_t e = launch_attend<tarmac_step_fwd, T>(x, h, adjf, wv, bv, ws, bs, wq, bq, vsq, c,
                                                    W, A, H, MSG, K, key_size, stream);
  if (e != cudaSuccess) return e;
  if ((e = launch_gate_cols<tarmac_step_fwd, T>(x, h, c, wi, wh, bi, bh, gi, gh, R, H, MSG, lo,
                                                w, stream)) != cudaSuccess)
    return e;
  const size_t n = (size_t)R * w;
  auto gates = tarmac_step_fwd_gates<T>;
  gates<<<(unsigned)((n + kHeadThreads - 1) / kHeadThreads), kHeadThreads, 0, stream>>>(
      h, gi, gh, h2c, R, H, lo, w);
  return cudaGetLastError();
}

template <class T>
cudaError_t forward_head(const float* h2f, const T* wo, const T* bo, const T* wvh,
                         const T* bvh, T* q_out, T* h2_out, int R, int H, int NACT,
                         int dueling, cudaStream_t stream) {
  if (R == 0) return cudaSuccess;
  const size_t smem = head_smem(H, NACT, dueling);
  auto head = tarmac_step_fwd_head_of<T>;
  cudaError_t e = allow_smem((const void*)head, smem);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)((R + kHeadRows - 1) / kHeadRows);
  head<<<blocks, kHeadThreads, smem, stream>>>(h2f, wo, bo, wvh, bvh, q_out, h2_out, R, H,
                                               NACT, dueling);
  return cudaGetLastError();
}

}  // namespace

typedef __nv_bfloat16 bf16;

// scratch: R * (MSG + 2K + MSG + 6H) floats (v|s|q, c, gi, gh).
extern "C" int tarmac_step_forward(
    const float* x, const float* h, const float* adjf,
    const float* wv, const float* bv, const float* ws, const float* bs,
    const float* wq, const float* bq, const float* wi, const float* wh,
    const float* bi, const float* bh, const float* wo, const float* bo,
    const float* wvh, const float* bvh, float* q_out, float* h2_out, float* scratch,
    int W, int A, int H, int MSG, int K, int NACT, int dueling, float key_size,
    cudaStream_t stream) {
  return forward<float>(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo, wvh, bvh,
                        q_out, h2_out, scratch, W, A, H, MSG, K, NACT, dueling, key_size,
                        stream);
}

extern "C" int tarmac_step_forward_bf16(
    const bf16* x, const bf16* h, const bf16* adjf, const bf16* wv, const bf16* bv,
    const bf16* ws, const bf16* bs, const bf16* wq, const bf16* bq, const bf16* wi,
    const bf16* wh, const bf16* bi, const bf16* bh, const bf16* wo, const bf16* bo,
    const bf16* wvh, const bf16* bvh, bf16* q_out, bf16* h2_out, float* scratch, int W, int A,
    int H, int MSG, int K, int NACT, int dueling, float key_size, cudaStream_t stream) {
  return forward<bf16>(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo, wvh, bvh,
                       q_out, h2_out, scratch, W, A, H, MSG, K, NACT, dueling, key_size,
                       stream);
}

// A column split's first launch group: h2c [R, hi - lo] f32 from the columns [lo, hi) of
// each gate. scratch: R * (MSG + 2K + MSG + 6 (hi - lo)) floats (v|s|q, c, gi, gh).
extern "C" int tarmac_step_forward_cols(
    const float* x, const float* h, const float* adjf, const float* wv, const float* bv,
    const float* ws, const float* bs, const float* wq, const float* bq, const float* wi,
    const float* wh, const float* bi, const float* bh, float* h2c, float* scratch, int W,
    int A, int H, int MSG, int K, int lo, int hi, float key_size, cudaStream_t stream) {
  return forward_cols<float>(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, h2c, scratch,
                             W, A, H, MSG, K, lo, hi, key_size, stream);
}

extern "C" int tarmac_step_forward_cols_bf16(
    const bf16* x, const bf16* h, const bf16* adjf, const bf16* wv, const bf16* bv,
    const bf16* ws, const bf16* bs, const bf16* wq, const bf16* bq, const bf16* wi,
    const bf16* wh, const bf16* bi, const bf16* bh, float* h2c, float* scratch, int W, int A,
    int H, int MSG, int K, int lo, int hi, float key_size, cudaStream_t stream) {
  return forward_cols<bf16>(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, h2c, scratch,
                            W, A, H, MSG, K, lo, hi, key_size, stream);
}

// A column split's second launch: q and h2 in T from the gathered f32 h2f [R, H].
extern "C" int tarmac_step_forward_head(const float* h2f, const float* wo, const float* bo,
                                        const float* wvh, const float* bvh, float* q_out,
                                        float* h2_out, int R, int H, int NACT, int dueling,
                                        cudaStream_t stream) {
  return forward_head<float>(h2f, wo, bo, wvh, bvh, q_out, h2_out, R, H, NACT, dueling, stream);
}

extern "C" int tarmac_step_forward_head_bf16(const float* h2f, const bf16* wo, const bf16* bo,
                                             const bf16* wvh, const bf16* bvh, bf16* q_out,
                                             bf16* h2_out, int R, int H, int NACT, int dueling,
                                             cudaStream_t stream) {
  return forward_head<bf16>(h2f, wo, bo, wvh, bvh, q_out, h2_out, R, H, NACT, dueling, stream);
}

extern "C" const char* tarmac_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
