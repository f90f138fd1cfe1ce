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
// What bounds it: f32 arithmetic outside the tensor cores, about 0.99 MFLOP a row at the
// 8-UBS width (hidden 256, msg 64, key 16, 9 actions), nearly all of it the v/s/q and GRU
// products: 0.00379 ms at R = 256 (training), 0.0047 ms at R = 320 (serving 40 worlds) and
// 0.061 ms at R = 4096 (512 worlds) on an H100 at 67 TFLOP/s.
//
// What the first design lost: one CTA of 256 threads per world, so 32 CTAs on the 132 SMs
// at training's W = 32 (40 when serving); each CTA streamed about 2 MB of weights from L2
// for its 8 rows, one strided (row, column) dot product of depth 2H per thread for v/s/q
// and three dependent L2 loads per k-step for the GRU, with 8 warps on an SM to hide them.
// It took 0.319 ms at R = 256, 84x its bound and 2.1x its plain version.
//
// Design. Four launches per call, in dependency order, all on the caller's stream:
//   (a)-(c) tarmac_step_common.cuh's launch_up_to_gates, shared with the backward: the
//           v|s|q and gi/gh products tiled by rows and columns across the whole card,
//           and the per-world masked softmax and c = alpha^T v, into the caller's scratch
//   (d) gates and head: a CTA takes kHeadRows rows, computes the gates and h2 (written out
//       and kept in shared memory), then the head's sums, each split into kHeadSplit
//       chunks of k whose partials are added in a fixed order (no atomics, no warp
//       shuffles), so a repeated call is bit-identical.
// Any A and any R work; R = 0 launches nothing.
//
// Storage types (storage.cuh): every kernel is a template on the type T of x, h, adjf, the
// weights, q and h2, float (tarmac_step_forward) or __nv_bfloat16 (tarmac_step_forward_bf16),
// as JAX's kernel widens every bf16 input to f32 inside (step_kernels.py:126-137). The
// scratch (v|s|q, c, gi, gh) and every sum are f32; q and h2 are rounded to T once, and q is
// computed from the unrounded h2.

#include "tarmac_step_common.cuh"

namespace {

struct tarmac_step_fwd {};          // tags this library's kernels (see the header)
constexpr int kHeadRows = 4;        // rows per CTA in (d): 64 CTAs at R = 256
constexpr int kHeadSplit = 8;       // chunks of k per head output
constexpr int kHeadThreads = 256;

// (d) h2 = GRU gates of (gi, gh, h), and q from h2, for the CTA's rows.
template <class T>
__global__ void __launch_bounds__(kHeadThreads) tarmac_step_fwd_head(
    const T* __restrict__ h, const float* __restrict__ gi, const float* __restrict__ gh,
    const T* __restrict__ wo, const T* __restrict__ bo, const T* __restrict__ wvh,
    const T* __restrict__ bvh, T* __restrict__ q_out, T* __restrict__ h2_out, int R, int H,
    int NACT, int dueling) {
  extern __shared__ float smem[];
  const int O = NACT + (dueling ? 1 : 0);               // the advantages, then the value
  float* s_h2 = smem;                                    // [rows, H]
  float* s_part = s_h2 + kHeadRows * H;                  // [rows, O, kHeadSplit]
  float* s_out = s_part + kHeadRows * O * kHeadSplit;    // [rows, O]
  const int row0 = blockIdx.x * kHeadRows;
  const int rows = min(kHeadRows, R - row0);

  for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
    const int j = i % H;
    const size_t row = (size_t)row0 + i / H;
    const Gates g = gru_gates(gi + row * 3 * H, gh + row * 3 * H, j, H);
    const float h2 = (1.f - g.z) * g.n + g.z * to_f32(h[row * H + j]);
    s_h2[i] = h2;
    h2_out[row * H + j] = from_f32<T>(h2);
  }
  __syncthreads();

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
  const int O = NACT + (dueling ? 1 : 0);
  const size_t smem = sizeof(float) * (size_t)kHeadRows * (H + O * (kHeadSplit + 1));
  auto head = tarmac_step_fwd_head<T>;
  if ((e = allow_smem((const void*)head, smem)) != cudaSuccess) return e;
  const unsigned blocks = (unsigned)((R + kHeadRows - 1) / kHeadRows);
  head<<<blocks, kHeadThreads, smem, stream>>>(h, gi, gh, wo, bo, wvh, bvh, q_out, h2_out, R,
                                               H, NACT, dueling);
  return cudaGetLastError();
}

}  // namespace

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
    const __nv_bfloat16* x, const __nv_bfloat16* h, const __nv_bfloat16* adjf,
    const __nv_bfloat16* wv, const __nv_bfloat16* bv, const __nv_bfloat16* ws,
    const __nv_bfloat16* bs, const __nv_bfloat16* wq, const __nv_bfloat16* bq,
    const __nv_bfloat16* wi, const __nv_bfloat16* wh, const __nv_bfloat16* bi,
    const __nv_bfloat16* bh, const __nv_bfloat16* wo, const __nv_bfloat16* bo,
    const __nv_bfloat16* wvh, const __nv_bfloat16* bvh, __nv_bfloat16* q_out,
    __nv_bfloat16* h2_out, float* scratch, int W, int A, int H, int MSG, int K, int NACT,
    int dueling, float key_size, cudaStream_t stream) {
  return forward<__nv_bfloat16>(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo,
                                wvh, bvh, q_out, h2_out, scratch, W, A, H, MSG, K, NACT,
                                dueling, key_size, stream);
}

extern "C" const char* tarmac_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
