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
// Design. Seven launches per call (eight at bf16), in dependency order, all on the caller's
// stream:
//   (a)-(c) the forward up to the GRU's pre-activations, launched by tarmac_step_common.cuh's
//           launch_up_to_gates (v|s|q products, per-world alpha and c, gi/gh products)
//   (d) per (row, hidden column): gates, h2, the head backward, the GRU backward -> dg, dh = dh2 z
//   (e) products   dx = dgi wi[:H]^T, dc = dgi wi[H:]^T, dh += dgh wh^T
//   (f) per world  alpha again (world_alpha, as in (b)), dalpha, dscore, dv, ds, dq
//   (g) products   dx += [dv|ds|dq] [wv|ws|wq][:H]^T, and the 14 weight gradients X^T G
//                  (a bias gradient is a ones column times G)
//   (h) bf16 only: dx and dh rounded from their f32 sums
// Every dense product goes through the header's row-tiled product kernel and job table,
// tiled by rows and columns across the whole card: at the training batch (R = 256) one
// CTA per world would keep 32 of the 132 SMs busy and stream every weight from L2 for 8
// rows. Each output is summed by one thread in a fixed order, with no atomics and no
// split-K, so a repeated call is bit-identical. Any A and any R work.
// What bounds it: f32 arithmetic outside the tensor cores, about 0.0112 ms at R = 256
// (the 8-UBS training inputs) on an H100 at 67 TFLOP/s. Split-precision 3xTF32 mma.sync
// products are the route to the tensor cores at f32 accuracy, and later work.
//
// Storage types (storage.cuh): every kernel is a template on the type T of the inputs,
// gq, gh2 and the gradients, float (tarmac_step_backward) or __nv_bfloat16
// (tarmac_step_backward_bf16). The scratch and every sum are f32. Each gradient is rounded
// to T once: the 14 weight gradients where (g) stores them; dx and dh, which (e) and (g)
// add to, are summed in f32 scratch at bf16 and rounded by a last launch (h), while at
// f32 they are summed in place as before.

#include "tarmac_step_common.cuh"

namespace {

struct tarmac_step_bwd {};          // tags this library's kernels (see the header)
constexpr int kGateThreads = 256;

// (f) the attention backward of one world, from dc: dv, ds, dq.
template <class T>
__global__ void __launch_bounds__(kWorldThreads) tarmac_step_bwd_attend_bwd(
    const T* __restrict__ adjf, const float* __restrict__ vsq,
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
  float* dx;                        // H    dx summed in f32 (bf16 only; else the output)
  float* dh;                        // H    dh summed in f32 (bf16 only; else the output)
};

template <class T>
__global__ void __launch_bounds__(kGateThreads) tarmac_step_bwd_gates(
    const T* __restrict__ h, const T* __restrict__ wo, const T* __restrict__ wvh,
    const T* __restrict__ gq, const T* __restrict__ gh2, float* __restrict__ dh,
    Scratch sc, int R, int H, int NACT, int dueling) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * H) return;
  const size_t row = i / H;
  const int j = (int)(i % H);
  const Gates gt = gru_gates(sc.gi + row * 3 * H, sc.gh + row * 3 * H, j, H);
  const float rg = gt.r, zg = gt.z, hnb = gt.hn, ng = gt.n;
  const float hp = to_f32(h[i]);
  sc.h2[i] = (1.f - zg) * ng + zg * hp;

  const T* g = gq + row * NACT;
  float sum = 0.f;
  if (dueling)
    for (int o = 0; o < NACT; ++o) sum += to_f32(g[o]);
  const float mean = sum / NACT;
  float dh2 = 0.f;
  for (int o = 0; o < NACT; ++o) {
    const float da = dueling ? to_f32(g[o]) - mean : to_f32(g[o]);
    dh2 = fmaf(da, to_f32(wo[(size_t)j * NACT + o]), dh2);
    if (j == 0) sc.dadv[row * NACT + o] = da;
  }
  if (dueling) dh2 = fmaf(sum, to_f32(wvh[j]), dh2);
  if (j == 0) sc.dvh[row] = sum;
  dh2 += to_f32(gh2[i]);

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

// (h) at bf16: dx and dh, summed in f32 scratch, rounded into the outputs.
template <class T>
__global__ void __launch_bounds__(kGateThreads) tarmac_step_bwd_round(
    const float* __restrict__ dx32, const float* __restrict__ dh32, T* __restrict__ dx,
    T* __restrict__ dh, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  dx[i] = from_f32<T>(dx32[i]);
  dh[i] = from_f32<T>(dh32[i]);
}

// Where dx and dh are summed: in the outputs themselves at f32, else in f32 scratch.
template <class T>
float* f32_sum(T* output, float* scratch) {
  if constexpr (std::is_same<T, float>::value) {
    return output;
  } else {
    return scratch;
  }
}

template <class T>
cudaError_t backward(const T* x, const T* h, const T* adjf, const T* wv, const T* bv,
                     const T* ws, const T* bs, const T* wq, const T* bq, const T* wi,
                     const T* wh, const T* bi, const T* bh, const T* wo, const T* bo,
                     const T* wvh, const T* bvh, const T* gq, const T* gh2, T* dx, T* dh,
                     T* dwv, T* dbv, T* dws, T* dbs, T* dwq, T* dbq, T* dwi, T* dwh, T* dbi,
                     T* dbh, T* dwo, T* dbo, T* dwvh, T* dbvh, float* scratch, int W, int A,
                     int H, int MSG, int K, int NACT, int dueling, float key_size,
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
  sc.dx = f32_sum(dx, sc.dc + (size_t)R * MSG);      // bf16: 2 R H floats more
  sc.dh = f32_sum(dh, sc.dc + (size_t)R * (MSG + H));
  cudaError_t e;

  if (R > 0) {
    if ((e = launch_up_to_gates<tarmac_step_bwd, T>(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh,
                                                    bi, bh, sc.vsq, sc.c2, sc.gi, sc.gh, W, A,
                                                    H, MSG, K, key_size, stream)) !=
        cudaSuccess)
      return e;
    {  // (d) gates, head and GRU backward; dh = dh2 z
      const size_t n = (size_t)R * H;
      const unsigned blocks = (unsigned)((n + kGateThreads - 1) / kGateThreads);
      auto gates = tarmac_step_bwd_gates<T>;
      gates<<<blocks, kGateThreads, 0, stream>>>(h, wo, wvh, gq, gh2, sc.dh, sc, R, H, NACT,
                                                 dueling);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    {  // (e) dx = dgi wi[:H]^T, dc = dgi wi[H:]^T, dh += dgh wh^T (dgh = dpre_r|dpre_z|dhn)
      Products<tarmac_step_bwd, Back<T>> p;
      Job& jdx = p.template add<Back<T>>(sc.dx, H, R, H, 0, 1, nullptr, 0);
      add_seg<Back<T>>(jdx, sc.dg, H4, wi, H3, H3);
      Job& jdc = p.template add<Back<T>>(sc.dc, MSG, R, MSG, 0, 1, nullptr, 0);
      add_seg<Back<T>>(jdc, sc.dg, H4, wi + (size_t)H * H3, H3, H3);
      Job& jdh = p.template add<Back<T>>(sc.dh, H, R, H, 0, 1, nullptr, 1);
      add_seg<Back<T>>(jdh, sc.dg, H4, wh, H3, 2 * H);
      add_seg<Back<T>>(jdh, sc.dg + H3, H4, wh + 2 * H, H3, H);
      if ((e = p.launch(stream)) != cudaSuccess) return e;
    }
    {  // (f) dv, ds, dq, per world
      const size_t smem = sizeof(float) * (size_t)A * (P + 2 * A + MSG);
      auto attend_bwd = tarmac_step_bwd_attend_bwd<T>;
      if ((e = allow_smem((const void*)attend_bwd, smem)) != cudaSuccess) return e;
      attend_bwd<<<W, kWorldThreads, smem, stream>>>(adjf, sc.vsq, sc.dc, sc.dv, sc.ds, sc.dq,
                                                     A, MSG, K, key_size);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  }

  // (g) dx += [dv|ds|dq] [wv|ws|wq][:H]^T, and the weight gradients X^T G over all rows
  // (a bias gradient is a ones column, X = nullptr, times G). With R = 0 they are zeros.
  Products<tarmac_step_bwd, Back<T>, GradX<T>, GradS<T>> p;
  Job& jdx = p.template add<Back<T>>(sc.dx, H, R, H, 0, 1, nullptr, 1);
  add_seg<Back<T>>(jdx, sc.dv, MSG, wv, MSG, MSG);
  add_seg<Back<T>>(jdx, sc.ds, K, ws, K, K);
  add_seg<Back<T>>(jdx, sc.dq, K, wq, K, K);
  // X^T G into a T gradient: a call tensor X (x, h) is of kind GradX, f32 scratch or ones
  // (nullptr) of kind GradS.
  auto xtg = [&](auto X, int ldx, int xcols, const float* G, int ldg, int gcols, T* grad,
                 int ldo) {
    using Ty = typename std::conditional<std::is_same<decltype(X), const T*>::value, GradX<T>,
                                         GradS<T>>::type;
    Job& j = p.template add<Ty>(grad, ldo, xcols, gcols, 1, 0, nullptr, 0);
    add_seg<Ty>(j, X, ldx, G, ldg, R);
  };
  const float* ones = nullptr;
  // [x|h]^T dv, ds, dq and their biases
  xtg(x, H, H, sc.dv, MSG, MSG, dwv, MSG);
  xtg(h, H, H, sc.dv, MSG, MSG, dwv + (size_t)H * MSG, MSG);
  xtg(x, H, H, sc.ds, K, K, dws, K);
  xtg(h, H, H, sc.ds, K, K, dws + (size_t)H * K, K);
  xtg(x, H, H, sc.dq, K, K, dwq, K);
  xtg(h, H, H, sc.dq, K, K, dwq + (size_t)H * K, K);
  // [x|c]^T dgi, h^T dgh
  xtg(x, H, H, sc.dg, H4, H3, dwi, H3);
  xtg((const float*)sc.c2, MSG, MSG, sc.dg, H4, H3, dwi + (size_t)H * H3, H3);
  xtg(h, H, H, sc.dg, H4, 2 * H, dwh, H3);
  xtg(h, H, H, sc.dg + H3, H4, H, dwh + 2 * H, H3);
  // head
  xtg((const float*)sc.h2, H, H, sc.dadv, NACT, NACT, dwo, NACT);
  xtg((const float*)sc.h2, H, H, sc.dvh, 1, 1, dwvh, 1);
  // biases: column sums
  xtg(ones, 0, 1, sc.dv, MSG, MSG, dbv, MSG);
  xtg(ones, 0, 1, sc.ds, K, K, dbs, K);
  xtg(ones, 0, 1, sc.dq, K, K, dbq, K);
  xtg(ones, 0, 1, sc.dg, H4, H3, dbi, H3);
  xtg(ones, 0, 1, sc.dg, H4, 2 * H, dbh, H3);
  xtg(ones, 0, 1, sc.dg + H3, H4, H, dbh + 2 * H, H3);
  xtg(ones, 0, 1, sc.dadv, NACT, NACT, dbo, NACT);
  xtg(ones, 0, 1, sc.dvh, 1, 1, dbvh, 1);
  if ((e = p.launch(stream)) != cudaSuccess) return e;
  if constexpr (!std::is_same<T, float>::value) {   // (h) round dx and dh
    const size_t n = (size_t)R * H;
    if (n > 0) {
      auto round = tarmac_step_bwd_round<T>;
      round<<<(unsigned)((n + kGateThreads - 1) / kGateThreads), kGateThreads, 0, stream>>>(
          sc.dx, sc.dh, dx, dh, n);
    }
  }
  return cudaGetLastError();
}

}  // namespace

// scratch: bwd_scratch_floats (ops/step_kernels.py) floats; at bf16 2 R H more.
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
  return backward<float>(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo, wvh, bvh,
                         gq, gh2, dx, dh, dwv, dbv, dws, dbs, dwq, dbq, dwi, dwh, dbi, dbh,
                         dwo, dbo, dwvh, dbvh, scratch, W, A, H, MSG, K, NACT, dueling,
                         key_size, stream);
}

typedef __nv_bfloat16 bf16;

extern "C" int tarmac_step_backward_bf16(
    const bf16* x, const bf16* h, const bf16* adjf, const bf16* wv, const bf16* bv,
    const bf16* ws, const bf16* bs, const bf16* wq, const bf16* bq, const bf16* wi,
    const bf16* wh, const bf16* bi, const bf16* bh, const bf16* wo, const bf16* bo,
    const bf16* wvh, const bf16* bvh, const bf16* gq, const bf16* gh2, bf16* dx, bf16* dh,
    bf16* dwv, bf16* dbv, bf16* dws, bf16* dbs, bf16* dwq, bf16* dbq, bf16* dwi, bf16* dwh,
    bf16* dbi, bf16* dbh, bf16* dwo, bf16* dbo, bf16* dwvh, bf16* dbvh, float* scratch,
    int W, int A, int H, int MSG, int K, int NACT, int dueling, float key_size,
    cudaStream_t stream) {
  return backward<bf16>(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo, wvh, bvh,
                        gq, gh2, dx, dh, dwv, dbv, dws, dbs, dwq, dbq, dwi, dwh, dbi, dbh,
                        dwo, dbo, dwvh, dbvh, scratch, W, A, H, MSG, K, NACT, dueling,
                        key_size, stream);
}

extern "C" const char* tarmac_step_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
