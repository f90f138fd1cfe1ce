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
// Design. Eight launches per call, in dependency order, all on the caller's stream:
//   (a)-(c) the forward up to the GRU's pre-activations, launched by tarmac_step_common.cuh's
//           launch_up_to_gates (v|s|q products, per-world alpha and c, gi/gh products)
//   (d) per (row, hidden column): gates, h2, the head backward, the GRU backward -> dg, dh = dh2 z
//   (e) products   dx = dgi wi[:H]^T, dc = dgi wi[H:]^T, dh += dgh wh^T
//   (f) per world  alpha again (world_alpha, as in (b)), dalpha, dscore, dv, ds, dq
//   (g) products   dx += [dv|ds|dq] [wv|ws|wq][:H]^T, and the 14 weight gradients X^T G
//                  (a bias gradient is a ones column times G)
//   (h) each weight gradient's row-chunk partials added in a fixed order and stored in T,
//       and at bf16 dx and dh rounded from their f32 sums
// Every dense product goes through the header's row-tiled product kernel and job table,
// tiled by rows and columns across the whole card: at the training batch (R = 256) one
// CTA per world would keep 32 of the 132 SMs busy and stream every weight from L2 for 8
// rows. The products run on the tensor cores (mma.sync): at f32 as 3xTF32 (each f32 value
// split into two tf32 parts, three products an 8-deep step), at bf16 with f32 scratch
// operands as a bf16 hi/lo pair. An X^T G sum over all R rows, 64 slabs deep in one CTA at
// R = 2048, is split into chunks of 256 rows (split_chunks) whose f32 partials (h) adds in
// a fixed order. No atomics, so a repeated call is bit-identical. Any A and any R work.
// What bounds it: arithmetic, about 7.5e8 operations at R = 256 (the 8-UBS training
// inputs): at f32 0.0112 ms on an H100's 67 TFLOP/s of f32 FMAs, or 0.0045 ms for 3xTF32's
// three tf32 passes at 495 TFLOP/s; at bf16 0.00605 ms at R = 2048 at 989 TFLOP/s. On an
// NVIDIA H100 80GB HBM3 at 700.00 W (chip_ab.py): f32 0.1472 ms at R = 256 and 0.4044 at
// R = 2048 (on the CUDA cores before: 0.2221, 0.6842), bf16 0.0962 and 0.2433; of f32's
// launches at R = 2048 the weight gradients (g) take 0.132 ms and (e) 0.093.
//
// Column split (tarmac_step_backward_cols, then tarmac_step_backward_rest): an mp rank's share
// of the GRU, the hidden columns [lo, hi) of each gate, w = hi - lo. The first entry point
// runs (a) and (b) whole, (c) and (d) on its columns, and (e) as products of its columns'
// dgi and dgh that give full-width partials of dx, dc and dh (dh2 z added on its columns)
// into the caller's f32 buffer red = [dx | dc | dh] ([R, H], [R, MSG], [R, H]); the caller
// all-reduces red over the mp ranks; the second runs (f)-(h) from the summed red: the
// attention backward, dx += [dv|ds|dq] [wv|ws|wq][:H]^T, the full gradients of wv, ws, wq
// and the biases bv, bs, bq, bo, bvh, its columns of wi, wh, bi, bh, and its rows [lo, hi)
// of wo and wvh (h2 of its columns: dwo = h2^T dadv is a sum over h2's columns' rows),
// then dx and dh in T from red. The rest of each gradient is left as the caller set it
// (zeros). With lo = 0, hi = H and no reduction between them the pair gives
// tarmac_step_backward's outputs bit for bit: (c), (e) and the weight gradients are the
// same products (gates that are contiguous are one job), and (d), (f) the same kernels.
//
// Storage types (storage.cuh): every kernel is a template on the type T of the inputs,
// gq, gh2 and the gradients, float (tarmac_step_backward) or __nv_bfloat16
// (tarmac_step_backward_bf16). The scratch and every sum are f32. Each gradient is stored
// in T once: the 14 weight gradients by the last launch (h), from their f32 partials; dx
// and dh, which (e) and (g) add to, are summed in place at f32 and rounded by (h) from f32
// sums in scratch at bf16.

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
  float* part;                      // not per row: split_chunks(R) f32 partials of every
                                    // weight and bias gradient
};

// ---- the split weight-gradient sums ----

constexpr int kSplitRows = 256;     // rows of an X^T G sum a chunk covers (from R = 512 on)
constexpr int kMaxSplit = 16;       // chunks at most; beyond R = 4096 they grow

// The chunks of an X^T G sum over R rows, and the rows of each (whole slabs).
int split_chunks(int R) {
  return std::max(1, std::min(kMaxSplit, (R + kSplitRows - 1) / kSplitRows));
}
int split_rows(int R) {
  const int chunks = split_chunks(R), rows = (R + chunks - 1) / chunks;
  return (rows + kBK - 1) / kBK * kBK;
}

constexpr int kMaxSums = 22;        // the 20 split gradient jobs of (g), dx and dh

struct Sum {                        // out[m, n] (row stride ldc) = the sum, in order, of
  const float* part;                // `parts` dense f32 partials [M, N] from part, rounded
  void* out;
  int parts, M, N, ldc;
  int block0;                       // its first block in the launch
  int group, stride;                // group > 0: column n is stored at column
                                    // (n / group) stride + n % group (a gate's slice)
};

struct Sums {
  Sum sum[kMaxSums];
  int n;
};

// (h) each gradient's partials added in a fixed order and stored (rounded at bf16), and at
// bf16 dx and dh rounded from their f32 sums; a thread an output entry, a block's entries of
// one Sum.
template <class T>
__global__ void __launch_bounds__(kGateThreads) tarmac_step_bwd_finish(
    const __grid_constant__ Sums sums) {
  int e = 0;
  while (e + 1 < sums.n && (int)blockIdx.x >= sums.sum[e + 1].block0) ++e;
  const Sum& S = sums.sum[e];
  const int size = S.M * S.N, i = ((int)blockIdx.x - S.block0) * kGateThreads + threadIdx.x;
  if (i >= size) return;
  float v = 0.f;
  for (int p = 0; p < S.parts; ++p) v += S.part[(size_t)p * size + i];
  const int n = i % S.N, col = S.group > 0 ? n / S.group * S.stride + n % S.group : n;
  static_cast<T*>(S.out)[(size_t)(i / S.N) * S.ldc + col] = from_f32<T>(v);
}

// (d) on the hidden columns [lo, lo + w) of each gate (all of them: lo = 0, w = H), a thread
// an entry of [R, H]: h2, dg = dpre_r|dpre_z|dpre_n|dhn ([R, 4w]) and dh = dh2 z on those
// columns, dh = 0 on the others (dh [R, ldh], the sum (e) adds dgh wh^T to).
template <class T>
__global__ void __launch_bounds__(kGateThreads) tarmac_step_bwd_gates(
    const T* __restrict__ h, const T* __restrict__ wo, const T* __restrict__ wvh,
    const T* __restrict__ gq, const T* __restrict__ gh2, float* __restrict__ dh, int ldh,
    Scratch sc, int R, int H, int lo, int w, int NACT, int dueling) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * H) return;
  const size_t row = i / H;
  const int col = (int)(i % H), j = col - lo;
  if (j < 0 || j >= w) {
    dh[row * ldh + col] = 0.f;
    return;
  }
  const Gates gt = gru_gates(sc.gi + row * 3 * w, sc.gh + row * 3 * w, j, w);
  const float rg = gt.r, zg = gt.z, hnb = gt.hn, ng = gt.n;
  const float hp = to_f32(h[i]);
  sc.h2[row * w + j] = gru_out(gt, hp);

  const T* g = gq + row * NACT;
  float sum = 0.f;
  if (dueling)
    for (int o = 0; o < NACT; ++o) sum += to_f32(g[o]);
  const float mean = sum / NACT;
  float dh2 = 0.f;
  for (int o = 0; o < NACT; ++o) {
    const float da = dueling ? to_f32(g[o]) - mean : to_f32(g[o]);
    dh2 = fmaf(da, to_f32(wo[(size_t)col * NACT + o]), dh2);
    if (j == 0) sc.dadv[row * NACT + o] = da;
  }
  if (dueling) dh2 = fmaf(sum, to_f32(wvh[col]), dh2);
  if (j == 0) sc.dvh[row] = sum;
  dh2 += to_f32(gh2[i]);

  const float dn = dh2 * (1.f - zg);
  const float dz = dh2 * (hp - ng);
  const float dpre_n = dn * (1.f - ng * ng);
  const float dr = dpre_n * hnb;
  float* out = sc.dg + row * 4 * w;
  out[j] = dr * rg * (1.f - rg);
  out[w + j] = dz * zg * (1.f - zg);
  out[2 * w + j] = dpre_n;
  out[3 * w + j] = dpre_n * rg;
  dh[row * ldh + col] = dh2 * zg;
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

// (a)-(e) on the hidden columns [lo, lo + w) (all of them: lo = 0, w = H) into sc's
// per-row scratch and the f32 sums dx, dc, dh, each [R, width], the whole product at w = H
// and full-width partials of a slice's columns otherwise.
template <class T>
cudaError_t backward_gru(const T* x, const T* h, const T* adjf, const T* wv, const T* bv,
                         const T* ws, const T* bs, const T* wq, const T* bq, const T* wi,
                         const T* wh, const T* bi, const T* bh, const T* wo, const T* wvh,
                         const T* gq, const T* gh2, const Scratch& sc, int W, int A, int H,
                         int MSG, int K, int NACT, int dueling, int lo, int w, float key_size,
                         cudaStream_t stream) {
  const int R = W * A, H3 = 3 * H, W4 = 4 * w;
  if (R == 0) return cudaSuccess;
  cudaError_t e;
  if ((e = launch_attend<tarmac_step_bwd, T>(x, h, adjf, wv, bv, ws, bs, wq, bq, sc.vsq, sc.c2,
                                             W, A, H, MSG, K, key_size, stream)) != cudaSuccess)
    return e;
  if ((e = launch_gate_cols<tarmac_step_bwd, T>(x, h, sc.c2, wi, wh, bi, bh, sc.gi, sc.gh, R, H,
                                                MSG, lo, w, stream)) != cudaSuccess)
    return e;
  {  // (d) gates, head and GRU backward; dh = dh2 z on the columns, 0 elsewhere
    const size_t n = (size_t)R * H;
    const unsigned blocks = (unsigned)((n + kGateThreads - 1) / kGateThreads);
    auto gates = tarmac_step_bwd_gates<T>;
    gates<<<blocks, kGateThreads, 0, stream>>>(h, wo, wvh, gq, gh2, sc.dh, H, sc, R, H, lo, w,
                                               NACT, dueling);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  // (e) dx = dgi wi[:H]^T, dc = dgi wi[H:]^T, dh += dgh wh^T (dgh = dpre_r|dpre_z|dhn), over
  // the columns' rows of wi^T and wh^T: a segment a gate, or one for gates that are
  // contiguous in both (all of them at w = H)
  Products<tarmac_step_bwd, T, Back<T>> p;
  const bool whole = w == H;
  Job& jdx = p.template add<Back<T>>(sc.dx, H, R, H, 0, 1, nullptr, 0);
  Job& jdc = p.template add<Back<T>>(sc.dc, MSG, R, MSG, 0, 1, nullptr, 0);
  Job& jdh = p.template add<Back<T>>(sc.dh, H, R, H, 0, 1, nullptr, 1);
  for (int g = 0; g < (whole ? 1 : 3); ++g) {
    const int k = whole ? H3 : w, col = g * H + lo;
    add_seg<Back<T>>(jdx, sc.dg + g * w, W4, wi + col, H3, k);
    add_seg<Back<T>>(jdc, sc.dg + g * w, W4, wi + (size_t)H * H3 + col, H3, k);
  }
  if (whole) {
    add_seg<Back<T>>(jdh, sc.dg, W4, wh, H3, 2 * H);
  } else {
    add_seg<Back<T>>(jdh, sc.dg, W4, wh + lo, H3, w);
    add_seg<Back<T>>(jdh, sc.dg + w, W4, wh + H + lo, H3, w);
  }
  add_seg<Back<T>>(jdh, sc.dg + 3 * w, W4, wh + 2 * H + lo, H3, w);
  return p.launch(stream);
}

// (f)-(h) from sc's per-row scratch and the summed dx, dc, dh: every gradient of the whole
// step (lo = 0, w = H), or the replicated ones, the columns [lo, lo + w) of wi, wh, bi, bh
// and the rows [lo, lo + w) of wo and wvh. dx and dh are stored in T from their f32 sums
// where those are not the outputs themselves (dxdh_summed).
template <class T>
cudaError_t backward_rest(const T* x, const T* h, const T* adjf, const T* wv, const T* ws,
                          const T* wq, T* dx, T* dh, T* dwv, T* dbv, T* dws, T* dbs, T* dwq,
                          T* dbq, T* dwi, T* dwh, T* dbi, T* dbh, T* dwo, T* dbo, T* dwvh,
                          T* dbvh, const Scratch& sc, bool dxdh_summed, int W, int A, int H,
                          int MSG, int K, int NACT, int lo, int w, float key_size,
                          cudaStream_t stream) {
  const int R = W * A, H3 = 3 * H, W4 = 4 * w, P = MSG + 2 * K;
  cudaError_t e;
  if (R > 0) {  // (f) dv, ds, dq, per world
    const size_t smem = sizeof(float) * (size_t)A * (P + 2 * A + MSG);
    auto attend_bwd = tarmac_step_bwd_attend_bwd<T>;
    if ((e = allow_smem((const void*)attend_bwd, smem)) != cudaSuccess) return e;
    attend_bwd<<<W, kWorldThreads, smem, stream>>>(adjf, sc.vsq, sc.dc, sc.dv, sc.ds, sc.dq, A,
                                                   MSG, K, key_size);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }

  // (g) dx += [dv|ds|dq] [wv|ws|wq][:H]^T, and the weight gradients X^T G over all rows
  // (a bias gradient is a ones column, X = nullptr, times G). With R = 0 they are zeros.
  // Every X^T G sum is split into row chunks whose f32 partials (h) adds.
  Products<tarmac_step_bwd, T, Back<T>, GradXPart<T>, GradSPart> p;
  Sums sums{};
  Job& jdx = p.template add<Back<T>>(sc.dx, H, R, H, 0, 1, nullptr, 1);
  add_seg<Back<T>>(jdx, sc.dv, MSG, wv, MSG, MSG);
  add_seg<Back<T>>(jdx, sc.ds, K, ws, K, K);
  add_seg<Back<T>>(jdx, sc.dq, K, wq, K, K);
  // X^T G into a T gradient's f32 partials: a call tensor X (x, h) is of kind GradXPart,
  // f32 scratch or ones (nullptr) of kind GradSPart. A gradient of the columns' gates keeps
  // gate g's w columns at column g H + lo (group w, stride H).
  float* part = sc.part;
  const int chunks = split_chunks(R);
  auto xtg = [&](auto X, int ldx, int xcols, const float* G, int ldg, int gcols, T* grad,
                 int ldo, int group) {
    using Ty = typename std::conditional<std::is_same<decltype(X), const T*>::value,
                                         GradXPart<T>, GradSPart>::type;
    Job& j = p.template add<Ty>(part, gcols, xcols, gcols, 1, 0, nullptr, 0);
    j.split = chunks;
    j.krows = split_rows(R);
    add_seg<Ty>(j, X, ldx, G, ldg, R);
    sums.sum[sums.n++] = Sum{part, grad, chunks, xcols, gcols, ldo, 0, group, H};
    part += (size_t)chunks * xcols * gcols;
  };
  const float* ones = nullptr;
  const float* h2 = sc.h2;
  const float* c2 = sc.c2;
  // [x|h]^T dv, ds, dq and their biases
  xtg(x, H, H, sc.dv, MSG, MSG, dwv, MSG, 0);
  xtg(h, H, H, sc.dv, MSG, MSG, dwv + (size_t)H * MSG, MSG, 0);
  xtg(x, H, H, sc.ds, K, K, dws, K, 0);
  xtg(h, H, H, sc.ds, K, K, dws + (size_t)H * K, K, 0);
  xtg(x, H, H, sc.dq, K, K, dwq, K, 0);
  xtg(h, H, H, sc.dq, K, K, dwq + (size_t)H * K, K, 0);
  // [x|c]^T dgi, h^T dgh, on the columns
  xtg(x, H, H, sc.dg, W4, 3 * w, dwi + lo, H3, w);
  xtg(c2, MSG, MSG, sc.dg, W4, 3 * w, dwi + (size_t)H * H3 + lo, H3, w);
  xtg(h, H, H, sc.dg, W4, 2 * w, dwh + lo, H3, w);
  xtg(h, H, H, sc.dg + 3 * w, W4, w, dwh + 2 * H + lo, H3, w);
  // head: the columns' rows of wo and wvh
  xtg(h2, w, w, sc.dadv, NACT, NACT, dwo + (size_t)lo * NACT, NACT, 0);
  xtg(h2, w, w, sc.dvh, 1, 1, dwvh + lo, 1, 0);
  // biases: column sums
  xtg(ones, 0, 1, sc.dv, MSG, MSG, dbv, MSG, 0);
  xtg(ones, 0, 1, sc.ds, K, K, dbs, K, 0);
  xtg(ones, 0, 1, sc.dq, K, K, dbq, K, 0);
  xtg(ones, 0, 1, sc.dg, W4, 3 * w, dbi + lo, H3, w);
  xtg(ones, 0, 1, sc.dg, W4, 2 * w, dbh + lo, H3, w);
  xtg(ones, 0, 1, sc.dg + 3 * w, W4, w, dbh + 2 * H + lo, H3, w);
  xtg(ones, 0, 1, sc.dadv, NACT, NACT, dbo, NACT, 0);
  xtg(ones, 0, 1, sc.dvh, 1, 1, dbvh, 1, 0);
  if ((e = p.launch(stream)) != cudaSuccess) return e;
  // (h) the gradients' partials added (and rounded at bf16); dx and dh from their f32 sums
  if (dxdh_summed) {
    sums.sum[sums.n++] = Sum{sc.dx, dx, 1, R, H, H, 0, 0, 0};
    sums.sum[sums.n++] = Sum{sc.dh, dh, 1, R, H, H, 0, 0, 0};
  }
  int blocks = 0;
  for (int i = 0; i < sums.n; ++i) {
    sums.sum[i].block0 = blocks;
    blocks += (sums.sum[i].M * sums.sum[i].N + kGateThreads - 1) / kGateThreads;
  }
  auto finish = tarmac_step_bwd_finish<T>;
  finish<<<blocks, kGateThreads, 0, stream>>>(sums);
  return cudaGetLastError();
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
  constexpr bool bf16 = !std::is_same<T, float>::value;
  sc.part = sc.dc + (size_t)R * (MSG + (bf16 ? 2 * H : 0));
  cudaError_t e = backward_gru<T>(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, wvh,
                                  gq, gh2, sc, W, A, H, MSG, K, NACT, dueling, 0, H, key_size,
                                  stream);
  if (e != cudaSuccess) return e;
  return backward_rest<T>(x, h, adjf, wv, ws, wq, dx, dh, dwv, dbv, dws, dbs, dwq, dbq, dwi, dwh,
                          dbi, dbh, dwo, dbo, dwvh, dbvh, sc, bf16, W, A, H, MSG, K, NACT, 0, H,
                          key_size, stream);
}

// A column split's scratch (bwd_cols_scratch_floats, ops/step_kernels.py): per row dg [4w],
// c, h2 [w], dv, ds, dq, dadv, dvh, v|s|q, gi [3w], gh [3w]; then each weight gradient's
// f32 partials, one per row chunk, the columns' gradients w wide. dx, dc and dh are red's.
Scratch carve_cols(float* scratch, float* red, int R, int H, int w, int MSG, int K, int NACT) {
  Scratch sc;
  sc.dg = scratch;
  sc.c2 = sc.dg + (size_t)R * 4 * w;
  sc.h2 = sc.c2 + (size_t)R * MSG;
  sc.dv = sc.h2 + (size_t)R * w;
  sc.ds = sc.dv + (size_t)R * MSG;
  sc.dq = sc.ds + (size_t)R * K;
  sc.dadv = sc.dq + (size_t)R * K;
  sc.dvh = sc.dadv + (size_t)R * NACT;
  sc.vsq = sc.dvh + (size_t)R;
  sc.gi = sc.vsq + (size_t)R * (MSG + 2 * K);
  sc.gh = sc.gi + (size_t)R * 3 * w;
  sc.part = sc.gh + (size_t)R * 3 * w;
  sc.dx = red;
  sc.dc = red + (size_t)R * H;
  sc.dh = sc.dc + (size_t)R * MSG;
  return sc;
}

bool cols_ok(int H, int lo, int hi) { return 0 <= lo && lo < hi && hi <= H; }

}  // namespace

// scratch: bwd_scratch_floats (ops/step_kernels.py) floats: per-row intermediates, at bf16
// 2 R H more, and split_chunks(R) partials of every weight gradient.
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

// A column split's first entry point: (a)-(e) on the columns [lo, hi) of each gate into
// red = [dx | dc | dh] (f32, R (2H + MSG) floats), full-width partials to be summed over the
// ranks. scratch: bwd_cols_scratch_floats (ops/step_kernels.py) floats, handed on to
// tarmac_step_backward_rest.
template <class T>
int backward_cols(const T* x, const T* h, const T* adjf, const T* wv, const T* bv, const T* ws,
                  const T* bs, const T* wq, const T* bq, const T* wi, const T* wh, const T* bi,
                  const T* bh, const T* wo, const T* wvh, const T* gq, const T* gh2, float* red,
                  float* scratch, int W, int A, int H, int MSG, int K, int NACT, int dueling,
                  int lo, int hi, float key_size, cudaStream_t stream) {
  if (!cols_ok(H, lo, hi)) return cudaErrorInvalidValue;
  const Scratch sc = carve_cols(scratch, red, W * A, H, hi - lo, MSG, K, NACT);
  return backward_gru<T>(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, wvh, gq, gh2,
                         sc, W, A, H, MSG, K, NACT, dueling, lo, hi - lo, key_size, stream);
}

// The second: (f)-(h) from red summed over the ranks and the first's scratch.
template <class T>
int backward_rest_cols(const T* x, const T* h, const T* adjf, const T* wv, const T* ws,
                       const T* wq, float* red, T* dx, T* dh, T* dwv, T* dbv, T* dws, T* dbs,
                       T* dwq, T* dbq, T* dwi, T* dwh, T* dbi, T* dbh, T* dwo, T* dbo, T* dwvh,
                       T* dbvh, float* scratch, int W, int A, int H, int MSG, int K, int NACT,
                       int lo, int hi, float key_size, cudaStream_t stream) {
  if (!cols_ok(H, lo, hi)) return cudaErrorInvalidValue;
  const Scratch sc = carve_cols(scratch, red, W * A, H, hi - lo, MSG, K, NACT);
  return backward_rest<T>(x, h, adjf, wv, ws, wq, dx, dh, dwv, dbv, dws, dbs, dwq, dbq, dwi, dwh,
                          dbi, dbh, dwo, dbo, dwvh, dbvh, sc, true, W, A, H, MSG, K, NACT, lo,
                          hi - lo, key_size, stream);
}

#define TARMAC_STEP_BACKWARD_COLS(SUFFIX, T)                                                  \
  extern "C" int tarmac_step_backward_cols##SUFFIX(                                           \
      const T* x, const T* h, const T* adjf, const T* wv, const T* bv, const T* ws,          \
      const T* bs, const T* wq, const T* bq, const T* wi, const T* wh, const T* bi,          \
      const T* bh, const T* wo, const T* wvh, const T* gq, const T* gh2, float* red,         \
      float* scratch, int W, int A, int H, int MSG, int K, int NACT, int dueling, int lo,    \
      int hi, float key_size, cudaStream_t stream) {                                         \
    return backward_cols<T>(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, wvh, gq, \
                            gh2, red, scratch, W, A, H, MSG, K, NACT, dueling, lo, hi,       \
                            key_size, stream);                                               \
  }                                                                                          \
  extern "C" int tarmac_step_backward_rest##SUFFIX(                                           \
      const T* x, const T* h, const T* adjf, const T* wv, const T* ws, const T* wq,          \
      float* red, T* dx, T* dh, T* dwv, T* dbv, T* dws, T* dbs, T* dwq, T* dbq, T* dwi,      \
      T* dwh, T* dbi, T* dbh, T* dwo, T* dbo, T* dwvh, T* dbvh, float* scratch, int W, int A, \
      int H, int MSG, int K, int NACT, int lo, int hi, float key_size, cudaStream_t stream) { \
    return backward_rest_cols<T>(x, h, adjf, wv, ws, wq, red, dx, dh, dwv, dbv, dws, dbs,    \
                                 dwq, dbq, dwi, dwh, dbi, dbh, dwo, dbo, dwvh, dbvh, scratch, \
                                 W, A, H, MSG, K, NACT, lo, hi, key_size, stream);           \
  }

TARMAC_STEP_BACKWARD_COLS(, float)
TARMAC_STEP_BACKWARD_COLS(_bf16, bf16)

extern "C" const char* tarmac_step_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
