// The device env's scheduler for Hopper (sm_90a): priority-ordered RB assignment and the
// SINR rates of every world in one launch.
//
// Replaces no pallas_call. It ports the loop that uav_bs_ctrl_tpu/envs/jax_env.py keeps on
// the TPU inside its jitted step: _schedule_body_scatter's jax.lax.fori_loop over the M
// ground terminals (GTs) in priority order (:158-185, the body :161-182) and
// _rates_from_schedule (:225-235). The port's plain version of it,
// envs/torch_env.py:_schedule_body_scatter, is a Python loop of some two dozen launches a
// GT from the host (about 1,200 a step at exp3 8-UBS, M = 50).
//
// For each GT m = prior[pm], pm = 0 .. M-1, of a world with N UBSs of R RBs each:
//   1. i = the nearest eligible UBS (used_rbs[i] < R and d[i, m] <= r_cov), the first index
//      on a tie; when none is eligible nothing changes.
//   2. c = the idle RB of UBS i with the least interference at m, the first on a tie; the
//      interference on RB c is sum over UBSs j, in index order, of p_itf[j, m, c].
//   3. UBS i serves m on RB c (used_rbs[i] += 1, rb_occ[i, c] = 1), and
//   4. p_itf[i, :, c] = where(d[i] <= r_cov, p_tx * gain[i], 0) with p_itf[i, m, c] = 0.
// Then rate[m] = bw * log2(1 + p_tx g[i, m] / (sum_j p_itf[j, m, c] + noise)) * 1e-6 over
// m's serving link (0 unserved), and rate_ubs[i] = sum of the rates UBS i serves.
//
// Design: one CTA of one warp a world; the warp walks the GTs in order, so the loop is the
// JAX fori_loop as written, with no block barrier. p_itf is never stored: an RB is given
// once per UBS, so p_itf[j, :, c] is either 0 (RB c of UBS j idle) or UBS j's radiated
// row with its one served GT zeroed, and the GT being placed has not been served yet.
// The interference at m on RB c is then the sum, in index order, of
// rad[j, m] = (d[j, m] <= r_cov ? p_tx * gain[j, m] : 0) over the UBSs j that occupy c,
// the same f32 sum as the plain version's over the dense p_itf (the skipped terms are
// +0). The state is one RB bit mask a UBS and the GT's (i, c), in shared memory; d and rad
// are staged there too where the world fits in 48 KB (exp3 8-UBS 3.2 KB, DenseHotSpotV2
// 3.2 KB, swarm16 25.6 KB), else read from device memory (swarm32, swarm64). Lane c sums
// RB c's interference, and two butterflies of (value, index) pick i and c as argmin
// does. p_tx * gain, the sums and the rate are each rounded as the plain version's f32
// operations round them (__fmul_rn, __fadd_rn: no FMA contraction), with the constants
// rounded to f32 by the caller, so a schedule and a rate agree with the plain version's
// up to the order of its sums. No atomics: a repeated call is bit-identical.
//
// What bounds it: the bytes of d_u2g, gain and prior_gts read once and of the two rate
// outputs written once, over 3.35 TB/s: 512 worlds of exp3 8-UBS are about 2 MB, 0.6 us.
// The kernel is far from that: it is a chain of M dependent steps a world (each an argmin
// over N, R sums of N terms and an argmin over R, a few hundred cycles), so its time per
// GT, ms / M, is the figure to watch; the worlds run side by side, 32 CTAs an SM. On an
// H100 at 700 W (chip_smoke.py): 0.039 ms a call at exp3 8-UBS, 0.78 us a GT, at 40 and
// at 512 worlds alike; swarm64, read from device memory, 2.25 ms, 2.8 us a GT.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxUbs = 64;                 // two a lane
constexpr int kMaxRbs = 32;                 // one a lane; a UBS's RBs are one 32-bit mask
constexpr int kMaxGts = 2048;
constexpr size_t kStageBytes = 48 * 1024;   // dynamic shared memory without an opt-in

struct Consts {
  float r_cov, p_tx, noise, bw, scale;
};

// Power UBS j radiates at a GT at distance d with channel gain g.
__device__ __forceinline__ float radiated(float d, float g, const Consts& k) {
  return d <= k.r_cov ? __fmul_rn(k.p_tx, g) : 0.f;
}

// One world's distances and radiated powers: staged in shared memory, or read from
// device memory (then rad is the gain, and radiated() is applied on each read).
template <bool kStaged>
struct World {
  const float* d;
  const float* rad;
  int M;
  Consts k;
  __device__ __forceinline__ float dist(int j, int m) const { return d[j * M + m]; }
  __device__ __forceinline__ float power(int j, int m) const {
    if constexpr (kStaged) {
      return rad[j * M + m];
    } else {
      return radiated(d[j * M + m], rad[j * M + m], k);
    }
  }
};

// The warp's smallest (v, idx), the smaller index on equal v: argmin's first index.
__device__ __forceinline__ void argmin_warp(float& v, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ov < v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(32)
    schedule_kernel(const float* __restrict__ d_u2g, const float* __restrict__ gain,
                    const long long* __restrict__ prior, float* __restrict__ rate_gt,
                    float* __restrict__ rate_ubs, int* __restrict__ assign_out, int N, int M,
                    int R, Consts k) {
  extern __shared__ float smem[];
  const int w = blockIdx.x, lane = threadIdx.x;
  const size_t nm = size_t(N) * M, off = size_t(w) * nm;
  unsigned* occ = reinterpret_cast<unsigned*>(smem);   // [kMaxUbs] RB bits of each UBS
  int* order = reinterpret_cast<int*>(occ + kMaxUbs);  // [M] the GTs in priority order
  int* assign = order + M;                             // [M] i * R + c, or -1
  float* rate = reinterpret_cast<float*>(assign + M);  // [M]
  const float* d_src = d_u2g + off;
  const float* r_src = gain + off;
  if constexpr (kStaged) {
    float* d_s = rate + M;
    float* r_s = d_s + nm;
    for (size_t e = lane; e < nm; e += 32) {
      const float dv = d_src[e];
      d_s[e] = dv;
      r_s[e] = radiated(dv, r_src[e], k);
    }
    d_src = d_s;
    r_src = r_s;
  }
  for (int j = lane; j < kMaxUbs; j += 32) occ[j] = 0u;
  for (int m = lane; m < M; m += 32) {
    const long long p = prior[size_t(w) * M + m];
    order[m] = p >= 0 && p < M ? int(p) : -1;           // out of range: skipped
    assign[m] = -1;
  }
  __syncwarp();
  const World<kStaged> world{d_src, r_src, M, k};

  for (int pm = 0; pm < M; ++pm) {
    const int m = order[pm];
    if (m < 0) continue;
    // 1. The nearest eligible UBS (lane l holds UBSs l and l + 32).
    float best = INFINITY;
    int i = N;
    for (int j = lane; j < N; j += 32) {
      const float dj = world.dist(j, m);
      if (__popc(occ[j]) < R && dj <= k.r_cov && dj < best) {
        best = dj;
        i = j;
      }
    }
    argmin_warp(best, i);
    if (i == N) continue;                                // no UBS eligible: ok is false
    // 2. RB c's interference at m, summed over the UBSs in index order, by lane c.
    float itf = INFINITY;
    int c = lane;
    if (lane < R && !((occ[i] >> lane) & 1u)) {
      itf = 0.f;
      for (int j = 0; j < N; ++j)
        if ((occ[j] >> lane) & 1u) itf = __fadd_rn(itf, world.power(j, m));
    }
    argmin_warp(itf, c);
    __syncwarp();                                        // every lane has read occ
    // 3-4. Served: p_itf[i, :, c] is now UBS i's radiated row without m (never stored).
    if (lane == 0) {
      occ[i] |= 1u << c;
      assign[m] = i * R + c;
    }
    __syncwarp();
  }

  // _rates_from_schedule: each served GT's SINR over its link, against the interference of
  // every other UBS on its RB.
  for (int m = lane; m < M; m += 32) {
    const int a = assign[m];
    float r = 0.f;
    if (a >= 0) {
      const int i = a / R, c = a - (a / R) * R;
      float itf = 0.f;
      for (int j = 0; j < N; ++j)
        if (j != i && ((occ[j] >> c) & 1u)) itf = __fadd_rn(itf, world.power(j, m));
      // p_tx * gain[i, m] is world.power(i, m): d[i, m] <= r_cov for the serving UBS.
      const float sinr = __fdiv_rn(world.power(i, m), __fadd_rn(itf, k.noise));
      r = __fmul_rn(__fmul_rn(k.bw, log2f(__fadd_rn(1.f, sinr))), k.scale);
    }
    rate[m] = r;
    rate_gt[size_t(w) * M + m] = r;
    if (assign_out != nullptr) assign_out[size_t(w) * M + m] = a;
  }
  __syncwarp();
  for (int j = lane; j < N; j += 32) {
    float s = 0.f;
    for (int m = 0; m < M; ++m)
      if (assign[m] >= j * R && assign[m] < (j + 1) * R) s = __fadd_rn(s, rate[m]);
    rate_ubs[size_t(w) * N + j] = s;
  }
}

size_t base_bytes(int M) { return (size_t(kMaxUbs) + 3 * size_t(M)) * 4; }

size_t staged_bytes(int N, int M) { return base_bytes(M) + 2 * size_t(N) * M * 4; }

}  // namespace

// Whether a world of N UBSs and M GTs is staged in shared memory.
extern "C" int env_schedule_staged(int N, int M) {
  return staged_bytes(N, M) <= kStageBytes ? 1 : 0;
}

// d_u2g, gain: [W, N, M] f32; prior: [W, M] int64; rate_gt: [W, M], rate_ubs: [W, N] f32;
// assign: [W, M] int32 (i * R + c of GT m's serving UBS and RB, -1 unserved) or null.
// The constants are the plain version's f32 roundings: r_cov, p_tx, noise (bw * n0), bw
// and scale (1e-6, Mbps).
extern "C" int env_schedule_forward(const float* d_u2g, const float* gain, const long long* prior,
                                    float* rate_gt, float* rate_ubs, int* assign, int W, int N,
                                    int M, int R, float r_cov, float p_tx, float noise, float bw,
                                    float scale, cudaStream_t stream) {
  if (W < 0 || N < 1 || N > kMaxUbs || M < 0 || M > kMaxGts || R < 1 || R > kMaxRbs)
    return cudaErrorInvalidValue;
  if (W == 0) return cudaSuccess;
  const Consts k{r_cov, p_tx, noise, bw, scale};
  if (env_schedule_staged(N, M)) {
    const size_t smem = staged_bytes(N, M);
    schedule_kernel<true><<<W, 32, smem, stream>>>(d_u2g, gain, prior, rate_gt, rate_ubs,
                                                   assign, N, M, R, k);
  } else {
    const size_t smem = base_bytes(M);
    schedule_kernel<false><<<W, 32, smem, stream>>>(d_u2g, gain, prior, rate_gt, rate_ubs,
                                                    assign, N, M, R, k);
  }
  return cudaGetLastError();
}

extern "C" const char* env_schedule_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
