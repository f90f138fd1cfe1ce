"""``csrc/tarmac_step_bwd.cu`` and ``csrc/tarmac_step.cu`` run on the CPU, through an
emulation of their CUDA threads, against ``tarmac_step_bwd_plain`` and ``tarmac_step_plain``.

Without nvcc a CUDA source cannot be compiled here. These tests compile it
with g++ as C++ instead, under a small header that emulates the pieces the
source uses: each CTA's threads run as fibers (``ucontext``) on the calling
thread, each until it waits at a barrier, those of every other CTA in
reverse order; they meet at a barrier for ``__syncthreads``, and the 32
lanes of each warp at a barrier of their own for ``__shfl_xor_sync``,
``__ballot_sync`` and ``__syncwarp`` (which a kernel calls only where its
warp is converged); CTAs run one after another (so a ``__shared__`` array is
a function-level static); and a launch ``k<<<g, b, smem, s>>>(...)`` (or
``k<Tag><<<...>>>``) becomes a call of the emulated launcher. Every ``csrc/*.cuh`` header is put
through the same substitutions and written beside the source, with a
``cuda_bf16.h`` whose 16-bit type rounds as the card's does
(``BF16_EMULATION_HEADER``; ``test_torch_bf16_emulated.py`` runs the bf16
instantiations), and ``mma_sm90.cuh``, the tensor-core instructions of the
step products (3xTF32 at f32, bf16 at bf16), is replaced by C++ stand-ins
(``MMA_EMULATION_HEADER``; ``test_torch_mma_emulated.py`` and
``test_torch_tf32_emulated.py`` hold them against numpy). The tests call
the C entry points ``tarmac_step_backward`` and ``tarmac_step_forward`` on CPU
tensors through ``ctypes`` (``test_torch_gat_emulated.py`` builds the GATv2
kernels the same way). They check the arithmetic, the job tables, the scratch
layout and the ragged edges; not the card's compiler, timing or memory model
(the card tests in ``test_torch_cuda_kernels.py`` do that). Without g++ they
skip. Tolerance: 1e-5 of max(1, max |plain|) per output (f32 sums in another
order, small widths).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from uav_bs_ctrl_tpu_torch.ops import step_kernels

CSRC = Path(step_kernels.__file__).resolve().parent / "csrc"
ORDER = ("x", "h", "adjf", "wv", "bv", "ws", "bs", "wq", "bq", "wi", "wh", "bi", "bh",
         "wo", "bo", "wvh", "bvh", "gq", "gh2")
EMULATION_HEADER = r"""
#pragma once
#include <ucontext.h>
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return 0; }
// An emulated card of two SMs, each holding one CTA of any kernel: a kernel that sizes its
// grid to the card runs two CTAs, each over many rows.
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 2; return 0; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return 0;
}
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
struct emu_dim3 { unsigned x = 0, y = 0, z = 0; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
struct alignas(16) float4 { float x, y, z, w; };
using std::max;
using std::min;
namespace emu {
// A CTA's threads run as fibers (ucontext) on the launching thread, one at a time: a thread
// runs until it waits at a barrier, and the scheduler resumes the threads whose barrier has
// opened, in thread order in one block and in reverse order in the next, so that a read of
// another thread's write with no barrier between them misreads in one of the two. A
// barrier is a count and a phase; no lock, no OS thread.
struct Barrier {
  explicit Barrier(std::ptrdiff_t n) : expected(n) {}
  std::ptrdiff_t expected, arrived = 0;
  unsigned phase = 0;
  void arrive_and_wait();
  void arrive_and_drop() {         // arrives now and leaves every later phase
    if (--expected == arrived) open();
  }
  void open() {
    arrived = 0;
    ++phase;
  }
};
struct Warp {                      // a warp's lanes meet here for a shuffle or a ballot
  explicit Warp(std::ptrdiff_t lanes) : barrier(lanes) {}
  Barrier barrier;
  unsigned long long slot[32];
  unsigned words[2][32][8];          // gather's posts, the two halves in turn
};
struct Fiber {                     // one CUDA thread
  ucontext_t context;
  emu_dim3 thread_idx;
  Warp* warp = nullptr;
  int lane = 0;
  unsigned gathers = 0;
  const Barrier* waits_at = nullptr; // the barrier it waits at, and the phase it waits out
  unsigned waits_phase = 0;
  bool done = false;
};
inline emu_dim3 block_idx, block_dim, grid_dim;
inline Barrier* block_barrier = nullptr;
inline float* dynamic_smem = nullptr;
inline Fiber* current = nullptr;
inline ucontext_t scheduler;
inline std::function<void()> body;
inline void Barrier::arrive_and_wait() {
  if (++arrived == expected) return open();
  current->waits_at = this;
  current->waits_phase = phase;
  swapcontext(&current->context, &scheduler);
}
inline int lane_id() { return current->lane; }
// Every lane's N words. A lane posts into the half its previous gather did not use, so one
// barrier a gather does: no lane posts there again before every lane has reached the next
// gather, and so has read this one.
template <int N>
void gather(const unsigned (&mine)[N], unsigned (&all)[32][N]) {
  Fiber& f = *current;
  unsigned (&posts)[32][8] = f.warp->words[f.gathers++ & 1u];
  std::memcpy(posts[f.lane], mine, sizeof mine);
  f.warp->barrier.arrive_and_wait();
  for (int l = 0; l < 32; ++l) std::memcpy(all[l], posts[l], sizeof mine);
}
template <class T>
T exchange(T v, int src) {         // every lane posts v, then reads lane src's
  Warp* w = current->warp;
  std::memcpy(&w->slot[current->lane], &v, sizeof(T));
  w->barrier.arrive_and_wait();
  T r;
  std::memcpy(&r, &w->slot[src], sizeof(T));
  w->barrier.arrive_and_wait();
  return r;
}
inline void run_fiber() {          // returns to the scheduler through uc_link
  body();
  current->done = true;
  block_barrier->arrive_and_drop();
  current->warp->barrier.arrive_and_drop();
}
struct Cfg { unsigned grid; int block; size_t smem; cudaStream_t stream; };
constexpr size_t kStack = size_t(1) << 18;
inline std::vector<std::unique_ptr<char[]>> stacks;
inline unsigned blocks_run = 0;
template <class F, class... Args>
void launch(Cfg c, F kernel, Args... args) {
  while ((int)stacks.size() < c.block) stacks.emplace_back(new char[kStack]);
  std::vector<Fiber> fibers(c.block);
  body = [&] { kernel(args...); };
  block_dim.x = c.block;
  grid_dim.x = c.grid;
  for (unsigned b = 0; b < c.grid; ++b) {
    std::vector<float> smem(c.smem / sizeof(float) + 1);
    Barrier barrier(c.block);
    std::vector<std::unique_ptr<Warp>> warps;
    for (int w = 0; 32 * w < c.block; ++w)
      warps.push_back(std::make_unique<Warp>(std::min(32, c.block - 32 * w)));
    block_idx.x = b;
    block_barrier = &barrier;
    dynamic_smem = smem.data();
    for (int t = 0; t < c.block; ++t) {
      Fiber& f = fibers[t];
      f.thread_idx.x = t;
      f.warp = warps[t / 32].get();
      f.lane = t % 32;
      f.gathers = 0;
      f.waits_at = nullptr;
      f.done = false;
      getcontext(&f.context);
      f.context.uc_stack.ss_sp = stacks[t].get();
      f.context.uc_stack.ss_size = kStack;
      f.context.uc_link = &scheduler;
      makecontext(&f.context, run_fiber, 0);
    }
    const bool reverse = blocks_run++ & 1u;
    for (int live = c.block; live > 0;) {
      bool ran = false;
      for (int i = 0; i < c.block; ++i) {
        Fiber& f = fibers[reverse ? c.block - 1 - i : i];
        if (f.done || (f.waits_at != nullptr && f.waits_at->phase == f.waits_phase)) continue;
        f.waits_at = nullptr;
        current = &f;
        ran = true;
        swapcontext(&scheduler, &f.context);
        if (f.done) --live;
      }
      if (!ran) {
        std::fprintf(stderr, "emulated block %u: every thread waits at a barrier\n", b);
        std::abort();
      }
    }
  }
  current = nullptr;
  body = nullptr;
}
}  // namespace emu
template <class T>
T __shfl_xor_sync(unsigned, T v, int off) { return emu::exchange(v, emu::lane_id() ^ off); }
inline unsigned __ballot_sync(unsigned, int pred) {
  emu::Warp* w = emu::current->warp;
  w->slot[emu::lane_id()] = pred != 0;
  w->barrier.arrive_and_wait();
  unsigned bits = 0;
  for (int l = 0; l < 32; ++l)
    if (w->slot[l]) bits |= 1u << l;
  w->barrier.arrive_and_wait();
  return bits;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) { return emu::exchange(v, src & 31); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::current->warp->barrier.arrive_and_wait(); }
#define threadIdx (emu::current->thread_idx)
#define blockIdx emu::block_idx
#define blockDim emu::block_dim
#define gridDim emu::grid_dim
#define __syncthreads() emu::block_barrier->arrive_and_wait()
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __grid_constant__
#define __launch_bounds__(...)
#define __shared__ static
"""

# cuda_bf16.h for the emulation (csrc/storage.cuh includes it): a 16-bit storage type,
# the widening load and the round-to-nearest-even store, bit for bit as on the card.
BF16_EMULATION_HEADER = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { std::uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 v) {
  std::uint32_t u = std::uint32_t(v.x) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  std::uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u)              // NaN stays a (quiet) NaN
    return __nv_bfloat16{std::uint16_t((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);                  // round to nearest, ties to even
  return __nv_bfloat16{std::uint16_t(u >> 16)};
}
"""


# mma_sm90.cuh for the emulation: each instruction's stand-in, in the PTX ISA's per-lane
# fragment layout. The 32 lanes of a warp meet through emu::gather (every lane posts its
# registers or its row address, then reads all), so a lane computes from the whole warp's
# operands as the instruction does; cp.async is a synchronous copy, counted in
# emu_cp_async_calls. Every shared or global address an instruction takes must be 16-byte
# aligned (ldmatrix's rows, cp.async's both ends), as on the card: the stand-ins abort
# otherwise. A tf32 operand is read as the f32 its top 19 bits give (the low 13 cleared),
# and to_tf32 rounds to nearest with ties away from zero. The bf16 product sums in f32,
# rounding to nearest; the tf32 one sums as the tensor cores do (Fasi, Higham, Mikaitis and
# Pranesh 2021, "Numerical behavior of NVIDIA tensor cores", on the A100's TF32): the
# products exact, each block of 4 of them and the running sum aligned to the largest
# exponent among them with the bits below 24 from its leading one cut off, added exactly,
# and the result cut to f32, so every sum rounds toward zero (emu_hmma_block).
MMA_EMULATION_HEADER = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
extern "C" std::atomic<long> emu_cp_async_calls;
std::atomic<long> emu_cp_async_calls{0};
namespace {
inline void emu_aligned(const void* p) {
  if (reinterpret_cast<std::uintptr_t>(p) % 16 != 0) std::abort();
}
inline float emu_half(unsigned word, int h) {           // the bf16 in half h of a word
  const unsigned u = (h ? word >> 16 : word & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  const unsigned mine[6] = {a[0], a[1], a[2], a[3], b[0], b[1]};
  unsigned all[32][6];
  emu::gather(mine, all);
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    for (int h = 0; h < 2; ++h) {
      A[g][2 * t + h] = emu_half(all[l][0], h);
      A[g + 8][2 * t + h] = emu_half(all[l][1], h);
      A[g][2 * t + 8 + h] = emu_half(all[l][2], h);
      A[g + 8][2 * t + 8 + h] = emu_half(all[l][3], h);
      B[2 * t + h][g] = emu_half(all[l][4], h);
      B[2 * t + 8 + h][g] = emu_half(all[l][5], h);
    }
  }
  const int g = emu::lane_id() / 4, t = emu::lane_id() % 4;
  for (int f = 0; f < 4; ++f) {
    const int m = g + 8 * (f / 2), n = 2 * t + f % 2;
    float acc = d[f];
    for (int k = 0; k < 16; ++k) acc += A[m][k] * B[k][n];   // a bf16 product is exact in f32
    d[f] = acc;
  }
}
inline float emu_tf32(unsigned word) {                  // a tf32 operand's value
  const unsigned u = word & 0xffffe000u;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline float emu_hmma_block(float c, const float (&p)[4]) {   // c + p[0] + ... + p[3]
  const double terms[5] = {c, p[0], p[1], p[2], p[3]};
  int top = 0;
  bool any = false;
  for (double v : terms) {
    if (v == 0.0) continue;
    int e;
    std::frexp(v, &e);                                  // |v| in [2^(e-1), 2^e)
    top = any ? std::max(top, e) : e;
    any = true;
  }
  if (!any) return 0.f;
  const double quantum = std::ldexp(1.0, top - 24);     // the last of 24 bits below the top
  double sum = 0.0;                                     // exact: 5 terms of < 2^24 quanta
  for (double v : terms) sum += std::trunc(v / quantum) * quantum;
  float f = static_cast<float>(sum);
  if (std::fabs(static_cast<double>(f)) > std::fabs(sum)) f = std::nextafter(f, 0.f);
  return f;
}
inline void mma_tf32_1688(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  const unsigned mine[6] = {a[0], a[1], a[2], a[3], b[0], b[1]};
  unsigned all[32][6];
  emu::gather(mine, all);
  float A[16][8], B[8][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    A[g][t] = emu_tf32(all[l][0]);
    A[g + 8][t] = emu_tf32(all[l][1]);
    A[g][t + 4] = emu_tf32(all[l][2]);
    A[g + 8][t + 4] = emu_tf32(all[l][3]);
    B[t][g] = emu_tf32(all[l][4]);
    B[t + 4][g] = emu_tf32(all[l][5]);
  }
  const int g = emu::lane_id() / 4, t = emu::lane_id() % 4;
  for (int f = 0; f < 4; ++f) {
    const int m = g + 8 * (f / 2), n = 2 * t + f % 2;
    for (int k0 = 0; k0 < 8; k0 += 4) {                 // a tf32 product is exact in f32
      const float p[4] = {A[m][k0] * B[k0][n], A[m][k0 + 1] * B[k0 + 1][n],
                          A[m][k0 + 2] * B[k0 + 2][n], A[m][k0 + 3] * B[k0 + 3][n]};
      d[f] = emu_hmma_block(d[f], p);
    }
  }
}
inline void mma_tf32_1684(float (&d)[4], const unsigned (&a)[2], const unsigned (&b)[1]) {
  const unsigned mine[3] = {a[0], a[1], b[0]};
  unsigned all[32][3];
  emu::gather(mine, all);
  float A[16][4], B[4][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    A[g][t] = emu_tf32(all[l][0]);
    A[g + 8][t] = emu_tf32(all[l][1]);
    B[t][g] = emu_tf32(all[l][2]);
  }
  const int g = emu::lane_id() / 4, t = emu::lane_id() % 4;
  for (int f = 0; f < 4; ++f) {
    const int m = g + 8 * (f / 2), n = 2 * t + f % 2;
    const float p[4] = {A[m][0] * B[0][n], A[m][1] * B[1][n], A[m][2] * B[2][n],
                        A[m][3] * B[3][n]};
    d[f] = emu_hmma_block(d[f], p);
  }
}
inline unsigned to_tf32(float v) {
  unsigned u;
  std::memcpy(&u, &v, sizeof u);
  if ((u & 0x7f800000u) == 0x7f800000u) return u;        // inf and NaN as they are
  return (u + 0x1000u) & 0xffffe000u;                     // half the dropped ulp, then cut
}
template <int N, bool Trans>
void ldmatrix(unsigned (&r)[N], const void* row) {
  emu_aligned(row);
  unsigned mine[2], all[32][2];
  std::memcpy(mine, &row, sizeof row);
  emu::gather(mine, all);
  auto at = [&](int l, int col) {                        // lane l's row, column col
    const unsigned short* p;
    std::memcpy(&p, all[l], sizeof p);
    return unsigned(p[col]);
  };
  const int g = emu::lane_id() / 4, t = emu::lane_id() % 4;
  for (int i = 0; i < N; ++i)
    r[i] = Trans ? at(8 * i + 2 * t, g) | at(8 * i + 2 * t + 1, g) << 16
                 : at(8 * i + g, 2 * t) | at(8 * i + g, 2 * t + 1) << 16;
}
inline void cp_async_16(void* shared, const void* global) {
  emu_aligned(shared);
  emu_aligned(global);
  std::memcpy(shared, global, 16);
  ++emu_cp_async_calls;
}
inline void cp_async_4(void* shared, const void* global, int bytes) {
  if (reinterpret_cast<std::uintptr_t>(shared) % 4 != 0 ||
      reinterpret_cast<std::uintptr_t>(global) % 4 != 0 || bytes < 1 || bytes > 4)
    std::abort();
  std::memset(shared, 0, 4);
  std::memcpy(shared, global, bytes);
  ++emu_cp_async_calls;
}
inline void cp_async_commit() {}
template <int N> void cp_async_wait() {}
}  // namespace
"""


def _emulate(source):
    """A CUDA source's text made C++ for the emulation header."""
    source = source.replace("extern __shared__ float smem[];",
                            "float* smem = emu::dynamic_smem;")
    return re.sub(r"(\w+(?:<\w+>)?)<<<([^>]*)>>>\(", r"emu::launch(emu::Cfg{\2}, \1, ", source)


def _build(out, name, signatures, rewrite=lambda text: text, source=None):
    """``csrc/<name>.cu`` (or the text ``source``) built with g++ under the
    emulation header into ``out``, loaded with ctypes and ``signatures``
    declared; ``rewrite`` edits the text of the source and of each header
    first (a planted fault)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernel source")
    (out / "cuda_runtime.h").write_text(EMULATION_HEADER)
    (out / "cuda_bf16.h").write_text(BF16_EMULATION_HEADER)
    for header in CSRC.glob("*.cuh"):
        (out / header.name).write_text(MMA_EMULATION_HEADER if header.name == "mma_sm90.cuh"
                                       else _emulate(rewrite(header.read_text())))
    if source is None:
        source = (CSRC / f"{name}.cu").read_text()
    (out / f"{name}.cpp").write_text(_emulate(rewrite(source)))
    so = out / f"{name}.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-w",
                    f"-I{out}", "-o", str(so), str(out / f"{name}.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``tarmac_step_bwd.cu`` built with g++ under the emulation header."""
    return _build(tmp_path_factory.mktemp("emulated"), "tarmac_step_bwd",
                  step_kernels._BWD_SIGNATURES)


@pytest.fixture(scope="module")
def emulated_fwd(tmp_path_factory):
    """``tarmac_step.cu`` built with g++ under the emulation header."""
    return _build(tmp_path_factory.mktemp("emulated_fwd"), "tarmac_step",
                  step_kernels._SIGNATURES)


def _case(rng, w, a, hidden, msg, key, n_act, empty_world):
    """Random inputs; world 0's agent 1 hears no one, and with ``empty_world``
    world 1 has no edge at all."""
    adjf = (rng.random((w * a, a)) > 0.4).astype(np.float32)
    adjf[np.arange(w * a), np.arange(w * a) % a] = 1.0
    adjf[0:a, 1] = 0.0
    if empty_world:
        adjf[a:2 * a] = 0.0
    lin = lambda i, o: rng.normal(size=(i, o)) / np.sqrt(i)
    vec = lambda o: 0.1 * rng.normal(size=o)
    case = dict(x=np.maximum(rng.normal(size=(w * a, hidden)), 0.0),
                h=np.tanh(rng.normal(size=(w * a, hidden))), adjf=adjf,
                wv=lin(2 * hidden, msg), bv=vec(msg), ws=lin(2 * hidden, key), bs=vec(key),
                wq=lin(2 * hidden, key), bq=vec(key), wi=lin(hidden + msg, 3 * hidden),
                wh=lin(hidden, 3 * hidden), bi=vec(3 * hidden), bh=vec(3 * hidden),
                wo=lin(hidden, n_act), bo=vec(n_act), wvh=lin(hidden, 1), bvh=vec(1),
                gq=rng.normal(size=(w * a, n_act)), gh2=rng.normal(size=(w * a, hidden)))
    return [torch.from_numpy(np.ascontiguousarray(case[k], np.float32)) for k in ORDER]


def _run(lib, args, w, a, key_size, dueling):
    """The emulated call; outputs and scratch start as NaN, so a value the
    kernel fails to write shows."""
    x, h = args[0], args[1]
    hidden, msg, key, n_act = x.shape[1], args[3].shape[1], args[5].shape[1], args[13].shape[1]
    outs = [torch.full_like(t, float("nan")) for t in (x, h, *args[3:17])]
    scratch = torch.full((max(1, step_kernels.bwd_scratch_floats(w * a, hidden, msg, key,
                                                                 n_act)),), float("nan"))
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in [*args, *outs, scratch]]
    assert lib.tarmac_step_backward(*ptrs, w, a, hidden, msg, key, n_act, int(dueling),
                                    float(key_size), None) == 0
    return outs


@pytest.mark.parametrize("w,a,hidden,msg,key,n_act,dueling,empty_world", [
    (5, 4, 32, 8, 4, 5, False, False),       # R = 20: one ragged row tile
    (3, 8, 40, 12, 6, 9, True, False),       # widths that are no multiple of a tile or slab
    (9, 8, 32, 64, 16, 9, False, True),      # R = 72 over three row tiles; a world with no edge
    (2, 3, 70, 20, 5, 3, True, True),        # A = 3
    (1, 4, 256, 64, 16, 9, False, False),    # W = 1, R = 4 (below a row tile), full width
])
def test_emulated_kernel_matches_plain(emulated, w, a, hidden, msg, key, n_act, dueling,
                                       empty_world):
    args = _case(np.random.default_rng(w * a + hidden), w, a, hidden, msg, key, n_act,
                 empty_world)
    got = _run(emulated, args, w, a, 4.0, dueling)
    want = step_kernels.tarmac_step_bwd_plain(*args, a, 4.0, dueling)
    for i, (g, r) in enumerate(zip(got, want)):
        err = (g - r).abs().max().item() / max(1.0, r.abs().max().item())
        assert err <= 1e-5, f"output {i}: {err:.3e}"


def test_emulated_kernel_with_no_rows_gives_zero_weight_gradients(emulated):
    args = _case(np.random.default_rng(0), 0, 4, 32, 8, 4, 5, False)
    got = _run(emulated, args, 0, 4, 4.0, True)
    assert all(torch.equal(g, torch.zeros_like(g)) for g in got[2:])


def _run_fwd(lib, args, w, a, key_size, dueling):
    """The emulated forward; q, h2 and the scratch start as NaN."""
    x, hidden = args[0], args[0].shape[1]
    msg, key, n_act = args[3].shape[1], args[5].shape[1], args[13].shape[1]
    q = torch.full((w * a, n_act), float("nan"))
    h2 = torch.full_like(x, float("nan"))
    scratch = torch.full((max(1, step_kernels.fwd_scratch_floats(w * a, hidden, msg, key)),),
                         float("nan"))
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in [*args, q, h2, scratch]]
    assert lib.tarmac_step_forward(*ptrs, w, a, hidden, msg, key, n_act, int(dueling),
                                   float(key_size), None) == 0
    return q, h2


@pytest.mark.parametrize("w,a,hidden,msg,key,n_act,dueling,empty_world", [
    (5, 4, 32, 8, 4, 5, False, False),       # R = 20: one ragged row tile
    (3, 8, 40, 12, 6, 9, True, False),       # widths that are no multiple of a tile or slab
    (9, 8, 32, 64, 16, 9, False, True),      # R = 72 over three row tiles; a world with no edge
    (7, 4, 70, 20, 5, 3, True, True),        # A = 4, R = 28; H = 70 splits the head unevenly
    (2, 3, 70, 20, 5, 3, False, True),       # A = 3: the last head block holds 2 rows
    (1, 4, 256, 64, 16, 9, False, False),    # the classic host loop's 4-UBS step: W = 1, R = 4
])
def test_emulated_forward_matches_plain(emulated_fwd, w, a, hidden, msg, key, n_act, dueling,
                                        empty_world):
    """World 0's agent 1 hears no one (c = 0 there); with ``empty_world``
    world 1 has no edge at all."""
    args = _case(np.random.default_rng(w * a + hidden + 1), w, a, hidden, msg, key, n_act,
                 empty_world)[:17]
    got = _run_fwd(emulated_fwd, args, w, a, 4.0, dueling)
    want = step_kernels.tarmac_step_plain(*args, a, 4.0, dueling)
    for name, g, r in zip(("q", "h2"), got, want):
        err = (g - r).abs().max().item() / max(1.0, r.abs().max().item())
        assert err <= 1e-5, f"{name}: {err:.3e}"


def test_emulated_forward_with_no_rows_returns_success(emulated_fwd):
    """W = 0 launches nothing (a grid of no blocks is a launch error on the card)."""
    args = _case(np.random.default_rng(0), 0, 4, 32, 8, 4, 5, False)[:17]
    _run_fwd(emulated_fwd, args, 0, 4, 4.0, True)
