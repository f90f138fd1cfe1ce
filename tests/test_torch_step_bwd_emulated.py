"""``csrc/tarmac_step_bwd.cu`` and ``csrc/tarmac_step.cu`` run on the CPU, through an
emulation of their CUDA threads, against ``tarmac_step_bwd_plain`` and ``tarmac_step_plain``.

Without nvcc a CUDA source cannot be compiled here. These tests compile it
with g++ as C++ instead, under a small header that emulates the pieces the
source uses: each CTA's threads run as ``std::thread``s that meet at a
``std::barrier`` for ``__syncthreads``; the 32 lanes of each warp meet at a
``std::barrier`` of their own for ``__shfl_xor_sync``, ``__ballot_sync`` and
``__syncwarp`` (which a kernel calls only where its warp is converged);
CTAs run one after another (so a ``__shared__`` array is a function-level
static); and a launch ``k<<<g, b, smem, s>>>(...)`` (or ``k<Tag><<<...>>>``)
becomes a call of the emulated launcher. Every ``csrc/*.cuh`` header is put
through the same substitutions and written beside the source, with a
``cuda_bf16.h`` whose 16-bit type rounds as the card's does
(``BF16_EMULATION_HEADER``; ``test_torch_bf16_emulated.py`` runs the bf16
instantiations). The tests call
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
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
struct emu_dim3 { unsigned x = 0, y = 0, z = 0; };
using std::min;
namespace emu {
inline thread_local emu_dim3 thread_idx, block_idx, block_dim, grid_dim;
inline thread_local std::barrier<>* block_barrier = nullptr;
inline thread_local float* dynamic_smem = nullptr;
struct Warp {                      // a warp's lanes meet here for a shuffle or a ballot
  explicit Warp(std::ptrdiff_t lanes) : barrier(lanes) {}
  std::barrier<> barrier;
  unsigned long long slot[32];
};
inline thread_local Warp* warp = nullptr;
inline thread_local int lane = 0;
template <class T>
T exchange(T v, int src) {         // every lane posts v, then reads lane src's
  std::memcpy(&warp->slot[lane], &v, sizeof(T));
  warp->barrier.arrive_and_wait();
  T r;
  std::memcpy(&r, &warp->slot[src], sizeof(T));
  warp->barrier.arrive_and_wait();
  return r;
}
struct Cfg { unsigned grid; int block; size_t smem; cudaStream_t stream; };
template <class F, class... Args>
void launch(Cfg c, F kernel, Args... args) {
  for (unsigned b = 0; b < c.grid; ++b) {
    std::vector<float> smem(c.smem / sizeof(float) + 1);
    std::barrier<> barrier(c.block);
    std::vector<std::unique_ptr<Warp>> warps;
    for (int w = 0; 32 * w < c.block; ++w)
      warps.push_back(std::make_unique<Warp>(std::min(32, c.block - 32 * w)));
    std::vector<std::thread> threads;
    for (int t = 0; t < c.block; ++t)
      threads.emplace_back([&, t] {
        thread_idx.x = t; block_idx.x = b; block_dim.x = c.block; grid_dim.x = c.grid;
        block_barrier = &barrier; dynamic_smem = smem.data();
        warp = warps[t / 32].get(); lane = t % 32;
        kernel(args...);
        barrier.arrive_and_drop();
        warp->barrier.arrive_and_drop();
      });
    for (auto& t : threads) t.join();
  }
}
}  // namespace emu
template <class T>
T __shfl_xor_sync(unsigned, T v, int off) { return emu::exchange(v, emu::lane ^ off); }
inline unsigned __ballot_sync(unsigned, int pred) {
  emu::warp->slot[emu::lane] = pred != 0;
  emu::warp->barrier.arrive_and_wait();
  unsigned bits = 0;
  for (int l = 0; l < 32; ++l)
    if (emu::warp->slot[l]) bits |= 1u << l;
  emu::warp->barrier.arrive_and_wait();
  return bits;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp->barrier.arrive_and_wait(); }
#define threadIdx emu::thread_idx
#define blockIdx emu::block_idx
#define blockDim emu::block_dim
#define gridDim emu::grid_dim
#define __syncthreads() emu::block_barrier->arrive_and_wait()
#define __global__
#define __device__
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


def _emulate(source):
    """A CUDA source's text made C++ for the emulation header."""
    source = source.replace("extern __shared__ float smem[];",
                            "float* smem = emu::dynamic_smem;")
    return re.sub(r"(\w+(?:<\w+>)?)<<<([^>]*)>>>\(", r"emu::launch(emu::Cfg{\2}, \1, ", source)


def _build(out, name, signatures):
    """``csrc/<name>.cu`` built with g++ under the emulation header into
    ``out``, loaded with ctypes and ``signatures`` declared."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernel source")
    (out / "cuda_runtime.h").write_text(EMULATION_HEADER)
    (out / "cuda_bf16.h").write_text(BF16_EMULATION_HEADER)
    for header in CSRC.glob("*.cuh"):
        (out / header.name).write_text(_emulate(header.read_text()))
    (out / f"{name}.cpp").write_text(_emulate((CSRC / f"{name}.cu").read_text()))
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
