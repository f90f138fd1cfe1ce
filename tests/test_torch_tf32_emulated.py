"""The f32 step products on the tensor cores (3xTF32) as the CPU emulation runs
them.

``test_torch_step_bwd_emulated.py``'s emulation swaps ``csrc/mma_sm90.cuh`` for
stand-ins (``MMA_EMULATION_HEADER``) that give each lane of a warp its fragment
in the PTX ISA's layout. Here a harness runs them in one emulated warp and holds
them against numpy: ``to_tf32`` rounds to nearest with ties away from zero and
clears the low 13 bits; one m16n8k8 TF32 product on tf32 values, its fragments
built by hand, is numpy's model of the tensor cores' sums bit for bit (each
block of 4 exact products and the running sum aligned to the largest exponent
and cut to 24 bits, then cut to f32) and ``C + A @ B`` in float64 within 1e-6
of max(1, max |D|); 1 plus products of 3/4 of its ulp stays 1. Then
``csrc/tarmac_step_common.cuh``'s own ``split_tf32`` and ``mma_3xtf32`` on
random f32 values, a 32-deep product as a slab is (four 8-deep steps), within
1e-6 of float64; with its two products of a small part taken out (a single
tf32 pass, a planted fault) the same check must fail. ``mma_slab32`` on a
32 x 64 tile of 768-deep products (the depth of the backward's ``dgi wi^T``)
of values in [0, 1), where every cut falls the same way, stays within 2e-6 of
float64; summing each step into the running sums (a planted fault) must not.
Last, the f32 step
forward and backward at W = 4, A = 8, hidden 64, msg 16, key 8, 9 actions with
dueling, where every row of a call tensor and of the scratch is 16-byte aligned,
so the products' operands arrive by ``cp.async`` (the stand-in counts the
copies), and at W = 40 (R = 320), whose weight gradients are summed in two row
chunks, each against its plain version within 1e-5 of max(1, max |plain|)
per output, as in ``test_torch_step_bwd_emulated.py``. Without g++ they skip.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from test_torch_step_bwd_emulated import CSRC, _build, _case, _run, _run_fwd
from uav_bs_ctrl_tpu_torch.ops import step_kernels

_P, _I = ctypes.c_void_p, ctypes.c_int
SPLIT_TOL = 1e-6          # 3xTF32 against float64, of max(1, max |D|)
SMALL_PRODUCTS = ("  mma_tf32_1688(d, a_small, b_big);\n"
                  "  mma_tf32_1688(d, a_big, b_small);\n")
HARNESS = r"""
#include <cuda_runtime.h>
#include "tarmac_step_common.cuh"

namespace {

__global__ void round_all(const float* v, unsigned* out, int n) {
  for (int i = threadIdx.x; i < n; i += 32) out[i] = to_tf32(v[i]);
}

// D = C + A B for row-major A [16][K], B [K][8], C and D [16][8], K a multiple of 8, one
// 8-deep step at a time: with `split` each value split by split_tf32 and each step summed
// by mma_3xtf32, else A's and B's bits handed to mma_tf32_1688 as they are.
__global__ void product(const float* A, const float* B, const float* C, float* D, int K,
                        int split) {
  const int l = threadIdx.x, g = l / 4, t = l % 4;
  float d[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1], C[(g + 8) * 8 + 2 * t],
                C[(g + 8) * 8 + 2 * t + 1]};
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float a[4] = {A[g * K + k0 + t], A[(g + 8) * K + k0 + t], A[g * K + k0 + t + 4],
                        A[(g + 8) * K + k0 + t + 4]};
    const float b[2] = {B[(k0 + t) * 8 + g], B[(k0 + t + 4) * 8 + g]};
    if (split) {
      unsigned a_big[4], a_small[4], b_big[2], b_small[2];
      for (int f = 0; f < 4; ++f) split_tf32(a[f], a_big[f], a_small[f]);
      for (int f = 0; f < 2; ++f) split_tf32(b[f], b_big[f], b_small[f]);
      mma_3xtf32(d, a_big, a_small, b_big, b_small);
    } else {
      const unsigned ab[4] = {float_bits(a[0]), float_bits(a[1]), float_bits(a[2]),
                              float_bits(a[3])};
      const unsigned bb[2] = {float_bits(b[0]), float_bits(b[1])};
      mma_tf32_1688(d, ab, bb);
    }
  }
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2];
  D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

// D = A B for row-major A [kBM][K], B [K][kBN], K a multiple of kBK: one CTA's tile, each
// 32-deep slab through the ring's first stage and mma_slab32, as a step product runs it.
__global__ void slab_product(const float* A, const float* B, float* D, int K) {
  __shared__ TfShared sh;
  float acc[kMI][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kProdThreads)
      sh.a[0][(i / kBK) * kLdA32<false> + i % kBK] = A[(i / kBK) * K + k0 + i % kBK];
    for (int i = threadIdx.x; i < kBK * kBN; i += kProdThreads)
      sh.b[0][(i / kBN) * kLdB32<false> + i % kBN] = B[(k0 + i / kBN) * kBN + i % kBN];
    __syncthreads();
    mma_slab32<false, false>(sh, 0, acc);
    __syncthreads();
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 16 * kMI, wn = (warp % 2) * 32;
  for (int mi = 0; mi < kMI; ++mi)
    for (int j = 0; j < 4; ++j)
      for (int f = 0; f < 4; ++f)           // d[f]: row g (+8 from f = 2), col 2t (+1 f odd)
        D[(wm + 16 * mi + g + 8 * (f / 2)) * kBN + wn + 8 * j + 2 * t + f % 2] = acc[mi][j][f];
}

}  // namespace

extern "C" int tile_shape(int* out) {
  out[0] = kBM;
  out[1] = kBN;
  return 0;
}

extern "C" int slab_test(const float* A, const float* B, float* D, int K) {
  slab_product<<<1, kProdThreads, 0, nullptr>>>(A, B, D, K);
  return 0;
}

extern "C" int round_test(const float* v, unsigned* out, int n) {
  round_all<<<1, 32, 0, nullptr>>>(v, out, n);
  return 0;
}

extern "C" int product_test(const float* A, const float* B, const float* C, float* D, int K,
                            int split) {
  product<<<1, 32, 0, nullptr>>>(A, B, C, D, K, split);
  return 0;
}
"""
SIGNATURES = {"round_test": (_I, [_P, _P, _I]),
              "product_test": (_I, [_P, _P, _P, _P, _I, _I]),
              "tile_shape": (_I, [_P]),
              "slab_test": (_I, [_P, _P, _P, _I])}
LONG_K = 768              # (e)'s depth: dgi [R, 3 hidden] wi^T at hidden 256
LONG_K_TOL = 2e-6         # a long-k tile against float64, of max(1, max |D|)
STEP_SUM = ("        float step[4] = {0.f, 0.f, 0.f, 0.f};\n"
            "        mma_3xtf32(step, a_big[mi], a_small[mi], b_big, b_small);\n"
            "#pragma unroll\n"
            "        for (int f = 0; f < 4; ++f) acc[mi][j][f] += step[f];\n")
IN_PLACE = "        mma_3xtf32(acc[mi][j], a_big[mi], a_small[mi], b_big, b_small);\n"


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("tf32"), "tf32_harness", SIGNATURES, source=HARNESS)


@pytest.fixture(scope="module")
def harness_one_pass(tmp_path_factory):
    """The harness with ``mma_3xtf32``'s two products of a small part taken out."""
    def drop(text):
        return text.replace(SMALL_PRODUCTS, "")
    return _build(tmp_path_factory.mktemp("tf32_one_pass"), "tf32_harness", SIGNATURES,
                  rewrite=drop, source=HARNESS)


@pytest.fixture(scope="module")
def harness_in_place(tmp_path_factory):
    """The harness with ``mma_slab32`` summing each step's three products into the
    running sums themselves, not into a zeroed sum of the step."""
    def in_place(text):
        return text.replace(STEP_SUM, IN_PLACE)
    return _build(tmp_path_factory.mktemp("tf32_in_place"), "tf32_harness", SIGNATURES,
                  rewrite=in_place, source=HARNESS)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _tf32(values):
    """float32 values rounded to tf32 as numpy: to nearest, ties away from zero."""
    bits = np.ascontiguousarray(values, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _product(lib, a, b, c, split):
    """The harness's D for float32 A [16, K], B [K, 8], C [16, 8]."""
    a, b, c = (torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in (a, b, c))
    d = torch.full((16, 8), float("nan"))
    assert lib.product_test(_ptr(a), _ptr(b), _ptr(c), _ptr(d), a.shape[1], int(split)) == 0
    return d.double().numpy()


def _hmma_block(c, p):
    """The emulated tensor cores' sum of float32 ``c`` and 4 exact products ``p``
    (floats): aligned to the largest exponent, cut to 24 bits below it, added,
    cut to float32."""
    terms = [float(c)] + [float(v) for v in p]
    tops = [math.frexp(v)[1] for v in terms if v != 0.0]
    if not tops:
        return np.float32(0.0)
    quantum = math.ldexp(1.0, max(tops) - 24)
    total = sum(math.trunc(v / quantum) * quantum for v in terms)
    f = np.float32(total)
    if abs(float(f)) > abs(total):
        f = np.nextafter(f, np.float32(0.0))
    return f


def _hmma(a, b, c):
    """numpy's m16n8k8 TF32 product on tf32 values, summed as the stand-in sums."""
    d = c.astype(np.float32).copy()
    for m in range(16):
        for n in range(8):
            for k0 in (0, 4):
                d[m, n] = _hmma_block(d[m, n], [float(a[m, k]) * float(b[k, n])
                                                for k in range(k0, k0 + 4)])
    return d


def _slab_err(lib, seed):
    """A kBM x kBN tile of LONG_K deep products of values in [0, 1) through
    ``mma_slab32`` against float64: every sum the same sign, so every cut the same way."""
    shape = torch.zeros(2, dtype=torch.int32)
    assert lib.tile_shape(_ptr(shape)) == 0
    bm, bn = shape.tolist()
    rng = np.random.default_rng(seed)
    a = rng.random((bm, LONG_K)).astype(np.float32)
    b = rng.random((LONG_K, bn)).astype(np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    d = torch.full((bm, bn), float("nan"))
    assert lib.slab_test(_ptr(at), _ptr(bt), _ptr(d), LONG_K) == 0
    want = a.astype(np.float64) @ b.astype(np.float64)
    return np.abs(d.double().numpy() - want).max() / max(1.0, np.abs(want).max())


def _split_err(lib, seed):
    rng = np.random.default_rng(seed)
    a, b, c = rng.normal(size=(16, 32)), rng.normal(size=(32, 8)), rng.normal(size=(16, 8))
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    want = c.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)
    return np.abs(_product(lib, a, b, c, True) - want).max() / max(1.0, np.abs(want).max())


def test_to_tf32_stand_in_rounds_to_nearest_ties_away(harness):
    """Random values, values that lie exactly half way between two tf32 values
    (either sign), and values just below and above that half way."""
    rng = np.random.default_rng(0)
    base = _tf32(rng.normal(size=64)).view(np.uint32)
    ties = (base | np.uint32(0x1000)).view(np.float32)
    near = np.concatenate([(base | np.uint32(0x0fff)).view(np.float32),
                           (base | np.uint32(0x1001)).view(np.float32)])
    v = np.concatenate([rng.normal(size=64).astype(np.float32), ties, near, [0.0, -0.0]])
    v = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    out = torch.zeros(v.shape, dtype=torch.int32)
    assert harness.round_test(_ptr(v), _ptr(out), v.numel()) == 0
    got = out.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, _tf32(v.numpy()).view(np.uint32))
    assert (np.abs(got[64:128].view(np.float32)) > np.abs(ties)).all()   # ties away from 0


def test_tf32_mma_stand_in_is_the_product(harness):
    """Bit for bit numpy's model of the tensor cores' sums, and within 1e-6 of
    float64."""
    rng = np.random.default_rng(1)
    a, b = _tf32(rng.normal(size=(16, 8))), _tf32(rng.normal(size=(8, 8)))
    c = rng.normal(size=(16, 8)).astype(np.float32)
    got = _product(harness, a, b, c, False)
    np.testing.assert_array_equal(got.astype(np.float32), _hmma(a, b, c))
    want = c.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= SPLIT_TOL, f"{err:.3e}"


def test_tf32_mma_stand_in_truncates_as_it_aligns(harness):
    """1 plus four products of 3/4 of an ulp of 1: each is cut to nothing as it
    is aligned to 1, so D is 1, where a sum rounded to nearest gives 1 + 3 ulp."""
    a = np.zeros((16, 8), np.float32)
    a[:, :4] = 3 * 2.0 ** -13
    b = np.full((8, 8), 2.0 ** -12, np.float32)
    c = np.ones((16, 8), np.float32)
    got = _product(harness, a, b, c, False)
    assert (got == 1.0).all()
    assert np.float32(1.0 + 12 * 2.0 ** -25) == np.float32(1.0 + 3 * 2.0 ** -23)


@pytest.mark.parametrize("seed", [2, 3])
def test_3xtf32_split_keeps_f32_accuracy(harness, seed):
    err = _split_err(harness, seed)
    print(f"3xTF32 against float64: {err:.3e}")
    assert err <= SPLIT_TOL, f"{err:.3e}"


@pytest.mark.parametrize("seed", [2, 3])
def test_3xtf32_check_fails_on_one_tf32_pass(harness_one_pass, seed):
    """The planted fault: only big A big B, about three decimal digits."""
    assert SMALL_PRODUCTS in (CSRC / "tarmac_step_common.cuh").read_text()
    err = _split_err(harness_one_pass, seed)
    print(f"one tf32 pass against float64: {err:.3e}")
    assert err > SPLIT_TOL


@pytest.mark.parametrize("seed", [4, 5])
def test_long_k_slab_sums_each_step_apart(harness, seed):
    """``mma_slab32`` over (e)'s 768-deep walk stays at f32 accuracy: each step's
    cuts are bounded by that step's own sum."""
    err = _slab_err(harness, seed)
    print(f"mma_slab32, K = {LONG_K}, against float64: {err:.3e}")
    assert err <= LONG_K_TOL, f"{err:.3e}"


@pytest.mark.parametrize("seed", [4, 5])
def test_long_k_check_fails_when_summed_in_place(harness_in_place, seed):
    """The planted fault: each step summed into the running sums, whose every
    cut is an ulp of the whole walk's sum."""
    assert STEP_SUM in (CSRC / "tarmac_step_common.cuh").read_text()
    err = _slab_err(harness_in_place, seed)
    print(f"mma_slab32 summing in place, K = {LONG_K}, against float64: {err:.3e}")
    assert err > LONG_K_TOL


@pytest.fixture(scope="module")
def step_libs(tmp_path_factory):
    return (_build(tmp_path_factory.mktemp("tf32_fwd"), "tarmac_step", step_kernels._SIGNATURES),
            _build(tmp_path_factory.mktemp("tf32_bwd"), "tarmac_step_bwd",
                   step_kernels._BWD_SIGNATURES))


def _copies(lib):
    return ctypes.c_long.in_dll(lib, "emu_cp_async_calls").value


@pytest.mark.parametrize("w,a,hidden,msg,key,n_act,dueling,empty_world", [
    (4, 8, 64, 16, 8, 9, True, False),       # every width a multiple of 4: cp.async rows
    (40, 8, 64, 16, 8, 9, False, True),      # R = 320: weight gradients in two row chunks
])
def test_emulated_f32_step_kernels_on_aligned_rows(step_libs, w, a, hidden, msg, key, n_act,
                                                   dueling, empty_world):
    fwd, bwd = step_libs
    args = _case(np.random.default_rng(w * a + hidden), w, a, hidden, msg, key, n_act,
                 empty_world)
    assert all(t.data_ptr() % 16 == 0 for t in args)
    before = _copies(fwd), _copies(bwd)
    got = _run_fwd(fwd, args[:17], w, a, 4.0, dueling)
    want = step_kernels.tarmac_step_plain(*args[:17], a, 4.0, dueling)
    names = ["q", "h2"]
    pairs = list(zip(got, want))
    got = _run(bwd, args, w, a, 4.0, dueling)
    want = step_kernels.tarmac_step_bwd_plain(*args, a, 4.0, dueling)
    names += ["dx", "dh"] + [f"d{k}" for k in step_kernels._WEIGHTS]
    pairs += list(zip(got, want))
    assert _copies(fwd) > before[0] and _copies(bwd) > before[1], "no operand came by cp.async"
    for name, (g, r) in zip(names, pairs):
        err = (g - r).abs().max().item() / max(1.0, r.abs().max().item())
        assert err <= 1e-5, f"{name}: {err:.3e}"
    if w * a > step_kernels.SPLIT_ROWS:
        assert step_kernels.split_chunks(w * a) == 2
