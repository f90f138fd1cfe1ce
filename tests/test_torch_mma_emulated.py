"""The tensor-core instructions of ``csrc/mma_sm90.cuh`` as the CPU emulation
runs them, and the bf16 step kernels at widths whose rows take ``cp.async``.

``test_torch_step_bwd_emulated.py``'s emulation swaps ``mma_sm90.cuh`` for
stand-ins (``MMA_EMULATION_HEADER``) that give each lane of a warp its
fragment in the PTX ISA's layout. Here a harness runs them in one emulated
warp and holds them against numpy: ``ldmatrix`` x1, x2 and x4, with and
without ``.trans``, against the layout written out in numpy; the m16n8k16
bf16 product on random bf16 values, its fragments built by hand and through
``ldmatrix`` from A stored [m][k] or [k][m] and B stored [k][n] or [n][k] (as
the product kernel stores its slabs), against ``C + A @ B`` in float64
(within 1e-5 of max(1, max |D|): a bf16 product is exact in f32, sixteen of
them summed in f32). Then the bf16 step forward and backward at W = 4, A = 8,
hidden 64, msg 16, key 8, 9 actions with dueling, where every row of a call
tensor is 16-byte aligned, so the products' bf16 operands arrive by
``cp.async``, and at W = 40 (R = 320), whose weight gradients are summed in
two row chunks; each held by ``test_torch_bf16_emulated.py``'s step check.
Without g++ they skip.
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_bf16_emulated import build_step_libs, check_step_case, _step_calls
from test_torch_step_bwd_emulated import _build, _case as step_case
from uav_bs_ctrl_tpu_torch.ops import step_kernels

_P = ctypes.c_void_p
HARNESS = r"""
#include <cuda_runtime.h>
#include "mma_sm90.cuh"

namespace {

unsigned pair(const unsigned short* p, int i0, int i1) {
  return unsigned(p[i0]) | unsigned(p[i1]) << 16;
}

// Lane l addresses row l of m [32][8]; every variant's registers into out[variant][l][4].
__global__ void ldmatrix_all(const unsigned short* m, unsigned* out) {
  const int l = threadIdx.x;
  const unsigned short* row = m + 8 * l;
  unsigned r1[1], r2[2], r4[4];
  unsigned* o = out + 4 * l;
  ldmatrix<1, false>(r1, row); o[0] = r1[0];
  o += 128; ldmatrix<1, true>(r1, row); o[0] = r1[0];
  o += 128; ldmatrix<2, false>(r2, row); o[0] = r2[0]; o[1] = r2[1];
  o += 128; ldmatrix<2, true>(r2, row); o[0] = r2[0]; o[1] = r2[1];
  o += 128; ldmatrix<4, false>(r4, row); for (int i = 0; i < 4; ++i) o[i] = r4[i];
  o += 128; ldmatrix<4, true>(r4, row); for (int i = 0; i < 4; ++i) o[i] = r4[i];
}

// D = C + A B for row-major A [16][16], B [16][8], C and D [16][8]; with `via` the
// fragments come through ldmatrix from a_src (A [m][k], or A^T [k][m] with a_t) and
// b_src (B [k][n], or B^T [n][k] with b_t), else straight from A and B.
__global__ void mma_one(const unsigned short* A, const unsigned short* B, const float* C,
                        float* D, int via, const unsigned short* a_src, int a_t,
                        const unsigned short* b_src, int b_t) {
  const int l = threadIdx.x, g = l / 4, t = l % 4, mat = l / 8, r = l % 8;
  unsigned a[4], b[2];
  if (!via) {
    a[0] = pair(A, g * 16 + 2 * t, g * 16 + 2 * t + 1);
    a[1] = pair(A, (g + 8) * 16 + 2 * t, (g + 8) * 16 + 2 * t + 1);
    a[2] = pair(A, g * 16 + 2 * t + 8, g * 16 + 2 * t + 9);
    a[3] = pair(A, (g + 8) * 16 + 2 * t + 8, (g + 8) * 16 + 2 * t + 9);
    b[0] = pair(B, 2 * t * 8 + g, (2 * t + 1) * 8 + g);
    b[1] = pair(B, (2 * t + 8) * 8 + g, (2 * t + 9) * 8 + g);
  } else {
    if (a_t) ldmatrix<4, true>(a, a_src + (r + 8 * (mat / 2)) * 16 + 8 * (mat % 2));
    else ldmatrix<4, false>(a, a_src + (l % 16) * 16 + 8 * (l / 16));
    if (b_t) ldmatrix<2, false>(b, b_src + (l % 8) * 16 + 8 * ((l / 8) % 2));
    else ldmatrix<2, true>(b, b_src + (l % 16) * 8);
  }
  float d[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1], C[(g + 8) * 8 + 2 * t],
                C[(g + 8) * 8 + 2 * t + 1]};
  mma_bf16_16816(d, a, b);
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2];
  D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

}  // namespace

extern "C" int ldmatrix_test(const unsigned short* m, unsigned* out) {
  ldmatrix_all<<<1, 32, 0, nullptr>>>(m, out);
  return 0;
}

extern "C" int mma_test(const unsigned short* A, const unsigned short* B, const float* C,
                        float* D, int via, const unsigned short* a_src, int a_t,
                        const unsigned short* b_src, int b_t) {
  mma_one<<<1, 32, 0, nullptr>>>(A, B, C, D, via, a_src, a_t, b_src, b_t);
  return 0;
}
"""
SIGNATURES = {"ldmatrix_test": (ctypes.c_int, [_P, _P]),
              "mma_test": (ctypes.c_int, [_P, _P, _P, _P, ctypes.c_int, _P, ctypes.c_int, _P,
                                          ctypes.c_int])}


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("mma"), "mma_harness", SIGNATURES, source=HARNESS)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _bf16_bits(values):
    """bf16 bit patterns (as int16) of float values, and the values they hold."""
    t = torch.from_numpy(np.ascontiguousarray(values, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).contiguous(), t.double().numpy()


def test_ldmatrix_stand_ins_follow_the_ptx_layout(harness):
    """Register i of lane l: row l/4, columns 2(l%4) and 2(l%4)+1 of matrix
    i (rows 8i..8i+7, one a lane), or with .trans rows 2(l%4), 2(l%4)+1 of
    column l/4; x1 and x2 read the first 8 and 16 lanes' rows."""
    rng = np.random.default_rng(0)
    m = rng.integers(0, 1 << 16, size=(32, 8)).astype(np.uint16)
    out = torch.zeros((6, 32, 4), dtype=torch.int32)
    assert harness.ldmatrix_test(_ptr(torch.from_numpy(m.view(np.int16))), _ptr(out)) == 0
    got = out.numpy().view(np.uint32)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for v, (n, trans) in enumerate([(1, False), (1, True), (2, False), (2, True),
                                    (4, False), (4, True)]):
        want = np.zeros((32, 4), np.uint32)
        for i in range(n):
            mat = m[8 * i:8 * i + 8].astype(np.uint32)
            lo, hi = (mat[2 * t, g], mat[2 * t + 1, g]) if trans else \
                (mat[g, 2 * t], mat[g, 2 * t + 1])
            want[:, i] = lo | hi << 16
        np.testing.assert_array_equal(got[v], want, err_msg=f"x{n} trans={trans}")


@pytest.mark.parametrize("via,a_t,b_t", [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 0, 1), (1, 1, 1)])
def test_mma_stand_in_is_the_bf16_product(harness, via, a_t, b_t):
    rng = np.random.default_rng(1 + 4 * via + 2 * a_t + b_t)
    a_bits, a = _bf16_bits(rng.normal(size=(16, 16)))
    b_bits, b = _bf16_bits(rng.normal(size=(16, 8)))
    c = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    d = torch.full((16, 8), float("nan"))
    a_src = (a_bits.T if a_t else a_bits).contiguous()
    b_src = (b_bits.T if b_t else b_bits).contiguous()
    assert harness.mma_test(_ptr(a_bits), _ptr(b_bits), _ptr(c), _ptr(d), via, _ptr(a_src),
                            a_t, _ptr(b_src), b_t) == 0
    want = c.double().numpy() + a @ b
    err = np.abs(d.double().numpy() - want).max() / max(1.0, np.abs(want).max())
    assert err <= 1e-5, f"{err:.3e}"


@pytest.fixture(scope="module")
def step_libs(tmp_path_factory):
    return build_step_libs(tmp_path_factory)


@pytest.mark.parametrize("w,a,hidden,msg,key,n_act,dueling,empty_world", [
    (4, 8, 64, 16, 8, 9, True, False),       # every width a multiple of 8: cp.async rows
    (40, 8, 64, 16, 8, 9, False, True),      # R = 320: weight gradients in two row chunks
])
def test_emulated_bf16_step_kernels_on_aligned_rows(step_libs, w, a, hidden, msg, key, n_act,
                                                    dueling, empty_world):
    check_step_case(step_libs, w, a, hidden, msg, key, n_act, dueling, empty_world)


def test_emulated_bf16_backward_with_no_rows_gives_zero_weight_gradients(step_libs):
    args = [t.to(torch.bfloat16) for t in step_case(np.random.default_rng(0), 0, 8, 64, 16, 8,
                                                     9, False)]
    _, outs = _step_calls(step_libs, args[:17], args[17], args[18], 0, 8, 8, True,
                          torch.bfloat16)
    assert all(torch.equal(g, torch.zeros_like(g)) for g in outs[2:])
    assert step_kernels.split_chunks(0) == 1
