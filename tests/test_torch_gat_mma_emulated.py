"""#2 and #3 as slot tiles on the tensor cores (``csrc/flash_gat_tile.cuh``,
``csrc/flash_gat_fused.cu``, ``csrc/flash_gat_fused_bwd.cu``), on the CPU through the
thread emulation of ``test_torch_step_bwd_emulated.py``, whose ``mma_sm90.cuh`` stand-ins
give each lane its fragment in the PTX ISA's layout and sum as the tensor cores do.

First the new stand-in, ``mma_tf32_1684`` (m16n8k4 tf32, the projection's product at
D <= 4), bit for bit numpy's model of the tensor cores' sums and within 1e-6 of float64.
Then both kernels against their plain versions, within 1e-5 of max(1, max |plain|) per
output (``test_torch_gat_emulated.py``'s limit), on masks whose rows have exactly the
valid counts that a tile design must get right: 0 (the all-masked rule: out, m, l, der
and dx exact), 1, 7, 8 and 9 (one tile, full, and the first slot of a second), 16, 17
and 50 (every slot of 'seen'), and M = 300 (two staged units: the online softmax and
der's sums across them); D = 1 to 8 (the depth-4 and depth-8 products), heads of 32 and
64 columns, H = 1 to 8 (CTAs of 4 warps at most 170 registers, and of up to 8). 'near'
(M = 7) runs the warp-per-(row, head) body the library routes it to. The emulated card
has two SMs of one CTA each, so a CTA walks many rows (its partial row sums them) and
tiles end at every row's end. The backward runs with and without ``dx``. The bf16
instantiations are held bit for bit to the f32 ones on the same inputs widened, and
within 2e-2 of the f64 referee.

Two planted faults must fail the 1e-5 check: the projection's products of a small tf32
part taken out (one tf32 pass at f32) and the backward's indicator product without the
small part of x d_s. The routing rule the library exports and ``chip_smoke.hmma_counts``
on the tile kernels' names close the file. Without g++ they skip.
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_gat_emulated import _ptrs, _rel_err
from test_torch_step_bwd_emulated import CSRC, _build
from test_torch_tf32_emulated import _hmma_block, _tf32
from uav_bs_ctrl_tpu_torch.ops import gat_kernels
from uav_bs_ctrl_tpu_torch.ops.masked import NEG_BIG

SLOPE = 0.2
TOL = 1e-5               # of max(1, max |plain|), per output
BF16_TOL = 2e-2          # of max(1, max |f64 referee|)
CASES = {  # name: (m, d, heads, f, valid slots of each row)
    "seen": (50, 4, 4, 64, [50, 0, 1, 16, 17, 7, 8, 9, 33, 25]),
    "near": (7, 2, 4, 64, [7, 0, 1, 5, 6, 7, 2]),
    "d1_f32": (20, 1, 2, 32, [20, 3, 0, 9, 16]),
    "d5": (20, 5, 2, 64, [17, 0, 8, 20, 1]),
    "d8": (20, 8, 2, 64, [20, 9, 0, 16, 5]),
    "h8_f32": (20, 3, 8, 32, [1, 17, 0, 20, 8]),
    "m300": (300, 6, 1, 64, [300, 0, 257, 1, 17, 40]),
}
PROJ_SMALL = ("    mma_tf32<KD>(e, ws, xs);\n    mma_tf32<KD>(e, ws, xb);\n"
              "    mma_tf32<KD>(e, wa, xs);\n")
IP_SMALL = "        mma_tf32_1688(st, ind, ysm);\n"
_P, _I = ctypes.c_void_p, ctypes.c_int
HARNESS = r"""
#include <cuda_runtime.h>
#include "mma_sm90.cuh"

namespace {

// D = C + A B for row-major A [16][4], B [4][8], C and D [16][8] of tf32 values, one
// m16n8k4 product, the fragments built from the PTX ISA's layout.
__global__ void product_k4(const unsigned* A, const unsigned* B, const float* C, float* D) {
  const int l = threadIdx.x, g = l / 4, t = l % 4;
  float d[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1], C[(g + 8) * 8 + 2 * t],
                C[(g + 8) * 8 + 2 * t + 1]};
  const unsigned a[2] = {A[g * 4 + t], A[(g + 8) * 4 + t]};
  const unsigned b[1] = {B[t * 8 + g]};
  mma_tf32_1684(d, a, b);
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2];
  D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

}  // namespace

extern "C" int product_k4_test(const unsigned* A, const unsigned* B, const float* C, float* D) {
  product_k4<<<1, 32, 0, nullptr>>>(A, B, C, D);
  return 0;
}
"""


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return (_build(tmp_path_factory.mktemp("tiles_fwd"), "flash_gat_fused",
                   gat_kernels._SIGNATURES),
            _build(tmp_path_factory.mktemp("tiles_bwd"), "flash_gat_fused_bwd",
                   gat_kernels._BWD_SIGNATURES))


@pytest.fixture(scope="module")
def one_pass_fwd(tmp_path_factory):
    """The forward with the projection's two products of a small part taken out."""
    assert PROJ_SMALL in (CSRC / "flash_gat_tile.cuh").read_text()
    return _build(tmp_path_factory.mktemp("one_pass"), "flash_gat_fused",
                  gat_kernels._SIGNATURES, lambda text: text.replace(PROJ_SMALL, ""))


@pytest.fixture(scope="module")
def no_small_ip_bwd(tmp_path_factory):
    """The backward with the indicator product's pass on the small part of x d_s
    taken out."""
    assert IP_SMALL in (CSRC / "flash_gat_fused_bwd.cu").read_text()
    return _build(tmp_path_factory.mktemp("no_small_ip"), "flash_gat_fused_bwd",
                  gat_kernels._BWD_SIGNATURES, lambda text: text.replace(IP_SMALL, ""))


def _case(name, dtype=torch.float32):
    """Random inputs of case ``name``; row r has exactly its listed count of valid
    slots, at random positions."""
    m, d, heads, f, counts = CASES[name]
    rng = np.random.default_rng(len(name) * 1000 + m + d)
    n, hf = len(counts), heads * f
    mask = np.zeros((n, m))
    for r, k in enumerate(counts):
        mask[r, rng.permutation(m)[:k]] = 1.0
    case = dict(x=rng.normal(size=(n, m, d)), w=rng.normal(size=(d, hf)) / np.sqrt(d),
                b=0.3 * rng.normal(size=hf), er=rng.normal(size=(n, hf)),
                attn=rng.normal(size=(heads, f)) / np.sqrt(f), mask=mask,
                g=rng.normal(size=(n, hf)))
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dtype)
            for k, v in case.items()}, heads


def _args(c):
    return [c[k] for k in ("x", "w", "b", "er", "attn", "mask")]


def _suffix(dtype):
    return "_bf16" if dtype == torch.bfloat16 else ""


def _forward(lib, c, heads):
    """The emulated forward in the inputs' dtype; outputs start as NaN."""
    n, m, d = c["x"].shape
    hf = c["w"].shape[1]
    dtype = c["x"].dtype
    out = torch.full((n, hf), float("nan"), dtype=dtype)
    mstat = torch.full((n, heads), float("nan"))
    lstat = torch.full((n, heads), float("nan"))
    assert getattr(lib, "flash_gat_fused_forward" + _suffix(dtype))(
        *_ptrs(*_args(c), out, mstat, lstat), n, m, d, hf, heads, SLOPE, None) == 0
    return out, mstat, lstat


def _backward(lib, c, heads, out, mstat, lstat, need_dx):
    """The emulated backward from the given statistics; outputs and partials start as NaN."""
    n, m, d = c["x"].shape
    hf = c["w"].shape[1]
    dtype = c["x"].dtype
    nan = lambda *shape: torch.full(shape, float("nan"), dtype=dtype)
    dw, db, der, dattn = nan(d, hf), nan(hf), nan(n, hf), nan(heads, hf // heads)
    dx = nan(n, m, d) if need_dx else None
    partial = torch.full((max(min(n, gat_kernels.MAX_CTAS), 1), (d + 2) * hf), float("nan"))
    assert getattr(lib, "flash_gat_fused_backward" + _suffix(dtype))(
        *_ptrs(*_args(c), c["g"], out, mstat, lstat, dw, db, der, dattn, dx, partial),
        n, m, d, hf, heads, SLOPE, None) == 0
    return dx, dw, db, der, dattn


def _forward_errs(lib, name):
    c, heads = _case(name)
    got = _forward(lib, c, heads)
    want = gat_kernels.flash_gat_fused_plain(*_args(c), heads, SLOPE)
    rows = c["mask"].sum(1) > 0
    errs = {"out": _rel_err(got[0], want[0]), "m": _rel_err(got[1][rows], want[1][rows]),
            "l": _rel_err(got[2], want[2])}
    return errs, got, c, heads


def _backward_errs(lib, name, need_dx):
    c, heads = _case(name)
    out, mstat, lstat = gat_kernels.flash_gat_fused_plain(*_args(c), heads, SLOPE)
    got = _backward(lib, c, heads, out, mstat, lstat, need_dx)
    want = gat_kernels.flash_gat_fused_bwd_plain(*_args(c), out, mstat, lstat, c["g"], heads,
                                                 SLOPE, need_dx)
    errs = {k: _rel_err(g, r) for k, g, r in zip(("dx", "dw", "db", "der", "dattn"), got, want)
            if r is not None}
    return errs, got, c


def test_tf32_k4_stand_in_is_the_product(tmp_path_factory):
    """One m16n8k4 product on tf32 values: bit for bit numpy's model of the
    tensor cores' sums (one block of 4 products with C), within 1e-6 of float64."""
    lib = _build(tmp_path_factory.mktemp("k4"), "k4_harness",
                 {"product_k4_test": (_I, [_P] * 4)}, source=HARNESS)
    rng = np.random.default_rng(4)
    a, b = _tf32(rng.normal(size=(16, 4))), _tf32(rng.normal(size=(4, 8)))
    c = rng.normal(size=(16, 8)).astype(np.float32)
    ta, tb = (torch.from_numpy(np.ascontiguousarray(v).view(np.int32)) for v in (a, b))
    tc, d = torch.from_numpy(c), torch.full((16, 8), float("nan"))
    assert lib.product_k4_test(*_ptrs(ta, tb, tc, d)) == 0
    want = np.array([[_hmma_block(c[i, j], [float(a[i, k]) * float(b[k, j]) for k in range(4)])
                      for j in range(8)] for i in range(16)], np.float32)
    np.testing.assert_array_equal(d.numpy(), want)
    exact = c.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(d.double().numpy() - exact).max() / max(1.0, np.abs(exact).max()) <= 1e-6


@pytest.mark.parametrize("name", CASES)
def test_tile_forward_matches_plain(libs, name):
    errs, got, c, heads = _forward_errs(libs[0], name)
    assert max(errs.values()) <= TOL, errs
    empty = c["mask"].sum(1) == 0
    assert torch.all(got[0][empty] == 0) and torch.all(got[1][empty] == NEG_BIG)
    assert torch.all(got[2][empty] == 0)


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_tile_backward_matches_plain(libs, name, need_dx):
    errs, got, c = _backward_errs(libs[1], name, need_dx)
    assert max(errs.values()) <= TOL, errs
    empty = c["mask"].sum(1) == 0
    assert torch.all(got[3][empty] == 0)                  # der of the all-masked rows
    if need_dx:
        assert torch.all(got[0][c["mask"] == 0] == 0)     # masked slots, all-masked rows too


@pytest.mark.parametrize("name", ["seen", "near", "d5", "h8_f32"])
def test_tile_bf16_is_the_f32_call_rounded(libs, name):
    """The bf16 call is the f32 call on the widened inputs, rounded; each output
    within 2e-2 of the f64 referee."""
    fwd, bwd = libs
    c16, heads = _case(name, torch.bfloat16)
    c32 = {k: v.float() for k, v in c16.items()}
    got16, got32 = _forward(fwd, c16, heads), _forward(fwd, c32, heads)
    assert torch.equal(got16[0], got32[0].to(torch.bfloat16))
    assert torch.equal(got16[1], got32[1]) and torch.equal(got16[2], got32[2])
    g16 = _backward(bwd, c16, heads, *got16, True)
    g32 = _backward(bwd, c32, heads, got16[0].float(), *got16[1:], True)
    for a, b in zip(g16, g32):
        assert torch.equal(a, b.to(torch.bfloat16))
    c64 = {k: v.double() for k, v in c32.items()}
    ref = gat_kernels.flash_gat_fused_plain(*_args(c64), heads, SLOPE)
    ref_g = gat_kernels.flash_gat_fused_bwd_plain(*_args(c64), *ref, c64["g"], heads, SLOPE,
                                                  True)
    for got, want in zip((got16[0], *g16), (ref[0], *ref_g)):
        assert _rel_err(got.double(), want) <= BF16_TOL


def test_planted_one_pass_projection_fails(one_pass_fwd):
    """One tf32 pass (about 11 bits of x and W) misses the 1e-5 limit."""
    errs, *_ = _forward_errs(one_pass_fwd, "seen")
    assert errs["out"] > TOL, errs


def test_planted_indicator_product_without_its_small_part_fails(no_small_ip_bwd):
    """x d_s as one tf32 pass in the indicator product misses the 1e-5 limit in dW."""
    errs, *_ = _backward_errs(no_small_ip_bwd, "seen", False)
    assert errs["dw"] > TOL, errs


def test_rows_of_more_than_two_tiles_take_the_tiles(libs):
    """The library's routing rule, which ``chip_smoke.py`` reports: rows of more than
    two tiles' worth of slots ('seen', M = 50; exp1's M = 20) of at most 8 heads of 32
    or 64 columns take the slot tiles; shorter rows ('near', M = 7; exp1's M = 10),
    wider heads and more heads the warp-per-(row, head) body."""
    uses = libs[0].flash_gat_fused_uses_tiles
    assert [m for m in range(0, 80) if uses(m, 256, 4)] == list(range(17, 80))
    assert uses(50, 64, 2) and uses(50, 256, 8) and uses(20, 128, 2)
    assert not uses(50, 256, 2) and not uses(50, 288, 9) and not uses(50, 1024, 1)


def test_hmma_counts_takes_the_slot_tile_kernels(tmp_path):
    """``chip_smoke.hmma_counts`` counts #2/#3's slot-tile kernels of each type, and
    leaves out the warp-per-(row, head) body and the partials' sum."""
    import chip_smoke
    from test_torch_chip_tools import _fake_cuobjdump
    ns = "_ZN55_GLOBAL__N__f2fddc64_22_flash_gat_fused_bwd_cu_a52eb3a8"
    f32 = ns + "25flash_gat_fused_bwd_tilesIfLi4ELi4ELb1ELb0ELi128EEEvPKT_"
    bf16 = ns + "25flash_gat_fused_bwd_tilesI13__nv_bfloat16Li4ELi4ELb1ELb0ELi128EEEvPKT_"
    rows = ns + "24flash_gat_fused_bwd_rowsIfLi2ELi4ELi256EEEvPKT_"
    reduce = ns + "26flash_gat_fused_bwd_reduceIfEEvPKfPT_S4_S4_iii"
    cuda_bin = _fake_cuobjdump(tmp_path, {f32: 16, bf16: 8, rows: 0, reduce: 0})
    counts = chip_smoke.hmma_counts({"flash_gat_fused_bwd": tmp_path / "lib.so"}, cuda_bin)
    assert counts == {"flash_gat_fused_bwd": {"f32": [1, 16, 0], "bf16": [1, 8, 0]}}
