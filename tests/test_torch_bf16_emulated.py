"""The bf16 instantiations of #2-#5 (``flash_gat_fused_forward_bf16``,
``flash_gat_fused_backward_bf16``, ``tarmac_step_forward_bf16``,
``tarmac_step_backward_bf16``) run on the CPU through the thread emulation
of ``test_torch_step_bwd_emulated.py``, whose ``cuda_bf16.h`` stores a
16-bit type and rounds to nearest even as the card does.

Each bf16 call is held, bit for bit, to its f32 instantiation on the same
inputs widened to f32 with the outputs rounded to bf16: the two differ only
in their loads and stores, so this pins the templating. Each is also held to
its plain version in float64 on the same bf16 inputs (the f64 referee of
``ROADMAP.md`` "Numerics"), within 2e-2 of max(1, max |referee|) per output,
and the plain bf16 version's error is printed beside it. The shapes are the
emulated tests' smallest: GATv2 'near' (N = 9, M = 7, D = 2, 4 x 64, a fully
masked row) and the classic host loop's 4-UBS 'seen' and 'near' rows, the
fused step at R = 20 (non-dueling) and R = 6 with A = 3 (dueling, a world
with no edge). Without g++ they skip.
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_gat_emulated import _case as gat_case
from test_torch_step_bwd_emulated import _build, _case as step_case
from uav_bs_ctrl_tpu_torch.ops import gat_kernels, step_kernels

BF16_TOL = 2e-2
SLOPE = 0.2


@pytest.fixture(scope="module")
def gat_libs(tmp_path_factory):
    return (_build(tmp_path_factory.mktemp("bf16_gat_fwd"), "flash_gat_fused",
                   gat_kernels._SIGNATURES),
            _build(tmp_path_factory.mktemp("bf16_gat_bwd"), "flash_gat_fused_bwd",
                   gat_kernels._BWD_SIGNATURES))


@pytest.fixture(scope="module")
def step_libs(tmp_path_factory):
    return (_build(tmp_path_factory.mktemp("bf16_step_fwd"), "tarmac_step",
                   step_kernels._SIGNATURES),
            _build(tmp_path_factory.mktemp("bf16_step_bwd"), "tarmac_step_bwd",
                   step_kernels._BWD_SIGNATURES))


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _nan(shape, dtype):
    return torch.full(shape, float("nan"), dtype=dtype)


def _err(got, ref):
    got, ref = got.double(), ref.double()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    return (got - ref).abs().max().item() / max(1.0, ref.abs().max().item())


def _check(name, got16, got32, plain16, ref):
    """Bit-identical to the f32 instantiation rounded, and within BF16_TOL of
    the referee; prints the plain bf16 version's error beside the kernel's."""
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, got32.to(torch.bfloat16)), f"{name}: not the rounded f32 call"
    err = _err(got16, ref)
    print(f"{name}: kernel {err:.2e}, plain bf16 {_err(plain16, ref):.2e}")
    assert err <= BF16_TOL, f"{name}: {err:.3e}"


def _gat_fwd(lib, c, heads, dtype):
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    x, w = c["x"], c["w"]
    n, m, d = x.shape
    hf = w.shape[1]
    out, ms, ls = _nan((n, hf), dtype), _nan((n, heads), torch.float32), \
        _nan((n, heads), torch.float32)
    assert getattr(lib, "flash_gat_fused_forward" + suffix)(
        *map(_ptr, (*(c[k] for k in ("x", "w", "b", "er", "attn", "mask")), out, ms, ls)),
        n, m, d, hf, heads, SLOPE, None) == 0
    return out, ms, ls


def _gat_bwd(lib, c, out, ms, ls, heads, dtype):
    """The emulated backward with dx; returns (dx, dw, db, der, dattn)."""
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    x, w, attn = c["x"], c["w"], c["attn"]
    n, m, d = x.shape
    hf = w.shape[1]
    dw, db, der, dattn, dx = (_nan((d, hf), dtype), _nan((hf,), dtype), _nan((n, hf), dtype),
                              _nan(attn.shape, dtype), _nan((n, m, d), dtype))
    partial = _nan((max(min(n, gat_kernels.MAX_CTAS), 1), (d + 2) * hf), torch.float32)
    assert getattr(lib, "flash_gat_fused_backward" + suffix)(
        *map(_ptr, (*(c[k] for k in ("x", "w", "b", "er", "attn", "mask", "g")), out, ms, ls,
                    dw, db, der, dattn, dx, partial)), n, m, d, hf, heads, SLOPE, None) == 0
    return dx, dw, db, der, dattn


@pytest.mark.parametrize("n,m,d,heads,f", [
    (9, 7, 2, 4, 64),         # 'near', a fully masked row
    (4, 50, 4, 4, 64),        # the classic host loop's 4-UBS step, 'seen'
    (4, 3, 2, 4, 64),         # and 'near' (K = 3)
])
def test_emulated_bf16_gat_kernels(gat_libs, n, m, d, heads, f):
    """#2 and #3 at bf16; the f32 backward takes the bf16 forward's out
    widened, and its row statistics, which are f32 in both."""
    fwd, bwd = gat_libs
    c16 = {k: v.to(torch.bfloat16) for k, v in gat_case(n, m, d, heads, f).items()}
    c32 = {k: v.float() for k, v in c16.items()}
    out16, ms16, ls16 = _gat_fwd(fwd, c16, heads, torch.bfloat16)
    out32, ms32, ls32 = _gat_fwd(fwd, c32, heads, torch.float32)
    assert torch.equal(ms16, ms32) and torch.equal(ls16, ls32)
    g16 = _gat_bwd(bwd, c16, out16, ms16, ls16, heads, torch.bfloat16)
    g32 = _gat_bwd(bwd, c32, out16.float(), ms16, ls16, heads, torch.float32)
    args = lambda c: [c[k] for k in ("x", "w", "b", "er", "attn", "mask")]
    c64 = {k: v.double() for k, v in c32.items()}
    ref = gat_kernels.flash_gat_fused_plain(*args(c64), heads)
    plain = gat_kernels.flash_gat_fused_plain(*args(c16), heads)
    _check("out", out16, out32, plain[0], ref[0])
    ref_g = gat_kernels.flash_gat_fused_bwd_plain(*args(c64), *ref, c64["g"], heads, SLOPE, True)
    plain_g = gat_kernels.flash_gat_fused_bwd_plain(*args(c16), *plain, c16["g"], heads, SLOPE,
                                                    True)
    for i, name in enumerate(("dx", "dw", "db", "der", "dattn")):
        _check(name, g16[i], g32[i], plain_g[i], ref_g[i])


def _step_calls(libs, args, gq, gh2, w, a, key, dueling, dtype):
    """The emulated forward and backward at ``dtype``."""
    fwd, bwd = libs
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    x = args[0]
    hidden, msg, ks, n_act = x.shape[1], args[3].shape[1], args[5].shape[1], args[13].shape[1]
    rows = w * a
    q, h2 = _nan((rows, n_act), dtype), _nan((rows, hidden), dtype)
    scratch = _nan((max(1, step_kernels.fwd_scratch_floats(rows, hidden, msg, ks)),),
                   torch.float32)
    assert getattr(fwd, "tarmac_step_forward" + suffix)(
        *map(_ptr, (*args, q, h2, scratch)), w, a, hidden, msg, ks, n_act, int(dueling),
        float(key), None) == 0
    outs = [_nan(t.shape, dtype) for t in (x, args[1], *args[3:17])]
    scratch = _nan((max(1, step_kernels.bwd_scratch_floats(
        rows, hidden, msg, ks, n_act, dtype == torch.bfloat16)),), torch.float32)
    assert getattr(bwd, "tarmac_step_backward" + suffix)(
        *map(_ptr, (*args, gq, gh2, *outs, scratch)), w, a, hidden, msg, ks, n_act,
        int(dueling), float(key), None) == 0
    return [q, h2], outs


@pytest.mark.parametrize("w,a,hidden,msg,key,n_act,dueling,empty_world", [
    (5, 4, 32, 8, 4, 5, False, False),       # R = 20: one ragged row tile
    (2, 3, 70, 20, 5, 3, True, True),        # A = 3, a world with no edge
])
def test_emulated_bf16_step_kernels(step_libs, w, a, hidden, msg, key, n_act, dueling,
                                    empty_world):
    t16 = [t.to(torch.bfloat16) for t in step_case(np.random.default_rng(w * a + hidden), w, a,
                                                    hidden, msg, key, n_act, empty_world)]
    t32 = [t.float() for t in t16]
    cfg = (a, float(key), dueling)
    got16 = _step_calls(step_libs, t16[:17], t16[17], t16[18], w, a, key, dueling,
                        torch.bfloat16)
    got32 = _step_calls(step_libs, t32[:17], t32[17], t32[18], w, a, key, dueling,
                        torch.float32)
    t64 = [t.double() for t in t32]
    refs = (step_kernels.tarmac_step_plain(*t64[:17], *cfg),
            step_kernels.tarmac_step_bwd_plain(*t64, *cfg))
    plains = (step_kernels.tarmac_step_plain(*t16[:17], *cfg),
              step_kernels.tarmac_step_bwd_plain(*t16, *cfg))
    names = (("q", "h2"), ["dx", "dh"] + [f"d{k}" for k in step_kernels._WEIGHTS])
    for part in range(2):
        for name, g16, g32, plain, ref in zip(names[part], got16[part], got32[part],
                                              plains[part], refs[part]):
            if not dueling and name in ("dwvh", "dbvh"):
                assert not g16.any()          # written as zeros without the V head
                continue
            _check(name, g16, g32, plain, ref)
