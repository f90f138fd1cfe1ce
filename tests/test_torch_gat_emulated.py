"""``csrc/flash_gat.cu`` (#1), ``csrc/flash_gat_fused.cu`` (#2) and
``csrc/flash_gat_fused_bwd.cu`` (#3) run on the CPU, through the thread emulation of
``test_torch_step_bwd_emulated.py`` (each warp's lanes meet at a barrier of their own for
the shuffles and ballots), against ``flash_gat_plain``, ``flash_gat_fused_plain`` and
``flash_gat_fused_bwd_plain``.

#2 and #3: the cases cover ragged row counts, no slot, one and two mask words (M = 7, 33,
50), a row of more than 256 slots (the forward's two sweeps), D = 1 to 8 (the kernels pad
to 2, 4 or 8 features), 1 to 32 columns a lane (F = 32 to 1024), H = 1 to 10 (CTAs of one
warp a head, up to 320 threads), more rows than the backward's grid (a CTA takes several
and its partial row sums them), a fully masked row and a fully valid one, and
``need_dx``. #1: the 4-UBS serving shapes ('seen' M = 50, 'near' M = 3), a mask word of
one slot, two list chunks (M = 300), no slot, F = 8 and 96 (lanes beyond F guarded),
F = 1024 (32 columns a lane), H = 32 (1024 threads) and scores at 50x (the online
rescale), each with a fully masked row and a fully valid one. Without g++ they skip.
Tolerance: 1e-5 of max(1, max |plain|) per output (f32 sums in another order, small
widths); the fully masked row's out, m, l, der and dx must be exact.
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_step_bwd_emulated import _build
from uav_bs_ctrl_tpu_torch.ops import gat_kernels
from uav_bs_ctrl_tpu_torch.ops.masked import NEG_BIG

SLOPE = 0.2
CASES = [  # n, m, d, heads, f
    (5, 50, 4, 4, 64),        # the update's 'seen' shape, two mask words, ragged N
    (9, 7, 2, 4, 64),         # 'near'
    (5, 33, 4, 2, 128),       # the 2x128 width (4 columns a lane); a mask word of one slot
    (9, 50, 2, 2, 128),
    (3, 300, 3, 4, 64),       # more than 256 slots: staged in two chunks; D = 3 pads to 4
    (4, 20, 1, 2, 256),       # F = 256: 8 columns a lane; D = 1 pads to 2
    (4, 20, 8, 3, 32),        # H = 3, F = 32: one column a lane; D = 8
    (2, 20, 4, 1, 1024),      # F = 1024: 32 columns a lane, one warp a CTA
    (3, 33, 2, 9, 32),        # H = 9: CTAs of 288 threads
    (3, 20, 3, 10, 96),       # H = 10, F = 96: 3 columns a lane
    (1030, 7, 2, 1, 64),      # more rows than the backward's 1024 CTAs: a CTA takes two
    (3, 0, 2, 4, 64),         # no slot at all
]


@pytest.fixture(scope="module")
def fwd_lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("gat_fwd"), "flash_gat_fused", gat_kernels._SIGNATURES)


@pytest.fixture(scope="module")
def bwd_lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("gat_bwd"), "flash_gat_fused_bwd",
                  gat_kernels._BWD_SIGNATURES)


def _case(n, m, d, heads, f):
    """Random inputs; row 0 has every slot valid, row 1 none, the rest about half."""
    rng = np.random.default_rng(n * m + d + heads)
    hf = heads * f
    mask = rng.random((n, m)) > 0.5
    mask[0], mask[1] = True, False
    case = dict(x=rng.normal(size=(n, m, d)), w=rng.normal(size=(d, hf)) / np.sqrt(d),
                b=0.3 * rng.normal(size=hf), er=rng.normal(size=(n, hf)),
                attn=rng.normal(size=(heads, f)) / np.sqrt(f), mask=mask,
                g=rng.normal(size=(n, hf)))
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in case.items()}


def _ptrs(*tensors):
    return [ctypes.c_void_p(t.data_ptr()) if t is not None else None for t in tensors]


def _args(c):
    return [c[k] for k in ("x", "w", "b", "er", "attn", "mask")]


def _rel_err(got, want):
    assert got.shape == want.shape
    if want.numel() == 0:
        return 0.0
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def _forward(lib, c, heads):
    """The emulated forward; its outputs start as NaN, so a value it fails to write shows."""
    n, m, d = c["x"].shape
    hf = c["w"].shape[1]
    out = torch.full((n, hf), float("nan"))
    mstat = torch.full((n, heads), float("nan"))
    lstat = torch.full((n, heads), float("nan"))
    assert lib.flash_gat_fused_forward(*_ptrs(*_args(c), out, mstat, lstat), n, m, d, hf,
                                       heads, SLOPE, None) == 0
    return out, mstat, lstat


@pytest.mark.parametrize("n,m,d,heads,f", CASES)
def test_emulated_forward_matches_plain(fwd_lib, n, m, d, heads, f):
    c = _case(n, m, d, heads, f)
    out, mstat, lstat = _forward(fwd_lib, c, heads)
    want = gat_kernels.flash_gat_fused_plain(*_args(c), heads, SLOPE)
    rows = c["mask"].sum(1) > 0
    for name, got, ref in (("out", out, want[0]), ("m", mstat[rows], want[1][rows]),
                           ("l", lstat, want[2])):
        assert _rel_err(got, ref) <= 1e-5, f"{name}: {_rel_err(got, ref):.3e}"
    empty = ~rows
    assert torch.all(out[empty] == 0) and torch.all(mstat[empty] == NEG_BIG)
    assert torch.all(lstat[empty] == 0)


def _backward(lib, c, heads, need_dx):
    """The emulated backward from the plain forward's statistics; its outputs and the
    partial buffer start as NaN."""
    n, m, d = c["x"].shape
    hf = c["w"].shape[1]
    args = _args(c)
    out, mstat, lstat = gat_kernels.flash_gat_fused_plain(*args, heads, SLOPE)
    dw, db = torch.full((d, hf), float("nan")), torch.full((hf,), float("nan"))
    der, dattn = torch.full((n, hf), float("nan")), torch.full((heads, hf // heads), float("nan"))
    dx = torch.full((n, m, d), float("nan")) if need_dx else None
    partial = torch.full((max(n, 1), (d + 2) * hf), float("nan"))
    assert lib.flash_gat_fused_backward(
        *_ptrs(*args, c["g"], out, mstat, lstat, dw, db, der, dattn, dx, partial),
        n, m, d, hf, heads, SLOPE, None) == 0
    want = gat_kernels.flash_gat_fused_bwd_plain(*args, out, mstat, lstat, c["g"], heads, SLOPE,
                                                 need_dx)
    return (dx, dw, db, der, dattn), want


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("n,m,d,heads,f", CASES)
def test_emulated_backward_matches_plain(bwd_lib, n, m, d, heads, f, need_dx):
    got, want = _backward(bwd_lib, _case(n, m, d, heads, f), heads, need_dx)
    for name, g, r in zip(("dx", "dw", "db", "der", "dattn"), got, want):
        if r is None:
            assert g is None
            continue
        assert _rel_err(g, r) <= 1e-5, f"{name}: {_rel_err(g, r):.3e}"
    assert torch.all(got[3][1] == 0)                       # der of the fully masked row
    if need_dx:
        assert torch.all(got[0][1] == 0)
        assert torch.all(got[0][_case(n, m, d, heads, f)["mask"] == 0] == 0)   # masked slots


def test_emulated_backward_with_no_rows_gives_zero_weight_gradients(bwd_lib):
    c = _case(4, 7, 2, 4, 64)
    c = {k: v[:0] if k in ("x", "er", "mask", "g") else v for k, v in c.items()}
    got, want = _backward(bwd_lib, c, 4, False)
    for g in got[1:]:
        assert torch.equal(g, torch.zeros_like(g))


FLASH_CASES = [  # n, m, heads, f, scale
    (5, 50, 4, 64, 1.0),      # 4-UBS 'seen': the served shape, two mask words
    (5, 3, 4, 64, 1.0),       # 'near'
    (4, 33, 4, 64, 1.0),      # a mask word of one slot
    (3, 300, 2, 64, 1.0),     # two list chunks
    (3, 0, 4, 64, 1.0),       # no slot
    (4, 20, 4, 8, 1.0),       # F = 8: 24 guarded lanes a warp
    (4, 40, 2, 96, 1.0),      # F = 96: 3 columns a lane, one guarded
    (3, 20, 1, 1024, 1.0),    # F = 1024: 32 columns a lane
    (3, 20, 32, 32, 1.0),     # H = 32: CTAs of 1024 threads
    (4, 50, 4, 64, 50.0),     # el and er at 50x: scores in the hundreds, the online rescale
]


@pytest.fixture(scope="module")
def flash_lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("flash_gat"), "flash_gat",
                  gat_kernels._FLASH_SIGNATURES)


def _flash_case(n, m, heads, f, scale):
    """Random (el, er, attn, mask); row 0 has every slot valid, row 1 none, the rest about
    half."""
    rng = np.random.default_rng(n * m + heads * f)
    hf = heads * f
    mask = rng.random((n, m)) > 0.5
    mask[0], mask[1] = True, False
    arrays = (scale * rng.normal(size=(n, m, hf)), scale * rng.normal(size=(n, hf)),
              rng.normal(size=(heads, f)) / np.sqrt(f), mask)
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in arrays]


@pytest.mark.parametrize("n,m,heads,f,scale", FLASH_CASES)
def test_emulated_flash_gat_matches_plain(flash_lib, n, m, heads, f, scale):
    el, er, attn, mask = _flash_case(n, m, heads, f, scale)
    out = torch.full((n, heads * f), float("nan"))      # a value left unwritten shows
    assert flash_lib.flash_gat_forward(*_ptrs(el, er, attn, mask, out), n, m, heads * f,
                                       heads, SLOPE, None) == 0
    want = gat_kernels.flash_gat_plain(el, er, attn, mask, heads, SLOPE)
    assert _rel_err(out, want) <= 1e-5, f"out: {_rel_err(out, want):.3e}"
    assert torch.all(out[mask.sum(1) == 0] == 0)
