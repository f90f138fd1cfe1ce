"""The column-split entry points of ``csrc/tarmac_step.cu`` (``tarmac_step_forward_cols``,
``tarmac_step_forward_head``) and ``csrc/tarmac_step_bwd.cu``
(``tarmac_step_backward_cols``, ``tarmac_step_backward_rest``), f32 and bf16, run on the
CPU through the thread emulation of ``test_torch_step_bwd_emulated.py``.

- Against the plain split versions of ``ops/step_kernels.py``: at f32 within
  1e-5 of max(1, max |plain|) per output, every rank of mp = 2 and 4 at
  hidden 32 and a slice whose columns start off a 16-byte boundary (hidden
  40, columns [10, 20)); at bf16 within 2e-2 of the plain split version run
  in float64 on the same bf16 inputs (the f64 referee of ``ROADMAP.md``
  "Numerics"). Each rank's backward reads its own copy of ``red`` summed
  over the ranks, as the all-reduce gives it.
- With ``lo = 0, hi = H`` the pairs give the whole-width entry points'
  (``tarmac_step_forward``, ``tarmac_step_backward``) outputs bit for bit,
  at both types.

Outputs and scratch start as NaN, so a value a kernel fails to write shows.
Without g++ the tests skip.
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_step_bwd_emulated import _build, _case
from uav_bs_ctrl_tpu_torch.ops import step_kernels

BF16_TOL = 2e-2
SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}
SHAPES = {"h32": (3, 4, 32, 8, 4, 5), "h40": (2, 4, 40, 12, 6, 9)}   # w, a, H, msg, key, n_act


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return (_build(tmp_path_factory.mktemp("split_fwd"), "tarmac_step",
                   step_kernels._LIB["tarmac_step"]),
            _build(tmp_path_factory.mktemp("split_bwd"), "tarmac_step_bwd",
                   step_kernels._LIB["tarmac_step_bwd"]))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _nan(shape, dtype=torch.float32):
    return torch.full(shape, float("nan"), dtype=dtype)


def _dims(args):
    return args[0].shape[1], args[3].shape[1], args[5].shape[1], args[13].shape[1]


def _fwd_cols(lib, args, w, a, cols):
    hidden, msg, key, _ = _dims(args)
    h2c = _nan((w * a, cols[1] - cols[0]))
    scratch = _nan((max(1, step_kernels.fwd_scratch_floats(w * a, cols[1] - cols[0], msg,
                                                            key)),))
    launch = getattr(lib, "tarmac_step_forward_cols" + SUFFIX[args[0].dtype])
    assert launch(*map(_p, args[:13]), _p(h2c), _p(scratch), w, a, hidden, msg, key, *cols,
                  4.0, None) == 0
    return h2c


def _head(lib, h2f, args, dueling):
    rows, hidden = h2f.shape
    dtype, n_act = args[0].dtype, args[13].shape[1]
    q, h2 = _nan((rows, n_act), dtype), _nan((rows, hidden), dtype)
    launch = getattr(lib, "tarmac_step_forward_head" + SUFFIX[dtype])
    assert launch(_p(h2f), *map(_p, args[13:17]), _p(q), _p(h2), rows, hidden, n_act,
                  int(dueling), None) == 0
    return q, h2


def _bwd_cols(lib, args, w, a, dueling, cols):
    hidden, msg, key, n_act = _dims(args)
    red = _nan((step_kernels.red_floats(w * a, hidden, msg),))
    scratch = _nan((max(1, step_kernels.bwd_cols_scratch_floats(w * a, hidden, msg, key, n_act,
                                                                 cols)),))
    operands = [t for i, t in enumerate(args) if i not in (14, 16)]     # no bo, bvh
    launch = getattr(lib, "tarmac_step_backward_cols" + SUFFIX[args[0].dtype])
    assert launch(*map(_p, operands), _p(red), _p(scratch), w, a, hidden, msg, key, n_act,
                  int(dueling), *cols, 4.0, None) == 0
    return red, scratch


def _bwd_rest(lib, args, red, scratch, w, a, cols):
    hidden, msg, key, n_act = _dims(args)
    dx, dh = _nan(args[0].shape, args[0].dtype), _nan(args[1].shape, args[1].dtype)
    grads = [torch.zeros_like(t) for t in args[3:17]]
    launch = getattr(lib, "tarmac_step_backward_rest" + SUFFIX[args[0].dtype])
    assert launch(*map(_p, (args[0], args[1], args[2], args[3], args[5], args[7])), _p(red),
                  _p(dx), _p(dh), *map(_p, grads), _p(scratch), w, a, hidden, msg, key, n_act,
                  *cols, 4.0, None) == 0
    return [dx, dh, *grads]


def _split(libs, args, w, a, dueling, cols):
    """Every rank's forward ``(q, h2)`` (h2's columns alone where ``cols``
    do not cover H) and backward outputs, the ranks' ``red`` summed as the
    all-reduce gives it to each."""
    fwd, bwd = libs
    h2f = torch.cat([_fwd_cols(fwd, args[:17], w, a, c) for c in cols], 1)
    out = _head(fwd, h2f, args[:17], dueling) if h2f.shape[1] == args[0].shape[1] else (h2f,)
    halves = [_bwd_cols(bwd, args, w, a, dueling, c) for c in cols]
    red = sum(r for r, _ in halves)
    return out, [_bwd_rest(bwd, args, red.clone(), s, w, a, c) for (_, s), c in zip(halves, cols)]


def _plain(args, w, a, dueling, cols):
    """The plain split versions, the same way round."""
    h2f = torch.cat([step_kernels.tarmac_step_cols_plain(*args[:13], a, 4.0, c) for c in cols], 1)
    out = (step_kernels.tarmac_step_head_plain(h2f, *args[13:17], dueling)
           if h2f.shape[1] == args[0].shape[1] else (h2f,))
    halves = [step_kernels.tarmac_step_bwd_cols_plain(*args, a, 4.0, dueling, c) for c in cols]
    red = sum(r for r, _ in halves)
    return out, [step_kernels.tarmac_step_bwd_rest_plain(*args[:17], red, s, a, 4.0, dueling, c)
                 for (_, s), c in zip(halves, cols)]


def _worst(got, want):
    return max((g.double() - r.double()).abs().max().item() / max(1.0, r.abs().max().item())
               for g, r in zip(got, want))


CASES = [("h32", 2, None, True), ("h32", 4, None, False), ("h40", 4, [(10, 20)], True)]


@pytest.mark.parametrize("shape,mp,cols,dueling", CASES)
def test_split_entry_points_match_plain_f32(libs, shape, mp, cols, dueling):
    w, a, hidden, msg, key, n_act = SHAPES[shape]
    args = _case(np.random.default_rng(mp + hidden), w, a, hidden, msg, key, n_act, True)
    cols = cols or [(r * hidden // mp, (r + 1) * hidden // mp) for r in range(mp)]
    out, ranks = _split(libs, args, w, a, dueling, cols)
    out_p, ranks_p = _plain(args, w, a, dueling, cols)
    assert _worst(out, out_p) <= 1e-5
    for r, (got, want) in enumerate(zip(ranks, ranks_p)):
        assert _worst(got, want) <= 1e-5, f"rank {r}"


@pytest.mark.parametrize("shape,mp,dueling", [("h32", 2, True), ("h32", 4, False)])
def test_split_entry_points_match_plain_bf16(libs, shape, mp, dueling):
    w, a, hidden, msg, key, n_act = SHAPES[shape]
    args = [t.to(torch.bfloat16) for t in _case(np.random.default_rng(7 + mp), w, a, hidden,
                                                  msg, key, n_act, True)]
    cols = [(r * hidden // mp, (r + 1) * hidden // mp) for r in range(mp)]
    (q, h2), ranks = _split(libs, args, w, a, dueling, cols)
    assert q.dtype == h2.dtype == ranks[0][0].dtype == torch.bfloat16
    (q_p, h2_p), ranks_p = _plain([t.double() for t in args], w, a, dueling, cols)
    assert _worst((q, h2), (q_p, h2_p)) <= BF16_TOL
    for r, (got, want) in enumerate(zip(ranks, ranks_p)):
        assert _worst(got, want) <= BF16_TOL, f"rank {r}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dueling", [False, True])
def test_whole_columns_are_the_whole_entry_points_bit_for_bit(libs, dtype, dueling):
    w, a, hidden, msg, key, n_act = SHAPES["h32"]
    args = [t.to(dtype) for t in _case(np.random.default_rng(3), w, a, hidden, msg, key,
                                       n_act, True)]
    fwd, bwd = libs
    (q, h2), (grads,) = _split(libs, args, w, a, dueling, [(0, hidden)])
    q0, h20 = _nan(q.shape, dtype), _nan(h2.shape, dtype)
    scratch = _nan((step_kernels.fwd_scratch_floats(w * a, hidden, msg, key),))
    launch = getattr(fwd, "tarmac_step_forward" + SUFFIX[dtype])
    assert launch(*map(_p, args[:17]), _p(q0), _p(h20), _p(scratch), w, a, hidden, msg, key,
                  n_act, int(dueling), 4.0, None) == 0
    whole = [_nan(t.shape, dtype) for t in (args[0], args[1], *args[3:17])]
    scratch = _nan((step_kernels.bwd_scratch_floats(w * a, hidden, msg, key, n_act,
                                                    dtype == torch.bfloat16),))
    launch = getattr(bwd, "tarmac_step_backward" + SUFFIX[dtype])
    assert launch(*map(_p, args), *map(_p, whole), _p(scratch), w, a, hidden, msg, key, n_act,
                  int(dueling), 4.0, None) == 0
    bits = lambda t: t.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    for name, got, want in zip(["q", "h2", "dx", "dh", *step_kernels._WEIGHTS],
                               [q, h2, *grads], [q0, h20, *whole]):
        assert torch.equal(bits(got), bits(want)), name
