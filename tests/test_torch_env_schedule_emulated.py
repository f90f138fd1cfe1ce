"""``csrc/env_schedule.cu`` run on the CPU, through the thread emulation of
``test_torch_step_bwd_emulated.py``, against ``torch_env._schedule_body_scatter``.

The kernel is one warp a world; the emulation runs its 32 lanes as fibers that
meet at a barrier for each shuffle and ``__syncwarp``, so the order of a
world's steps, its argmins' tie breaks and its shared-memory state are those
of the source. g++ has no ``__fmul_rn``/``__fadd_rn``/``__fdiv_rn``: a prelude
gives them as the plain f32 operations (x86-64 SSE rounds each to nearest, and
g++ does not contract them into FMAs without an FMA target). The cases are
``env_schedule_cases.py``'s (exp3 8-UBS, exp2, DenseHotSpotV2, a cut-down
swarm, each with the edge cases of world 0 and a last world of no
interference), staged in shared memory, and swarm64 (64, 800, 10) at one
world, read from device memory. The rule is ``env_kernels.compare_schedules``:
the same serving UBS and RB for every GT, rates within 1e-6 of the world's
largest rate, any parting shown to be an interference tie. Planted faults (the
last index on a tie, an interference sum over the idle UBSs, the serving UBS
counted as interference) must fail it. Without g++ the tests skip.
"""

import ctypes

import numpy as np
import pytest
import torch

from env_schedule_cases import SHAPES, WORLDS, edge_outcomes, make_case, params_of
from test_torch_step_bwd_emulated import _build
from uav_bs_ctrl_tpu_torch.envs import torch_env
from uav_bs_ctrl_tpu_torch.ops import env_kernels

PRELUDE = r"""
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
"""
SOURCE = (env_kernels.build.CSRC / "env_schedule.cu").read_text()
FAULTS = {
    "last index on a tie": ("(ov == v && oi < idx)", "(ov == v && oi > idx)"),
    "interference over the idle UBSs": ("if ((occ[j] >> lane) & 1u) itf",
                                        "if (!((occ[j] >> lane) & 1u)) itf"),
    "the serving UBS counted as interference": ("if (j != i && ((occ[j] >> c) & 1u))",
                                                "if (((occ[j] >> c) & 1u))"),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("env_schedule"), "env_schedule",
                  env_kernels._SIGNATURES, source=PRELUDE + SOURCE)


def _run(lib, params, case, with_assign=True):
    """The emulated launch on CPU tensors; outputs start as NaN (and -7), so
    an entry the kernel does not write shows."""
    d, g, prior = (torch.from_numpy(np.ascontiguousarray(case[k])) for k in ("d", "gain", "prior"))
    n_w, N, M = d.shape
    rate_gt = torch.full((n_w, M), float("nan"))
    rate_ubs = torch.full((n_w, N), float("nan"))
    assign = torch.full((n_w, M), -7, dtype=torch.int32)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (d, g, prior, rate_gt, rate_ubs)]
    err = lib.env_schedule_forward(*ptrs, ctypes.c_void_p(assign.data_ptr()) if with_assign
                                   else None, n_w, N, M, params.n_rbs, params.r_cov,
                                   params.p_tx, params.noise, params.bw,
                                   env_kernels.RATE_SCALE, None)
    assert err == 0
    return assign, rate_gt, rate_ubs


def _check(lib, params, case):
    """The emulated kernel against the scatter body: ``compare_schedules``' result."""
    got = _run(lib, params, case)
    sched, rate_gt, rate_ubs = torch_env._schedule_body_scatter(
        params, *(torch.from_numpy(case[k]) for k in ("d", "gain", "prior")))
    want = (env_kernels.schedule_assignment(sched), rate_gt, rate_ubs)
    res = env_kernels.compare_schedules(params, case["d"], case["gain"], case["prior"], got, want)
    return res, got, want


def _cases():
    for name in SHAPES:
        params = params_of(torch_env, name)
        yield name, params, make_case(params, WORLDS[name], seed=len(name) + 10)


@pytest.mark.parametrize("name", list(SHAPES))
def test_emulated_kernel_matches_scatter_body(lib, name):
    params = params_of(torch_env, name)
    case = make_case(params, WORLDS[name], seed=len(name) + 10)
    assert lib.env_schedule_staged(params.n_ubs, params.n_gts) == 1
    res, got, want = _check(lib, params, case)
    assert not res["faults"], res["faults"]
    assert res["err"] <= env_kernels.RATE_RTOL, res["err"]
    assert torch.equal(got[0], want[0])                       # no tie in these cases
    outcomes = edge_outcomes(params, case, got[0])
    assert all(outcomes.values()), outcomes


def test_emulated_swarm64_reads_device_memory(lib):
    """swarm64, (64, 800, 10) at one world: 410 KB of d and powers, past the
    48 KB the kernel stages, so it reads them from device memory."""
    params = torch_env.make_params("swarm64")
    case = make_case(params, 1, seed=64)
    assert lib.env_schedule_staged(params.n_ubs, params.n_gts) == 0
    assert lib.env_schedule_staged(32, 400) == 0 and lib.env_schedule_staged(16, 200) == 1
    res, got, want = _check(lib, params, case)
    assert not res["faults"] and res["err"] <= env_kernels.RATE_RTOL, res
    assert torch.equal(got[0], want[0])
    assert (got[0] >= 0).sum() > params.n_ubs                 # UBSs serve several GTs


def test_emulated_kernel_repeats_bit_for_bit_and_skips_the_assignment(lib):
    params = params_of(torch_env, "8ubs")
    case = make_case(params, 4, seed=1)
    first, second = _run(lib, params, case), _run(lib, params, case, with_assign=False)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    assert (second[0] == -7).all()                            # no assignment pointer: unwritten


def test_emulated_kernel_takes_no_world_and_refuses_sizes_it_does_not_take(lib):
    params = params_of(torch_env, "8ubs")
    case = make_case(params, 1, seed=2)
    case = {k: v[:0] for k, v in case.items()}
    assert _run(lib, params, case)[1].numel() == 0
    call = lambda N, M, R: lib.env_schedule_forward(None, None, None, None, None, None, 1, N,
                                                    M, R, 100.0, 0.01, 1e-15, 1.8e5, 1e-6,
                                                    None)
    assert call(65, 50, 5) != 0 and call(8, 2049, 5) != 0 and call(8, 50, 33) != 0
    assert call(8, 50, 0) != 0 and call(0, 50, 5) != 0


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_the_rule(tmp_path, fault):
    old, new = FAULTS[fault]
    assert SOURCE.count(old) == 1
    bad = _build(tmp_path, "env_schedule", env_kernels._SIGNATURES,
                 source=PRELUDE + SOURCE.replace(old, new))
    caught = []
    for name, params, case in _cases():
        res, _, _ = _check(bad, params, case)
        caught.append(bool(res["faults"]) or res["err"] > env_kernels.RATE_RTOL)
    assert any(caught), fault
