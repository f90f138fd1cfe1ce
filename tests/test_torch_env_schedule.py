"""The port's two scheduler bodies against ``uav_bs_ctrl_tpu.envs.jax_env``'s.

``torch_env._schedule_body_scatter`` and ``_schedule_body_onehot`` (every world
at once) against JAX's bodies of the same names (vmapped over the worlds) on
the same seeded positions, gains and priorities (``env_schedule_cases.py``):
exp3 8-UBS (8, 50, 5), exp2 (4, 4, 1), DenseHotSpotV2 (4, 100, 10) and a
cut-down swarm (16, 200, 10), at 2-8 worlds, with a GT that no UBS covers, a
UBS that runs out of RBs, two UBSs at exactly the same distance and a world
with no interference at all. The rule (``ops/env_kernels.compare_schedules``):
the same serving UBS and RB for every GT, and rates within 1e-6 of the
world's largest rate (the native core's 1e-6, ``native/env_core.cpp:7-8``,
taken relative to that rate); where the schedules part, the two RBs' exact
interference sums must tie within the roundoff of summing them in another
order. Also: ``_schedule`` on a CPU tensor runs the body ``SCHEDULE_IMPL``
names, and the kernel's wrapper runs the scatter body there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from env_schedule_cases import SHAPES, WORLDS, edge_outcomes, make_case, params_of
from uav_bs_ctrl_tpu.envs import jax_env
from uav_bs_ctrl_tpu_torch.envs import torch_env
from uav_bs_ctrl_tpu_torch.ops import env_kernels

BODIES = ("scatter", "onehot")


def _torch(case):
    return [torch.from_numpy(case[k]) for k in ("d", "gain", "prior")]


def _jax_schedule(name, body, case):
    jp = params_of(jax_env, name)
    fn = getattr(jax_env, f"_schedule_body_{body}")
    out = jax.jit(jax.vmap(lambda d, g, p: fn(jp, d, g, p)))(
        jnp.asarray(case["d"]), jnp.asarray(case["gain"]), jnp.asarray(case["prior"], jnp.int32))
    sched, rate_gt, rate_ubs = (torch.from_numpy(np.array(x)) for x in out)
    return env_kernels.schedule_assignment(sched), rate_gt, rate_ubs


def _port_schedule(params, body, case):
    sched, rate_gt, rate_ubs = getattr(torch_env, f"_schedule_body_{body}")(params, *_torch(case))
    return env_kernels.schedule_assignment(sched), rate_gt, rate_ubs


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_port_body_matches_jax_body(name, body):
    params = params_of(torch_env, name)
    case = make_case(params, WORLDS[name], seed=len(name))
    want = _jax_schedule(name, body, case)
    got = _port_schedule(params, body, case)
    res = env_kernels.compare_schedules(params, case["d"], case["gain"], case["prior"], got, want)
    assert not res["faults"], res["faults"]
    assert res["err"] <= env_kernels.RATE_RTOL, res["err"]
    assert len(res["ties"]) < WORLDS[name], res["ties"]      # some world agrees in full
    served = (want[0] >= 0).sum().item()
    assert 0 < served < want[0].numel()                      # GTs served, and GTs not
    outcomes = edge_outcomes(params, case, want[0])
    assert all(outcomes.values()), outcomes
    assert edge_outcomes(params, case, got[0]) == outcomes


@pytest.mark.parametrize("name", ["8ubs", "hotspot_v2"])
def test_bodies_agree_and_interfere(name):
    """Both port bodies give the same schedule, on worlds where GTs hear
    several UBSs (some served GT's rate is cut by interference)."""
    params = params_of(torch_env, name)
    case = make_case(params, WORLDS[name], seed=3)
    scatter = _port_schedule(params, "scatter", case)
    onehot = _port_schedule(params, "onehot", case)
    res = env_kernels.compare_schedules(params, case["d"], case["gain"], case["prior"],
                                        onehot, scatter)
    assert not res["faults"] and not res["ties"] and res["err"] <= env_kernels.RATE_RTOL
    a, rate = scatter[0].numpy(), scatter[1].numpy()
    R = params.n_rbs
    d, g = case["d"], case["gain"]
    w, m = np.nonzero(a >= 0)
    alone = params.bw * np.log2(1 + params.p_tx * g[w, a[w, m] // R, m] / params.noise) * 1e-6
    assert (rate[w, m] < 0.999 * alone).any()                # interference bites somewhere
    assert (d <= params.r_cov).sum(1).max() >= 2


def test_schedule_runs_the_body_schedule_impl_names(monkeypatch):
    params = params_of(torch_env, "8ubs")
    args = _torch(make_case(params, 2, seed=5))
    assert torch_env.SCHEDULE_IMPL == jax_env.SCHEDULE_IMPL == "scatter"
    default = torch_env._schedule(params, *args)
    for got, want in zip(default, torch_env._schedule_body_scatter(params, *args)):
        assert torch.equal(got, want)
    called = []
    for body in BODIES:
        monkeypatch.setattr(torch_env, f"_schedule_body_{body}",
                            lambda *a, body=body: called.append(body) or (None, None, None))
    for impl in ("onehot", "scatter"):
        monkeypatch.setattr(torch_env, "SCHEDULE_IMPL", impl)
        torch_env._schedule(params, *args)
    assert called == ["onehot", "scatter"]


def test_wrapper_runs_the_scatter_body_on_the_cpu():
    params = params_of(torch_env, "hotspot_v2")
    args = _torch(make_case(params, 3, seed=6))
    before = env_kernels.schedule_and_rate.launches
    rate_gt, rate_ubs, assign = env_kernels.schedule_and_rate(params, *args, with_assignment=True)
    sched, want_gt, want_ubs = torch_env._schedule_body_scatter(params, *args)
    assert torch.equal(rate_gt, want_gt) and torch.equal(rate_ubs, want_ubs)
    assert torch.equal(assign, env_kernels.schedule_assignment(sched))
    assert assign.dtype == torch.int32 and tuple(assign.shape) == (3, params.n_gts)
    assert env_kernels.schedule_and_rate.launches == before    # no kernel ran
    assert len(env_kernels.schedule_and_rate(params, *args)) == 2


def test_wrapper_raises_off_the_cpu_and_the_card():
    params = params_of(torch_env, "exp2")
    d = torch.empty((2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        env_kernels.schedule_and_rate(params, d, d, torch.empty((2, 4), dtype=torch.int64,
                                                                device="meta"))


def test_divergence_rule():
    """``first_divergence`` replays two schedules to the first GT they place
    apart; ``is_interference_tie`` takes a parting only between RBs of one
    UBS whose exact sums of three or more powers lie within 2(k - 1) ulps."""
    params = params_of(torch_env, "8ubs")._replace(n_ubs=3, n_gts=4, n_rbs=2)
    R = params.n_rbs
    d = np.full((3, 4), 50.0, np.float32)                   # every UBS covers every GT
    g = np.full((3, 4), 1e-9, np.float32)
    power = float(np.float32(params.p_tx) * np.float32(1e-9))
    prior = np.array([3, 0, 1, 2])
    want = np.array([1 * R + 0, 2 * R + 0, 0 * R + 1, 0 * R + 0])
    assert env_kernels.first_divergence(params, d, g, prior, want, want) is None
    for got, gt, sides, itf in (                             # not ties: each must fail
            ([1 * R + 0, 2 * R + 0, 0 * R + 1, 0 * R + 1], 3, ((0, 1), (0, 0)), [0.0, 0.0]),
            ([1 * R + 0, 2 * R + 0, 0 * R + 1, 1 * R + 1], 3, ((1, 1), (0, 0)), [0.0, 0.0]),
            ([1 * R + 1, 2 * R + 0, 0 * R + 1, 0 * R + 0], 0, ((1, 1), (1, 0)), [0.0, power])):
        div = env_kernels.first_divergence(params, d, g, prior, np.array(got), want)
        assert (div["gt"], div["a"], div["b"], div["itf"]) == (gt, *sides, itf)
        assert not env_kernels.is_interference_tie(div)
    tie = dict(gt=0, a=(0, 0), b=(0, 1), itf=[3 * power, 3 * power * (1 + 2 ** -23)], terms=3)
    assert env_kernels.is_interference_tie(tie)
    assert not env_kernels.is_interference_tie(dict(tie, terms=2))   # one order only
    assert not env_kernels.is_interference_tie(dict(tie, itf=[3 * power, 3.01 * power]))
    assert not env_kernels.is_interference_tie(dict(tie, b=(1, 1)))  # another UBS
