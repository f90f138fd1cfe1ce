"""The port's batched single-UBS env (``envs/torch_env_subs.py``, exp1) against
``uav_bs_ctrl_tpu.envs.jax_env_subs``.

- ``make_params``: every field equal.
- The layout pool: the port's NumPy copy of ``SingleUbsCoverageEnv._set_position``
  gives the JAX package's pool for the same seed, bit for bit, and leaves
  ``np.random`` as it was.
- A reset from the same positions and the same priority permutation, then 30
  steps of the same actions (the episode's limit, so ``done`` at the last),
  at 2 groups x 3 GTs and 4 x 5 (and 4 x 5 with 3 RBs, so that the greedy
  scheduler's cap binds): positions exact, rates, average rates, utilities,
  Jain's index, throughput, returns, observations and rewards within 1e-5,
  priorities equal up to ``tests/test_torch_env.py``'s tie rule (two GTs
  whose average rates tie to 1e-6 in the JAX env may swap places; the port
  then continues from the JAX order). A move is 100 m, so the UBS starts
  beside a GT group and stays or steps out and back, so that the scheduler
  serves on most steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_env import TIE_RTOL
from uav_bs_ctrl_tpu.algos import collect_subs as jcollect_subs
from uav_bs_ctrl_tpu.envs import jax_env_subs
from uav_bs_ctrl_tpu_torch.algos import collect_subs
from uav_bs_ctrl_tpu_torch.envs import torch_env_subs

TOL = dict(atol=1e-5, rtol=1e-5)
N_WORLDS, N_STEPS = 3, 30
CASES = [dict(n_grps=2, gts_per_grp=3), dict(n_grps=4, gts_per_grp=5),
         dict(n_grps=4, gts_per_grp=5, n_rbs=3)]


def _ids(case):
    return "-".join(f"{k}{v}" for k, v in case.items())


@pytest.mark.parametrize("kw", [dict(), dict(n_grps=4, gts_per_grp=5, episode_limit=30),
                                dict(range_pos=800, r_cov=150.0, n_rbs=4, vels=[5, 10],
                                     n_dirs=8)], ids=["default", "exp1", "odd"])
def test_make_params_fields_equal(kw):
    got, want = torch_env_subs.make_params(**kw), jax_env_subs.make_params(**kw)
    assert got._fields == want._fields
    for name in want._fields:
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("kw", CASES[:2], ids=_ids)
def test_layout_pool_is_jax_pool(kw):
    np.random.seed(123)
    before = np.random.get_state()[1].copy()
    got = collect_subs.make_subs_layout_pool(6, seed=7, **kw)
    assert np.array_equal(np.random.get_state()[1], before)
    want = jcollect_subs.make_subs_layout_pool(6, seed=7, **kw)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[1].shape == (6, kw["n_grps"] * kw["gts_per_grp"], 2)


def _assert_priority_equal_up_to_ties(got, want):
    g, w = got.numpy(), np.asarray(want.prior_gts)
    avg = np.asarray(want.aver_rate_per_gt)
    for world in range(g.shape[0]):
        assert sorted(g[world]) == list(range(g.shape[1]))
        np.testing.assert_allclose(avg[world][g[world]], avg[world][w[world]],
                                   rtol=TIE_RTOL, atol=0, err_msg="prior_gts")


def _assert_state_equal(got, want):
    _assert_priority_equal_up_to_ties(got.prior_gts, want)
    for name in torch_env_subs.SubsState._fields:
        if name == "prior_gts":
            continue
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name in ("t", "pos_ubs", "pos_gts"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def _assert_obs_equal(got, want):
    for key in ("agent", "gt"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("kw", CASES, ids=_ids)
def test_torch_env_subs_matches_jax_env_subs(kw):
    kw = dict(kw, episode_limit=N_STEPS)
    jp, tp = jax_env_subs.make_params(**kw), torch_env_subs.make_params(**kw)
    pos_ubs, pool = collect_subs.make_subs_layout_pool(N_WORLDS, seed=5, **kw)
    # Start each UBS 30 m from a GT, so that a group is in range from the first step.
    ubs = pool[:, 0] + np.float32(30.0)
    keys = jax.random.split(jax.random.PRNGKey(2), N_WORLDS)
    prior = np.stack([np.asarray(jax.random.permutation(k, jp.n_gts)) for k in keys])
    js = jax.vmap(lambda u, g, k: jax_env_subs.reset_from_positions(jp, u, g, k))(
        jnp.asarray(ubs), jnp.asarray(pool), keys)
    ts = torch_env_subs.reset_from_positions(tp, torch.from_numpy(ubs), torch.from_numpy(pool),
                                             torch.from_numpy(prior))
    _assert_state_equal(ts, js)
    _assert_obs_equal(torch_env_subs.get_obs(tp, ts),
                      jax.vmap(lambda s: jax_env_subs.get_obs(jp, s))(js))
    ts = ts._replace(prior_gts=torch.from_numpy(np.asarray(js.prior_gts, np.int64)))

    rng = np.random.default_rng(11)
    opposite = np.array([0, 3, 4, 1, 2])                 # stay, +x, +y, -x, -y
    acts = np.zeros(N_WORLDS, np.int64)
    jstep = jax.jit(jax.vmap(lambda s, a: jax_env_subs.step(jp, s, a)))
    served = []
    for step in range(N_STEPS):
        acts = opposite[acts] if step % 2 else rng.integers(0, jp.n_actions, size=N_WORLDS)
        js, jobs, jrew, jdone = jstep(js, jnp.asarray(acts, jnp.int32))
        ts, tobs, trew, tdone = torch_env_subs.step(tp, ts, torch.from_numpy(acts))
        _assert_state_equal(ts, js)
        _assert_obs_equal(tobs, jobs)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **TOL)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        assert tdone.all() == (step == N_STEPS - 1) and tdone.any() == tdone.all()
        ts = ts._replace(prior_gts=torch.from_numpy(np.asarray(js.prior_gts, np.int64)))
        served.append(int((ts.rate_per_gt > 0).sum(-1).max()))
    assert sum(n > 0 for n in served) >= N_STEPS // 2        # the scheduler served
    assert max(served) <= tp.n_rbs
    if tp.n_rbs < kw["gts_per_grp"]:
        assert max(served) == tp.n_rbs                       # the cap bound
