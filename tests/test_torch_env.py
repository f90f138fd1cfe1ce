"""The port's batched torch env against ``uav_bs_ctrl_tpu.envs.jax_env``.

Same layouts (both packages' NumPy layout pools, which must agree), the same
GT priority permutation, then 10 steps of the same random actions, on the
debug map, exp3's 4- and 8-UBS maps and exp2's ``inf`` and ``r400`` HotSpot
maps (4 UBSs, 4 GTs, one RB; ``r400``'s finite talk radius leaves edges out
of the talk graph). Floats
match to 1e-5; bools and integers exactly, with one exception: XLA's CPU
``exp``/``arctan`` and PyTorch's differ in the last bit, so two GTs whose
average rates tie exactly in one package can differ by an ulp in the other and
swap places in the stable ``argsort`` that sets the next priority order. The
priority order must then agree up to such swaps, and the torch env continues
from the JAX order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uav_bs_ctrl_tpu.algos import collect as jcollect
from uav_bs_ctrl_tpu.envs import jax_env
from uav_bs_ctrl_tpu_torch.algos import collect
from uav_bs_ctrl_tpu_torch.envs import torch_env

TOL = dict(atol=1e-5, rtol=1e-5)
TIE_RTOL = 1e-6
N_WORLDS, N_STEPS = 2, 10


def _assert_priority_equal_up_to_ties(got: torch.Tensor, want: jax_env.EnvState):
    """Positions where the orders differ must hold GTs whose average rates tie
    to TIE_RTOL; elsewhere the orders are equal."""
    g, w = got.numpy(), np.asarray(want.prior_gts)
    avg = np.asarray(want.avg_rate_per_gt)
    for world in range(g.shape[0]):
        assert sorted(g[world]) == list(range(g.shape[1]))
        np.testing.assert_allclose(avg[world][g[world]], avg[world][w[world]],
                                   rtol=TIE_RTOL, atol=0, err_msg="prior_gts")


def _assert_state_equal(got: torch_env.EnvState, want: jax_env.EnvState):
    _assert_priority_equal_up_to_ties(got.prior_gts, want)
    for name in torch_env.EnvState._fields:
        if name == "prior_gts":
            continue
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if w.dtype == np.float32:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _assert_obs_equal(got: dict, want: dict):
    for key in ("agent", "gt", "ubs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)
    np.testing.assert_array_equal(got["adj"].numpy(), np.asarray(want["adj"]))


@pytest.mark.parametrize("map_id", ["debug", "4ubs", "8ubs", "inf", "r400"])
def test_torch_env_matches_jax_env(map_id):
    pool_t = collect.make_layout_pool(map_id, N_WORLDS, seed=7)
    pool_j = jcollect.make_layout_pool(map_id, N_WORLDS, seed=7)
    for a, b in zip(pool_t, pool_j):
        np.testing.assert_array_equal(a, np.asarray(b))

    jp = jax_env.make_params(map_id)
    tp = torch_env.make_params(map_id)
    # Random hotspot layouts rarely put a UBS within r_cov of a GT; start each
    # UBS near a different GT so that the scheduler serves, interferes and
    # reorders priorities from the first step. Under a finite r_comm (exp2's
    # r400) half the UBSs keep their layout positions, so that the talk graph
    # has missing edges.
    near = pool_t[1][:, ::max(1, jp.n_gts // jp.n_ubs)][:, :jp.n_ubs] + 20.0
    if np.isfinite(jp.r_comm):
        near[:, jp.n_ubs // 2:] = pool_t[0][:, jp.n_ubs // 2:]
    pool_t = (near, pool_t[1])
    keys = jax.random.split(jax.random.PRNGKey(3), N_WORLDS)
    prior = np.stack([np.asarray(jax.random.permutation(k, jp.n_gts)) for k in keys])
    js = jax.vmap(lambda u, g, k: jax_env.reset_from_positions(jp, u, g, k))(
        jnp.asarray(pool_t[0]), jnp.asarray(pool_t[1]), keys)
    ts = torch_env.reset_from_positions(tp, torch.from_numpy(pool_t[0]),
                                        torch.from_numpy(pool_t[1]), torch.from_numpy(prior))
    _assert_state_equal(ts, js)
    _assert_obs_equal(torch_env.get_obs(tp, ts), jax.vmap(lambda s: jax_env.get_obs(jp, s))(js))

    rng = np.random.default_rng(11)
    jstep = jax.jit(jax.vmap(lambda s, a: jax_env.step(jp, s, a)))
    missing_edges = 0
    for _ in range(N_STEPS):
        acts = rng.integers(0, jp.n_actions, size=(N_WORLDS, jp.n_ubs))
        js, jobs, _, jrew, jdone = jstep(js, jnp.asarray(acts, jnp.int32))
        ts, tobs, trew, tdone = torch_env.step(tp, ts, torch.from_numpy(acts))
        _assert_state_equal(ts, js)
        _assert_obs_equal(tobs, jobs)
        ts = ts._replace(prior_gts=torch.from_numpy(np.asarray(js.prior_gts, np.int64)))
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **TOL)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        missing_edges += int((~tobs["adj"]).sum())
    assert float(ts.total_throughput.sum()) > 0.0      # the schedule served someone
    assert (missing_edges > 0) == bool(np.isfinite(jp.r_comm))
