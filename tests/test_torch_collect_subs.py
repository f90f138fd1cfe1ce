"""The port's exp1 collection (``algos/collect_subs.py``) against
``uav_bs_ctrl_tpu.algos.collect_subs``.

- From the same states, params and weights at eps = 0 (greedy, so no random
  draw decides anything), ``collect_episode_subs`` gives JAX's chunks for both
  exp1 agents (T = 20, L = 5, W = 3, hidden 16): actions exact; obs, rewards,
  the h pairs and the episode stats within 1e-5; ``done`` all zero.
- The slice layout on its own, as ``tests/test_fused_drqn.py`` checks JAX's:
  shapes, continuity of the slices' observations, the first slice's zero h,
  EpRet as the sum of the slices' rewards; and each slice's h pair is the h
  at its first step and the policy's h after that step.
- ``evaluate_policy_subs``: its stats' keys and shapes, finite values.
"""

from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uav_bs_ctrl_tpu.algos import collect_subs as jcollect_subs
from uav_bs_ctrl_tpu.envs import jax_env_subs
from uav_bs_ctrl_tpu.models.agents import DRQN_REGISTRY as JAX_DRQN_REGISTRY
from uav_bs_ctrl_tpu_torch.algos import collect_subs
from uav_bs_ctrl_tpu_torch.algos.drqn.fused import obs_shape
from uav_bs_ctrl_tpu_torch.envs import torch_env_subs
from uav_bs_ctrl_tpu_torch.models.agents import DRQN_REGISTRY
from uav_bs_ctrl_tpu_torch.utils.convert import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
T, L, W, HID = 20, 5, 3, 16
ENV = dict(n_grps=2, gts_per_grp=3, episode_limit=T)
ARGS = SN(hidden_size=HID, n_heads=2, n_layers=1, dueling=False)


def _agents(agent):
    """The JAX agent and its params, and the port's agent with those params."""
    params = jax_env_subs.make_params(**ENV)
    shape = obs_shape(params, agent)
    jagent = JAX_DRQN_REGISTRY[agent](shape, params.n_actions, ARGS)
    jparams = jagent.init(jax.random.PRNGKey(3))
    tagent = DRQN_REGISTRY[agent](shape, params.n_actions, ARGS)
    tagent.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tagent))
    return jagent, jparams, tagent


def _jax_apply(jagent, agent):
    """``drqn/fused.py:_agent_apply``: the 'rnn' agent on the flat observation."""
    def apply(p, obs, h, key):
        if agent != "gnn":
            lead = obs["agent"].shape[:-1]
            obs = {"agent": jnp.concatenate([obs["agent"], obs["gt"].reshape(lead + (-1,))], -1)}
        return jagent.apply(p, obs, h, key)
    return apply


def _start(params):
    """W worlds beside a GT group, and their priority permutations."""
    _, pool = collect_subs.make_subs_layout_pool(W, seed=4, **ENV)
    ubs = pool[:, 0] + np.float32(30.0)
    keys = jax.random.split(jax.random.PRNGKey(5), W)
    prior = np.stack([np.asarray(jax.random.permutation(k, params.n_gts)) for k in keys])
    return ubs, pool, keys, prior


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("agent", ["gnn", "rnn"])
def test_greedy_episode_chunks_match_jax(agent):
    jp, tp = jax_env_subs.make_params(**ENV), torch_env_subs.make_params(**ENV)
    jagent, jparams, tagent = _agents(agent)
    ubs, pool, keys, prior = _start(jp)
    js = jax.vmap(lambda u, g, k: jax_env_subs.reset_from_positions(jp, u, g, k))(
        jnp.asarray(ubs), jnp.asarray(pool), keys)
    want, _, want_stats = jcollect_subs.collect_episode_subs(
        jp, _jax_apply(jagent, agent), jparams, js, jnp.zeros((W, 1, HID)), T, L,
        jax.random.PRNGKey(0), jnp.float32(0.0))

    ts = torch_env_subs.reset_from_positions(tp, torch.from_numpy(ubs), torch.from_numpy(pool),
                                             torch.from_numpy(prior))
    with torch.no_grad():
        got, final, stats = collect_subs.collect_episode_subs(
            tp, collect_subs.make_policy(tagent, agent), ts, torch.zeros((W, 1, HID)), T, L,
            torch.Generator().manual_seed(0), 0.0)
    assert got.keys() == want.keys() and got["obs"].keys() == want["obs"].keys()
    np.testing.assert_array_equal(_np(got["act"]), _np(want["act"]))
    assert got["act"].dtype == torch.int32
    assert len(np.unique(_np(got["act"]))) > 1                   # the policy moved about
    for key in ("agent", "gt"):
        np.testing.assert_allclose(_np(got["obs"][key]), _np(want["obs"][key]), err_msg=key,
                                   **TOL)
    for key in ("h", "rew"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), err_msg=key, **TOL)
    assert float(got["rew"].sum()) > 0
    np.testing.assert_array_equal(_np(got["done"]), 0.0)
    assert tuple(got["done"].shape) == (W * T // L, L)
    for key, v in stats.items():
        np.testing.assert_allclose(_np(v), _np(want_stats[key]), err_msg=key, **TOL)
    assert (final.t == T).all()


def test_slice_layout():
    """Slice i covers steps iL .. (i+1)L; its h pair is the h at step iL and
    the policy's h after that step, from slice i's first observation."""
    tp = torch_env_subs.make_params(n_grps=2, gts_per_grp=2, episode_limit=T)
    m = tp.n_gts
    tagent = DRQN_REGISTRY["rnn"](2 + 4 * m, tp.n_actions, ARGS)
    policy = collect_subs.make_policy(tagent, "rnn")
    gen = torch.Generator().manual_seed(1)
    pool = collect_subs.make_subs_layout_pool(2, seed=0, n_grps=2, gts_per_grp=2, episode_limit=T)
    states = collect_subs.reset_subs_worlds(tp, pool, gen, W, torch.device("cpu"))
    with torch.no_grad():
        chunks, final, stats = collect_subs.collect_episode_subs(
            tp, policy, states, torch.zeros((W, 1, HID)), T, L, gen, 0.5)
    S = T // L
    assert tuple(chunks["obs"]["agent"].shape) == (W * S, L + 1, 1, 2)
    assert tuple(chunks["obs"]["gt"].shape) == (W * S, L + 1, 1, m, 4)
    assert tuple(chunks["h"].shape) == (W * S, 2, 1, HID)
    assert tuple(chunks["act"].shape) == (W * S, L, 1) == tuple(chunks["rew"].shape)
    np.testing.assert_array_equal(chunks["done"].numpy(), 0.0)
    assert (final.t == T).all()

    obs_a = chunks["obs"]["agent"].numpy().reshape(W, S, L + 1, 1, 2)
    obs_g = chunks["obs"]["gt"].numpy().reshape(W, S, L + 1, 1, m, 4)
    np.testing.assert_array_equal(obs_a[:, :-1, -1], obs_a[:, 1:, 0])
    np.testing.assert_array_equal(obs_g[:, :-1, -1], obs_g[:, 1:, 0])
    h = chunks["h"].numpy().reshape(W, S, 2, 1, HID)
    np.testing.assert_array_equal(h[:, 0, 0], 0.0)
    assert np.abs(h[:, 1:, 0]).max() > 0
    with torch.no_grad():
        _, h_next = policy({k: v[:, 0] for k, v in chunks["obs"].items()}, chunks["h"][:, 0])
    np.testing.assert_allclose(h_next.numpy(), chunks["h"][:, 1].numpy(), rtol=1e-6, atol=1e-7)
    rew = chunks["rew"].numpy().reshape(W, S, L)
    np.testing.assert_allclose(stats["EpRet"].numpy(), rew.sum((1, 2)), rtol=1e-5)


def test_evaluate_policy_subs_stats():
    tp = torch_env_subs.make_params(**ENV)
    _, _, tagent = _agents("gnn")
    pool = collect_subs.make_subs_layout_pool(4, seed=10_000, **ENV)
    with torch.no_grad():
        stats = collect_subs.evaluate_policy_subs(
            tp, collect_subs.make_policy(tagent, "gnn"), pool, HID,
            torch.Generator().manual_seed(0), 5, torch.device("cpu"))
    assert set(stats) == {"TestEpRet", "TestFairIdx", "TestAvgGlobalUtility",
                          "TestTotalThroughput"}
    for key, v in stats.items():
        assert tuple(v.shape) == (5,) and torch.isfinite(v).all(), key
