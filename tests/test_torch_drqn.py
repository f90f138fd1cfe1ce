"""The port's exp1 DRQN against the JAX package's: ``DrqnGnnAgent`` and the exp1
``RnnAgent``, ``algos/drqn``'s ``QLearner`` and its checkpoints.

- The agents' forward (Q and h') on the same weights and inputs: 1e-5 at
  hidden 16 (M = 6), 1e-4 at hidden 256 with M = 20 (exp1's 4 x 5 GTs),
  through the kernels' plain versions and the unfused path.
- One update on the same batch (B = 4, L = 5) against JAX's
  ``QLearner._update_fn``: LossQ, QVals, the clipped gradients, the AdamW
  moments and the params and targets after AdamW and Polyak within 1e-5
  (``tests/test_torch_update.py:_check_first_update``), for both agents,
  through the kernels' Functions and the unfused path; ten updates on fixed
  batches stay within 1e-4 (LossQ of each, the params after).
- The committed ``data/exp1_fast_grp4_size5_{gnn,rnn}/..._s0/checkpoint_epoch50.pt``
  at full width: Q and h' of the loaded net on real exp1 observations within
  1e-4 of JAX's loaded learner, and the AdamW state (count, both moments),
  the LR scale and the scheduler's epoch as JAX restores them.
- A checkpoint the port's exp1 learner writes resumes in the learner of
  JAX's ``FusedDrqnTrainer``: params, count and both moments leaf for leaf,
  the LR scale, the scheduler's epoch and the stamp.
"""

import json
from pathlib import Path
from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_update import TOL, _check_first_update, _jax_first_update, _named, _torch_tree
from uav_bs_ctrl_tpu.algos.common import check_args_sanity as jax_check_args
from uav_bs_ctrl_tpu.algos.drqn.config import DEFAULT_CONFIG as JAX_DRQN_DEFAULTS
from uav_bs_ctrl_tpu.algos.drqn.fused import FusedDrqnTrainer as JaxFusedDrqnTrainer
from uav_bs_ctrl_tpu.algos.drqn.learner import QLearner as JaxQLearner
from uav_bs_ctrl_tpu_torch.algos import collect_subs
from uav_bs_ctrl_tpu_torch.algos.drqn.config import DEFAULT_CONFIG, check_args
from uav_bs_ctrl_tpu_torch.algos.drqn.fused import obs_shape
from uav_bs_ctrl_tpu_torch.algos.drqn.learner import QLearner
from uav_bs_ctrl_tpu_torch.envs import torch_env_subs
from uav_bs_ctrl_tpu_torch.models.agents import DrqnGnnAgent, RnnAgent

ROOT = Path(__file__).resolve().parents[1]
RUN_DIRS = {a: ROOT / "data" / f"exp1_fast_grp4_size5_{a}" / f"exp1_fast_grp4_size5_{a}_s0"
            for a in ("gnn", "rnn")}
FULL_TOL = dict(atol=1e-4, rtol=1e-4)
L, B, N_ACT = 5, 4, 5
SMALL = dict(n_grps=2, gts_per_grp=3)           # M = 6
EXP1 = dict(n_grps=4, gts_per_grp=5)            # M = 20


def _kw(agent, hidden=16, **extra):
    return dict(agent=agent, hidden_size=hidden, n_heads=2 if hidden == 16 else 4,
                n_layers=1 if hidden == 16 else 2, max_seq_len=L, batch_size=B,
                replay_size=40, **extra)


def _env_info(agent, env=SMALL):
    params = torch_env_subs.make_params(**env)
    return dict(obs_shape=obs_shape(params, agent), n_actions=N_ACT,
                episode_limit=params.episode_limit)


def _learners(agent, kw=None, env=SMALL, seed=0):
    """JAX's ``QLearner`` (dense path) and the port's, with the JAX weights."""
    kw = kw or _kw(agent)
    jl = JaxQLearner(_env_info(agent, env),
                     jax_check_args(SN(**{**JAX_DRQN_DEFAULTS, **kw, "device": "cpu"})), seed=seed)
    tl = QLearner(_env_info(agent, env), check_args(SN(**{**DEFAULT_CONFIG, **kw,
                                                          "device": "cpu"})), seed=seed)
    tl.load_params(jax.tree_util.tree_map(np.asarray, jl.params))
    return jl, tl


def _obs(rng, agent, lead, m):
    gt = (0.5 * rng.normal(size=lead + (1, m, 4))).astype(np.float32)
    own = rng.random(lead + (1, 2)).astype(np.float32)
    if agent == "gnn":
        return {"agent": own, "gt": gt}
    return {"agent": np.concatenate([own, gt.reshape(lead + (1, -1))], -1)}


def _batch(rng, agent, hidden, m=6):
    """A batch in the exp1 replay layout; one done flag (exp1 stores none, the
    update reads it all the same)."""
    done = np.zeros((B, L), np.float32)
    done[0, -1] = 1.0
    return dict(obs=_obs(rng, agent, (B, L + 1), m),
                h=(0.5 * rng.normal(size=(B, 2, 1, hidden))).astype(np.float32),
                act=rng.integers(0, N_ACT, size=(B, L, 1)).astype(np.int32),
                rew=rng.normal(size=(B, L, 1)).astype(np.float32), done=done)


@pytest.mark.parametrize("agent,hidden", [("gnn", 16), ("gnn", 256), ("rnn", 16), ("rnn", 256)])
def test_agent_forward_matches_jax(agent, hidden):
    env = SMALL if hidden == 16 else EXP1
    jl, tl = _learners(agent, _kw(agent, hidden), env)
    assert type(tl.net) is (DrqnGnnAgent if agent == "gnn" else RnnAgent)
    assert type(tl.net).__name__ == type(jl.agent).__name__
    tol = TOL if hidden == 16 else FULL_TOL
    m = torch_env_subs.make_params(**env).n_gts
    rng = np.random.default_rng(hidden)
    obs = _obs(rng, agent, (7,), m)
    h = np.tanh(rng.normal(size=(7, 1, hidden))).astype(np.float32)
    q_want, h_want = jl.agent.apply(jl.params["net"], jax.tree_util.tree_map(jnp.asarray, obs),
                                    jnp.asarray(h))
    with torch.no_grad():
        for use_kernels in (True, False):
            q, h2 = tl.net(_torch_tree(obs), torch.from_numpy(h), use_kernels)
            assert tuple(q.shape) == (7, 1, N_ACT)
            np.testing.assert_allclose(q.numpy(), np.asarray(q_want), **tol)
            np.testing.assert_allclose(h2.numpy(), np.asarray(h_want), **tol)


@pytest.mark.parametrize("agent", ["gnn", "rnn"])
def test_first_update_matches_jax(agent):
    jl, tl = _learners(agent)
    assert (tl.double_q, tl.mixer, tl.share_reward, tl.max_seq_len) == (False, None, False, L)
    batch = _batch(np.random.default_rng(1), agent, 16)
    want = _jax_first_update(jl, jax.tree_util.tree_map(jnp.asarray, batch))
    for use_kernels in (True, False):
        _check_first_update(tl, want, batch, use_kernels, TOL)


@pytest.mark.parametrize("agent", ["gnn", "rnn"])
def test_ten_updates_track_jax(agent):
    jl, tl = _learners(agent, seed=2)
    rng = np.random.default_rng(3)
    batches = [_batch(rng, agent, 16) for _ in range(3)]
    params, targets, opt_state = jl.params, jl.target_params, jl.opt_state
    for step in range(10):
        batch = batches[step % len(batches)]
        params, targets, opt_state, m = jl._update_jit(
            params, targets, opt_state, jax.tree_util.tree_map(jnp.asarray, batch),
            jax.random.PRNGKey(step), jnp.float32(1.0))
        got = tl.update_on_batch(_torch_tree(batch))
        np.testing.assert_allclose(float(got["LossQ"]), float(m["LossQ"]), rtol=1e-4,
                                   err_msg=f"update {step}")
    want = _named(params)
    for name, v in tl.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[f"net.{name}"], err_msg=name, **FULL_TOL)
    assert tl.optimizer.state[tl.parameters()[0]]["step"].item() == 10


def _real_obs(agent, n=6):
    """Observations of exp1 worlds: the first from the held-out pool's start,
    the rest with the UBS beside a GT group, so that GTs are served."""
    params = torch_env_subs.make_params(**EXP1)
    _, pool = collect_subs.make_subs_layout_pool(n, seed=10_000, **EXP1)
    ubs = np.full((n, 2), 500.0, np.float32)
    ubs[1:] = pool[1:, 0] + np.float32(20.0)
    prior = np.stack([np.random.default_rng(i).permutation(params.n_gts) for i in range(n)])
    states = torch_env_subs.reset_from_positions(params, torch.from_numpy(ubs),
                                                 torch.from_numpy(pool), torch.from_numpy(prior))
    states, obs, _, _ = torch_env_subs.step(params, states, torch.zeros(n, dtype=torch.int64))
    assert float(states.rate_per_gt.sum()) > 0
    if agent == "rnn":
        obs = collect_subs.flatten_obs(obs)
    return {k: v.numpy() for k, v in obs.items()}


@pytest.mark.parametrize("agent", ["gnn", "rnn"])
def test_committed_checkpoint_loads_at_full_width(agent):
    run_dir = RUN_DIRS[agent]
    config = json.loads((run_dir / "config.json").read_text())
    path = run_dir / "checkpoint_epoch50.pt"
    kw = dict(config["args"], device="cpu")
    env_info = _env_info(agent, config["env_kwargs"])
    jl = JaxQLearner(env_info, jax_check_args(SN(**{**JAX_DRQN_DEFAULTS, **kw})))
    tl = QLearner(env_info, check_args(SN(**{**DEFAULT_CONFIG, **kw})), seed=5)
    assert tl.load_checkpoint(path) == {"epoch": 50, "t": 800_000}
    jl.load_checkpoint(str(path))
    assert (tl.lr_scale, tl._epoch) == (float(jl.lr_scale), int(jl._epoch)) == (0.5, 50)

    obs = _real_obs(agent)
    h = np.tanh(np.random.default_rng(0).normal(size=(len(obs["agent"]), 1, 256)))
    h = h.astype(np.float32)
    q_want, h_want = jl.agent.apply(jl.params["net"], jax.tree_util.tree_map(jnp.asarray, obs),
                                    jnp.asarray(h))
    with torch.no_grad():
        for use_kernels in (True, False):
            q, h2 = tl.net(_torch_tree(obs), torch.from_numpy(h), use_kernels)
            np.testing.assert_allclose(q.numpy(), np.asarray(q_want), **FULL_TOL)
            np.testing.assert_allclose(h2.numpy(), np.asarray(h_want), **FULL_TOL)

    adam = jl.opt_state.inner_state[0]
    mu, nu = _named(adam.mu), _named(adam.nu)
    assert int(adam.count) == 78_400
    for name, p in tl.net.named_parameters():
        state = tl.optimizer.state[p]
        assert state["step"].item() == 78_400
        np.testing.assert_array_equal(state["exp_avg"].numpy(), mu[f"net.{name}"], err_msg=name)
        np.testing.assert_array_equal(state["exp_avg_sq"].numpy(), nu[f"net.{name}"],
                                      err_msg=name)
    np.testing.assert_array_equal(tl._update_lr, np.asarray(jl.opt_state.hyperparams[
        "learning_rate"]))


@pytest.mark.parametrize("agent", ["gnn", "rnn"])
def test_jax_fused_drqn_trainer_resumes_a_port_checkpoint(tmp_path, agent):
    kw = _kw(agent)
    _, port = _learners(agent, kw, seed=4)
    rng = np.random.default_rng(6)
    for _ in range(3):
        port.update_on_batch(_torch_tree(_batch(rng, agent, 16)))
    port.step_lr_scheduler()
    port.step_lr_scheduler()
    path = tmp_path / "checkpoint_epoch2.pt"
    port.save_checkpoint(path, dict(epoch=2, t=400))

    trainer = JaxFusedDrqnTrainer(dict(SMALL, episode_limit=20),
                                  train_kwargs=dict(kw, device="cpu"), n_worlds=2, n_layouts=2)
    jl = trainer.learner
    stamp = jl.load_checkpoint(str(path))
    assert (int(stamp["epoch"]), int(stamp["t"])) == (2, 400)
    assert (float(jl.lr_scale), int(jl._epoch)) == (port.lr_scale, port._epoch) == (0.98, 2)
    adam = jl.opt_state.inner_state[0]
    assert int(jl.opt_state.count) == int(adam.count) == 3
    params, mu, nu = _named(jl.params), _named(adam.mu), _named(adam.nu)
    assert sorted(params) == sorted(f"net.{k}" for k, _ in port.net.named_parameters())
    for name, p in port.net.named_parameters():
        key = f"net.{name}"
        np.testing.assert_array_equal(p.detach().numpy(), params[key], err_msg=key)
        state = port.optimizer.state[p]
        np.testing.assert_array_equal(state["exp_avg"].numpy(), mu[key], err_msg=key)
        np.testing.assert_array_equal(state["exp_avg_sq"].numpy(), nu[key], err_msg=key)
