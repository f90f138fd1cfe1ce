"""Rollouts on the device (counterpart of ``algos/collect.py``).

Episodes run W worlds at once: the policy acts greedily with a joint epsilon
per world per step (the reference's exploration rule). ``collect_chunk``
returns the experience in the replay layout; ``eval_rollout`` only the final
episode statistics. Random draws come from a CPU ``torch.Generator`` and are
moved to the device, so one seed gives the same draws on the CPU and on the
card. Each step hands the policy its own key, as the JAX rollouts split
``k_pol`` off theirs: a ``StepKey``, a seed drawn from the rollout's
generator only when the policy reads it (the DiscreteComm agent seeds its
Gumbel noise with it), so a policy that samples nothing leaves the rollout's
stream as it was.

``rows=(lo, hi, W)`` runs worlds ``[lo, hi)`` of ``W`` (a dp rank's block,
``algos/madrqn/fused.py``): every draw is made at the full ``W`` worlds, as
one rank makes it, and the block's rows are kept, so the generator advances
as the single-rank run's and the block's worlds are that run's.
"""

import numpy as np
import torch

from uav_bs_ctrl_tpu_torch.envs import torch_env
from uav_bs_ctrl_tpu_torch.envs.maps import MAPS
from uav_bs_ctrl_tpu_torch.models.modules import gumbel_noise


def make_layout_pool(map_id, n_layouts, seed=0):
    """Layouts from the map's own NumPy generator: (ubs [P, N, 2], gts [P, M, 2])."""
    m = MAPS[map_id]
    rng_state = np.random.get_state()
    np.random.seed(seed)
    ubs, gts = [], []
    for _ in range(n_layouts):
        pos = m.set_positions()
        ubs.append(np.asarray(pos["ubs"], np.float32))
        gts.append(np.asarray(pos["gt"], np.float32))
    np.random.set_state(rng_state)
    return np.stack(ubs), np.stack(gts)


def reset_worlds(params, pool, generator, n_worlds, device, rows=None):
    """Reset ``n_worlds`` worlds from random pool layouts, each with a random
    GT priority permutation (with ``rows``, worlds ``[lo, hi)`` of them)."""
    pool_ubs, pool_gts = (torch.as_tensor(a) for a in pool)
    idx = torch.randint(0, pool_ubs.shape[0], (n_worlds,), generator=generator)
    prior = torch.argsort(torch.rand((n_worlds, params.n_gts), generator=generator), dim=-1)
    if rows is not None:
        idx, prior = idx[rows[0]:rows[1]], prior[rows[0]:rows[1]]
    return torch_env.reset_from_positions(params, pool_ubs[idx].to(device),
                                          pool_gts[idx].to(device), prior.to(device))


def flatten_obs(obs):
    """The MLP encoder's observation from the env's: ``{"agent": [..., A, 2 +
    5M + 3(N-1)], "adj"}``, each agent's own position, GT rows and UBS rows
    laid end to end (JAX ``fused.py:_agent_apply``)."""
    lead = tuple(obs["agent"].shape[:-1])
    flat = torch.cat([obs["agent"], obs["gt"].reshape(lead + (-1,)),
                      obs["ubs"].reshape(lead + (-1,))], -1)
    return {"agent": flat, "adj": obs["adj"]}


def make_policy(net, o):
    """``net`` (an agent, or a learner's ``_apply_net``: any ``(obs, h,
    use_kernels, key) -> (q, h')``) as a rollout policy on the env's obs: as
    it is for ``o='gnn'``, on :func:`flatten_obs` of the obs for ``o='mlp'``."""
    if o == "gnn":
        return net

    def policy(obs, h, use_kernels=True, key=None):
        return net(flatten_obs(obs), h, use_kernels, key)
    return policy


class StepKey:
    """One env step's policy key: ``int(key)`` draws a seed from the rollout's
    generator the first time and returns the same seed after; ``noise(shape,
    device)`` is the Gumbel noise of that seed for ``shape`` (leading axis the
    worlds), drawn at the full worlds of ``rows`` and cut to its block."""

    def __init__(self, generator, rows=None):
        self._generator, self._seed, self._rows = generator, None, rows

    def __int__(self):
        if self._seed is None:
            self._seed = int(torch.randint(0, 2**62, (), generator=self._generator))
        return self._seed

    def noise(self, shape, device):
        if self._rows is None:
            return gumbel_noise(shape, int(self), device)
        lo, hi, total = self._rows
        return gumbel_noise((total,) + tuple(shape[1:]), int(self), device)[lo:hi]


def _act(policy, obs, h, generator, eps, n_actions, rows=None):
    """Joint epsilon-greedy actions [W, A] and the next hidden state;
    ``policy(obs, h, key=...)`` gets the step's ``StepKey``."""
    q, h2 = policy(obs, h, key=StepKey(generator, rows))
    greedy = q.argmax(-1)                                       # [W, A]
    n = greedy.shape[0] if rows is None else rows[2]
    rand = torch.randint(0, n_actions, (n,) + tuple(greedy.shape[1:]), generator=generator)
    explore = torch.rand((n, 1), generator=generator) < eps
    if rows is not None:
        rand, explore = rand[rows[0]:rows[1]], explore[rows[0]:rows[1]]
    return torch.where(explore.to(h.device), rand.to(h.device), greedy), h2


def episode_stats(states, prefix=""):
    return {f"{prefix}EpRet": states.ep_ret, f"{prefix}FairIdx": states.fair_idx,
            f"{prefix}AvgGlobalUtility": states.avg_global_util,
            f"{prefix}TotalThroughput": states.total_throughput,
            f"{prefix}ProbCollision": states.n_colls / torch.clamp(
                states.t.to(torch.float32), min=1)}


def collect_chunk(env_params, policy, states, h0, n_steps, generator, eps, rows=None):
    """Roll ``n_steps`` steps of every world; returns ``(chunk, states, stats)``.

    The chunk is in the replay layout: ``obs`` dict of [W, T+1, ...] (the last
    entry is the obs after the final step), ``h`` [W, 2, A, H] (h at t=0 and
    t=1, all the BPTT update reads), ``state`` [W, T+1, ds], ``act`` [W, T, A]
    int32, ``rew`` [W, T, A] and ``done`` [W, T]. Episodes end only by
    timeout, where the reference stores ``(1 - bad_mask) * done`` with
    ``bad_mask == done``: the stored ``done`` is identically zero, so TD
    targets always bootstrap.
    """
    obs_seq, state_seq, h_pair, acts_seq, rew_seq, done_seq = [], [], [h0], [], [], []
    h = h0
    obs = torch_env.get_obs(env_params, states)
    for _ in range(n_steps):
        obs_seq.append(obs)
        state_seq.append(torch_env.get_state_vec(env_params, states))
        acts, h = _act(policy, obs, h, generator, eps, env_params.n_actions, rows)
        if len(h_pair) == 1:
            h_pair.append(h)
        states, obs, rew, done = torch_env.step(env_params, states, acts)
        acts_seq.append(acts)
        rew_seq.append(rew)
        done_seq.append(done)
    obs_seq.append(obs)
    state_seq.append(torch_env.get_state_vec(env_params, states))
    raw_done = torch.stack(done_seq, 1).to(torch.float32)
    chunk = dict(obs={k: torch.stack([o[k] for o in obs_seq], 1) for k in obs_seq[0]},
                 h=torch.stack(h_pair, 1), state=torch.stack(state_seq, 1),
                 act=torch.stack(acts_seq, 1).to(torch.int32),
                 rew=torch.stack(rew_seq, 1), done=raw_done * (1.0 - raw_done))
    return chunk, states, episode_stats(states)


def eval_rollout(env_params, policy, states, h0, n_steps, generator, eps):
    """Roll ``n_steps`` steps of every world with ``policy(obs, h, key) -> (q, h')``
    choosing epsilon-greedy actions; returns the episode statistics [W]."""
    h = h0
    obs = torch_env.get_obs(env_params, states)
    for _ in range(n_steps):
        acts, h = _act(policy, obs, h, generator, eps, env_params.n_actions)
        states, obs, _, _ = torch_env.step(env_params, states, acts)
    return episode_stats(states, "Test")


def evaluate_policy(env_params, policy, pool, hidden_size, generator, n_episodes,
                    device, eps=0.05):
    """``n_episodes`` parallel test episodes from pool layouts; stat tensors [W]."""
    states = reset_worlds(env_params, pool, generator, n_episodes, device)
    h0 = torch.zeros((n_episodes, env_params.n_ubs, hidden_size), device=device)
    return eval_rollout(env_params, policy, states, h0, env_params.episode_limit,
                        generator, eps)
