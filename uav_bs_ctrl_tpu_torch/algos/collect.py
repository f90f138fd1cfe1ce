"""Serving-side rollouts on the device (counterpart of ``algos/collect.py``).

Test episodes run W worlds at once: the policy acts greedily with a joint
epsilon per world per step (the reference's exploration rule), and only the
final episode statistics leave the device. Random draws come from a CPU
``torch.Generator`` and are moved to the device, so one seed gives the same
draws on the CPU and on the card.
"""

import numpy as np
import torch

from uav_bs_ctrl_tpu_torch.envs import torch_env
from uav_bs_ctrl_tpu_torch.envs.maps import MAPS


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


def reset_worlds(params, pool, generator, n_worlds, device):
    """Reset ``n_worlds`` worlds from random pool layouts, each with a random
    GT priority permutation."""
    pool_ubs, pool_gts = (torch.as_tensor(a) for a in pool)
    idx = torch.randint(0, pool_ubs.shape[0], (n_worlds,), generator=generator)
    prior = torch.argsort(torch.rand((n_worlds, params.n_gts), generator=generator), dim=-1)
    return torch_env.reset_from_positions(params, pool_ubs[idx].to(device),
                                          pool_gts[idx].to(device), prior.to(device))


def eval_rollout(env_params, policy, states, h0, n_steps, generator, eps):
    """Roll ``n_steps`` steps of every world with ``policy(obs, h) -> (q, h')``
    choosing epsilon-greedy actions; returns the episode statistics [W]."""
    n_w, n_act = h0.shape[0], env_params.n_actions
    device = h0.device
    h = h0
    for _ in range(n_steps):
        obs = torch_env.get_obs(env_params, states)
        q, h = policy(obs, h)
        greedy = q.argmax(-1)                                   # [W, A]
        rand = torch.randint(0, n_act, tuple(greedy.shape), generator=generator)
        explore = torch.rand((n_w, 1), generator=generator) < eps
        acts = torch.where(explore.to(device), rand.to(device), greedy)
        states, _, _, _ = torch_env.step(env_params, states, acts)
    return dict(TestEpRet=states.ep_ret, TestFairIdx=states.fair_idx,
                TestAvgGlobalUtility=states.avg_global_util,
                TestTotalThroughput=states.total_throughput,
                TestProbCollision=states.n_colls / torch.clamp(
                    states.t.to(torch.float32), min=1))


def evaluate_policy(env_params, policy, pool, hidden_size, generator, n_episodes,
                    device, eps=0.05):
    """``n_episodes`` parallel test episodes from pool layouts; stat tensors [W]."""
    states = reset_worlds(env_params, pool, generator, n_episodes, device)
    h0 = torch.zeros((n_episodes, env_params.n_ubs, hidden_size), device=device)
    return eval_rollout(env_params, policy, states, h0, env_params.episode_limit,
                        generator, eps)
