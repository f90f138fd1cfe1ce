"""Rollouts of the single-UBS env on the device (counterpart of
``algos/collect_subs.py``, the exp1 path).

Episodes run W worlds at once with joint epsilon-greedy exploration, one draw
a world a step (``collect._act``; random draws from a CPU ``torch.Generator``,
so one seed gives the same draws on the CPU and on the card). The DRQN regime
trains on ``max_seq_len`` (L) steps, shorter than the T-step episode, so
:func:`collect_episode_subs` slices each episode into T // L replay chunks
whose hidden-state pairs are taken at each slice's first two steps, which is
what the reference's per-step ``cache()`` into its chunking buffer stores.
Episodes end only by timeout, so the stored ``done`` is identically zero.

The programs (JAX jits ``collect_episode_subs`` and ``eval_rollout_subs``,
``collect_subs.py:55``, ``:128``): ``collect.draw_episode`` makes an
episode's draws at A = 1 in :func:`reset_subs_worlds`' and ``collect._act``'s
order (the layout index, the priority draws, then each step's random action
and coin; neither exp1 agent reads a key), and :func:`collect_on_draws` and
:func:`episode_body` play the episode on them, the layouts gathered from the
pool on the device, so a ``graphs.Program`` of either draws nothing and gives
the eager episode's bits (``algos/drqn/fused.py``, ``serve.py``).
"""

import numpy as np
import torch

from uav_bs_ctrl_tpu_torch.algos.collect import _act_on, _DrawAsYouGo, _DrawnBefore, unpack_draws
from uav_bs_ctrl_tpu_torch.envs import torch_env_subs


def make_subs_layout_pool(n_layouts, seed=0, **env_kwargs):
    """GT layouts from the NumPy env's own generator, ``np.random`` seeded
    with ``seed`` and restored after: ``(pos_ubs [2], pos_gts [L, M, 2])``.
    The UBS always starts at the region's centre; only the GTs vary."""
    params = torch_env_subs.make_params(**env_kwargs)
    rng_state = np.random.get_state()
    np.random.seed(seed)
    layouts = [torch_env_subs.set_position(params) for _ in range(n_layouts)]
    np.random.set_state(rng_state)
    return layouts[0][0], np.stack([gts for _, gts in layouts])


def reset_subs_worlds(params, pool, generator, n_worlds, device):
    """Reset ``n_worlds`` worlds from random pool layouts, each with a random
    GT priority permutation."""
    pos_ubs, pool_gts = (torch.as_tensor(a) for a in pool)
    idx = torch.randint(0, pool_gts.shape[0], (n_worlds,), generator=generator)
    prior = torch.argsort(torch.rand((n_worlds, params.n_gts), generator=generator), dim=-1)
    return torch_env_subs.reset_from_positions(
        params, pos_ubs.expand(n_worlds, 2).to(device), pool_gts[idx].to(device),
        prior.to(device))


def flatten_obs(obs):
    """``RnnAgent``'s flat observation ``{"agent": [..., 1, 2 + 4M]}``: the UBS
    position, then the GT rows laid end to end (JAX ``drqn/fused.py:82-88``)."""
    lead = tuple(obs["agent"].shape[:-1])
    return {"agent": torch.cat([obs["agent"], obs["gt"].reshape(lead + (-1,))], -1)}


def make_policy(net, agent):
    """``net`` (an agent, or a learner's ``_apply_net``) as a rollout policy on
    the env's obs: as it is for the 'gnn' agent, on :func:`flatten_obs` of the
    obs for 'rnn'."""
    if agent == "gnn":
        return net

    def policy(obs, h, use_kernels=True, key=None):
        return net(flatten_obs(obs), h, use_kernels, key)
    return policy


def episode_stats(states, prefix=""):
    return {f"{prefix}EpRet": states.ep_ret, f"{prefix}FairIdx": states.fair_idx,
            f"{prefix}AvgGlobalUtility": states.avg_global_util,
            f"{prefix}TotalThroughput": states.total_throughput}


def collect_episode_subs(env_params, policy, states, h0, T, L, generator, eps):
    """Roll one T-step episode of every world and slice it into T // L chunks.

    Returns ``(chunks, final_states, stats)``, the chunk leaves ``[W * S, ...]``
    (S = T // L slices, world-major) in the replay layout: ``obs`` dict of
    [W*S, L+1, 1, ...] (slice i covers steps iL .. (i+1)L, the last the
    next obs), ``h`` [W*S, 2, 1, H] (h at steps iL and iL+1), ``act``
    [W*S, L, 1] int32, ``rew`` [W*S, L, 1] and ``done`` [W*S, L].
    """
    return _collect(env_params, policy, states, h0, T, L,
                    _DrawAsYouGo(generator, eps, env_params.n_actions))


def _collect(env_params, policy, states, h0, T, L, draws):
    if T % L:
        raise ValueError(f"episode_limit {T} must be a multiple of max_seq_len {L}")
    n_slices = T // L
    obs_seq, h_seq, acts_seq, rew_seq, done_seq = [], [], [], [], []
    h = h0
    obs = torch_env_subs.get_obs(env_params, states)
    for t in range(T):
        obs_seq.append(obs)
        h_seq.append(h)
        acts, h = _act_on(policy, obs, h, draws, t)                           # [W, 1]
        states, obs, rew, done = torch_env_subs.step(env_params, states, acts[:, 0])
        acts_seq.append(acts)
        rew_seq.append(rew[:, None])
        done_seq.append(done)
    obs_seq.append(obs)
    h_seq.append(h)

    dev = h0.device
    t0 = torch.arange(n_slices, device=dev) * L
    idx_seq = t0[:, None] + torch.arange(L + 1, device=dev)            # [S, L+1]
    idx_h = t0[:, None] + torch.arange(2, device=dev)                  # [S, 2]

    def slice_seq(seq, idx):                       # T+1 steps -> [W*S, idx width, ...]
        full = torch.stack(seq, 1)[:, idx]
        return full.reshape((-1,) + tuple(full.shape[2:]))

    def slice_step(seq):                           # T steps -> [W*S, L, ...]
        full = torch.stack(seq, 1)
        return full.reshape((full.shape[0] * n_slices, L) + tuple(full.shape[2:]))

    raw_done = slice_step(done_seq).to(torch.float32)
    chunks = dict(obs={k: slice_seq([o[k] for o in obs_seq], idx_seq) for k in obs_seq[0]},
                  h=slice_seq(h_seq, idx_h), act=slice_step(acts_seq).to(torch.int32),
                  rew=slice_step(rew_seq), done=raw_done * (1.0 - raw_done))
    return chunks, states, episode_stats(states)


def eval_rollout_subs(env_params, policy, states, h0, T, generator, eps):
    """Roll T steps of every world epsilon-greedily; the episode statistics [W]."""
    return _play(env_params, policy, states, h0, T,
                 _DrawAsYouGo(generator, eps, env_params.n_actions))


def _play(env_params, policy, states, h0, T, draws):
    h = h0
    obs = torch_env_subs.get_obs(env_params, states)
    for t in range(T):
        acts, h = _act_on(policy, obs, h, draws, t)
        states, obs, _, _ = torch_env_subs.step(env_params, states, acts[:, 0])
    return episode_stats(states, "Test")


def evaluate_policy_subs(env_params, policy, pool, hidden_size, generator, n_episodes,
                         device, eps=0.05):
    """``n_episodes`` parallel test episodes from pool layouts (the reference
    drqn ``test_agent`` at eps 0.05); stat tensors [W]."""
    states = reset_subs_worlds(env_params, pool, generator, n_episodes, device)
    h0 = torch.zeros((n_episodes, 1, hidden_size), device=device)
    return eval_rollout_subs(env_params, policy, states, h0, env_params.episode_limit,
                             generator, eps)


# --------------------------------------------------------------------------- #
# Episodes as programs (JAX jits ``collect_episode_subs`` and
# ``eval_rollout_subs``): ``collect.draw_episode``'s draws at A = 1, made
# first, then the episode on them.

def reset_on_draws(env_params, pool, d):
    """The worlds of unpacked draws ``d`` from ``pool``, a pair of device
    tensors (pos_ubs [2], gts [P, M, 2]): :func:`reset_subs_worlds`'s states."""
    pos_ubs, pool_gts = pool
    return torch_env_subs.reset_from_positions(
        env_params, pos_ubs.expand(d.idx.shape[0], 2), pool_gts[d.idx], d.prior)


def collect_on_draws(env_params, policy, pool, hidden_size, L, draws, noise):
    """:func:`reset_subs_worlds` and :func:`collect_episode_subs` of one
    episode on ``collect.draw_episode``'s draws (the eager pair's bits);
    returns ``(chunks, stats, slots)``, the slots [W * S] world-major."""
    d = unpack_draws(draws, env_params)
    h0 = torch.zeros((draws.shape[0], 1, hidden_size), device=draws.device)
    chunks, _, stats = _collect(env_params, policy, reset_on_draws(env_params, pool, d), h0,
                                env_params.episode_limit, L,
                                _DrawnBefore(d.rand, d.explore, noise))
    return chunks, stats, d.slot


def episode_body(env_params, policy, pool, hidden_size, draws, noise):
    """:func:`evaluate_policy_subs` on ``collect.draw_episode``'s draws: its
    stats [W] (the body of exp1's ``collect.EpisodeProgram``)."""
    d = unpack_draws(draws, env_params)
    h0 = torch.zeros((draws.shape[0], 1, hidden_size), device=draws.device)
    return _play(env_params, policy, reset_on_draws(env_params, pool, d), h0,
                 env_params.episode_limit, _DrawnBefore(d.rand, d.explore, noise))
