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

The programs (JAX jits ``collect_chunk`` and ``eval_rollout``,
``collect.py:55``, ``:117``): :func:`draw_episode` makes every draw of one
episode up front, by the eager path's calls in its order (:func:`draw_reset`,
then each step's :func:`draw_seed` when the policy reads a key and
:func:`draw_explore`), into one ``[W, K]`` int64 tensor, and the steps'
Gumbel noise from their seeds on the device; :func:`episode_body` plays the
episode on them (the layouts gathered from a pool on the device), so a
``graphs.Program`` of it draws nothing and gives the eager episode's bits.
:class:`EpisodeProgram` is ``evaluate_policy`` so; the fused trainer's
collection is one too (``algos/madrqn/fused.py``).
"""

from types import SimpleNamespace

import numpy as np
import torch

from uav_bs_ctrl_tpu_torch import graphs
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


def draw_reset(n_gts, n_layouts, generator, n_worlds):
    """A reset's draws: each world's pool layout [W], then its GT priority
    permutation [W, M] (the argsort, on the host, of uniform draws)."""
    idx = torch.randint(0, n_layouts, (n_worlds,), generator=generator)
    prior = torch.argsort(torch.rand((n_worlds, n_gts), generator=generator), dim=-1)
    return idx, prior


def draw_seed(generator):
    """A step's policy key: a seed for the Gumbel noise of that step."""
    return int(torch.randint(0, 2**62, (), generator=generator))


def draw_explore(generator, shape, n_actions, eps):
    """A step's exploration: random actions of ``shape`` ([W, A]), then one
    coin a world, True (explore) below ``eps``."""
    rand = torch.randint(0, n_actions, shape, generator=generator)
    explore = torch.rand((shape[0], 1), generator=generator) < eps
    return rand, explore


def reset_worlds(params, pool, generator, n_worlds, device, rows=None):
    """Reset ``n_worlds`` worlds from random pool layouts, each with a random
    GT priority permutation (with ``rows``, worlds ``[lo, hi)`` of them)."""
    pool_ubs, pool_gts = (torch.as_tensor(a) for a in pool)
    idx, prior = draw_reset(params.n_gts, pool_ubs.shape[0], generator, n_worlds)
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
            self._seed = draw_seed(self._generator)
        return self._seed

    def noise(self, shape, device):
        if self._rows is None:
            return gumbel_noise(shape, int(self), device)
        lo, hi, total = self._rows
        return gumbel_noise((total,) + tuple(shape[1:]), int(self), device)[lo:hi]


class DrawnKey:
    """One step's policy key in a program: the Gumbel noise drawn before the
    replay from the step's seed (what ``StepKey.noise`` draws), or None when
    the policy reads no key (reading it then raises)."""

    def __init__(self, noise):
        self._noise = noise

    def noise(self, shape, device):
        if self._noise is None:
            raise RuntimeError("the policy reads a key, and no noise was drawn for it: give "
                               "the program the shape of one step's noise")
        if tuple(shape) != tuple(self._noise.shape):
            raise ValueError(f"the step reads noise of shape {tuple(shape)}, drawn "
                             f"{tuple(self._noise.shape)}")
        return self._noise

    def __int__(self):
        raise RuntimeError("a program draws nothing: its policy reads the noise drawn "
                           "before the replay (key.noise), not a seed")


class _DrawAsYouGo:
    """The eager path's draws: each made from ``generator`` as the step runs."""

    def __init__(self, generator, eps, n_actions, rows=None):
        self.generator, self.eps, self.n_actions, self.rows = generator, eps, n_actions, rows

    def key(self, t):
        return StepKey(self.generator, self.rows)

    def choose(self, t, greedy):
        n = greedy.shape[0] if self.rows is None else self.rows[2]
        rand, explore = draw_explore(self.generator, (n,) + tuple(greedy.shape[1:]),
                                     self.n_actions, self.eps)
        if self.rows is not None:
            lo, hi = self.rows[:2]
            rand, explore = rand[lo:hi], explore[lo:hi]
        return torch.where(explore.to(greedy.device), rand.to(greedy.device), greedy)


class _DrawnBefore:
    """A program's draws, made before it runs: ``rand`` [T, W, A] and
    ``explore`` [T, W, 1] on the device, ``noise`` [T, ...] or None."""

    def __init__(self, rand, explore, noise):
        self.rand, self.explore, self.noise = rand, explore, noise

    def key(self, t):
        return DrawnKey(None if self.noise is None else self.noise[t])

    def choose(self, t, greedy):
        return torch.where(self.explore[t], self.rand[t], greedy)


def _act(policy, obs, h, generator, eps, n_actions, rows=None):
    """Joint epsilon-greedy actions [W, A] and the next hidden state;
    ``policy(obs, h, key=...)`` gets the step's ``StepKey``."""
    return _act_on(policy, obs, h, _DrawAsYouGo(generator, eps, n_actions, rows), 0)


def _act_on(policy, obs, h, draws, t):
    """Step ``t``'s actions and next hidden state, the policy's key and the
    exploration taken from ``draws``."""
    q, h2 = policy(obs, h, key=draws.key(t))
    return draws.choose(t, q.argmax(-1)), h2                    # [W, A]


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
    return _collect(env_params, policy, states, h0, n_steps,
                    _DrawAsYouGo(generator, eps, env_params.n_actions, rows))


def _collect(env_params, policy, states, h0, n_steps, draws):
    obs_seq, state_seq, h_pair, acts_seq, rew_seq, done_seq = [], [], [h0], [], [], []
    h = h0
    obs = torch_env.get_obs(env_params, states)
    for t in range(n_steps):
        obs_seq.append(obs)
        state_seq.append(torch_env.get_state_vec(env_params, states))
        acts, h = _act_on(policy, obs, h, draws, t)
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
    return _play(env_params, policy, states, h0, n_steps,
                 _DrawAsYouGo(generator, eps, env_params.n_actions))


def _play(env_params, policy, states, h0, n_steps, draws):
    h = h0
    obs = torch_env.get_obs(env_params, states)
    for t in range(n_steps):
        acts, h = _act_on(policy, obs, h, draws, t)
        states, obs, _, _ = torch_env.step(env_params, states, acts)
    return episode_stats(states, "Test")


def evaluate_policy(env_params, policy, pool, hidden_size, generator, n_episodes,
                    device, eps=0.05):
    """``n_episodes`` parallel test episodes from pool layouts; stat tensors [W]."""
    states = reset_worlds(env_params, pool, generator, n_episodes, device)
    h0 = torch.zeros((n_episodes, env_params.n_ubs, hidden_size), device=device)
    return eval_rollout(env_params, policy, states, h0, env_params.episode_limit,
                        generator, eps)


# --------------------------------------------------------------------------- #
# Episodes as programs: the draws made first, then the episode on them.

def n_agents_of(env_params):
    """The agents of a world: the UBSs of the multi-UBS env, 1 for the
    single-UBS (exp1) env, whose params have no ``n_ubs``."""
    return getattr(env_params, "n_ubs", 1)


def draw_steps(generator, n_steps, shape, n_actions, eps, reads_key):
    """Each of ``n_steps`` steps' draws, by the eager path's calls in its
    order: a seed when the policy ``reads_key``, then the random actions of
    ``shape`` ([W, A]) and the coins. Returns ``(rand [W, T, A], explore
    [W, T] bool, seeds)``."""
    seeds, rand, explore = [], [], []
    for _ in range(n_steps):
        if reads_key:
            seeds.append(draw_seed(generator))
        r, e = draw_explore(generator, shape, n_actions, eps)
        rand.append(r)
        explore.append(e)
    return torch.stack(rand, 1), torch.cat(explore, 1), seeds


def draw_episode(env_params, n_layouts, generator, n_worlds, eps, noise_shape, device,
                 slots=None, rows=None):
    """Every draw of one episode of ``n_worlds`` worlds from a pool of
    ``n_layouts``, made by the eager path's calls in its order: the reset's,
    then each step's seed (only when ``noise_shape``, the shape of one step's
    Gumbel noise, is not None: the policy reads a key), random actions and
    coin. Returns ``(draws, noise)``: ``draws`` [W, K] int64 on the host
    (pinned for a CUDA ``device``), each world's row its layout, priority
    permutation, T x A random actions, T coins and, with ``slots`` ([W], or
    [W, S] for S ring chunks a world), its ring slots (:func:`unpack_draws`
    reads them); ``noise`` [T, ...] each step's noise drawn on ``device``
    from its seed, as ``StepKey.noise`` draws it, or None. The single-UBS
    env's episodes (``collect_subs``) draw the same with A = 1.

    With ``rows=(lo, hi, W)`` (``W`` = ``n_worlds``, ``noise_shape`` that of
    the W worlds) every draw is made at the W worlds, as the eager
    ``_DrawAsYouGo`` and ``StepKey`` make them, and worlds ``[lo, hi)`` are
    kept (the noise too); ``slots`` are then the block's."""
    T, A = env_params.episode_limit, n_agents_of(env_params)
    idx, prior = draw_reset(env_params.n_gts, n_layouts, generator, n_worlds)
    rand, explore, seeds = draw_steps(generator, T, (n_worlds, A), env_params.n_actions, eps,
                                      noise_shape is not None)
    lo, hi = (0, n_worlds) if rows is None else rows[:2]
    cols = [idx[lo:hi, None], prior[lo:hi], rand[lo:hi].reshape(hi - lo, T * A),
            explore[lo:hi].to(torch.int64)]
    if slots is not None:
        cols.append(slots.reshape(hi - lo, -1))
    draws = torch.cat(cols, 1)
    if torch.device(device).type == "cuda":
        draws = draws.pin_memory()
    noise = None if noise_shape is None else torch.stack(
        [gumbel_noise(noise_shape, seed, device)[lo:hi] for seed in seeds])
    return draws, noise


def unpack_draws(draws, env_params):
    """:func:`draw_episode`'s draws, on the device: ``idx`` [W], ``prior``
    [W, M], ``rand`` [T, W, A], ``explore`` [T, W, 1] bool and ``slot``
    [W * S], world-major (None without slots)."""
    T, A, M = env_params.episode_limit, n_agents_of(env_params), env_params.n_gts
    n_worlds, o = draws.shape[0], 1 + M + T * A
    return SimpleNamespace(
        idx=draws[:, 0], prior=draws[:, 1:1 + M].contiguous(),
        rand=draws[:, 1 + M:o].reshape(n_worlds, T, A).transpose(0, 1),
        explore=(draws[:, o:o + T] != 0).transpose(0, 1)[..., None],
        slot=draws[:, o + T:].reshape(-1) if draws.shape[1] > o + T else None)


def reset_on_draws(env_params, pool, d):
    """The worlds of unpacked draws ``d``, from ``pool``, a pair of device
    tensors (ubs [P, N, 2], gts [P, M, 2]): :func:`reset_worlds`'s states."""
    return torch_env.reset_from_positions(env_params, pool[0][d.idx], pool[1][d.idx], d.prior)


def collect_on_draws(env_params, policy, pool, hidden_size, draws, noise):
    """:func:`reset_worlds` and :func:`collect_chunk` of one episode on
    :func:`draw_episode`'s draws (the eager pair's bits); returns ``(chunk,
    stats, slots)``."""
    d = unpack_draws(draws, env_params)
    h0 = torch.zeros((draws.shape[0], env_params.n_ubs, hidden_size), device=draws.device)
    chunk, _, stats = _collect(env_params, policy, reset_on_draws(env_params, pool, d), h0,
                               env_params.episode_limit, _DrawnBefore(d.rand, d.explore, noise))
    return chunk, stats, d.slot


def episode_body(env_params, policy, pool, hidden_size, draws, noise):
    """:func:`evaluate_policy` on :func:`draw_episode`'s draws: its stats [W]."""
    d = unpack_draws(draws, env_params)
    h0 = torch.zeros((draws.shape[0], env_params.n_ubs, hidden_size), device=draws.device)
    return _play(env_params, policy, reset_on_draws(env_params, pool, d), h0,
                 env_params.episode_limit, _DrawnBefore(d.rand, d.explore, noise))


def pool_on(pool, device):
    """A layout pool's (ubs, gts) arrays as tensors on ``device``."""
    return tuple(torch.as_tensor(a).to(device) for a in pool)


class EpisodeProgram:
    """:func:`evaluate_policy` as a program (JAX jits ``eval_rollout``):
    ``program(generator, n_episodes, eps)`` makes the episode's draws with
    :func:`draw_episode` and runs :func:`episode_body` on them, a replayed
    CUDA graph on the card (one per ``n_episodes``). ``noise_shape(W)`` is
    the shape of one step's Gumbel noise at W worlds, or None when the
    policy reads no key (an agent's ``noise_shape((W,), n_agents)``). The
    stats are the eager call's, and ``generator`` ends where it would.
    ``body`` plays the episode: :func:`episode_body`, or for exp1's
    single-UBS env ``collect_subs.episode_body`` (its pool ``(pos_ubs [2],
    gts [P, M, 2])``)."""

    def __init__(self, env_params, policy, pool, hidden_size, device, noise_shape,
                 body=episode_body):
        self.env_params, self.policy, self.hidden_size = env_params, policy, hidden_size
        self.device, self.noise_shape, self.body = torch.device(device), noise_shape, body
        self.pool = pool_on(pool, device)
        self.n_layouts = self.pool[1].shape[0]
        self.program = graphs.Program(self._body, device, name="episode")

    def __call__(self, generator, n_episodes, eps=0.05):
        draws, noise = draw_episode(self.env_params, self.n_layouts, generator, n_episodes,
                                    eps, self.noise_shape(n_episodes), self.device)
        return graphs.clone_tree(self.program(draws, noise))

    @torch.no_grad()
    def _body(self, draws, noise):
        return self.body(self.env_params, self.policy, self.pool, self.hidden_size, draws, noise)
