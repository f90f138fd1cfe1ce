"""Fused DRQN training on the device (counterpart of ``algos/drqn/fused.py``, exp1).

An iteration collects one T-step episode on ``n_worlds`` worlds, slices it
into the ``max_seq_len`` (L) replay chunks (``collect_subs``), writes them
into the device ring and runs ``updates_per_iter`` updates, each on B chunks
drawn with replacement from the ring: by default one update per L env
steps, the reference drqn driver's cadence (``updates_per_iter =
n_worlds * T / L``). The ring holds ``replay_size`` chunks rounded down to a
multiple of an iteration's; at the committed exp1 config (40 worlds, L = 10,
M = 20 GTs) that is 49,600 chunks of about 5.7 KB, some 280 MB. The layout
pools use seeds ``seed`` and ``seed + 10_000``; the host makes the random
draws from one CPU ``torch.Generator`` seeded with ``seed``.

The 'rnn' agent's policy and ring see the flat observation ``[agent | gt]``
(``collect_subs.flatten_obs``), as the JAX trainer's ``_agent_apply`` and
``_collect``.
"""

from types import SimpleNamespace as SN

import torch

from uav_bs_ctrl_tpu_torch.algos import collect_subs
from uav_bs_ctrl_tpu_torch.algos.buffer import DeviceRing
from uav_bs_ctrl_tpu_torch.algos.drqn.config import DEFAULT_CONFIG, check_args
from uav_bs_ctrl_tpu_torch.algos.drqn.learner import QLearner
from uav_bs_ctrl_tpu_torch.envs import torch_env_subs


def obs_shape(env_params, agent):
    """Per-slot widths for the 'gnn' agent, the flat width ``2 + 4M`` for 'rnn'
    (JAX ``fused.py:50-53``)."""
    if agent == "gnn":
        return dict(agent=2, gt=4)
    return 2 + env_params.n_gts * 4


class FusedDrqnTrainer(DeviceRing):
    """Device replay ring + on-device collection and updates (exp1)."""

    def __init__(self, env_kwargs=None, train_kwargs=None, n_worlds=8, capacity_chunks=None,
                 updates_per_iter=None, n_layouts=256, seed=0):
        cfg = dict(DEFAULT_CONFIG)
        cfg.update(train_kwargs or {})
        self.args = args = check_args(SN(**cfg))
        self.device = args.device
        env_kwargs = dict(env_kwargs or {})

        self.env_params = torch_env_subs.make_params(**env_kwargs)
        self.T = self.env_params.episode_limit
        self.L = args.max_seq_len if args.max_seq_len is not None else self.T
        if self.T % self.L:
            raise ValueError(f"episode_limit {self.T} must be a multiple of max_seq_len {self.L}")
        self.n_slices = self.T // self.L
        self.n_worlds = n_worlds
        self.chunks_per_iter = n_worlds * self.n_slices
        self.updates_per_iter = updates_per_iter or self.chunks_per_iter

        env_info = dict(obs_shape=obs_shape(self.env_params, args.agent),
                        n_actions=self.env_params.n_actions, episode_limit=self.T)
        self.learner = QLearner(env_info, args, seed=seed)
        # Collection and test episodes at the compute dtype (JAX ``_agent_apply``).
        self.policy = collect_subs.make_policy(self.learner._apply_net, args.agent)

        capacity = capacity_chunks or args.replay_size
        capacity -= capacity % self.chunks_per_iter
        if capacity <= 0:
            raise ValueError(f"a ring of {capacity_chunks or args.replay_size} chunks holds no "
                             f"iteration of {self.chunks_per_iter}")
        self.capacity = capacity

        self.pool = collect_subs.make_subs_layout_pool(n_layouts, seed=seed, **env_kwargs)
        self.test_pool = collect_subs.make_subs_layout_pool(
            n_layouts, seed=seed + 10_000, **env_kwargs)
        self.generator = torch.Generator().manual_seed(seed)
        self.replay = None                 # tree of [capacity, ...] device tensors
        self.last_losses = None            # LossQ of each update of the last iteration
        self._ptr = 0
        self._size = 0

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _collect(self, eps):
        states = collect_subs.reset_subs_worlds(self.env_params, self.pool, self.generator,
                                                self.n_worlds, self.device)
        h0 = torch.zeros((self.n_worlds, 1, self.args.hidden_size), device=self.device)
        chunks, _, stats = collect_subs.collect_episode_subs(
            self.env_params, self.policy, states, h0, self.T, self.L, self.generator, eps)
        if self.args.agent != "gnn":
            chunks["obs"] = collect_subs.flatten_obs(chunks["obs"])
        return chunks, stats

    @torch.no_grad()
    def evaluate(self, n_episodes=5, eps=0.05):
        """Test episodes on held-out layouts (the reference drqn ``test_agent``)."""
        stats = collect_subs.evaluate_policy_subs(
            self.env_params, self.policy, self.test_pool, self.args.hidden_size,
            self.generator, n_episodes, self.device, eps)
        return {k: v.cpu().numpy() for k, v in stats.items()}

    def run_iteration(self, eps, warmup=False):
        """One iteration; returns host-side metric floats. ``warmup=True``
        collects the episode into the ring without updating."""
        chunks, stats = self._collect(eps)
        self._write(chunks)
        if warmup:
            return {k: float(v.mean()) for k, v in stats.items()}
        self.last_losses = torch.stack([self.learner.update_on_batch(self.sample_batch())["LossQ"]
                                        for _ in range(self.updates_per_iter)])
        metrics = dict(LossQ=self.last_losses.mean(), EpRet=stats["EpRet"].mean(),
                       FairIdx=stats["FairIdx"].mean(),
                       AvgGlobalUtility=stats["AvgGlobalUtility"].mean())
        return {k: float(v) for k, v in metrics.items()}
