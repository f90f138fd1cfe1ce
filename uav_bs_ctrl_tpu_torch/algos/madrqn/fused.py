"""Fused MADRQN training on the device (counterpart of ``algos/madrqn/fused.py``).

An iteration runs ``interleave`` sub-iterations of [collect ``n_worlds/S``
episodes on the device -> write them into the device replay ring -> ``K/S``
updates, each on B chunks drawn with replacement from the ring]. Experience,
ring and updates stay on the device; the host schedules and makes the random
draws, from one CPU ``torch.Generator`` (resets, exploration, sample
indices) moved to the device, so a seed gives the same run on the CPU and on
the card.

``mesh`` (a ``DeviceMesh`` of ``parallel.mesh.make_mesh``; JAX
``fused.py:97-119``) shards the whole loop over ``dp``: rank r collects its
block of each collection's worlds, keeps them in its shard of the ring
(``algos/buffer.py:RingShard``) and trains on its rows of each batch, the
learner distributed (``parallel.mesh.distribute_learner``). Every rank
advances the generator exactly as the single-rank trainer does (it draws the
full-size tensors and keeps its rows), so the dp trainer reproduces the
single-rank one; the metrics are means over every rank's worlds, and the
test episodes run whole on every rank.

Under ``o='mlp'`` the policy and the ring see the flat observation
``[agent | gt | ubs]`` per agent (and the talk graph), as the JAX trainer's
``_agent_apply`` and ``_collect`` flatten it; the ring is sized from it.

Memory: the ring holds ``capacity_chunks`` episodes; at exp3 8-UBS that is
about 0.5 MB per chunk, 2.5 GB at 5000 chunks.
"""

from types import SimpleNamespace as SN

import torch

from uav_bs_ctrl_tpu_torch.algos import collect
from uav_bs_ctrl_tpu_torch.algos.buffer import DeviceRing, RingShard
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import DEFAULT_CONFIG, check_args_sanity
from uav_bs_ctrl_tpu_torch.envs import torch_env
from uav_bs_ctrl_tpu_torch.parallel.dist import all_reduce
from uav_bs_ctrl_tpu_torch.parallel.mesh import distribute_learner


def obs_shape(env_params, o):
    """The agent's obs shape on the env's fair-service observations: per-slot
    feature widths for the GNN encoder (the flag column of a GT or UBS row is
    its mask), the flat width ``2 + M (1 + 4) + (N - 1)(1 + 2)`` for the MLP
    one (JAX ``fused.py:69-73``)."""
    if o == "gnn":
        return dict(agent=2, gt=4, ubs=2)
    return 2 + env_params.n_gts * 5 + (env_params.n_ubs - 1) * 3


def state_shape(env_params):
    """The global state's width: UBS positions, and per GT position, rate and
    average rate (JAX ``fused.py:74-75``)."""
    return env_params.n_ubs * 2 + env_params.n_gts * 4


class FusedMadrqnTrainer(DeviceRing):
    """Device-resident replay ring + on-device collection and updates."""

    def __init__(self, map_id, train_kwargs=None, n_worlds=16, capacity_chunks=256,
                 updates_per_iter=None, n_layouts=64, seed=0, interleave=1, mesh=None):
        cfg = dict(DEFAULT_CONFIG)
        cfg.update(train_kwargs or {})
        self.args = args = check_args_sanity(SN(**cfg))
        self.device = args.device

        self.env_params = torch_env.make_params(map_id)
        self.T = self.env_params.episode_limit
        args.max_seq_len = None            # chunk == episode

        if capacity_chunks % n_worlds:
            raise ValueError("capacity_chunks must be a multiple of n_worlds "
                             "(the ring's write stride)")
        self.n_worlds = n_worlds
        self.capacity = capacity_chunks
        self.updates_per_iter = updates_per_iter or n_worlds
        if n_worlds % interleave or self.updates_per_iter % interleave:
            raise ValueError("interleave must divide n_worlds and updates_per_iter")
        self.interleave = interleave

        env_info = dict(obs_shape=obs_shape(self.env_params, args.o),
                        state_shape=state_shape(self.env_params),
                        n_actions=self.env_params.n_actions, n_agents=self.env_params.n_ubs,
                        episode_limit=self.T)
        self.learner = MultiAgentQLearner(env_info, args, seed=seed)
        # Collection and test episodes at the compute dtype (JAX ``_agent_apply``).
        self.policy = collect.make_policy(self.learner._apply_net, args.o)

        self.pool = collect.make_layout_pool(map_id, n_layouts, seed=seed)
        self.test_pool = collect.make_layout_pool(map_id, n_layouts, seed=seed + 10_000)
        self.generator = torch.Generator().manual_seed(seed)
        self.replay = None                 # tree of [capacity, ...] device tensors
        self.last_losses = None            # LossQ of each update of the last iteration
        self._ptr = 0
        self._size = 0
        if mesh is not None:
            names = mesh.mesh_dim_names
            dp = mesh.size(names.index("dp"))
            assert n_worlds % dp == 0 and (n_worlds // interleave) % dp == 0, \
                f"n_worlds={n_worlds} and its sub-iterations must divide by dp={dp}"
            assert capacity_chunks % dp == 0, \
                f"capacity_chunks={capacity_chunks} must be divisible by dp={dp}"
            distribute_learner(self.learner, mesh)
            self.ring_shard = RingShard(capacity_chunks, dp, mesh.get_local_rank("dp"),
                                        mesh.get_group("dp"))

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _collect(self, eps, n_worlds):
        rows = None if self.ring_shard is None else self.ring_shard.rows(n_worlds)
        states = collect.reset_worlds(self.env_params, self.pool, self.generator, n_worlds,
                                      self.device, rows)
        n_local = n_worlds if rows is None else rows[1] - rows[0]
        h0 = torch.zeros((n_local, self.env_params.n_ubs, self.args.hidden_size),
                         device=self.device)
        chunk, _, stats = collect.collect_chunk(self.env_params, self.policy, states, h0,
                                                self.T, self.generator, eps, rows)
        if self.args.o == "mlp":
            chunk["obs"] = collect.flatten_obs(chunk["obs"])
        if self.learner.share_reward:
            chunk["rew"] = chunk["rew"].mean(-1, keepdim=True)
        return chunk, stats

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def evaluate(self, n_episodes=8, eps=0.05):
        """Test episodes on held-out layouts (the reference's test_agent)."""
        stats = collect.evaluate_policy(self.env_params, self.policy, self.test_pool,
                                        self.args.hidden_size, self.generator, n_episodes,
                                        self.device, eps)
        return {k: v.cpu().numpy() for k, v in stats.items()}

    def run_iteration(self, eps, warmup=False):
        """One iteration; returns host-side metric floats. ``warmup=True``
        collects ``n_worlds`` episodes into the ring without updating."""
        if warmup:
            chunk, stats = self._collect(eps, self.n_worlds)
            self._write(chunk)
            return self._means(stats)
        sub_worlds = self.n_worlds // self.interleave
        k_sub = self.updates_per_iter // self.interleave
        losses, all_stats = [], []
        for _ in range(self.interleave):
            chunk, stats = self._collect(eps, sub_worlds)
            self._write(chunk)
            all_stats.append(stats)
            for _ in range(k_sub):
                losses.append(self.learner.update_on_batch(self.sample_batch())["LossQ"])
        stats = {k: torch.cat([s[k] for s in all_stats])
                 for k in ("EpRet", "FairIdx", "AvgGlobalUtility")}
        self.last_losses = torch.stack(losses)
        return dict(LossQ=float(self.last_losses.mean()), **self._means(stats))

    def _means(self, stats):
        """Each stat's mean over the worlds (every rank's on a sharded ring)."""
        if self.ring_shard is None:
            return {k: float(v.mean()) for k, v in stats.items()}
        sums = all_reduce(torch.stack([v.sum() for v in stats.values()]),
                          self.ring_shard.group)
        n = next(iter(stats.values())).numel() * self.ring_shard.dp
        return {k: float(v / n) for k, v in zip(stats, sums)}
