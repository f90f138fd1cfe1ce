"""Fused MADRQN training on the device (counterpart of ``algos/madrqn/fused.py``).

An iteration runs ``interleave`` sub-iterations of [collect ``n_worlds/S``
episodes on the device -> write them into the device replay ring -> ``K/S``
updates, each on B chunks drawn with replacement from the ring]. Experience,
ring and updates stay on the device. Every random draw (resets,
exploration, sample indices) comes from one CPU ``torch.Generator`` in a
fixed order, so a seed gives the same run on the CPU and on the card.

The iteration runs as programs (JAX jits it whole, ``_iter_jit`` and
``_collect_jit``, ``fused.py:124-125``): with ``graphs`` (the default) each
collection, its ring write included, is one ``graphs.Program`` (on the card
a CUDA graph for each number of worlds) and each update another (the
learner's, gathering its batch from the ring by slot index). Before each
collection's replay the host makes all of its draws (``collect.draw_episode``,
the eager path's calls in its order) and hands them over in one copy; before
a sub-iteration's updates it draws their ``[K/S, B]`` sample indices, and
before each update the learner draws its noise. The test episodes are
``collect.EpisodeProgram``. The eager path (``graphs=False``) makes the same
draws as it goes and gives the same bits.

``mesh`` (a ``DeviceMesh`` of ``parallel.mesh.make_mesh``; JAX
``fused.py:97-119``) shards the whole loop over ``dp``: rank r collects its
block of each collection's worlds, keeps them in its shard of the ring
(``algos/buffer.py:RingShard``) and trains on its rows of each batch, the
learner distributed (``parallel.mesh.distribute_learner``). Every rank
advances the generator exactly as the single-rank trainer does (it draws the
full-size tensors and keeps its rows), so the dp trainer reproduces the
single-rank one; the metrics are means over every rank's worlds, and the
test episodes run whole on every rank. JAX jits this loop whole with XLA's
collectives inside; a capture holds none, so on the program path the host
runs each collective between two replays: the rank's collection is one
program over its block (its ring rows written at its local slots), a
sub-iteration's batches are fetched by one fill program and one all-reduce
(``DeviceRing._fetched``), and each update is the learner's gradient
program, the dp all-reduce and its step program. The metrics' all-reduce
(:meth:`_means`) is the iteration's one host sync.

Under ``o='mlp'`` the policy and the ring see the flat observation
``[agent | gt | ubs]`` per agent (and the talk graph), as the JAX trainer's
``_agent_apply`` and ``_collect`` flatten it; the ring is sized from it.

Memory: the ring holds ``capacity_chunks`` episodes; at exp3 8-UBS that is
about 0.5 MB per chunk, 2.5 GB at 5000 chunks.
"""

from types import SimpleNamespace as SN

import torch

from uav_bs_ctrl_tpu_torch import graphs as programs
from uav_bs_ctrl_tpu_torch.algos import collect
from uav_bs_ctrl_tpu_torch.algos.buffer import DeviceRing, RingShard, tree_map
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import DEFAULT_CONFIG, check_args_sanity
from uav_bs_ctrl_tpu_torch.envs import torch_env
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
                 updates_per_iter=None, n_layouts=64, seed=0, interleave=1, mesh=None,
                 graphs=True):
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
        self.learner = MultiAgentQLearner(env_info, args, seed=seed, graphs=graphs)
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
        self.graphs = graphs
        if self.graphs:
            self._pool = collect.pool_on(self.pool, self.device)
            self._collection = programs.Program(self._collect_body, self.device,
                                                name="collection")
            self._episodes = collect.EpisodeProgram(self.env_params, self.policy,
                                                    self.test_pool, args.hidden_size,
                                                    self.device, self._noise_shape)

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
        return self._ring_form(chunk), stats

    def _ring_form(self, chunk):
        """A collected chunk as the ring holds it: the flat observation under
        ``o='mlp'``, the agents' mean reward with ``share_reward``."""
        if self.args.o == "mlp":
            chunk["obs"] = collect.flatten_obs(chunk["obs"])
        if self.learner.share_reward:
            chunk["rew"] = chunk["rew"].mean(-1, keepdim=True)
        return chunk

    def _noise_shape(self, n_worlds):
        return self.learner.net.noise_shape((n_worlds,), self.env_params.n_ubs)

    # ------------------------------------------------------------------ #
    # The programs

    def _chunk_layout(self):
        """Each ring leaf's per-chunk shape and dtype, read off one world's
        initial state on the host (nothing drawn, no env step taken)."""
        p, T, A = self.env_params, self.T, self.env_params.n_ubs
        state = torch_env.initial_state(p, torch.zeros((1, A, 2)), torch.zeros((1, p.n_gts, 2)),
                                        torch.arange(p.n_gts)[None])
        obs = torch_env.get_obs(p, state)
        if self.args.o == "mlp":
            obs = collect.flatten_obs(obs)
        f32 = torch.float32
        return dict(obs={k: ((T + 1,) + tuple(v.shape[1:]), v.dtype) for k, v in obs.items()},
                    h=((2, A, self.args.hidden_size), f32),
                    state=((T + 1, torch_env.get_state_vec(p, state).shape[-1]), f32),
                    act=((T, A), torch.int32),
                    rew=((T, 1 if self.learner.share_reward else A), f32),
                    done=((T,), f32))

    def _collect_replayed(self, eps, n_worlds):
        """One collection of ``n_worlds`` episodes into the ring, as a
        program: the ring's books kept and every draw made on the host, then
        the replay; returns its stats [W] (cloned; a sharded ring's rank:
        its block's)."""
        if self.replay is None:
            self._make_ring(self._chunk_layout())
        rows = None if self.ring_shard is None else self.ring_shard.rows(n_worlds)
        slots = self._claim(n_worlds)
        draws, noise = collect.draw_episode(self.env_params, len(self.pool[0]),
                                            self.generator, n_worlds, eps,
                                            self._noise_shape(n_worlds), self.device, slots,
                                            rows)
        return programs.clone_tree(self._collection(draws, noise))

    @torch.no_grad()
    def _collect_body(self, draws, noise):
        """The collection program: the episodes on ``draws``, written into
        the ring at their slots; returns the episode stats."""
        chunk, stats, slots = collect.collect_on_draws(self.env_params, self.policy,
                                                       self._pool, self.args.hidden_size,
                                                       draws, noise)
        self._write_slots(self._ring_form(chunk), slots)
        return stats

    def _ring_update_body(self, idx, noise):
        """The update program: the batch at ring slots ``idx`` [B], then the
        learner's update body."""
        batch = tree_map(lambda store: store[idx], self.replay)
        return self.learner._update_body(batch, noise, True)

    def _run_programs(self, eps, warmup):
        """:meth:`run_iteration` as programs; one host sync, for the metrics.
        On a sharded ring each sub-iteration's batches are fetched in one go
        and each update is the sharded learner's (its programs and
        collectives)."""
        if warmup:
            return self._means(self._collect_replayed(eps, self.n_worlds))
        sub_worlds = self.n_worlds // self.interleave
        k_sub = self.updates_per_iter // self.interleave
        learner = self.learner
        losses, all_stats = [], []
        for _ in range(self.interleave):
            all_stats.append(self._collect_replayed(eps, sub_worlds))
            rows = self._draw_rows(k_sub)                                      # [K/S, B]
            if self.ring_shard is not None:
                for batch in self._fetched(rows):
                    losses.append(learner.update_on_batch(batch)["LossQ"])
                continue
            update = learner.program("ring", self._ring_update_body)
            for k in range(k_sub):
                noise = learner.draw_noise_for(learner.batch_size, self.env_params.n_ubs)
                losses.append(learner.replay_update(update, rows[k], noise)["LossQ"])
        stats = {k: torch.cat([s[k] for s in all_stats])
                 for k in ("EpRet", "FairIdx", "AvgGlobalUtility")}
        self.last_losses = torch.stack(losses)
        return self._means(stats, self.last_losses)

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def evaluate(self, n_episodes=8, eps=0.05):
        """Test episodes on held-out layouts (the reference's test_agent)."""
        if self.graphs:
            stats = self._episodes(self.generator, n_episodes, eps)
        else:
            stats = collect.evaluate_policy(self.env_params, self.policy, self.test_pool,
                                            self.args.hidden_size, self.generator,
                                            n_episodes, self.device, eps)
        return {k: v.cpu().numpy() for k, v in stats.items()}

    def run_iteration(self, eps, warmup=False):
        """One iteration; returns host-side metric floats. ``warmup=True``
        collects ``n_worlds`` episodes into the ring without updating."""
        if self.graphs:
            return self._run_programs(eps, warmup)
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
        return self._means(stats, self.last_losses)
