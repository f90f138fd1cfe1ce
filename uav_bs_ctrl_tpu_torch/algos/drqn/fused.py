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

The iteration runs as programs (JAX jits it, ``_iter_jit`` and
``_collect_jit``, ``fused.py:77-78``), as the MADRQN trainer's
(``algos/madrqn/fused.py``): with ``graphs`` (the default) the collection,
its ring write by slot included, is one ``graphs.Program`` (on the card a
CUDA graph) and each update another (the learner's, gathering its batch from
the ring by slot index). Before the collection's replay the host makes all
of its draws (``collect.draw_episode`` at A = 1, the eager path's calls in
its order) and hands them over in one copy; before the updates it draws
their ``[K, B]`` sample indices in one go, in the eager path's order. The
iteration syncs with the host once, for its metrics. The test episodes are
a ``collect.EpisodeProgram`` of ``collect_subs.episode_body``. The eager
path (``graphs=False``) makes the same draws as it goes and gives the same
bits.
"""

from types import SimpleNamespace as SN

import torch

from uav_bs_ctrl_tpu_torch import graphs as programs
from uav_bs_ctrl_tpu_torch.algos import collect, collect_subs
from uav_bs_ctrl_tpu_torch.algos.buffer import DeviceRing, tree_map
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
                 updates_per_iter=None, n_layouts=256, seed=0, graphs=True):
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
        self.learner = QLearner(env_info, args, seed=seed, graphs=graphs)
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
        self.graphs = graphs
        if graphs:
            self._pool = collect.pool_on(self.pool, self.device)
            self._collection = programs.Program(self._collect_body, self.device,
                                                name="collection")
            self._episodes = collect.EpisodeProgram(
                self.env_params, self.policy, self.test_pool, args.hidden_size, self.device,
                self._noise_shape, body=collect_subs.episode_body)

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _collect(self, eps):
        states = collect_subs.reset_subs_worlds(self.env_params, self.pool, self.generator,
                                                self.n_worlds, self.device)
        h0 = torch.zeros((self.n_worlds, 1, self.args.hidden_size), device=self.device)
        chunks, _, stats = collect_subs.collect_episode_subs(
            self.env_params, self.policy, states, h0, self.T, self.L, self.generator, eps)
        return self._ring_form(chunks), stats

    def _ring_form(self, chunks):
        """Collected chunks as the ring holds them: the 'rnn' agent's flat
        observation."""
        if self.args.agent != "gnn":
            chunks["obs"] = collect_subs.flatten_obs(chunks["obs"])
        return chunks

    def _noise_shape(self, n_worlds):
        return self.learner.net.noise_shape((n_worlds,), 1)

    # ------------------------------------------------------------------ #
    # The programs

    def _chunk_layout(self):
        """Each ring leaf's per-chunk shape and dtype, read off one world's
        initial state on the host (nothing drawn, no env step taken)."""
        p, L = self.env_params, self.L
        state = torch_env_subs.reset_from_positions(p, torch.zeros((1, 2)),
                                                    torch.zeros((1, p.n_gts, 2)),
                                                    torch.arange(p.n_gts)[None])
        obs = torch_env_subs.get_obs(p, state)
        if self.args.agent != "gnn":
            obs = collect_subs.flatten_obs(obs)
        f32 = torch.float32
        return dict(obs={k: ((L + 1,) + tuple(v.shape[1:]), v.dtype) for k, v in obs.items()},
                    h=((2, 1, self.args.hidden_size), f32), act=((L, 1), torch.int32),
                    rew=((L, 1), f32), done=((L,), f32))

    def _collect_replayed(self, eps):
        """The iteration's collection into the ring, as a program: the
        ring's books kept and every draw made on the host, then the replay;
        returns its stats [W] (cloned)."""
        if self.replay is None:
            self._make_ring(self._chunk_layout())
        slots = self._claim(self.chunks_per_iter).reshape(self.n_worlds, self.n_slices)
        draws, noise = collect.draw_episode(self.env_params, len(self.pool[1]), self.generator,
                                            self.n_worlds, eps, self._noise_shape(self.n_worlds),
                                            self.device, slots)
        return programs.clone_tree(self._collection(draws, noise))

    @torch.no_grad()
    def _collect_body(self, draws, noise):
        """The collection program: the episode on ``draws``, its chunks
        written into the ring at their slots; returns the episode stats."""
        chunks, stats, slots = collect_subs.collect_on_draws(
            self.env_params, self.policy, self._pool, self.args.hidden_size, self.L, draws,
            noise)
        self._write_slots(self._ring_form(chunks), slots)
        return stats

    def _ring_update_body(self, idx, noise):
        """The update program: the batch at ring slots ``idx`` [B], then the
        learner's update body."""
        batch = tree_map(lambda store: store[idx], self.replay)
        return self.learner._update_body(batch, noise, True)

    def _run_programs(self, eps, warmup):
        """:meth:`run_iteration` as programs; one host sync, for the metrics."""
        stats = self._collect_replayed(eps)
        if warmup:
            return self._means(stats)
        learner = self.learner
        update = learner.program("ring", self._ring_update_body)
        rows = self._draw_rows(self.updates_per_iter)
        losses = [learner.replay_update(update, rows[k],
                                        learner.draw_noise_for(learner.batch_size, 1))["LossQ"]
                  for k in range(self.updates_per_iter)]
        self.last_losses = torch.stack(losses)
        return self._means(dict(EpRet=stats["EpRet"], FairIdx=stats["FairIdx"],
                                AvgGlobalUtility=stats["AvgGlobalUtility"]), self.last_losses)

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def evaluate(self, n_episodes=5, eps=0.05):
        """Test episodes on held-out layouts (the reference drqn ``test_agent``)."""
        if self.graphs:
            stats = self._episodes(self.generator, n_episodes, eps)
        else:
            stats = collect_subs.evaluate_policy_subs(
                self.env_params, self.policy, self.test_pool, self.args.hidden_size,
                self.generator, n_episodes, self.device, eps)
        return {k: v.cpu().numpy() for k, v in stats.items()}

    def run_iteration(self, eps, warmup=False):
        """One iteration; returns host-side metric floats. ``warmup=True``
        collects the episode into the ring without updating."""
        if self.graphs:
            return self._run_programs(eps, warmup)
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
