"""Multi-UBS downlink coverage environment, the host NumPy env.

Counterpart of ``uav_bs_ctrl_tpu/envs/mubs_cov.py`` (reference
``envs/mubs_cov/mubs_cov.py``): ``MultiUbsCoverageEnv`` with per-RB
interference-aware scheduling (reference ``:170-200`` "V2"), priority-ordered
GT association, collision masking and penalties, Jain-fairness x mean-rate
utility reward, and the same observation / state feature layouts
(``get_obs_agent`` reference ``:215-242``, ``get_state`` reference
``:280-297``).

Every draw comes from ``rng`` (a ``np.random.RandomState``; default
``np.random``, as the JAX env), in the JAX env's order: the map's layout,
then the GT priority permutation. ``use_native=True`` (the default, as in
JAX) runs the C++ scheduling core (``uav_bs_ctrl_tpu_torch/native``, built
with the host C++ compiler at the first env that asks for it; the same
schedules as ``_schedule_numpy``, rates within 1e-6), with ``bw * n0`` as
the noise, as the JAX env does. When the core cannot be built the env runs
``_schedule_numpy``, as JAX's does, but not silently: it warns once per
process with the compiler's error. ``scheduler`` records which ran:
``'native'`` or ``'numpy'``.
"""

import numpy as np

from uav_bs_ctrl_tpu_torch.envs import spaces
from uav_bs_ctrl_tpu_torch.envs.common import AirToGroundChannel, jain_fairness_index
from uav_bs_ctrl_tpu_torch.envs.maps import MAPS
from uav_bs_ctrl_tpu_torch.envs.multi_agent_env import MultiAgentEnv
from uav_bs_ctrl_tpu_torch.envs.recorder import MultiUbsRecorder
from uav_bs_ctrl_tpu_torch.native import env_core


class MultiUbsCoverageEnv(MultiAgentEnv):
    """N UAV base stations (UBSs) serving M ground terminals (GTs) on RBs."""

    h_ubs = 100.0                               # UAV altitude (m)
    p_tx = 1e-3 * np.power(10, 10 / 10)         # Tx power (W)
    n0 = 1e-3 * np.power(10, -170 / 10)         # Noise PSD (W/Hz)
    bw = 180e3                                  # RB bandwidth (Hz)
    fc = 2.4e9                                  # Carrier frequency (Hz)
    scene = "dense-urban"
    safe_dist = 10.0                            # Collision distance (m)
    penalty = 5                                 # Collision penalty

    def __init__(self, map_id, fair_service=True, avoid_collision=True, record=True,
                 use_native=True, rng=None):
        super().__init__()
        self.rng = np.random if rng is None else rng

        self.map = MAPS[map_id]
        for k, v in self.map.get_params().items():
            setattr(self, k, v)

        self._fair_service = fair_service
        self._avoid_collision = avoid_collision

        self.chan = AirToGroundChannel(self.scene, self.fc)
        g_max = self.chan.estimate_chan_gain(0, self.h_ubs)
        snr_max = self.p_tx * g_max / (self.n0 * self.bw)
        self.max_rate = self.bw * np.log2(1 + snr_max) * 1e-6  # Best-case link rate (Mbps)

        self.t = None
        self.pos_ubs = np.empty((self.n_ubs, 2), dtype=np.float32)
        self.pos_gts = np.empty((self.n_gts, 2), dtype=np.float32)
        self.d_u2g = np.empty((self.n_ubs, self.n_gts), dtype=np.float32)
        self.d_u2u = np.empty((self.n_ubs, self.n_ubs), dtype=np.float32)
        self.adj = np.empty((self.n_ubs, self.n_ubs), dtype=bool)
        self.prior_gts = np.empty(self.n_gts, dtype=int)
        self.sched = np.empty((self.n_ubs, self.n_gts, self.n_rbs), dtype=bool)
        self.mask_collision = np.empty(self.n_ubs, dtype=bool)

        self.rate_per_gt = np.empty(self.n_gts, dtype=np.float32)
        self.rate_per_ubs = np.empty(self.n_ubs, dtype=np.float32)
        self.total_throughput = None
        self.n_colls = None
        self.avg_rate_per_gt = np.empty(self.n_gts, dtype=np.float32)
        self.fair_idx = None
        self.global_util = None
        self.avg_global_util = None

        # Action set: hover + n_dirs directions x each velocity.
        move_amounts = self.dt * np.array(self.vels).reshape(-1, 1)
        ang = 2 * np.pi * np.arange(self.n_dirs) / self.n_dirs
        move_dirs = np.stack([np.cos(ang), np.sin(ang)]).T
        self.avail_moves = np.concatenate((np.zeros((1, 2)), np.kron(move_amounts, move_dirs)))

        self.n_agents = self.n_ubs
        self.n_actions = self.avail_moves.shape[0]

        self.observation_space = [spaces.Dict(spaces={
            "agent": spaces.Box(-np.inf, np.inf, shape=np.array([self.obs_own_feats_size])),
            "ubs": spaces.Box(-np.inf, np.inf, shape=np.array(self.obs_ubs_feats_size)),
            "gt": spaces.Box(-np.inf, np.inf, shape=np.array(self.obs_gt_feats_size)),
        })] * self.n_agents
        self.state_space = spaces.Box(-np.inf, np.inf, shape=np.array([self.get_state_size()]))
        self.action_space = [spaces.Discrete(self.n_actions)]

        self.ep_ret = None

        self.recorder = MultiUbsRecorder(self) if record else None

        self.scheduler = "native" if use_native and env_core.available() else "numpy"
        if use_native and self.scheduler == "numpy":
            env_core.warn_fallback()

    # ------------------------------------------------------------------ #

    def reset(self):
        self.t = 0
        self.ep_ret = 0
        self.avg_global_util = 0
        self.avg_rate_per_gt = np.zeros(self.n_gts, dtype=np.float32)
        self.total_throughput = 0
        self.n_colls = 0

        positions = self.map.set_positions(self.rng)
        self.pos_ubs, self.pos_gts = positions["ubs"], positions["gt"]
        self.prior_gts = self.rng.permutation(self.n_gts)
        self._transmit_data()

        if self.recorder is not None:
            self.recorder.reload()

        return self.get_obs(), self.get_state()

    def step(self, actions):
        self.t += 1

        moves = self.avail_moves[np.array(actions, dtype=int)]
        self.pos_ubs = np.clip(self.pos_ubs + moves, 0, self.range_pos)

        self._transmit_data()

        reward = self._get_reward()
        self.ep_ret += reward.mean()

        done = self.t == self.episode_limit
        info = dict(EpRet=self.ep_ret, EpLen=self.t, AvgGlobalUtility=self.avg_global_util,
                    FairIdx=self.fair_idx, TotalThroughput=self.total_throughput,
                    ProbCollision=self.n_colls / self.t)
        info["BadMask"] = bool(self.t == self.episode_limit)

        if self.recorder is not None:
            self.recorder.click(pos_ubs=self.pos_ubs.copy(), fair_idx=self.fair_idx,
                                reward=reward.mean())

        return self.get_obs(), self.get_state(), reward, done, info

    # ------------------------------------------------------------------ #
    # Physics

    def _transmit_data(self):
        """Serve GTs from the latest UBS positions (reference ``:131-210``)."""

        # Spatial relations (vectorized; reference uses explicit loops).
        diff_ug = self.pos_ubs[:, None, :] - self.pos_gts[None, :, :]
        self.d_u2g = np.linalg.norm(diff_ug, axis=-1).astype(np.float32)
        diff_uu = self.pos_ubs[:, None, :] - self.pos_ubs[None, :, :]
        self.d_u2u = np.linalg.norm(diff_uu, axis=-1).astype(np.float32)

        self.adj = self.d_u2u <= self.r_comm
        self.mask_collision = ((self.d_u2u + 99999 * np.eye(self.n_ubs)) < self.safe_dist).any(1)
        self.n_colls += self.mask_collision.sum() / 2

        g = self.chan.estimate_chan_gain(self.d_u2g, self.h_ubs)
        mask_itf = self.d_u2g <= self.r_cov

        if self.scheduler == "native":
            self.sched, self.rate_per_gt, self.rate_per_ubs = env_core.schedule_and_rate(
                self.d_u2g, g, mask_itf, self.prior_gts, self.n_rbs, self.r_cov,
                self.p_tx, self.bw * self.n0, self.bw)
        else:
            self._schedule_numpy(g, mask_itf)

        # Long-term service statistics.
        self.avg_rate_per_gt = (self.avg_rate_per_gt * self.t + self.rate_per_gt) / (self.t + 1)
        self.total_throughput += self.rate_per_gt.sum() * self.dt / 1e3  # Gb
        self.fair_idx = jain_fairness_index(self.avg_rate_per_gt)
        self.global_util = self.fair_idx * self.rate_per_gt.mean()
        self.avg_global_util = (self.avg_global_util * self.t + self.global_util) / (self.t + 1)
        # Stable sort, as the JAX package's NumPy, C++ and JAX envs, so that
        # they agree bitwise on rate ties (the reference's default quicksort
        # orders exact ties differently).
        self.prior_gts = np.argsort(self.avg_rate_per_gt, kind='stable')

    def _schedule_numpy(self, g, mask_itf):
        """Priority-ordered association with lowest-interference idle-RB pick.

        Exact reference semantics (``mubs_cov.py:172-200``): GTs are visited in
        priority order; each attaches to its nearest in-range UBS with a free
        RB, choosing the idle RB with the least accumulated interference; the
        serving UBS then radiates interference on that RB to every GT inside
        its coverage (except the served GT).
        """
        n_ubs, n_gts, n_rbs = self.n_ubs, self.n_gts, self.n_rbs
        sched = np.zeros((n_ubs, n_gts, n_rbs), dtype=bool)
        p_itf = np.zeros((n_ubs, n_gts, n_rbs), dtype=np.float32)

        for m in self.prior_gts:
            nearest_ubs = np.argsort(self.d_u2g[:, m], kind='stable')
            for i in nearest_ubs:
                if (sched[i].sum() < n_rbs) and (self.d_u2g[i, m] <= self.r_cov):
                    occupied = np.where(sched[i].sum(0) > 0)
                    itf_per_chan = p_itf[:, m, :].sum(0)
                    itf_per_chan[occupied] = np.nan
                    opt_chan = np.nanargmin(itf_per_chan)
                    sched[i, m, opt_chan] = True
                    p_itf[i, :, opt_chan] = self.p_tx * g[i] * mask_itf[i]
                    p_itf[i, m, opt_chan] = 0
                    break

        rate_per_gt = np.zeros(n_gts, dtype=np.float32)
        for m in range(n_gts):
            if sched[:, m, :].sum() > 0:
                ubs_idx, chan_idx = np.where(sched[:, m, :])
                # Each GT is served by at most one (UBS, RB) link, so sinr has size 1.
                sinr = (self.p_tx * g[ubs_idx, m]) / (p_itf[:, m, chan_idx].sum() + self.bw * self.n0)
                rate_per_gt[m] = (self.bw * np.log2(1 + sinr) * 1e-6)[0]

        self.sched = sched
        self.rate_per_gt = rate_per_gt
        self.rate_per_ubs = (sched.sum(-1) * rate_per_gt).sum(1)

    # ------------------------------------------------------------------ #
    # Observations / state

    def get_obs(self) -> list:
        return [self.get_obs_agent(i) for i in range(self.n_agents)]

    def get_obs_agent(self, agent_id: int) -> dict:
        """Local observation dict (layout matches reference ``:215-242``)."""
        own_feats = np.zeros(self.obs_own_feats_size, dtype=np.float32)
        ubs_feats = np.zeros(self.obs_ubs_feats_size, dtype=np.float32)
        gt_feats = np.zeros(self.obs_gt_feats_size, dtype=np.float32)

        own_feats[0:2] = self.pos_ubs[agent_id] / self.range_pos

        other_ids = [j for j in range(self.n_agents) if j != agent_id]
        for row, j in enumerate(other_ids):
            if self.d_u2u[agent_id, j] <= self.r_comm:
                ubs_feats[row, 0] = 1
                ubs_feats[row, 1:3] = (self.pos_ubs[j] - self.pos_ubs[agent_id]) / min(self.range_pos, self.r_comm)

        visible = self.d_u2g[agent_id] <= self.r_sns
        gt_feats[visible, 0] = 1
        gt_feats[visible, 1:3] = (self.pos_gts[visible] - self.pos_ubs[agent_id]) / min(self.range_pos, self.r_sns)
        gt_feats[visible, 3] = self.rate_per_gt[visible] / self.max_rate
        if self._fair_service:
            gt_feats[visible, 4] = (self.avg_rate_per_gt[visible] / self.max_rate
                                    * self.n_gts / (self.n_ubs * self.n_rbs))

        return dict(agent=own_feats, ubs=ubs_feats, gt=gt_feats)

    def get_obs_size(self) -> dict:
        return dict(agent=self.obs_own_feats_size, ubs=self.obs_ubs_feats_size,
                    gt=self.obs_gt_feats_size)

    @property
    def obs_own_feats_size(self) -> int:
        return 2  # normalized (x, y)

    @property
    def obs_ubs_feats_size(self) -> tuple:
        return self.n_ubs - 1, 1 + 2  # visibility flag + normalized offset

    @property
    def obs_gt_feats_size(self) -> tuple:
        nf_gt = 1 + 2 + 1  # flag + offset + instant rate
        if self._fair_service:
            nf_gt += 1  # + average rate
        return self.n_gts, nf_gt

    def get_state(self) -> np.ndarray:
        """Global state for centralized training (reference ``:280-297``)."""
        ubs_feats = np.zeros(self.state_ubs_feats_size, dtype=np.float32)
        gt_feats = np.zeros(self.state_gt_feats_size, dtype=np.float32)

        ubs_feats[:, 0:2] = self.pos_ubs / self.range_pos
        gt_feats[:, 0:2] = self.pos_gts / self.range_pos
        gt_feats[:, 2] = self.rate_per_gt / self.max_rate
        if self._fair_service:
            gt_feats[:, 3] = self.avg_rate_per_gt / self.max_rate * self.n_gts / (self.n_ubs * self.n_rbs)

        return np.concatenate((ubs_feats.flatten(), gt_feats.flatten()))

    def get_state_size(self) -> int:
        return int(np.prod(self.state_ubs_feats_size) + np.prod(self.state_gt_feats_size))

    @property
    def state_ubs_feats_size(self) -> tuple:
        return self.n_ubs, 2

    @property
    def state_gt_feats_size(self) -> tuple:
        nf_gt = 2 + 1
        if self._fair_service:
            nf_gt += 1
        return self.n_gts, nf_gt

    # ------------------------------------------------------------------ #
    # Reward

    def _get_reward(self):
        """Local per-agent rewards (reference ``:324-341``)."""
        if self._fair_service:
            local_rewards = self.global_util * np.ones(self.n_agents, dtype=np.float32)
        else:
            local_rewards = self.rate_per_gt.mean() * np.ones(self.n_agents, dtype=np.float32)

        local_rewards = self.reward_scale_rate * local_rewards / self.max_rate
        idle_mask = self.rate_per_ubs == 0
        local_rewards = local_rewards * (1 - idle_mask)

        if self._avoid_collision:
            local_rewards = (1 - self.mask_collision) * local_rewards - self.mask_collision * self.penalty

        return local_rewards

    def replay(self, **kwargs):
        if self.recorder is not None:
            self.recorder.replay(**kwargs)
