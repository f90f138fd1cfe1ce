"""Single-UBS downlink coverage environment (exp1), the host NumPy env.

Counterpart of ``uav_bs_ctrl_tpu/envs/subs_cov.py`` (reference
``envs/subs_cov/subs_cov.py``): ``SingleUbsCoverageEnv`` with clustered GT
groups, greedy priority scheduling onto ``n_rbs`` interference-free RBs, and
fairness x mean-rate reward. Single-agent gym-style API: ``reset() -> obs``,
``step(a) -> (obs, rew, done, info)``.

Every draw comes from ``rng`` (a ``np.random.RandomState``; default
``np.random``, as the JAX env), in the JAX env's order: the layout
(``torch_env_subs.set_position``, the same draws as its ``_set_position``),
then the GT priority permutation. So a ``RandomState(seed)`` gives the JAX
env's episodes after ``np.random.seed(seed)``.
"""

import numpy as np

from uav_bs_ctrl_tpu_torch.envs import spaces, torch_env_subs
from uav_bs_ctrl_tpu_torch.envs.common import AirToGroundChannel, jain_fairness_index
from uav_bs_ctrl_tpu_torch.envs.recorder import SingleUbsRecorder


class SingleUbsCoverageEnv:
    """One UAV base station serving clustered ground terminals."""

    unit = 100
    h_ubs = 100
    p_tx = 1e-3 * np.power(10, 10 / 10)
    n0 = 1e-3 * np.power(10, -170 / 10)
    bw = 180e3
    fc = 2.4e9
    dt = 10
    scene = "urban"

    def __init__(self, range_pos=1000, episode_limit=200, n_grps=2, gts_per_grp=1,
                 r_cov=100.0, n_rbs=10, vels=10, n_dirs=4, record=True, rng=None):
        self.rng = np.random if rng is None else rng
        self._params = torch_env_subs.make_params(range_pos, episode_limit, n_grps, gts_per_grp,
                                                  r_cov, n_rbs, vels, n_dirs)
        self.range_pos = range_pos
        self.episode_limit = episode_limit

        self.n_grps = n_grps
        self.gts_per_grp = gts_per_grp
        self.n_gts = n_grps * gts_per_grp

        self.r_cov = r_cov
        self.n_rbs = n_rbs

        self.chan = AirToGroundChannel(self.scene, self.fc)
        g_max = self.chan.estimate_chan_gain(0, self.h_ubs)
        snr_max = self.p_tx * g_max / (self.n0 * self.bw)
        self.max_rate = self.bw * np.log2(1 + snr_max) * 1e-6

        self.t = None
        self.pos_ubs = np.empty(2, dtype=np.float32)
        self.pos_gts = np.empty((self.n_gts, 2), dtype=np.float32)
        self.d_u2g = np.empty(self.n_gts, dtype=np.float32)
        self.prior_gts = np.empty(self.n_gts, dtype=int)
        self.sched = np.empty(self.n_gts, dtype=bool)

        self.rate_per_gt = np.empty(self.n_gts, dtype=np.float32)
        self.aver_rate_per_gt = np.empty(self.n_gts, dtype=np.float32)
        self.fair_idx = None
        self.total_throughput = None
        self.global_util = None
        self.avg_global_util = None

        move_amounts = self.dt * np.array(vels).reshape(-1, 1)
        ang = 2 * np.pi * np.arange(n_dirs) / n_dirs
        move_dirs = np.stack([np.cos(ang), np.sin(ang)]).T
        self.avail_moves = np.concatenate((np.zeros((1, 2)), np.kron(move_amounts, move_dirs)))
        self.n_actions = self.avail_moves.shape[0]

        self.observation_space = spaces.Dict(spaces={
            "agent": spaces.Box(-np.inf, np.inf, shape=np.array([self.obs_own_feats_size])),
            "gt": spaces.Box(-np.inf, np.inf, shape=np.array(self.obs_gt_feats_size)),
        })
        self.action_space = spaces.Discrete(self.n_actions)
        self.reward_scale_rate = self.n_grps

        self.ep_ret = 0
        self.recorder = SingleUbsRecorder(self) if record else None

    def reset(self):
        self.t = 0
        self.ep_ret = 0
        self.avg_global_util = 0
        self.aver_rate_per_gt = np.zeros(self.n_gts, dtype=np.float32)
        self.total_throughput = 0

        self._set_position()
        self.prior_gts = self.rng.permutation(self.n_gts)
        self._transmit_data()

        if self.recorder is not None:
            self.recorder.reload()

        return self.get_obs()

    def _set_position(self):
        """UBS starts at the center; GT groups at random angles/radii (reference ``:95-113``)."""
        self.pos_ubs, self.pos_gts = torch_env_subs.set_position(self._params, self.rng)

    def step(self, action):
        self.t += 1
        move = self.avail_moves[action]

        self.pos_ubs = np.clip(self.pos_ubs + move, 0, self.range_pos)
        self._transmit_data()

        rew = self._get_reward()
        self.ep_ret += rew
        done = self.t == self.episode_limit
        info = dict(EpRet=self.ep_ret, EpLen=self.t, AvgGlobalUtility=self.avg_global_util,
                    FairIdx=self.fair_idx, TotalThroughput=self.total_throughput)
        info["BadMask"] = bool(self.t == self.episode_limit)

        if self.recorder is not None:
            self.recorder.click(pos_ubs=self.pos_ubs.copy(), global_utility=self.global_util,
                                reward=rew, total_throughput=self.total_throughput,
                                fair_idx=self.fair_idx, rate_per_gt=self.rate_per_gt.copy(),
                                velocity=np.linalg.norm(move / self.dt))

        return self.get_obs(), rew, done, info

    def _transmit_data(self):
        """Greedy priority scheduling, interference-free RBs (reference ``:135-157``)."""
        self.d_u2g = np.linalg.norm(self.pos_gts - self.pos_ubs, axis=-1).astype(np.float32)

        self.sched = np.zeros(self.n_gts, dtype=bool)
        for m in self.prior_gts:
            if (self.sched.sum() < self.n_rbs) and (self.d_u2g[m] <= self.r_cov):
                self.sched[m] = True

        g = self.chan.estimate_chan_gain(self.d_u2g, self.h_ubs)
        p_rx = self.p_tx * g * self.sched
        sinr = p_rx / (self.bw * self.n0)
        self.rate_per_gt = (self.bw * np.log2(1 + sinr) * 1e-6).astype(np.float32)

        self.aver_rate_per_gt = (self.aver_rate_per_gt * self.t + self.rate_per_gt) / (self.t + 1)
        self.total_throughput += self.rate_per_gt.sum() * self.dt / 1e3
        self.fair_idx = jain_fairness_index(self.aver_rate_per_gt)
        self.global_util = self.fair_idx * self.rate_per_gt.mean()
        self.avg_global_util = (self.avg_global_util * self.t + self.global_util) / (self.t + 1)
        self.prior_gts = np.argsort(self.aver_rate_per_gt, kind='stable')

    def get_obs(self):
        own_feats = np.zeros(self.obs_own_feats_size, dtype=np.float32)
        gt_feats = np.zeros(self.obs_gt_feats_size, dtype=np.float32)

        own_feats[0:2] = self.pos_ubs / self.range_pos

        gt_feats[:, 0:2] = (self.pos_gts - self.pos_ubs) / self.range_pos
        gt_feats[:, 2] = self.rate_per_gt / self.max_rate
        gt_feats[:, 3] = self.aver_rate_per_gt / self.max_rate * self.n_grps

        return dict(agent=own_feats, gt=gt_feats)

    def get_obs_size(self):
        return dict(agent=self.obs_own_feats_size, gt=self.obs_gt_feats_size)

    @property
    def obs_own_feats_size(self):
        return 2

    @property
    def obs_gt_feats_size(self):
        return self.n_gts, 2 + 1 + 1

    def _get_reward(self):
        return self.reward_scale_rate * self.global_util / self.max_rate

    def replay(self, **kwargs):
        if self.recorder is not None:
            self.recorder.replay(**kwargs)
