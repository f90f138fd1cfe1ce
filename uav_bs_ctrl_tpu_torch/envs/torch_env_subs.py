"""Single-UBS coverage environment (exp1) on the device, batched over a leading world axis.

Counterpart of ``uav_bs_ctrl_tpu/envs/jax_env_subs.py``: one UAV base station
serving clustered ground terminals on ``n_rbs`` interference-free RBs, for W
worlds at once. Every ``SubsState`` field carries a leading ``[W]`` axis. The
greedy scheduler is a permutation and a cumulative count: the first ``n_rbs``
GTs within ``r_cov``, in priority order, are served. The JAX op order is kept
and everything is float32, so that ``d <= r_cov`` on a coverage boundary falls
the same way; the stable ``argsort`` keeps index order on ties.

:func:`set_position` is the NumPy copy of the NumPy env's
``SingleUbsCoverageEnv._set_position`` (``uav_bs_ctrl_tpu/envs/subs_cov.py``),
drawing from ``np.random`` (or the ``rng`` it is given) in the same order,
so that a seed gives the JAX package's layouts.
"""

from typing import NamedTuple

import numpy as np
import torch

from uav_bs_ctrl_tpu_torch.envs.common import AirToGroundChannel
from uav_bs_ctrl_tpu_torch.envs.torch_env import _chan_gain, _constant, _jain, _norm


class SubsParams(NamedTuple):
    """Static physics/scenario parameters (Python scalars)."""
    n_gts: int
    n_rbs: int
    n_grps: int
    n_actions: int
    range_pos: float
    episode_limit: int
    dt: float
    r_cov: float
    reward_scale_rate: float
    h_ubs: float
    p_tx: float
    noise: float           # bw * n0 (W)
    bw: float
    max_rate: float
    chan_a: float
    chan_b: float
    eta_los: float
    eta_nlos: float
    fc: float
    avail_moves: tuple     # ((dx, dy), ...)


class SubsState(NamedTuple):
    """Per-world state; every field has a leading [W] axis."""
    t: torch.Tensor                  # [W] int32
    pos_ubs: torch.Tensor            # [W, 2] f32
    pos_gts: torch.Tensor            # [W, M, 2] f32
    prior_gts: torch.Tensor          # [W, M] int64
    aver_rate_per_gt: torch.Tensor   # [W, M] f32
    rate_per_gt: torch.Tensor        # [W, M] f32
    fair_idx: torch.Tensor           # [W] f32
    global_util: torch.Tensor        # [W] f32
    avg_global_util: torch.Tensor    # [W] f32
    total_throughput: torch.Tensor   # [W] f32
    ep_ret: torch.Tensor             # [W] f32


def make_params(range_pos=1000, episode_limit=200, n_grps=2, gts_per_grp=1,
                r_cov=100.0, n_rbs=10, vels=10, n_dirs=4) -> SubsParams:
    """SubsParams of the NumPy env's constructor arguments (its constants)."""
    chan = AirToGroundChannel("urban", 2.4e9)
    p_tx = 1e-3 * 10 ** (10 / 10)
    n0 = 1e-3 * 10 ** (-170 / 10)
    bw = 180e3
    g_max = chan.estimate_chan_gain(0, 100.0)
    max_rate = bw * np.log2(1 + p_tx * g_max / (n0 * bw)) * 1e-6

    move_amounts = 10 * np.array(vels).reshape(-1, 1)
    ang = 2 * np.pi * np.arange(n_dirs) / n_dirs
    move_dirs = np.stack([np.cos(ang), np.sin(ang)]).T
    avail_moves = np.concatenate((np.zeros((1, 2)), np.kron(move_amounts, move_dirs)))

    return SubsParams(
        n_gts=n_grps * gts_per_grp, n_rbs=n_rbs, n_grps=n_grps,
        n_actions=avail_moves.shape[0], range_pos=float(range_pos),
        episode_limit=int(episode_limit), dt=10.0, r_cov=float(r_cov),
        reward_scale_rate=float(n_grps), h_ubs=100.0, p_tx=p_tx, noise=bw * n0,
        bw=bw, max_rate=float(max_rate), chan_a=chan.a, chan_b=chan.b,
        eta_los=chan.eta_los, eta_nlos=chan.eta_nlos, fc=chan.fc,
        avail_moves=tuple(map(tuple, avail_moves.tolist())))


def set_position(params: SubsParams, rng=None):
    """One layout from ``rng`` (a ``np.random.RandomState``; default
    ``np.random``): ``(pos_ubs [2], pos_gts [M, 2])`` float32.

    The UBS starts at the region's centre; the GT groups sit at random angles
    (evenly spread from a random offset) and radii of 0.2-0.3 ``range_pos``,
    each GT at N(0, (0.25 r_cov)^2) around its group's centre, clipped to the
    region; then the GT rows are shuffled (``subs_cov.py:_set_position``).
    """
    rng = np.random if rng is None else rng
    n_grps, range_pos = params.n_grps, params.range_pos
    per_grp = params.n_gts // n_grps
    pos_ubs = np.array([range_pos / 2, range_pos / 2], dtype=np.float32)

    ang_grps = (rng.rand() + np.arange(n_grps) / n_grps) * 2 * np.pi
    r_min, r_max = 0.2 * range_pos, 0.3 * range_pos
    r_grps = r_min + rng.rand(n_grps) * (r_max - r_min)
    pos_grps = pos_ubs + (np.stack((np.cos(ang_grps), np.sin(ang_grps))) * r_grps).T

    pos_gts = np.empty((params.n_gts, 2), dtype=np.float32)
    for g in range(n_grps):
        rows = slice(g * per_grp, (g + 1) * per_grp)
        pos_gts[rows] = pos_grps[g] + 0.25 * params.r_cov * rng.randn(per_grp, 2)

    pos_gts = np.clip(pos_gts, 0, range_pos)
    rng.shuffle(pos_gts)
    return pos_ubs, pos_gts


def _transmit(params: SubsParams, state: SubsState) -> SubsState:
    d = _norm(state.pos_gts - state.pos_ubs[:, None, :])                # [W, M]

    # Greedy scheduling: the first n_rbs in-range GTs in priority order, then
    # back to GT index order through the inverse permutation.
    eligible_in_order = torch.gather(d, 1, state.prior_gts) <= params.r_cov
    rank = torch.cumsum(eligible_in_order.to(torch.int32), dim=-1)
    sched_in_order = eligible_in_order & (rank <= params.n_rbs)
    inv = torch.argsort(state.prior_gts, dim=-1, stable=True)
    sched = torch.gather(sched_in_order, 1, inv)

    g = _chan_gain(params, d)
    sinr = params.p_tx * g * sched.to(torch.float32) / params.noise
    rate = params.bw * torch.log2(1 + sinr) * 1e-6

    t_f = state.t.to(torch.float32)
    aver = (state.aver_rate_per_gt * t_f[:, None] + rate) / (t_f[:, None] + 1)
    total_tp = state.total_throughput + rate.sum(-1) * params.dt / 1e3
    fair = _jain(aver)
    gu = fair * rate.mean(-1)
    avg_gu = (state.avg_global_util * t_f + gu) / (t_f + 1)
    prior = torch.argsort(aver, dim=-1, stable=True)

    return state._replace(rate_per_gt=rate, aver_rate_per_gt=aver,
                          total_throughput=total_tp, fair_idx=fair,
                          global_util=gu, avg_global_util=avg_gu, prior_gts=prior)


def reset_from_positions(params: SubsParams, pos_ubs, pos_gts, prior_gts) -> SubsState:
    """W worlds from explicit positions [W, 2] / [W, M, 2] and GT priority
    permutations [W, M], then the initial service pass at t=0."""
    n_w, m = pos_gts.shape[0], params.n_gts
    dev = pos_gts.device
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    state = SubsState(
        t=torch.zeros(n_w, dtype=torch.int32, device=dev),
        pos_ubs=pos_ubs.to(torch.float32), pos_gts=pos_gts.to(torch.float32),
        prior_gts=prior_gts.to(torch.int64),
        aver_rate_per_gt=zeros(n_w, m), rate_per_gt=zeros(n_w, m),
        fair_idx=zeros(n_w), global_util=zeros(n_w), avg_global_util=zeros(n_w),
        total_throughput=zeros(n_w), ep_ret=zeros(n_w))
    return _transmit(params, state)


def step(params: SubsParams, state: SubsState, action):
    """One step of every world; action [W] int. Returns
    (state', obs, reward [W], done [W])."""
    move = _constant(params.avail_moves, torch.float32, action.device)[action]
    pos = torch.clamp(state.pos_ubs + move, 0, params.range_pos)
    state = _transmit(params, state._replace(t=state.t + 1, pos_ubs=pos))
    rew = params.reward_scale_rate * state.global_util / params.max_rate
    state = state._replace(ep_ret=state.ep_ret + rew)
    done = state.t == params.episode_limit
    return state, get_obs(params, state), rew, done


def get_obs(params: SubsParams, state: SubsState) -> dict:
    """``{"agent": [W, 1, 2], "gt": [W, 1, M, 4]}``: the UBS position, and per GT
    its offset from the UBS, rate and (scaled) average rate."""
    own = state.pos_ubs / params.range_pos
    gt = torch.cat([
        (state.pos_gts - state.pos_ubs[:, None, :]) / params.range_pos,
        (state.rate_per_gt / params.max_rate)[..., None],
        (state.aver_rate_per_gt / params.max_rate * params.n_grps)[..., None],
    ], dim=-1)
    return {"agent": own[:, None, :], "gt": gt[:, None, :, :]}
