"""Multi-UBS coverage environment on the device, batched over a leading world axis.

Counterpart of ``uav_bs_ctrl_tpu/envs/jax_env.py``: the air-to-ground channel,
priority-ordered interference-aware RB scheduling, rewards and observations,
for W worlds at once. Every ``EnvState`` field carries a leading ``[W]`` axis.
The JAX op order is kept and everything is float32, so that comparisons at a
boundary (``d <= r_cov``, ``d <= r_sns``) fall the same way; ``argmin`` and
``argsort`` pick the first index on ties.

Scheduling (reference ``envs/mubs_cov/mubs_cov.py:172-200``): GTs are visited
in priority order; each attaches to its nearest in-range UBS with a free RB,
on the idle RB with the least accumulated interference; the serving UBS then
radiates interference on that RB to every GT in its coverage but the served one.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from uav_bs_ctrl_tpu_torch.envs.common import AirToGroundChannel
from uav_bs_ctrl_tpu_torch.envs.maps import MAPS

_INF = float("inf")


class EnvParams(NamedTuple):
    """Static physics/scenario parameters (Python scalars)."""
    n_ubs: int
    n_gts: int
    n_rbs: int
    n_actions: int
    range_pos: float
    episode_limit: int
    dt: float
    r_cov: float
    r_sns: float
    r_comm: float
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
    safe_dist: float
    penalty: float
    fair_service: bool
    avoid_collision: bool
    avail_moves: tuple      # ((dx, dy), ...)


class EnvState(NamedTuple):
    """Per-world state; every field has a leading [W] axis."""
    t: torch.Tensor                 # [W] int32
    pos_ubs: torch.Tensor           # [W, N, 2] f32
    pos_gts: torch.Tensor           # [W, M, 2] f32
    prior_gts: torch.Tensor         # [W, M] int64
    avg_rate_per_gt: torch.Tensor   # [W, M] f32
    rate_per_gt: torch.Tensor       # [W, M] f32
    rate_per_ubs: torch.Tensor      # [W, N] f32
    d_u2g: torch.Tensor             # [W, N, M] f32
    d_u2u: torch.Tensor             # [W, N, N] f32
    mask_collision: torch.Tensor    # [W, N] bool
    fair_idx: torch.Tensor          # [W] f32
    global_util: torch.Tensor       # [W] f32
    avg_global_util: torch.Tensor   # [W] f32
    total_throughput: torch.Tensor  # [W] f32
    n_colls: torch.Tensor           # [W] f32
    ep_ret: torch.Tensor            # [W] f32


def make_params(map_id: str, fair_service=True, avoid_collision=True) -> EnvParams:
    """EnvParams of a named map (the NumPy env's constants)."""
    p = MAPS[map_id].get_params()
    chan = AirToGroundChannel("dense-urban", 2.4e9)
    p_tx = 1e-3 * 10 ** (10 / 10)
    n0 = 1e-3 * 10 ** (-170 / 10)
    bw = 180e3
    g_max = chan.estimate_chan_gain(0, 100.0)
    snr_max = p_tx * g_max / (n0 * bw)
    max_rate = bw * np.log2(1 + snr_max) * 1e-6

    move_amounts = p["dt"] * np.array(p["vels"]).reshape(-1, 1)
    ang = 2 * np.pi * np.arange(p["n_dirs"]) / p["n_dirs"]
    move_dirs = np.stack([np.cos(ang), np.sin(ang)]).T
    avail_moves = np.concatenate((np.zeros((1, 2)), np.kron(move_amounts, move_dirs)))

    return EnvParams(
        n_ubs=int(p["n_ubs"]), n_gts=int(p["n_gts"]), n_rbs=int(p["n_rbs"]),
        n_actions=int(avail_moves.shape[0]), range_pos=float(p["range_pos"]),
        episode_limit=int(p["episode_limit"]), dt=float(p["dt"]),
        r_cov=float(p["r_cov"]), r_sns=float(p["r_sns"]), r_comm=float(p["r_comm"]),
        reward_scale_rate=float(p["reward_scale_rate"]), h_ubs=100.0, p_tx=p_tx,
        noise=bw * n0, bw=bw, max_rate=float(max_rate),
        chan_a=chan.a, chan_b=chan.b, eta_los=chan.eta_los, eta_nlos=chan.eta_nlos,
        fc=chan.fc, safe_dist=10.0, penalty=5.0,
        fair_service=bool(fair_service), avoid_collision=bool(avoid_collision),
        avail_moves=tuple(map(tuple, avail_moves.tolist())),
    )


def _chan_gain(params: EnvParams, d_level):
    # A tensor numerator: ``float / tensor`` would round twice (reciprocal * float).
    h_ubs = torch.tensor(params.h_ubs, dtype=d_level.dtype, device=d_level.device)
    p_los = 1.0 / (1.0 + params.chan_a * torch.exp(
        -params.chan_b * (torch.arctan(h_ubs / (d_level + 1e-5))
                          - params.chan_a)))
    d = torch.sqrt(torch.square(d_level) + params.h_ubs ** 2)
    fspl = (4.0 * math.pi * params.fc * d / 3e8) ** 2
    pl = (p_los * fspl * 10 ** (params.eta_los / 20)
          + (1 - p_los) * fspl * 10 ** (params.eta_nlos / 20))
    return 1.0 / pl


def _jain(x):
    x = torch.clamp(x, min=1e-6)
    return torch.square(x.sum(-1)) / (x.shape[-1] * torch.square(x).sum(-1))


def _norm(diff):
    """Euclidean norm over the last axis of size 2, as ``jnp.linalg.norm``."""
    return torch.sqrt(torch.square(diff).sum(-1))


def _schedule(params: EnvParams, d_u2g, gain, prior_gts):
    """Priority/interference-aware RB assignment: the JAX scatter formulation,
    looped over the M GTs in Python, every world at once."""
    n_w = d_u2g.shape[0]
    N, M, R = params.n_ubs, params.n_gts, params.n_rbs
    dev = d_u2g.device
    w = torch.arange(n_w, device=dev)
    used_rbs = torch.zeros((n_w, N), dtype=torch.int32, device=dev)
    rb_occ = torch.zeros((n_w, N, R), dtype=torch.bool, device=dev)
    p_itf = torch.zeros((n_w, N, M, R), dtype=torch.float32, device=dev)
    sched = torch.zeros((n_w, N, M, R), dtype=torch.bool, device=dev)
    covered = d_u2g <= params.r_cov                                  # [W, N, M]
    radiated = torch.where(covered, params.p_tx * gain, 0.0)        # [W, N, M]
    for pm in range(M):
        m = prior_gts[:, pm]                                         # [W]
        d_col = d_u2g[w, :, m]                                       # [W, N]
        eligible = (used_rbs < R) & (d_col <= params.r_cov)
        i = torch.where(eligible, d_col, _INF).argmin(-1)            # nearest eligible
        ok = eligible.any(-1)                                        # [W]

        itf_per_chan = p_itf[w, :, m, :].sum(1)                      # [W, R]
        occ_i = rb_occ[w, i]                                         # [W, R]
        c = torch.where(occ_i, _INF, itf_per_chan).argmin(-1)        # least-itf idle RB

        sched[w, i, m, c] |= ok
        rb_occ[w, i, c] |= ok
        used_rbs[w, i] += ok.to(torch.int32)
        # UBS i radiates on RB c to covered GTs, except the served one.
        row = radiated[w, i].clone()                                 # [W, M]
        row[w, m] = 0.0
        p_itf[w, i, :, c] = torch.where(ok[:, None], row, p_itf[w, i, :, c])
    return _rates_from_schedule(params, gain, p_itf, sched)


def _rates_from_schedule(params: EnvParams, gain, p_itf, sched):
    sf = sched.to(torch.float32)                                     # [W, N, M, R]
    serving = sched.any(-1).any(1)                                   # [W, M]
    g_serv = (sf * gain[..., None]).sum((1, 3))                      # imc,im->m
    itf_serv = (sf.sum(1) * p_itf.sum(1)).sum(-1)                    # imc,jmc->m
    sinr = params.p_tx * g_serv / (itf_serv + params.noise)
    rate_per_gt = torch.where(serving, params.bw * torch.log2(1 + sinr) * 1e-6, 0.0)
    rate_per_ubs = (sf * rate_per_gt[:, None, :, None]).sum((2, 3))  # imc,m->i
    return sched, rate_per_gt, rate_per_ubs


def _transmit(params: EnvParams, state: EnvState) -> EnvState:
    d_u2g = _norm(state.pos_ubs[:, :, None, :] - state.pos_gts[:, None, :, :])
    d_u2u = _norm(state.pos_ubs[:, :, None, :] - state.pos_ubs[:, None, :, :])
    eye = torch.eye(params.n_ubs, device=d_u2u.device)
    mask_collision = ((d_u2u + 99999 * eye) < params.safe_dist).any(-1)
    n_colls = state.n_colls + mask_collision.sum(-1) / 2

    gain = _chan_gain(params, d_u2g)
    _, rate_per_gt, rate_per_ubs = _schedule(params, d_u2g, gain, state.prior_gts)

    t_f = state.t.to(torch.float32)
    avg_rate = (state.avg_rate_per_gt * t_f[:, None] + rate_per_gt) / (t_f[:, None] + 1)
    total_tp = state.total_throughput + rate_per_gt.sum(-1) * params.dt / 1e3
    fair_idx = _jain(avg_rate)
    global_util = fair_idx * rate_per_gt.mean(-1)
    avg_gu = (state.avg_global_util * t_f + global_util) / (t_f + 1)
    prior = torch.argsort(avg_rate, dim=-1, stable=True)

    return state._replace(
        d_u2g=d_u2g, d_u2u=d_u2u, mask_collision=mask_collision, n_colls=n_colls,
        rate_per_gt=rate_per_gt, rate_per_ubs=rate_per_ubs,
        avg_rate_per_gt=avg_rate, total_throughput=total_tp, fair_idx=fair_idx,
        global_util=global_util, avg_global_util=avg_gu, prior_gts=prior)


def _reward(params: EnvParams, state: EnvState):
    base = state.global_util if params.fair_service else state.rate_per_gt.mean(-1)
    local = (params.reward_scale_rate * base / params.max_rate)[:, None] \
        * torch.ones_like(state.rate_per_ubs)
    local = local * (1 - (state.rate_per_ubs == 0).to(torch.float32))
    if params.avoid_collision:
        coll = state.mask_collision.to(torch.float32)
        local = (1 - coll) * local - coll * params.penalty
    return local


def reset_from_positions(params: EnvParams, pos_ubs, pos_gts, prior_gts) -> EnvState:
    """W worlds from explicit positions [W, N, 2] / [W, M, 2] and GT priority
    permutations [W, M], then the initial service pass at t=0."""
    n_w = pos_ubs.shape[0]
    N, M = params.n_ubs, params.n_gts
    dev = pos_ubs.device
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    state = EnvState(
        t=torch.zeros(n_w, dtype=torch.int32, device=dev),
        pos_ubs=pos_ubs.to(torch.float32), pos_gts=pos_gts.to(torch.float32),
        prior_gts=prior_gts.to(torch.int64),
        avg_rate_per_gt=zeros(n_w, M), rate_per_gt=zeros(n_w, M),
        rate_per_ubs=zeros(n_w, N), d_u2g=zeros(n_w, N, M), d_u2u=zeros(n_w, N, N),
        mask_collision=torch.zeros((n_w, N), dtype=torch.bool, device=dev),
        fair_idx=zeros(n_w), global_util=zeros(n_w), avg_global_util=zeros(n_w),
        total_throughput=zeros(n_w), n_colls=zeros(n_w), ep_ret=zeros(n_w))
    return _transmit(params, state)


def reset(params: EnvParams, generator, device, n_worlds) -> EnvState:
    """``n_worlds`` worlds with uniform positions in ``[0, range_pos)`` for the
    UBSs and GTs and a uniform GT priority permutation (JAX ``reset``, the
    scaling path), drawn in that order from ``generator`` (a CPU
    ``torch.Generator``) and moved to ``device``, through
    :func:`reset_from_positions`."""
    pos_ubs = torch.rand((n_worlds, params.n_ubs, 2), generator=generator) * params.range_pos
    pos_gts = torch.rand((n_worlds, params.n_gts, 2), generator=generator) * params.range_pos
    prior = torch.argsort(torch.rand((n_worlds, params.n_gts), generator=generator), dim=-1)
    return reset_from_positions(params, pos_ubs.to(device), pos_gts.to(device),
                                prior.to(device))


def rollout(params: EnvParams, policy, state0, h0, generator, n_steps, eps=0.0):
    """``n_steps`` steps of every world with ``policy(obs, h, key=...) -> (q,
    h')`` in the loop (JAX ``rollout``, a scan there). Exploration is the
    reference's quirk, as in ``algos/collect.py``: one coin per world per
    step for all its agents, then uniform random actions, drawn from
    ``generator``. Returns ``(final_state, rewards [W, T, N])``."""
    from uav_bs_ctrl_tpu_torch.algos.collect import _act   # collect imports this module

    state, h, rewards = state0, h0, []
    obs = get_obs(params, state)
    for _ in range(n_steps):
        acts, h = _act(policy, obs, h, generator, eps, params.n_actions)
        state, obs, rew, _ = step(params, state, acts)
        rewards.append(rew)
    return state, torch.stack(rewards, 1)


def step(params: EnvParams, state: EnvState, actions):
    """One step of every world; actions [W, N] int. Returns
    (state', obs, reward [W, N], done [W])."""
    moves = torch.tensor(params.avail_moves, dtype=torch.float32,
                         device=actions.device)[actions]
    pos_ubs = torch.clamp(state.pos_ubs + moves, 0, params.range_pos)
    state = state._replace(t=state.t + 1, pos_ubs=pos_ubs)
    state = _transmit(params, state)
    rew = _reward(params, state)
    state = state._replace(ep_ret=state.ep_ret + rew.mean(-1))
    done = state.t == params.episode_limit
    return state, get_obs(params, state), rew, done


def get_state_vec(params: EnvParams, state: EnvState):
    """The global state the QMIX mixer reads, [W, 2N + M*(3 + fair_service)]:
    UBS positions, then per GT its position, rate and (fair service) average
    rate, each normalised as in the observations."""
    n_w = state.pos_ubs.shape[0]
    ubs = (state.pos_ubs / params.range_pos).reshape(n_w, -1)
    cols = [state.pos_gts / params.range_pos,
            (state.rate_per_gt / params.max_rate)[..., None]]
    if params.fair_service:
        cols.append((state.avg_rate_per_gt / params.max_rate
                     * params.n_gts / (params.n_ubs * params.n_rbs))[..., None])
    gts = torch.cat(cols, -1).reshape(n_w, -1)
    return torch.cat([ubs, gts], -1)


def _others_index(n, device):
    """[n, n-1] index of all agents but the row agent, in index order."""
    idx = np.arange(n)[None, :].repeat(n, 0)
    out = np.stack([np.delete(idx[i], i) for i in range(n)]) if n > 1 \
        else np.zeros((n, 0), np.int64)
    return torch.as_tensor(out, dtype=torch.int64, device=device)


def get_obs(params: EnvParams, state: EnvState) -> dict:
    """Padded-neighbourhood obs dict, each entry with a leading [W] axis."""
    N, M = params.n_ubs, params.n_gts
    dev = state.pos_ubs.device
    own = state.pos_ubs / params.range_pos                           # [W, N, 2]

    # Other-UBS rows: for agent i, row j enumerates the OTHER UBSs in index order.
    others = _others_index(N, dev)                                   # [N, N-1]
    rel = (state.pos_ubs[:, others] - state.pos_ubs[:, :, None, :]) / min(
        params.range_pos, params.r_comm)
    d_other = torch.gather(state.d_u2u, 2, others.expand(state.d_u2u.shape[0], -1, -1))
    vis_u = (d_other <= params.r_comm)[..., None].to(torch.float32)
    ubs_feats = torch.cat([vis_u, rel * vis_u], -1)

    vis_g = (state.d_u2g <= params.r_sns)[..., None].to(torch.float32)   # [W, N, M, 1]
    rel_g = (state.pos_gts[:, None, :, :] - state.pos_ubs[:, :, None, :]) / min(
        params.range_pos, params.r_sns)
    inst = torch.broadcast_to(state.rate_per_gt[:, None, :, None] / params.max_rate,
                              vis_g.shape)
    cols = [vis_g, rel_g * vis_g, inst * vis_g]
    if params.fair_service:
        avg = state.avg_rate_per_gt[:, None, :, None] / params.max_rate \
            * params.n_gts / (params.n_ubs * params.n_rbs)
        cols.append(torch.broadcast_to(avg, vis_g.shape) * vis_g)
    gt_feats = torch.cat(cols, -1)

    adj = state.d_u2u <= params.r_comm
    return {"agent": own, "gt": gt_feats, "ubs": ubs_feats, "adj": adj}
