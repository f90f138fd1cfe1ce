"""Seeded inputs of the env scheduler's tests (``test_torch_env_schedule*.py``).

Positions on an integer grid, gains and GT priorities are made with numpy
from a seed; ``d_u2g`` is the f32 distance of the positions. World 0 holds the
edge cases, each found by :func:`edge_outcomes`:

- GT 0 far from every UBS (no UBS covers it);
- GT 1, first in priority, exactly 30 m from UBS 0 and from UBS 1, which
  stand apart (the first index must win);
- R + 2 GTs around UBS N-1, which stands apart (it runs out of RBs);
- the last world, when there are two or more: UBSs 1 km apart and every GT
  within 80 m of one of them, so no GT hears a second UBS and every RB's
  interference is 0 (the first idle RB must win).

The other worlds scatter the UBSs and GTs over a square of about 1.4
coverage discs a GT, so GTs are left uncovered, heard by several UBSs, and
compete for RBs.
"""

import numpy as np

from uav_bs_ctrl_tpu_torch.envs import torch_env

# name: (map, overrides) -> (N, M, R)
SHAPES = {
    "8ubs": ("8ubs", {}),                                   # exp3 8-UBS: (8, 50, 5)
    "exp2": ("inf", {}),                                    # exp2: (4, 4, 1)
    "hotspot_v2": ("4ubs", dict(n_gts=100, n_rbs=10)),      # DenseHotSpotV2: (4, 100, 10)
    "swarm16": ("swarm16", {}),                             # a cut-down swarm: (16, 200, 10)
}
WORLDS = {"8ubs": 8, "exp2": 8, "hotspot_v2": 4, "swarm16": 2}


def params_of(env_module, name):
    """``env_module.make_params`` of the shape ``name`` (``torch_env`` or ``jax_env``)."""
    map_id, overrides = SHAPES[name]
    return env_module.make_params(map_id)._replace(**overrides)


def make_case(params, n_worlds, seed):
    """``dict(d, gain, prior)``: [W, N, M] f32, [W, N, M] f32, [W, M] int64."""
    rng = np.random.default_rng(seed)
    N, M, R = params.n_ubs, params.n_gts, params.n_rbs
    side = int(np.sqrt(np.pi * params.r_cov ** 2 * N / 1.4))
    ubs = rng.integers(0, side, (n_worlds, N, 2)).astype(np.float32)
    gts = rng.integers(0, side, (n_worlds, M, 2)).astype(np.float32)
    prior = np.argsort(rng.random((n_worlds, M)), -1).astype(np.int64)
    gts[0, 0] = (-10_000.0, -10_000.0)                        # covered by no UBS
    if M > 1:
        gts[0, 1] = (side + 2_000.0, side // 2)              # UBSs 0 and 1 at 30 m each
        ubs[0, 0] = gts[0, 1] - (30.0, 0.0)
        ubs[0, 1] = gts[0, 1] + (30.0, 0.0)
        prior[0] = np.concatenate([[1], prior[0][prior[0] != 1]])
    crowd = range(2, min(M, R + 4))                           # R + 2 GTs on UBS N-1, apart
    ubs[0, N - 1] = (side + 5_000.0, side + 5_000.0)
    for k, m in enumerate(crowd):
        gts[0, m] = ubs[0, N - 1] + (float(k % 7) * 10.0, float(k // 7) * 10.0)
    if n_worlds > 1:                                          # no GT hears two UBSs
        w = n_worlds - 1
        ubs[w] = 1_000.0 * np.stack([np.arange(N) % 8, np.arange(N) // 8], -1)
        owner = rng.integers(0, N, M)
        gts[w] = ubs[w, owner] + rng.integers(-56, 57, (M, 2))
    d = np.sqrt(np.square(ubs[:, :, None, :] - gts[:, None, :, :]).sum(-1)).astype(np.float32)
    gain = (10.0 ** rng.uniform(-11.0, -8.0, (n_worlds, N, M))).astype(np.float32)
    return dict(d=d, gain=gain, prior=prior)


def edge_outcomes(params, case, assign):
    """The edge cases' outcomes in an assignment ``[W, M]`` (i * R + c, -1
    unserved): whether GT 0 of world 0 went unserved, whether GT 1 went to
    UBS 0, whether UBS N-1 used all R RBs and left the rest of its crowd
    unserved, and (the last world) whether each UBS's RBs went 0, 1, 2, ...
    in priority order."""
    R, N = params.n_rbs, params.n_ubs
    a = np.asarray(assign)
    out = dict(uncovered=bool(a[0, 0] == -1))
    if params.n_gts > 1:
        out["first_of_equals"] = bool(a[0, 1] >= 0 and a[0, 1] // R == 0)
    crowd = a[0, 2:min(params.n_gts, R + 4)]
    if len(crowd) > R:
        out["out_of_rbs"] = bool((crowd // R == N - 1).sum() == R and (crowd == -1).sum()
                                 == len(crowd) - R)
    if a.shape[0] > 1:
        w, order = a.shape[0] - 1, case["prior"][-1]
        served = [a[w, m] for m in order if a[w, m] >= 0]
        next_rb = np.zeros(N, int)
        ok = bool(served)
        for x in served:
            ok &= bool(x % R == next_rb[x // R])
            next_rb[x // R] += 1
        out["first_rb_at_zero_itf"] = ok
    return out
