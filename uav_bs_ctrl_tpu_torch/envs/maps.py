"""Named scenario configurations ("maps") for the multi-UBS coverage env.

NumPy-only copy of ``uav_bs_ctrl_tpu/envs/maps.py``, kept in the port so that
layout pools draw the same positions from the same NumPy seed. Each
``set_positions`` takes an optional ``rng`` (a ``np.random.RandomState``) and
draws from it in the JAX package's order; without one it draws from
``np.random``, as the JAX package does.

Parity surface: reference ``envs/mubs_cov/maps.py`` — same registry keys
(``test``, ``debug``, exp2 ``inf``/``r400``/``r800``, exp3
``4ubs``/``6ubs``/``8ubs``), same parameters and layout generators.
Additionally provides ``swarm*`` maps (scaled UBS/GT swarms) used by the
TPU scaling benchmarks, which have no reference counterpart.
"""

import numpy as np

from uav_bs_ctrl_tpu_torch.envs.common import select_from_cube


def _rng(rng):
    return np.random if rng is None else rng


class Map:
    """Base scenario: uniform random UBS/GT layout on an integer lattice."""

    def __init__(self, range_pos=500, episode_limit=20, dt=10, n_ubs=1, n_gts=1,
                 r_cov=100.0, n_rbs=1, r_sns=np.inf, r_comm=np.inf, vels=10,
                 n_dirs=4, rew_scale=1.0):
        self.range_pos = range_pos      # Side length of the square region (m)
        self.episode_limit = episode_limit
        self.dt = dt                    # Seconds per timestep
        self.n_ubs = n_ubs
        self.n_gts = n_gts
        self.r_cov = r_cov              # Coverage radius (m)
        self.n_rbs = n_rbs              # Resource blocks per UBS
        self.r_sns = r_sns              # GT sensing radius (m)
        self.r_comm = r_comm            # UBS<->UBS communication radius (m)
        self.vels = vels                # Scalar or list of speeds (m/s)
        self.n_dirs = n_dirs            # Discrete flying directions
        self.reward_scale_rate = rew_scale

    def get_params(self) -> dict:
        return dict(self.__dict__)

    def set_positions(self, rng=None) -> dict:
        pos_ubs = select_from_cube(self.n_ubs, 0, self.range_pos, 2, rng)
        pos_gts = select_from_cube(self.n_gts, 0, self.range_pos, 2, rng)
        return dict(ubs=pos_ubs.astype(np.float32), gt=pos_gts.astype(np.float32))


class Debug(Map):
    """Deterministic fixture: pinned UBS/GT positions (reference ``maps.py:38-50``)."""

    def __init__(self, **kw):
        defaults = dict(range_pos=1000, episode_limit=10, dt=10, n_ubs=3, n_gts=4,
                        r_cov=100.0, n_rbs=1, r_sns=300.0, r_comm=np.inf,
                        vels=10.0, n_dirs=4, rew_scale=1.0)
        defaults.update(kw)
        super().__init__(**defaults)

    def set_positions(self, rng=None):
        pos_ubs = 100 * np.array([[3, 3], [8, 2], [8, 9]], dtype=np.float32)
        pos_gts = 100 * np.array([[3, 4], [4, 2], [3, 1], [6, 9]], dtype=np.float32)
        return dict(ubs=pos_ubs, gt=pos_gts)


class HotSpot(Map):
    """Exp2 scenario: one random hotspot of GTs (reference ``maps.py:56-75``)."""

    def __init__(self, **kw):
        defaults = dict(range_pos=2000, episode_limit=40, dt=20, n_ubs=4, n_gts=4,
                        r_cov=100.0, n_rbs=1, r_sns=200.0, r_comm=np.inf,
                        vels=[5, 10], n_dirs=4, rew_scale=10.0)
        defaults.update(kw)
        super().__init__(**defaults)

    def set_positions(self, rng=None):
        min_dist = 200.0
        pos_ubs = min_dist * select_from_cube(self.n_ubs, 0, self.range_pos // min_dist, 2, rng)

        range_spot = 1
        while range_spot**2 < self.n_gts:
            range_spot += 1
        pos_spot = min_dist * range_spot * select_from_cube(1, 0, self.range_pos // min_dist // range_spot, 2, rng)
        pos_gts = pos_spot + min_dist * select_from_cube(self.n_gts, 0, range_spot, 2, rng)

        pos_gts = np.clip(pos_gts, 0, self.range_pos)
        _rng(rng).shuffle(pos_gts)
        return dict(ubs=pos_ubs.astype(np.float32), gt=pos_gts.astype(np.float32))


class DenseHotSpot(Map):
    """Exp3 scenario: clustered GT groups in a hotspot (reference ``maps.py:82-113``)."""

    def __init__(self, n_grps=10, gts_per_grp=5, **kw):
        defaults = dict(range_pos=6000, episode_limit=50, dt=40, n_ubs=4,
                        n_gts=n_grps * gts_per_grp, r_cov=100.0, n_rbs=5,
                        r_sns=400.0, r_comm=np.inf, vels=[5, 10], n_dirs=4,
                        rew_scale=10.0)
        defaults.update(kw)
        super().__init__(**defaults)
        self.n_grps = n_grps
        self.gts_per_grp = gts_per_grp

    def set_positions(self, rng=None):
        min_dist = 200.0
        pos_ubs = min_dist * select_from_cube(self.n_ubs, 0, self.range_pos // min_dist, 2, rng)

        range_spot = 1
        while range_spot**2 < self.n_grps:
            range_spot += 1
        pos_spot = min_dist * range_spot * select_from_cube(1, 0, self.range_pos // min_dist // range_spot, 2, rng)
        pos_grps = pos_spot + min_dist * select_from_cube(self.n_grps, 0, range_spot, 2, rng)

        pos_gts = np.empty((self.n_gts, 2), dtype=np.float32)
        for g in range(self.n_grps):
            rows = slice(g * self.gts_per_grp, (g + 1) * self.gts_per_grp)
            pos_gts[rows] = pos_grps[g] + self.r_cov * (_rng(rng).rand(self.gts_per_grp, 2) - 0.5)

        pos_gts = np.clip(pos_gts, 0, self.range_pos)
        _rng(rng).shuffle(pos_gts)
        return dict(ubs=pos_ubs.astype(np.float32), gt=pos_gts.astype(np.float32))


class DenseHotSpotV2(Map):
    """Exp3 hard mode: one large circular hotspot (reference ``maps.py:117-132``)."""

    def __init__(self, **kw):
        defaults = dict(range_pos=6000.0, episode_limit=100, dt=10, n_ubs=4,
                        n_gts=100, r_cov=100.0, n_rbs=10, r_sns=400, r_comm=np.inf,
                        vels=[5.0, 10.0], n_dirs=4, rew_scale=10.0)
        defaults.update(kw)
        super().__init__(**defaults)

    def set_positions(self, rng=None):
        pos_ubs = 100 * select_from_cube(self.n_ubs, 0, self.range_pos // 100, 2, rng)
        radius_spot = 400
        pos_spot = radius_spot * select_from_cube(1, 1, self.range_pos // radius_spot, 2, rng)
        pos_gts = pos_spot + radius_spot * 2 * (_rng(rng).rand(self.n_gts, 2) - 0.5)
        pos_gts = np.clip(pos_gts, 0, self.range_pos)
        _rng(rng).shuffle(pos_gts)
        return dict(ubs=pos_ubs.astype(np.float32), gt=pos_gts.astype(np.float32))


MAPS = {
    "test": Map(),
    "debug": Debug(),

    # Experiment 2
    "inf": HotSpot(),
    "r400": HotSpot(r_comm=400.0),
    "r800": HotSpot(r_comm=800.0),

    # Experiment 3
    "4ubs": DenseHotSpot(n_ubs=4),
    "6ubs": DenseHotSpot(n_ubs=6),
    "8ubs": DenseHotSpot(n_ubs=8),

    # TPU scaling benchmarks: scaled UBS/GT swarms (no reference counterpart).
    "swarm16": DenseHotSpot(n_ubs=16, n_grps=20, gts_per_grp=10, n_rbs=10, range_pos=8000),
    "swarm32": DenseHotSpot(n_ubs=32, n_grps=40, gts_per_grp=10, n_rbs=10, range_pos=12000),
    "swarm64": DenseHotSpot(n_ubs=64, n_grps=80, gts_per_grp=10, n_rbs=10, range_pos=16000),
}
