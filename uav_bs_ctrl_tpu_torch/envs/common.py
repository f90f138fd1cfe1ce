"""Shared env math: the air-to-ground channel model, Jain's fairness index
and lattice sampling.

NumPy-only copy of ``uav_bs_ctrl_tpu/envs/common.py`` (``AirToGroundChannel``,
``jain_fairness_index``, ``select_from_cube``), kept in the port so it imports
nothing of the JAX package.
"""

import numpy as np

C_LIGHT = 3e8  # Speed of light (m/s)


def select_from_cube(n_els, min_val, max_val, n_dims, rng=None):
    """Draw ``n_els`` distinct integer lattice points from [min_val, max_val)^n_dims."""
    rng = rng if rng is not None else np.random
    side = int(max_val) - int(min_val)
    total = side**n_dims
    if hasattr(rng, "choice"):
        flat = rng.choice(total, size=n_els, replace=False)
    else:  # pragma: no cover
        flat = np.random.choice(total, size=n_els, replace=False)
    coords = np.empty((n_els, n_dims), dtype=np.int64)
    rem = flat
    for d in range(n_dims - 1, -1, -1):
        coords[:, d] = rem % side
        rem = rem // side
    return coords + int(min_val)


def jain_fairness_index(x) -> float:
    """Jain's fairness index: (sum x)^2 / (n * sum x^2), clipped at 1e-6."""
    x = np.asarray(x)
    if x.size == 0:
        return 1.0
    x = np.clip(x, 1e-6, np.inf)
    return float(np.square(x.sum()) / (x.size * np.square(x).sum()))


class AirToGroundChannel:
    """Probabilistic LoS/NLoS air-to-ground channel.

    gain = 1 / (p_los * FSPL * 10^(eta_los/20) + (1-p_los) * FSPL * 10^(eta_nlos/20))
    with p_los = 1 / (1 + a * exp(-b * (atan(h/d) - a))).
    """

    SCENE_PARAMS = {
        # scene: (a, b, eta_los_dB, eta_nlos_dB)
        "suburban": (4.88, 0.43, 0.1, 21),
        "urban": (9.61, 0.16, 1, 20),
        "dense-urban": (12.08, 0.11, 1.6, 23),
        "high-rise-urban": (27.23, 0.08, 2.3, 34),
    }

    def __init__(self, scene: str, fc: float):
        a, b, eta_los, eta_nlos = self.SCENE_PARAMS[scene]
        self.a, self.b = a, b
        self.eta_los, self.eta_nlos = eta_los, eta_nlos
        self.fc = fc

    def estimate_chan_gain(self, d_level, h_ubs):
        """Channel gain from horizontal distance ``d_level`` and UAV height."""
        d_level = np.asarray(d_level, dtype=np.float64)
        p_los = 1.0 / (1.0 + self.a * np.exp(-self.b * (np.arctan(h_ubs / (d_level + 1e-5)) - self.a)))
        d = np.sqrt(np.square(d_level) + np.square(h_ubs))
        fspl = (4.0 * np.pi * self.fc * d / C_LIGHT) ** 2
        pl = p_los * fspl * 10 ** (self.eta_los / 20) + (1 - p_los) * fspl * 10 ** (self.eta_nlos / 20)
        return 1.0 / pl
