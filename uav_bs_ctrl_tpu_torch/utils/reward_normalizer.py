"""Welford running mean/std z-filter (a copy of
``uav_bs_ctrl_tpu/utils/reward_normalizer.py``).

Parity surface: reference ``algos/madrqn/utils/reward_normalizer.py`` —
``RunningStat`` (Welford update) and ``ZFilter`` (center/scale + clip).
NumPy instead of torch; instantiated by the wrapper but never invoked by the
step path, exactly like the reference (SURVEY.md §2.4 quirk 1).
"""

import numpy as np


class RunningStat:
    """Streaming mean/variance (Welford)."""

    def __init__(self, shape):
        self._n = 0
        self._m = np.zeros(shape, dtype=np.float32)
        self._s = np.zeros(shape, dtype=np.float32)

    def push(self, x):
        x = np.asarray(x, dtype=np.float32)
        assert x.shape == self._m.shape
        self._n += 1
        if self._n == 1:
            self._m[...] = x
        else:
            old_m = self._m.copy()
            self._m[...] = old_m + (x - old_m) / self._n
            self._s[...] = self._s + (x - old_m) * (x - self._m)

    @property
    def n(self):
        return self._n

    @property
    def mean(self):
        return self._m

    @property
    def var(self):
        return self._s / (self._n - 1) if self._n > 1 else np.square(self._m)

    @property
    def std(self):
        return np.sqrt(self.var)

    @property
    def shape(self):
        return self._m.shape


class ZFilter:
    """y = (x - mean) / std with running estimates and optional clipping."""

    def __init__(self, shape, center=True, scale=True, clip=None):
        assert shape is not None
        if clip is not None:
            assert clip > 0
        self.center = center
        self.scale = scale
        self.clip = clip
        self.rs = RunningStat(shape)

    def __call__(self, x, **kwargs):
        self.rs.push(x)
        x = np.asarray(x, dtype=np.float32)
        if self.center:
            x = x - self.rs.mean
        if self.scale:
            if self.center:
                x = x / (self.rs.std + 1e-8)
            else:
                x = (x - self.rs.mean) / (self.rs.std + 1e-8) + self.rs.mean
        if self.clip:
            x = np.clip(x, -self.clip, self.clip)
        return x
