"""Minimal gym-compatible space dataclasses (a copy of
``uav_bs_ctrl_tpu/envs/spaces.py``, kept in the port so that it imports
nothing of the JAX package).

The reference depends on gym 0.21 spaces (``Discrete``/``Box``/``Dict``) and
``gym.spaces.utils.flatten_space``/``flatten`` (see reference
``envs/mubs_cov/mubs_cov.py:70-76`` and
``algos/madrqn/utils/env_wrappers.py:7,46-53``).  gym is not a dependency of
this framework; these small classes reproduce the used surface.

Crucial behavioral detail: gym's ``Dict`` space holds its subspaces in an
``OrderedDict`` sorted by key, and ``flatten`` concatenates raveled entries in
that sorted-key order.  The MLP-encoder path depends on this ordering
(``agent`` < ``gt`` < ``ubs``), so we sort keys identically.
"""

from collections import OrderedDict

import numpy as np


class Space:
    pass


class Discrete(Space):
    def __init__(self, n):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.int64

    def sample(self, rng=None):
        rng = rng or np.random
        return int(rng.integers(self.n)) if hasattr(rng, "integers") else int(rng.randint(self.n))

    def contains(self, x):
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"


class Box(Space):
    def __init__(self, low, high, shape=None, dtype=np.float32):
        self.shape = tuple(int(s) for s in np.atleast_1d(shape)) if shape is not None else np.broadcast(low, high).shape
        self.low = np.broadcast_to(np.asarray(low, dtype=dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, dtype=dtype), self.shape)
        self.dtype = dtype

    def __repr__(self):
        return f"Box{self.shape}"


class Dict(Space):
    def __init__(self, spaces=None, **kwargs):
        spaces = dict(spaces or {}, **kwargs)
        # gym sorts dict spaces by key; flatten order depends on it.
        self.spaces = OrderedDict(sorted(spaces.items()))

    def __getitem__(self, key):
        return self.spaces[key]

    def __repr__(self):
        return "Dict(" + ", ".join(f"{k}: {v}" for k, v in self.spaces.items()) + ")"


def flatdim(space) -> int:
    """Number of scalar entries in a flattened sample of ``space``."""
    if isinstance(space, Box):
        return int(np.prod(space.shape))
    if isinstance(space, Discrete):
        return space.n
    if isinstance(space, Dict):
        return sum(flatdim(s) for s in space.spaces.values())
    raise TypeError(f"Unsupported space {space!r}")


def flatten_space(space) -> Box:
    """Flatten a space into a 1-D Box (gym ``flatten_space`` equivalent)."""
    return Box(-np.inf, np.inf, shape=(flatdim(space),))


def flatten(space, x) -> np.ndarray:
    """Flatten a sample ``x`` of ``space`` to a 1-D float32 array.

    Matches gym semantics: Dict entries are concatenated in sorted-key order;
    Discrete becomes a one-hot vector; Box is raveled (C order).
    """
    if isinstance(space, Box):
        return np.asarray(x, dtype=np.float32).ravel()
    if isinstance(space, Discrete):
        onehot = np.zeros(space.n, dtype=np.float32)
        onehot[int(x)] = 1.0
        return onehot
    if isinstance(space, Dict):
        return np.concatenate([flatten(s, x[k]) for k, s in space.spaces.items()])
    raise TypeError(f"Unsupported space {space!r}")
