"""Primitive modules: Linear, MLP, GRU cell and the Gumbel-softmax sample
(counterpart of ``models/modules.py``).

Weights keep the JAX package's layout, ``[in, out]``, under its names (``w``,
``b``; ``wi``, ``wh``, ``bi``, ``bh``), so a JAX parameter tree loads leaf by
leaf with no transposes (``utils/convert.py``). ``Linear`` and ``GRUCell``
start from U(-1/sqrt(fan), 1/sqrt(fan)), the distribution of the JAX package's
``linear_init``/``gru_init``, which the QMIX mixer relies on when it starts
without a checkpoint; served and trained weights come from a checkpoint.
"""

import math

import torch
from torch import nn


def linear(x, w, b):
    return x @ w + b


def gru(x, h, wi, wh, bi, bh):
    """GRU cell step, gate order (r, z, n): h' = (1 - z) * n + z * h."""
    i_r, i_z, i_n = torch.chunk(x @ wi + bi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(h @ wh + bh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def _uniform(shape, bound):
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound))


class Linear(nn.Module):
    def __init__(self, in_f, out_f):
        super().__init__()
        k = 1.0 / math.sqrt(in_f)
        self.w = _uniform((in_f, out_f), k)
        self.b = _uniform((out_f,), k)

    def forward(self, x):
        return linear(x, self.w, self.b)


class MLP(nn.Module):
    """``n_layers`` x (Linear -> ReLU)."""

    def __init__(self, in_f, hidden, n_layers):
        super().__init__()
        self.layers = nn.ModuleList(
            [Linear(in_f if i == 0 else hidden, hidden) for i in range(n_layers)])

    def forward(self, x):
        for layer in self.layers:
            x = torch.relu(layer(x))
        return x


class GRUCell(nn.Module):
    def __init__(self, in_f, hidden):
        super().__init__()
        k = 1.0 / math.sqrt(hidden)
        self.wi = _uniform((in_f, 3 * hidden), k)
        self.wh = _uniform((hidden, 3 * hidden), k)
        self.bi = _uniform((3 * hidden,), k)
        self.bh = _uniform((3 * hidden,), k)

    def forward(self, x, h):
        return gru(x, h, self.wi, self.wh, self.bi, self.bh)


def gumbel_noise(shape, seed, device):
    """Float32 Gumbel(0, 1) noise of ``shape`` drawn on ``device`` from a
    generator of that device seeded with ``seed`` (the card's Philox stream
    differs from the CPU's Mersenne Twister, so one seed gives other noise on
    each), whatever the process's default dtype."""
    return gumbel_draw(shape, torch.Generator(device=device).manual_seed(seed), device)


def gumbel_draw(shape, generator, device):
    """Float32 Gumbel(0, 1) noise of ``shape`` on ``device`` from ``generator``
    (a generator of that device), advancing it."""
    draw = torch.empty(shape, dtype=torch.float32, device=device).exponential_(
        generator=generator)
    return -draw.clamp_min(torch.finfo(draw.dtype).tiny).log()


def gumbel_softmax(logits, tau=1.0, hard=False, seed=None, noise=None):
    """Gumbel-softmax over the last dim (torch ``F.gumbel_softmax`` semantics).

    The noise is ``noise`` when given (a tensor of ``logits``' shape, e.g. the
    JAX package's ``jax.random.gumbel`` draw), else ``gumbel_noise`` from
    ``seed`` on ``logits``' device; it is drawn in f32 and rounded to
    ``logits``' dtype, where JAX draws it (``jax.random.gumbel(key, shape,
    logits.dtype)``), so a bf16 step stays bf16. ``hard`` gives the one-hot
    of the argmax forward and the soft sample's gradient (straight-through).
    """
    if noise is None:
        if seed is None:
            raise ValueError("gumbel_softmax needs a seed or the noise itself")
        noise = gumbel_noise(logits.shape, seed, logits.device)
    noise = noise.to(logits.dtype)
    y_soft = torch.softmax((logits + noise) / tau, dim=-1)
    if not hard:
        return y_soft
    # The one-hot of the argmax by a scatter: ``F.one_hot`` checks its classes
    # on the host (a sync) for a CPU tensor.
    y_hard = torch.zeros_like(y_soft).scatter_(-1, y_soft.argmax(-1, keepdim=True), 1.0)
    return y_soft + (y_hard - y_soft).detach()
