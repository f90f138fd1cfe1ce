"""Dueling Q head (counterpart of ``models/heads.py:DuelingLayer``).

The QMIX mixer is training-only and is still to be ported (ROADMAP.md).
"""

from torch import nn

from uav_bs_ctrl_tpu_torch.models.modules import Linear


class DuelingLayer(nn.Module):
    """Q = V + (A - mean(A))."""

    def __init__(self, in_feats, n_actions):
        super().__init__()
        self.adv = Linear(in_feats, n_actions)
        self.v = Linear(in_feats, 1)

    def forward(self, x):
        advs = self.adv(x)
        return self.v(x) + (advs - advs.mean(-1, keepdim=True))
