"""Output heads (counterpart of ``models/heads.py``): the dueling Q head and the
QMIX monotonic mixer.

- ``DuelingLayer``: Q = V + (A - mean(A)).
- ``QMixer``: hypernetwork with abs() first/final weights (monotonicity), ELU
  hidden, state-value V(s) bias; mixes per-agent Q [..., A] with states
  [..., ds] into q_tot [..., 1]. Training only.
"""

import torch
import torch.nn.functional as F
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


class QMixer(nn.Module):
    def __init__(self, state_dim, n_agents, embed_dim):
        super().__init__()
        self.n_agents = n_agents
        self.embed_dim = embed_dim
        self.hyper_w1 = Linear(state_dim, embed_dim * n_agents)
        self.hyper_wf = Linear(state_dim, embed_dim)
        self.hyper_b1 = Linear(state_dim, embed_dim)
        self.v1 = Linear(state_dim, embed_dim)
        self.v2 = Linear(embed_dim, 1)

    def forward(self, agent_qs, states):
        """agent_qs: [..., A]; states: [..., ds] -> q_tot [..., 1]."""
        w1 = torch.abs(self.hyper_w1(states))
        w1 = w1.reshape(states.shape[:-1] + (self.n_agents, self.embed_dim))
        b1 = self.hyper_b1(states)
        hidden = F.elu(torch.einsum("...a,...ae->...e", agent_qs, w1) + b1)
        wf = torch.abs(self.hyper_wf(states))
        v = self.v2(torch.relu(self.v1(states)))
        return torch.sum(hidden * wf, dim=-1, keepdim=True) + v
