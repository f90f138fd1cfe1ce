"""TarMAC communication over the agents' talk graph (counterpart of ``models/comm.py``).

The talk graph is a dense adjacency ``adj[..., S, D]`` (edge src -> dst where
True). Only TarMAC is ported; the other protocols are still to be ported
(ROADMAP.md Queue 1).
"""

import torch
from torch import nn

from uav_bs_ctrl_tpu_torch.models.modules import GRUCell, Linear
from uav_bs_ctrl_tpu_torch.ops.masked import masked_softmax


class TarMAC(nn.Module):
    """Signature/query scores / key_size, softmax over SOURCES per destination,
    attention-weighted value sum, GRU([x; c], h); ``n_rounds`` rounds."""

    def __init__(self, hidden, msg_size, key_size, n_rounds=1):
        super().__init__()
        self.key_size = key_size
        self.n_rounds = n_rounds
        self.f_val = Linear(2 * hidden, msg_size)
        self.f_sign = Linear(2 * hidden, key_size)
        self.f_que = Linear(2 * hidden, key_size)
        self.f_udt = GRUCell(hidden + msg_size, hidden)

    def forward(self, adj, x, h):
        for _ in range(self.n_rounds):
            inputs = torch.cat([x, h.detach()], dim=-1)    # h reaches v/s/q without gradient
            v = self.f_val(inputs)                         # [..., S, msg]
            s = self.f_sign(inputs)                        # [..., S, key]
            q = self.f_que(inputs)                         # [..., D, key]
            scores = torch.einsum("...sk,...dk->...sd", s, q) / self.key_size
            alpha = masked_softmax(scores, adj, dim=-2)
            c = torch.einsum("...sd,...sm->...dm", alpha, v)
            h = self.f_udt(torch.cat([x, c], dim=-1), h)
        return h
