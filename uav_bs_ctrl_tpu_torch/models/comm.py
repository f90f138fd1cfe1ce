"""Communication over the agents' talk graph (counterpart of ``models/comm.py``).

The talk graph is a dense adjacency ``adj[..., S, D]`` (edge src -> dst where
True). Every protocol of the JAX package's ``COMM_REGISTRY``, under its
parameter names, so that ``params_from_jax`` maps the trees by path:

- ``BaseComm``: message Linear([x; sg(h)]) per source, mean over in-edges,
  GRU([x; c], h).
- ``DiscreteComm``: 2-way hard Gumbel-softmax bits per EDGE, OR (max) over
  in-edges, decode Linear, GRU([x; dec(c)], h). The only protocol that
  draws noise: ``key`` is the noise tensor itself, an object whose
  ``noise(shape, device)`` draws it (the rollouts' ``StepKey``), or a seed
  (anything ``int()`` takes) of a generator on the inputs' device.
- ``CommNet``: mean of sg(h) over in-edges, GRU(x + Linear(c), h); rounds.
- ``TarMAC``: signature/query scores / key_size, softmax over sources per
  destination, attention-weighted value sum, GRU([x; c], h); rounds.
- ``EdgeConv``: per-edge Linear([x_s; sg(h_s); x_d; sg(h_d)]), mean over
  in-edges, GRU([x; c], h); rounds.

``sg`` (JAX's ``stop_gradient``) is ``detach``. A destination with no
in-edge receives zeros. TarMAC under ``comm_backend='graph_parallel'`` runs
``tarmac_attention_graph_parallel`` over the registered ``gp`` group (JAX
``models/comm.py:149-160``), or, with none, its dense attention after a
one-time ``RuntimeWarning``.
"""

import torch
from torch import nn

from uav_bs_ctrl_tpu_torch.models.encoders import _warn_graph_parallel_fallback
from uav_bs_ctrl_tpu_torch.models.modules import GRUCell, Linear, gumbel_softmax
from uav_bs_ctrl_tpu_torch.ops.masked import masked_max, masked_softmax
from uav_bs_ctrl_tpu_torch.parallel.graph_parallel import (
    get_graph_parallel_group, tarmac_attention_graph_parallel)


def _aggregate_mean(msg, adj):
    """Mean over valid in-edges: msg [..., S, M], adj [..., S, D] -> [..., D, M]."""
    w = adj.to(msg.dtype)
    total = torch.einsum("...sj,...sd->...jd", w, msg)
    return total / torch.clamp_min(w.sum(-2)[..., None], 1)


class BaseComm(nn.Module):
    def __init__(self, hidden, msg_size):
        super().__init__()
        self.f_msg = Linear(2 * hidden, msg_size)
        self.f_udt = GRUCell(hidden + msg_size, hidden)

    def forward(self, adj, x, h, key=None):
        msg = self.f_msg(torch.cat([x, h.detach()], dim=-1))
        return self.f_udt(torch.cat([x, _aggregate_mean(msg, adj)], dim=-1), h)


class DiscreteComm(nn.Module):
    def __init__(self, hidden, msg_size):
        super().__init__()
        self.msg_size = msg_size
        self.f_enc = Linear(2 * hidden, 2 * msg_size)
        self.f_dec = Linear(2 * msg_size, 2 * msg_size)
        self.f_udt = GRUCell(hidden + 2 * msg_size, hidden)

    def forward(self, adj, x, h, key):
        n_src, n_dst = x.shape[-2], adj.shape[-1]
        lead = x.shape[:-2]
        logits = self.f_enc(torch.cat([x, h.detach()], dim=-1))
        # Per-EDGE sampling (the reference samples in DGL's message function,
        # so each edge re-samples even from the same source).
        edge_logits = torch.broadcast_to(
            logits.reshape(lead + (n_src, 1, self.msg_size, 2)),
            lead + (n_src, n_dst, self.msg_size, 2))
        if isinstance(key, torch.Tensor):
            bits = gumbel_softmax(edge_logits, tau=0.5, hard=True, noise=key)
        elif hasattr(key, "noise"):
            bits = gumbel_softmax(edge_logits, tau=0.5, hard=True,
                                  noise=key.noise(edge_logits.shape, x.device))
        else:
            bits = gumbel_softmax(edge_logits, tau=0.5, hard=True,
                                  seed=None if key is None else int(key))
        flat = bits.reshape(lead + (n_src, n_dst, 2 * self.msg_size))
        c = masked_max(flat, adj[..., None], dim=-3)          # OR over in-edges
        return self.f_udt(torch.cat([x, self.f_dec(c)], dim=-1), h)


class CommNet(nn.Module):
    def __init__(self, hidden, n_rounds=1):
        super().__init__()
        self.n_rounds = n_rounds
        self.c_mod = Linear(hidden, hidden)
        self.f_mod = GRUCell(hidden, hidden)

    def forward(self, adj, x, h, key=None):
        for _ in range(self.n_rounds):
            c = _aggregate_mean(h.detach(), adj)
            h = self.f_mod(x + self.c_mod(c), h)
        return h


class TarMAC(nn.Module):
    """Signature/query scores / key_size, softmax over SOURCES per destination,
    attention-weighted value sum, GRU([x; c], h); ``n_rounds`` rounds."""

    def __init__(self, hidden, msg_size, key_size, n_rounds=1, backend="dense"):
        super().__init__()
        self.key_size = key_size
        self.n_rounds = n_rounds
        self.backend = backend
        self.f_val = Linear(2 * hidden, msg_size)
        self.f_sign = Linear(2 * hidden, key_size)
        self.f_que = Linear(2 * hidden, key_size)
        self.f_udt = GRUCell(hidden + msg_size, hidden)

    def gp_group(self):
        """The registered ``gp`` group under ``comm_backend='graph_parallel'``, or None."""
        return get_graph_parallel_group() if self.backend == "graph_parallel" else None

    def warn_fallback(self):
        """JAX's one-time warning when the talk attention asked for a mesh
        and none is registered."""
        if self.backend == "graph_parallel" and self.gp_group() is None:
            _warn_graph_parallel_fallback("tarmac_talk")

    def forward(self, adj, x, h, key=None):
        for _ in range(self.n_rounds):
            inputs = torch.cat([x, h.detach()], dim=-1)    # h reaches v/s/q without gradient
            v = self.f_val(inputs)                         # [..., S, msg]
            s = self.f_sign(inputs)                        # [..., S, key]
            q = self.f_que(inputs)                         # [..., D, key]
            c = self._attention(s, q, v, adj)
            h = self.f_udt(torch.cat([x, c], dim=-1), h)
        return h

    def _attention(self, s, q, v, adj):
        """Per-destination softmax attention over valid source agents."""
        group = self.gp_group()
        if group is not None:
            return tarmac_attention_graph_parallel(s, q, v, adj, self.key_size, group)
        self.warn_fallback()
        scores = torch.einsum("...sk,...dk->...sd", s, q) / self.key_size
        alpha = masked_softmax(scores, adj, dim=-2)
        return torch.einsum("...sd,...sm->...dm", alpha, v)


class EdgeConv(nn.Module):
    def __init__(self, hidden, msg_size, n_rounds=1):
        super().__init__()
        self.n_rounds = n_rounds
        self.f_msg = Linear(4 * hidden, msg_size)
        self.f_udt = GRUCell(hidden + msg_size, hidden)

    def forward(self, adj, x, h, key=None):
        n_src, n_dst = x.shape[-2], adj.shape[-1]
        lead = x.shape[:-2]
        for _ in range(self.n_rounds):
            feat = torch.cat([x, h.detach()], dim=-1)
            pair_shape = lead + (n_src, n_dst, feat.shape[-1])
            pair = torch.cat([torch.broadcast_to(feat[..., :, None, :], pair_shape),
                              torch.broadcast_to(feat[..., None, :, :], pair_shape)], dim=-1)
            msg = self.f_msg(pair)                         # [..., S, D, msg]
            w = adj.to(msg.dtype)[..., None]
            c = torch.sum(msg * w, dim=-3) / torch.clamp_min(torch.sum(w, dim=-3), 1)
            h = self.f_udt(torch.cat([x, c], dim=-1), h)
        return h


COMM_PROTOCOLS = ("base", "disc", "commnet", "tarmac", "econv")


def make_comm(args):
    """The protocol ``args.c`` names, at the args' widths."""
    hidden, msg = args.hidden_size, args.msg_size
    return {"base": lambda: BaseComm(hidden, msg),
            "disc": lambda: DiscreteComm(hidden, msg),
            "commnet": lambda: CommNet(hidden, args.n_rounds),
            "tarmac": lambda: TarMAC(hidden, msg, args.key_size, args.n_rounds,
                                     getattr(args, "comm_backend", "dense")),
            "econv": lambda: EdgeConv(hidden, msg, args.n_rounds)}[args.c]()
