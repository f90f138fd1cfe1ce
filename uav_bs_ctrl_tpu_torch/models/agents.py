"""Recurrent agents (counterpart of ``models/agents.py``).

- ``RnnAgent``: MLP(obs) -> GRU cell -> (dueling) Q head, the agent of
  ``o='mlp'`` without comm.
- ``GnnAgent``: encoder (the hetero-GATv2 ``GraphObservationEncoder`` for a
  dict obs shape, the MLP ``DenseObservationEncoder`` for an int one) -> comm
  protocol on the talk graph (or a GRU cell when ``c`` is None) -> (dueling)
  Q head.
- ``DrqnGnnAgent``: the exp1 agent, one GATv2 (GT -> agent) over every GT
  row -> GRU cell -> Q head.

``build_agent`` picks between them by the JAX package's rule. ``encode`` is
the h-independent observation encoding, ``step`` the recurrent part, and
calling the module (``forward``) is ``step . encode``, the JAX ``apply``;
``key`` (a seed or the noise tensor) reaches the comm, where only
DiscreteComm draws from it; ``noise_shape`` says what one step draws.

With ``use_kernels`` (the default) the encoder goes through the kernel of its
``gat_backend`` (``flash_gat`` for 'pallas', else ``flash_gat_fused_train``)
and, for one-round TarMAC, the step through ``tarmac_step_train`` (the
fused step the JAX package takes under ``step_backend='pallas'``; the port
takes it under either step backend; not while a ``gp`` group runs the talk
attention edge-partitioned); the CUDA kernels on a card, their plain
versions on the CPU. Every other step runs on plain torch modules, as the JAX
step does under ``step_backend='xla'``. ``use_kernels=False`` takes the
unfused module path, whose autograd is the independent reference.
"""

import torch
from torch import nn

from uav_bs_ctrl_tpu_torch.models.comm import DiscreteComm, make_comm
from uav_bs_ctrl_tpu_torch.models.encoders import (DenseObservationEncoder, GATv2,
                                                   GraphObservationEncoder)
from uav_bs_ctrl_tpu_torch.models.heads import DuelingLayer
from uav_bs_ctrl_tpu_torch.models.modules import GRUCell, Linear
from uav_bs_ctrl_tpu_torch.ops.step_kernels import tarmac_step_train


def _head(hidden, n_actions, dueling):
    return DuelingLayer(hidden, n_actions) if dueling else Linear(hidden, n_actions)


class RnnAgent(nn.Module):
    """MLP encoder -> GRU -> (dueling) Q head, used when the obs is flat and
    there is no comm. It has no kernel and reads no key."""

    def __init__(self, obs_shape: int, n_actions, args):
        super().__init__()
        self.hidden = args.hidden_size
        self.enc = DenseObservationEncoder(obs_shape, args.hidden_size, args.n_layers)
        self.rnn = GRUCell(args.hidden_size, args.hidden_size)
        self.f_out = _head(args.hidden_size, n_actions, bool(args.dueling))

    def encode(self, obs, use_kernels=True):
        return self.enc(obs)

    def step(self, x, adj, h, use_kernels=True, key=None):
        h = self.rnn(x, h)
        return self.f_out(h), h

    def forward(self, obs, h, use_kernels=True, key=None):
        return self.step(self.encode(obs), None, h)

    def noise_shape(self, lead, n_agents):
        return None


class GnnAgent(nn.Module):
    def __init__(self, obs_shape, n_actions, args):
        super().__init__()
        self.hidden = args.hidden_size
        self.key_size = args.key_size
        self.dueling = bool(args.dueling)
        if isinstance(obs_shape, int):
            self.enc = DenseObservationEncoder(obs_shape, args.hidden_size, args.n_layers)
        elif isinstance(obs_shape, dict):
            self.enc = GraphObservationEncoder(obs_shape, args.hidden_size, args.n_heads,
                                               args.gat_backend)
        else:
            raise TypeError(f"Unsupported obs_shape {obs_shape!r}")
        if args.c is None:
            self.rnn = GRUCell(args.hidden_size, args.hidden_size)
            self.f_comm = None
        else:
            self.f_comm = make_comm(args)
        self.f_out = _head(args.hidden_size, n_actions, self.dueling)
        self.fused_step = args.c == "tarmac" and args.n_rounds == 1

    def encode(self, obs, use_kernels=True):
        return self.enc(obs, use_kernels)                  # [..., A, hidden]

    def step(self, x, adj, h, use_kernels=True, key=None):
        if use_kernels and self.fused_step and self.f_comm.gp_group() is None:
            return self._step_fused(x, adj, h)
        h = self.rnn(x, h) if self.f_comm is None else self.f_comm(adj, x, h, key)
        return self.f_out(h), h

    def forward(self, obs, h, use_kernels=True, key=None):
        return self.step(self.encode(obs, use_kernels), obs.get("adj"), h, use_kernels, key)

    def noise_shape(self, lead, n_agents):
        """The shape of the Gumbel noise one step reads for ``lead`` batch dims
        of ``n_agents`` agents (one draw per edge and bit), or None when the
        step reads no key: only DiscreteComm samples."""
        if not isinstance(self.f_comm, DiscreteComm):
            return None
        return tuple(lead) + (n_agents, n_agents, self.f_comm.msg_size, 2)

    def _step_fused(self, x, adj, h):
        """Flatten [..., A, H] rows world-major, run one fused step, restore the shape."""
        a, hidden = x.shape[-2], x.shape[-1]
        lead = x.shape[:-2]
        adjf = torch.broadcast_to(adj, lead + (a, a)).reshape(-1, a)
        if self.dueling:
            wo, bo = self.f_out.adv.w, self.f_out.adv.b
            wvh, bvh = self.f_out.v.w, self.f_out.v.b
        else:
            wo, bo = self.f_out.w, self.f_out.b
            wvh = torch.zeros((hidden, 1), dtype=x.dtype, device=x.device)
            bvh = torch.zeros((1,), dtype=x.dtype, device=x.device)
        c = self.f_comm
        c.warn_fallback()
        q, h_new = tarmac_step_train(
            x.reshape(-1, hidden).contiguous(), h.reshape(-1, hidden).contiguous(),
            adjf.to(x.dtype).contiguous(),
            c.f_val.w, c.f_val.b, c.f_sign.w, c.f_sign.b, c.f_que.w, c.f_que.b,
            c.f_udt.wi, c.f_udt.wh, c.f_udt.bi, c.f_udt.bh,
            wo, bo, wvh, bvh, a, self.key_size, self.dueling)
        return q.reshape(lead + (a, -1)), h_new.reshape(lead + (a, hidden))


class DrqnGnnAgent(nn.Module):
    """Single-relation GATv2 (GT -> agent) -> GRU -> Linear(Q), the exp1 agent
    (JAX ``models/agents.py:DrqnGnnAgent``).

    The drqn graph builder attaches every GT row with its full feature vector
    (no visibility flag), so the neighbourhood mask is all ones. The GATv2 has
    ``n_heads`` heads of ``hidden / n_heads`` and a residual from the agent's
    features; with ``use_kernels`` it runs ``flash_gat_fused_train``. It reads
    no key.
    """

    def __init__(self, obs_shape: dict, n_actions, args):
        super().__init__()
        self.hidden = args.hidden_size
        if self.hidden % args.n_heads:
            raise ValueError(f"hidden_size {self.hidden} is not a multiple of n_heads "
                             f"{args.n_heads}")
        self.enc = GATv2(obs_shape["gt"], obs_shape["agent"], args.n_heads,
                         self.hidden // args.n_heads)
        self.rnn = GRUCell(self.hidden, self.hidden)
        self.f_out = Linear(self.hidden, n_actions)

    def encode(self, obs, use_kernels=True):
        gt = obs["gt"]                                     # [..., 1, M, d_gt]
        mask = torch.ones(gt.shape[:-1], dtype=torch.bool, device=gt.device)
        return self.enc(gt, obs["agent"], mask, use_kernels)

    def step(self, x, adj, h, use_kernels=True, key=None):
        h = self.rnn(x, h)
        return self.f_out(h), h

    def forward(self, obs, h, use_kernels=True, key=None):
        return self.step(self.encode(obs, use_kernels), None, h)

    def noise_shape(self, lead, n_agents):
        return None


def build_agent(obs_shape, n_actions, args):
    """The madrqn agent rule (reference ``algos/madrqn/learner.py:62-67``):
    ``RnnAgent`` iff ``o == 'mlp'`` and ``c`` is None, else ``GnnAgent``."""
    if args.o == "mlp" and args.c is None:
        return RnnAgent(obs_shape, n_actions, args)
    return GnnAgent(obs_shape, n_actions, args)


REGISTRY = {"rnn": RnnAgent, "gnn": GnnAgent}
DRQN_REGISTRY = {"rnn": RnnAgent, "gnn": DrqnGnnAgent}
