"""Observation encoders (counterpart of ``models/encoders.py``): the
heterograph GATv2 encoder and the dense MLP encoder over the flat observation.

Each agent owns fixed-size neighbourhood slot arrays (``[..., A, M, d]``
features plus a ``[..., A, M]`` visibility mask), exactly the env's obs layout.

The JAX package's ``gat_backend`` picks the kernel: ``'pallas'`` projects
``el = fc_src(x_src)`` as a plain product and runs ``flash_gat`` over it (the
inference-only path: the kernel has no gradient); every other backend runs
the projection-fused ``flash_gat_fused_train``. ``'graph_parallel'`` with a
``gp`` group registered (``parallel.graph_parallel.set_graph_parallel_mesh``)
runs ``gatv2_graph_parallel`` on the slot axis padded to the group's size,
whatever ``use_kernels`` says (JAX's path is plain too); with none it runs as
the dense backend does, after a one-time ``RuntimeWarning`` per slot count
with the JAX package's text (``models/encoders.py:31-50``).
"""

import math
import warnings

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from uav_bs_ctrl_tpu_torch.models.modules import MLP, Linear
from uav_bs_ctrl_tpu_torch.ops.gat_kernels import flash_gat, flash_gat_fused_train
from uav_bs_ctrl_tpu_torch.ops.masked import masked_softmax
from uav_bs_ctrl_tpu_torch.parallel.graph_parallel import (
    gatv2_graph_parallel, get_graph_parallel_group, pad_slot_axis)

_gp_fallback_warned = set()


def _warn_graph_parallel_fallback(n_slots):
    """One-time warning, per slot count (or ``'tarmac_talk'``), that
    ``'graph_parallel'`` ran as the dense backend: no mesh is registered."""
    if n_slots in _gp_fallback_warned:
        return
    _gp_fallback_warned.add(n_slots)
    warnings.warn(
        f"backend='graph_parallel' ({n_slots}) fell back to dense: no mesh "
        "registered (parallel.graph_parallel.set_graph_parallel_mesh)",
        RuntimeWarning, stacklevel=3)


class GATv2(nn.Module):
    """Masked bipartite GATv2 with residual and ReLU (DGL 0.9 ``GATv2Conv``):
    ``e_ij = a . LeakyReLU(W_src x_j + W_dst x_i)``, softmax over each
    destination's valid slots, message ``W_src x_j``; no valid slot leaves the
    residual only."""

    def __init__(self, d_src, d_dst, n_heads, feats_per_head, negative_slope=0.2,
                 backend="dense"):
        super().__init__()
        out = n_heads * feats_per_head
        self.n_heads = n_heads
        self.backend = backend
        self.negative_slope = negative_slope
        self.fc_src = Linear(d_src, out)
        self.fc_dst = Linear(d_dst, out)
        k = 1.0 / math.sqrt(feats_per_head)
        self.attn = nn.Parameter(torch.empty(n_heads, feats_per_head).uniform_(-k, k))
        self.res_fc = Linear(d_dst, out) if d_dst != out else None

    def forward(self, x_src, x_dst, mask, use_kernels=True):
        """x_src: [..., M, d_src], x_dst: [..., d_dst], mask: [..., M] bool.

        ``use_kernels`` takes the backend's kernel: ``flash_gat`` (one launch,
        no gradient) for ``'pallas'``, else ``flash_gat_fused_train`` (one
        forward launch, and under autograd one backward launch); the CUDA
        kernels on a card, their plain versions on the CPU. ``False`` takes
        the dense path, whose autograd is the independent reference.
        """
        if self.backend == "graph_parallel" and x_src.shape[-2]:
            group = get_graph_parallel_group()
            if group is not None:
                x_src, mask = pad_slot_axis(x_src, mask, dist.get_world_size(group))
                return gatv2_graph_parallel(self, x_src, x_dst, mask, self.n_heads, group,
                                            self.negative_slope)
            _warn_graph_parallel_fallback(x_src.shape[-2])
        res = self.res_fc(x_dst) if self.res_fc is not None else x_dst
        if x_src.shape[-2] == 0:          # no slots at all: residual only
            return torch.relu(res)
        er = self.fc_dst(x_dst)                                   # [..., H*F]
        hf = er.shape[-1]
        if use_kernels:
            batch = x_src.shape[:-2]
            m, d = x_src.shape[-2:]
            mask2 = torch.broadcast_to(mask, batch + (m,)).reshape(-1, m)
            mask2 = mask2.to(x_src.dtype).contiguous()
            er2 = er.reshape(-1, hf).contiguous()
            if self.backend == "pallas":
                el = self.fc_src(x_src).reshape(-1, m, hf)        # a plain product, as in JAX
                ft = flash_gat(el.contiguous(), er2, self.attn, mask2, self.n_heads,
                               self.negative_slope)
            else:
                ft = flash_gat_fused_train(
                    x_src.reshape(-1, m, d).contiguous(), self.fc_src.w, self.fc_src.b, er2,
                    self.attn, mask2, self.n_heads, self.negative_slope)
            rst = ft.reshape(batch + (hf,))
        else:
            feats = hf // self.n_heads
            el = self.fc_src(x_src)                               # [..., M, H*F]
            el_h = el.reshape(el.shape[:-1] + (self.n_heads, feats))
            er_h = er.reshape(er.shape[:-1] + (1, self.n_heads, feats))
            e = F.leaky_relu(el_h + er_h, self.negative_slope)    # [..., M, H, F]
            scores = (e * self.attn).sum(-1)                      # [..., M, H]
            alpha = masked_softmax(scores, mask[..., None], dim=-2)
            ft = (alpha[..., None] * el_h).sum(-3)                # [..., H, F]
            rst = ft.reshape(ft.shape[:-2] + (hf,))
        return torch.relu(rst + res)


class GraphObservationEncoder(nn.Module):
    """GATv2 per relation ('seen': GT -> agent, 'near': UBS -> agent), concat,
    Linear + ReLU.

    obs: 'agent' [..., A, d_agent]; 'gt' [..., A, M, 1 + d_gt]; 'ubs'
    [..., A, K, 1 + d_ubs]. Column 0 of a gt/ubs row is the visibility flag
    used as the slot mask; columns 1: are the features.
    """

    def __init__(self, obs_shape: dict, hidden, n_heads, backend="dense"):
        super().__init__()
        if hidden % n_heads:
            raise ValueError(f"hidden_size {hidden} is not a multiple of n_heads {n_heads}")
        f = hidden // n_heads
        self.seen = GATv2(obs_shape["gt"], obs_shape["agent"], n_heads, f, backend=backend)
        self.near = GATv2(obs_shape["ubs"], obs_shape["agent"], n_heads, f, backend=backend)
        self.aggr = Linear(2 * hidden, hidden)

    def forward(self, obs, use_kernels=True):
        gt, ubs = obs["gt"], obs["ubs"]
        x_gt = self.seen(gt[..., 1:], obs["agent"], gt[..., 0] > 0, use_kernels)
        x_ubs = self.near(ubs[..., 1:], obs["agent"], ubs[..., 0] > 0, use_kernels)
        return torch.relu(self.aggr(torch.cat([x_gt, x_ubs], dim=-1)))


class DenseObservationEncoder(MLP):
    """MLP on the agent's flat features ``obs["agent"]`` [..., A, d]
    (reference D1). Its parameters are the MLP's, ``layers.i.{w, b}``, as the
    JAX tree ``{"layers": [...]}``; there is no kernel, so ``use_kernels``
    changes nothing."""

    def forward(self, obs, use_kernels=True):
        return super().forward(obs["agent"])
