"""Graph parallelism: the relations' slot axis partitioned over a process group
(counterpart of ``parallel/graph_parallel.py``).

In the dense-masked layout an edge partition of a relation is a shard of its
slot axis: each rank of the ``gp`` group holds M/gp candidate slots per
destination and computes a partial masked softmax; an all-reduce of the row
maxima (detached), a summed denominator and a summed weighted aggregate give
the exact global softmax on every rank. The TarMAC talk graph is split the
same way over its source agents. Both are plain torch plus collectives, as
the JAX package computes them inside ``shard_map``; no kernel runs here.

**The autograd rule.** JAX's ``shard_map`` has a replicated output and a
replicated loss on every rank. To give every rank the dense gradient with no
gradient all-reduce over ``gp`` afterwards:

- (a) a **sharded** input taken into the local block (GATv2's ``el`` and
  ``mask``, TarMAC's ``s``, ``v`` and ``adj``) is a slice forward and an
  **all-gather** of the block cotangents backward (:class:`Shard`);
- (b) a **replicated** input used whole inside every rank's block (``er``,
  the ``attn`` parameter, TarMAC's ``q``) is the identity forward and an
  **all-reduce sum** backward (:class:`Replicate`): each block adds only its
  own slots' share of the cotangent;
- (c) the combining sums (denominator, weighted sum) are an all-reduce sum
  forward and the **identity** backward (:class:`Combine`): the output is
  replicated, so each rank's cotangent of it is already the whole one;
  ``torch.distributed.nn.functional.all_reduce`` does not fit, since its
  backward all-reduces the cotangent and counts a replicated loss gp times;
- (d) the max shift is detached (an all-reduce ``MAX``): it cancels in the
  softmax.

A mistake here shows as gradients off by a factor of gp or missing terms;
``tests/test_torch_parallel_graph.py`` holds both functions' outputs and
gradients to ``jax.grad`` of JAX's, and plants each inversion.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from uav_bs_ctrl_tpu_torch.ops.masked import NEG_BIG
from uav_bs_ctrl_tpu_torch.parallel.dist import all_gather, all_reduce

# The registered (mesh, axis): ``gat_backend``/``comm_backend='graph_parallel'``
# read it at each call, so a learner switches onto the edge-partitioned path
# by one registration (``distribute_learner(..., graph_parallel=True)``).
_GP_MESH = None
_GP_AXIS = "gp"


def set_graph_parallel_mesh(mesh, axis="gp"):
    """Register the ``DeviceMesh`` and axis that ``'graph_parallel'`` uses
    (None clears it)."""
    global _GP_MESH, _GP_AXIS
    _GP_MESH = mesh
    _GP_AXIS = axis


def get_graph_parallel_mesh():
    return _GP_MESH, _GP_AXIS


def get_graph_parallel_group():
    """The registered ``gp`` process group, or None."""
    return None if _GP_MESH is None else _GP_MESH.get_group(_GP_AXIS)


def pad_slot_axis(x_src, mask, axis_size):
    """Pad the slot axis (``x_src[..., M, d]`` / ``mask[..., M]``) to a
    multiple of ``axis_size`` with masked (all-invalid) slots: exact, since a
    masked slot has zero weight."""
    pad = (-x_src.shape[-2]) % axis_size
    if pad == 0:
        return x_src, mask
    return F.pad(x_src, (0, 0, 0, pad)), F.pad(mask, (0, pad), value=False)


def _block(n, group):
    """This rank's ``[lo, hi)`` of an axis of ``n`` entries split over ``group``."""
    size = n // dist.get_world_size(group)
    lo = dist.get_rank(group) * size
    return lo, lo + size


class Shard(torch.autograd.Function):
    """Rule (a): this rank's block of axis ``dim`` forward, the all-gathered
    block cotangents backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        lo, hi = _block(x.shape[dim], group)
        return x.narrow(dim, lo, hi - lo).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(all_gather(grad.contiguous(), ctx.group), ctx.dim), None, None


class Replicate(torch.autograd.Function):
    """Rule (b): the identity forward, an all-reduce sum of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


class Combine(torch.autograd.Function):
    """Rule (c): an all-reduce sum forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _partial_softmax(scores, mask, group):
    """Rule (d)'s shift and the block's unnormalised weights: ``scores`` and
    ``mask`` [N, S_loc, D]; returns ``w`` [N, S_loc, D]."""
    scores = torch.where(mask, scores, NEG_BIG)
    local_max = scores.detach().amax(1)                          # [N, D]
    global_max = all_reduce(local_max, group, dist.ReduceOp.MAX)
    shift = torch.where(global_max <= NEG_BIG / 2, 0.0, global_max)
    return torch.where(mask, torch.exp(scores - shift[:, None, :]), 0.0)


def gatv2_graph_parallel(gat, x_src, x_dst, mask, n_heads, group, negative_slope=0.2,
                         activation=torch.relu):
    """Masked bipartite GATv2 (the port's ``GATv2`` module ``gat``: ``fc_src``,
    ``fc_dst``, ``attn``, ``res_fc``) with the source-slot axis split over
    ``group``; M must divide by its size (:func:`pad_slot_axis`).

    x_src: [..., M, d_src], x_dst: [..., d_dst], mask: [..., M] -> [..., H*F],
    replicated on every rank, with every gradient dense."""
    el = gat.fc_src(x_src)                                       # [..., M, H*F]
    er = gat.fc_dst(x_dst)                                       # [..., H*F]
    hf = er.shape[-1]
    feats = hf // n_heads
    batch = x_src.shape[:-2]
    m = x_src.shape[-2]
    lo, hi = _block(m, group)
    el_blk = Shard.apply(el.reshape(-1, m, hf), 1, group)      # [N, M_loc, H*F]
    mask_blk = torch.broadcast_to(mask, batch + (m,)).reshape(-1, m)[:, lo:hi]
    n = el_blk.shape[0]
    el_h = el_blk.reshape(n, hi - lo, n_heads, feats)
    er_h = Replicate.apply(er.reshape(-1, hf), group).reshape(n, 1, n_heads, feats)
    attn = Replicate.apply(gat.attn, group)
    scores = (F.leaky_relu(el_h + er_h, negative_slope) * attn).sum(-1)   # [N, M_loc, H]
    w = _partial_softmax(scores, mask_blk[..., None].expand(-1, -1, n_heads), group)
    denom = Combine.apply(w.sum(1), group)                                 # [N, H]
    acc = Combine.apply(torch.einsum("nmh,nmhf->nhf", w, el_h), group)    # [N, H, F]
    ft = (acc / torch.clamp_min(denom, 1e-30)[..., None]).reshape(batch + (hf,))
    rst = ft + (gat.res_fc(x_dst) if gat.res_fc is not None else x_dst)
    return activation(rst) if activation is not None else rst


def tarmac_attention_graph_parallel(s, q, v, adj, key_size, group):
    """TarMAC talk-graph attention with the SOURCE-agent axis split over
    ``group`` (non-divisible S padded with masked sources).

    s: [..., S, K] signatures, q: [..., D, K] queries, v: [..., S, M] values,
    adj: [..., S, D] edge mask (src -> dst) -> c: [..., D, M], the dense
    ``masked_softmax(s q^T / key_size, adj, -2)^T v`` on every rank."""
    g = dist.get_world_size(group)
    pad = (-s.shape[-2]) % g
    if pad:
        s = F.pad(s, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        adj = F.pad(adj, (0, 0, 0, pad), value=False)
    sp, d, dk, dm = s.shape[-2], q.shape[-2], s.shape[-1], v.shape[-1]
    batch = s.shape[:-2]
    lo, hi = _block(sp, group)
    s_blk = Shard.apply(s.reshape(-1, sp, dk), 1, group)         # [N, S_loc, K]
    v_blk = Shard.apply(v.reshape(-1, sp, dm), 1, group)         # [N, S_loc, M]
    adj_blk = torch.broadcast_to(adj, batch + (sp, d)).reshape(-1, sp, d)[:, lo:hi]
    q_r = Replicate.apply(q.reshape(-1, d, dk), group)           # [N, D, K]
    scores = torch.einsum("nsk,ndk->nsd", s_blk, q_r) / key_size
    w = _partial_softmax(scores, adj_blk, group)
    denom = Combine.apply(w.sum(1), group)                       # [N, D]
    acc = Combine.apply(torch.einsum("nsd,nsm->ndm", w, v_blk), group)
    return (acc / torch.clamp_min(denom, 1e-30)[..., None]).reshape(batch + (d, dm))
