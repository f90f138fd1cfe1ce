"""Padded edge-list graph primitives (counterpart of ``uav_bs_ctrl_tpu/ops/segment.py``).

A relation is ``(src_idx, dst_idx, edge_mask)`` tensors padded to a fixed
``E``: visibility changes flip the mask, never a shape. These cover the
reference's DGL native-kernel surface:

- ``gather_src``           edge-parallel gather of source features (DGL ``edges.src``)
- ``sddmm_dot``            per-edge dot scores (DGL ``fn.u_dot_v``)
- ``segment_softmax``      per-destination softmax (DGL ``edge_softmax``)
- ``segment_sum/mean/max`` SpMM-style aggregation (``fn.sum``, mailbox
  ``.mean(1)``, ``.max(1)``)

Backends keep JAX's names: ``'xla'`` scatters with ``index_add_``,
``'onehot'`` as a one-hot product. No training path calls these (JAX's
training does not either, and the JAX module reaches no Pallas kernel): they
are the port's surface for parity with DGL's ops, in plain torch.

A destination with no valid in-edge gets 0, as ``ops/masked.py`` and DGL's
zero-in-degree rule. The max shift in :func:`segment_softmax` is detached:
it cancels exactly, so ties do not split its gradient.
"""

import torch

_NEG_BIG = -1e30


def _expand(mask, values):
    return mask.reshape(tuple(mask.shape) + (1,) * (values.ndim - mask.ndim))


def gather_src(x_src, src_idx):
    """Per-edge gather of source-node features: [N_src, ...] -> [E, ...]."""
    return x_src.index_select(0, src_idx)


def sddmm_dot(a_src, b_dst, src_idx, dst_idx):
    """Per-edge dot product ``a[src] . b[dst]`` -> [E, ...] (heads broadcast)."""
    return (a_src.index_select(0, src_idx) * b_dst.index_select(0, dst_idx)).sum(-1)


def segment_sum(values, dst_idx, edge_mask, num_dst, backend="xla"):
    """Sum the valid edge values into destination buckets. values: [E, ...]."""
    values = torch.where(_expand(edge_mask, values), values, torch.zeros_like(values))
    if backend == "onehot":
        onehot = torch.nn.functional.one_hot(dst_idx.long(), num_dst).to(values.dtype)   # [E, N]
        flat = values.reshape(values.shape[0], -1)
        return (onehot.T @ flat).reshape((num_dst,) + tuple(values.shape[1:]))
    if backend != "xla":
        raise ValueError(f"backend must be 'xla' or 'onehot', got {backend!r}")
    out = values.new_zeros((num_dst,) + tuple(values.shape[1:]))
    return out.index_add(0, dst_idx, values)


def segment_mean(values, dst_idx, edge_mask, num_dst, backend="xla"):
    """Mean over valid in-edges per destination; no valid edge -> 0."""
    total = segment_sum(values, dst_idx, edge_mask, num_dst, backend)
    ones = edge_mask.to(values.dtype)
    count = segment_sum(ones, dst_idx, edge_mask, num_dst, backend)
    count = count.reshape((num_dst,) + (1,) * (total.ndim - 1))
    return total / torch.clamp(count, min=1)


def _segment_amax(masked, dst_idx, num_dst):
    """Per-destination max of ``masked`` [E, ...]; ``_NEG_BIG`` where no edge lands."""
    index = _expand(dst_idx.long(), masked).expand_as(masked)
    out = masked.new_full((num_dst,) + tuple(masked.shape[1:]), _NEG_BIG)
    return out.scatter_reduce(0, index, masked, "amax", include_self=False)


def segment_max(values, dst_idx, edge_mask, num_dst):
    """Max over valid in-edges per destination; no valid edge -> 0."""
    masked = torch.where(_expand(edge_mask, values), values,
                         torch.full_like(values, _NEG_BIG))
    out = _segment_amax(masked, dst_idx, num_dst)
    return torch.where(out <= _NEG_BIG / 2, torch.zeros_like(out), out)


def segment_softmax(scores, dst_idx, edge_mask, num_dst, backend="xla"):
    """Per-destination softmax over valid in-edges. scores: [E, ...]; masked
    edges -> 0."""
    valid = _expand(edge_mask, scores)
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG_BIG))
    seg_max = _segment_amax(masked.detach(), dst_idx, num_dst)
    seg_max = torch.where(seg_max <= _NEG_BIG / 2, torch.zeros_like(seg_max), seg_max)
    # A masked edge's score may be anything: shift it to 0, so that its exp
    # (dropped below) is finite and sends no nan back through the where.
    shifted = torch.where(valid, scores - seg_max.index_select(0, dst_idx),
                          torch.zeros_like(scores))
    unnorm = torch.where(valid, torch.exp(shifted), torch.zeros_like(shifted))
    denom = segment_sum(unnorm, dst_idx, edge_mask, num_dst, backend)
    return unnorm / torch.clamp(denom.index_select(0, dst_idx), min=1e-30)


def spmm_attention(alpha, values, src_idx, dst_idx, edge_mask, num_dst, backend="xla"):
    """Attention-weighted SpMM: ``out[d] = sum_e alpha_e * values[src_e]``.

    alpha: [E] or [E, H]; values: [N_src, D] or [N_src, H, D].
    """
    v_e = values.index_select(0, src_idx)
    msg = v_e * alpha.reshape(tuple(alpha.shape) + (1,) * (v_e.ndim - alpha.ndim))
    return segment_sum(msg, dst_idx, edge_mask, num_dst, backend)


def dense_to_edges(adj):
    """An [N_src, N_dst] adjacency mask as a full padded edge list
    ``(src_idx, dst_idx, edge_mask)`` with E = N_src * N_dst, row-major (all
    destinations of source 0, then source 1, ...)."""
    n_src, n_dst = adj.shape
    src = torch.arange(n_src, device=adj.device).repeat_interleave(n_dst)
    dst = torch.arange(n_dst, device=adj.device).repeat(n_src)
    return src, dst, adj.reshape(-1)
