"""Dense masked reductions (counterpart of ``uav_bs_ctrl_tpu/ops/masked.py``).

Rows with no valid entry give exactly 0, matching an empty in-edge set in the
reference's graph softmax and its zero-padded mailboxes. ``mask`` broadcasts
to ``x``'s shape.
"""

import torch

NEG_BIG = -1e30


def masked_softmax(x, mask, dim):
    """Softmax of ``x`` over ``dim`` restricted to ``mask``; all-masked rows -> 0."""
    mask = torch.broadcast_to(mask, x.shape)
    x_masked = torch.where(mask, x, NEG_BIG)
    x_max = torch.amax(x_masked, dim=dim, keepdim=True)
    # All-masked rows shift by 0 instead of -1e30, so no inf - inf.
    x_max = torch.where(x_max <= NEG_BIG / 2, 0.0, x_max)
    unnorm = torch.where(mask, torch.exp(x - x_max), 0.0)
    denom = torch.sum(unnorm, dim=dim, keepdim=True)
    return unnorm / torch.clamp_min(denom, 1e-30)


def masked_sum(x, mask, dim):
    return torch.sum(torch.where(torch.broadcast_to(mask, x.shape), x, 0.0), dim=dim)


def masked_mean(x, mask, dim):
    """Mean over valid entries (divides by the valid count, not the axis size)."""
    mask = torch.broadcast_to(mask, x.shape)
    count = torch.sum(mask, dim=dim).to(x.dtype)
    return masked_sum(x, mask, dim) / torch.clamp_min(count, 1)


def masked_max(x, mask, dim):
    """Max over valid entries; rows with no valid entry give 0. Ties share
    the gradient evenly (``amax``), as JAX's ``max`` does."""
    m = torch.amax(torch.where(torch.broadcast_to(mask, x.shape), x, NEG_BIG), dim=dim)
    return torch.where(m <= NEG_BIG / 2, 0.0, m)
