"""The mp compute split: each mp rank runs its share of an update's work.

JAX's update is one jitted program whose params carry the mp storage rule,
and XLA partitions its products over ``mp`` (``uav_bs_ctrl_tpu/parallel/
mesh.py:1-13``). The port's products sit inside kernels #2-#5, so the split
is written out: the agent's ``mp_plan`` names the modules,
:func:`parallel.mesh.distribute_learner` gives each its :class:`Share`
(``sharding.plan``), and the modules run it:

- each relation's GATv2 on the rank's heads (``GATv2.forward``: its
  columns of ``fc_src``, ``fc_dst``, ``res_fc``, its rows of ``attn``,
  through #2/#3 with ``n_heads = H/mp``);
- the encoder's ``aggr`` row-parallel (:func:`aggr_rows`): the rank's
  columns of ``[x_gt | x_ubs]`` times the matching rows of ``aggr.w``, one
  all-reduce of the partial products, then the bias and the ReLU;
- the one-round TarMAC step's GRU on the rank's hidden columns of each
  gate (:func:`tarmac_step_cols_train`, the column-split #4/#5 of
  ``ops/step_kernels.py``): h2's columns all-gathered before the Q head, and
  one all-reduce of the backward's full-width partials of dx, dc and dh.

Everything else (v|s|q and the attention, the Q head's product, the mixer,
the loss) runs whole on every rank. A :class:`Share` is attached to each
split module as ``mp_share`` (to the policy and the target net alike), and
is read only inside :func:`splitting`, which the learner's ``backward``
enters around its loss: ``act``, the collection, serving and checkpoints run
the whole modules on their full weights.

Gradients: a split module's parameters get the rank's slice of the gradient
(autograd's slicing puts zeros elsewhere; the step's backward its columns of
wi, wh, bi, bh and rows of wo, wvh), a replicated one the whole gradient on
every rank; ``LearnerSharding.reduce`` sums them over mp with the replicated
ones taken from mp rank 0 alone. The forward's all-reduce has an identity
backward: what follows it is computed alike on every rank, so each rank's
cotangent is already the whole one.

``COLLECTIVES`` counts this module's collectives by kind and their host
seconds (they are also in ``parallel.dist.COLLECTIVES``).
"""

import contextlib
import time

import torch

from uav_bs_ctrl_tpu_torch.ops.step_kernels import (tarmac_step_bwd_cols, tarmac_step_bwd_rest,
                                                    tarmac_step_cols, tarmac_step_head)
from uav_bs_ctrl_tpu_torch.parallel.dist import all_gather, all_reduce

COLLECTIVES = {"all_gather": 0, "all_reduce": 0, "seconds": 0.0}
_SPLITTING = [False]


def reset_collectives():
    COLLECTIVES.update(all_gather=0, all_reduce=0, seconds=0.0)


def _collective(kind, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    COLLECTIVES[kind] += 1
    COLLECTIVES["seconds"] += time.perf_counter() - t0
    return out


class Share:
    """An mp rank's share of a module's work: ``[lo, hi)`` of its ``whole``
    ``unit`` ('heads', the 'rows' of each half of ``aggr.w``, or the GRU's
    'columns' of each gate), and the mp ``group``. Copies of a module share
    it (``deepcopy`` keeps the object: a process group is not copied)."""

    def __init__(self, unit, lo, hi, whole, group):
        self.unit, self.lo, self.hi, self.whole, self.group = unit, lo, hi, whole, group

    def __deepcopy__(self, memo):
        return self

    def __repr__(self):
        return f"{self.unit} [{self.lo}, {self.hi}) of {self.whole}"


@contextlib.contextmanager
def splitting():
    """Run the planned modules on their shares for the span (an update's loss)."""
    before = _SPLITTING[0]
    _SPLITTING[0] = True
    try:
        yield
    finally:
        _SPLITTING[0] = before


def active_share(module):
    """``module``'s :class:`Share` inside :func:`splitting`, else None."""
    return getattr(module, "mp_share", None) if _SPLITTING[0] else None


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) over the group forward; the identity backward."""

    @staticmethod
    def forward(ctx, part, group):
        return _collective("all_reduce", all_reduce, part.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def aggr_rows(aggr, x_gt, x_ubs, share):
    """The encoder's ``aggr(cat([x_gt, x_ubs]))`` from the rank's columns
    ``[lo, hi)`` of ``x_gt`` and ``x_ubs`` (its heads' outputs): the partial
    product with the matching rows of ``aggr.w``, summed over the group, plus
    the bias (the ReLU is the caller's). At bf16 the partial products are
    taken and summed in f32 and rounded once, as the whole product's sum is."""
    hidden = share.whole
    acc = torch.promote_types(x_gt.dtype, torch.float32)
    w = torch.cat([aggr.w[share.lo:share.hi], aggr.w[hidden + share.lo:hidden + share.hi]])
    part = torch.cat([x_gt, x_ubs], dim=-1).to(acc) @ w.to(acc)
    return _SumOverRanks.apply(part, share.group).to(x_gt.dtype) + aggr.b


class _TarmacStepCols(torch.autograd.Function):
    """The column-split ``tarmac_step`` forward and ``tarmac_step_bwd``
    backward of one rank, joined by their collectives."""

    @staticmethod
    def forward(ctx, share, x, h, adjf, *rest):
        tensors = tuple(t.detach() for t in (x, h, adjf) + rest[:14])
        a, key_size, dueling = rest[14:]
        cols = (share.lo, share.hi)
        h2c = tarmac_step_cols(*tensors[:13], a, key_size, cols)
        h2f = torch.cat(_collective("all_gather", all_gather, h2c, share.group), dim=1)
        q, h2 = tarmac_step_head(h2f, *tensors[13:], dueling)
        ctx.save_for_backward(*tensors)
        ctx.cfg = (share, a, key_size, dueling)
        return q, h2

    @staticmethod
    def backward(ctx, gq, gh2):
        share, a, key_size, dueling = ctx.cfg
        cols = (share.lo, share.hi)
        tensors = ctx.saved_tensors
        red, saved = tarmac_step_bwd_cols(*tensors, gq.contiguous(), gh2.contiguous(), a,
                                          key_size, dueling, cols)
        red = _collective("all_reduce", all_reduce, red, share.group)
        grads = tarmac_step_bwd_rest(*tensors, red, saved, a, key_size, dueling, cols)
        need = ctx.needs_input_grad
        grads = (None,) + grads[:2] + (None,) + grads[2:]
        return tuple(g if need[i] else None for i, g in enumerate(grads)) + (None,) * 3


def tarmac_step_cols_train(share, x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo,
                           wvh, bvh, a, key_size, dueling):
    """``ops.step_kernels.tarmac_step_train`` (same contract) on an mp rank:
    the GRU of the columns of ``share``, q and h2 whole on every rank."""
    return _TarmacStepCols.apply(share, x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh,
                                 wo, bo, wvh, bvh, a, key_size, dueling)
