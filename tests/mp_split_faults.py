"""Planted faults of the mp compute split for ``test_torch_parallel_mp_split.py``.

:func:`planted_update` is a rank task: ``parallel.workers.learner_update``
with the learner's mp plan corrupted right after ``distribute_learner``. It
imports no JAX, so that the spawned ranks stay light.
"""

from uav_bs_ctrl_tpu_torch.parallel import workers


def plant(learner, fault):
    """``'replicated_twice'`` sums every gradient over mp, the replicated ones
    included; ``'column_offset'`` moves mp rank 0's GRU columns one column
    up (one column twice, column 0 never)."""
    sharding = learner.sharding
    if fault == "replicated_twice":
        sharding.split = [True] * len(sharding.split)
    elif fault == "column_offset":
        if sharding.mp_rank == 0:
            share = learner.net.f_comm.f_udt.mp_share
            share.lo, share.hi = share.lo + 1, share.hi + 1
    else:
        raise ValueError(f"unknown fault {fault!r}")


def planted_update(rank, world, device, fault, **kwargs):
    """``workers.learner_update(rank, world, device, **kwargs)`` with
    ``fault`` planted in its learner."""
    distribute = workers.distribute_learner

    def distribute_and_plant(learner, *args, **kw):
        out = distribute(learner, *args, **kw)
        plant(learner, fault)
        return out

    workers.distribute_learner = distribute_and_plant
    try:
        return workers.learner_update(rank, world, device, **kwargs)
    finally:
        workers.distribute_learner = distribute
