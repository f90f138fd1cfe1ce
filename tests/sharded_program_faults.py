"""A planted fault of the sharded update's program path for
``test_torch_parallel_programs.py``.

:func:`identity_sum_update` is a rank task: ``parallel.workers.learner_update``
with the learner's sum over the ranks (``LearnerSharding.sum_ranks``, which
the host runs between the gradient and the step program) made the identity.
It imports no JAX, so that the spawned ranks stay light.
"""

from uav_bs_ctrl_tpu_torch.parallel import workers
from uav_bs_ctrl_tpu_torch.parallel.mesh import LearnerSharding


def identity_sum_update(rank, world, device, **kwargs):
    """``workers.learner_update(rank, world, device, **kwargs)`` with
    ``LearnerSharding.sum_ranks`` the identity."""
    sum_ranks = LearnerSharding.sum_ranks
    LearnerSharding.sum_ranks = lambda self, flat: flat
    try:
        return workers.learner_update(rank, world, device, **kwargs)
    finally:
        LearnerSharding.sum_ranks = sum_ranks
