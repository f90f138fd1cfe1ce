"""Process groups and collectives (counterpart of ``parallel/dist.py``).

- :func:`init_distributed` joins the default process group from torchrun's
  variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``,
  ``LOCAL_RANK``) or its arguments; a no-op at world size 1.
- :func:`dist_statistics_scalar`: the cross-rank mean/std (and min/max) of
  per-rank samples, one all-gather of each rank's ``[sum, n, sum_sq, min,
  max]`` row in float64 combined by :func:`combine_host_stats` (the JAX
  package's exact math, copied), used by the ``EpochLogger`` on several ranks.
- :func:`all_reduce`, :func:`all_gather` and :func:`all_reduce_tree`: the
  collectives of the parallel layer, out of place. A group on gloo reduces
  CUDA tensors through host copies (several ranks may share one card, where
  NCCL refuses two ranks on one GPU); ``COLLECTIVES`` counts their calls and
  host seconds, the card synchronised first on that path (under NCCL the
  host time of a collective is its enqueue).
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVES = {"calls": 0, "seconds": 0.0}


def init_distributed(rank=None, world_size=None, backend=None, init_method=None):
    """Join the default process group; returns ``(rank, world_size)``.

    Arguments default to torchrun's ``RANK``/``WORLD_SIZE`` and, for the
    ``env://`` rendezvous, ``MASTER_ADDR``/``MASTER_PORT``; ``backend``
    defaults to NCCL when there is a card for each local rank, else gloo.
    Under NCCL the rank takes the card ``LOCAL_RANK`` (else its rank)."""
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    if world_size > 1 and not dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", rank))
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() and \
                torch.cuda.device_count() > local else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(local)
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size)
    return rank, world_size


def num_hosts() -> int:
    """The number of ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _staged(tensor, group):
    """Whether a collective of ``tensor`` in ``group`` goes through the host:
    a CUDA tensor in a gloo group."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(tensor, group=None, op=dist.ReduceOp.SUM):
    """``op`` over ``group`` of ``tensor``, out of place."""
    t0 = _start(tensor, group)
    if _staged(tensor, group):
        host = tensor.detach().cpu()
        dist.all_reduce(host, op=op, group=group)
        out = host.to(tensor.device)
    else:
        out = tensor.detach().clone()
        dist.all_reduce(out, op=op, group=group)
    return _stop(t0, out)


def all_gather(tensor, group=None):
    """Every rank's ``tensor`` in ``group``, in group-rank order."""
    t0 = _start(tensor, group)
    size = dist.get_world_size(group)
    src = tensor.detach().contiguous()
    staged = _staged(tensor, group)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    if staged:
        parts = [p.to(tensor.device) for p in parts]
    return _stop(t0, parts)


def all_reduce_tree(tensors, group=None):
    """The sum over ``group`` of a list of tensors, one collective per dtype
    (booleans summed as uint8 and returned as booleans)."""
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(torch.uint8 if t.dtype == torch.bool else t.dtype, []).append(i)
    out = [None] * len(tensors)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([tensors[i].reshape(-1).to(dtype) for i in idx])
        flat = all_reduce(flat, group)
        for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = part.reshape(tensors[i].shape).to(tensors[i].dtype)
    return out


def _start(tensor, group):
    if _staged(tensor, group):
        torch.cuda.synchronize(tensor.device)
    return time.perf_counter()


def _stop(t0, out):
    COLLECTIVES["calls"] += 1
    COLLECTIVES["seconds"] += time.perf_counter() - t0
    return out


def reset_collectives():
    COLLECTIVES.update(calls=0, seconds=0.0)


def dist_statistics_scalar(x, with_min_and_max=False):
    """Cross-rank mean/std (and min/max) of per-rank scalar samples.

    One rank: NumPy in float32, as the logger's own. Several: an all-gather
    of :func:`local_stat_row` in float64 over the default group (on the card
    under NCCL), combined by :func:`combine_host_stats`."""
    x = np.asarray(x, dtype=np.float32)
    if num_hosts() == 1:
        mean = x.mean() if x.size else 0.0
        std = np.sqrt(np.mean((x - mean) ** 2)) if x.size else 0.0
        if with_min_and_max:
            return (mean, std, x.min() if x.size else np.inf,
                    x.max() if x.size else -np.inf)
        return mean, std
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    row = torch.tensor(local_stat_row(x), dtype=torch.float64, device=device)
    rows = torch.stack(all_gather(row)).cpu().numpy()
    return combine_host_stats(rows, with_min_and_max)


def local_stat_row(x):
    """This rank's contribution to the cross-rank statistics all-gather."""
    x = np.asarray(x, dtype=np.float64)
    return [x.sum(), float(x.size), np.sum(x ** 2),
            x.min() if x.size else np.inf, x.max() if x.size else -np.inf]


def combine_host_stats(sums, with_min_and_max=False):
    """Combine all-gathered per-rank rows ``[sum, n, sum_sq, min, max]``.

    The reference computes residuals around the GLOBAL mean
    (``utils/mpi_tools.py:88-91``: allreduce the mean first, then allreduce
    ``sum((x - global_mean)**2)``).  ``E[(x-mu)^2] = E[x^2] - mu^2`` yields the
    exact same quantity from raw second moments in a single collective.
    """
    sums = np.asarray(sums, dtype=np.float64)
    global_sum, global_n = sums[:, 0].sum(), sums[:, 1].sum()
    mean = global_sum / max(global_n, 1)
    var = max(sums[:, 2].sum() / max(global_n, 1) - mean ** 2, 0.0)
    std = np.sqrt(var)
    if with_min_and_max:
        return mean, std, sums[:, 3].min(), sums[:, 4].max()
    return mean, std
