"""Ranks on one machine: spawn a process group, run tasks in every rank, and
bring back each rank's results.

``spawn(n_ranks, tasks, device)`` starts ``n_ranks`` fresh processes (the
``spawn`` start method), joins them in one process group through a file
rendezvous (no TCP port to collide), and runs each task ``(fn, kwargs)`` in
order as ``fn(rank, world_size, device, **kwargs)`` in every rank; ``fn`` is a
module-level function of a module that imports neither the tests nor JAX, so
that the children stay light. The backend is NCCL, one card a rank, when
``device`` is CUDA and there are enough cards; otherwise gloo: on the CPU, or
with CUDA tensors when several ranks share one card (NCCL refuses two ranks
on one GPU). On the CPU each rank runs one thread.

No fallback hides a rank: a rank that raises (a failed collective included)
or exits non-zero fails the whole call with its traceback, and the others are
stopped.
"""

import pickle
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import multiprocessing as mp

import torch
import torch.distributed as dist

TIMEOUT_S = 900


def pick_backend(device, n_ranks):
    """``"nccl"`` for CUDA with a card for each rank, else ``"gloo"``."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


def rank_device(device, backend, rank):
    """The torch device of ``rank``: its own card under NCCL, the shared
    ``device`` otherwise."""
    if backend == "nccl":
        return torch.device("cuda", rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", 0)
    return device


def _rank_main(rank, world, backend, device, rendezvous, out_path, tasks):
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        dev = rank_device(device, backend, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
        try:
            results = [fn(rank, world, dev, **kwargs) for fn, kwargs in tasks]
        finally:
            dist.destroy_process_group()
        out = {"results": results}
    except BaseException:       # reported to the parent, which fails the call
        out = {"error": traceback.format_exc()}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    if "error" in out:
        raise SystemExit(1)


def spawn(n_ranks, tasks, device="cuda"):
    """Run ``tasks`` (a list of ``(fn, kwargs)``) in ``n_ranks`` ranks of one
    process group; returns ``[[rank 0's result, rank 1's, ...] per task]``.
    Raises with the failing ranks' tracebacks when a rank fails, and when the
    ranks are not done within ``TIMEOUT_S`` (also each collective's limit)."""
    backend = pick_backend(device, n_ranks)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        tmp = Path(tmp)
        procs = [ctx.Process(target=_rank_main, args=(
            r, n_ranks, backend, str(device), str(tmp / "rendezvous"), str(tmp / f"rank{r}.pkl"),
            tasks)) for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while any(p.is_alive() for p in procs):
                failed = [p for p in procs if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    grace = time.monotonic() + 10
                    while any(p.is_alive() for p in procs) and time.monotonic() < grace:
                        time.sleep(0.1)
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(30)
        outs, errors = [], []
        for r, p in enumerate(procs):
            path = tmp / f"rank{r}.pkl"
            out = pickle.loads(path.read_bytes()) if path.exists() else {}
            if "results" not in out or p.exitcode != 0:
                errors.append(f"rank {r} (exit code {p.exitcode}):\n"
                              f"{out.get('error', 'no result (killed or timed out)')}")
            outs.append(out.get("results"))
    if errors:
        raise RuntimeError(f"{len(errors)} of {n_ranks} ranks failed ({backend}):\n" +
                           "\n".join(errors))
    return [[outs[r][i] for r in range(n_ranks)] for i in range(len(tasks))]
