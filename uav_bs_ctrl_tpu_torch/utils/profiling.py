"""Tracing and per-phase timing (counterpart of ``uav_bs_ctrl_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` capture (the CPU, and the card when
  there is one) of the block, written to ``logdir`` for TensorBoard or
  Perfetto, where the JAX package captures ``jax.profiler``'s.
- ``annotate(name)``: a named range on the host timeline,
  ``torch.profiler.record_function``.
- ``StepTimer``: per-phase wall clock, mean ms since the last flush, dumped
  into the ``EpochLogger`` (``TimeActMs``, ``TimeEnvMs``, ``TimeUpdateMs``).
  A phase that ends by reading a result back to the host (``act``'s actions,
  ``update``'s LossQ) includes its device time.
"""

import contextlib
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(logdir, enabled=True):
    """Capture a ``torch.profiler`` trace into ``logdir`` while the block runs."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def annotate(name):
    """Named range (shows up on the host timeline of a trace)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates per-phase wall-clock; reports mean ms since last flush."""

    def __init__(self):
        self._acc = defaultdict(float)
        self._cnt = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t0
            self._cnt[name] += 1

    def flush(self, prefix="Time"):
        """Return {f'{prefix}{Phase}Ms': mean_ms} and reset."""
        out = {}
        for name, total in self._acc.items():
            n = max(self._cnt[name], 1)
            out[f"{prefix}{name}Ms"] = 1e3 * total / n
        self._acc.clear()
        self._cnt.clear()
        return out
