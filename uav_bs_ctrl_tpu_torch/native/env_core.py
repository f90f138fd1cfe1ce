"""ctypes binding of the C++ env scheduling core (counterpart of
``uav_bs_ctrl_tpu/native/env_core.py``).

``schedule_and_rate`` is the C++ twin of
``MultiUbsCoverageEnv._schedule_numpy``: priority-ordered GT association
with the lowest-interference idle RB, then the per-GT SINR rates (reference
``envs/mubs_cov/mubs_cov.py:172-200``). The library is built from
``env_core.cpp`` at the first :func:`load` (``build.py``), never at import.
When it cannot be built, :func:`load` returns None, :func:`error` holds the
reason, and :func:`warn_fallback` warns once per process. ``calls`` counts
the calls into the library.
"""

import ctypes
import subprocess
import warnings

import numpy as np

from uav_bs_ctrl_tpu_torch.native import build

_LIB = None
_ERROR = None          # why the core is unavailable (the compiler's error)
_TRIED = False
_WARNED = False
calls = 0              # schedule_and_rate calls into the library

_F32 = ctypes.POINTER(ctypes.c_float)
_F64 = ctypes.POINTER(ctypes.c_double)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.POINTER(ctypes.c_int64)


def load():
    """The loaded library, built on the first call; None when it cannot be
    built or loaded (then :func:`error` says why). Tried once per process."""
    global _LIB, _ERROR, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(build.build()))
        lib.schedule_and_rate.restype = None
        lib.schedule_and_rate.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,     # n_ubs, n_gts, n_rbs
            _F32, _F64, _U8, _I64,                        # d_u2g, gain, mask_itf, prior_gts
            ctypes.c_double, ctypes.c_double,             # r_cov, p_tx
            ctypes.c_double, ctypes.c_double,             # noise, bw
            _U8, _F32, _F32]                              # out: sched, rate_per_gt, rate_per_ubs
        _LIB = lib
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        _ERROR = f"{type(e).__name__}: {e}"
    return _LIB


def available() -> bool:
    return load() is not None


def error():
    """Why the core is unavailable, or None."""
    return _ERROR


def warn_fallback():
    """Warn, once per process, that the host env runs the NumPy scheduler
    because the core could not be built."""
    global _WARNED
    if not _WARNED:
        _WARNED = True
        warnings.warn(f"the C++ env core could not be built; MultiUbsCoverageEnv runs its "
                      f"NumPy scheduler instead: {_ERROR}", RuntimeWarning, stacklevel=3)


def schedule_and_rate(d_u2g, gain, mask_itf, prior_gts, n_rbs, r_cov, p_tx, noise, bw=180e3):
    """C++ twin of ``MultiUbsCoverageEnv._schedule_numpy``; ``noise`` is
    ``bw * n0`` (W). Returns (sched [n_ubs, n_gts, n_rbs] bool,
    rate_per_gt [n_gts] f32, rate_per_ubs [n_ubs] f32)."""
    global calls
    lib = load()
    if lib is None:
        raise RuntimeError(f"the C++ env core is unavailable: {_ERROR}")
    n_ubs, n_gts = d_u2g.shape
    d = np.ascontiguousarray(d_u2g, dtype=np.float32)
    g = np.ascontiguousarray(gain, dtype=np.float64)
    mi = np.ascontiguousarray(mask_itf, dtype=np.uint8)
    pr = np.ascontiguousarray(prior_gts, dtype=np.int64)
    sched = np.zeros((n_ubs, n_gts, n_rbs), dtype=np.uint8)
    rate_gt = np.zeros(n_gts, dtype=np.float32)
    rate_ubs = np.zeros(n_ubs, dtype=np.float32)
    lib.schedule_and_rate(
        n_ubs, n_gts, n_rbs, d.ctypes.data_as(_F32), g.ctypes.data_as(_F64),
        mi.ctypes.data_as(_U8), pr.ctypes.data_as(_I64),
        float(r_cov), float(p_tx), float(noise), float(bw),
        sched.ctypes.data_as(_U8), rate_gt.ctypes.data_as(_F32), rate_ubs.ctypes.data_as(_F32))
    calls += 1
    return sched.astype(bool), rate_gt, rate_ubs
