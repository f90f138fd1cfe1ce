"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``ops/csrc/<name>.cu`` exports ``extern "C"`` launchers that take raw
device pointers, sizes and a ``cudaStream_t`` and return the launch's
``cudaError_t``; no source includes PyTorch's headers, so a file compiles in
seconds and needs neither ninja nor pybind11. The shared object goes to
``ops/_build/<name>-<hash>.so``, keyed by the source, every ``csrc/*.cuh``
header, the flags and ``nvcc --version``, and is built on first use. Kernels
#2-#5 export one launcher per storage type: ``<name>`` takes float32
pointers, ``<name>_bf16`` bfloat16 ones (``SUFFIX``).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-O3", "-lineinfo", "-std=c++17",
              "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-shared"]
NVCC_TIMEOUT_S = 300

_loaded = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def _target(name: str, nvcc: str) -> Path:
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # any header a source may include
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(version.encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Compile every missing ``<name>.so`` with one ``nvcc`` per source, all
    started together; returns ``{name: path}``. Raises with nvcc's stderr on
    a failed build."""
    nvcc = find_nvcc()
    targets = {name: _target(name, nvcc) for name in names}
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        print("nvcc:", " ".join(cmd), flush=True)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        try:
            _, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            errors.append(f"nvcc timed out after {NVCC_TIMEOUT_S} s on {name}.cu")
            continue
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}) on {name}.cu:\n{err}")
            continue
        os.replace(tmp, targets[name])
        print(f"built {targets[name].name} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    ``signatures`` (``{function: (restype, [argtypes])}``) declared."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return _loaded[name]


SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}   # a launcher's name by storage type


def storage_type(what, *tensors):
    """The storage type of a kernel call's tensor operands: float32 or
    bfloat16, the same for all (the kernels take no mixed types); raises
    ``TypeError`` otherwise."""
    dtype = tensors[0].dtype
    if dtype not in SUFFIX:
        raise TypeError(f"{what} takes float32 or bfloat16 operands, got {dtype}")
    mixed = sorted({str(t.dtype) for t in tensors if t.dtype != dtype})
    if mixed:
        raise TypeError(f"{what} takes operands of one dtype, got {dtype} and {mixed}")
    return dtype


def pointers(device, tensors: dict, storage=torch.float32, f32=()) -> list:
    """Device pointers of ``tensors`` after checking what the kernels take:
    ``storage`` (float32 or bfloat16; float32 for the names in ``f32``, the
    row statistics and scratch), contiguous, on ``device``, and not part of
    an autograd graph (autograd reaches a kernel only through its
    ``torch.autograd.Function``, ``flash_gat_fused_train`` or
    ``tarmac_step_train``)."""
    grad = torch.is_grad_enabled()
    ptrs = []
    for name, t in tensors.items():
        want = torch.float32 if name in f32 else storage
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != want:
            raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if grad and t.requires_grad:
            raise NotImplementedError(
                f"{name} requires grad: differentiate through the kernel's "
                "torch.autograd.Function (flash_gat_fused_train, tarmac_step_train)")
        ptrs.append(ctypes.c_void_p(t.data_ptr()))
    return ptrs


def count_launch(fn, dtype=torch.float32):
    """Add one to the wrapper ``fn``'s launch count, and to its bf16 count
    for a bf16 launch (``fn.launches - fn.launches_bf16`` are f32 ones). A
    launch into a capturing stream (``graphs.Program``'s capture) records
    the kernel and runs nothing, so it counts nothing: the graph's replays
    launch it, and pass no wrapper."""
    if torch.cuda.is_current_stream_capturing():
        return
    fn.launches += 1
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1


def check_launch(lib, error_string_fn: str, err: int, what: str):
    """Raise with ``cudaGetErrorString`` when a launcher returned non-zero."""
    if err != 0:
        msg = getattr(lib, error_string_fn)(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err}: {msg}")


def stream_of(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
