#!/usr/bin/env python3
"""Time ``tarmac_step_bwd`` against another version of its source, in turns, on one GPU.

    python3 chip_ab.py OLD.cu

``OLD.cu`` is an earlier ``uav_bs_ctrl_tpu_torch/ops/csrc/tarmac_step_bwd.cu``
(for example from ``git show <commit>:<path>``) with the same C entry point
and a scratch buffer no larger than the repo's. The script builds it with
``ops/build.py``'s flags beside the repo's own build, then at 32 and 512
worlds draws random inputs at the 8-UBS training width (A = 8, hidden 256,
msg 64, key 16, 9 actions), calls the port's wrapper with either library
loaded, and prints the largest difference of the outputs relative to
max(1, max |old|) and the ms per call of each, timed with
``chip_smoke.time_cuda`` in turns: old, new, new, old.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from uav_bs_ctrl_tpu_torch.ops import build, step_kernels  # noqa: E402

NAME = "tarmac_step_bwd"
WORLDS = (32, 512)          # the training batch, and a batch that fills the card


def main():
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old_source = Path(sys.argv[1]).resolve()
    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    signatures = step_kernels._BWD_SIGNATURES
    new = build.load(NAME, signatures)
    old_so = build.BUILD_DIR / f"{NAME}-old.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(old_so), str(old_source)],
                   check=True, timeout=build.NVCC_TIMEOUT_S)
    old = ctypes.CDLL(str(old_so))
    for fn, (restype, argtypes) in signatures.items():
        getattr(old, fn).restype = restype
        getattr(old, fn).argtypes = argtypes
    print(chip_smoke.card_line(), flush=True)

    rng = np.random.default_rng(0)
    for w in WORLDS:
        args = tuple(chip_smoke.step_case(rng, w, 8, 256, 64, 16, 9).values()) + (
            torch.randn((w * 8, 9), device="cuda"), torch.randn((w * 8, 256), device="cuda"),
            8, 16, False)

        def call(lib):
            build._loaded[NAME] = lib           # the wrapper launches whichever is loaded
            return step_kernels.tarmac_step_bwd(*args)

        with torch.no_grad():
            got, want = call(new), call(old)
            diff = max((g - r).abs().max().item() / max(1.0, r.abs().max().item())
                       for g, r in zip(got, want))
            times = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                lib = old if which == "old" else new
                times[which].append(chip_smoke.time_cuda(lambda: call(lib)))
        build._loaded[NAME] = new
        print(f"{NAME} R={w * 8}: {old_source.name} {times['old']} ms, this tree "
              f"{times['new']} ms; max |new - old| / max(1, max |old|) {diff:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
