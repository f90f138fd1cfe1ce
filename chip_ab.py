#!/usr/bin/env python3
"""Time a kernel against another version of its source, in turns, on one GPU.

    python3 chip_ab.py NAME OLD.cu

``NAME`` is ``tarmac_step`` (the step forward), ``tarmac_step_bwd`` (its
backward), ``flash_gat`` (the GATv2 attention over a pre-projected ``el``),
``flash_gat_fused`` (the projection-fused GATv2 forward) or
``flash_gat_fused_bwd`` (its backward). ``OLD.cu`` is another version of
``uav_bs_ctrl_tpu_torch/ops/csrc/NAME.cu`` (for example from ``git show
<commit>:<path>``) with the same C entry point and a scratch buffer no larger
than the repo's; its ``#include "..."`` lines resolve beside it. A step forward
source whose ``tarmac_step_forward`` takes no scratch buffer (the one CTA per
world design, up to commit 92dda40) is called with that signature. The script
builds it with ``ops/build.py``'s flags beside the repo's own build, draws
random inputs, calls both versions on them, and prints the largest difference
of the outputs relative to max(1, max |old|) (leaving out the -1e30 of a
forward's fully masked rows), whether they are bit-identical, and the ms per
call of each, timed with ``chip_smoke.time_cuda`` in turns: old, new, new, old.

The step kernels run at the 8-UBS width (A = 8, hidden 256, msg 64, key 16, 9
actions) at 32 and 512 worlds (the forward also at 40, the serving batch), and
again on the same inputs rounded to bf16 where the old source has the bf16
launcher. The
GATv2 kernels run at the 8-UBS width (4 heads of 64) for the 'seen' GT slots
(M = 50, D = 4) and the 'near' UBS slots (M = 7, D = 2), at N = 256 rows (the
update), 320 (serving 40 worlds) and 4096, each with slots valid at the share
``chip_smoke.py`` measures in the update's inputs (``UPDATE_VALID``) and at
70 % (its kernel cases); the backward gets the plain forward's statistics and
a random cotangent, without ``dx`` (as in training). ``flash_gat`` runs at the
4-UBS DiscreteComm width (4 heads of 64) at N = 160 rows (serving 40 worlds),
320, 2048 and 4096, for the 'seen' GT slots (M = 50) at the valid shares
serving sees at step 0 and step 25 of an episode (``SERVING_VALID``) and at
70 %, and for the 'near' UBS slots (M = 3), all valid.
"""

import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from uav_bs_ctrl_tpu_torch.ops import build, gat_kernels, step_kernels  # noqa: E402

KERNELS = {  # name: (wrapper, ctypes signatures)
    "flash_gat": (gat_kernels.flash_gat, gat_kernels._FLASH_SIGNATURES),
    "tarmac_step": (step_kernels.tarmac_step, step_kernels._SIGNATURES),
    "tarmac_step_bwd": (step_kernels.tarmac_step_bwd, step_kernels._BWD_SIGNATURES),
    "flash_gat_fused": (gat_kernels.flash_gat_fused, gat_kernels._SIGNATURES),
    "flash_gat_fused_bwd": (gat_kernels.flash_gat_fused_bwd, gat_kernels._BWD_SIGNATURES),
}
STEP_WORLDS = {"tarmac_step": (32, 40, 512), "tarmac_step_bwd": (32, 512)}
GAT_ROWS = (256, 320, 4096)
GAT_SLOTS = {"seen": (50, 4), "near": (7, 2)}        # M, D
UPDATE_VALID = {"seen": 0.32, "near": 1.0}           # valid share of the update's masks
FLASH_ROWS = (160, 320, 2048, 4096)
SERVING_VALID = (0.013, 0.38)      # 4-UBS serving's 'seen' valid share at steps 0 and 25
_P, _I = ctypes.c_void_p, ctypes.c_int
UNSCRATCHED_FORWARD = (_I, [_P] * 19 + [_I] * 7 + [ctypes.c_float, _P])


def unscratched_forward(source: str) -> bool:
    """True for a forward source whose entry point takes no scratch buffer."""
    found = re.search(r'extern "C" int tarmac_step_forward\(([^)]*)\)', source)
    return found is not None and "scratch" not in found.group(1)


def call_unscratched(lib, args):
    """The forward through ``lib``'s scratch-less entry point, as the wrapper
    called it before the forward took a scratch buffer."""
    x, a, key_size, dueling = args[0], args[17], args[18], args[19]
    rows, hidden = x.shape
    msg, ks, n_act = args[3].shape[1], args[5].shape[1], args[13].shape[1]
    q = torch.empty((rows, n_act), dtype=torch.float32, device=x.device)
    h2 = torch.empty_like(x)
    ptrs = build.pointers(x.device, dict(zip([f"in{i}" for i in range(17)], args[:17]),
                                         q=q, h2=h2))
    err = lib.tarmac_step_forward(*ptrs, rows // a, a, hidden, msg, ks, n_act,
                                  int(bool(dueling)), float(key_size), build.stream_of(x.device))
    build.check_launch(lib, "tarmac_step_error_string", err, "tarmac_step (old)")
    return q, h2


def scale(ref):
    """max(1, max |ref|) over the entries that are no -1e30 sentinel (the
    forward's m of a row with no valid slot)."""
    live = ref.abs() < 1e29
    return max(1.0, ref[live].abs().max().item()) if live.any() else 1.0


def step_cases(name, rng):
    """(label, wrapper arguments) of the step kernel ``name``."""
    for w in STEP_WORLDS[name]:
        args = tuple(chip_smoke.step_case(rng, w, 8, 256, 64, 16, 9).values())
        if name == "tarmac_step_bwd":
            args += (torch.randn((w * 8, 9), device="cuda"),
                     torch.randn((w * 8, 256), device="cuda"))
        yield f"R={w * 8}", args + (8, 16, False)


def gat_cases(name, rng):
    """(label, wrapper arguments) of the GATv2 kernel ``name``."""
    for n in GAT_ROWS:
        for slots, (m, d) in GAT_SLOTS.items():
            for valid in (UPDATE_VALID[slots], 0.7):
                c = chip_smoke.gat_case(rng, n, m, d, 256, 4, [1, 5, n - 1], valid)
                args = (c["x"], c["w"], c["b"], c["er"], c["attn"], c["mask"])
                if name == "flash_gat_fused_bwd":
                    args += gat_kernels.flash_gat_fused_plain(*args, 4) + \
                        (torch.randn((n, 256), device="cuda"),)
                share = (c["mask"] > 0).float().mean().item()
                yield f"N={n} {slots} (M={m}, D={d}) valid {share:.3f}", args + (4,)


def flash_cases():
    """(label, wrapper arguments) of ``flash_gat``, drawn on the device."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in FLASH_ROWS:
        for m, valid in [(50, v) for v in SERVING_VALID + (0.7,)] + [(3, 1.0)]:
            args = chip_smoke.flash_gat_case(gen, n, m, 256, 4, [1, 5, n - 1], cut=1.0 - valid)
            share = (args[3] > 0).float().mean().item()
            yield f"N={n} {'seen' if m == 50 else 'near'} (M={m}) valid {share:.3f}", args + (4,)


def main():
    if len(sys.argv) != 3 or sys.argv[1] not in KERNELS:
        print(__doc__, file=sys.stderr)
        return 2
    name, old_source = sys.argv[1], Path(sys.argv[2]).resolve()
    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    wrapper, signatures = KERNELS[name]
    new = build.load(name, signatures)
    text = old_source.read_text()
    unscratched = name == "tarmac_step" and unscratched_forward(text)
    old_so = build.BUILD_DIR / f"{name}-ab-{hashlib.sha256(text.encode()).hexdigest()[:12]}.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(old_so), str(old_source)],
                   check=True, timeout=build.NVCC_TIMEOUT_S)
    old = ctypes.CDLL(str(old_so))
    for fn, (restype, argtypes) in signatures.items():
        if not hasattr(old, fn):        # an older source without the bf16 launchers
            continue
        getattr(old, fn).restype = restype
        getattr(old, fn).argtypes = argtypes
    if unscratched:
        old.tarmac_step_forward.restype, old.tarmac_step_forward.argtypes = UNSCRATCHED_FORWARD
    print(chip_smoke.card_line(), flush=True)

    rng = np.random.default_rng(0)
    if name in STEP_WORLDS:
        cases = list(step_cases(name, rng))
        if hasattr(old, f"{next(iter(signatures))}_bf16"):       # and the bf16 launchers
            cases += [(f"{label} bf16", tuple(t.to(torch.bfloat16) if torch.is_tensor(t) else t
                                              for t in args)) for label, args in cases]
    else:
        cases = flash_cases() if name == "flash_gat" else gat_cases(name, rng)
    for label, args in cases:
        def call(lib):
            if lib is old and unscratched:
                return call_unscratched(lib, args)
            build._loaded[name] = lib           # the wrapper launches whichever is loaded
            outs = wrapper(*args)
            return [outs] if torch.is_tensor(outs) else [o for o in outs if o is not None]

        with torch.no_grad():
            got, want = call(new), call(old)
            diff = max((g - r).abs().max().item() / scale(r) for g, r in zip(got, want))
            same = all(torch.equal(g, r) for g, r in zip(got, want))
            times = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                lib = old if which == "old" else new
                times[which].append(chip_smoke.time_cuda(lambda: call(lib)))
        build._loaded[name] = new
        print(f"{name} {label}: {sys.argv[2]} {times['old']} ms, this tree "
              f"{times['new']} ms; max |new - old| / max(1, max |old|) {diff:.2e}, "
              f"bit-identical {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
