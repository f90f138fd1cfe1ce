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
actions) at 32, 256 and 512 worlds (R = 256, 2,048 and 4,096; the forward also
at 40, the serving batch, and at the classic host loop's one 4-UBS world, R =
4), and again on the same inputs rounded to bf16 where the old source has the
bf16 launcher; for each step case the script also prints the plain version's ms
(after the turns), the card's bound (``chip_smoke.bound``; at f32 its
operations at the rate of 3xTF32 products on the tensor cores) and, at bf16,
each version's largest error against the plain version in float64 on
the same inputs, relative to max(1, max |referee|) per output. The
GATv2 kernels run at the 8-UBS width (4 heads of 64) for the 'seen' GT slots
(M = 50, D = 4) and the 'near' UBS slots (M = 7, D = 2), at N = 256 rows (the
update), 320 (serving 40 worlds) and 4096, each with slots valid at the share
``chip_smoke.py`` measures in the update's inputs (``UPDATE_VALID``) and at
70 % (its kernel cases), and at ``bench.py``'s rows (``BENCH_GAT_ROWS``: B·A =
2,048 of its ``per_step`` update and B·(T+1)·A = 104,448 of its ``hoisted``
one, at B = 256) at its 70 % (``BENCH_VALID``); the backward gets the plain
forward's statistics and a random cotangent, without ``dx`` (as in
training), and its plain version is timed up to ``PLAIN_BYTES`` of [N, M, HF]
f32. Both run again on the same inputs rounded to bf16 where the old source
has the bf16 launchers (the backward's statistics from the plain bf16
forward), with each version's error against the f64 referee up to N = 4,096
(``REFEREE_ROWS``). The forward also runs at
the classic host loop's rows (``HOST_GAT``: exp1's one UBS, N = 1, and one
4-UBS world, N = 4), with its plain ms and bound. ``flash_gat`` runs at the
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

PLAIN = {"tarmac_step": (step_kernels.tarmac_step_plain, chip_smoke.step_cost),
         "tarmac_step_bwd": (step_kernels.tarmac_step_bwd_plain, chip_smoke.step_bwd_cost),
         "flash_gat_fused": (gat_kernels.flash_gat_fused_plain, chip_smoke.gat_cost),
         "flash_gat_fused_bwd": (gat_kernels.flash_gat_fused_bwd_plain, chip_smoke.gat_bwd_cost)}
KERNELS = {  # name: (wrapper, ctypes signatures)
    "flash_gat": (gat_kernels.flash_gat, gat_kernels._FLASH_SIGNATURES),
    "tarmac_step": (step_kernels.tarmac_step, step_kernels._SIGNATURES),
    "tarmac_step_bwd": (step_kernels.tarmac_step_bwd, step_kernels._BWD_SIGNATURES),
    "flash_gat_fused": (gat_kernels.flash_gat_fused, gat_kernels._SIGNATURES),
    "flash_gat_fused_bwd": (gat_kernels.flash_gat_fused_bwd, gat_kernels._BWD_SIGNATURES),
}
STEP_WORLDS = {"tarmac_step": (32, 40, 256, 512), "tarmac_step_bwd": (32, 256, 512)}
HOST_STEP = (1, 4)                 # the classic host loop's TarMAC step: one 4-UBS world
GAT_ROWS = (256, 320, 4096)
BENCH_GAT_ROWS = (2048, 104448)    # bench.py at B = 256: B·A (per_step), B·(T+1)·A (hoisted)
BENCH_VALID = 0.7                  # its synthetic masks' valid share (chip_smoke.bench_synth_obs)
REFEREE_ROWS = 4096                # the f64 referee's rows at most (104,448 'seen' in f64 is GBs)
PLAIN_BYTES = 2 << 30              # the plain backward's [N, M, HF] f32 temporaries, at most
GAT_SLOTS = {"seen": (50, 4), "near": (7, 2)}        # M, D
UPDATE_VALID = {"seen": 0.32, "near": 1.0}           # valid share of the update's masks
# The classic host loop's #2 calls (N, M, D, valid share): exp1's one UBS over its 10 GTs,
# all valid; a 4-UBS world's 'seen' GT slots and its 'near' UBS slots.
HOST_GAT = ((1, 10, 4, 1.0), (4, 50, 4, UPDATE_VALID["seen"]), (4, 3, 2, 1.0))
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
    worlds = [(w, 8) for w in STEP_WORLDS[name]]
    if name == "tarmac_step":
        worlds.append(HOST_STEP)
    for w, a in worlds:
        args = tuple(chip_smoke.step_case(rng, w, a, 256, 64, 16, 9).values())
        if name == "tarmac_step_bwd":
            args += (torch.randn((w * a, 9), device="cuda"),
                     torch.randn((w * a, 256), device="cuda"))
        yield f"R={w * a}" + (f" (A={a}, the host loop's step)" if a != 8 else ""), \
            args + (a, 16, False)


def gat_cases(name, rng, dtype=torch.float32):
    """(label, wrapper arguments) of the GATv2 kernel ``name``, the inputs
    rounded to ``dtype``."""
    shapes = [(n, slots, valid) for n in GAT_ROWS for slots in GAT_SLOTS
              for valid in (UPDATE_VALID[slots], 0.7)]
    shapes += [(n, slots, BENCH_VALID) for n in BENCH_GAT_ROWS for slots in GAT_SLOTS]
    suffix = " bf16" if dtype == torch.bfloat16 else ""
    for n, slots, valid in shapes:
        m, d = GAT_SLOTS[slots]
        c = chip_smoke.gat_case(rng, n, m, d, 256, 4, [1, 5, n - 1], valid)
        args = tuple(c[k].to(dtype) for k in ("x", "w", "b", "er", "attn", "mask"))
        if name == "flash_gat_fused_bwd":
            args += gat_kernels.flash_gat_fused_plain(*args, 4) + \
                (torch.randn((n, 256), device="cuda").to(dtype), 4, 0.2, False)
        else:
            args += (4,)
        share = (c["mask"] > 0).float().mean().item()
        yield f"N={n} {slots} (M={m}, D={d}) valid {share:.3f}{suffix}", args
    if name == "flash_gat_fused":
        for n, m, d, valid in HOST_GAT:
            c = chip_smoke.gat_case(rng, n, m, d, 256, 4, [], valid)
            args = tuple(c[k].to(dtype) for k in ("x", "w", "b", "er", "attn", "mask")) + (4,)
            share = (c["mask"] > 0).float().mean().item()
            yield f"N={n} (M={m}, D={d}) valid {share:.3f}, the host loop's{suffix}", args


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
    elif name == "flash_gat":
        cases = flash_cases()
    else:
        cases = list(gat_cases(name, rng))
        if hasattr(old, f"{next(iter(signatures))}_bf16"):
            cases += list(gat_cases(name, rng, torch.bfloat16))
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
        if name in PLAIN:
            plain, cost = PLAIN[name]
            x = args[0]
            big = name == "flash_gat_fused_bwd" and \
                x.shape[0] * x.shape[1] * args[1].shape[1] * 4 > PLAIN_BYTES
            with torch.no_grad():
                plain_ms = None if big else chip_smoke.time_cuda(lambda: plain(*args))
                bound_ms, bound_by = chip_smoke.bound(*cost(args))
                plain_txt = "not measured" if plain_ms is None else f"{plain_ms:.4f} ms"
                line = f"{name} {label}: plain {plain_txt}, bound {bound_ms:.6f} ms " \
                    f"({bound_by})"
                if x.dtype == torch.bfloat16 and (name in STEP_WORLDS
                                                  or x.shape[0] <= REFEREE_ROWS):
                    ref = [r for r in plain(*(t.double() if torch.is_tensor(t) else t
                                              for t in args)) if r is not None]
                    errs = [max(chip_smoke.referee_err(g, r) for g, r in zip(outs, ref))
                            for outs in (want, got)]
                    line += f"; max |kernel - f64 referee| / max(1, max |referee|): " \
                        f"{sys.argv[2]} {errs[0]:.2e}, this tree {errs[1]:.2e}"
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
