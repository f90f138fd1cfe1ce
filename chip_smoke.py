#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``uav_bs_ctrl_tpu_torch``) on one GPU.

Run from anywhere: ``python3 chip_smoke.py``. Phases, each printed with its wall
time: the device; the nvcc build of every kernel (one nvcc per source, in
parallel); each of the five kernels against its plain PyTorch version on the
card; serving the committed exp3 8-UBS TarMAC policy (40 worlds, one 50-step
episode) through the kernels, with every step's Q checked against the plain
path; serving the committed exp3 4-UBS DiscreteComm policy with
``gat_backend='pallas'`` (``flash_gat``), every step's Q checked against the
plain path fed the same Gumbel noise, and ``flash_gat`` checked and timed on
the inputs of steps 0 and 25 (the 'seen' mask is about 1 % valid at the
first, 38 % at the second); the 8-UBS policy served through
``flash_gat`` against its fused-kernel serving; training the 8-UBS run through
``uav_bs_ctrl_tpu_torch.train``'s code path (resumed with its AdamW state, two
warm-ups and one full iteration of 40 updates, then evaluation); one update
through the kernels against the same update on the plain path, and repeated
bit for bit; and timings. Any failed phase exits non-zero with no result line.
The last line is the JSON device record.
"""

import contextlib
import faulthandler
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WATCHDOG_S = 600
ATOL = RTOL = 1e-4        # f32 kernel vs plain version, full width
F32_PEAK_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores (data sheet)
HBM_BYTES_PER_S = 3.35e12
RUN_DIR = ROOT / "data" / "exp3_fast_8ubs_tarmac_qmix_il10_lay64k" / \
    "exp3_fast_8ubs_tarmac_qmix_il10_lay64k_s0"
DISC_DIR = ROOT / "data" / "exp3_fast_4ubs_disc_lay64k" / "exp3_fast_4ubs_disc_lay64k_s0"
N_WORLDS = 40             # the run's n_worlds
EPS = 0.05                # evaluate_policy's test epsilon
DEVICE = "cuda"
REPLACES = {"flash_gat": "uav_bs_ctrl_tpu/ops/pallas_kernels.py:138",
            "flash_gat_fused": "uav_bs_ctrl_tpu/ops/pallas_kernels.py:329",
            "flash_gat_fused_bwd": "uav_bs_ctrl_tpu/ops/pallas_kernels.py:623",
            "tarmac_step": "uav_bs_ctrl_tpu/ops/step_kernels.py:314",
            "tarmac_step_bwd": "uav_bs_ctrl_tpu/ops/step_kernels.py:379"}
BWD_RTOL = 1e-4           # backward kernel vs plain: of each output's largest entry
UPDATE_LOSS_RTOL = 1e-5   # one update, kernels vs plain path: LossQ
UPDATE_GRAD_RTOL = 1e-4   # clipped grads, of the group's largest raw-gradient entry
UPDATE_PARAM_ATOL = 1e-5  # updated params and targets, where the gradient is resolved:
RESOLVED_RTOL = 1e-5      # |raw grad| above this share of the group's largest entry; below
                          # it the gradient is at the f32 roundoff of the sums (zero in
                          # exact arithmetic for some entries) and Adam's step has either sign
FLASH_RTOL = 1e-5         # flash_gat vs plain: of max(1, the output's largest entry)
DISC_Q_RTOL = 1e-4        # 4-UBS DiscreteComm Q vs the plain path: of max(1, max |Q|); Q is
                          # 150-190 there, where one f32 ulp is 1.5e-5
CAPTURE_STEPS = (0, 25)   # 4-UBS serving steps whose flash_gat inputs are checked and timed:
                          # the 'seen' mask is about 1 % valid at step 0, 38 % at step 25
TIE = 1e-4                # a Gumbel margin |z0 - z1| this small rounds either way: a roundoff
                          # tie, where the plain path's bit may follow the kernel path's


@contextlib.contextmanager
def phase(name):
    """Print the phase's name, then its wall time when it succeeds."""
    t0 = time.perf_counter()
    print(f"[phase] {name}", flush=True)
    yield
    print(f"[phase] {name} done in {time.perf_counter() - t0:.2f} s", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_cuda(fn, n_iter=20, reps=5):
    """Median device ms per call over ``reps`` runs of ``n_iter`` back-to-back
    calls, from CUDA events. A sleep kernel at least as long as the host needs
    to queue the calls keeps the card busy meanwhile, so the events see the
    calls' device time, not their launch latency."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    cycles = int(host_ms * 4e6) + 10_000_000    # >= host_ms at any clock up to 4 GHz
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n_iter)
    return statistics.median(times)


def gat_case(rng, n, m, d, hf, heads, masked_rows, valid=0.7):
    """flash_gat_fused's inputs, each slot valid with probability ``valid``."""
    f = hf // heads
    arr = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)
    mask = (rng.random((n, m)) < valid).astype(np.float32)
    mask[masked_rows] = 0.0
    return dict(
        x=arr(rng.normal(size=(n, m, d))),
        w=arr(rng.normal(size=(d, hf)) / np.sqrt(d)),
        b=arr(0.1 * rng.normal(size=hf)),
        er=arr(rng.normal(size=(n, hf))),
        attn=arr(rng.normal(size=(heads, f)) / np.sqrt(f)),
        mask=arr(mask))


def flash_gat_case(gen, n, m, hf, heads, masked_rows, scale=1.0, cut=0.3):
    """(el, er, attn, mask) for flash_gat, drawn on the device from the
    device generator ``gen`` (N = 4096, M = 256 is 268 M values); ``scale``
    multiplies el and er; a slot is valid where a uniform draw exceeds ``cut``."""
    f = hf // heads
    normal = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE)
    mask = (torch.rand((n, m), generator=gen, device=DEVICE) > cut).to(torch.float32)
    mask[masked_rows] = 0.0
    return scale * normal(n, m, hf), scale * normal(n, hf), normal(heads, f) / f ** 0.5, mask


def step_case(rng, w, a, hidden, msg, key, n_act, empty_world=False):
    """Random step inputs; with ``empty_world``, world 1 has no edge at all."""
    arr = lambda t: torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(DEVICE)
    lin = lambda i, o: rng.normal(size=(i, o)) / np.sqrt(i)
    adjf = (rng.random((w * a, a)) > 0.4).astype(np.float32)
    adjf[np.arange(w * a), np.arange(w * a) % a] = 1.0      # self-loops ...
    adjf[0:a, 1] = 0.0                                       # ... but world 0, agent 1 hears no one
    if empty_world:
        adjf[a:2 * a] = 0.0
    return dict(
        x=arr(np.maximum(rng.normal(size=(w * a, hidden)), 0.0)),
        h=arr(np.tanh(rng.normal(size=(w * a, hidden)))),
        adjf=arr(adjf),
        wv=arr(lin(2 * hidden, msg)), bv=arr(0.1 * rng.normal(size=msg)),
        ws=arr(lin(2 * hidden, key)), bs=arr(0.1 * rng.normal(size=key)),
        wq=arr(lin(2 * hidden, key)), bq=arr(0.1 * rng.normal(size=key)),
        wi=arr(lin(hidden + msg, 3 * hidden)), wh=arr(lin(hidden, 3 * hidden)),
        bi=arr(0.1 * rng.normal(size=3 * hidden)), bh=arr(0.1 * rng.normal(size=3 * hidden)),
        wo=arr(lin(hidden, n_act)), bo=arr(0.1 * rng.normal(size=n_act)),
        wvh=arr(lin(hidden, 1)), bvh=arr(0.1 * rng.normal(size=1)))


def max_err(got, want, what):
    """Max |got - want| over the output tuple; raises beyond ATOL + RTOL*|want|."""
    worst = 0.0
    for g, r in zip(got, want):
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{what}: bad output (shape {tuple(g.shape)} vs "
                                 f"{tuple(r.shape)}, or non-finite values)")
        worst = max(worst, (g - r).abs().max().item())
        if not torch.allclose(g, r, atol=ATOL, rtol=RTOL):
            raise AssertionError(f"{what}: max |kernel - plain| = "
                                 f"{(g - r).abs().max().item():.3e} beyond "
                                 f"atol={ATOL}, rtol={RTOL}")
    return worst


def gat_cost(x, mask, hf, heads):
    """(operations, bytes) one flash_gat_fused call needs: per valid slot the
    projection 2*D*HF, bias, +er, LeakyReLU, score 2*HF and aggregation 2*HF,
    plus 3 per head for the softmax; each input read once, each output written once."""
    n, m, d = x.shape
    valid = float((mask > 0).sum())
    ops = valid * (hf * (2 * d + 7) + 3 * heads) + n * hf
    nbytes = 4 * (x.numel() + mask.numel() + 2 * n * hf + d * hf + 2 * hf + 2 * n * heads)
    return ops, nbytes


def flash_gat_cost(el, mask, heads):
    """(operations, bytes) one flash_gat call needs: per valid slot +er,
    LeakyReLU (2), x attn, the score sum and the weighted sum (2), about 7*HF,
    plus 3 per head for the softmax, and a divide per output. Bytes: the mask,
    er and attn read once, the output written once, and of el only the valid
    slots' rows (a masked slot's contiguous HF-row does not reach the output)."""
    n, m, hf = el.shape
    valid = float((mask > 0).sum())
    ops = valid * (7 * hf + 3 * heads) + n * hf
    nbytes = 4 * (valid * hf + mask.numel() + 2 * n * hf + hf)
    return ops, nbytes


def step_cost(args):
    """(operations, bytes) one tarmac_step call needs: the v/s/q projections,
    scores, softmax and aggregation over the valid edges, the GRU's two
    products and gates, and the head."""
    x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo, wvh, bvh = args[:17]
    dueling = args[19]
    rows, hid = x.shape
    msg, key, n_act = wv.shape[1], ws.shape[1], wo.shape[1]
    edges = float((adjf > 0).sum())
    ops = (rows * 2 * 2 * hid * (msg + 2 * key) + edges * (2 * key + 3 + 2 * msg)
           + rows * 2 * ((hid + msg) * 3 * hid + hid * 3 * hid) + rows * hid * 10
           + rows * 2 * hid * (n_act + (1 if dueling else 0)))
    read = args[:15] + ((wvh, bvh) if dueling else ())
    nbytes = 4 * (sum(t.numel() for t in read) + rows * (n_act + hid))
    return ops, nbytes


def gat_bwd_cost(x, mask, hf, heads, need_dx):
    """(operations, bytes) one flash_gat_fused_bwd call needs: per valid slot
    the recompute of el, z, LeakyReLU and the score (2*D*HF + 5*HF), d_alpha
    (2*HF), d_s, d_z and d_el (5*HF), the der/dattn/db sums (4*HF) and dW
    (2*D*HF), plus 4 per head for alpha; dx adds 2*D*HF per slot. Each input
    (x, mask, w, b, er, attn, g, out, m, l) read once, each output written once."""
    n, m, d = x.shape
    valid = float((mask > 0).sum())
    ops = valid * (hf * (4 * d + 16 + (2 * d if need_dx else 0)) + 4 * heads) + 2 * n * hf
    nbytes = 4 * (x.numel() + mask.numel() + 3 * n * hf + 2 * n * heads + 2 * d * hf + 2 * hf
                  + n * hf + d * hf + 2 * hf + (x.numel() if need_dx else 0))
    return ops, nbytes


def step_bwd_cost(args):
    """(operations, bytes) one tarmac_step_bwd call needs: the forward
    recompute up to h2; the head, GRU (elementwise) and attention backwards;
    the transposed products [dx|dc] = dgi wi^T, dgh wh^T and dv/ds/dq times
    the v/s/q weights; and the 14 weight gradients X^T G with their bias sums.
    Inputs (x, h, adjf, weights, gq, gh2) read once, outputs (dx, dh, 14
    weight gradients) written once."""
    x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo, wvh, bvh = args[:17]
    rows, hid = x.shape
    msg, key, n_act = wv.shape[1], ws.shape[1], wo.shape[1]
    edges = float((adjf > 0).sum())
    vsq = rows * 2 * 2 * hid * (msg + 2 * key)                  # [x|h] @ [wv|ws|wq]
    gru = rows * 2 * ((hid + msg) * 3 * hid + hid * 3 * hid)   # the GRU's two products
    attn = edges * (2 * key + 3 + 2 * msg)
    recompute = vsq + attn + gru + rows * hid * 10
    backward = (rows * 2 * hid * (n_act + 1) + rows * hid * 12  # head, GRU gates
                + gru                                          # dgi wi^T, dgh wh^T
                + edges * (4 * msg + 4 * key + 4)              # dalpha, dv, dscore, ds, dq
                + vsq // 2)                                    # dv/ds/dq @ v/s/q weights
    weight_grads = vsq + gru + rows * 2 * hid * (n_act + 1) + rows * (6 * hid + msg + 2 * key
                                                                      + n_act + 1)
    weights = args[3:17]
    nbytes = 4 * (2 * sum(t.numel() for t in weights) + x.numel() + h.numel() + adjf.numel()
                  + rows * (n_act + hid) + 2 * rows * hid)
    return recompute + backward + weight_grads, nbytes


def rel_err(got, want, what, limit=BWD_RTOL):
    """max |got - want| / max(1, max |want|) over the outputs; raises beyond
    ``limit`` or on a shape mismatch or non-finite values."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, want)):
        if r is None and g is None:
            continue
        if g is None or r is None or g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{what} output {i}: bad output (missing, shape, or non-finite)")
        err = (g - r).abs().max().item() / max(1.0, r.abs().max().item())
        if err > limit:
            raise AssertionError(f"{what} output {i}: max |kernel - plain| / max(1, max|plain|)"
                                 f" = {err:.3e} beyond {limit}")
        worst = max(worst, err)
    return worst


def bound(ops, nbytes):
    t_ops, t_bytes = ops / F32_PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def capture_kernel_calls(agent, obs, h, key=None):
    """The (name, args) of every kernel call one policy forward makes (the
    models call the fused forward kernels through their autograd Functions,
    with the forward kernels' arguments, and flash_gat directly)."""
    from uav_bs_ctrl_tpu_torch.models import agents, encoders
    calls = []
    targets = {"flash_gat": (encoders, "flash_gat"),
               "flash_gat_fused": (encoders, "flash_gat_fused_train"),
               "tarmac_step": (agents, "tarmac_step_train")}
    orig = {name: getattr(mod, attr) for name, (mod, attr) in targets.items()}

    def recorder(name):
        def rec(*args):
            calls.append((name, args))
            return orig[name](*args)
        return rec

    for name, (mod, attr) in targets.items():
        setattr(mod, attr, recorder(name))
    try:
        agent(obs, h, key=key)
    finally:
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, orig[name])
    return calls


@contextlib.contextmanager
def same_bits_at_ties(ties):
    """DiscreteComm's sample, for a policy called twice per step on the same
    noise (kernel path, then plain path): where the two paths' hard bits
    differ, the plain path's Gumbel margin |z0 - z1| must be within ``TIE``
    (logits an f32 roundoff apart round the sample either way) and the plain
    path then takes the kernel path's bit; a wider difference raises.
    ``ties`` counts such bits and keeps the smallest margin seen."""
    from uav_bs_ctrl_tpu_torch.models import comm
    from uav_bs_ctrl_tpu_torch.models.modules import gumbel_noise, gumbel_softmax
    first = []

    def sample(logits, tau=1.0, hard=False, seed=None, noise=None):
        if noise is None:
            noise = gumbel_noise(logits.shape, seed, logits.device)
        z = logits + noise
        bits = gumbel_softmax(logits, tau, hard, noise=noise)
        margin = (z[..., 0] - z[..., 1]).abs()
        ties["min_margin"] = min(ties["min_margin"], margin.min().item())
        if not first:
            first.append(bits)
            return bits
        bits_k = first.pop()
        differ = (bits != bits_k).any(-1)
        wide = (differ & (margin > TIE)).sum().item()
        if wide:
            raise AssertionError(f"{wide} DiscreteComm bits differ between the kernel and "
                                 f"the plain path at Gumbel margins beyond {TIE}")
        ties["bits"] += int(differ.sum())
        return torch.where(differ[..., None], bits_k, bits)

    comm.gumbel_softmax = sample
    try:
        yield
    finally:
        comm.gumbel_softmax = gumbel_softmax


def capture_backward_calls(learner, batch, step):
    """Run one kernel-path backward of ``learner`` on ``batch`` and return the
    inputs the two backward kernels got at policy step ``step``:
    ``[("flash_gat_fused_bwd", (fwd_args, g)) x2, ("tarmac_step_bwd",
    (fwd_args, gq, gh2))]``, the cotangents caught by hooks on the outputs;
    and the valid share of the masks of every ``flash_gat_fused`` call of the
    update, ``[seen, near]`` (the policy and the target unroll)."""
    from uav_bs_ctrl_tpu_torch.models import agents, encoders
    orig_gat, orig_step = encoders.flash_gat_fused_train, agents.tarmac_step_train
    seen = {"gat": 0, "step": 0, "any": 0}
    grads = {}
    valid = [[0.0, 0], [0.0, 0]]           # 'seen', 'near': valid slots, slots

    def hook(key):
        def store(g):
            grads[key] = g.detach().contiguous().clone()
        return store

    def rec_gat(*args):
        out = orig_gat(*args)
        which = valid[seen["any"] % 2]           # each policy step calls 'seen', then 'near'
        which[0] += float((args[5] > 0).sum())
        which[1] += args[5].numel()
        seen["any"] += 1
        if torch.is_grad_enabled():
            if seen["gat"] // 2 == step:
                key = ("gat", seen["gat"] % 2)
                grads[key + ("args",)] = tuple(a.detach() if torch.is_tensor(a) else a
                                               for a in args)
                out.register_hook(hook(key))
            seen["gat"] += 1
        return out

    def rec_step(*args):
        q, h2 = orig_step(*args)
        if torch.is_grad_enabled():
            if seen["step"] == step:
                grads["step_args"] = tuple(a.detach() if torch.is_tensor(a) else a
                                           for a in args)
                q.register_hook(hook("gq"))
                h2.register_hook(hook("gh2"))
            seen["step"] += 1
        return q, h2

    encoders.flash_gat_fused_train, agents.tarmac_step_train = rec_gat, rec_step
    try:
        learner.backward(batch, use_kernels=True)
    finally:
        encoders.flash_gat_fused_train, agents.tarmac_step_train = orig_gat, orig_step
    return [("flash_gat_fused_bwd", (grads[("gat", 0, "args")], grads[("gat", 0)])),
            ("flash_gat_fused_bwd", (grads[("gat", 1, "args")], grads[("gat", 1)])),
            ("tarmac_step_bwd", (grads["step_args"], grads["gq"], grads["gh2"]))], \
        [v / total for v, total in valid]


def launch_split(events, n_calls):
    """Mean device ms of each launch position within one call, from the
    ``(start_us, duration_us, name)`` of ``n_calls`` calls' launches in
    order; None unless every call made the same number of launches."""
    events = sorted(events)
    if not n_calls or len(events) % n_calls:
        return None
    per_call = len(events) // n_calls
    return [(events[p][2], sum(e[1] for e in events[p::per_call]) / n_calls / 1e3)
            for p in range(per_call)]


LIBRARY_TAGS = {"tarmac_step": "tarmac_step_fwd",      # a word in every kernel name of
                "tarmac_step_bwd": "tarmac_step_bwd",  # the library, and in no other
                "flash_gat_fused": "flash_gat_fused_fwd",
                "flash_gat_fused_bwd": "flash_gat_fused_bwd"}


def kernel_label(name):
    """A profiled kernel's function name with its template tag, no namespaces."""
    return name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]


def profile_updates(learner, batch, n, ms_per_update, calls_per_update):
    """Device time of ``n`` kernel-path updates by kernel, from
    ``torch.profiler`` (device-side events only, so no kernel is counted twice
    through the operator that launched it), against ``ms_per_update``, the
    wall time of an update measured without the profiler. Prints the top 8,
    and for each kernel of ``calls_per_update`` (``{name: wrapper calls per
    update}``, names in ``LIBRARY_TAGS``) its CUDA kernels and the split of one
    call over its launches; returns ``{name: CUDA launches per update}`` (None
    when the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.enable_grad():
        learner.update_on_batch(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                learner.update_on_batch(batch)
            torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3 / n, e.count // n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    if not rows:
        print("  profiler: no device time recorded; the busy share is not measured", flush=True)
        return None
    busy = sum(r[0] for r in rows)
    print(f"  profiler, {n} updates through the kernels: device busy {busy:.2f} ms per update, "
          f"{100 * busy / ms_per_update:.1f} % of the {ms_per_update:.2f} ms an update takes "
          f"without the profiler; {sum(r[1] for r in rows)} kernel launches per update",
          flush=True)
    for ms, count, key in rows[:8]:
        print(f"    {ms:8.3f} ms/update  {count:6d} launches/update  {key[:80]}", flush=True)
    launches = {}
    for name, calls in calls_per_update.items():
        tag = LIBRARY_TAGS[name]
        mine = [r for r in rows if tag in r[2]]
        print(f"  {name}'s kernels: {sum(r[0] for r in mine):.3f} ms/update over "
              f"{sum(r[1] for r in mine)} launches/update ({calls} calls)", flush=True)
        for ms, count, key in mine:
            print(f"    {ms:8.3f} ms/update  {count:6d} launches/update  {kernel_label(key)}",
                  flush=True)
        split = launch_split([(e.time_range.start, e.time_range.elapsed_us(), e.name)
                              for e in prof.events() if e.device_type == DeviceType.CUDA
                              and tag in e.name], n * calls)
        if split is None:
            print(f"  {name}'s calls made unequal numbers of launches", flush=True)
        else:
            print(f"  one {name} call, launch by launch (mean device ms): " + ", ".join(
                f"{kernel_label(k)} {ms:.4f}" for k, ms in split), flush=True)
        launches[name] = sum(r[1] for r in mine)
    return launches


def training_log_test_stats(run_dir, epoch):
    lines = (run_dir / "progress.txt").read_text().splitlines()
    head = lines[0].split("\t")
    for line in lines[1:]:
        row = dict(zip(head, line.split("\t")))
        if int(float(row["Epoch"])) == epoch:
            return {k: float(v) for k, v in row.items()
                    if k in ("AverageTestEpRet", "StdTestEpRet", "TestFairIdx",
                             "TestAvgGlobalUtility",
                             "TestTotalThroughput", "TestProbCollision")}
    return {}


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "uav_bs_ctrl_tpu_torch").is_dir() or not RUN_DIR.is_dir() \
            or not DISC_DIR.is_dir():
        print(f"chip_smoke: the uav_bs_ctrl_tpu_torch package, {RUN_DIR.relative_to(ROOT)} and "
              f"{DISC_DIR.relative_to(ROOT)} must sit beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from uav_bs_ctrl_tpu_torch import serve, train
    from uav_bs_ctrl_tpu_torch.algos import collect
    from uav_bs_ctrl_tpu_torch.envs import torch_env
    from uav_bs_ctrl_tpu_torch.models.modules import gumbel_noise
    from uav_bs_ctrl_tpu_torch.ops import build
    from uav_bs_ctrl_tpu_torch.ops.gat_kernels import (
        flash_gat, flash_gat_fused, flash_gat_fused_bwd, flash_gat_fused_bwd_plain,
        flash_gat_fused_plain, flash_gat_plain)
    from uav_bs_ctrl_tpu_torch.ops.step_kernels import (
        tarmac_step, tarmac_step_bwd, tarmac_step_bwd_plain, tarmac_step_plain)
    kernels = {"flash_gat": (flash_gat, flash_gat_plain),
               "flash_gat_fused": (flash_gat_fused, flash_gat_fused_plain),
               "tarmac_step": (tarmac_step, tarmac_step_plain)}
    bwd_kernels = {"flash_gat_fused_bwd": (flash_gat_fused_bwd, flash_gat_fused_bwd_plain),
                   "tarmac_step_bwd": (tarmac_step_bwd, tarmac_step_bwd_plain)}
    all_kernels = {name: table[name] for name in REPLACES
                   for table in (kernels, bwd_kernels) if name in table}

    def reset_counts():
        for fn, _ in all_kernels.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, (fn, _) in all_kernels.items()}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.set_grad_enabled(False)
    device = torch.device(DEVICE)

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        card = card_line()
        print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}; "
              f"nvidia-smi: {card}", flush=True)

    with phase("build"):
        build.build(list(all_kernels))

    worst = dict.fromkeys(all_kernels, 0.0)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    with phase("kernels against plain versions"):
        k_4ubs = torch_env.make_params("4ubs").n_ubs - 1           # 'near' slots at 4 UBS
        for n in (160, 320, 4096):
            for m in (50, k_4ubs, 256):
                for hf, heads in ((256, 4), (128, 2)):
                    args = flash_gat_case(gen, n, m, hf, heads, masked_rows=[1, 5, n - 1]) + \
                        (heads,)
                    got = flash_gat(*args)
                    what = f"flash_gat N={n} M={m} HF={hf} H={heads}"
                    err = rel_err([got], [flash_gat_plain(*args)], what, FLASH_RTOL)
                    zero = got[args[3].sum(1) == 0].abs().max().item()
                    if zero != 0.0:
                        raise AssertionError(f"{what}: fully masked rows gave {zero}")
                    worst["flash_gat"] = max(worst["flash_gat"], err)
        print(f"  flash_gat, 18 cases (N 160/320/4096, M 50/{k_4ubs}/256, 4x64 and 2x128): max "
              f"|k - p| / max(1, max|p|) {worst['flash_gat']:.3e}, fully masked rows exactly 0",
              flush=True)
        args = flash_gat_case(gen, 320, 256, 128, 2, masked_rows=[1], scale=50.0) + (2,)
        got = flash_gat(*args)
        err = rel_err([got], [flash_gat_plain(*args)], "flash_gat x50 scores", FLASH_RTOL)
        print(f"  flash_gat x50 score magnitudes N=320 M=256: {err:.3e} (max |out| "
              f"{got.abs().max().item():.1f})", flush=True)
        worst["flash_gat"] = max(worst["flash_gat"], err)
        for n, m, d, label in ((320, 50, 4, "seen"), (320, 7, 2, "near"), (4096, 50, 4, "large")):
            c = gat_case(rng, n, m, d, 256, 4, masked_rows=[1, 5, n - 1])
            args = (c["x"], c["w"], c["b"], c["er"], c["attn"], c["mask"], 4)
            got = flash_gat_fused(*args)
            err = max_err(got, flash_gat_fused_plain(*args), f"flash_gat_fused {label}")
            zero = got[0][[1, 5, n - 1]].abs().max().item()
            if zero != 0.0:
                raise AssertionError(f"flash_gat_fused {label}: fully masked rows gave {zero}")
            print(f"  flash_gat_fused {label} N={n} M={m} D={d}: max abs err {err:.3e}", flush=True)
            worst["flash_gat_fused"] = max(worst["flash_gat_fused"], err)
        for w in (40, 512):
            for dueling in (False, True):
                c = step_case(rng, w, 8, 256, 64, 16, 9)
                args = tuple(c.values()) + (8, 16, dueling)
                got = tarmac_step(*args)
                err = max_err(got, tarmac_step_plain(*args),
                              f"tarmac_step W={w} dueling={dueling}")
                iso = got[1][1] - tarmac_step_plain(*args)[1][1]     # the isolated destination
                print(f"  tarmac_step W={w} dueling={dueling}: max abs err {err:.3e} "
                      f"(isolated destination {iso.abs().max().item():.1e})", flush=True)
                worst["tarmac_step"] = max(worst["tarmac_step"], err)
        # The 4-UBS width (A = 4), and a world with no edge at all (every alpha 0, c = 0).
        for w, a, dueling, empty_world in ((40, 4, False, False), (512, 4, True, False),
                                           (40, 8, True, True)):
            args = tuple(step_case(rng, w, a, 256, 64, 16, 9, empty_world).values()) + \
                (a, 16, dueling)
            what = f"tarmac_step W={w} A={a} dueling={dueling} empty world={empty_world}"
            err = max_err(tarmac_step(*args), tarmac_step_plain(*args), what)
            print(f"  {what}: max abs err {err:.3e}", flush=True)
            worst["tarmac_step"] = max(worst["tarmac_step"], err)

    with phase("backward kernels against plain versions"):
        for n in (256, 4096):
            for m, d in ((50, 4), (7, 2)):
                c = gat_case(rng, n, m, d, 256, 4, masked_rows=[1, 5, n - 1])
                args = (c["x"], c["w"], c["b"], c["er"], c["attn"], c["mask"])
                out, mstat, lstat = flash_gat_fused(*args, 4)
                g = torch.randn(out.shape, device=device)
                for need_dx in (False, True):
                    bwd_args = args + (out, mstat, lstat, g, 4, 0.2, need_dx)
                    got = flash_gat_fused_bwd(*bwd_args)
                    what = f"flash_gat_fused_bwd N={n} M={m} D={d} dx={need_dx}"
                    err = rel_err(got, flash_gat_fused_bwd_plain(*bwd_args), what)
                    zero = got[3][[1, 5, n - 1]].abs().max().item()
                    if zero != 0.0:
                        raise AssertionError(f"{what}: fully masked rows gave der {zero}")
                    print(f"  {what}: max rel err {err:.3e}", flush=True)
                    worst["flash_gat_fused_bwd"] = max(worst["flash_gat_fused_bwd"], err)
        for w in (32, 512):
            for dueling in (False, True):
                c = step_case(rng, w, 8, 256, 64, 16, 9)
                gq = torch.randn((w * 8, 9), device=device)
                gh2 = torch.randn((w * 8, 256), device=device)
                args = tuple(c.values()) + (gq, gh2, 8, 16, dueling)
                what = f"tarmac_step_bwd W={w} dueling={dueling}"
                err = rel_err(tarmac_step_bwd(*args), tarmac_step_bwd_plain(*args), what)
                print(f"  {what} (world 0, agent 1 hears no one): max rel err {err:.3e}",
                      flush=True)
                worst["tarmac_step_bwd"] = max(worst["tarmac_step_bwd"], err)
        # The 4-UBS width (A = 4), and a world with no edge at all (every alpha 0, c = 0).
        for w, a, dueling, empty_world in ((32, 4, False, False), (512, 4, True, False),
                                           (32, 8, True, True)):
            c = step_case(rng, w, a, 256, 64, 16, 9, empty_world)
            gq = torch.randn((w * a, 9), device=device)
            gh2 = torch.randn((w * a, 256), device=device)
            args = tuple(c.values()) + (gq, gh2, a, 16, dueling)
            what = f"tarmac_step_bwd W={w} A={a} dueling={dueling} empty world={empty_world}"
            err = rel_err(tarmac_step_bwd(*args), tarmac_step_bwd_plain(*args), what)
            print(f"  {what}: max rel err {err:.3e}", flush=True)
            worst["tarmac_step_bwd"] = max(worst["tarmac_step_bwd"], err)

    with phase(f"serve {RUN_DIR.name}: {N_WORLDS} worlds, one episode, eps={EPS}"):
        reset_counts()
        t0 = time.perf_counter()
        stats = serve.evaluate(RUN_DIR, N_WORLDS, eps=EPS, seed=0, device=DEVICE)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve_launches = counts()
        steps = torch_env.make_params("8ubs").episode_limit
        print(f"  launches on the serving path: {serve_launches} over {steps} env steps "
              f"({serve_s:.2f} s, loading included)", flush=True)
        want = dict(dict.fromkeys(all_kernels, 0), flash_gat_fused=2 * steps, tarmac_step=steps)
        if serve_launches != want:
            raise AssertionError(f"expected {want} launches, got {serve_launches}")
        for key, v in stats.items():
            if tuple(v.shape) != (N_WORLDS,) or not torch.isfinite(v).all():
                raise AssertionError(f"{key}: shape {tuple(v.shape)} or non-finite values")
        means = {k: float(v.mean()) for k, v in stats.items()}
        print(f"  episode stats (mean over {N_WORLDS} worlds): {json.dumps(means)}")
        print(f"  the training log's test stats at epoch 200 (JAX, other layouts): "
              f"{json.dumps(training_log_test_stats(RUN_DIR, 200))}", flush=True)

    with phase("serve again, every step's Q and h' against the unfused plain path"):
        agent, config = serve.load_policy(RUN_DIR, DEVICE)
        env_params = torch_env.make_params(config["map_id"])
        errs, calls, first = [], [], []

        def checked(obs, h, key=None):
            if not calls:
                first.extend((obs, h))
                calls.extend(capture_kernel_calls(agent, obs, h))
            q, h2 = agent(obs, h)
            q_ref, h_ref = agent(obs, h, use_kernels=False)
            errs.append(((q - q_ref).abs().max().item(), (h2 - h_ref).abs().max().item()))
            return q, h2

        stats2 = collect.evaluate_policy(env_params, checked, serve.test_pool(config["map_id"], 0),
                                         agent.hidden, torch.Generator().manual_seed(0),
                                         N_WORLDS, device, EPS)
        worst_q, worst_h = max(e[0] for e in errs), max(e[1] for e in errs)
        print(f"  {len(errs)} steps: max |dQ| {worst_q:.3e}, max |dh'| {worst_h:.3e} "
              f"(bound {ATOL}); same episode stats as the first run: "
              f"{all(torch.equal(stats[k], stats2[k]) for k in stats)}", flush=True)
        if len(errs) != steps or worst_q > ATOL or worst_h > ATOL:
            raise AssertionError(f"per-step Q/h' beyond {ATOL}: {worst_q:.3e} / {worst_h:.3e}")
        for name, args in calls:
            fn, plain = kernels[name]
            worst[name] = max(worst[name], max_err(fn(*args), plain(*args),
                                                   f"{name} on serving inputs"))

    with phase(f"serve {DISC_DIR.name} with gat_backend='pallas': {N_WORLDS} worlds, one "
               f"episode, eps={EPS}"):
        reset_counts()
        t0 = time.perf_counter()
        disc_stats = serve.evaluate(DISC_DIR, N_WORLDS, eps=EPS, seed=0, device=DEVICE,
                                    gat_backend="pallas")
        torch.cuda.synchronize()
        disc_s = time.perf_counter() - t0
        disc_launches = counts()
        disc_steps = torch_env.make_params("4ubs").episode_limit
        print(f"  launches on the serving path: {disc_launches} over {disc_steps} env steps "
              f"({disc_s:.2f} s, loading included)", flush=True)
        want = dict(dict.fromkeys(all_kernels, 0), flash_gat=2 * disc_steps)
        if disc_launches != want:
            raise AssertionError(f"expected {want} launches, got {disc_launches}")
        for key, v in disc_stats.items():
            if tuple(v.shape) != (N_WORLDS,) or not torch.isfinite(v).all():
                raise AssertionError(f"{key}: shape {tuple(v.shape)} or non-finite values")
        print(f"  episode stats (mean over {N_WORLDS} worlds): "
              f"{json.dumps({k: float(v.mean()) for k, v in disc_stats.items()})}")
        print(f"  the training log's test stats at epoch 200 (JAX, other layouts): "
              f"{json.dumps(training_log_test_stats(DISC_DIR, 200))}", flush=True)

    with phase("serve the 4-UBS policy again, every step's Q and h' against the plain path "
               "on the same Gumbel noise"):
        dagent, dconfig = serve.load_policy(DISC_DIR, DEVICE, gat_backend="pallas")
        denv = torch_env.make_params(dconfig["map_id"])
        derrs, dcalls = [], {}               # dcalls: {step: the step's kernel calls}
        ties = {"bits": 0, "min_margin": float("inf")}

        def dchecked(obs, h, key):
            seed = int(key)                  # one seed, so the same noise, for every call
            if len(derrs) in CAPTURE_STEPS:
                dcalls[len(derrs)] = capture_kernel_calls(dagent, obs, h, seed)
            with same_bits_at_ties(ties):
                q, h2 = dagent(obs, h, key=seed)
                q_ref, h_ref = dagent(obs, h, use_kernels=False, key=seed)
            derrs.append(((q - q_ref).abs().max().item() / max(1.0, q_ref.abs().max().item()),
                          (h2 - h_ref).abs().max().item()))
            return q, h2

        dpool = serve.test_pool(dconfig["map_id"], 0)
        stats2 = collect.evaluate_policy(denv, dchecked, dpool, dagent.hidden,
                                         torch.Generator().manual_seed(0), N_WORLDS, device, EPS)
        worst_q, worst_h = max(e[0] for e in derrs), max(e[1] for e in derrs)
        print(f"  {len(derrs)} steps: max |dQ| / max(1, max |Q|) {worst_q:.3e} (bound "
              f"{DISC_Q_RTOL}), max |dh'| {worst_h:.3e} (bound {ATOL}); DiscreteComm bits "
              f"taken from the kernel path at roundoff ties: {ties['bits']} (smallest Gumbel "
              f"margin {ties['min_margin']:.2e}, tie bound {TIE}); same episode stats as the "
              f"first run: {all(torch.equal(disc_stats[k], stats2[k]) for k in disc_stats)}",
              flush=True)
        if len(derrs) != disc_steps or worst_q > DISC_Q_RTOL or worst_h > ATOL:
            raise AssertionError(f"per-step Q/h' beyond {DISC_Q_RTOL}/{ATOL}: "
                                 f"{worst_q:.3e} / {worst_h:.3e}")
        for step in CAPTURE_STEPS:
            names = [name for name, _ in dcalls[step]]
            if names != ["flash_gat", "flash_gat"]:
                raise AssertionError(f"4-UBS policy step {step} called {names}")
            for rel, (name, args) in zip(("seen", "near"), dcalls[step]):
                got, what = flash_gat(*args), f"flash_gat on step {step}'s '{rel}' inputs"
                err = rel_err([got], [flash_gat_plain(*args)], what, FLASH_RTOL)
                empty = args[3].sum(1) == 0
                zero = got[empty].abs().max().item() if empty.any() else 0.0
                if zero != 0.0:
                    raise AssertionError(f"{what}: fully masked rows gave {zero}")
                print(f"  {what} {tuple(args[0].shape)}: valid share "
                      f"{(args[3] > 0).float().mean().item():.4f}, {int(empty.sum())} fully "
                      f"masked rows; max |k - p| / max(1, max|p|) {err:.3e}", flush=True)
                worst[name] = max(worst[name], err)

    with phase(f"serve {RUN_DIR.name} with gat_backend='pallas': {N_WORLDS} worlds, one "
               f"episode, every step's Q against the fused-kernel serving path"):
        pagent, _ = serve.load_policy(RUN_DIR, DEVICE, gat_backend="pallas")
        perrs = []
        reset_counts()

        def pchecked(obs, h, key=None):
            q, h2 = pagent(obs, h)
            q_ref, h_ref = agent(obs, h)
            perrs.append(((q - q_ref).abs().max().item(), (h2 - h_ref).abs().max().item()))
            return q, h2

        stats3 = collect.evaluate_policy(env_params, pchecked, serve.test_pool(config["map_id"], 0),
                                         agent.hidden, torch.Generator().manual_seed(0),
                                         N_WORLDS, device, EPS)
        torch.cuda.synchronize()
        # The 'pallas' policy launches flash_gat x2 and tarmac_step per step; the
        # fused reference beside it flash_gat_fused x2 and tarmac_step.
        pallas_launches = counts()
        want = dict(dict.fromkeys(all_kernels, 0), flash_gat=2 * steps,
                    flash_gat_fused=2 * steps, tarmac_step=2 * steps)
        worst_q, worst_h = max(e[0] for e in perrs), max(e[1] for e in perrs)
        print(f"  launches, the 'pallas' policy and its fused reference: {pallas_launches}",
              flush=True)
        print(f"  {len(perrs)} steps: max |dQ| {worst_q:.3e}, max |dh'| {worst_h:.3e} against "
              f"the fused kernels (bound {ATOL}); episode stats "
              f"{json.dumps({k: float(v.mean()) for k, v in stats3.items()})}; the same as "
              f"the fused serving: {all(torch.equal(stats[k], stats3[k]) for k in stats)}",
              flush=True)
        if pallas_launches != want:
            raise AssertionError(f"expected {want} launches, got {pallas_launches}")
        if len(perrs) != steps or worst_q > ATOL or worst_h > ATOL:
            raise AssertionError(f"per-step Q/h' beyond {ATOL}: {worst_q:.3e} / {worst_h:.3e}")

    with phase(f"train {RUN_DIR.name}: resume with the AdamW state, {train.N_WARMUPS} warm-ups "
               f"and one full iteration, then {N_WORLDS} test episodes"):
        with torch.enable_grad():
            t0 = time.perf_counter()
            trainer = train.build_trainer(RUN_DIR, DEVICE)
            learner = trainer.learner
            n_updates = trainer.updates_per_iter
            T, B, A = trainer.T, learner.batch_size, trainer.env_params.n_ubs
            print(f"  {trainer.n_worlds} worlds, interleave {trainer.interleave}, "
                  f"{trainer.updates_per_iter} updates per iteration at B={B}, T={T}; ring of "
                  f"{trainer.capacity} chunks; a pool of {len(trainer.pool[0])} layouts (the "
                  f"run's 64k cut to run_fast.py's default); lr {learner.lr} x "
                  f"{learner.lr_scale}; AdamW resumed at step "
                  f"{learner.optimizer.state[learner.parameters()[0]]['step'].item():.0f}",
                  flush=True)
            reset_counts()
            t1 = time.perf_counter()
            warm = [trainer.run_iteration(EPS, warmup=True) for _ in range(train.N_WARMUPS)]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            metrics = trainer.run_iteration(EPS)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            test = trainer.evaluate(N_WORLDS, eps=EPS)
            train_launches = counts()
        losses = trainer.last_losses.tolist()
        print(f"  load {t1 - t0:.2f} s, {train.N_WARMUPS} warm-ups {t2 - t1:.2f} s, iteration "
              f"{t3 - t2:.2f} s (eps {EPS})", flush=True)
        print(f"  warm-up episode stats: {json.dumps(warm)}")
        print(f"  LossQ per update: {json.dumps([round(v, 4) for v in losses])}")
        print(f"  iteration: {json.dumps(metrics)}")
        print(f"  test episodes: {json.dumps({k: float(v.mean()) for k, v in test.items()})}")
        print(f"  launches on the training path: {train_launches}", flush=True)
        if len(losses) != n_updates or not all(np.isfinite(losses)):
            raise AssertionError(f"expected {n_updates} finite LossQ values, got {losses}")
        chunks = (train.N_WARMUPS + 1) * trainer.n_worlds
        if (trainer._size, trainer._ptr) != (chunks, chunks):
            raise AssertionError(f"ring size/ptr {trainer._size}/{trainer._ptr}, expected {chunks}")
        # warm-ups, sub-iterations, test
        policy_steps = (train.N_WARMUPS + trainer.interleave + 1) * T
        per_update = {"flash_gat": 0, "flash_gat_fused": 2 * (2 * T + 1),
                      "tarmac_step": 2 * T + 1, "flash_gat_fused_bwd": 2 * T, "tarmac_step_bwd": T}
        want = {k: n_updates * v for k, v in per_update.items()}
        want["flash_gat_fused"] += 2 * policy_steps
        want["tarmac_step"] += policy_steps
        if train_launches != want:
            raise AssertionError(f"expected {want} launches, got {train_launches}")

    with phase("one update through the kernels against the plain path, then again bit for bit"):
        batch = trainer.sample_batch()
        snap = learner.state_dict()
        names = [f"net.{k}" for k, _ in learner.net.named_parameters()] + \
            [f"mixer.{k}" for k, _ in learner.mixer.named_parameters()]

        def one_update(use_kernels):
            learner.load_state_dict(snap)
            with torch.enable_grad():
                m = learner.backward(batch, use_kernels)
                raw = [p.grad.detach().clone() for p in learner.parameters()]
                learner.apply_grads()
            clipped = [p.grad.detach().clone() for p in learner.parameters()]
            return float(m["LossQ"]), raw, clipped, learner.state_dict()

        before = counts()
        kern = one_update(True)
        launched = {k: v - before[k] for k, v in counts().items()}
        plain_upd = one_update(False)
        again = one_update(True)
        learner.load_state_dict(snap)
        print(f"  launches in one update: {launched}", flush=True)
        if launched != per_update:
            raise AssertionError(f"expected {per_update} launches per update, got {launched}")
        loss_err = abs(kern[0] - plain_upd[0]) / abs(plain_upd[0])
        scale = {g: max(r.abs().max().item() for n, r in zip(names, plain_upd[1])
                        if n.startswith(g)) for g in ("net", "mixer")}
        grad_err = max((k - q).abs().max().item() / scale[n.split(".")[0]]
                       for n, k, q in zip(names, kern[2], plain_upd[2]))
        resolved = {n: r.abs() > RESOLVED_RTOL * scale[n.split(".")[0]]
                    for n, r in zip(names, plain_upd[1])}
        param_err, loose, loose_err, n_entries = 0.0, 0, 0.0, 0
        for mod in ("net", "mixer", "target_net", "target_mixer"):
            for k, v in kern[3][mod].items():
                name = f"{mod.replace('target_', '')}.{k}"
                diff = (v - plain_upd[3][mod][k]).abs()
                param_err = max(param_err, diff[resolved[name]].max().item()
                                if resolved[name].any() else 0.0)
                n_entries += diff.numel()
                if not resolved[name].all():
                    loose += int((~resolved[name]).sum())
                    loose_err = max(loose_err, diff[~resolved[name]].max().item())
        bitwise = kern[0] == again[0] and all(
            torch.equal(a, b) for a, b in zip(kern[2] + kern[1], again[2] + again[1])) and all(
            torch.equal(v, again[3][mod][k]) for mod in ("net", "mixer", "target_net",
                                                         "target_mixer")
            for k, v in kern[3][mod].items())
        print(f"  LossQ kernels {kern[0]:.6f}, plain {plain_upd[0]:.6f} (rel diff {loss_err:.2e},"
              f" limit {UPDATE_LOSS_RTOL}); clipped grads max |diff| / largest raw gradient "
              f"of the group {grad_err:.2e} (limit {UPDATE_GRAD_RTOL}; largest raw gradient "
              f"net {scale['net']:.4g}, mixer {scale['mixer']:.4g}); params and targets max "
              f"|diff| {param_err:.2e} where the gradient is resolved (limit {UPDATE_PARAM_ATOL})"
              f"; repeated kernel update bit-identical: {bitwise}", flush=True)
        print(f"  {loose} of {n_entries} param and target entries have a raw gradient below "
              f"{RESOLVED_RTOL} of their group's largest (roundoff level); there the two "
              f"updates differ by up to {loose_err:.2e}", flush=True)
        if not (loss_err <= UPDATE_LOSS_RTOL and grad_err <= UPDATE_GRAD_RTOL
                and param_err <= UPDATE_PARAM_ATOL and bitwise):
            raise AssertionError("the kernel update disagrees with the plain path or does "
                                 "not repeat bit for bit")

    record = []
    with phase("times"):
        print(f"  card: {card}", flush=True)
        for cname, args in calls:
            fn, plain = kernels[cname]
            ms, plain_ms = time_cuda(lambda: fn(*args)), time_cuda(lambda: plain(*args))
            cost = step_cost(args) if cname == "tarmac_step" else \
                gat_cost(args[0], args[5], args[1].shape[1], args[6])
            bound_ms, bound_by = bound(*cost)
            print(f"  serving {cname} {tuple(args[0].shape)}: {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, bound {bound_ms:.5f} ms ({bound_by}), {100 * bound_ms / ms:.2f} % of "
                  f"the bound's speed", flush=True)
        with torch.enable_grad():
            bwd_calls, update_valid = capture_backward_calls(learner, batch, T // 2)
        learner.load_state_dict(snap)
        step_valid = [float((c[0][5] > 0).float().mean()) for _, c in bwd_calls[:2]]
        print(f"  valid-slot share of the update's flash_gat_fused inputs: 'seen' "
              f"{update_valid[0]:.4f}, 'near' {update_valid[1]:.4f} over every call of "
              f"one update; {step_valid[0]:.4f} and {step_valid[1]:.4f} at policy step "
              f"{T // 2}, the inputs timed below", flush=True)
        timed = {name: [] for name in all_kernels}
        flash_cases = []
        for step in CAPTURE_STEPS:
            for rel, (_, args) in zip(("seen", "near"), dcalls[step]):
                ms = time_cuda(lambda: flash_gat(*args))
                plain_ms = time_cuda(lambda: flash_gat_plain(*args))
                cost = flash_gat_cost(args[0], args[3], args[4])
                bound_ms, bound_by = bound(*cost)
                share = (args[3] > 0).float().mean().item()
                print(f"  4-UBS serving flash_gat, step {step} '{rel}' {tuple(args[0].shape)}, "
                      f"valid share {share:.4f}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{bound_ms:.5f} ms ({bound_by}: {cost[0]:.3e} ops, {cost[1]:.3e} "
                      f"bytes); {disc_launches['flash_gat'] // disc_steps} launches per env "
                      f"step", flush=True)
                timed["flash_gat"].append((ms, plain_ms, bound_ms, bound_by))
                flash_cases.append({"inputs": f"step {step} {rel}", "valid_share": share,
                                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                    "bound_by": bound_by})
        for name, captured in bwd_calls:
            fwd_args = captured[0]
            if name == "flash_gat_fused_bwd":
                out, mstat, lstat = flash_gat_fused(*fwd_args)
                fwd_name, fwd_cost = "flash_gat_fused", gat_cost(fwd_args[0], fwd_args[5],
                                                                 fwd_args[1].shape[1],
                                                                 fwd_args[6])
                bwd_args = fwd_args[:6] + (out, mstat, lstat, captured[1]) + fwd_args[6:] + \
                    (False,)
                bwd_cost = gat_bwd_cost(fwd_args[0], fwd_args[5], fwd_args[1].shape[1],
                                        fwd_args[6], False)
            else:
                fwd_name, fwd_cost = "tarmac_step", step_cost(fwd_args)
                bwd_args = fwd_args[:17] + captured[1:] + fwd_args[17:]
                bwd_cost = step_bwd_cost(fwd_args)
            worst[name] = max(worst[name], rel_err(all_kernels[name][0](*bwd_args),
                                                   all_kernels[name][1](*bwd_args),
                                                   f"{name} on training inputs"))
            for kname, kargs, cost in ((fwd_name, fwd_args, fwd_cost),
                                       (name, bwd_args, bwd_cost)):
                fn, plain = all_kernels[kname]
                ms = time_cuda(lambda: fn(*kargs))
                plain_ms = time_cuda(lambda: plain(*kargs))
                bound_ms, bound_by = bound(*cost)
                print(f"  training {kname} {tuple(kargs[0].shape)}: {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
                      f"{cost[0]:.3e} ops, {cost[1]:.3e} bytes), {100 * bound_ms / ms:.2f} % "
                      f"of the bound's speed", flush=True)
                timed[kname].append((ms, plain_ms, bound_ms, bound_by))
        # tarmac_step_bwd at 512 worlds (R = 4096), random inputs of the training width.
        c = step_case(rng, 512, A, 256, 64, 16, 9)
        big = tuple(c.values()) + (torch.randn((512 * A, 9), device=device),
                                   torch.randn((512 * A, 256), device=device), A, 16, False)
        cost = step_bwd_cost(big)
        big_ms, big_plain_ms = time_cuda(lambda: tarmac_step_bwd(*big)), \
            time_cuda(lambda: tarmac_step_bwd_plain(*big))
        print(f"  tarmac_step_bwd (4096, 256), 512 worlds: {big_ms:.4f} ms, plain "
              f"{big_plain_ms:.4f} ms, bound {bound(*cost)[0]:.5f} ms ({bound(*cost)[1]}: "
              f"{cost[0]:.3e} ops, {cost[1]:.3e} bytes)", flush=True)
        big_fwd = big[:17] + big[19:]
        cost = step_cost(big_fwd)
        big_ms, big_plain_ms = time_cuda(lambda: tarmac_step(*big_fwd)), \
            time_cuda(lambda: tarmac_step_plain(*big_fwd))
        print(f"  tarmac_step (4096, 256), 512 worlds: {big_ms:.4f} ms, plain {big_plain_ms:.4f} "
              f"ms, bound {bound(*cost)[0]:.5f} ms ({bound(*cost)[1]}: {cost[0]:.3e} ops, "
              f"{cost[1]:.3e} bytes), {100 * bound(*cost)[0] / big_ms:.2f} % of the bound's "
              f"speed", flush=True)
        # Each kernel's launches on its main path: flash_gat's the 4-UBS 'pallas'
        # serving, the others' the training path.
        path_launches = dict(train_launches, flash_gat=disc_launches["flash_gat"])
        for name, rows in timed.items():
            record.append({
                "name": name, "route": "cuda",
                "source": f"uav_bs_ctrl_tpu_torch/ops/csrc/{name}.cu",
                "replaces": REPLACES[name], "launches": path_launches[name],
                "max_abs_err": worst[name],
                "ms": statistics.mean(r[0] for r in rows),
                "plain_ms": statistics.mean(r[1] for r in rows),
                "bound_ms": statistics.mean(r[2] for r in rows),
                "bound_by": rows[0][3], "library_ms": None})
            if name == "flash_gat":
                record[-1]["cases"] = flash_cases

        def ms_per_update(use_kernels, n=5):
            learner.load_state_dict(snap)
            with torch.enable_grad():
                learner.update_on_batch(batch, use_kernels)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    learner.update_on_batch(batch, use_kernels)
                torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        upd = {True: [], False: []}
        for use_kernels in (False, True, True, False):
            upd[use_kernels].append(ms_per_update(use_kernels))
        learner.load_state_dict(snap)
        edges = B * (2 * T + 1) * A * (trainer.env_params.n_gts + (A - 1) + A)
        for use_kernels, label in ((True, "kernels"), (False, "plain path")):
            ms = statistics.mean(upd[use_kernels])
            print(f"  one update ({label}): {ms:.2f} ms (runs {upd[use_kernels]}), "
                  f"{1e3 / ms:.2f} updates/s, {edges * 1e3 / ms:.4g} message-passing edges/s "
                  f"({edges} edges per update = B(2T+1)A(M+K+A))", flush=True)
        split_calls = {name: per_update[name] for name in LIBRARY_TAGS}
        cuda_launches = profile_updates(learner, batch, 2, statistics.mean(upd[True]),
                                        split_calls)
        for entry in record:
            if entry["name"] in split_calls:
                entry["cuda_launches_per_call"] = (
                    None if cuda_launches is None
                    else cuda_launches[entry["name"]] / split_calls[entry["name"]])
        learner.load_state_dict(snap)
        obs, h = first
        fwd_ms = time_cuda(lambda: agent(obs, h))
        host = []
        for _ in range(20):
            t0 = time.perf_counter()
            agent(obs, h)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        print(f"  policy forward per env step ({N_WORLDS} worlds): device {fwd_ms:.4f} ms, "
              f"host wall {statistics.median(host):.4f} ms", flush=True)
        first_512 = []

        def dagent_512(obs, h, key):
            if not first_512 and obs["agent"].shape[0] == 512:
                first_512.append((obs, h))
            return dagent(obs, h, key=key)

        batched_ms = {}
        for label, pol, hidden, env, pool, n_steps in (
                ("8-UBS TarMAC, fused kernels", agent, agent.hidden, env_params,
                 serve.test_pool(config["map_id"], 0), steps),
                ("4-UBS DiscreteComm, 'pallas'", dagent_512, dagent.hidden, denv, dpool,
                 disc_steps)):
            for n_worlds in (N_WORLDS, 512):
                generator = torch.Generator().manual_seed(1)
                t0 = time.perf_counter()
                collect.evaluate_policy(env, pol, pool, hidden, generator, n_worlds,
                                        device, EPS)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                batched_ms[label, n_worlds] = dt * 1e3 / n_steps
                print(f"  {label}: {n_worlds} worlds x {n_steps} steps with the policy in the "
                      f"loop: {dt:.3f} s, {n_worlds * n_steps / dt:.1f} env steps/s "
                      f"({n_steps / dt:.2f} batched steps/s)", flush=True)

        def host_ms(fn, n=10):
            """Median host wall ms of ``fn(i)``, the card idle before and after."""
            out = []
            for i in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(i)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(out)

        obs, h = first_512[0]
        a4 = h.shape[1]
        shape = (512, a4, a4, dagent.f_comm.msg_size, 2)      # DiscreteComm's per-edge noise
        pol_ms = host_ms(lambda i: dagent(obs, h, key=i))
        card_noise_ms = host_ms(lambda i: gumbel_noise(shape, i, device))
        host_noise_ms = host_ms(lambda i: (-torch.empty(shape).exponential_(
            generator=torch.Generator().manual_seed(i)).log()).to(device))
        step_ms = batched_ms["4-UBS DiscreteComm, 'pallas'", 512]
        print(f"  4-UBS batched step at 512 worlds, {step_ms:.2f} ms: policy forward "
              f"{pol_ms:.3f} ms host wall (its {math.prod(shape)} Gumbel values drawn on the "
              f"card in {card_noise_ms:.3f} ms; drawn on the host and copied, as before, "
              f"{host_noise_ms:.3f} ms), so about {step_ms - pol_ms:.2f} ms for the env step "
              f"and the exploration draws", flush=True)

    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
