#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``uav_bs_ctrl_tpu_torch``) on one GPU.

Run from anywhere: ``python3 chip_smoke.py``. Phases, each printed with its wall
time: the device; the nvcc build of every kernel (one nvcc per source, in
parallel); the tensor-core (HMMA) instructions that ``cuobjdump -sass`` finds
in every product kernel of the step kernels and every slot-tile kernel of
#2/#3, f32 (3xTF32) and bf16; each of the five kernels against its plain
PyTorch version on the card (#2/#3 at 'seen' shapes, which take the slot tiles,
and at 'near' ones, which take the warp-per-(row, head) body); the device
env's scheduler ``env_schedule`` against its plain version on every step of
recorded rollouts (``env_schedule_phase``: 8-UBS at 40 and 512 worlds,
4-UBS, DenseHotSpotV2, swarm64), its launches held to the env steps taken on
the card there and in serving, ``rollout``, vec_run and the timed
collections; serving the committed exp3 8-UBS TarMAC policy (40 worlds, one 50-step
episode) through the kernels, with every step's Q checked against the plain
path; serving the committed exp3 4-UBS DiscreteComm policy with
``gat_backend='pallas'`` (``flash_gat``), every step's Q checked against the
plain path fed the same Gumbel noise, and ``flash_gat`` checked and timed on
the inputs of steps 0 and 25 (the 'seen' mask is about 1 % valid at the
first, 38 % at the second); the 8-UBS policy served through
``flash_gat`` against its fused-kernel serving; training the 8-UBS run through
``uav_bs_ctrl_tpu_torch.train``'s code path (resumed with its AdamW state, two
warm-ups and one full iteration of 40 updates, then evaluation);
``uav_bs_ctrl_tpu_torch.run_fast.train_fast`` on the same configuration, first a fresh start of two 2000-step epochs (one warm-up
iteration, one of 40 updates; ``progress.txt``, checkpoints and launches
checked), then a resume of the committed run's epoch-200 checkpoint for one
epoch more (AdamW step, LR scale, the appended row, and the written
checkpoint read back bit for bit); one update through the kernels against
the same update on the plain path, and repeated bit for bit; training the
committed exp3 4-UBS DiscreteComm+QMIX run (resumed, two warm-ups and one
40-update iteration through #2 and #3, its kernel update held against the
plain path on the same per-step Gumbel noise) and the committed exp2 r400
TarMAC run (the MLP encoder, the fused step #4 and #5 on a talk graph with
missing edges) the same way; ``run_fast.train_fast`` on exp2 r400
DiscreteComm from a fresh start for one epoch with updates (its checkpoint
read back bit for bit); exp1, the single-UBS DRQN (``exp1_phases``): #2 and
#3 at exp1's shapes (every slot valid), the committed exp1 gnn and rnn runs
served (40 worlds, one 200-step episode; the gnn run's every step against the
plain path), the gnn run resumed with two warm-ups and one update gated
against the plain path, ``run_fast.train_fast_exp1`` resumed from the gnn
run's epoch 50 for one epoch and started fresh with the rnn agent; the
classic host loop (``host_loop_phases``): ``test_policies.test_series`` over
the committed exp1 2 x 5 gnn run and the 4-UBS TarMAC+QMIX run (4 episodes
each, ms per host step split into act and env, the launches counted, every
step's Q and h' held against the plain path, the rows set beside the
committed summaries), ``run_classic``'s exp3 preset on the 4-UBS TarMAC+QMIX
configuration for one 2000-step epoch (one update gated against the plain
path and repeated bit for bit, its checkpoint read back by ``test_series``)
and a one-variant ``ExperimentGrid`` through the pickled-thunk subprocess;
the bench workload (``bench_phases``): ``bench.py``'s flagship update on its
synthetic replay, at f32 and bf16 under the ``per_step``, ``hoisted`` and
``merged`` schedules (gates at B = 32: f32 kernel updates against the plain
path and the schedules against each other; bf16 kernel updates against an
f64 plain-path referee, f32 masters, a bit-identical repeat, bf16 launches
only; times at B = 256 with each bf16 kernel against its f64 referee and
beside the f32 one; one fresh bf16 ``run_fast.train_fast`` epoch); slice 13
(``slice13_phases``): ``vec_run.train_vectorized`` at the 8-UBS run's
width (32 worlds, two 1,600-step chunks, 64 updates at B = 32 through
#2-#5, one gated against the plain path, the checkpoint read by the classic
learner), ``torch_env.reset``/``rollout`` of the 8-UBS policy on 512 worlds
against ``eval_rollout``, the C++ env core in ``test_series`` (the
committed rows reproduced; host env ms with the core and with NumPy), and
``ops/segment.py`` on the card against the CPU on one update's 1,680,640
edges; slice 14, the parallel layer (``parallel_phases``), ranks spawned on
the one card over gloo: ``graft_entry.dryrun_multichip(4)`` (dp = 2, mp = 2,
the toy and flagship cases against single-rank updates), a gp = 2 flagship
step, the dp = 2 fused trainer against the single-rank one and a dp = 2
update of the committed checkpoint through the update gates, with each
rank's launches, ms per sharded update and collectives' share; the mp
compute split (``mp_split_phases``): the column-split #4/#5 against their
plain versions and, at the whole columns, #4/#5 bit for bit, #2/#3 at a
rank's heads, the split entry points timed, and one update of the committed
checkpoint on dims (1, mp, 1) for mp = 1, 2, 4 at f32 and bf16 (ranks on the
one card over gloo) against the single rank's and the f64 referee's, with
each rank's busy ms, launches, heads and GRU columns and collectives; the
programs (``graph_phases``, ``program_phases``): each CUDA graph path
against its eager twin bit for bit, its launches counted on the card (the
8-UBS update, the fused iteration, ``serve.evaluate``, the 4-UBS
DiscreteComm trainer; exp1's fused iteration resumed at full width, both
exp1 runs served, a ``vec_run`` chunk and ``torch_env.rollout`` at 512
worlds; the host loop's ``act`` in ``host_loop_phases``, whose ``test_series``
summaries also equal the committed ``data/test_*`` rows of the exp1, 4-UBS
and 8-UBS runs); and timings (``exp1_times`` adds exp1's kernels, updates
and collection; ``bf16_table_cells`` the bf16 'near' #2/#3 and R = 4,096
#4/#5 cells).
Any failed phase exits non-zero with no result line. The last line is the
JSON device record.
"""

import collections
import contextlib
import faulthandler
import functools
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WATCHDOG_S = 1100          # a hung phase ends the run before the 1200 s the smoke is given
ATOL = RTOL = 1e-4        # f32 kernel vs plain version, full width
F32_PEAK_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores (data sheet)
BF16_PEAK_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense (data sheet)
TF32_PEAK_FLOPS = 495e12  # H100 SXM tf32 on the tensor cores, dense (data sheet)
F32_MMA_PEAK_FLOPS = TF32_PEAK_FLOPS / 3  # f32-accurate products there: 3xTF32's three passes
HBM_BYTES_PER_S = 3.35e12
RUN_DIR = ROOT / "data" / "exp3_fast_8ubs_tarmac_qmix_il10_lay64k" / \
    "exp3_fast_8ubs_tarmac_qmix_il10_lay64k_s0"
DISC_DIR = ROOT / "data" / "exp3_fast_4ubs_disc_lay64k" / "exp3_fast_4ubs_disc_lay64k_s0"
DISC_QMIX_DIR = ROOT / "data" / "exp3_fast_4ubs_disc_qmix_lay64k" / \
    "exp3_fast_4ubs_disc_qmix_lay64k_s0"
EXP2_DIR = ROOT / "data" / "exp2_fast_r400_tarmac" / "exp2_fast_r400_tarmac_s0"
EXP1_GNN_DIR = ROOT / "data" / "exp1_fast_grp4_size5_gnn" / "exp1_fast_grp4_size5_gnn_s0"
EXP1_RNN_DIR = ROOT / "data" / "exp1_fast_grp4_size5_rnn" / "exp1_fast_grp4_size5_rnn_s0"
EXP1_EPOCH = 50           # the committed exp1 checkpoints' epoch
HOST_EXP1_DIR = ROOT / "data" / "exp1_fast_grp2_size5_gnn" / "exp1_fast_grp2_size5_gnn_s10"
HOST_4UBS_DIR = ROOT / "data" / "exp3_fast_4ubs_tarmac_qmix" / "exp3_fast_4ubs_tarmac_qmix_s0"
HOST_EPISODES = 4         # test_policies episodes per run on the card
CLASSIC_STEPS = 2000      # run_classic's one epoch: updates from B T = 1600 steps, every T
N_WORLDS = 40             # the run's n_worlds
EPS = 0.05                # evaluate_policy's test epsilon
DEVICE = "cuda"
REPLACES = {"flash_gat": "uav_bs_ctrl_tpu/ops/pallas_kernels.py:138",
            "flash_gat_fused": "uav_bs_ctrl_tpu/ops/pallas_kernels.py:329",
            "flash_gat_fused_bwd": "uav_bs_ctrl_tpu/ops/pallas_kernels.py:623",
            "tarmac_step": "uav_bs_ctrl_tpu/ops/step_kernels.py:314",
            "tarmac_step_bwd": "uav_bs_ctrl_tpu/ops/step_kernels.py:379",
            "env_schedule": "no pallas_call: the fori_loop over the GTs, "
                            "uav_bs_ctrl_tpu/envs/jax_env.py:184"}
SPLIT_KERNELS = {"tarmac_step_cols": "tarmac_step", "tarmac_step_head": "tarmac_step",
                 "tarmac_step_bwd_cols": "tarmac_step_bwd",      # the column split of #4/#5,
                 "tarmac_step_bwd_rest": "tarmac_step_bwd"}      # by the kernel each splits
MP_SPLITS = (2, 4)        # the mp phases' meshes (1, mp, 1), beside the single rank (mp = 1)
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
GAT_TIE = 1e-5            # a GATv2 pre-activation |z| this small takes LeakyReLU's slope 1 or
                          # 0.2 by roundoff: the der entries it feeds are reported, not held
TIE = 1e-4                # a Gumbel margin |z0 - z1| this small rounds either way: a roundoff
                          # tie, where the plain path's bit may follow the kernel path's
VEC_WORLDS = 32           # slice 13's vec_run phase: 32 worlds x T = 50, 1,600 env steps a chunk
VEC_CUTS = dict(steps_per_epoch=3200, epochs=1, replay_size=64, num_test_episodes=5)
ROLLOUT_WORLDS = 512      # torch_env.reset / rollout worlds
ROLLOUT_ATOL = 1e-5       # rollout against eval_rollout: rewards and returns
SEGMENT_RTOL = 1e-5       # ops/segment.py on the card against the CPU: of max |cpu|; the
                          # card's index_add_ sums in no fixed order
SEGMENT_ONEHOT_DST = 512  # the one-hot backend ([E, N] product) on the edges into 512 destinations
UPDATE_EDGES = 1_680_640  # bench.py:64's edges of an update at B = 32, T = 50, A = 8, M = 50, K = 7
# Slice 14's dp = 2 fused trainer: the 8-UBS run's width cut to 8 worlds, a 16-chunk ring, one
# warm-up and one iteration of 2 updates in 2 sub-iterations; held to the single-rank trainer:
# LossQ and episode stats rtol, params atol + rtol (tests/test_parallel.py:388-421) where the
# raw gradient was resolved in every update (RESOLVED_RTOL, as check_update).
PARALLEL_FUSED = dict(n_worlds=8, capacity_chunks=16, updates_per_iter=2, interleave=2,
                      n_layouts=16)
PARALLEL_RTOL, PARALLEL_ATOL, PARALLEL_PARAMS_RTOL = 1e-5, 2e-5, 1e-3
# The dp = 2 programs beside their eager twins: the updates timed a rank (their median), and
# one more iteration of each trainer timed after its results are taken.
PARALLEL_TIMED = 5
# env_schedule against the scatter body: (map, worlds) of each recorded rollout, and its steps
# where not the map's episode (swarm64's plain body makes some two dozen launches a GT, 800 GTs).
ENV_SHAPES = (("8ubs", N_WORLDS), ("8ubs", 512), ("4ubs", N_WORLDS), ("hotspot_v2", N_WORLDS),
              ("swarm64", 4))
ENV_STEPS = {"hotspot_v2": 50, "swarm64": 3}


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


def body_of(m, hf=256, heads=4):
    """The body #2/#3 take for rows of ``m`` slots at ``heads`` heads of ``hf``
    columns in all, as their library routes them."""
    from uav_bs_ctrl_tpu_torch.ops import build, gat_kernels
    lib = build.load("flash_gat_fused", gat_kernels._SIGNATURES)
    return ("slot tiles" if lib.flash_gat_fused_uses_tiles(m, hf, heads)
            else "warp-per-(row, head) body")


def gat_peak(dtype):
    """The peak FLOP/s of a GATv2 kernel's (#2, #3) operations: their
    projections run on the tensor cores, as the step kernels' products do, so
    ``step_peak``'s rates (bf16's, and 3xTF32's at f32); the operations beside
    the projections are counted at that rate too, so the bound stays one that
    the kernel cannot beat."""
    return step_peak(dtype)


def gat_cost(args):
    """(operations, bytes, peak FLOP/s) one flash_gat_fused call on ``args``
    needs: per valid slot the projection 2*D*HF, bias, +er, LeakyReLU, score
    2*HF and aggregation 2*HF, plus 3 per head for the softmax; each input read
    once, each output written once, in the operands' storage type (the row
    statistics in f32)."""
    x, mask, hf, heads = args[0], args[5], args[1].shape[1], args[6]
    n, m, d = x.shape
    valid = float((mask > 0).sum())
    ops = valid * (hf * (2 * d + 7) + 3 * heads) + n * hf
    nbytes = x.element_size() * (x.numel() + mask.numel() + 2 * n * hf + d * hf + 2 * hf) \
        + 4 * 2 * n * heads
    return ops, nbytes, gat_peak(x.dtype)


def flash_gat_cost(el, mask, heads):
    """(operations, bytes, peak FLOP/s) one flash_gat call (f32 only) needs: per valid slot +er,
    LeakyReLU (2), x attn, the score sum and the weighted sum (2), about 7*HF,
    plus 3 per head for the softmax, and a divide per output. Bytes: the mask,
    er and attn read once, the output written once, and of el only the valid
    slots' rows (a masked slot's contiguous HF-row does not reach the output)."""
    n, m, hf = el.shape
    valid = float((mask > 0).sum())
    ops = valid * (7 * hf + 3 * heads) + n * hf
    nbytes = 4 * (valid * hf + mask.numel() + 2 * n * hf + hf)
    return ops, nbytes, F32_PEAK_FLOPS


def step_peak(dtype):
    """The peak FLOP/s of a step kernel's operations: its products run on the
    tensor cores, in bf16 or, at f32, as 3xTF32 (three tf32 passes, the least
    the card takes for f32-accurate products). The gates, softmax and sums
    outside the products are counted at that rate too, faster than the CUDA
    cores', so the bound stays one that the kernel cannot beat."""
    return BF16_PEAK_FLOPS if dtype == torch.bfloat16 else F32_MMA_PEAK_FLOPS


def step_cost(args):
    """(operations, bytes, peak FLOP/s) one tarmac_step call needs: the v/s/q
    projections, scores, softmax and aggregation over the valid edges, the
    GRU's two products and gates, and the head."""
    x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo, wvh, bvh = args[:17]
    dueling = args[19]
    rows, hid = x.shape
    msg, key, n_act = wv.shape[1], ws.shape[1], wo.shape[1]
    edges = float((adjf > 0).sum())
    ops = (rows * 2 * 2 * hid * (msg + 2 * key) + edges * (2 * key + 3 + 2 * msg)
           + rows * 2 * ((hid + msg) * 3 * hid + hid * 3 * hid) + rows * hid * 10
           + rows * 2 * hid * (n_act + (1 if dueling else 0)))
    read = args[:15] + ((wvh, bvh) if dueling else ())
    nbytes = x.element_size() * (sum(t.numel() for t in read) + rows * (n_act + hid))
    return ops, nbytes, step_peak(x.dtype)


def gat_bwd_cost(args):
    """(operations, bytes, peak FLOP/s) one flash_gat_fused_bwd call on
    ``args`` needs: per valid slot
    the recompute of el, z, LeakyReLU and the score (2*D*HF + 5*HF), d_alpha
    (2*HF), d_s, d_z and d_el (5*HF), the der/dattn/db sums (4*HF) and dW
    (2*D*HF), plus 4 per head for alpha; dx adds 2*D*HF per slot. Each input
    (x, mask, w, b, er, attn, g, out, m, l) read once, each output written once."""
    x, mask, hf, heads, need_dx = args[0], args[5], args[1].shape[1], args[10], args[12]
    n, m, d = x.shape
    valid = float((mask > 0).sum())
    ops = valid * (hf * (4 * d + 16 + (2 * d if need_dx else 0)) + 4 * heads) + 2 * n * hf
    nbytes = x.element_size() * (x.numel() + mask.numel() + 3 * n * hf + 2 * d * hf + 2 * hf
                                 + n * hf + d * hf + 2 * hf + (x.numel() if need_dx else 0)) \
        + 4 * 2 * n * heads
    return ops, nbytes, gat_peak(x.dtype)


def step_bwd_cost(args):
    """(operations, bytes, peak FLOP/s) one tarmac_step_bwd call needs: the forward
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
    nbytes = x.element_size() * (2 * sum(t.numel() for t in weights) + x.numel() + h.numel()
                                 + adjf.numel() + rows * (n_act + hid) + 2 * rows * hid)
    return recompute + backward + weight_grads, nbytes, step_peak(x.dtype)


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


def bound(ops, nbytes, peak):
    """The least ms the card could take: the larger of the bytes over HBM's rate
    and the operations over ``peak``, the rate a cost function gives for its
    kernel's work (``gat_peak``, ``step_peak``)."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_case(what, inputs, fn, plain, args, cost, **timing):
    """Times ``fn(*args)`` and, unless ``plain`` is None, ``plain(*args)``
    (``time_cuda(..., **timing)``), prints both beside the bound of ``cost``
    under ``what`` and returns the case ``{"inputs", "ms", "plain_ms",
    "bound_ms", "bound_by"}``."""
    ms = time_cuda(lambda: fn(*args), **timing)
    plain_ms = None if plain is None else time_cuda(lambda: plain(*args), **timing)
    bound_ms, bound_by = bound(*cost)
    plain_txt = "not measured" if plain_ms is None else f"{plain_ms:.4f} ms"
    print(f"  {what}: {ms:.4f} ms, plain {plain_txt}, bound {bound_ms:.6f} ms ({bound_by}: "
          f"{cost[0]:.3e} ops, {cost[1]:.3e} bytes), {100 * bound_ms / ms:.2f} % of the "
          f"bound's speed", flush=True)
    return dict(inputs=inputs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


HMMA_KERNELS = {"tarmac_step": "step_products",                 # a word in the name of each
                "tarmac_step_bwd": "step_products",             # library's kernels whose
                "flash_gat_fused": "flash_gat_fused_fwd_tiles",  # products run on the
                "flash_gat_fused_bwd": "flash_gat_fused_bwd_tiles"}   # tensor cores


def hmma_counts(libraries, cuda_bin):
    """{library: {"bf16": [kernels, HMMA instructions, kernels without one],
    "f32": [...]}}: the HMMA (tensor-core) instructions in each built
    library's product kernels (``HMMA_KERNELS``: the step kernels'
    step_products, #2/#3's slot tiles), by storage type, from ``cuobjdump
    -sass`` (beside nvcc in ``cuda_bin``, else on PATH; raises without it). A
    bf16 kernel's name holds ``__nv_bfloat16``."""
    tool = Path(cuda_bin) / "cuobjdump"
    if not tool.is_file():
        found = shutil.which("cuobjdump")
        if found is None:
            raise RuntimeError(f"cuobjdump is neither in {cuda_bin} nor on PATH")
        tool = Path(found)
    counts = {}
    for name, path in libraries.items():
        sass = subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        found = {"bf16": [0, 0, 0], "f32": [0, 0, 0]}
        for block in sass.split("Function : ")[1:]:
            fn = block.split(None, 1)[0]
            if HMMA_KERNELS[name] not in fn:
                continue
            kind = found["bf16" if "__nv_bfloat16" in fn else "f32"]
            hmma = sum(1 for line in block.splitlines() if "HMMA" in line)
            kind[0] += 1
            kind[1] += hmma
            kind[2] += hmma == 0
        if not found["bf16"][0] or not found["f32"][0]:
            raise AssertionError(f"{name}: no {HMMA_KERNELS[name]} kernel of one type in the "
                                 f"SASS ({found})")
        counts[name] = found
    return counts


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
    """DiscreteComm's sample, for two paths on the same noise (kernel path,
    then plain path): where the two paths' hard bits differ, the plain path's
    Gumbel margin |z0 - z1| must be within ``TIE`` (logits an f32 roundoff
    apart round the sample either way) and the plain path then takes the
    kernel path's bit (with its own straight-through gradient); a wider
    difference raises. The kernel path's samples queue up in call order and
    the plain path's take them in turn: a sample follows when ``ties["follow"]``
    is set, or, without that key, when a kernel sample waits (a policy called
    twice per step). ``ties`` counts such bits and keeps the smallest margin
    seen."""
    from uav_bs_ctrl_tpu_torch.models import comm
    from uav_bs_ctrl_tpu_torch.models.modules import gumbel_noise, gumbel_softmax
    first = collections.deque()

    def sample(logits, tau=1.0, hard=False, seed=None, noise=None):
        if noise is None:
            noise = gumbel_noise(logits.shape, seed, logits.device)
        z = logits + noise
        bits = gumbel_softmax(logits, tau, hard, noise=noise)
        margin = (z[..., 0] - z[..., 1]).abs()
        ties["min_margin"] = min(ties["min_margin"], margin.min().item())
        if not ties.get("follow", bool(first)):
            first.append(bits.detach())
            return bits
        bits_k = first.popleft()
        differ = (bits != bits_k).any(-1)
        wide = (differ & (margin > TIE)).sum().item()
        if wide:
            raise AssertionError(f"{wide} DiscreteComm bits differ between the kernel and "
                                 f"the plain path at Gumbel margins beyond {TIE}")
        ties["bits"] += int(differ.sum())
        if not bits.requires_grad:
            return torch.where(differ[..., None], bits_k, bits)
        return bits + torch.where(differ[..., None], bits_k - bits.detach(),
                                  torch.zeros_like(bits))

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


# The CUDA kernel that each call of a wrapper launches exactly once, by function name: a
# call of #1-#3 runs the row or the tile body, #4 ends in its head, #5 in its finish, and
# env_schedule is one kernel.
CALL_MARKS = {"flash_gat": ("flash_gat_rows",),
              "flash_gat_fused": ("flash_gat_fused_fwd_rows", "flash_gat_fused_fwd_tiles"),
              "flash_gat_fused_bwd": ("flash_gat_fused_bwd_rows", "flash_gat_fused_bwd_tiles"),
              "tarmac_step": ("tarmac_step_fwd_head",),
              "tarmac_step_bwd": ("tarmac_step_bwd_finish",),
              "env_schedule": ("schedule_kernel",)}


def wrapper_counts():
    """``({name: launches}, {name: bf16 launches})`` of every wrapper in ``CALL_MARKS``."""
    from uav_bs_ctrl_tpu_torch.ops import env_kernels, gat_kernels, step_kernels
    fns = {name: getattr(gat_kernels, name, None) or getattr(step_kernels, name, None)
           for name in CALL_MARKS if name != "env_schedule"}
    fns["env_schedule"] = env_kernels.schedule_and_rate
    return ({k: fn.launches for k, fn in fns.items()},
            {k: getattr(fn, "launches_bf16", 0) for k, fn in fns.items()})


def trace_padding(n=64):
    """Kernels of no wrapper at a trace's ends, then a pause: the profiler can
    miss the first kernel events of a trace (the smoke saw a window that
    began with #2 lose two of its calls)."""
    pad = torch.zeros(1, device=DEVICE)
    for _ in range(n):
        pad.add_(1)
    torch.cuda.synchronize()
    time.sleep(0.05)


_REPLAY_CALLS = weakref.WeakKeyDictionary()    # a captured graph -> the calls of a replay


def replay_calls(graph, replay):
    """Replay ``graph`` (by ``replay``) under the profiler and return
    ``({name: calls}, {name: bf16 calls})`` of ``CALL_MARKS``' kernels in the
    replay's CUDA kernel events: each wrapper call launches its mark once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    marks = {m: name for name, ms in CALL_MARKS.items() for m in ms}
    calls, calls16 = collections.Counter(), collections.Counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace_padding()
        replay(graph)
        torch.cuda.synchronize()
        trace_padding()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        label = kernel_label(e.name())
        name = marks.get(label.split("<")[0])
        if name is not None:
            calls[name] += 1
            calls16[name] += "bfloat16" in label
    return calls, calls16


@contextlib.contextmanager
def card_launches():
    """The calls of each kernel that ran on the card inside the block: the
    wrappers' launches (the eager path's, and each program's first call,
    which runs eagerly) and, for every replay of a captured graph, the calls
    in that graph. A replay passes no wrapper, so a graph's calls are counted
    in the profiler's CUDA kernel events of its first replay in any block
    (``replay_calls``; a graph replays the same kernels every time), and each
    replay adds them. Yields a namespace whose ``calls`` and ``calls_bf16``
    (#1-#5, ``{name: n}``) and ``env`` (env_schedule's calls) are set when
    the block ends."""
    seen = SimpleNamespace(calls=None, calls_bf16=None, env=None)
    replayed, replayed16 = collections.Counter(), collections.Counter()
    replay = torch.cuda.CUDAGraph.replay

    def counted(graph):
        if graph in _REPLAY_CALLS:
            replay(graph)
        else:
            _REPLAY_CALLS[graph] = replay_calls(graph, replay)
        replayed.update(_REPLAY_CALLS[graph][0])
        replayed16.update(_REPLAY_CALLS[graph][1])

    before = wrapper_counts()
    torch.cuda.CUDAGraph.replay = counted
    try:
        yield seen
    finally:
        torch.cuda.CUDAGraph.replay = replay
    after = wrapper_counts()
    calls = {k: after[0][k] - before[0][k] + replayed[k] for k in CALL_MARKS}
    calls16 = {k: after[1][k] - before[1][k] + replayed16[k] for k in CALL_MARKS}
    seen.env = calls.pop("env_schedule")
    calls16.pop("env_schedule")
    seen.calls, seen.calls_bf16 = calls, calls16


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


def progress_rows(run_dir):
    """``(header, rows)`` of a run's ``progress.txt``, each row a dict of strings."""
    lines = (Path(run_dir) / "progress.txt").read_text().splitlines()
    head = lines[0].split("\t")
    return head, [dict(zip(head, line.split("\t"))) for line in lines[1:]]


def training_log_test_stats(run_dir, epoch):
    for row in progress_rows(run_dir)[1]:
        if int(float(row["Epoch"])) == epoch:
            return {k: float(v) for k, v in row.items()
                    if k in ("AverageTestEpRet", "StdTestEpRet", "TestFairIdx",
                             "TestAvgGlobalUtility",
                             "TestTotalThroughput", "TestProbCollision")}
    return {}


def learner_bits_equal(a, b):
    """Whether two learners hold the same params and AdamW state, bit for bit."""
    pairs = list(zip(a.parameters(), b.parameters()))
    return len(a.parameters()) == len(b.parameters()) and all(
        torch.equal(p, q) and a.optimizer.state[p].keys() == b.optimizer.state[q].keys()
        and all(torch.equal(a.optimizer.state[p][k], b.optimizer.state[q][k])
                for k in a.optimizer.state[p]) for p, q in pairs)


def check_update(learner, batch, per_update, counts, noise=None):
    """One update of ``learner`` on ``batch`` through the kernels, held against
    the same update on the plain path, then again through the kernels, bit
    for bit; ``per_update``, the launches one update must make (``counts()``
    reads them). With ``noise`` (DiscreteComm's per-step Gumbel noise) both
    paths get the same draws, and a hard bit the two paths round apart at a
    roundoff tie is the kernel path's (``same_bits_at_ties``). The gates:
    LossQ ``UPDATE_LOSS_RTOL`` relative, clipped gradients ``UPDATE_GRAD_RTOL``
    of the group's largest raw gradient, params and targets
    ``UPDATE_PARAM_ATOL`` where the gradient is resolved. The learner is left
    as it was."""
    snap = learner.state_dict()
    groups = ("net",) if learner.mixer is None else ("net", "mixer")
    names = [f"{g}.{k}" for g in groups for k, _ in getattr(learner, g).named_parameters()]
    mods = groups + tuple(f"target_{g}" for g in groups)

    def one_update(use_kernels):
        learner.load_state_dict(snap)
        with torch.enable_grad():
            m = learner.backward(batch, use_kernels, noise)
            raw = [p.grad.detach().clone() for p in learner.parameters()]
            learner.apply_grads()
        clipped = [p.grad.detach().clone() for p in learner.parameters()]
        return float(m["LossQ"]), raw, clipped, learner.state_dict()

    ties = {"bits": 0, "min_margin": float("inf")}
    with same_bits_at_ties(ties) if noise is not None else contextlib.nullcontext():
        ties["follow"] = False
        before = counts()
        kern = one_update(True)
        launched = {k: v - before[k] for k, v in counts().items()}
        ties["follow"] = True
        plain_upd = one_update(False)
    again = one_update(True)
    learner.load_state_dict(snap)
    print(f"  launches in one update: {launched}", flush=True)
    if launched != per_update:
        raise AssertionError(f"expected {per_update} launches per update, got {launched}")
    if noise is not None:
        samples = noise["pol"][..., 0].numel() + noise["targ"][..., 0].numel()
        print(f"  DiscreteComm bits taken from the kernel path at roundoff ties: {ties['bits']} "
              f"of {samples} (smallest Gumbel margin {ties['min_margin']:.2e}, tie bound "
              f"{TIE})", flush=True)
    loss_err, grad_err, param_err, loose, loose_err, n_entries, scale = update_gate_errors(
        kern, plain_upd, names, groups)
    bitwise = kern[0] == again[0] and all(
        torch.equal(a, b) for a, b in zip(kern[2] + kern[1], again[2] + again[1])) and all(
        torch.equal(v, again[3][mod][k]) for mod in mods for k, v in kern[3][mod].items())
    largest = ", ".join(f"{g} {scale[g]:.4g}" for g in groups)
    print(f"  LossQ kernels {kern[0]:.6f}, plain {plain_upd[0]:.6f} (rel diff {loss_err:.2e},"
          f" limit {UPDATE_LOSS_RTOL}); clipped grads max |diff| / largest raw gradient "
          f"of the group {grad_err:.2e} (limit {UPDATE_GRAD_RTOL}; largest raw gradient "
          f"{largest}); params and targets max |diff| {param_err:.2e} where the gradient "
          f"is resolved (limit {UPDATE_PARAM_ATOL}); repeated kernel update bit-identical: "
          f"{bitwise}", flush=True)
    print(f"  {loose} of {n_entries} param and target entries have a raw gradient below "
          f"{RESOLVED_RTOL} of their group's largest (roundoff level); there the two "
          f"updates differ by up to {loose_err:.2e}", flush=True)
    if not (math.isfinite(kern[0]) and loss_err <= UPDATE_LOSS_RTOL
            and grad_err <= UPDATE_GRAD_RTOL and param_err <= UPDATE_PARAM_ATOL and bitwise):
        raise AssertionError("the kernel update disagrees with the plain path or does "
                             "not repeat bit for bit")


def update_gate_errors(got, ref, names, groups):
    """:func:`check_update`'s gate figures of the update ``got`` against
    ``ref``, each ``(LossQ, raw grads, clipped grads, state)`` (grads listed
    as ``names``, ``"<group>.<param>"``; state ``{module: {param: tensor}}``
    for each group and its ``target_`` twin): the LossQ relative error, the
    clipped grads' max |diff| over the group's largest raw gradient, the
    params' and targets' max |diff| where the raw gradient is resolved, the
    unresolved entries, their max |diff|, all entries, and the scales."""
    loss_err = abs(got[0] - ref[0]) / abs(ref[0])
    scale = {g: max(r.abs().max().item() for n, r in zip(names, ref[1])
                    if n.startswith(g + ".")) for g in groups}
    grad_err = max((k - q).abs().max().item() / scale[n.split(".")[0]]
                   for n, k, q in zip(names, got[2], ref[2]))
    resolved = {n: r.abs() > RESOLVED_RTOL * scale[n.split(".")[0]]
                for n, r in zip(names, ref[1])}
    param_err, loose, loose_err, n_entries = 0.0, 0, 0.0, 0
    for mod in groups + tuple(f"target_{g}" for g in groups):
        for k, v in got[3][mod].items():
            name = f"{mod.replace('target_', '')}.{k}"
            diff = (v - ref[3][mod][k]).abs()
            param_err = max(param_err, diff[resolved[name]].max().item()
                            if resolved[name].any() else 0.0)
            n_entries += diff.numel()
            if not resolved[name].all():
                loose += int((~resolved[name]).sum())
                loose_err = max(loose_err, diff[~resolved[name]].max().item())
    return loss_err, grad_err, param_err, loose, loose_err, n_entries, scale


def ms_per_update(learner, batch, use_kernels=True, noise=None, n=5):
    """Wall ms of one update on ``batch`` (after one untimed), the learner
    restored after."""
    snap = learner.state_dict()
    with torch.enable_grad():
        learner.update_on_batch(batch, use_kernels, noise)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            learner.update_on_batch(batch, use_kernels, noise)
        torch.cuda.synchronize()
    learner.load_state_dict(snap)
    return (time.perf_counter() - t0) * 1e3 / n


# bench.py's flagship update (TRAIN_KW, :65-83; setup_learner, :101-130), its own copy.
BENCH_A, BENCH_M, BENCH_K, BENCH_NF_GT, BENCH_NF_UBS = 8, 50, 7, 5, 3
BENCH_HID, BENCH_HEADS, BENCH_MSG, BENCH_KEY, BENCH_N_ACT = 256, 4, 64, 16, 9
BENCH_T, BENCH_B, BENCH_GATE_B = 50, 256, 32
BENCH_STATE = BENCH_A * 2 + BENCH_M * 4
BENCH_SCHEDULES = ("per_step", "hoisted", "merged")
BF16_TOL = 2e-2           # a bf16 kernel or update vs its f64 referee: of max(1, max |referee|)
LEAF_FLOOR = 1e-3         # a bf16 gradient leaf's own scale: at least this share of the largest
LEAF_RATIO = 2.0          # a leaf on its own scale: the kernel path's error at most this times
                          # the plain bf16 path's, + BF16_TOL (bf16 leaves deep in the chain
                          # are off by up to about 0.3 of their own scale, a zero one by 1)


def bench_train_kw(batch_size, compute_dtype, bptt_encoder):
    """``bench.py``'s ``TRAIN_KW`` at ``batch_size`` (its B is 256)."""
    return dict(o="gnn", c="tarmac", hidden_size=BENCH_HID, msg_size=BENCH_MSG,
                key_size=BENCH_KEY, n_heads=BENCH_HEADS, n_layers=2, batch_size=batch_size,
                max_seq_len=BENCH_T, double_q=True, dueling=True,
                replay_size=max(64, batch_size), compute_dtype=compute_dtype,
                gat_backend="pallas_fused_mxu", bptt_encoder=bptt_encoder, step_backend="xla")


def bench_learner(batch_size, compute_dtype, bptt_encoder):
    from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
    from uav_bs_ctrl_tpu_torch.config import make_args
    env_info = dict(obs_shape=dict(agent=2, gt=BENCH_NF_GT - 1, ubs=BENCH_NF_UBS - 1),
                    state_shape=BENCH_STATE, n_actions=BENCH_N_ACT, n_agents=BENCH_A,
                    episode_limit=BENCH_T)
    return MultiAgentQLearner(env_info, make_args(bench_train_kw(batch_size, compute_dtype,
                                                                 bptt_encoder), DEVICE), seed=0)


def bench_synth_obs(rng):
    a, m, k = BENCH_A, BENCH_M, BENCH_K
    return {
        "agent": rng.normal(size=(a, 2)).astype(np.float32),
        "gt": np.concatenate([(rng.random((a, m, 1)) > 0.3).astype(np.float32),
                              rng.normal(size=(a, m, BENCH_NF_GT - 1)).astype(np.float32)], -1),
        "ubs": np.concatenate([(rng.random((a, k, 1)) > 0.3).astype(np.float32),
                               rng.normal(size=(a, k, BENCH_NF_UBS - 1)).astype(np.float32)], -1),
        "adj": np.ones((a, a), dtype=bool),
    }


def bench_replay(learner):
    """``bench.py:setup_learner``'s synthetic replay, drawn in its order from
    ``np.random.default_rng(0)``: B sequences of T transitions."""
    rng = np.random.default_rng(0)
    for _ in range(BENCH_B):
        for t in range(BENCH_T):
            learner.cache(
                obs=bench_synth_obs(rng), h=rng.normal(size=(BENCH_A, BENCH_HID)).astype(np.float32),
                state=rng.normal(size=(BENCH_STATE,)).astype(np.float32),
                act=rng.integers(BENCH_N_ACT, size=BENCH_A),
                rew=rng.normal(size=BENCH_A).astype(np.float32),
                next_obs=bench_synth_obs(rng),
                next_h=rng.normal(size=(BENCH_A, BENCH_HID)).astype(np.float32),
                next_state=rng.normal(size=(BENCH_STATE,)).astype(np.float32),
                done=float(t == BENCH_T - 1), bad_mask=float(t == BENCH_T - 1))


def bench_per_update(bptt_encoder):
    """Wrapper calls of one bench update: #2 twice a step of both unrolls and
    #3 twice a backward step (per_step, merged), or once per relation and net
    (hoisted); #4 every step, #5 every backward step."""
    T = BENCH_T
    gat = (4, 2) if bptt_encoder == "hoisted" else (2 * (2 * T + 1), 2 * T)
    return {"flash_gat": 0, "flash_gat_fused": gat[0], "flash_gat_fused_bwd": gat[1],
            "tarmac_step": 2 * T + 1, "tarmac_step_bwd": T}


def referee_learner(learner):
    """The f64 referee of a bf16 learner: the same learner with its nets'
    params rounded to bf16 and every module in f64, computing in f64 on the
    plain path (``use_kernels=False``)."""
    ref = bench_learner(BENCH_GATE_B, "float32", learner.bptt_encoder)
    ref.load_state_dict(learner.state_dict())
    for net in (ref.net, ref.target_net):
        for p in net.parameters():
            p.data = p.data.to(torch.bfloat16).double()
    for mod in (ref.mixer, ref.target_mixer):
        if mod is not None:
            mod.double()
    ref.compute_dtype = torch.float64
    return ref


def referee_batch(batch):
    """The referee's batch: obs and h rounded to bf16 (as the bf16 update
    casts them), every floating leaf in f64."""
    def cast(key, v):
        if not v.is_floating_point():
            return v
        return (v.to(torch.bfloat16) if key in ("obs", "h") else v).double()
    return {k: ({kk: cast("obs", vv) for kk, vv in v.items()} if isinstance(v, dict)
                else cast(k, v)) for k, v in batch.items()}


def loss_q_grads(learner, batch, use_kernels):
    """LossQ, Q [B, T, A] and the raw gradients of one backward (no step)."""
    learner.optimizer.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, qvals = learner._loss(batch, use_kernels, None)
        loss.backward()
    return loss.item(), qvals.detach(), [p.grad.detach().clone() for p in learner.parameters()]


def referee_err(got, ref, scale=None):
    """max |got - ref| / max(1, scale), the scale max |ref| unless given."""
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"bad output: shape {tuple(got.shape)} vs {tuple(ref.shape)}, "
                             "or non-finite values")
    scale = ref.abs().max().item() if scale is None else scale
    return (got - ref).abs().max().item() / max(1.0, scale)


def gat_referee(fwd_args, out, mstat, lstat, g, dtype=torch.float64, chunk=8192):
    """The referees of #2 and #3 on their own inputs, the plain versions in
    ``dtype`` (f64 for a bf16 kernel, f32 for an f32 one): (out, m, l) of the
    plain forward on ``fwd_args``' values, and (dw, db, der, dattn) of the
    plain backward on the backward's inputs (the kernel forward's ``out``,
    ``m``, ``l``, and ``g``), taken ``chunk`` rows at a time (a call of 10^5
    rows would hold tens of GB of temporaries); and the der entries [N, HF]
    that a valid slot's |z| below ``GAT_TIE`` feeds."""
    from uav_bs_ctrl_tpu_torch.ops.gat_kernels import (flash_gat_fused_bwd_plain,
                                                       flash_gat_fused_plain)
    x, w, b, er, attn, mask, heads, slope = fwd_args
    cast = lambda t: t.to(dtype)
    fwds, ders, ties, sums = [], [], [], None
    for i in range(0, x.shape[0], chunk):
        rows = slice(i, i + chunk)
        args = (cast(x[rows]), cast(w), cast(b), cast(er[rows]), cast(attn), cast(mask[rows]))
        fwds.append(flash_gat_fused_plain(*args, heads, slope))
        _, dw, db, der, dattn = flash_gat_fused_bwd_plain(
            *args, cast(out[rows]), mstat[rows].to(dtype), lstat[rows].to(dtype),
            cast(g[rows]), heads, slope, False)
        ders.append(der)
        z = args[0] @ args[1] + args[2] + args[3][:, None, :]
        ties.append(((z.abs() < GAT_TIE) & (args[5] > 0)[:, :, None]).any(1))
        sums = [dw, db, dattn] if sums is None else [a + c for a, c in zip(sums, (dw, db, dattn))]
    return (tuple(torch.cat(parts) for parts in zip(*fwds)),
            (sums[0], sums[1], torch.cat(ders), sums[2]), torch.cat(ties))


def clip_like_update(learner, grads):
    """``grads`` (net leaves, then mixer leaves) clipped as ``apply_grads``
    clips them: the net's to [-1, 1], the mixer's as they are."""
    n_net = len(list(learner.net.parameters()))
    return [g.clamp(-1.0, 1.0) if i < n_net else g for i, g in enumerate(grads)]


def leaf_errs(grads, refs, largest):
    """Each leaf's max |got - ref| over its own scale: its max |ref|, at least
    ``LEAF_FLOOR`` of ``largest`` (a leaf that is zero in exact arithmetic,
    such as a key bias under the softmax, has no scale of its own)."""
    return [(g.double() - r.double()).abs().max().item()
            / max(r.abs().max().item(), LEAF_FLOOR * largest) for g, r in zip(grads, refs)]


@contextlib.contextmanager
def zeroed_gat_dw(gat_kernels):
    """#3 as the learner's backward calls it, with its dW set to zero."""
    kernel = gat_kernels.flash_gat_fused_bwd

    def zeroed(*args, **kwargs):
        dx, dw, db, der, dattn = kernel(*args, **kwargs)
        return dx, torch.zeros_like(dw), db, der, dattn
    zeroed.launches, zeroed.launches_bf16 = kernel.launches, kernel.launches_bf16  # counted
    zeroed.shapes = kernel.shapes                            # and recorded
    gat_kernels.flash_gat_fused_bwd = zeroed                 # through the module's name
    try:
        yield
    finally:
        gat_kernels.flash_gat_fused_bwd = kernel


def bench_phases(ctx):
    """``bench.py``'s flagship update (8 UBSs, M = 50, K = 7, hidden 256, 4
    heads, msg 64, key 16, dueling, double-Q, ``pallas_fused_mxu``) through the
    port's learner, on ``bench.py:setup_learner``'s synthetic replay (B = 256
    sequences of T = 50), at f32 and bf16 under each BPTT schedule. Gates at B
    = 32: f32 kernel updates against the plain path (``check_update``) and
    ``hoisted``/``merged`` against ``per_step``; bf16 kernel updates within
    ``BF16_TOL`` of the f64 plain-path referee (LossQ, Q, clipped grads), each
    clipped-grad leaf on its own scale against the plain bf16 path's error
    (``leaf_errs``; zeroing #3's dW must fail it), f32 masters and AdamW state
    after, a bit-identical repeat, only bf16 launches. Times at B = 256: ms
    and launches per update, the device-busy share, edges/s; each kernel at
    the update's shapes in both dtypes, a bf16 one against its f64 referee,
    an f32 one against its plain version. Then one fresh bf16 ``train_fast``
    epoch. Returns the bf16 kernels' record entries."""
    from uav_bs_ctrl_tpu_torch import run_fast
    from uav_bs_ctrl_tpu_torch.algos.buffer import tree_leaves, tree_map
    from uav_bs_ctrl_tpu_torch.ops import gat_kernels, step_kernels
    from uav_bs_ctrl_tpu_torch.utils import checkpoint
    counts, counts_bf16, reset_counts = ctx.counts, ctx.counts_bf16, ctx.reset_counts
    kernel_names = ("flash_gat_fused", "flash_gat_fused_bwd", "tarmac_step", "tarmac_step_bwd")
    T, A = BENCH_T, BENCH_A
    edges = BENCH_B * (2 * T + 1) * A * (BENCH_M + BENCH_K + A)     # bench.py:64

    with phase(f"bench workload: bench.py's replay, {BENCH_B} sequences of {T} steps"):
        t0 = time.perf_counter()
        base = bench_learner(BENCH_B, "float32", "per_step")
        bench_replay(base)
        sample = lambda b, seed: tree_map(lambda v: torch.as_tensor(v, device=DEVICE),
                                          base.buffer.sample(b, np.random.RandomState(seed)))
        gate_batch, batch = sample(BENCH_GATE_B, 1), sample(BENCH_B, 2)
        print(f"  replay of {len(base.buffer)} sequences built and sampled in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        learners = {(dt, s): bench_learner(BENCH_GATE_B, dt, s)
                    for dt in ("float32", "bfloat16") for s in BENCH_SCHEDULES}

    with phase(f"bench workload: f32 gates at B = {BENCH_GATE_B} (each schedule's kernel update "
               f"against the plain path; hoisted and merged against per_step)"):
        raw = {}
        for s in BENCH_SCHEDULES:
            learner = learners["float32", s]
            print(f"  {s}:", flush=True)
            check_update(learner, gate_batch, bench_per_update(s), counts)
            snap = learner.state_dict()
            raw[s] = loss_q_grads(learner, gate_batch, True)
            learner.load_state_dict(snap)
        names = [f"net.{k}" for k, _ in learners["float32", "per_step"].net.named_parameters()]
        scale = max(g.abs().max().item() for g in raw["per_step"][2])
        for s in ("hoisted", "merged"):
            loss_err = abs(raw[s][0] - raw["per_step"][0]) / abs(raw["per_step"][0])
            grad_err = max((a - b).abs().max().item() for a, b in zip(raw[s][2],
                                                                      raw["per_step"][2])) / scale
            print(f"  {s} against per_step: LossQ rel diff {loss_err:.2e} (limit "
                  f"{UPDATE_LOSS_RTOL}), raw grads max |diff| / largest {grad_err:.2e} (limit "
                  f"{UPDATE_GRAD_RTOL}; {len(names)} tensors)", flush=True)
            if not (loss_err <= UPDATE_LOSS_RTOL and grad_err <= UPDATE_GRAD_RTOL):
                raise AssertionError(f"f32 {s} differs from per_step")

    with phase(f"bench workload: bf16 gates at B = {BENCH_GATE_B} (the kernel update against "
               f"its f64 plain-path referee, each gradient leaf also on its own scale beside "
               f"the plain bf16 path's, a planted fault, f32 masters and AdamW state, a "
               f"bit-identical repeat, bf16 launches only)"):
        ref_batch = referee_batch(gate_batch)
        for s in BENCH_SCHEDULES:
            learner = learners["bfloat16", s]
            names = [f"{g}.{k}" for g, mod in (("net", learner.net), ("mixer", learner.mixer))
                     if mod is not None for k, _ in mod.named_parameters()]
            snap = learner.state_dict()
            before, before16 = counts(), counts_bf16()
            loss, q, grads = loss_q_grads(learner, gate_batch, True)
            launched = {k: v - before[k] for k, v in counts().items()}
            launched16 = {k: v - before16[k] for k, v in counts_bf16().items()}
            learner.apply_grads()
            clipped = [p.grad.detach().clone() for p in learner.parameters()]
            after = learner.state_dict()
            learner.load_state_dict(snap)
            again = loss_q_grads(learner, gate_batch, True)
            learner.apply_grads()
            again_state = learner.state_dict()
            bitwise = again[0] == loss and torch.equal(again[1], q) and all(
                torch.equal(a, b) for a, b in zip(again[2], grads)) and all(
                torch.equal(v, again_state[m][k]) for m in ("net", "target_net")
                for k, v in after[m].items())
            masters = all(p.dtype == torch.float32 for m in (learner.net, learner.target_net)
                          for p in m.parameters()) and all(
                t.dtype == torch.float32 for p in learner.parameters()
                for t in (learner.optimizer.state[p]["exp_avg"],
                          learner.optimizer.state[p]["exp_avg_sq"]))
            learner.load_state_dict(snap)
            plain_clipped = clip_like_update(learner,
                                             loss_q_grads(learner, gate_batch, False)[2])
            ref = referee_learner(learner)
            ref_loss, ref_q, ref_grads = loss_q_grads(ref, ref_batch, False)
            ref_clipped = clip_like_update(ref, ref_grads)
            del ref
            gscale = max(g.abs().max().item() for g in ref_clipped)
            errs = {"LossQ": abs(loss - ref_loss) / max(1.0, abs(ref_loss)),
                    "Q": referee_err(q, ref_q),
                    "clipped grads": max(referee_err(a, b, gscale)
                                         for a, b in zip(clipped, ref_clipped))}
            leaves = leaf_errs(clipped, ref_clipped, gscale)
            plain_leaves = leaf_errs(plain_clipped, ref_clipped, gscale)
            leaf_fail = [n for n, k, p in zip(names, leaves, plain_leaves)
                         if k > LEAF_RATIO * p + BF16_TOL]
            want = bench_per_update(s)
            print(f"  {s}: LossQ {loss:.6f}, referee {ref_loss:.6f}; errors against the f64 "
                  f"referee (of max(1, max |referee|); grads of the largest clipped grad "
                  f"{gscale:.3g}): " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f" (limit {BF16_TOL}); masters and AdamW state f32: {masters}; repeat "
                  f"bit-identical: {bitwise}; bf16 launches {launched16}", flush=True)
            print(f"  {s}: each clipped-grad leaf on its own scale (max |referee|, at least "
                  f"{LEAF_FLOOR} of the largest), kernel path vs plain bf16 path (limit: "
                  f"{LEAF_RATIO} x plain + {BF16_TOL}); the worst five: " + "; ".join(
                      f"{names[i]} {leaves[i]:.2e} vs {plain_leaves[i]:.2e}"
                      for i in sorted(range(len(names)), key=lambda i: -leaves[i])[:5]),
                  flush=True)
            if s == "per_step":     # the leaf gate's power: #3's dW zeroed must fail it
                learner.load_state_dict(snap)
                with zeroed_gat_dw(gat_kernels):
                    fault = clip_like_update(learner, loss_q_grads(learner, gate_batch, True)[2])
                learner.load_state_dict(snap)
                caught = [(n, k) for n, k, p in zip(names, leaf_errs(fault, ref_clipped, gscale),
                                                    plain_leaves)
                          if k > LEAF_RATIO * p + BF16_TOL]
                print(f"  planted fault, #3's dW zeroed: the leaf gate fails on "
                      f"{[(n, round(k, 4)) for n, k in caught]}", flush=True)
                if not caught:
                    raise AssertionError("the leaf gate missed a zeroed GATv2 dW")
            if max(errs.values()) > BF16_TOL or leaf_fail or not (
                    masters and bitwise and math.isfinite(loss)):
                raise AssertionError(f"bf16 {s}: the update fails its gates (leaves beyond "
                                     f"their limit: {leaf_fail})")
            if launched16 != want or launched != want:
                raise AssertionError(f"bf16 {s}: expected {want} bf16 launches and no f32 one, "
                                     f"got {launched16} of {launched}")

    out = SimpleNamespace(records=[], ms={}, launches={}, card_launches={}, graph_ms={})
    with phase(f"bench workload: times at B = {BENCH_B}, f32 and bf16 x per_step, hoisted, "
               f"merged ({edges} message-passing edges an update, bench.py:64)"):
        print(f"  card: {card_line()}", flush=True)
        captured = {}
        for dt in ("float32", "bfloat16"):
            for s in BENCH_SCHEDULES:
                learner = learners[dt, s]
                snap = learner.state_dict()
                reset_counts()
                with torch.enable_grad():     # the program's first call: eager, then captured
                    learner.update_on_batch(batch)           # (and it sizes the allocator)
                torch.cuda.synchronize()
                launches = counts() if dt == "float32" else counts_bf16()
                wrapped = counts(), counts_bf16()
                with card_launches() as card, torch.enable_grad():   # a replay
                    learner.update_on_batch(batch)
                replayed = card.calls if dt == "float32" else card.calls_bf16
                if bench_per_update(s) != launches or launches != wrapped[0] or \
                        replayed != launches or replayed != card.calls:
                    raise AssertionError(f"{dt} {s}: expected {bench_per_update(s)} launches "
                                         f"of that type, got {wrapped[0]}, bf16 {wrapped[1]} "
                                         f"from the wrappers; on the card a replay made "
                                         f"{card.calls}, bf16 {card.calls_bf16}")
                learner.load_state_dict(snap)
                ms = ms_per_update(learner, batch, n=3)
                print(f"  {dt} {s}: {ms:.2f} ms per update, {1e3 / ms:.2f} updates/s, "
                      f"{edges * 1e3 / ms:.4g} edges/s; wrapper launches per update "
                      f"{launches}, the same calls in a replay on the card", flush=True)
                cuda_launches = profile_updates(learner, batch, 2, ms,
                                                {k: launches[k] for k in kernel_names})
                learner.load_state_dict(snap)
                if s == "hoisted":      # the update's CUDA graph against its eager twin
                    runs = {True: [ms], False: []}
                    for graphs_on in (False, True, False):
                        learner.graphs = graphs_on
                        runs[graphs_on].append(ms_per_update(learner, batch, n=3))
                    learner.graphs = True
                    out.graph_ms[dt] = {k: statistics.mean(v) for k, v in runs.items()}
                    print(f"  {dt} {s}: ms an update, graph {out.graph_ms[dt][True]:.2f} (runs "
                          f"{[round(x, 2) for x in runs[True]]}), eager "
                          f"{out.graph_ms[dt][False]:.2f} (runs "
                          f"{[round(x, 2) for x in runs[False]]})", flush=True)
                out.ms[dt, s] = ms
                out.launches[dt, s], out.card_launches[dt, s] = launches, replayed
                if s in ("per_step", "hoisted"):
                    with torch.enable_grad():
                        calls, _ = capture_backward_calls(learner, batch,
                                                          T // 2 if s == "per_step" else 0)
                    learner.load_state_dict(snap)
                    captured[dt, s] = calls
                del cuda_launches

        timed = {name: {"float32": [], "bfloat16": []} for name in kernel_names}
        worst = {dt: {name: [0.0, 0.0, 0.0] for name in kernel_names}   # rel err, abs err,
                 for dt in ("float32", "bfloat16")}                       # plain bf16's rel err
        for dt in ("float32", "bfloat16"):
            for s in ("per_step", "hoisted"):
                calls = captured[dt, s]
                big = s == "hoisted"
                for name, c in calls:
                    if big and name == "tarmac_step_bwd":
                        continue                 # #4/#5 run a step at a time in every schedule
                    fwd_args = c[0]
                    if name == "flash_gat_fused_bwd":
                        fwd_name = "flash_gat_fused"
                        fwd, bwd = gat_kernels.flash_gat_fused, gat_kernels.flash_gat_fused_bwd
                        out_k, ms_k, ls_k = fwd(*fwd_args)
                        bwd_args = fwd_args[:6] + (out_k, ms_k, ls_k, c[1]) + fwd_args[6:] + \
                            (False,)
                        fwd_cost, bwd_cost = gat_cost(fwd_args), gat_bwd_cost(bwd_args)
                        plains = (gat_kernels.flash_gat_fused_plain,
                                  gat_kernels.flash_gat_fused_bwd_plain)
                        label = f"'{'seen' if fwd_args[0].shape[1] == BENCH_M else 'near'}' " \
                                f"N={fwd_args[0].shape[0]}"
                    else:
                        fwd_name = "tarmac_step"
                        fwd, bwd = step_kernels.tarmac_step, step_kernels.tarmac_step_bwd
                        bwd_args = fwd_args[:17] + c[1:] + fwd_args[17:]
                        fwd_cost, bwd_cost = step_cost(fwd_args), step_bwd_cost(fwd_args)
                        plains = (step_kernels.tarmac_step_plain,
                                  step_kernels.tarmac_step_bwd_plain)
                        label = f"R={fwd_args[0].shape[0]}"
                    # Every output against its referee on the same inputs: a bf16 kernel
                    # against the plain version in f64 (within BF16_TOL of max(1, max
                    # |referee|)), an f32 one against the plain version in f32 (max_err's
                    # ATOL/RTOL forward, BWD_RTOL backward). The update's own cotangents
                    # are small (about 1e-5 at GATv2's output), so the backward is also
                    # held with unit-normal ones.
                    bf16 = dt == "bfloat16"
                    ref_dtype = torch.float64 if bf16 else torch.float32
                    unit = tuple(torch.randn(t.shape, device=t.device).to(t.dtype)
                                 for t in c[1:])
                    for cot_label, cot in (("the update's cotangent", c[1:]),
                                           ("unit-normal cotangents", unit)):
                        if fwd_name == "flash_gat_fused":
                            b_args = fwd_args[:6] + (out_k, ms_k, ls_k) + cot + \
                                fwd_args[6:] + (False,)
                            *refs, ties = gat_referee(fwd_args, out_k, ms_k, ls_k, cot[0],
                                                      ref_dtype)
                            # At bf16 the row statistics' -1e30 of a fully masked row
                            # is not the f64 referee's: only ``out`` is held there.
                            got = ((out_k,) if bf16 else (out_k, ms_k, ls_k),
                                   bwd(*b_args)[1:])
                            if not bf16:
                                # A der entry fed by a LeakyReLU tie is off by up to 0.8
                                # |d_s attn| (1e-2 of max |der| at N = 10^5 with unit
                                # cotangents): held at f32 where no tie feeds it. bf16's
                                # limit holds every entry.
                                tie_err = (got[1][2] - refs[1][2])[ties].abs().max().item() \
                                    if ties.any() else 0.0
                                print(f"  {dt} {name}, {label}, {cot_label}: "
                                      f"{int(ties.sum())} of {ties.numel()} der entries fed by "
                                      f"a |z| < {GAT_TIE} tie, max |kernel - plain| there "
                                      f"{tie_err:.2e}", flush=True)
                                untie = lambda t: torch.where(ties, 0.0, t)
                                got = (got[0], got[1][:2] + (untie(got[1][2]),) + got[1][3:])
                                refs = (refs[0], refs[1][:2] + (untie(refs[1][2]),) + refs[1][3:])
                            plain_got = None if big or not bf16 else (
                                plains[0](*fwd_args)[:1], plains[1](*b_args)[1:])
                        else:
                            b_args = fwd_args[:17] + cot + fwd_args[17:]
                            ref_in = [t.to(ref_dtype) if torch.is_tensor(t) else t
                                      for t in b_args]
                            refs = (plains[0](*(ref_in[:17] + ref_in[19:])), plains[1](*ref_in))
                            got = (fwd(*fwd_args), bwd(*b_args))
                            plain_got = (plains[0](*fwd_args), plains[1](*b_args)) if bf16 \
                                else None
                        for kname, part in ((fwd_name, 0), (name, 1)):
                            what = f"{dt} {kname}, {label}, {cot_label}"
                            rel = max(referee_err(g_, r) for g_, r in zip(got[part], refs[part]))
                            ab = max((g_.double() - r.double()).abs().max().item()
                                     for g_, r in zip(got[part], refs[part]))
                            if bf16:
                                prel = float("nan") if plain_got is None else max(
                                    referee_err(g_, r)
                                    for g_, r in zip(plain_got[part], refs[part]))
                                print(f"  {what}: max |kernel - f64 referee| / max(1, "
                                      f"max|referee|) {rel:.2e} (limit {BF16_TOL}), abs "
                                      f"{ab:.2e}; the plain bf16 version's "
                                      f"{'not measured' if math.isnan(prel) else f'{prel:.2e}'}",
                                      flush=True)
                                if rel > BF16_TOL:
                                    raise AssertionError(f"{what}: {rel:.3e} from its f64 "
                                                         "referee")
                            else:
                                prel = float("nan")
                                if part == 0:
                                    max_err(got[part], refs[part], what)
                                else:
                                    rel_err(got[part], refs[part], what)
                                print(f"  {what}: max |kernel - plain f32| / max(1, max|plain|) "
                                      f"{rel:.2e}, abs {ab:.2e} (limits: forward atol {ATOL} "
                                      f"rtol {RTOL}, backward {BWD_RTOL})", flush=True)
                            w_ = worst[dt][kname]
                            w_[0], w_[1] = max(w_[0], rel), max(w_[1], ab)
                            if not math.isnan(prel):
                                w_[2] = max(w_[2], prel)
                    for kname, fn, plain, kargs, cost in (
                            (fwd_name, fwd, plains[0], fwd_args, fwd_cost),
                            (name, bwd, plains[1], bwd_args, bwd_cost)):
                        f32_big = big and dt == "float32"    # tens of GB of f32 temporaries
                        timed[kname][dt].append(time_case(
                            f"{dt} {kname} {label}", label, fn, None if f32_big else plain,
                            kargs, cost, n_iter=5 if big else 20, reps=3 if big else 5))
        for s in BENCH_SCHEDULES:
            print(f"  ms per update at B = {BENCH_B}, {s}: f32 {out.ms['float32', s]:.2f}, bf16 "
                  f"{out.ms['bfloat16', s]:.2f}", flush=True)
        for name in kernel_names:
            rows = timed[name]["bfloat16"]
            finite = [r["plain_ms"] for r in rows if r["plain_ms"] is not None]
            out.records.append({
                "name": f"{name}_bf16", "route": "cuda",
                "source": f"uav_bs_ctrl_tpu_torch/ops/csrc/{name}.cu",
                "replaces": REPLACES[name],
                "launches": out.launches["bfloat16", "per_step"][name],
                "card_launches": out.card_launches["bfloat16", "per_step"][name],
                "max_abs_err": worst["bfloat16"][name][1],
                "max_rel_err": worst["bfloat16"][name][0],
                "plain_bf16_max_rel_err": worst["bfloat16"][name][2],
                "f32_max_rel_err_vs_plain": worst["float32"][name][0],
                "ms": statistics.mean(r["ms"] for r in rows),
                "plain_ms": statistics.mean(finite) if finite else None,
                "bound_ms": statistics.mean(r["bound_ms"] for r in rows),
                "bound_by": rows[0]["bound_by"], "library_ms": None, "cases": rows,
                "f32_cases": timed[name]["float32"],
                "launches_per_update": {s: out.launches["bfloat16", s][name]
                                        for s in BENCH_SCHEDULES}})
        del learners, base, batch, gate_batch, captured

    with phase("bench workload: a fresh run_fast.train_fast('exp3', c='tarmac', "
               "compute_dtype='bfloat16') epoch of 2000 steps (8 worlds, updates from the "
               "fifth iteration)"):
        scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_bf16_"))
        reset_counts()
        t0 = time.perf_counter()
        with torch.enable_grad():
            tr = run_fast.train_fast(
                "exp3", "8ubs", seed=0, n_worlds=8,
                train_overrides=dict(c="tarmac", compute_dtype="bfloat16", epochs=1,
                                     steps_per_epoch=2000, update_after=0, save_freq=1,
                                     device=DEVICE),
                logger_kwargs=dict(output_dir=str(scratch), exp_name="chip_smoke_bf16"))
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t0
        launches, launches16 = counts(), counts_bf16()
        head, rows = progress_rows(scratch)
        values = [float(v) for r in rows for k, v in r.items() if k not in ("Epoch",)]
        ckpt = checkpoint.load(scratch / "checkpoint_epoch1.pt")
        adam = checkpoint.find_state(ckpt["optimizer_state_dict"], "ScaleByAdamState")
        leaves = [np.asarray(v) for tree in (ckpt["model_state_dict"], *adam.args[1:])
                  for v in tree_leaves(tree)]
        print(f"  {fresh_s:.2f} s; row {[(k, rows[0][k]) for k in ('Epoch', 'TotalEnvInteracts', 'LossQ', 'AverageEpRet', 'AverageTestEpRet')]}; "
              f"{int(adam.args[0])} updates; checkpoint leaves "
              f"{sorted({str(v.dtype) for v in leaves})}; launches {launches}, bf16 "
              f"{launches16}", flush=True)
        if len(rows) != 1 or not all(math.isfinite(v) for v in values):
            raise AssertionError(f"progress.txt rows {rows}")
        if {str(v.dtype) for v in leaves} != {"float32"} or int(adam.args[0]) != tr.updates_per_iter:
            raise AssertionError("the bf16 run's checkpoint must hold f32 masters and moments "
                                 f"after {tr.updates_per_iter} updates")
        if launches16 != launches or not all(
                launches16[k] for k in kernel_names):
            raise AssertionError(f"the bf16 run launched f32 kernels or missed one: {launches}, "
                                 f"bf16 {launches16}")
        del tr
        shutil.rmtree(scratch)
    return out


def exp1_phases(ctx):
    """The exp1 (single-UBS DRQN) phases: #2 and #3 at exp1's shapes against
    their plain versions; serving the committed gnn and rnn runs (epoch 50),
    the gnn run's every step against the plain path; the gnn run resumed by
    ``train.py``'s path, two warm-ups, one update gated against the plain
    path; ``run_fast.train_fast_exp1`` resumed (gnn) and fresh (rnn). ``ctx``
    carries main's ``rng``, ``worst``, ``counts``, ``reset_counts`` and
    ``phase_launches``; returns what :func:`exp1_times` times."""
    from uav_bs_ctrl_tpu_torch import run_fast, serve, train
    from uav_bs_ctrl_tpu_torch.algos import collect_subs
    from uav_bs_ctrl_tpu_torch.algos.drqn import config as drqn_config
    from uav_bs_ctrl_tpu_torch.algos.drqn.fused import obs_shape
    from uav_bs_ctrl_tpu_torch.algos.drqn.learner import QLearner
    from uav_bs_ctrl_tpu_torch.envs import torch_env_subs
    from uav_bs_ctrl_tpu_torch.ops.gat_kernels import (
        flash_gat_fused, flash_gat_fused_bwd, flash_gat_fused_bwd_plain, flash_gat_fused_plain)
    from uav_bs_ctrl_tpu_torch.utils import checkpoint
    counts, reset_counts, worst = ctx.counts, ctx.reset_counts, ctx.worst
    zero = dict.fromkeys(counts(), 0)
    gnn_config = json.loads((EXP1_GNN_DIR / "config.json").read_text())
    env_kwargs = gnn_config["env_kwargs"]
    env_params = torch_env_subs.make_params(**env_kwargs)
    T, M = env_params.episode_limit, env_params.n_gts
    B, heads, hidden = drqn_config.DEFAULT_CONFIG["batch_size"], 4, 256
    out = SimpleNamespace(cases={})

    with phase(f"exp1 kernels: #2 at N = {N_WORLDS} and {B}, #3 at N = {B}; M = {M}, D = 4, "
               f"H = {heads}, F = {hidden // heads}, every slot valid"):
        for n in (N_WORLDS, B):
            c = gat_case(ctx.rng, n, M, 4, hidden, heads, masked_rows=[], valid=1.0)
            if not bool((c["mask"] > 0).all()):
                raise AssertionError("the exp1 case's mask is not all valid")
            args = (c["x"], c["w"], c["b"], c["er"], c["attn"], c["mask"], heads)
            got = flash_gat_fused(*args)
            err = max_err(got, flash_gat_fused_plain(*args), f"flash_gat_fused exp1 N={n}")
            worst["flash_gat_fused"] = max(worst["flash_gat_fused"], err)
            out.cases[("flash_gat_fused", n)] = args
            print(f"  flash_gat_fused N={n} M={M} D=4 all valid: max abs err {err:.3e}",
                  flush=True)
            if n == B:
                g = torch.randn(got[0].shape, device=DEVICE)
                bwd_args = args[:6] + got + (g, heads, 0.2, False)
                err = rel_err(flash_gat_fused_bwd(*bwd_args), flash_gat_fused_bwd_plain(*bwd_args),
                              f"flash_gat_fused_bwd exp1 N={n}")
                worst["flash_gat_fused_bwd"] = max(worst["flash_gat_fused_bwd"], err)
                out.cases[("flash_gat_fused_bwd", n)] = bwd_args
                print(f"  flash_gat_fused_bwd N={n} M={M} D=4 all valid, no dx: max rel err "
                      f"{err:.3e}", flush=True)

    for label, run_dir in (("gnn", EXP1_GNN_DIR), ("rnn", EXP1_RNN_DIR)):
        with phase(f"serve {run_dir.name} (epoch {EXP1_EPOCH}): {N_WORLDS} worlds, one "
                   f"{T}-step episode, eps={EPS}"):
            reset_counts()
            t0 = time.perf_counter()
            stats = serve.evaluate(run_dir, N_WORLDS, eps=EPS, seed=0, device=DEVICE)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            launches = ctx.phase_launches[f"exp1_serve_{label}"] = counts()
            want = dict(zero, flash_gat_fused=T) if label == "gnn" else zero
            print(f"  launches: {launches} over {T} env steps ({serve_s:.2f} s, loading "
                  f"included)", flush=True)
            if launches != want:
                raise AssertionError(f"expected {want} launches, got {launches}")
            for key, v in stats.items():
                if tuple(v.shape) != (N_WORLDS,) or not torch.isfinite(v).all():
                    raise AssertionError(f"{key}: shape {tuple(v.shape)} or non-finite values")
            means = {k: float(v.mean()) for k, v in stats.items()}
            logged = training_log_test_stats(run_dir, EXP1_EPOCH)
            print(f"  episode stats (mean over {N_WORLDS} worlds): {json.dumps(means)}")
            print(f"  the training log's test stats at epoch {EXP1_EPOCH} (JAX, 5 episodes, "
                  f"other layouts): {json.dumps(logged)}", flush=True)
            if not means["TestEpRet"] > 0.5 * logged["AverageTestEpRet"]:
                raise AssertionError(f"TestEpRet {means['TestEpRet']:.2f} is not above half the "
                                     f"run's own {logged['AverageTestEpRet']}")

        if label != "gnn":
            continue
        with phase(f"serve {run_dir.name} again, every step's Q and h' against the unfused "
                   f"plain path"):
            agent, _ = serve.load_policy(run_dir, DEVICE)
            errs, calls = [], []

            def checked(obs, h, use_kernels=True, key=None):
                if not calls:
                    calls.extend(capture_kernel_calls(agent, obs, h))
                q, h2 = agent(obs, h)
                q_ref, h_ref = agent(obs, h, use_kernels=False)
                errs.append(((q - q_ref).abs().max().item(), (h2 - h_ref).abs().max().item()))
                return q, h2

            stats2 = collect_subs.evaluate_policy_subs(
                env_params, checked, serve.test_pool_subs(env_kwargs, 0), agent.hidden,
                torch.Generator().manual_seed(0), N_WORLDS, torch.device(DEVICE), EPS)
            worst_q, worst_h = max(e[0] for e in errs), max(e[1] for e in errs)
            print(f"  {len(errs)} steps: max |dQ| {worst_q:.3e}, max |dh'| {worst_h:.3e} (bound "
                  f"{ATOL}); same episode stats as the first run: "
                  f"{all(torch.equal(stats[k], stats2[k]) for k in stats)}", flush=True)
            if len(errs) != T or worst_q > ATOL or worst_h > ATOL:
                raise AssertionError(f"per-step Q/h' beyond {ATOL}: {worst_q:.3e} / {worst_h:.3e}")
            if [name for name, _ in calls] != ["flash_gat_fused"]:
                raise AssertionError(f"an exp1 policy step called {[n for n, _ in calls]}")
            args = calls[0][1]
            if tuple(args[0].shape) != (N_WORLDS, M, 4) or not bool((args[5] > 0).all()):
                raise AssertionError(f"the serving step's #2 inputs: x {tuple(args[0].shape)}, "
                                     f"valid share {(args[5] > 0).float().mean().item()}")
            err = max_err(flash_gat_fused(*args), flash_gat_fused_plain(*args),
                          "flash_gat_fused on exp1 serving inputs")
            worst["flash_gat_fused"] = max(worst["flash_gat_fused"], err)
            out.cases[("flash_gat_fused", N_WORLDS)] = args      # real inputs for the times

    with phase(f"train {EXP1_GNN_DIR.name}: resume with the AdamW state, {train.N_WARMUPS} "
               f"warm-ups and one full iteration, then one update through the kernels "
               f"against the plain path"):
        with torch.enable_grad():
            t0 = time.perf_counter()
            tr = train.build_trainer(EXP1_GNN_DIR, DEVICE)
            lr = tr.learner
            t1 = time.perf_counter()
            with card_launches() as card:       # the collection program: eager, then replays
                warm = [tr.run_iteration(EPS, warmup=True) for _ in range(train.N_WARMUPS)]
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = ctx.phase_launches["exp1_train_warmups"] = card.calls
        print(f"  {type(lr.net).__name__}, {tr.n_worlds} worlds, L = {tr.L} ({tr.n_slices} "
              f"slices an episode), {tr.updates_per_iter} updates an iteration at "
              f"B={lr.batch_size}; ring of {tr.capacity} chunks; lr {lr.lr} x {lr.lr_scale}; "
              f"AdamW resumed at step "
              f"{lr.optimizer.state[lr.parameters()[0]]['step'].item():.0f}", flush=True)
        print(f"  load {t1 - t0:.2f} s, {train.N_WARMUPS} warm-ups {t2 - t1:.2f} s; warm-up "
              f"episode stats {json.dumps(warm)}; launches {launches}", flush=True)
        want = dict(zero, flash_gat_fused=train.N_WARMUPS * T)
        if launches != want or (tr._size, tr._ptr) != (2 * tr.chunks_per_iter,) * 2:
            raise AssertionError(f"expected {want} launches and a ring of "
                                 f"{2 * tr.chunks_per_iter}, got {launches}, "
                                 f"{tr._size}/{tr._ptr}")
        # The policy unrolls L + 1 steps and the target L; without double-Q the
        # policy's last step feeds no loss term, so autograd runs L backward steps.
        per_update = dict(zero, flash_gat_fused=2 * tr.L + 1, flash_gat_fused_bwd=tr.L)
        with torch.enable_grad(), card_launches() as card:   # the updates replay
            t0 = time.perf_counter()
            metrics = tr.run_iteration(EPS)
            torch.cuda.synchronize()
            out.iteration_s = time.perf_counter() - t0
        launches = ctx.phase_launches["exp1_train_iteration"] = card.calls
        losses = tr.last_losses.tolist()
        print(f"  one iteration ({tr.n_worlds} worlds x {T} steps, {tr.updates_per_iter} "
              f"updates): {out.iteration_s:.2f} s, {json.dumps(metrics)}; LossQ of the first "
              f"and last 5 updates {[round(v, 5) for v in losses[:5] + losses[-5:]]}; "
              f"calls on the card {launches}", flush=True)
        want = {k: tr.updates_per_iter * v for k, v in per_update.items()}
        want["flash_gat_fused"] += T
        if launches != want or len(losses) != tr.updates_per_iter \
                or not all(np.isfinite(losses)):
            raise AssertionError(f"expected {want} launches and {tr.updates_per_iter} finite "
                                 f"LossQ values, got {launches}")
        batch = tr.sample_batch()
        check_update(lr, batch, per_update, counts)
        out.gnn_trainer, out.gnn_batch, out.per_update = tr, batch, per_update

    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_exp1_"))
    with phase(f"run_fast exp1: resume {EXP1_GNN_DIR.name} from checkpoint_epoch"
               f"{EXP1_EPOCH}.pt for one epoch of 1600 steps at 8 worlds"):
        columns = progress_rows(EXP1_GNN_DIR)[0]
        resume_dir = scratch / "gnn"
        resume_dir.mkdir()
        shutil.copy(EXP1_GNN_DIR / f"checkpoint_epoch{EXP1_EPOCH}.pt", resume_dir)
        saved_t = int(checkpoint.load(EXP1_GNN_DIR / f"checkpoint_epoch{EXP1_EPOCH}.pt")["t"])
        with torch.enable_grad(), card_launches() as card:   # the updates replay
            t0 = time.perf_counter()
            resumed = run_fast.train_fast_exp1(
                env_kwargs, seed=gnn_config["seed"], n_worlds=8,
                train_overrides=dict(gnn_config["args"], epochs=EXP1_EPOCH + 1,
                                     steps_per_epoch=1600, device=DEVICE),
                logger_kwargs=dict(output_dir=str(resume_dir), exp_name=gnn_config["exp_name"]),
                resume=True)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
        launches = ctx.phase_launches["exp1_run_fast_resumed"] = card.calls
        rl = resumed.learner
        head, rows = progress_rows(resume_dir)
        n_upd = resumed.updates_per_iter
        jax_row = next(r for r in progress_rows(EXP1_GNN_DIR)[1]
                       if r["Epoch"] == str(EXP1_EPOCH + 1))
        print(f"  the JAX run's epoch {EXP1_EPOCH + 1} (16,000 steps, 1,600 updates): LossQ "
              f"{jax_row['LossQ']}, AverageEpRet {jax_row['AverageEpRet']}", flush=True)
        print(f"  {resume_s:.2f} s; {n_upd} updates; AdamW step "
              f"{rl.optimizer.state[rl.parameters()[0]]['step'].item():.0f}, lr_scale "
              f"{rl.lr_scale}; row: Epoch {rows[0]['Epoch']}, TotalEnvInteracts "
              f"{rows[0]['TotalEnvInteracts']}, LossQ {rows[0]['LossQ']}, AverageEpRet "
              f"{rows[0]['AverageEpRet']}, AverageTestEpRet {rows[0]['AverageTestEpRet']}; "
              f"calls on the card {launches}", flush=True)
        if head != columns or len(rows) != 1 or rows[0]["Epoch"] != str(EXP1_EPOCH + 1) \
                or int(rows[0]["TotalEnvInteracts"]) != saved_t + 1600 \
                or not math.isfinite(float(rows[0]["LossQ"])) or n_upd != 160:
            raise AssertionError(f"progress.txt: header {head}, rows {rows}, {n_upd} updates")
        # two warm-ups, the iteration's collection, the test episodes
        want = {k: n_upd * v for k, v in per_update.items()}
        want["flash_gat_fused"] += 4 * T
        if launches != want:
            raise AssertionError(f"expected {want} launches, got {launches}")
        written = resume_dir / f"checkpoint_epoch{EXP1_EPOCH + 1}.pt"
        env_info = dict(obs_shape=obs_shape(env_params, "gnn"), n_actions=env_params.n_actions,
                        episode_limit=T)
        reloaded = QLearner(env_info, resumed.args, seed=1)
        stamp = reloaded.load_checkpoint(written)
        same = learner_bits_equal(rl, reloaded)
        print(f"  {written.name}: stamp {stamp}; a fresh learner loading it holds the trainer's "
              f"params and AdamW state bit for bit: {same}", flush=True)
        if not same or stamp != {"epoch": EXP1_EPOCH + 1, "t": saved_t + 1600}:
            raise AssertionError(f"{written.name} does not hold the trainer's state")
        del resumed, reloaded

    with phase("run_fast exp1: a fresh --agent rnn start, 2 epochs of 1600 steps at 8 worlds, "
               "the second with updates"):
        with torch.enable_grad():
            reset_counts()
            t0 = time.perf_counter()
            fresh = run_fast.train_fast_exp1(
                env_kwargs, seed=0, n_worlds=8,
                train_overrides=dict(agent="rnn", epochs=2, steps_per_epoch=1600,
                                     update_after=1600, save_freq=1, device=DEVICE),
                logger_kwargs=dict(output_dir=str(scratch / "rnn"), exp_name="chip_smoke_rnn"))
            torch.cuda.synchronize()
            fresh_s = time.perf_counter() - t0
            launches = ctx.phase_launches["exp1_run_fast_rnn"] = counts()
        head, rows = progress_rows(scratch / "rnn")
        cols = ("Epoch", "TotalEnvInteracts", "LossQ", "AverageEpRet", "AverageTestEpRet")
        print(f"  {fresh_s:.2f} s; {type(fresh.learner.net).__name__}; rows {cols}: "
              f"{[tuple(r[c] for c in cols) for r in rows]}; launches {launches}", flush=True)
        if head != columns or [(r["Epoch"], r["TotalEnvInteracts"]) for r in rows] != \
                [("1", "1600"), ("2", "3200")] or not math.isnan(float(rows[0]["LossQ"])) \
                or not math.isfinite(float(rows[1]["LossQ"])):
            raise AssertionError(f"progress.txt: header {head}, rows {rows}")
        if launches != zero:
            raise AssertionError(f"a kernel launched on the rnn path: {launches}")
        out.rnn_trainer = fresh
    shutil.rmtree(scratch)
    return out


def host_loop_phases(ctx):
    """The classic host loop (slice 11): ``test_policies.test_series`` on the
    card over the committed exp1 2 x 5 gnn run (epoch 50; #2 at N = 1 a step)
    and the 4-UBS TarMAC+QMIX run (its newest checkpoint; #2 twice and #4 at
    W = 1 a step), timed with ``StepTimer`` and then again with every step's
    Q and h' held against the plain path; ``run_classic``'s exp3 preset on
    the 4-UBS TarMAC+QMIX configuration at full width for one epoch of
    ``CLASSIC_STEPS`` steps, one of its updates gated against the plain path
    and repeated bit for bit, its checkpoint read back by ``test_series``; a
    one-variant ``ExperimentGrid`` of the exp1 DRQN gnn agent through the
    pickled-thunk subprocess. ``ctx`` as for :func:`exp1_phases`."""
    from uav_bs_ctrl_tpu_torch import run_classic, serve, test_policies
    from uav_bs_ctrl_tpu_torch.algos import core
    from uav_bs_ctrl_tpu_torch.algos.buffer import tree_map
    from uav_bs_ctrl_tpu_torch.algos.drqn import run as drqn_run
    from uav_bs_ctrl_tpu_torch.envs.subs_cov import SingleUbsCoverageEnv
    from uav_bs_ctrl_tpu_torch.utils.profiling import StepTimer
    from uav_bs_ctrl_tpu_torch.utils.run_utils import ExperimentGrid
    counts, reset_counts = ctx.counts, ctx.reset_counts
    zero = dict.fromkeys(counts(), 0)
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_host_"))
    out = SimpleNamespace(step_ms={}, step_ms_eager={}, kernel_cases={})
    act_q = core.RecurrentQLearner._act_q
    errs, first = [], []

    def checked(self, obs, h, key):
        if not first:
            first.append((self.net, obs, h, key))
        q, h2 = act_q(self, obs, h, key)
        q_ref, h_ref = self.net(obs, h, False, key)
        errs.append(((q - q_ref).abs().max().item(), (h2 - h_ref).abs().max().item()))
        return q, h2

    # (label, run, checkpoint, committed summary and the checkpoint it was made
    # at, steps an episode, launches a step)
    runs = (("exp1", HOST_EXP1_DIR, f"checkpoint_epoch{EXP1_EPOCH}.pt",
             ROOT / "data" / "test_exp1_grp2" / "test_summary.csv",
             f"checkpoint_epoch{EXP1_EPOCH}.pt", 200, dict(zero, flash_gat_fused=1)),
            ("4ubs", HOST_4UBS_DIR, serve.latest_checkpoint(HOST_4UBS_DIR).name,
             ROOT / "data" / "test_exp3_4ubs" / "test_summary.csv", "checkpoint_epoch100.pt",
             50, dict(zero, flash_gat_fused=2, tarmac_step=1)),
            ("8ubs", RUN_DIR, "checkpoint_epoch100.pt",
             ROOT / "data" / "test_exp3_8ubs" / "test_summary.csv", "checkpoint_epoch100.pt",
             50, dict(zero, flash_gat_fused=2, tarmac_step=1)))
    for label, run_dir, ckpt, committed, committed_ckpt, steps, per_step in runs:
        with phase(f"test_policies on the card: {run_dir.name} at {ckpt}, {HOST_EPISODES} "
                   f"episodes of {steps} steps, act as a program against eager, timed, then "
                   f"every step against the plain path"):
            print(f"  {card_line()}", flush=True)
            n_steps = HOST_EPISODES * steps
            want = {k: v * n_steps for k, v in per_step.items()}
            series = {}
            for graphs_on in (True, False):
                timer, act_ms = StepTimer(), []
                reset_counts()
                t0 = time.perf_counter()
                with card_launches() as card, timing_calls(core.RecurrentQLearner, "act",
                                                           act_ms):
                    summary = test_policies.test_series(
                        None, test_policies.METRICS, [str(run_dir)], ckpt, HOST_EPISODES,
                        str(scratch / f"{label}_{graphs_on}"), device=DEVICE, timer=timer,
                        graphs=graphs_on)
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                times = dict(timer.flush(), ActMedianMs=statistics.median(act_ms))
                series[graphs_on] = (summary, card.calls, counts(), times)
                print(f"  {'graph' if graphs_on else 'eager'}: {wall:.2f} s (loading included); "
                      f"per host step: act {times['TimeActMs']:.3f} ms mean (the graph path's "
                      f"first call captures), {times['ActMedianMs']:.4f} ms median, env "
                      f"{times['TimeEnvMs']:.3f} ms; "
                      f"launches {card.calls} over {n_steps} steps on the card, {counts()} "
                      f"through the wrappers", flush=True)
            (summary, launches, through, times), eager = series[True], series[False]
            ctx.phase_launches[f"host_test_series_{label}"] = launches
            out.step_ms[label] = times
            out.step_ms_eager[label] = eager[3]
            # the graph path's wrappers count act's first call only (its eager run)
            if launches != want or eager[1] != want or eager[2] != want \
                    or through != (want if DEVICE == "cpu" else per_step):
                raise AssertionError(f"expected {want} launches (the program's wrappers "
                                     f"{per_step}), got {launches} ({through}), eager "
                                     f"{eager[1]} ({eager[2]})")
            if summary != eager[0]:
                raise AssertionError(f"act's program gives another summary than eager act: "
                                     f"{summary} against {eager[0]}")
            print(f"  the summary of act as a program equals eager act's bit for bit",
                  flush=True)
            for key, v in summary.items():
                if len(v) != HOST_EPISODES or not np.isfinite(np.asarray(v, float)).all():
                    raise AssertionError(f"{key}: {v}")
            print("  means: " + json.dumps({m: float(np.mean(v)) for (m, _), v in
                                            summary.items()}), flush=True)
            if committed_ckpt != ckpt:          # the committed summary's own checkpoint
                test_policies.test_series(None, test_policies.METRICS, [str(run_dir)],
                                          committed_ckpt, HOST_EPISODES,
                                          str(scratch / f"{label}_committed"), device=DEVICE)
            same = rows_equal(scratch / (f"{label}_True" if committed_ckpt == ckpt else
                                         f"{label}_committed") / "test_summary.csv",
                              committed, HOST_EPISODES)
            print(f"  at {committed_ckpt}, episodes whose row equals the committed "
                  f"{committed.relative_to(ROOT)} (the JAX harness, same seed; 1e-5 relative): "
                  f"{sum(same)} of {HOST_EPISODES} ({same})", flush=True)
            if not all(same):
                raise AssertionError(f"{label}: the committed rows are not reproduced: {same}")

            errs.clear()
            first.clear()
            core.RecurrentQLearner._act_q = checked
            try:
                reset_counts()
                again = test_policies.test_series(      # eager: the check syncs every step
                    None, test_policies.METRICS, [str(run_dir)], ckpt, HOST_EPISODES,
                    str(scratch / f"{label}_checked"), device=DEVICE, graphs=False)
                torch.cuda.synchronize()
            finally:
                core.RecurrentQLearner._act_q = act_q
            worst_q, worst_h = max(e[0] for e in errs), max(e[1] for e in errs)
            print(f"  checked: {len(errs)} steps, max |dQ| {worst_q:.3e}, max |dh'| "
                  f"{worst_h:.3e} (bound {ATOL}); launches {counts()}; the same summary as "
                  f"the timed run: {again == summary}", flush=True)
            if len(errs) != n_steps or worst_q > ATOL or worst_h > ATOL:
                raise AssertionError(f"per-step Q/h' beyond {ATOL}: {worst_q:.3e} / "
                                     f"{worst_h:.3e} over {len(errs)} steps")
            if counts() != want:
                raise AssertionError(f"expected {want} launches, got {counts()}")
            host_kernel_times(label, capture_kernel_calls(*first[0]), out.kernel_cases)

    classic_dir = scratch / "classic"
    with phase(f"run_classic: exp3 preset, 4ubs TarMAC+QMIX at full width, one epoch of "
               f"{CLASSIC_STEPS} steps, one update gated against the plain path"):
        print(f"  {card_line()}", flush=True)
        t0 = time.perf_counter()
        with torch.enable_grad(), card_launches() as card:   # the updates replay
            learner = run_classic.main(
                ["--exp", "exp3", "--map", "4ubs", "--c", "tarmac", "--mixer", "--device",
                 DEVICE, "--epochs", "1", "--steps-per-epoch", str(CLASSIC_STEPS),
                 "--update-after", "0", "--data-dir", str(classic_dir)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ctx.phase_launches["host_run_classic"] = card.calls
        T, B = learner.max_seq_len, learner.batch_size
        run_dir = next(classic_dir.glob("*/*_s0"))
        head, rows = progress_rows(run_dir)
        n_upd = len(range(B * T, CLASSIC_STEPS, T))
        per_update = dict(zero, flash_gat_fused=2 * (2 * T + 1), tarmac_step=2 * T + 1,
                          flash_gat_fused_bwd=2 * T, tarmac_step_bwd=T)
        saved = next(iter(json.loads((run_dir / "config.json").read_text())["args"].values()))
        policy_steps = CLASSIC_STEPS + saved["num_test_episodes"] * T   # training, the tests
        want = {k: n_upd * v for k, v in per_update.items()}
        want["flash_gat_fused"] += 2 * policy_steps
        want["tarmac_step"] += policy_steps
        taken = learner.optimizer.state[learner.parameters()[0]]["step"].item()
        cols = ("Epoch", "TotalEnvInteracts", "LossQ", "AverageEpRet", "AverageTestEpRet",
                "TimeActMs", "TimeEnvMs", "TimeUpdateMs", "Time")
        print(f"  {wall:.2f} s; B={B}, T={T}: {taken:.0f} updates; row "
              f"{ {c: rows[0][c] for c in cols} }; calls on the card {launches}", flush=True)
        out.classic = {c: float(rows[0][c]) for c in cols}
        if len(rows) != 1 or rows[0]["TotalEnvInteracts"] != str(CLASSIC_STEPS) \
                or not math.isfinite(float(rows[0]["LossQ"])) or taken != n_upd:
            raise AssertionError(f"progress.txt {rows}, {taken} updates (expected {n_upd})")
        if launches != want:
            raise AssertionError(f"expected {want} launches, got {launches}")
        batch = tree_map(lambda x: torch.as_tensor(x, device=DEVICE),
                         learner.buffer.sample(B, np.random.RandomState(0)))
        check_update(learner, batch, per_update, counts)
        out.classic_update_ms = ms_per_update(learner, batch, n=3)
        print(f"  one classic update (kernels): {out.classic_update_ms:.2f} ms", flush=True)

    with phase("test_policies reads back the classic run's checkpoint_epoch1.pt"):
        with card_launches() as card:
            summary = test_policies.test_series(None, test_policies.METRICS, [str(run_dir)],
                                                "checkpoint_epoch1.pt", 1,
                                                str(scratch / "readback"), device=DEVICE)
        launches = card.calls
        print(f"  {json.dumps({f'{m}/{e}': float(np.mean(v)) for (m, e), v in summary.items()})};"
              f" launches {launches}", flush=True)
        if launches != dict(zero, flash_gat_fused=2 * T, tarmac_step=T) or not all(
                len(v) == 1 and math.isfinite(float(v[0])) for v in summary.values()):
            raise AssertionError(f"read-back: {summary}, launches {launches}")
    del learner

    with phase("a one-variant ExperimentGrid of the exp1 DRQN gnn agent through the "
               "pickled-thunk subprocess on the card"):
        eg = ExperimentGrid(name="chip_smoke_grid")
        eg.add("seed", [0])
        eg.add("env_fn", SingleUbsCoverageEnv)
        eg.add("env_kwargs:n_grps", [2], "grp", True)
        eg.add("env_kwargs:gts_per_grp", 5)
        eg.add("train_kwargs:agent", "gnn", "", True)
        for k, v in dict(epochs=1, steps_per_epoch=400, update_after=0, num_test_episodes=1,
                         save_freq=1, device=DEVICE).items():
            eg.add(f"train_kwargs:{k}", v)
        t0 = time.perf_counter()
        failed = eg.run(drqn_run.train, data_dir=str(scratch / "grid"))
        wall = time.perf_counter() - t0
        grid_dir = scratch / "grid" / "chip_smoke_grid_grp2_gnn" / "chip_smoke_grid_grp2_gnn_s0"
        head, rows = progress_rows(grid_dir)
        config = json.loads((grid_dir / "config.json").read_text())
        saved = next(iter(config["args"].values()))
        cols = ("Epoch", "TotalEnvInteracts", "LossQ", "AverageEpRet", "AverageTestEpRet")
        print(f"  {wall:.2f} s (a fresh interpreter); row "
              f"{[{c: r[c] for c in cols} for r in rows]}; config: env_fn "
              f"{config['env_fn']}, device {saved['device']}, hidden {saved['hidden_size']}; "
              f"files {sorted(p.name for p in grid_dir.iterdir())}", flush=True)
        if failed or len(rows) != 1 or not math.isfinite(float(rows[0]["LossQ"])) \
                or saved["device"] != DEVICE or config["env_fn"] != "SingleUbsCoverageEnv" \
                or not (grid_dir / "checkpoint_epoch1.pt").exists():
            raise AssertionError(f"the grid's run: failed {failed}, rows {rows}, config {saved}")
    shutil.rmtree(scratch)
    return out


@contextlib.contextmanager
def timing_calls(cls, name, ms):
    """Append the host wall ms of each call of ``cls.name`` inside the block
    to ``ms`` (a call that reads its result back to the host, as ``act``
    does, includes its device time)."""
    fn = getattr(cls, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(cls, name, timed)
    try:
        yield
    finally:
        setattr(cls, name, fn)


def host_kernel_times(label, calls, cases):
    """Times the kernel calls of one host step (one world: #2 at N = 1, 4 or
    8 rows, #4 at R = 4 or 8) against their plain versions, with their
    bounds, into ``cases[name]``, at f32 (the run's) and at bf16 (the same
    inputs rounded: the cells a bf16 run's host loop would launch);
    measurement only, after the phase's launches are counted."""
    from uav_bs_ctrl_tpu_torch.ops.gat_kernels import flash_gat_fused, flash_gat_fused_plain
    from uav_bs_ctrl_tpu_torch.ops.step_kernels import tarmac_step, tarmac_step_plain
    fns = {"flash_gat_fused": (flash_gat_fused, flash_gat_fused_plain),
           "tarmac_step": (tarmac_step, tarmac_step_plain)}
    for name, f32_args in calls:
        fn, plain = fns[name]
        for dt in (torch.float32, torch.bfloat16):
            args = tuple(a.to(dt) if torch.is_tensor(a) and a.is_floating_point() else a
                         for a in f32_args)
            if name == "tarmac_step":
                cost, shape = step_cost(args), f"R={args[0].shape[0]}"
            else:
                cost = gat_cost(args)
                shape = f"N={args[0].shape[0]} M={args[0].shape[1]} D={args[0].shape[2]}"
            tag = "" if dt == torch.float32 else " bf16"
            cases.setdefault(name, []).append(time_case(
                f"host loop {label} {name}{tag} {shape}", f"host loop {label}:{tag} {shape}",
                fn, plain, args, cost))


def committed_rows(path):
    """``{(metric, exp_name): [value strings]}`` of a test_summary.csv."""
    rows = [line.split(",") for line in Path(path).read_text().splitlines()]
    return {(m, e): [r[i] for r in rows[2:]]
            for i, (m, e) in enumerate(zip(rows[0], rows[1])) if i}


def rows_equal(got_path, want_path, n_episodes):
    """Per episode, whether every column of ``got_path``'s summary equals
    ``want_path``'s to 1e-5 relative."""
    got, want = committed_rows(got_path), committed_rows(want_path)
    return [all(k in want and math.isclose(float(got[k][i]), float(want[k][i]), rel_tol=1e-5)
                for k in got) for i in range(n_episodes)]


def update_edge_list(obs):
    """The message-passing edges of one update on ``obs`` (leaves [B, T+1, A,
    ...]), flattened into one padded edge list: every world-step of the
    policy's T+1 steps and the target's T (steps 1..T), each with its
    'seen' (M GT slots -> agent), 'near' (K UBS slots -> agent) and talk (A
    agents -> agent) graph, B (2T+1) A (M + K + A) edges in all
    (``bench.py:64``). Returns ``(src, dst, mask, n_src, n_dst)``."""
    t1 = obs["gt"].shape[1]
    steps = torch.cat([torch.arange(t1), torch.arange(1, t1)])
    gt = obs["gt"][:, steps, ..., 0] > 0                        # [B, S, A, M]
    ubs = obs["ubs"][:, steps, ..., 0] > 0                      # [B, S, A, K]
    adj = obs["adj"][:, steps]                                  # [B, S, A, A]
    b, s, a, m = gt.shape
    k, g = ubs.shape[-1], b * s
    agent = torch.arange(g * a).reshape(g, a)                   # the destinations
    n_seen, n_near = g * a * m, g * a * k
    src = torch.cat([torch.arange(n_seen), n_seen + torch.arange(n_near),
                     n_seen + n_near + agent[:, None, :].expand(g, a, a).reshape(-1)])
    dst = torch.cat([agent[..., None].expand(g, a, m).reshape(-1),
                     agent[..., None].expand(g, a, k).reshape(-1),
                     agent[..., None].expand(g, a, a).reshape(-1)])
    mask = torch.cat([gt.reshape(-1), ubs.reshape(-1), adj.reshape(-1)])
    return src, dst, mask, n_seen + n_near + g * a, g * a


def slice13_phases(ctx):
    """Slice 13: ``vec_run.train_vectorized`` at the committed 8-UBS
    TarMAC+QMIX run's full width (``VEC_WORLDS`` worlds, cut to
    ``VEC_CUTS``; #2-#5 launched, one update gated against the plain path,
    the checkpoint read by the classic learner, which acts once);
    ``torch_env.reset`` of ``ROLLOUT_WORLDS`` worlds and a 50-step
    ``torch_env.rollout`` of the committed 8-UBS policy at eps 0, its actions
    and rewards against ``eval_rollout``'s on the same states; the C++ env
    core (built, and used by ``test_series``, whose committed 4-UBS and exp1
    rows must reproduce; host env ms per step with the core and with NumPy);
    every ``ops/segment.py`` op on the card against the CPU on one update's
    1,680,640 edges. ``ctx`` as for :func:`exp1_phases`, with ``check_env``
    (``env_schedule``'s launches against the env steps on the card);
    returns the figures."""
    from functools import partial
    from uav_bs_ctrl_tpu_torch import serve, test_policies
    from uav_bs_ctrl_tpu_torch.algos import collect
    from uav_bs_ctrl_tpu_torch.algos.buffer import tree_map
    from uav_bs_ctrl_tpu_torch.algos.madrqn import vec_run
    from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
    from uav_bs_ctrl_tpu_torch.algos.madrqn.wrappers import make_env
    from uav_bs_ctrl_tpu_torch.config import make_args
    from uav_bs_ctrl_tpu_torch.envs import torch_env
    from uav_bs_ctrl_tpu_torch.envs.mubs_cov import MultiUbsCoverageEnv
    from uav_bs_ctrl_tpu_torch.native import env_core
    from uav_bs_ctrl_tpu_torch.ops import segment
    from uav_bs_ctrl_tpu_torch.utils.profiling import StepTimer
    counts, reset_counts = ctx.counts, ctx.reset_counts
    zero = dict.fromkeys(counts(), 0)
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_slice13_"))
    out = SimpleNamespace()
    run_args = json.loads((RUN_DIR / "config.json").read_text())["args"]
    kw = dict(run_args, device=DEVICE, save_freq=1, **VEC_CUTS)

    with phase(f"vec_run: train_vectorized('8ubs') at {RUN_DIR.parent.name}'s width, "
               f"{VEC_WORLDS} worlds, {VEC_CUTS}"):
        print(f"  {card_line()}", flush=True)
        print(f"  depth cuts: steps_per_epoch {run_args['steps_per_epoch']} -> "
              f"{VEC_CUTS['steps_per_epoch']}, epochs {run_args['epochs']} -> "
              f"{VEC_CUTS['epochs']}, replay_size {run_args['replay_size']} -> "
              f"{VEC_CUTS['replay_size']} chunks, {VEC_CUTS['num_test_episodes']} test "
              f"episodes; random weights from seed 0", flush=True)
        reset_counts()
        t0 = time.perf_counter()
        with torch.enable_grad(), card_launches() as card:   # the updates replay
            learner = vec_run.train_vectorized(
                "8ubs", seed=0, train_kwargs=kw, n_worlds=VEC_WORLDS,
                logger_kwargs=dict(output_dir=str(scratch / "vec"), exp_name="chip_smoke_vec"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ctx.phase_launches["vec_run"] = card.calls
        ctx.check_env("vec_run: the chunks, their resets and the test episodes")
        T, B = learner.max_seq_len, learner.batch_size
        n_chunks = VEC_CUTS["steps_per_epoch"] * VEC_CUTS["epochs"] // (VEC_WORLDS * T)
        n_upd = n_chunks * VEC_WORLDS
        per_update = dict(zero, flash_gat_fused=2 * (2 * T + 1), tarmac_step=2 * T + 1,
                          flash_gat_fused_bwd=2 * T, tarmac_step_bwd=T)
        policy_steps = (n_chunks + 1) * T                      # the chunks, the test episodes
        want = {k: n_upd * v for k, v in per_update.items()}
        want["flash_gat_fused"] += 2 * policy_steps
        want["tarmac_step"] += policy_steps
        head, rows = progress_rows(scratch / "vec")
        taken = learner.optimizer.state[learner.parameters()[0]]["step"].item()
        out.vec = {c: float(rows[-1][c]) for c in ("EnvStepsPerSec", "TimeCollectMs",
                                                   "TimeUpdateMs", "LossQ", "AverageEpRet",
                                                   "AverageTestEpRet")}
        print(f"  {wall:.2f} s; {n_chunks} chunks of {VEC_WORLDS} x {T} env steps, {taken:.0f} "
              f"updates at B={B}; {out.vec}; calls on the card {launches}, per chunk "
              f"{ {k: v / n_chunks for k, v in launches.items()} }", flush=True)
        if [(r["Epoch"], r["TotalEnvInteracts"]) for r in rows] != \
                [("1", str(n_chunks * VEC_WORLDS * T))] or taken != n_upd \
                or not all(math.isfinite(v) for v in out.vec.values()):
            raise AssertionError(f"progress.txt {rows}, {taken} updates (expected {n_upd})")
        if launches != want or not all(launches[k] for k in per_update if per_update[k]):
            raise AssertionError(f"expected {want} launches, got {launches}")
        batch = tree_map(lambda x: torch.as_tensor(x, device=DEVICE),
                         learner.buffer.sample(B, np.random.RandomState(1)))
        check_update(learner, batch, per_update, counts)
        args = make_args(dict(kw, max_seq_len=None), DEVICE)
        env = make_env(partial(MultiUbsCoverageEnv, "8ubs", record=False,
                               rng=np.random.RandomState(0)), args)
        classic = MultiAgentQLearner(env.get_env_info(), args, seed=1)
        stamp = classic.load_checkpoint(scratch / "vec" / "checkpoint_epoch1.pt")
        same = all(torch.equal(p, q) for p, q in zip(classic.parameters(), learner.parameters()))
        (o, _), h = env.reset(), classic.init_hidden()
        acts, _ = classic.act(o, h, 0.0, np.random.RandomState(2))
        print(f"  checkpoint_epoch1.pt: stamp {stamp}; the classic learner holds the trained "
              f"params bit for bit: {same}; its greedy actions {acts} (scheduler "
              f"{env.env.scheduler})", flush=True)
        if stamp != {"epoch": 1, "t": n_chunks * VEC_WORLDS * T} or not same \
                or len(acts) != env.n_agents:
            raise AssertionError("the vec_run checkpoint does not load into the classic learner")
        del learner, classic

    with phase(f"rollout: torch_env.reset of {ROLLOUT_WORLDS} worlds, a 50-step rollout of "
               f"{RUN_DIR.name} at eps 0, against eval_rollout on the same states"):
        agent, config = serve.load_policy(RUN_DIR, DEVICE)
        params = torch_env.make_params(config["map_id"])
        T = params.episode_limit
        states = torch_env.reset(params, torch.Generator().manual_seed(0), DEVICE,
                                 ROLLOUT_WORLDS)
        h0 = torch.zeros((ROLLOUT_WORLDS, params.n_ubs, agent.hidden), device=DEVICE)
        step, recorded = torch_env.step, []

        def recording_step(p, s, a):
            res = step(p, s, a)
            recorded[-1].append((a, res[2]))
            return res

        def roll():
            return torch_env.rollout(params, agent, states, h0, torch.Generator().manual_seed(1),
                                     T, eps=0.0)

        roll()                                       # first call at these shapes, untimed
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, rews = roll()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = ctx.phase_launches["rollout"] = counts()
        ctx.check_env(f"rollout, {T} steps")
        torch_env.step = recording_step
        try:
            recorded.append([])
            roll()
            recorded.append([])
            stats = collect.eval_rollout(params, agent, states, h0, T,
                                         torch.Generator().manual_seed(2), 0.0)
        finally:
            torch_env.step = step
        acts = [torch.stack([a for a, _ in rec]) for rec in recorded]
        eval_rews = torch.stack([r for _, r in recorded[1]], 1)
        rew_err = (rews - eval_rews).abs().max().item()
        ret_err = (final.ep_ret - stats["TestEpRet"]).abs().max().item()
        out.rollout_steps_per_s = ROLLOUT_WORLDS * T / dt
        print(f"  {dt:.3f} s, {out.rollout_steps_per_s:.1f} env steps/s ({T / dt:.2f} batched "
              f"steps/s); mean episode return {final.ep_ret.mean().item():.4f}; actions equal "
              f"to eval_rollout's: {torch.equal(acts[0], acts[1])}; max |reward diff| "
              f"{rew_err:.3e}, |return diff| {ret_err:.3e} (limit {ROLLOUT_ATOL}); launches "
              f"{launches}", flush=True)
        if not torch.equal(acts[0], acts[1]) or rew_err > ROLLOUT_ATOL \
                or ret_err > ROLLOUT_ATOL or rews.shape != (ROLLOUT_WORLDS, T, params.n_ubs):
            raise AssertionError("rollout disagrees with eval_rollout")
        if launches != dict(zero, flash_gat_fused=2 * T, tarmac_step=T):
            raise AssertionError(f"rollout launches {launches}")
        del agent

    with phase("native: the C++ env core in test_series (the committed rows) and the host "
               "env's ms per step with the core and with NumPy"):
        print(f"  {card_line()}", flush=True)
        if not env_core.available():
            raise AssertionError(f"the C++ env core did not build: {env_core.error()}")
        print(f"  {Path(env_core.load()._name).relative_to(ROOT)}", flush=True)
        out.env_ms = {}
        available, warn_fallback = env_core.available, env_core.warn_fallback
        # (label, run, checkpoint, committed summary or None, steps an episode, core used)
        runs = (("4ubs", HOST_4UBS_DIR, "checkpoint_epoch100.pt",
                 ROOT / "data" / "test_exp3_4ubs" / "test_summary.csv", 50, True),
                ("8ubs", RUN_DIR, serve.latest_checkpoint(RUN_DIR).name, None, 50, True),
                ("exp1", HOST_EXP1_DIR, f"checkpoint_epoch{EXP1_EPOCH}.pt",
                 ROOT / "data" / "test_exp1_grp2" / "test_summary.csv", 200, False))
        for label, run_dir, ckpt, committed, steps, uses_core in runs:
            for scheduler in ("native", "numpy") if uses_core else ("numpy",):
                if scheduler == "numpy":        # the env's NumPy path, as if the core were absent
                    env_core.available, env_core.warn_fallback = (lambda: False), (lambda: None)
                try:
                    timer, calls = StepTimer(), env_core.calls
                    test_policies.test_series(None, test_policies.METRICS, [str(run_dir)], ckpt,
                                              HOST_EPISODES, str(scratch / label / scheduler),
                                              device=DEVICE, timer=timer)
                finally:
                    env_core.available, env_core.warn_fallback = available, warn_fallback
                n_calls = env_core.calls - calls
                times = timer.flush()
                out.env_ms[label, scheduler] = times["TimeEnvMs"]
                want_calls = HOST_EPISODES * (steps + 1) if uses_core and scheduler == "native" \
                    else 0
                same = rows_equal(scratch / label / scheduler / "test_summary.csv",
                                  committed or scratch / label / "native" / "test_summary.csv",
                                  HOST_EPISODES)
                against = committed.relative_to(ROOT) if committed else "the core's run"
                print(f"  {label} at {ckpt}, {HOST_EPISODES} episodes, {scheduler}: env "
                      f"{times['TimeEnvMs']:.3f} ms, act {times['TimeActMs']:.3f} ms a host step; "
                      f"{n_calls} calls into the core (expected {want_calls}); rows equal to "
                      f"{against}'s: {sum(same)} of {HOST_EPISODES}", flush=True)
                if n_calls != want_calls or not all(same):
                    raise AssertionError(f"{label} ({scheduler}): {n_calls} core calls, rows {same}")

    with phase(f"segment: ops/segment.py on the card against the CPU, one 8-UBS update's "
               f"edges (B = {batch['obs']['gt'].shape[0]}, T = {batch['obs']['gt'].shape[1] - 1})"):
        obs = {k: batch["obs"][k].cpu() for k in ("gt", "ubs", "adj")}
        src, dst, mask, n_src, n_dst = update_edge_list(obs)
        gen = torch.Generator().manual_seed(3)
        x = torch.randn((n_src, 4, 8), generator=gen)          # 4 heads of 8
        q = torch.randn((n_dst, 4, 8), generator=gen)
        v = torch.randn((n_src, 4, 8), generator=gen)

        def ops(x, q, v, src, dst, mask, n_dst, backend):
            """Every op on one edge list: ``{name: output}``."""
            s = segment.sddmm_dot(x, q, src, dst)
            e = segment.gather_src(v, src)
            alpha = segment.segment_softmax(s, dst, mask, n_dst, backend)
            res = {"segment_sum": segment.segment_sum(e, dst, mask, n_dst, backend),
                   "segment_mean": segment.segment_mean(e, dst, mask, n_dst, backend),
                   "segment_softmax": alpha,
                   "spmm_attention": segment.spmm_attention(alpha, v, src, dst, mask, n_dst,
                                                            backend)}
            if backend == "xla":
                res.update(gather_src=e, sddmm_dot=s,
                           segment_max=segment.segment_max(e, dst, mask, n_dst))
            return res

        sub = dst < SEGMENT_ONEHOT_DST                         # the one-hot product is [E, N]
        host = {"xla": (x, q, v, src, dst, mask, n_dst),
                "onehot": (x, q, v, src[sub], dst[sub], mask[sub], SEGMENT_ONEHOT_DST)}
        out.segment = {}
        for backend, args in host.items():
            card = tuple(a.to(DEVICE) if torch.is_tensor(a) else a for a in args)
            want, got = ops(*args, backend), ops(*card, backend)
            for name in sorted(want):
                err = (got[name].cpu() - want[name]).abs().max().item() / max(
                    want[name].abs().max().item(), 1e-30)
                out.segment[f"{name} {backend}"] = err
                print(f"  {name} ({backend}) {tuple(got[name].shape)}: max |card - cpu| / "
                      f"max |cpu| {err:.3e} (limit {SEGMENT_RTOL})", flush=True)
                if not err <= SEGMENT_RTOL:
                    raise AssertionError(f"segment {name} ({backend}): {err:.3e}")
            ms = time_cuda(lambda: ops(*card, backend), n_iter=3, reps=3)
            out.segment[f"ms {backend}"] = ms
            print(f"  every {backend} op once on {int(card[3].numel())} edges: {ms:.3f} ms on "
                  f"the card", flush=True)
        adj = obs["adj"][0, 0]
        exact = all(torch.equal(a.cpu(), b) for a, b in zip(
            segment.dense_to_edges(adj.to(DEVICE)), segment.dense_to_edges(adj)))
        print(f"  {src.numel()} edges ({mask.float().mean().item():.4f} valid) into {n_dst} "
              f"destinations from {n_src} sources; one-hot on the {int(sub.sum())} edges into "
              f"the first {SEGMENT_ONEHOT_DST}; dense_to_edges equal: {exact}", flush=True)
        if src.numel() != UPDATE_EDGES or not exact:
            raise AssertionError(f"{src.numel()} edges (expected {UPDATE_EDGES}), "
                                 f"dense_to_edges {exact}")
    shutil.rmtree(scratch)
    return out


def env_schedule_phase(ctx):
    """``env_schedule`` (``ops/env_kernels.py``, ``csrc/env_schedule.cu``)
    against its plain version, ``torch_env._schedule_body_scatter``, on the
    card: each step of a recorded rollout (``ENV_SHAPES``: the committed 8-UBS
    policy at 40 and 512 worlds, eps 0.05; random moves on the 4-UBS map,
    DenseHotSpotV2 and swarm64, from layouts with each UBS on a GT) fed to
    both, so that one near-tie does not spread; held to
    ``env_kernels.compare_schedules`` (the same UBS and RB for every GT, rates
    within ``RATE_RTOL`` of the world's largest, any parting an interference
    tie, which is printed); a repeat bit for bit; the kernel's launches equal
    to the rollouts' env steps; the kernel timed with CUDA events and the
    plain body by host wall time beside the bound. ``ctx`` carries
    ``reset_counts`` and ``check_env``; returns the ``env_schedule`` cases."""
    from unittest import mock
    from uav_bs_ctrl_tpu_torch import serve
    from uav_bs_ctrl_tpu_torch.algos import collect
    from uav_bs_ctrl_tpu_torch.envs import maps, torch_env
    from uav_bs_ctrl_tpu_torch.ops import env_kernels
    kernel = env_kernels.schedule_and_rate
    agent, config = serve.load_policy(RUN_DIR, DEVICE)
    cases, ties_all, worst_err, worst_abs = [], [], 0.0, 0.0
    with phase(f"env_schedule against the scatter body on recorded rollouts: {ENV_SHAPES}"), \
            mock.patch.dict(maps.MAPS, {"hotspot_v2": maps.DenseHotSpotV2()}):
        for map_id, n_worlds in ENV_SHAPES:
            params = torch_env.make_params(map_id)
            gen = torch.Generator().manual_seed(n_worlds)
            pool = collect.make_layout_pool(map_id, 64, seed=1)
            states = collect.reset_worlds(params, pool, gen, n_worlds, DEVICE)
            recorded, schedule = [], torch_env._schedule

            def recording(p, d, g, prior):
                recorded.append((d.clone(), g.clone(), prior.clone()))
                return schedule(p, d, g, prior)

            n_steps = ENV_STEPS.get(map_id, params.episode_limit)
            ctx.reset_counts()
            torch_env._schedule = recording
            try:
                if map_id == config["map_id"]:
                    h0 = torch.zeros((n_worlds, params.n_ubs, agent.hidden), device=DEVICE)
                    torch_env.rollout(params, agent, states, h0, gen, n_steps, eps=EPS)
                else:        # each UBS on a GT, then one random move in four a step
                    take = torch.randperm(params.n_gts, generator=gen)[:params.n_ubs]
                    states = torch_env.reset_from_positions(
                        params, states.pos_gts[:, take.to(DEVICE)] + 20.0, states.pos_gts,
                        states.prior_gts)
                    for _ in range(n_steps):
                        moves = torch.randint(0, params.n_actions, (n_worlds, params.n_ubs),
                                              generator=gen)
                        moves[torch.rand(moves.shape, generator=gen) >= 0.25] = 0
                        states = torch_env.step(params, states, moves.to(DEVICE))[0]
            finally:
                torch_env._schedule = schedule
            torch.cuda.synchronize()
            label = f"{map_id} (N, M, R) = {(params.n_ubs, params.n_gts, params.n_rbs)}, " \
                f"{n_worlds} worlds"
            ctx.check_env(f"the recorded rollout, {label}")
            served, ties, err, abs_err = 0, [], 0.0, 0.0
            for step, (d, g, prior) in enumerate(recorded):
                rate_gt, rate_ubs, assign = kernel(params, d, g, prior, with_assignment=True)
                sched, plain_gt, plain_ubs = torch_env._schedule_body_scatter(params, d, g, prior)
                res = env_kernels.compare_schedules(
                    params, d, g, prior, (assign, rate_gt, rate_ubs),
                    (env_kernels.schedule_assignment(sched), plain_gt, plain_ubs))
                if res["faults"] or res["err"] > env_kernels.RATE_RTOL:
                    raise AssertionError(f"env_schedule, {label}, step {step}: max rate error "
                                         f"{res['err']:.3e} of the world's largest rate "
                                         f"(limit {env_kernels.RATE_RTOL}); faults "
                                         f"{res['faults'][:3]}")
                ties += [dict(t, step=step) for t in res["ties"]]
                err, abs_err = max(err, res["err"]), max(abs_err, res["abs_err"])
                served += int((assign >= 0).sum())
                if step == 0:
                    again = kernel(params, d, g, prior, with_assignment=True)
                    if not all(torch.equal(a, b) for a, b in
                               zip(again, (rate_gt, rate_ubs, assign))):
                        raise AssertionError(f"env_schedule, {label}: a repeat differs")
            d, g, prior = recorded[len(recorded) // 2]
            ms = time_cuda(lambda: kernel(params, d, g, prior))
            plain_ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch_env._schedule_body_scatter(params, d, g, prior)
                torch.cuda.synchronize()
                plain_ms.append((time.perf_counter() - t0) * 1e3)
            nbytes = (d.numel() + g.numel()) * 4 + prior.numel() * 8 + \
                n_worlds * (params.n_gts + params.n_ubs) * 4
            bound_ms, bound_by = bound(0, nbytes, F32_PEAK_FLOPS)
            staged = env_kernels.staged(params.n_ubs, params.n_gts)
            case = dict(inputs=label, steps=len(recorded), ms=ms,
                        ms_per_gt=ms / params.n_gts, plain_ms=statistics.median(plain_ms),
                        bound_ms=bound_ms, bound_by=bound_by, max_rel_err=err,
                        max_abs_err=abs_err, ties=len(ties), staged=staged,
                        served_share=served / (len(recorded) * n_worlds * params.n_gts))
            cases.append(case)
            ties_all += ties
            worst_err, worst_abs = max(worst_err, err), max(worst_abs, abs_err)
            print(f"  {label}: {len(recorded)} steps, {100 * case['served_share']:.1f} % of "
                  f"the GTs served; max rate error {err:.3e} of the world's largest "
                  f"({abs_err:.3e} Mbps), near-ties {len(ties)} {ties[:3]}; a repeat bit for "
                  f"bit; {'staged in shared memory' if staged else 'read from device memory'}"
                  f"; kernel {ms:.4f} ms ({1e3 * case['ms_per_gt']:.3f} us a GT), plain "
                  f"{case['plain_ms']:.2f} ms host wall, bound {bound_ms:.6f} ms ({bound_by}: "
                  f"{nbytes} bytes)", flush=True)
        ctx.reset_counts()             # the comparisons' launches are not the main path's
    return SimpleNamespace(cases=cases, ties=ties_all, err=worst_err, abs_err=worst_abs)


def per_update_launches(T):
    """#1-#5's launches in one 8-UBS TarMAC update of T steps."""
    return {"flash_gat": 0, "flash_gat_fused": 2 * (2 * T + 1), "tarmac_step": 2 * T + 1,
            "flash_gat_fused_bwd": 2 * T, "tarmac_step_bwd": T}


def fused_launches(T):
    """#1-#5's launches in each rank of the dp fused trainer's warm-up and
    iteration (``PARALLEL_FUSED``): the updates, and one policy forward a
    step of the warm-up and of each sub-iteration's collection."""
    want = {k: PARALLEL_FUSED["updates_per_iter"] * v for k, v in per_update_launches(T).items()}
    steps = (1 + PARALLEL_FUSED["interleave"]) * T
    want["flash_gat_fused"] += 2 * steps
    want["tarmac_step"] += steps
    return want


def fused_env_calls(T):
    """env_schedule's calls in each rank of the dp fused trainer's warm-up and
    iteration (``PARALLEL_FUSED``): one an env step of each collection, the
    reset's included."""
    return (1 + PARALLEL_FUSED["interleave"]) * (T + 1)


def rank_lines(ranks, ms_key="ms", what="sharded update"):
    """One line a rank: its #1-#5 launches, ms per ``what`` and its collectives' share."""
    for r, x in enumerate(ranks):
        coll = x["collectives"] if "collectives" in x else dict(ms=x["collective_ms"],
                                                                calls=x["collective_calls"])
        print(f"  rank {r}: launches {x['launches']}; {x[ms_key]:.2f} ms per {what}, of it "
              f"{coll['ms']:.2f} ms in {coll['calls']} collectives "
              f"({100 * coll['ms'] / x[ms_key]:.1f} %)", flush=True)


def summed(ranks):
    return {k: sum(x["launches"][k] for x in ranks) for k in ranks[0]["launches"]}


def rank_launches(want, split=False):
    """A rank's launches (``parallel.workers.counts``: #1-#5 and the split
    #4/#5) from ``want``, #1-#5's: with ``split`` (an mp rank's update through
    the kernels) #4's launches are the column split's forward pair and #5's
    its backward pair."""
    out = dict(want, **dict.fromkeys(SPLIT_KERNELS, 0))
    if split:
        for name, whole in SPLIT_KERNELS.items():
            out[name] = want[whole]
        out.update(tarmac_step=0, tarmac_step_bwd=0)
    return out


def step_cols_cost(args):
    """(operations, bytes, peak FLOP/s) of one ``tarmac_step_cols`` call: v|s|q
    and the attention whole, the GRU's products and gates on its w columns of
    each gate; x, h, adjf, the v|s|q weights and the columns of wi, wh, bi, bh
    read once, h2's columns (f32) written once."""
    x, h, adjf, wv, bv, ws, bs, wq, bq = args[:9]
    lo, hi = args[15]
    w, (rows, hid), msg, key = hi - lo, x.shape, wv.shape[1], ws.shape[1]
    edges = float((adjf > 0).sum())
    ops = (rows * 2 * 2 * hid * (msg + 2 * key) + edges * (2 * key + 3 + 2 * msg)
           + rows * 2 * 3 * w * (2 * hid + msg) + rows * w * 10)
    nbytes = x.element_size() * (sum(t.numel() for t in args[:9]) + 3 * w * (2 * hid + msg + 2)) \
        + 4 * rows * w
    return ops, nbytes, step_peak(x.dtype)


def step_head_cost(args):
    """(operations, bytes, peak FLOP/s) of one ``tarmac_step_head`` call: the
    head's sums; h2 (f32) and the head's weights read once, q and h2 written."""
    h2f, wo, bo, wvh, bvh = args[:5]
    rows, hid = h2f.shape
    n_act = wo.shape[1]
    ops = rows * 2 * hid * (n_act + 1) + rows * (n_act + 3)
    nbytes = 4 * h2f.numel() + wo.element_size() * (
        sum(t.numel() for t in args[1:5]) + rows * (n_act + hid))
    return ops, nbytes, step_peak(wo.dtype)


def step_bwd_cols_cost(args):
    """(operations, bytes, peak FLOP/s) of one ``tarmac_step_bwd_cols`` call:
    the recompute (v|s|q and the attention whole, the GRU on the w columns),
    the head's dh2 and the GRU backward on the columns, and the products of
    dgi and dgh of the columns into full-width partials of dx, dc and dh;
    inputs read once, ``red`` (f32) written once."""
    x, h, adjf, wv, bv, ws, bs, wq, bq = args[:9]
    lo, hi = args[22]
    w, (rows, hid), msg, key, n_act = hi - lo, x.shape, wv.shape[1], ws.shape[1], \
        args[13].shape[1]
    edges = float((adjf > 0).sum())
    gru = rows * 2 * 3 * w * (2 * hid + msg)
    ops = (rows * 2 * 2 * hid * (msg + 2 * key) + edges * (2 * key + 3 + 2 * msg) + 2 * gru
           + rows * w * (2 * (n_act + 1) + 22))
    nbytes = x.element_size() * (sum(t.numel() for t in args[:9]) + 3 * w * (2 * hid + msg + 2)
                                 + w * (n_act + 1) + args[17].numel() + args[18].numel()) \
        + 4 * rows * (2 * hid + msg)
    return ops, nbytes, step_peak(x.dtype)


def step_bwd_rest_cost(args):
    """(operations, bytes, peak FLOP/s) of one ``tarmac_step_bwd_rest`` call:
    the attention backward, dx += [dv|ds|dq] [wv|ws|wq]^T, the v|s|q weight
    gradients whole and the columns' share of the GRU's and the head's; red
    and the first half's per-row scratch (f32) read once, with x, h, adjf and
    the v|s|q weights; dx, dh and the gradients' entries it computes written
    once."""
    x, h, adjf, wv, bv, ws, bs, wq, bq = args[:9]
    lo, hi = args[22]
    w, (rows, hid), msg, key, n_act = hi - lo, x.shape, wv.shape[1], ws.shape[1], \
        args[13].shape[1]
    edges = float((adjf > 0).sum())
    vsq = rows * 2 * 2 * hid * (msg + 2 * key)
    ops = (edges * (4 * msg + 4 * key + 4) + vsq // 2 + vsq + rows * 2 * 3 * w * (2 * hid + msg)
           + rows * 2 * w * (n_act + 1) + rows * (6 * w + msg + 2 * key + n_act + 1))
    grads = (2 * hid + 1) * (msg + 2 * key) + 3 * w * (2 * hid + msg + 2) + w * (n_act + 1) \
        + n_act + 1
    nbytes = 4 * (args[17].numel() + rows * (11 * w + 3 * msg + 4 * key + n_act + 1)) \
        + x.element_size() * (x.numel() + h.numel() + adjf.numel() + wv.numel() + ws.numel()
                              + wq.numel() + 2 * rows * hid + grads)
    return ops, nbytes, step_peak(x.dtype)


def split_step(args, a, dueling, cols, plain=False):
    """The column-split wrappers (``plain``: their plain versions) over
    simulated ranks on one device: h2's columns gathered, the head; each
    rank's backward from ``red`` summed over the ranks (a copy each, as an
    all-reduce gives it). Returns ``((q, h2), [each rank's (dx, dh, 14
    gradients)])``."""
    from uav_bs_ctrl_tpu_torch.ops import step_kernels as sk
    fn = lambda name: getattr(sk, name + ("_plain" if plain else ""))
    h2f = torch.cat([fn("tarmac_step_cols")(*args[:13], a, 16, c) for c in cols], 1)
    out = fn("tarmac_step_head")(h2f, *args[13:17], dueling)
    halves = [fn("tarmac_step_bwd_cols")(*args, a, 16, dueling, c) for c in cols]
    red = sum(r for r, _ in halves)
    return out, [fn("tarmac_step_bwd_rest")(*args[:17], red.clone(), saved, a, 16, dueling, c)
                 for (_, saved), c in zip(halves, cols)]


def split_entry_errs(args, a, dueling, cols, what):
    """Each column-split entry point against its plain version on the same
    inputs, for every simulated rank of ``cols``: ``tarmac_step_cols``' h2
    columns, ``tarmac_step_head``'s q and h2 (on the kernels' gathered h2),
    ``tarmac_step_bwd_cols``' ``red``, and ``tarmac_step_bwd_rest``'s dx, dh
    and 14 gradients (on the same summed ``red``, each from its own first
    half's saved tensors). Returns each entry's max |kernel - plain|; raises
    beyond ``max_err``'s tolerances (forward) or ``BWD_RTOL`` of max(1, max
    |plain|) (backward)."""
    from uav_bs_ctrl_tpu_torch.ops import step_kernels as sk
    abs_err = lambda got, want: max((g - w).abs().max().item() for g, w in zip(got, want))
    errs = {}
    h2c = [sk.tarmac_step_cols(*args[:13], a, 16, c) for c in cols]
    errs["tarmac_step_cols"] = max(
        max_err((h,), (sk.tarmac_step_cols_plain(*args[:13], a, 16, c),),
                f"{what} tarmac_step_cols {c}") for c, h in zip(cols, h2c))
    h2f = torch.cat(h2c, 1)
    errs["tarmac_step_head"] = max_err(sk.tarmac_step_head(h2f, *args[13:17], dueling),
                                       sk.tarmac_step_head_plain(h2f, *args[13:17], dueling),
                                       f"{what} tarmac_step_head")
    halves = [sk.tarmac_step_bwd_cols(*args, a, 16, dueling, c) for c in cols]
    plains = [sk.tarmac_step_bwd_cols_plain(*args, a, 16, dueling, c) for c in cols]
    for c, (red, _), (red_p, _) in zip(cols, halves, plains):
        rel_err((red,), (red_p,), f"{what} tarmac_step_bwd_cols {c}")
    errs["tarmac_step_bwd_cols"] = max(abs_err((r,), (p,)) for (r, _), (p, _) in
                                       zip(halves, plains))
    red = sum(r for r, _ in halves)
    errs["tarmac_step_bwd_rest"] = 0.0
    for c, (_, saved), (_, saved_p) in zip(cols, halves, plains):   # the rest adds into red
        got = sk.tarmac_step_bwd_rest(*args[:17], red.clone(), saved, a, 16, dueling, c)
        want = sk.tarmac_step_bwd_rest_plain(*args[:17], red.clone(), saved_p, a, 16, dueling, c)
        rel_err(got, want, f"{what} tarmac_step_bwd_rest {c}")
        errs["tarmac_step_bwd_rest"] = max(errs["tarmac_step_bwd_rest"], abs_err(got, want))
    return errs


def referee_of(ref):
    """``ref`` (an f32 learner holding a bf16 learner's weights) made its f64
    referee: net params rounded to bf16, then every module in f64, computing
    in f64 (on the plain path, as the caller runs it)."""
    for net in (ref.net, ref.target_net):
        for p in net.parameters():
            p.data = p.data.to(torch.bfloat16).double()
    for mod in (ref.mixer, ref.target_mixer):
        if mod is not None:
            mod.double()
    ref.compute_dtype = torch.float64
    return ref


def mp_split_phases(ctx):
    """The mp compute split (``parallel/mp_split.py``). First the column-split
    #4/#5 on the card at the 8-UBS update's shapes (R = 256, hidden 256, msg
    64, key 16, 9 actions): every rank of mp = 2 and 4 simulated on the one
    device against the plain split versions (f32; bf16 against their f64
    referee), the whole columns (0, H) against #4/#5 bit for bit at both
    types, and #2/#3 at a rank's heads (2 or 1 of 4, F = 64) against their
    plain versions with the body each takes; each split entry point timed
    beside its plain version and bound. Then one update of the committed
    8-UBS TarMAC+QMIX checkpoint on ``ctx.batch`` (B = 32) on dims (1, mp, 1)
    for mp = 1 (this process, a group of one), 2 and 4 (ranks sharing the
    card over gloo), f32 and bf16: each mp rank's f32 update held to the
    single rank's through :func:`check_update`'s gates, its bf16 update to
    the f64 referee's (LossQ, the mean Q, the clipped gradients) and, every
    rank's mp = 1 included, to the bench's leaf rule against the plain bf16
    path (each leaf within ``LEAF_RATIO`` x the plain path's error +
    ``BF16_TOL``) on the raw gradients, with #3's dW zeroed as a planted fault
    the rule must catch; its launches held to the split's, its recorded
    shapes to its share. Prints per rank the card's busy ms (profiler), ms per update,
    launches, heads and GRU columns, and the collectives' count and host ms.
    Returns the split entry points' record entries for the kernels line."""
    from uav_bs_ctrl_tpu_torch import serve
    from uav_bs_ctrl_tpu_torch.algos.buffer import tree_map
    from uav_bs_ctrl_tpu_torch.algos.madrqn import fused
    from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
    from uav_bs_ctrl_tpu_torch.config import make_args
    from uav_bs_ctrl_tpu_torch.envs import torch_env
    from uav_bs_ctrl_tpu_torch.ops import gat_kernels, step_kernels as sk
    from uav_bs_ctrl_tpu_torch.parallel import launch, workers
    rng = np.random.default_rng(23)
    A, H = 8, 256
    worst = dict.fromkeys(SPLIT_KERNELS, 0.0)
    timed = {}

    with phase("mp split: the column-split #4/#5 and #2/#3 at a rank's heads against their "
               "plain versions, the whole columns against #4/#5 bit for bit"):
        print(f"  {card_line()}", flush=True)
        for dueling in (False, True):
            args = tuple(step_case(rng, 32, A, H, 64, 16, 9).values())
            args += (torch.randn((32 * A, 9), device=DEVICE),
                     torch.randn((32 * A, H), device=DEVICE))
            for mp in MP_SPLITS:
                cols = [(r * H // mp, (r + 1) * H // mp) for r in range(mp)]
                what = f"split #4/#5 mp={mp} dueling={dueling}"
                entry = split_entry_errs(args, A, dueling, cols, what)
                worst.update((k, max(worst[k], v)) for k, v in entry.items())
                (q, h2), ranks = split_step(args, A, dueling, cols)
                ferr = max_err((q, h2), sk.tarmac_step_plain(*args[:17], A, 16, dueling), what)
                _, plain = split_step(args, A, dueling, cols, plain=True)
                whole = sk.tarmac_step_bwd_plain(*args, A, 16, dueling)
                shares = {8, 9, 10, 11, 12, 14}    # wi, wh, bi, bh, wo, wvh: summed over ranks
                summed_grads = [sum(x[i] for x in ranks) if i in shares else ranks[0][i]
                                for i in range(len(whole))]
                err = max(rel_err(g, p, f"{what} rank {r}") for r, (g, p) in
                          enumerate(zip(ranks, plain)))
                err = max(err, rel_err(summed_grads, whole, f"{what}, the ranks' sum"))
                args16 = tuple(t.to(torch.bfloat16) for t in args)
                out16, ranks16 = split_step(args16, A, dueling, cols)
                out64, ranks64 = split_step(tuple(t.double() for t in args16), A, dueling, cols,
                                            plain=True)
                err16 = max(referee_err(g, r) for g, r in zip(out16 + tuple(
                    t for x in ranks16 for t in x), out64 + tuple(t for x in ranks64 for t in x)))
                print(f"  {what}: each entry point's max abs err against its plain version "
                      f"on the same inputs {entry}; the joined q, h2 {ferr:.3e} against "
                      f"tarmac_step_plain; every rank's backward and their sum {err:.3e} of "
                      f"max(1, max |plain|) from the plain split versions and "
                      f"tarmac_step_bwd_plain (limit {BWD_RTOL}); bf16 "
                      f"{err16:.3e} of the f64 referee (limit {BF16_TOL})", flush=True)
                if err16 > BF16_TOL:
                    raise AssertionError(f"{what} bf16: {err16:.3e} from the referee")
            for dtype in (torch.float32, torch.bfloat16):
                a16 = tuple(t.to(dtype) for t in args)
                (q, h2), (grads,) = split_step(a16, A, dueling, [(0, H)])
                same = all(torch.equal(g.view(torch.int16 if dtype == torch.bfloat16 else
                                              torch.int32),
                                       w.view(torch.int16 if dtype == torch.bfloat16 else
                                              torch.int32))
                           for g, w in zip((q, h2, *grads),
                                           sk.tarmac_step(*a16[:17], A, 16, dueling)
                                           + sk.tarmac_step_bwd(*a16, A, 16, dueling)))
                print(f"  columns (0, {H}), {dtype}, dueling={dueling}: the split pairs' q, h2 "
                      f"and 16 gradients bit-identical to #4/#5: {same}", flush=True)
                if not same:
                    raise AssertionError("the whole columns differ from #4/#5")
        for heads, hf in ((2, 128), (1, 64)):
            for m, d, rel in ((50, 4, "seen"), (7, 2, "near")):
                c = gat_case(rng, 256, m, d, hf, heads, masked_rows=[1, 5, 255])
                fwd = (c["x"], c["w"], c["b"], c["er"], c["attn"], c["mask"], heads)
                out = gat_kernels.flash_gat_fused(*fwd)
                err = max_err(out, gat_kernels.flash_gat_fused_plain(*fwd), f"#2 {rel} H={heads}")
                g = torch.randn(out[0].shape, device=DEVICE)
                bwd = fwd[:6] + out + (g, heads, 0.2, False)
                berr = rel_err(gat_kernels.flash_gat_fused_bwd(*bwd),
                               gat_kernels.flash_gat_fused_bwd_plain(*bwd), f"#3 {rel} H={heads}")
                print(f"  a rank's heads (mp = {4 // heads}): #2/#3 '{rel}' N=256 M={m} "
                      f"{heads} head(s) of 64 ({body_of(m, hf, heads)}): #2 max abs err "
                      f"{err:.3e}, #3 max rel err {berr:.3e}", flush=True)

    with phase("mp split: the column-split #4/#5 timed at the update's R = 256"):
        print(f"  {card_line()}", flush=True)
        args = tuple(step_case(rng, 32, A, H, 64, 16, 9).values()) + (
            torch.randn((32 * A, 9), device=DEVICE), torch.randn((32 * A, H), device=DEVICE))
        for dtype in (torch.float32, torch.bfloat16):
            a16 = tuple(t.to(dtype) for t in args)
            for mp in MP_SPLITS:
                cols = (0, H // mp)
                h2f = torch.cat([sk.tarmac_step_cols(*a16[:13], A, 16, (r * H // mp,
                                                                        (r + 1) * H // mp))
                                 for r in range(mp)], 1)
                red, saved = sk.tarmac_step_bwd_cols(*a16, A, 16, True, cols)
                _, saved_plain = sk.tarmac_step_bwd_cols_plain(*a16, A, 16, True, cols)
                rest_plain = lambda *a: sk.tarmac_step_bwd_rest_plain(  # the plain first
                    *a[:18], saved_plain, *a[19:])                    # half's saved tensors
                calls = {   # the rest sums into its red: timing repeats add to red's dx
                    "tarmac_step_cols": (a16[:13] + (A, 16, cols), step_cols_cost,
                                         sk.tarmac_step_cols_plain),
                    "tarmac_step_head": ((h2f,) + a16[13:17] + (True,), step_head_cost,
                                         sk.tarmac_step_head_plain),
                    "tarmac_step_bwd_cols": (a16 + (A, 16, True, cols), step_bwd_cols_cost,
                                             sk.tarmac_step_bwd_cols_plain),
                    "tarmac_step_bwd_rest": (a16[:17] + (red, saved, A, 16, True, cols),
                                             step_bwd_rest_cost, rest_plain)}
                for name, (kargs, cost, plain) in calls.items():
                    timed.setdefault(name, []).append(time_case(
                        f"{name} {dtype} mp={mp} columns {cols}", f"R=256 mp={mp} {dtype}",
                        getattr(sk, name), plain, kargs, cost(kargs)))

    run = json.loads((RUN_DIR / "config.json").read_text())
    ckpt = serve.latest_checkpoint(RUN_DIR)
    env = torch_env.make_params(run["map_id"])
    env_info = dict(obs_shape=fused.obs_shape(env, "gnn"), state_shape=fused.state_shape(env),
                    n_actions=env.n_actions, n_agents=env.n_ubs, episode_limit=env.episode_limit)
    out_ranks = {}
    with phase(f"mp split: one update of {ckpt.name} at B = 32 on dims (1, mp, 1), mp = 1 (this "
               f"process), 2 and 4 (ranks sharing the card over gloo), f32 and bf16"):
        print(f"  {card_line()}", flush=True)
        batch = tree_map(lambda x: x.cpu().numpy(), ctx.batch)
        groups = ("net", "mixer")
        tasks = {dt: dict(cfg=dict(run["args"], compute_dtype=dt), env_info=env_info,
                          batch=batch, ckpt=str(ckpt), profile=True)
                 for dt in ("float32", "bfloat16")}
        t0 = time.perf_counter()
        spent = {}
        with tempfile.TemporaryDirectory() as tmp:      # mp = 1: this process, a group of one
            torch.distributed.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                                                 rank=0, world_size=1)
            try:
                out_ranks[1] = {dt: [workers.learner_update(0, 1, torch.device(DEVICE),
                                                            dims=(1, 1, 1), **kw)]
                                for dt, kw in tasks.items()}
            finally:
                torch.distributed.destroy_process_group()
        spent[1] = time.perf_counter() - t0
        for mp in MP_SPLITS:
            t1 = time.perf_counter()
            out_ranks[mp] = dict(zip(tasks, launch.spawn(mp, [
                (workers.learner_update, dict(kw, dims=(1, mp, 1))) for kw in tasks.values()],
                DEVICE)))
            spent[mp] = time.perf_counter() - t1
        print("  wall s, the single rank and each spawn: " + ", ".join(
            f"mp = {mp} {sec:.2f} (the first update {[round(x['ms_first']) for x in out_ranks[mp]['float32']]} "
            f"and {[round(x['ms_first']) for x in out_ranks[mp]['bfloat16']]} ms, the profiled one "
            f"{[round(x['profile_s'], 2) for dt in tasks for x in out_ranks[mp][dt]]} s)"
            for mp, sec in spent.items()), flush=True)
        names = list(out_ranks[1]["float32"][0]["grads"])
        as_ref = lambda x: (
            x["loss"], [torch.from_numpy(x["grads"][n]).to(DEVICE) for n in names],
            [torch.from_numpy(x["grads"][n]).to(DEVICE).clamp(-1.0, 1.0) if n.startswith("net.")
             else torch.from_numpy(x["grads"][n]).to(DEVICE) for n in names],
            {("" if what == "params" else "target_") + g:
             {k[len(g) + 1:]: torch.from_numpy(v).to(DEVICE)
              for k, v in x[what].items() if k.startswith(g + ".")}
             for what in ("params", "targets") for g in groups})
        single = as_ref(out_ranks[1]["float32"][0])
        T = ctx.batch["act"].shape[1]
        # the f64 referee of the bf16 update (LossQ, Q, clipped grads), and the leaf rule's
        # raw gradients: the bench's rule (each leaf within LEAF_RATIO x the plain bf16
        # path's error + BF16_TOL) before the clip. This checkpoint's raw gradients reach
        # hundreds and the clip cuts nearly every net leaf to [-1, 1]: a clipped entry near
        # the bound then errs by up to 1 of the clipped scale from a raw error of about 1 %
        # (chip_bf16_leaves.py); the bench's gradients stay inside the bound.
        args16 = make_args(dict(run["args"], compute_dtype="bfloat16"), DEVICE)
        learner16 = MultiAgentQLearner(env_info, args16, seed=0)
        learner16.load_checkpoint(ckpt)
        ref = MultiAgentQLearner(env_info, make_args(dict(run["args"]), DEVICE), seed=0)
        ref.load_checkpoint(ckpt)
        ref_loss, ref_q, ref_grads = loss_q_grads(referee_of(ref), referee_batch(ctx.batch),
                                                  False)
        ref_clipped = clip_like_update(ref, ref_grads)
        gscale = max(g.abs().max().item() for g in ref_clipped)
        cut = [n for n, g in zip(names, ref_grads) if n.startswith("net.") and g.abs().max() > 1]
        plain_leaves = leaf_errs(loss_q_grads(learner16, ctx.batch, False)[2], ref_grads, gscale)
        with zeroed_gat_dw(gat_kernels):    # the rule's power: #3's dW zeroed must fail it
            fault = leaf_errs(loss_q_grads(learner16, ctx.batch, True)[2], ref_grads, gscale)
        caught = [(n, round(k, 4)) for n, k, p in zip(names, fault, plain_leaves)
                  if k > LEAF_RATIO * p + BF16_TOL]
        print(f"  the bf16 leaf rule on the raw gradients (the clip cuts {len(cut)} of "
              f"{sum(n.startswith('net.') for n in names)} net leaves: largest raw referee entry "
              f"{max(g.abs().max().item() for g in ref_grads):.4g}), each leaf on its own scale "
              f"(max |referee|, at least {LEAF_FLOOR} of the largest clipped entry "
              f"{gscale:.4g}) against the plain bf16 path's (limit {LEAF_RATIO} x plain + "
              f"{BF16_TOL}); planted fault, #3's dW zeroed in this process's kernel update: the "
              f"rule fails on {caught}", flush=True)
        if not caught:
            raise AssertionError("the mp phase's leaf rule missed a zeroed GATv2 dW")
        worst5 = lambda errs, base: "; ".join(
            f"{names[i]} {errs[i]:.2e} vs {base[i]:.2e}"
            for i in sorted(range(len(names)), key=lambda i: -errs[i])[:5])
        del ref, learner16
        for mp in (1,) + MP_SPLITS:
            for dt in ("float32", "bfloat16"):
                ranks = out_ranks[mp][dt]
                print(f"  mp = {mp}, {dt}:", flush=True)
                for r, x in enumerate(ranks):
                    coll = x["collectives"]
                    print(f"    rank {r}: card busy {x['device_ms']} ms (profiler), "
                          f"{x['ms']:.2f} ms per update; launches {x['launches']}; #2/#3 at "
                          f"(heads, H*F) {x['shapes']['flash_gat_fused']}, the split #4/#5 on "
                          f"GRU columns {x['shapes']['tarmac_step_cols']}; {coll['calls']} "
                          f"collectives, {coll['ms']:.2f} ms host ({coll['split']})", flush=True)
                    want = rank_launches(per_update_launches(T), split=mp > 1)
                    if x["launches"] != want:
                        raise AssertionError(f"mp = {mp} {dt} rank {r}: launches "
                                             f"{x['launches']}, expected {want}")
                    if mp > 1:
                        lo, c = r * H // mp, H // mp
                        if (x["shapes"]["flash_gat_fused"] != [(4 // mp, c)] or
                                x["shapes"]["tarmac_step_cols"] != [(lo, lo + c, H)]):
                            raise AssertionError(f"mp = {mp} rank {r} ran {x['shapes']}")
                    got = as_ref(x)
                    if dt == "float32":
                        loss_err, grad_err, param_err, loose, loose_err, n_entries, _ = \
                            update_gate_errors(got, single, names, groups)
                        print(f"      against the single rank: LossQ rel diff {loss_err:.2e} "
                              f"(limit {UPDATE_LOSS_RTOL}), clipped grads {grad_err:.2e} "
                              f"(limit {UPDATE_GRAD_RTOL}), params and targets {param_err:.2e} "
                              f"where resolved (limit {UPDATE_PARAM_ATOL}; {loose} of "
                              f"{n_entries} unresolved within {loose_err:.2e})", flush=True)
                        if not (math.isfinite(x["loss"]) and loss_err <= UPDATE_LOSS_RTOL and
                                grad_err <= UPDATE_GRAD_RTOL and param_err <= UPDATE_PARAM_ATOL):
                            raise AssertionError(f"mp = {mp} rank {r}: the f32 update "
                                                 "disagrees with the single rank's")
                    else:
                        errs = {"LossQ": abs(x["loss"] - ref_loss) / max(1.0, abs(ref_loss)),
                                "mean Q": abs(x["qvals"] - ref_q.mean().item())
                                / max(1.0, ref_q.abs().max().item()),
                                "clipped grads": max(referee_err(a, b, gscale)
                                                     for a, b in zip(got[2], ref_clipped))}
                        leaves = leaf_errs(got[1], ref_grads, gscale)
                        leaf_fail = [n for n, k, p in zip(names, leaves, plain_leaves)
                                     if k > LEAF_RATIO * p + BF16_TOL]
                        print(f"      against the f64 referee: " + ", ".join(
                            f"{k} {v:.2e}" for k, v in errs.items()) + f" (limit {BF16_TOL}); "
                            f"leaves beyond {LEAF_RATIO} x the plain bf16 path's + {BF16_TOL}: "
                            f"{leaf_fail}; the worst five against the plain path's: "
                            f"{worst5(leaves, plain_leaves)}", flush=True)
                        if max(errs.values()) > BF16_TOL or leaf_fail or \
                                not math.isfinite(x["loss"]):
                            raise AssertionError(f"mp = {mp} rank {r}: the bf16 update fails "
                                                 "its referee gates")
                ctx.phase_launches[f"mp_split_{mp}_{dt}"] = summed(ranks)
        for mp in MP_SPLITS:
            print(f"  {out_ranks[mp]['float32'][0]['plan_line']}", flush=True)

    launches = out_ranks[2]["float32"][0]["launches"]
    return [{
        "name": name, "route": "cuda",
        "source": f"uav_bs_ctrl_tpu_torch/ops/csrc/{SPLIT_KERNELS[name]}.cu",
        "replaces": REPLACES[SPLIT_KERNELS[name]], "launches": launches[name],
        "max_abs_err": worst[name],
        "ms": statistics.mean(c["ms"] for c in rows),
        "plain_ms": statistics.mean(c["plain_ms"] for c in rows),
        "bound_ms": statistics.mean(c["bound_ms"] for c in rows),
        "bound_by": rows[0]["bound_by"], "library_ms": None, "cases": rows,
        "phase_launches": {k: v.get(name, 0) for k, v in ctx.phase_launches.items()}}
        for name, rows in timed.items()]


def parallel_phases(ctx):
    """Slice 14, the parallel layer on ``torch.distributed``, ranks sharing
    the one card (gloo; NCCL refuses two ranks on one GPU), spawned by
    ``parallel.launch`` after the parent built the kernels:
    ``graft_entry.dryrun_multichip(4)`` (dp = 2, mp = 2; the toy and the
    flagship 8-UBS case, each rank's sharded update held to a single-rank one
    at JAX's tolerances, #2-#5 launched in every rank of the flagship case;
    the toy's F = 8 heads take the plain path); then 2 ranks for a gp
    = 2 flagship step (both relations and the talk graph edge-partitioned,
    plain torch as JAX's, no fallback), the dp = 2 fused trainer at the
    committed 8-UBS TarMAC+QMIX run's width resumed from its checkpoint
    (``PARALLEL_FUSED``) against the single-rank trainer, and one dp = 2
    update of the checkpoint on ``ctx.batch`` (B = 32, 16 a rank) through
    :func:`check_update`'s gates against the single-rank kernel update.
    Prints the backend and, per rank, the launches, ms per sharded update and
    the collectives' share; adds each phase's launches (summed over the
    ranks) to ``ctx.phase_launches``. The dry run's flagship ranks split their
    work over mp (#2/#3 on 2 of the 4 heads, the column-split #4/#5 on 128 of
    the 256 GRU columns), so their update stays eager and says why.

    The dp = 2 fused trainer and the dp = 2 update also run as programs (CUDA
    graphs; the collectives run by the host between replays), each beside
    its eager twin in the same ranks and held to it bit for bit per rank
    (metrics, ring shard, losses, params, generators; the update's LossQ,
    ``.grad``, params, targets and AdamW state). The program trainer also
    passes the single-rank gates, and the calls of #2-#5 and env_schedule on
    the card, replays included, are counted in each rank by the profiler
    (:func:`card_launches`). Per rank: the median ms of
    ``PARALLEL_TIMED`` replayed updates against eager ones, the card's busy
    ms of one, the collectives' calls and ms, the iterations' wall seconds
    and ``Program.stats()``."""
    from uav_bs_ctrl_tpu_torch import graft_entry, serve, train
    from uav_bs_ctrl_tpu_torch.algos.buffer import tree_map
    from uav_bs_ctrl_tpu_torch.algos.madrqn import fused
    from uav_bs_ctrl_tpu_torch.parallel import launch, workers
    run = json.loads((RUN_DIR / "config.json").read_text())
    ckpt = serve.latest_checkpoint(RUN_DIR)

    with phase("parallel: graft_entry.dryrun_multichip(4), the toy and flagship-8ubs cases"):
        print(f"  {card_line()}; backend {launch.pick_backend(DEVICE, 4)}, 4 ranks on "
              f"{torch.cuda.device_count()} card(s), mesh (dp, mp, gp) "
              f"{graft_entry.mesh_dims(4)}", flush=True)
        out = graft_entry.dryrun_multichip(4, DEVICE)
        for label, ranks in out.items():
            print(f"  {label}:", flush=True)
            rank_lines(ranks)
            case = graft_entry.CASES[label]
            want = rank_launches(per_update_launches(case["T"]), split=True)
            if not case["kernels"]:          # the toy's F = 8 heads: the plain path
                want = dict.fromkeys(want, 0)
            if any(x["launches"] != want for x in ranks):
                raise AssertionError(f"{label}: expected {want} launches a rank")
            ctx.phase_launches[f"parallel_dryrun_{label}"] = summed(ranks)

    with phase(f"parallel: 2 ranks, a gp = 2 flagship step, the dp = 2 fused trainer "
               f"({PARALLEL_FUSED}) resumed from {ckpt.name}, a dp = 2 update of it at B = 32, "
               f"the trainer and the update eagerly and as programs"):
        print(f"  {card_line()}", flush=True)
        trainer_kw = dict(PARALLEL_FUSED, seed=run["seed"])
        with torch.enable_grad():
            # The eager path, whose apply_grads sees each update's raw gradients (a
            # replayed program's stay in its graph); a replay gives the same bits.
            single = train.build_trainer(RUN_DIR, DEVICE, graphs=False, **PARALLEL_FUSED)
            raws, apply = [], single.learner.apply_grads

            def apply_and_keep():          # each update's raw gradients, for the gate below
                raws.append([p.grad.detach().clone() for p in single.learner.parameters()])
                apply()

            single.learner.apply_grads = apply_and_keep
            ref_metrics = [single.run_iteration(EPS, warmup=True), single.run_iteration(EPS)]
            ref_params = [p.detach() for p in single.learner.parameters()]
            learner = train.build_trainer(RUN_DIR, DEVICE, **PARALLEL_FUSED).learner
            m = learner.backward(ctx.batch)
            raw_ref = [p.grad.detach().clone() for p in learner.parameters()]
            learner.apply_grads()
        groups = ("net", "mixer")
        names = [f"{g}.{k}" for g in groups for k, _ in getattr(learner, g).named_parameters()]
        ref = (float(m["LossQ"]), raw_ref, [p.grad.detach().clone() for p in learner.parameters()],
               learner.state_dict())
        env_info = dict(obs_shape=fused.obs_shape(single.env_params, "gnn"),
                        state_shape=fused.state_shape(single.env_params),
                        n_actions=single.env_params.n_actions,
                        n_agents=single.env_params.n_ubs, episode_limit=single.T)
        batch = tree_map(lambda x: x.cpu().numpy(), ctx.batch)
        fused_kw = dict(map_id=run["map_id"], train_kwargs=run["args"], trainer_kw=trainer_kw,
                        ckpt=str(ckpt), schedule=[(EPS, True), (EPS, False)],
                        timed=[(EPS, False)])
        update_kw = dict(cfg=dict(run["args"]), env_info=env_info, batch=batch, dims=(2, 1, 1),
                         ckpt=str(ckpt), n_timed=PARALLEL_TIMED, profile=True)
        t0 = time.perf_counter()
        gp_step, dp_fused, dp_fused_prog, dp_update, dp_update_prog = launch.spawn(2, [
            (graft_entry.run_case, dict(label="flagship-8ubs", dims=(1, 1, 2))),
            (workers.fused_train, fused_kw),
            (workers.fused_train, dict(fused_kw, graphs=True, launches=card_launches)),
            (workers.learner_update, update_kw),
            (workers.learner_update, dict(update_kw, graphs=True, launches=card_launches))],
            DEVICE)
        print(f"  backend {gp_step[0]['backend']}; the spawn and the five tasks "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        print(f"  gp = 2 flagship step (plain torch: the edge-partitioned GATv2 and TarMAC "
              f"attention run no kernel, as JAX's reach no pallas_call): LossQ "
              f"{gp_step[0]['loss']:.6f}, single-rank {gp_step[0]['loss_single']:.6f}; grads max "
              f"|diff| {max(x['grad_err'] for x in gp_step):.2e}, params "
              f"{max(x['params_err'] for x in gp_step):.2e}", flush=True)
        rank_lines(gp_step)
        ctx.phase_launches["parallel_gp_step"] = summed(gp_step)

        T = single.T
        want = rank_launches(fused_launches(T))
        print(f"  dp = 2 fused trainer: single-rank warm-up {json.dumps(ref_metrics[0])}, "
              f"iteration {json.dumps(ref_metrics[1])}", flush=True)
        # Entries whose raw gradient was resolved in every update (check_update's rule):
        # elsewhere Adam turns roundoff-level gradients into steps of up to ~3 lr.
        resolved = [torch.ones_like(p, dtype=torch.bool) for p in ref_params]
        for raw in raws:
            scale = {g: max(r.abs().max().item() for n, r in zip(names, raw)
                            if n.startswith(g + ".")) for g in groups}
            resolved = [m & (r.abs() > RESOLVED_RTOL * scale[n.split(".")[0]])
                        for m, n, r in zip(resolved, names, raw)]
        resolved = [m.cpu().numpy() for m in resolved]
        steps = fused_env_calls(T)
        for label, ranks in (("eager", dp_fused), ("programs", dp_fused_prog)):
            params_err, loose, loose_err = 0.0, 0, 0.0
            for r, x in enumerate(ranks):
                print(f"  {label}, rank {r}: warm-up {json.dumps(x['metrics'][0])}, iteration "
                      f"{json.dumps(x['metrics'][1])}; ring {x['ring']} ({x['local_rows']} "
                      f"local slots); {x['seconds']:.2f} s, {x['collectives']['ms']:.2f} ms in "
                      f"{x['collectives']['calls']} collectives; launches {x['launches']}",
                      flush=True)
                for got, ref_m in zip(x["metrics"], ref_metrics):
                    for k in ("LossQ", "EpRet") if "LossQ" in ref_m else ref_m:
                        if abs(got[k] - ref_m[k]) > PARALLEL_RTOL * abs(ref_m[k]):
                            raise AssertionError(f"dp fused ({label}) rank {r} {k}: {got[k]} "
                                                 f"vs {ref_m[k]}")
                for (name, got), want_p, ok in zip(x["params"].items(), ref_params, resolved):
                    want_p = want_p.cpu().numpy()
                    diff = np.abs(got - want_p)
                    limit = PARALLEL_ATOL + PARALLEL_PARAMS_RTOL * np.abs(want_p)
                    params_err = max(params_err, float(diff[ok].max()) if ok.any() else 0.0)
                    loose += int((~ok).sum())
                    loose_err = max(loose_err, float(diff[~ok].max()) if (~ok).any() else 0.0)
                    if (diff[ok] > limit[ok]).any():
                        raise AssertionError(f"dp fused ({label}) rank {r} param {name}: max "
                                             f"|diff| {diff[ok].max():.3e} where resolved")
                if label == "eager" and x["launches"] != want:
                    raise AssertionError(f"dp fused rank {r}: expected {want} launches")
                if label == "programs" and (x["launches"] != fused_launches(T)
                                            or x["env_calls"] != steps):
                    raise AssertionError(
                        f"dp fused programs rank {r}: calls on the card {x['launches']}, "
                        f"env_schedule {x['env_calls']}; expected {fused_launches(T)}, {steps}")
            print(f"  {label}: params max |diff| {params_err:.2e} where the raw gradient was "
                  f"resolved in both updates (limit {PARALLEL_ATOL} + {PARALLEL_PARAMS_RTOL} "
                  f"|p|); {loose // len(ranks)} entries a rank below {RESOLVED_RTOL} of their "
                  f"group's largest, which Adam moves by roundoff, differ by up to "
                  f"{loose_err:.2e}", flush=True)
        for r, (x, y) in enumerate(zip(dp_fused_prog, dp_fused)):
            hold_leaves(f"dp = 2 fused trainer, rank {r}", x, y,
                        ("metrics", "ring", "params", "replay", "losses", "generators"))
            print(f"  rank {r}: wall s, programs against eager: warm-up "
                  f"{x['iter_seconds'][0]:.3f} / {y['iter_seconds'][0]:.3f}, iteration "
                  f"{x['iter_seconds'][1]:.3f} / {y['iter_seconds'][1]:.3f} (the programs' "
                  f"captures in both), one more iteration {x['timed_seconds'][0]:.3f} / "
                  f"{y['timed_seconds'][0]:.3f}; calls on the card {x['launches']}, env_schedule "
                  f"{x['env_calls']}; programs {json.dumps(x['program_stats'])}", flush=True)
        ctx.phase_launches["parallel_fused_dp2"] = summed(dp_fused)
        ctx.phase_launches["parallel_fused_dp2_programs"] = summed(dp_fused_prog)

        for r, x in enumerate(dp_update):
            raw = [torch.from_numpy(x["grads"][n]).to(DEVICE) for n in names]
            clipped = [g.clamp(-1.0, 1.0) if n.startswith("net.") else g
                       for n, g in zip(names, raw)]
            state = {("" if what == "params" else "target_") + g:
                     {k[len(g) + 1:]: torch.from_numpy(v).to(DEVICE)
                      for k, v in x[what].items() if k.startswith(g + ".")}
                     for what in ("params", "targets") for g in groups}
            loss_err, grad_err, param_err, loose, loose_err, n_entries, _ = update_gate_errors(
                (x["loss"], raw, clipped, state), ref, names, groups)
            print(f"  dp = 2 update, rank {r}: LossQ {x['loss']:.6f}, single-rank {ref[0]:.6f} "
                  f"(rel diff {loss_err:.2e}, limit {UPDATE_LOSS_RTOL}); clipped grads "
                  f"{grad_err:.2e} of the group's largest raw gradient (limit "
                  f"{UPDATE_GRAD_RTOL}); params and targets {param_err:.2e} where resolved "
                  f"(limit {UPDATE_PARAM_ATOL}; {loose} of {n_entries} unresolved entries within "
                  f"{loose_err:.2e})", flush=True)
            if not (math.isfinite(x["loss"]) and loss_err <= UPDATE_LOSS_RTOL
                    and grad_err <= UPDATE_GRAD_RTOL and param_err <= UPDATE_PARAM_ATOL):
                raise AssertionError(f"the dp = 2 update of rank {r} disagrees with the "
                                     "single-rank kernel update")
            if x["launches"] != rank_launches(per_update_launches(T)):
                raise AssertionError(f"dp update rank {r}: launches {x['launches']}")
        rank_lines(dp_update)
        ctx.phase_launches["parallel_update_dp2"] = summed(dp_update)
        one = per_update_launches(T)
        for r, (x, y) in enumerate(zip(dp_update_prog, dp_update)):
            if not x["captures"] or x["programs"] != ["('grads', True)", "step"]:
                raise AssertionError(f"dp update rank {r}: programs {x['programs']}, captures "
                                     f"{x['captures']} ({x['captures_reason']})")
            if (x["loss"], x["qvals"]) != (y["loss"], y["qvals"]):
                raise AssertionError(f"dp update rank {r}: LossQ, QVals {x['loss']}, "
                                     f"{x['qvals']} on programs, {y['loss']}, {y['qvals']} eager")
            hold_leaves(f"dp = 2 update, rank {r}", x, y,
                        ("after_grads", "params", "targets", "adam"))
            if x["launches"] != rank_launches(one) or x["timed_calls"] != one:
                raise AssertionError(f"dp update programs rank {r}: launches {x['launches']} "
                                     f"(the first call), {x['timed_calls']} on the card in a "
                                     f"replay; expected {one}")
            print(f"  dp = 2 update, rank {r}: median of {PARALLEL_TIMED} updates "
                  f"{x['ms']:.2f} ms replayed, {y['ms']:.2f} ms eager; the card busy "
                  f"{busy_text(x['device_ms'])} / {busy_text(y['device_ms'])}; the collectives "
                  f"{x['collectives']['calls']} calls, {x['collectives']['ms']:.2f} ms / "
                  f"{y['collectives']['calls']} calls, {y['collectives']['ms']:.2f} ms; the "
                  f"first call (eager, then the captures) {x['ms_first']:.2f} ms; programs "
                  f"{json.dumps(x['program_stats'])}", flush=True)
        ctx.phase_launches["parallel_update_dp2_programs"] = summed(
            [dict(x, launches=x["timed_calls"]) for x in dp_update_prog])
        del single, learner


def busy_text(ms):
    """A profiler's busy ms as printed: "not measured" where it saw none."""
    return "not measured" if ms is None else f"{ms:.2f} ms"


def hold_leaves(what, got, want, keys):
    """Raise unless the results ``got`` and ``want`` (trees of dicts and
    lists of numpy arrays and numbers) are equal bit for bit under ``keys``."""
    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            items = [(f"{prefix}{key}.", sub) for key, sub in tree.items()]
        elif isinstance(tree, (list, tuple)):
            items = [(f"{prefix}{i}.", sub) for i, sub in enumerate(tree)]
        else:
            return {prefix: np.asarray(tree)}
        return {k: v for path, sub in items for k, v in leaves(sub, path).items()}

    bad = []
    for key in keys:
        a, b = leaves(got[key], f"{key}."), leaves(want[key], f"{key}.")
        bad += sorted(a.keys() ^ b.keys())
        bad += [k for k in a.keys() & b.keys() if a[k].dtype != b[k].dtype
                or a[k].shape != b[k].shape or a[k].tobytes() != b[k].tobytes()]
    if bad:
        raise AssertionError(f"{what}: the programs differ from the eager path in {len(bad)} "
                             f"leaves: {bad[:8]}")
    print(f"  {what}: the programs equal the eager path bit for bit ({', '.join(keys)})",
          flush=True)


# The programs (graph_phases): each CUDA-graph path held to its eager twin, bit for bit.
GRAPH_SCHEDULES = ("per_step", "hoisted")
GRAPH_TRAINER = {}        # build_trainer's sizes for the full iteration: the run's own
GRAPH_DISC_TRAINER = dict(updates_per_iter=4, interleave=2, capacity_chunks=2 * N_WORLDS)
GRAPH_SERVE_WORLDS = (N_WORLDS, 512)
ADAMW_PARAM_ULPS = 0      # the update against one through torch's own AdamW: the params' ulps
                          # (of each leaf's largest |p|) apart; 0 on the card, bit for bit


def with_torch_adamw(learner):
    """Make ``learner``'s eager update take ``torch.optim.AdamW``'s own step
    (the learning rate set, then ``optimizer.step()``) in place of
    ``_prepare_step``/``_adamw``, whose arithmetic the port keeps; undone by
    deleting the two attributes."""
    def prepare():
        for group in learner.optimizer.param_groups:
            group["lr"] = learner.lr * learner.lr_scale
    learner._prepare_step, learner._adamw = prepare, learner.optimizer.step


def learner_bits(learner):
    """Params, targets, AdamW's state and ``.grad`` of a learner, in order, cloned."""
    out = []
    for p, t in zip(learner.parameters(), learner.target_parameters()):
        out += [p, t, p.grad] + list(learner.optimizer.state[p].values())
    return [None if x is None else x.detach().clone() for x in out]


def bits_differ(got, want):
    """The count of leaves of two lists (or dicts) of tensors that are not
    equal bit for bit (a missing leaf counts)."""
    if isinstance(got, dict):
        if got.keys() != want.keys():
            return max(len(got), len(want))
        got, want = list(got.values()), [want[k] for k in got]
    if len(got) != len(want):
        return max(len(got), len(want))
    return sum(not (a is None and b is None) and (
        a is None or b is None or a.dtype != b.dtype or not torch.equal(a, b))
        for a, b in zip(got, want))


def hold_bits(what, against="the eager path", **pairs):
    """Raise unless every ``name=(got, want)`` pair is equal bit for bit."""
    bad = {name: bits_differ(*pair) for name, pair in pairs.items()}
    bad = {k: v for k, v in bad.items() if v}
    if bad:
        raise AssertionError(f"{what}: the graph path differs from {against} in {bad}")
    print(f"  {what}: the graph path equals {against} bit for bit ({', '.join(pairs)})",
          flush=True)


def busy_ms(fn, n):
    """The card's busy ms a call of ``fn`` over ``n`` calls: the device time
    of every kernel the profiler saw (graph replays' kernels too), or None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / n if total > 0 else None


@contextlib.contextmanager
def recording_steps(record):
    """Append each env step's ``(actions, reward)`` to ``record``."""
    from uav_bs_ctrl_tpu_torch.envs import torch_env
    step = torch_env.step

    def recorded(params, state, actions):
        out = step(params, state, actions)
        record.append((actions, out[2]))
        return out

    torch_env.step = recorded
    try:
        yield
    finally:
        torch_env.step = step


_LAST_INPUTS = weakref.WeakKeyDictionary()     # a CPU rehearsal's programs' last inputs


@contextlib.contextmanager
def remembering_inputs():
    """On the CPU, keep each program's last inputs, which are what a graph's
    static buffers would hold, for :func:`stale_buffers`."""
    from uav_bs_ctrl_tpu_torch import graphs
    call = graphs.Program.__call__

    def remembered(self, *inputs):
        out = call(self, *inputs)
        _LAST_INPUTS[self] = inputs
        return out

    graphs.Program.__call__ = remembered
    try:
        yield
    finally:
        graphs.Program.__call__ = call
        _LAST_INPUTS.clear()


@contextlib.contextmanager
def stale_buffers():
    """The planted fault: a program replays without refilling its static
    buffers, so it runs on the inputs of its call before. On the card the
    refill is skipped; on the CPU each program is handed the inputs of its
    previous call, which :func:`remembering_inputs` keeps."""
    from uav_bs_ctrl_tpu_torch import graphs
    if DEVICE == "cpu":
        name, call = "__call__", graphs.Program.__call__

        def fault(self, *inputs):
            return call(self, *_LAST_INPUTS.get(self, inputs))
    else:
        name, call = "_refill", graphs.Program.__dict__["_refill"]
        fault = staticmethod(lambda cap, leaves: None)
    setattr(graphs.Program, name, fault)
    try:
        yield
    finally:
        setattr(graphs.Program, name, call)


def program_stats(*programs):
    """Captured graphs, capture seconds and pool bytes over ``programs``."""
    stats = [p.stats() for p in programs]
    return {k: sum(s[k] for s in stats) for k in ("graphs", "capture_s", "pool_bytes")}


def put_back(learner, bits):
    """Copy :func:`learner_bits`' params, targets and AdamW state back into
    the learner's own tensors, so its programs, which read those tensors,
    stay captured (``load_state_dict`` drops them)."""
    it = iter(bits)
    with torch.no_grad():
        for p, t in zip(learner.parameters(), learner.target_parameters()):
            p.copy_(next(it))
            t.copy_(next(it))
            next(it)                                   # .grad, which the update remakes
            for v in learner.optimizer.state[p].values():
                v.copy_(next(it))


def graph_phases(ctx):
    """The programs (JAX's jits) against the eager path, on the card: each
    graph path from the same state and seed as its eager twin, bit for bit.
    A program's first call for a shape runs eagerly and is then captured, so
    every comparison also holds a replay: one 8-UBS update (the committed
    epoch-200 checkpoint, ``ctx.batch`` at B = 32) at f32 and bf16 under
    ``per_step`` and ``hoisted``, its first call and a replay from the same
    state; one full fused iteration of the 8-UBS run at its own sizes (two
    warm-ups, 40 updates in 10 sub-iterations, the test episodes twice; the
    whole ring compared); ``serve.evaluate``'s first call and its replay on
    the kept program, and the 40- and 512-world served episode's actions
    and rewards on a replay; the 4-UBS DiscreteComm+QMIX trainer
    (collections and updates on pre-drawn Gumbel noise); the planted
    stale-buffer fault, which must fail the comparison. The launches: the
    eager twin's through the wrappers, the graph path's on the card
    (:func:`card_launches`, replays included), each held to the other and to
    202/100/101/50 an 8-UBS update and one env_schedule an env step. Times:
    ms an update (wall, and the card's busy ms) graph against eager; the
    iteration's wall time; ``serve.evaluate``'s first and later calls and
    served env steps/s at 40 and 512 worlds; capture seconds and graph pool
    bytes. ``ctx``: ``batch``, ``counts``, ``reset_counts``, ``check_env``.
    Returns the times."""
    with remembering_inputs() if DEVICE == "cpu" else contextlib.nullcontext():
        return _graph_phases(ctx)


def _graph_phases(ctx):
    from uav_bs_ctrl_tpu_torch import serve, train
    from uav_bs_ctrl_tpu_torch.algos import collect
    from uav_bs_ctrl_tpu_torch.algos.buffer import tree_leaves
    from uav_bs_ctrl_tpu_torch.algos.core import COMPUTE_DTYPES, apply_net
    from uav_bs_ctrl_tpu_torch.algos.madrqn import fused
    from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
    from uav_bs_ctrl_tpu_torch.config import make_args
    from uav_bs_ctrl_tpu_torch.envs import torch_env
    from uav_bs_ctrl_tpu_torch import graphs
    counts, reset_counts = ctx.counts, ctx.reset_counts
    config = json.loads((RUN_DIR / "config.json").read_text())
    env_params = torch_env.make_params(config["map_id"])
    T = env_params.episode_limit
    out = SimpleNamespace(update_ms={}, iteration_s={}, serve_steps_s={}, capture={},
                          serve_s={})
    zero = dict.fromkeys(per_update_launches(T), 0)
    # what the wrappers count in a replay: nothing on the card (it passes no wrapper); on the
    # CPU, where a rehearsal runs, a program's call is its body's
    replayed = (lambda n: n) if DEVICE == "cpu" else (lambda n: dict(zero) if
                                                        isinstance(n, dict) else 0)

    def updated(learner, batch, graphs_on, noise=None):
        """One update: its metrics, the learner's bits after, the wrappers'
        launches and the calls on the card."""
        learner.graphs = graphs_on
        reset_counts()
        with card_launches() as card, torch.enable_grad():
            metrics = learner.update_on_batch(batch, noise=noise)
        return ({k: v.clone() for k, v in metrics.items()}, learner_bits(learner), counts(),
                card.calls)

    with phase(f"graphs: one {config['map_id']} update at B = {ctx.batch['h'].shape[0]}, "
               f"graph against eager, f32 and bf16 x {' and '.join(GRAPH_SCHEDULES)}"):
        print(f"  card: {card_line()}", flush=True)
        env_info = dict(obs_shape=fused.obs_shape(env_params, "gnn"),
                        state_shape=fused.state_shape(env_params),
                        n_actions=env_params.n_actions, n_agents=env_params.n_ubs,
                        episode_limit=T)
        for dt in ("float32", "bfloat16"):
            for s in GRAPH_SCHEDULES:
                learner = MultiAgentQLearner(env_info, make_args(
                    dict(config["args"], compute_dtype=dt, bptt_encoder=s), DEVICE), seed=0)
                learner.load_checkpoint(serve.latest_checkpoint(RUN_DIR))
                snap, bits0 = learner.state_dict(), learner_bits(learner)
                first = updated(learner, ctx.batch, True)        # eager, then captured
                put_back(learner, bits0)
                got = updated(learner, ctx.batch, True)          # a replay
                learner.load_state_dict(snap)
                want = updated(learner, ctx.batch, False)
                learner.load_state_dict(snap)
                hold_bits(f"{dt} {s} update", metrics=(got[0], want[0]),
                          state=(got[1], want[1]))
                hold_bits(f"{dt} {s} update, the program's first call", metrics=(first[0],
                          want[0]), state=(first[1], want[1]))
                with_torch_adamw(learner)
                ref = updated(learner, ctx.batch, False)
                del learner._prepare_step, learner._adamw
                learner.load_state_dict(snap)
                # learner_bits: each parameter's p, target, grad, step, exp_avg, exp_avg_sq
                moved = [i for i in range(len(ref[1])) if i % 6 in (0, 1)]
                ulps = max((got[1][i] - ref[1][i]).abs().max().item()
                           / (2.0 ** -23 * max(ref[1][i].abs().max().item(), 1e-30))
                           for i in moved)
                hold_bits(f"{dt} {s} update, all but the params and targets",
                          "the update through torch.optim.AdamW's own step",
                          metrics=(got[0], ref[0]),
                          state=([x for i, x in enumerate(got[1]) if i not in moved],
                                 [x for i, x in enumerate(ref[1]) if i not in moved]))
                print(f"  {dt} {s}: the params and targets {ulps:.2f} ulps (of each leaf's "
                      f"largest) from torch's AdamW (limit {ADAMW_PARAM_ULPS})", flush=True)
                if ulps > ADAMW_PARAM_ULPS:
                    raise AssertionError(f"{dt} {s}: the update's AdamW step is not torch's")
                per = per_update_launches(T)
                if s == "hoisted":        # #2 once a relation and net, #3 once a relation
                    per.update(flash_gat_fused=4, flash_gat_fused_bwd=2)
                # eager: the wrappers' launches; the first call the same, as it runs eagerly;
                # the replay: no wrapper launch, and the same calls on the card
                if (want[2], want[3], first[2], first[3], got[2], got[3]) != \
                        (per, per, per, per, replayed(per), per):
                    raise AssertionError(
                        f"{dt} {s}: launches (wrappers, card): eager {want[2:]}, the first "
                        f"call {first[2:]}, a replay {got[2:]}; expected {per}")
                ms = {}
                for graphs_on in (False, True, True, False):
                    learner.graphs = graphs_on
                    ms.setdefault(graphs_on, []).append(ms_per_update(learner, ctx.batch, n=5))
                busy = {}
                for graphs_on in (True, False):
                    learner.graphs = graphs_on
                    with torch.enable_grad():
                        busy[graphs_on] = busy_ms(
                            lambda: learner.update_on_batch(ctx.batch), 2)
                    if graphs_on:
                        cap = program_stats(*learner._programs.values())
                    learner.load_state_dict(snap)
                out.update_ms[dt, s] = dict(graph=statistics.mean(ms[True]),
                                            eager=statistics.mean(ms[False]),
                                            graph_busy=busy[True], eager_busy=busy[False],
                                            **cap)
                r = out.update_ms[dt, s]
                print(f"  {dt} {s}: ms an update, graph {r['graph']:.3f} (runs {ms[True]}), "
                      f"eager {r['eager']:.3f} (runs {ms[False]}); the card busy "
                      f"{r['graph_busy']} and {r['eager_busy']} ms; launches {want[2]}, the "
                      f"same calls in a replay on the card; capture {cap['capture_s']:.3f} s, "
                      f"graph pool {cap['pool_bytes']} bytes", flush=True)
                del learner, snap, bits0
        gc.collect()

    with phase(f"graphs: one full fused iteration of {RUN_DIR.name} at its own sizes, graph "
               f"against eager ({train.N_WARMUPS} warm-ups, the iteration, {N_WORLDS} test "
               f"episodes twice)"):
        runs = {}
        for graphs_on in (True, False):
            with torch.enable_grad():
                tr = train.build_trainer(RUN_DIR, DEVICE, graphs=graphs_on, **GRAPH_TRAINER)
                reset_counts()
                with card_launches() if graphs_on else contextlib.nullcontext() as card:
                    t0 = time.perf_counter()
                    warm = [tr.run_iteration(EPS, warmup=True) for _ in range(train.N_WARMUPS)]
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    metrics = tr.run_iteration(EPS)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    test = [tr.evaluate(N_WORLDS, eps=EPS) for _ in range(2)]
                    t3 = time.perf_counter()
            if graphs_on:                    # the replays pass no wrapper: the card's count
                launches, env = card.calls, card.env
            else:
                launches, env = counts(), ctx.check_env("the eager iteration")
            runs[graphs_on] = SimpleNamespace(trainer=tr, warm=warm, metrics=metrics, test=test,
                                              launches=launches, env=env,
                                              times=(t1 - t0, t2 - t1, t3 - t2))
            print(f"  {'graph' if graphs_on else 'eager'}: warm-ups {t1 - t0:.3f} s, the "
                  f"iteration {t2 - t1:.3f} s, two test episodes {t3 - t2:.3f} s"
                  f"; {tr.n_worlds} worlds, "
                  f"interleave {tr.interleave}, {tr.updates_per_iter} updates at B = "
                  f"{tr.learner.batch_size}; launches {launches}, env_schedule {env}"
                  f"{' on the card' if graphs_on else ''}", flush=True)
        g, e = runs[True], runs[False]
        env_want = (train.N_WARMUPS + g.trainer.interleave + 2) * (T + 1)
        if (g.warm, g.metrics, g.launches, g.env) != (e.warm, e.metrics, e.launches, e.env) \
                or e.env != env_want or any(not np.array_equal(a[k], b[k])
                                            for a, b in zip(g.test, e.test) for k in b):
            raise AssertionError(f"graph {g.warm} {g.metrics} {g.launches} {g.env}, eager "
                                 f"{e.warm} {e.metrics} {e.launches} {e.env} (env steps "
                                 f"{env_want})")
        gt, et = g.trainer, e.trainer
        hold_bits("the iteration", ring=(tree_leaves(gt.replay), tree_leaves(et.replay)),
                  losses=([gt.last_losses], [et.last_losses]),
                  learner=(learner_bits(gt.learner), learner_bits(et.learner)),
                  generator=([gt.generator.get_state()], [et.generator.get_state()]))
        if (gt._ptr, gt._size) != (et._ptr, et._size):
            raise AssertionError("the ring's books differ")
        cap = program_stats(gt._collection, gt._episodes.program,
                            *gt.learner._programs.values())
        with torch.enable_grad():                  # every shape captured: replays only
            t0 = time.perf_counter()
            gt.run_iteration(EPS)
            torch.cuda.synchronize()
            again = time.perf_counter() - t0
        out.iteration_s = dict(graph=g.times, eager=e.times, graph_again=again, **cap)
        out.capture["iteration"] = cap
        print(f"  the iteration {g.times[1]:.3f} s on the graph path (its first calls, "
              f"captures and each graph's profiled first replay included), {e.times[1]:.3f} s "
              f"eager; the next graph iteration "
              f"{again:.3f} s; {cap['graphs']} graphs captured in {cap['capture_s']:.3f} s, "
              f"pools {cap['pool_bytes']} bytes; metrics {json.dumps(g.metrics)}", flush=True)
        del runs, g, e, gt, et, tr
        gc.collect()

    with phase(f"graphs: serve.evaluate, its first call and a replay of its kept program, "
               f"against eager; the served {config['map_id']} episode at "
               f"{' and '.join(map(str, GRAPH_SERVE_WORLDS))} worlds"):
        per_episode = dict(zero, flash_gat_fused=2 * T, tarmac_step=T)
        serve._served.clear()
        calls = {}
        for label in ("first", "kept", "eager"):
            reset_counts()
            with card_launches() if label == "kept" else contextlib.nullcontext() as card:
                t0 = time.perf_counter()
                stats = serve.evaluate(RUN_DIR, N_WORLDS, eps=EPS, seed=0, device=DEVICE,
                                       graphs=label != "eager")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if label == "kept":              # a replay: no wrapper, its calls on the card
                got = (counts(), card.calls, wrapper_counts()[0]["env_schedule"], card.env)
                want = (replayed(per_episode), per_episode, replayed(T + 1), T + 1)
            else:
                got = (counts(), ctx.check_env(f"serve.evaluate, {label}"))
                want = (per_episode, T + 1)
            if got != want:
                raise AssertionError(f"serve.evaluate, {label} call: launches {got}, "
                                     f"expected {want}")
            calls[label] = (stats, wall)
        hold_bits(f"serve.evaluate, {N_WORLDS} worlds, its first call",
                  stats=(calls["first"][0], calls["eager"][0]))
        hold_bits(f"serve.evaluate, {N_WORLDS} worlds, a replay of its kept program",
                  stats=(calls["kept"][0], calls["eager"][0]))
        kept = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve.evaluate(RUN_DIR, N_WORLDS, eps=EPS, seed=0, device=DEVICE)
            torch.cuda.synchronize()
            kept.append(time.perf_counter() - t0)
        out.serve_s = dict(first=calls["first"][1], kept=statistics.mean(kept),
                           eager=calls["eager"][1])
        print(f"  serve.evaluate at {N_WORLDS} worlds, loading included: the first call "
              f"{out.serve_s['first']:.4f} s (an eager episode, then the capture: what "
              f"serve.py's CLI makes), a later call {out.serve_s['kept']:.4f} s (runs "
              f"{[round(x, 4) for x in kept]}; the kept program's replay), eager "
              f"{out.serve_s['eager']:.4f} s", flush=True)
        serve._served.clear()
        agent, _ = serve.load_policy(RUN_DIR, DEVICE)
        policy = collect.make_policy(functools.partial(
            apply_net, agent, dtype=COMPUTE_DTYPES[config["args"]["compute_dtype"]]), "gnn")
        pool = serve.test_pool(config["map_id"], 0)
        noise_shape = lambda w: agent.noise_shape((w,), env_params.n_ubs)
        episodes = collect.EpisodeProgram(env_params, policy, pool, agent.hidden, DEVICE,
                                          noise_shape)
        record = []

        def recorded_body(draws, noise):
            record.clear()
            with recording_steps(record):
                stats = episodes._body(draws, noise)
            return stats, torch.stack([a for a, _ in record]), torch.stack([r for _, r in record])

        recorded = graphs.Program(recorded_body, DEVICE, name="recorded episode")

        def drawn(seed, n_worlds):
            return collect.draw_episode(env_params, len(pool[0]),
                                        torch.Generator().manual_seed(seed), n_worlds, EPS,
                                        noise_shape(n_worlds), DEVICE)

        for n_worlds in GRAPH_SERVE_WORLDS:
            recorded(*drawn(7, n_worlds))                      # eager, then captured
            stats_g, acts_g, rews_g = graphs.clone_tree(recorded(*drawn(0, n_worlds)))
            eager_record = []
            with recording_steps(eager_record):
                stats_e = collect.evaluate_policy(env_params, policy, pool, agent.hidden,
                                                  torch.Generator().manual_seed(0), n_worlds,
                                                  DEVICE, EPS)
            hold_bits(f"the served episode at {n_worlds} worlds, a replay",
                      stats=(stats_g, stats_e),
                      actions=([acts_g], [torch.stack([a for a, _ in eager_record])]),
                      rewards=([rews_g], [torch.stack([r for _, r in eager_record])]))
            episodes(torch.Generator().manual_seed(1), n_worlds, EPS)     # captured here
            ms = {}
            for graphs_on in (False, True, True, False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gen = torch.Generator().manual_seed(1)
                if graphs_on:
                    episodes(gen, n_worlds, EPS)
                else:
                    collect.evaluate_policy(env_params, policy, pool, agent.hidden, gen,
                                            n_worlds, DEVICE, EPS)
                torch.cuda.synchronize()
                ms.setdefault(graphs_on, []).append(time.perf_counter() - t0)
            out.serve_steps_s[n_worlds] = {
                "graph": n_worlds * T / statistics.mean(ms[True]),
                "eager": n_worlds * T / statistics.mean(ms[False])}
            print(f"  {n_worlds} worlds x {T} steps: graph {out.serve_steps_s[n_worlds]['graph']:.1f} "
                  f"env steps/s ({[round(x, 4) for x in ms[True]]} s an episode, the draws "
                  f"included; replays of a kept program), eager "
                  f"{out.serve_steps_s[n_worlds]['eager']:.1f} ({[round(x, 4) for x in ms[False]]}"
                  f" s)", flush=True)
        out.capture["episode"] = program_stats(episodes.program)
        print(f"  the episode program: {json.dumps(out.capture['episode'])}", flush=True)

        with stale_buffers():
            stale = episodes(torch.Generator().manual_seed(4), N_WORLDS, EPS)
        fresh = collect.evaluate_policy(env_params, policy, pool, agent.hidden,
                                        torch.Generator().manual_seed(4), N_WORLDS, DEVICE, EPS)
        try:
            hold_bits("the planted fault: a replay on stale draw buffers", stats=(stale, fresh))
        except AssertionError as err:
            print(f"  the planted fault fails as it must: {err}", flush=True)
        else:
            raise AssertionError("a replay on stale draw buffers passed the graph-vs-eager check")
        del episodes, recorded, agent

    with phase(f"graphs: {DISC_QMIX_DIR.name} (DiscreteComm's Gumbel noise drawn before the "
               f"replay), a warm-up and one iteration, graph against eager"):
        runs = {}
        for graphs_on in (True, False):
            with torch.enable_grad():
                tr = train.build_trainer(DISC_QMIX_DIR, DEVICE, graphs=graphs_on,
                                         **GRAPH_DISC_TRAINER)
                reset_counts()
                with card_launches() if graphs_on else contextlib.nullcontext() as card:
                    warm = tr.run_iteration(EPS, warmup=True)
                    metrics = tr.run_iteration(EPS)
                    torch.cuda.synchronize()
            runs[graphs_on] = (tr, warm, metrics) + (
                (card.calls, card.env) if graphs_on else
                (counts(), ctx.check_env("4-UBS eager")))
        (gt, *g), (et, *e) = runs[True], runs[False]
        if g != e or e[3] != (1 + gt.interleave) * (gt.T + 1):
            raise AssertionError(f"4-UBS DiscreteComm: graph {g}, eager {e} (the launches "
                                 f"on the card and through the wrappers)")
        hold_bits("the 4-UBS DiscreteComm collections and updates",
                  ring=(tree_leaves(gt.replay), tree_leaves(et.replay)),
                  learner=(learner_bits(gt.learner), learner_bits(et.learner)),
                  noise=([gt.learner.noise_generator.get_state()],
                         [et.learner.noise_generator.get_state()]))
        print(f"  {gt.n_worlds} worlds, {gt.updates_per_iter} updates in {gt.interleave} "
              f"sub-iterations at B = {gt.learner.batch_size}; metrics {json.dumps(g[1])}; "
              f"launches {g[2]}, env_schedule {g[3]} on the card, as eager", flush=True)
        with torch.enable_grad():
            with stale_buffers():
                gt.run_iteration(EPS)
            et.run_iteration(EPS)
        try:
            hold_bits("the planted fault: an iteration replayed on stale index and draw buffers",
                      learner=(learner_bits(gt.learner), learner_bits(et.learner)))
        except AssertionError as err:
            print(f"  the planted fault fails as it must: {err}", flush=True)
        else:
            raise AssertionError("an iteration on stale buffers passed the graph-vs-eager check")
        del runs, gt, et, tr
        gc.collect()
    return out


PROGRAM_VEC_CUTS = dict(steps_per_epoch=VEC_WORLDS * 50, epochs=1, replay_size=64,
                        num_test_episodes=5)   # one chunk of 32 worlds x T = 50
PROGRAM_VEC_UPDATES = 4   # the twin comparison's updates (each eager 8-UBS update about 0.25 s)


def timed_runs(fns, order=(True, False, False, True)):
    """``{key: [wall s, ...]}`` of ``fns[key]()`` in ``order``, the card idle
    before and after each call."""
    out = {}
    for key in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[key]()
        torch.cuda.synchronize()
        out.setdefault(key, []).append(time.perf_counter() - t0)
    return out


def program_phases(ctx):
    """Slice 21, the rest of JAX's single-card jits as programs, each against
    its eager twin on the card, bit for bit: exp1's fused iteration (the
    committed gnn run resumed at full width: two warm-ups, the 800-update
    iteration, the test episodes twice; then a steady-state iteration);
    both committed exp1 runs served at ``N_WORLDS`` worlds (``serve.evaluate``'s
    first call and a replay of its kept program); a ``vec_run`` chunk at the
    8-UBS run's width; ``torch_env.rollout`` of the 8-UBS policy at
    ``ROLLOUT_WORLDS`` worlds, eps ``EPS``. The launches: the eager twin's
    through the wrappers, the graph path's on the card (``card_launches``),
    each held to the other and to its formula. Times, each against the eager
    twin: an exp1 iteration, exp1's collection, vec_run's collection and the
    rollout (env steps/s). ``ctx``: ``counts``, ``reset_counts``,
    ``check_env``, ``phase_launches``. Returns the times."""
    with remembering_inputs() if DEVICE == "cpu" else contextlib.nullcontext():
        return _program_phases(ctx)


def _program_phases(ctx):
    from uav_bs_ctrl_tpu_torch import graphs, serve, train
    from uav_bs_ctrl_tpu_torch.algos import collect
    from uav_bs_ctrl_tpu_torch.algos.buffer import tree_leaves, tree_map
    from uav_bs_ctrl_tpu_torch.algos.madrqn import vec_run
    from uav_bs_ctrl_tpu_torch.envs import torch_env
    counts, reset_counts = ctx.counts, ctx.reset_counts
    zero = dict.fromkeys(counts(), 0)
    out = SimpleNamespace(exp1={}, serve={}, vec={}, rollout={})
    replayed = (lambda n: n) if DEVICE == "cpu" else (lambda n: dict(zero))

    with phase(f"programs: exp1's fused iteration, {EXP1_GNN_DIR.name} resumed at full width, "
               f"graph against eager ({train.N_WARMUPS} warm-ups, the iteration, {N_WORLDS} "
               f"test episodes twice), then a steady-state iteration"):
        print(f"  card: {card_line()}", flush=True)
        runs = {}
        for graphs_on in (True, False):
            with torch.enable_grad():
                tr = train.build_trainer(EXP1_GNN_DIR, DEVICE, graphs=graphs_on)
                reset_counts()
                with card_launches() if graphs_on else contextlib.nullcontext() as card:
                    t0 = time.perf_counter()
                    warm = [tr.run_iteration(EPS, warmup=True) for _ in range(train.N_WARMUPS)]
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    metrics = tr.run_iteration(EPS)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    test = [tr.evaluate(N_WORLDS, eps=EPS) for _ in range(2)]
                    t3 = time.perf_counter()
            launches = card.calls if graphs_on else counts()
            runs[graphs_on] = SimpleNamespace(trainer=tr, warm=warm, metrics=metrics, test=test,
                                              launches=launches, times=(t1 - t0, t2 - t1, t3 - t2))
            print(f"  {'graph' if graphs_on else 'eager'}: warm-ups {t1 - t0:.3f} s, the "
                  f"iteration {t2 - t1:.3f} s, two test episodes {t3 - t2:.3f} s; "
                  f"{tr.n_worlds} worlds, {tr.updates_per_iter} updates at B = "
                  f"{tr.learner.batch_size}; launches {launches}"
                  f"{' on the card' if graphs_on else ''}", flush=True)
        g, e = runs[True], runs[False]
        gt, et = g.trainer, e.trainer
        T, L, n_upd = gt.T, gt.L, gt.updates_per_iter
        want = dict(zero, flash_gat_fused=(train.N_WARMUPS + 1 + 2) * T + n_upd * (2 * L + 1),
                    flash_gat_fused_bwd=n_upd * L)
        ctx.phase_launches["exp1_programs"] = g.launches
        if (g.warm, g.metrics, g.launches) != (e.warm, e.metrics, e.launches) \
                or e.launches != want or any(not np.array_equal(a[k], b[k])
                                             for a, b in zip(g.test, e.test) for k in b):
            raise AssertionError(f"exp1: graph {g.warm} {g.metrics} {g.launches}, eager "
                                 f"{e.warm} {e.metrics} {e.launches} (expected {want})")
        hold_bits("exp1's iteration", ring=(tree_leaves(gt.replay), tree_leaves(et.replay)),
                  losses=([gt.last_losses], [et.last_losses]),
                  learner=(learner_bits(gt.learner), learner_bits(et.learner)),
                  generator=([gt.generator.get_state()], [et.generator.get_state()]))
        if (gt._ptr, gt._size) != (et._ptr, et._size):
            raise AssertionError("exp1: the ring's books differ")
        cap = program_stats(gt._collection, gt._episodes.program,
                            *gt.learner._programs.values())
        with torch.enable_grad():                  # every shape captured: replays only
            t0 = time.perf_counter()
            steady = gt.run_iteration(EPS)
            torch.cuda.synchronize()
            again = time.perf_counter() - t0
        collect_s = timed_runs({True: lambda: gt._collect_replayed(EPS),
                                False: lambda: et._write(et._collect(EPS)[0])})
        n_steps = gt.n_worlds * T
        out.exp1 = dict(graph=g.times, eager=e.times, graph_again=again,
                        collect_steps_s={k: n_steps / statistics.mean(v)
                                         for k, v in collect_s.items()}, **cap)
        print(f"  the iteration {g.times[1]:.3f} s on the graph path (its first calls and "
              f"captures included), {e.times[1]:.3f} s eager; the next graph iteration "
              f"{again:.3f} s (LossQ {steady['LossQ']:.5f}); {cap['graphs']} graphs captured in "
              f"{cap['capture_s']:.3f} s, pools {cap['pool_bytes']} bytes; the collection "
              f"({gt.n_worlds} x {T} steps, its ring write included) "
              f"{out.exp1['collect_steps_s'][True]:.1f} env steps/s on the graph path (runs "
              f"{[round(x, 4) for x in collect_s[True]]} s), eager "
              f"{out.exp1['collect_steps_s'][False]:.1f} ({[round(x, 4) for x in collect_s[False]]}"
              f" s); metrics {json.dumps(g.metrics)}", flush=True)
        del runs, g, e, gt, et, tr
        gc.collect()

    with phase(f"programs: the committed exp1 gnn and rnn runs served at {N_WORLDS} worlds, "
               f"serve.evaluate's first call and a replay of its kept program against eager"):
        for label, run_dir in (("gnn", EXP1_GNN_DIR), ("rnn", EXP1_RNN_DIR)):
            serve._served.clear()
            T = json.loads((run_dir / "config.json").read_text())["env_kwargs"].get(
                "episode_limit", 200)
            per_episode = dict(zero, flash_gat_fused=T if label == "gnn" else 0)
            calls = {}
            for kind in ("first", "kept", "eager"):
                reset_counts()
                with card_launches() if kind == "kept" else contextlib.nullcontext() as card:
                    t0 = time.perf_counter()
                    stats = serve.evaluate(run_dir, N_WORLDS, eps=EPS, seed=0, device=DEVICE,
                                           graphs=kind != "eager")
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                got = (counts(), card.calls) if kind == "kept" else counts()
                want = (replayed(per_episode), per_episode) if kind == "kept" else per_episode
                if got != want:
                    raise AssertionError(f"exp1 {label} served, {kind} call: launches {got}, "
                                         f"expected {want}")
                calls[kind] = (stats, wall)
            hold_bits(f"exp1 {label} served, its first call", stats=(calls["first"][0],
                                                                    calls["eager"][0]))
            hold_bits(f"exp1 {label} served, a replay of its kept program",
                      stats=(calls["kept"][0], calls["eager"][0]))
            kept = timed_runs({True: lambda: serve.evaluate(run_dir, N_WORLDS, eps=EPS, seed=0,
                                                            device=DEVICE)}, (True, True))[True]
            out.serve[label] = dict(first=calls["first"][1], kept=statistics.mean(kept),
                                    eager=calls["eager"][1],
                                    steps_s=N_WORLDS * T / statistics.mean(kept))
            print(f"  {label}: the first call {calls['first'][1]:.4f} s (loading, an eager "
                  f"episode, the capture), a later call {out.serve[label]['kept']:.4f} s "
                  f"({out.serve[label]['steps_s']:.1f} env steps/s, loading included), eager "
                  f"{calls['eager'][1]:.4f} s; launches an episode {per_episode}; TestEpRet "
                  f"{float(calls['kept'][0]['TestEpRet'].mean()):.4f}", flush=True)
        serve._served.clear()

    run_args = json.loads((RUN_DIR / "config.json").read_text())["args"]
    with phase(f"programs: a vec_run chunk at {RUN_DIR.parent.name}'s width ({VEC_WORLDS} "
               f"worlds, {PROGRAM_VEC_UPDATES} updates), graph against eager"):
        scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_programs_"))
        kw = dict(run_args, device=DEVICE, save_freq=1, **PROGRAM_VEC_CUTS)
        runs = {}
        for graphs_on in (True, False):
            reset_counts()
            with torch.enable_grad(), card_launches() as card:
                learner = vec_run.train_vectorized(
                    "8ubs", seed=0, train_kwargs=kw, n_worlds=VEC_WORLDS,
                    updates_per_chunk=PROGRAM_VEC_UPDATES, graphs=graphs_on,
                    logger_kwargs=dict(output_dir=str(scratch / str(graphs_on)),
                                       exp_name="chip_smoke_vec"))
            torch.cuda.synchronize()
            _, rows = progress_rows(scratch / str(graphs_on))
            runs[graphs_on] = (learner, [{k: v for k, v in r.items()
                                          if not k.startswith("Time") and k != "EnvStepsPerSec"}
                                         for r in rows], card.calls, card.env)
        (gl, g_rows, g_calls, g_env), (el, e_rows, e_calls, e_env) = runs[True], runs[False]
        T = gl.max_seq_len
        want = dict(zero, flash_gat_fused=2 * 2 * T + PROGRAM_VEC_UPDATES * 2 * (2 * T + 1),
                    tarmac_step=2 * T + PROGRAM_VEC_UPDATES * (2 * T + 1),
                    flash_gat_fused_bwd=PROGRAM_VEC_UPDATES * 2 * T,
                    tarmac_step_bwd=PROGRAM_VEC_UPDATES * T)
        ctx.phase_launches["vec_run_programs"] = g_calls
        print(f"  rows {g_rows}; launches on the card {g_calls} (eager {e_calls}), "
              f"env_schedule {g_env} (eager {e_env})", flush=True)
        if g_rows != e_rows or (g_calls, g_env) != (e_calls, e_env) or e_calls != want \
                or e_env != 2 * (T + 1):
            raise AssertionError(f"vec_run: graph {g_rows} {g_calls} {g_env}, eager {e_rows} "
                                 f"{e_calls} {e_env} (expected {want})")
        hold_bits("the vec_run chunk", learner=(learner_bits(gl), learner_bits(el)),
                  buffer=([torch.from_numpy(x) for x in tree_leaves(gl.buffer._storage)],
                          [torch.from_numpy(x) for x in tree_leaves(el.buffer._storage)]))
        # vec_run's collection alone, as train_vectorized runs it: the draws, the episode and
        # the host's copy of the chunk
        env_params = torch_env.make_params("8ubs")
        policy = collect.make_policy(gl._apply_net, run_args["o"])
        pool = collect.make_layout_pool("8ubs", 256, seed=0)
        pool_dev = collect.pool_on(pool, DEVICE)
        collection = graphs.Program(vec_run.collection_body, DEVICE, name="collection",
                                    extra=(env_params, policy, pool_dev, gl.net.hidden,
                                           run_args["o"]))
        gen = torch.Generator().manual_seed(3)

        def graph_chunk():
            chunk, stats = collection(*collect.draw_episode(
                env_params, 256, gen, VEC_WORLDS, EPS, None, DEVICE))
            tree_map(lambda x: x.cpu().numpy(), chunk)

        @torch.no_grad()
        def eager_chunk():
            states = collect.reset_worlds(env_params, pool, gen, VEC_WORLDS, DEVICE)
            h0 = torch.zeros((VEC_WORLDS, env_params.n_ubs, gl.net.hidden), device=DEVICE)
            chunk = collect.collect_chunk(env_params, policy, states, h0, T, gen, EPS)[0]
            tree_map(lambda x: x.cpu().numpy(), chunk)

        graph_chunk()                                       # the first call and the capture
        chunk_s = timed_runs({True: graph_chunk, False: eager_chunk})
        out.vec = {k: VEC_WORLDS * T / statistics.mean(v) for k, v in chunk_s.items()}
        print(f"  vec_run's collection ({VEC_WORLDS} x {T} steps, the host copy included): "
              f"{out.vec[True]:.1f} env steps/s on the graph path (runs "
              f"{[round(x, 4) for x in chunk_s[True]]} s), eager {out.vec[False]:.1f} "
              f"({[round(x, 4) for x in chunk_s[False]]} s)", flush=True)
        shutil.rmtree(scratch)
        del runs, gl, el, learner, collection

    with phase(f"programs: torch_env.rollout of {RUN_DIR.name} at {ROLLOUT_WORLDS} worlds, "
               f"eps {EPS}, graph against eager"):
        agent, config = serve.load_policy(RUN_DIR, DEVICE)
        params = torch_env.make_params(config["map_id"])
        T = params.episode_limit
        states = torch_env.reset(params, torch.Generator().manual_seed(0), DEVICE,
                                 ROLLOUT_WORLDS)
        h0 = torch.zeros((ROLLOUT_WORLDS, params.n_ubs, agent.hidden), device=DEVICE)
        torch_env._rollouts.clear()

        def roll(graphs_on, seed=1):
            gen = torch.Generator().manual_seed(seed)
            final, rews = torch_env.rollout(params, agent, states, h0, gen, T, EPS,
                                            graphs=graphs_on)
            return final, rews, gen.get_state()

        per_rollout = dict(zero, flash_gat_fused=2 * T, tarmac_step=T)
        res = {}
        for kind in ("first", "replay", "eager"):
            reset_counts()
            with card_launches() if kind == "replay" else contextlib.nullcontext() as card:
                res[kind] = roll(kind != "eager", 1 if kind != "first" else 2)
                torch.cuda.synchronize()
            got = (counts(), card.calls, card.env) if kind == "replay" else (
                counts(), ctx.check_env(f"rollout, {kind}"))
            want = (replayed(per_rollout), per_rollout, T) if kind == "replay" else (
                per_rollout, T)
            if got != want:
                raise AssertionError(f"rollout, {kind}: launches {got}, expected {want}")
        first_eager = roll(False, 2)
        for kind, ref in (("first", first_eager), ("replay", res["eager"])):
            hold_bits(f"rollout at {ROLLOUT_WORLDS} worlds, its {kind} call",
                      state=(list(res[kind][0]), list(ref[0])), rewards=([res[kind][1]], [ref[1]]),
                      generator=([res[kind][2]], [ref[2]]))
        roll_s = timed_runs({True: lambda: roll(True), False: lambda: roll(False)})
        out.rollout = {k: ROLLOUT_WORLDS * T / statistics.mean(v) for k, v in roll_s.items()}
        (_, kept), = torch_env._rollouts.values()
        print(f"  {ROLLOUT_WORLDS} worlds x {T} steps: {out.rollout[True]:.1f} env steps/s on "
              f"the graph path (replays of the kept program, the draws included; runs "
              f"{[round(x, 4) for x in roll_s[True]]} s), eager {out.rollout[False]:.1f} "
              f"({[round(x, 4) for x in roll_s[False]]} s); launches a rollout {per_rollout}, "
              f"one env_schedule a step; the program {json.dumps(program_stats(kept))}",
              flush=True)
        torch_env._rollouts.clear()
        del agent
    return out


BF16_NEAR_ROWS = (256, 2048, 104_448)   # #2/#3's 'near' rows: B = 32 and 256 updates, hoisted


def bf16_table_cells(rng, step_args):
    """bf16 cells of the kernel table timed with their bounds: #2 and #3 on
    'near' rows (M = 7 UBS slots of D = 2, every slot valid, as in an
    update) at ``BF16_NEAR_ROWS``, and #4/#5 on ``step_args`` (R = 4,096, the
    f32 case's inputs) rounded to bf16. Returns ``{kernel: [case, ...]}``."""
    from uav_bs_ctrl_tpu_torch.ops import gat_kernels, step_kernels
    bf16 = torch.bfloat16
    cast = lambda args: tuple(a.to(bf16) if torch.is_tensor(a) and a.is_floating_point()
                              else a for a in args)
    cases = {}
    for n in BF16_NEAR_ROWS:
        c = gat_case(rng, n, 7, 2, 256, 4, masked_rows=[], valid=1.0)
        args = cast((c["x"], c["w"], c["b"], c["er"], c["attn"], c["mask"], 4))
        out, mstat, lstat = gat_kernels.flash_gat_fused(*args)
        bwd_args = args[:6] + (out, mstat, lstat, torch.randn(out.shape, device=DEVICE).to(bf16),
                               4, 0.2, False)
        timing = dict(n_iter=5, reps=3) if n > 10_000 else {}
        for name, fn, plain, kargs, cost in (
                ("flash_gat_fused", gat_kernels.flash_gat_fused,
                 gat_kernels.flash_gat_fused_plain, args, gat_cost(args)),
                ("flash_gat_fused_bwd", gat_kernels.flash_gat_fused_bwd,
                 gat_kernels.flash_gat_fused_bwd_plain, bwd_args, gat_bwd_cost(bwd_args))):
            cases.setdefault(name, []).append(time_case(
                f"bf16 {name} 'near' N={n} M=7 D=2, all valid", f"bf16 'near' N={n}", fn, plain,
                kargs, cost, **timing))
    bwd = cast(step_args)
    fwd = bwd[:17] + bwd[19:]
    for name, fn, plain, kargs, cost in (
            ("tarmac_step", step_kernels.tarmac_step, step_kernels.tarmac_step_plain, fwd,
             step_cost(fwd)),
            ("tarmac_step_bwd", step_kernels.tarmac_step_bwd, step_kernels.tarmac_step_bwd_plain,
             bwd, step_bwd_cost(bwd))):
        cases[name] = [time_case(f"bf16 {name} R={bwd[0].shape[0]}",
                                 f"bf16 512 worlds, R={bwd[0].shape[0]}", fn, plain, kargs, cost)]
    return cases


def exp1_times(e1):
    """exp1's times: #2 and #3 at exp1's shapes with their bounds, ms per
    update (gnn through the kernels and on the plain path, rnn), the
    profiler's split of a gnn update, env steps/s of a 40-world collection,
    and from those the projected committed-config iteration and run. Returns
    ``{kernel: [case, ...]}`` for the record."""
    from uav_bs_ctrl_tpu_torch.algos import collect_subs
    from uav_bs_ctrl_tpu_torch.ops.gat_kernels import (
        flash_gat_fused, flash_gat_fused_bwd, flash_gat_fused_bwd_plain, flash_gat_fused_plain)
    fns = {"flash_gat_fused": (flash_gat_fused, flash_gat_fused_plain),
           "flash_gat_fused_bwd": (flash_gat_fused_bwd, flash_gat_fused_bwd_plain)}
    cases = {name: [] for name in fns}
    for (name, n), args in sorted(e1.cases.items()):
        fn, plain = fns[name]
        cost = gat_bwd_cost(args) if name == "flash_gat_fused_bwd" else gat_cost(args)
        what = "serving inputs" if name == "flash_gat_fused" and n == N_WORLDS else "random"
        shape = f"N={n} M={args[0].shape[1]} all valid ({what})"
        cases[name].append(time_case(f"exp1 {name} {shape}", f"exp1 {shape}", fn, plain, args,
                                     cost))
    gnn, rnn = e1.gnn_trainer, e1.rnn_trainer
    upd = {}
    for label, tr, batch, kernels in (("gnn, kernels", gnn, e1.gnn_batch, True),
                                      ("gnn, plain path", gnn, e1.gnn_batch, False),
                                      ("rnn", rnn, rnn.sample_batch(), True)):
        upd[label] = ms_per_update(tr.learner, batch, kernels, n=10)
        print(f"  one exp1 update ({label}, B={tr.learner.batch_size}, L={tr.L}): "
              f"{upd[label]:.2f} ms, {1e3 / upd[label]:.2f} updates/s", flush=True)
    snap = gnn.learner.state_dict()
    profile_updates(gnn.learner, e1.gnn_batch, 2, upd["gnn, kernels"],
                    {name: e1.per_update[name] for name in fns})
    gnn.learner.load_state_dict(snap)
    collect_s = {}
    for label, tr in (("gnn", gnn), ("rnn", rnn)):
        for _ in range(2):                          # the first untimed
            gen = torch.Generator().manual_seed(2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states = collect_subs.reset_subs_worlds(tr.env_params, tr.pool, gen, N_WORLDS,
                                                    torch.device(DEVICE))
            h0 = torch.zeros((N_WORLDS, 1, tr.args.hidden_size), device=DEVICE)
            collect_subs.collect_episode_subs(tr.env_params, tr.policy, states, h0, tr.T, tr.L,
                                              gen, EPS)
            torch.cuda.synchronize()
            collect_s[label] = time.perf_counter() - t0
        print(f"  collect_episode_subs ({label}), {N_WORLDS} worlds x {tr.T} steps: "
              f"{collect_s[label]:.3f} s, {N_WORLDS * tr.T / collect_s[label]:.1f} env steps/s",
              flush=True)
    n_upd = N_WORLDS * gnn.n_slices                 # one update per L env steps
    for label, key in (("gnn", "gnn, kernels"), ("rnn", "rnn")):
        it_s = collect_s[label] + n_upd * upd[key] / 1e3
        print(f"  projected committed-config iteration ({label}): {N_WORLDS} x {gnn.T} steps + "
              f"{n_upd} updates = {it_s:.2f} s; the run's 125 iterations (2 warm-ups) "
              f"{(125 * collect_s[label] + 123 * n_upd * upd[key] / 1e3) / 60:.1f} min",
              flush=True)
    print(f"  the gnn iteration measured in the train phase: {e1.iteration_s:.2f} s, so the "
          f"run's 123 training iterations {123 * e1.iteration_s / 60:.1f} min", flush=True)
    return cases


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    run_dirs = (RUN_DIR, DISC_DIR, DISC_QMIX_DIR, EXP2_DIR, EXP1_GNN_DIR, EXP1_RNN_DIR,
                HOST_EXP1_DIR, HOST_4UBS_DIR)
    if not (ROOT / "uav_bs_ctrl_tpu_torch").is_dir() or not all(d.is_dir() for d in run_dirs):
        print(f"chip_smoke: the uav_bs_ctrl_tpu_torch package and "
              f"{', '.join(str(d.relative_to(ROOT)) for d in run_dirs)} must sit beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from uav_bs_ctrl_tpu_torch import run_fast, serve, train
    from uav_bs_ctrl_tpu_torch.algos import collect
    from uav_bs_ctrl_tpu_torch.algos.madrqn import fused
    from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
    from uav_bs_ctrl_tpu_torch.config import make_args
    from uav_bs_ctrl_tpu_torch.utils import checkpoint
    from uav_bs_ctrl_tpu_torch.envs import torch_env
    from uav_bs_ctrl_tpu_torch.models.modules import gumbel_noise
    from uav_bs_ctrl_tpu_torch.ops import build
    from uav_bs_ctrl_tpu_torch.ops.env_kernels import schedule_and_rate
    from uav_bs_ctrl_tpu_torch.native import build as native_build
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

    # env_schedule launches once an env step (each torch_env._transmit, the reset's included)
    # of worlds on the card: its launches are held to the env steps counted here. A step
    # recorded into a graph's capture runs nothing and is not counted, as its launch is not;
    # the steps a replay runs pass no Python, and card_launches counts their env_schedule.
    env_steps = collections.Counter()
    transmit = torch_env._transmit

    def counted_transmit(params, state):
        if DEVICE == "cpu" or not torch.cuda.is_current_stream_capturing():
            env_steps[state.pos_ubs.device.type] += 1
        return transmit(params, state)

    torch_env._transmit = counted_transmit

    def reset_counts():
        for fn, _ in all_kernels.values():
            fn.launches = fn.launches_bf16 = 0
        schedule_and_rate.launches = 0
        env_steps.clear()

    def check_env(what):
        """env_schedule's launches since the last reset_counts against the env
        steps on the card since then: equal, and not 0."""
        launches, steps = schedule_and_rate.launches, env_steps[device.type]
        print(f"  env_schedule: {launches} launches over {steps} env steps on the card "
              f"({what})", flush=True)
        if launches != steps or steps == 0:
            raise AssertionError(f"env_schedule launched {launches} times over {steps} env "
                                 f"steps on the card ({what})")
        return launches

    def counts():
        return {name: fn.launches for name, (fn, _) in all_kernels.items()}

    def counts_bf16():
        return {name: fn.launches_bf16 for name, (fn, _) in all_kernels.items()}

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
        built = build.build(list(all_kernels) + ["env_schedule"])
        print(f"  the C++ env core: {native_build.build(verbose=True).relative_to(ROOT)}",
              flush=True)

    with phase("the products on the tensor cores (cuobjdump -sass)"):
        hmma = hmma_counts({k: built[k] for k in HMMA_KERNELS}, Path(build.find_nvcc()).parent)
        for name, c in hmma.items():
            print(f"  {name}: HMMA instructions in its f32 {HMMA_KERNELS[name]} kernels "
                  f"{c['f32'][1]} (of {c['f32'][0]} kernels, {c['f32'][2]} without one), in its "
                  f"bf16 ones {c['bf16'][1]} (of {c['bf16'][0]}, {c['bf16'][2]} without one)",
                  flush=True)
            if c["bf16"][2] or c["f32"][2]:
                raise AssertionError(f"{name}: every f32 and bf16 product kernel must run on "
                                     "the tensor cores")

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
            print(f"  flash_gat_fused {label} N={n} M={m} D={d} ({body_of(m)}): max abs err "
                  f"{err:.3e}", flush=True)
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
                    what = f"flash_gat_fused_bwd N={n} M={m} D={d} dx={need_dx} ({body_of(m)})"
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

    env_sched = env_schedule_phase(SimpleNamespace(reset_counts=reset_counts, check_env=check_env))

    with phase(f"serve {RUN_DIR.name}: {N_WORLDS} worlds, one episode, eps={EPS}"):
        reset_counts()
        with card_launches() as serve_card:
            t0 = time.perf_counter()
            stats = serve.evaluate(RUN_DIR, N_WORLDS, eps=EPS, seed=0, device=DEVICE)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
        serve_launches = counts()
        steps = torch_env.make_params("8ubs").episode_limit
        serve_env_launches = check_env(f"serving, {steps} steps and the reset")
        print(f"  launches on the serving path: {serve_launches} over {steps} env steps "
              f"({serve_s:.2f} s, loading and the capture included); on the card "
              f"{serve_card.calls}, env_schedule {serve_card.env}", flush=True)
        want = dict(dict.fromkeys(all_kernels, 0), flash_gat_fused=2 * steps, tarmac_step=steps)
        if serve_launches != want or serve_card.calls != want \
                or serve_card.env != serve_env_launches:
            raise AssertionError(f"expected {want} launches, got {serve_launches} from the "
                                 f"wrappers and {serve_card.calls} on the card")
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
        with card_launches() as disc_card:
            t0 = time.perf_counter()
            disc_stats = serve.evaluate(DISC_DIR, N_WORLDS, eps=EPS, seed=0, device=DEVICE,
                                        gat_backend="pallas")
            torch.cuda.synchronize()
            disc_s = time.perf_counter() - t0
        disc_launches = counts()
        disc_steps = torch_env.make_params("4ubs").episode_limit
        disc_env = check_env(f"serving, {disc_steps} steps and the reset")
        print(f"  launches on the serving path: {disc_launches} over {disc_steps} env steps "
              f"({disc_s:.2f} s, loading and the capture included); on the card "
              f"{disc_card.calls}, env_schedule {disc_card.env}", flush=True)
        want = dict(dict.fromkeys(all_kernels, 0), flash_gat=2 * disc_steps)
        if disc_launches != want or disc_card.calls != want or disc_card.env != disc_env:
            raise AssertionError(f"expected {want} launches, got {disc_launches} from the "
                                 f"wrappers and {disc_card.calls} on the card")
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
        check_env(f"serving, {steps} steps and the reset")
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
            with card_launches() as window:
                t1 = time.perf_counter()
                warm = [trainer.run_iteration(EPS, warmup=True)
                        for _ in range(train.N_WARMUPS)]
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                metrics = trainer.run_iteration(EPS)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                test = trainer.evaluate(N_WORLDS, eps=EPS)
            train_launches, train_card = counts(), window.calls
        losses = trainer.last_losses.tolist()
        print(f"  load {t1 - t0:.2f} s, {train.N_WARMUPS} warm-ups {t2 - t1:.2f} s, iteration "
              f"{t3 - t2:.2f} s (eps {EPS}; each graph's first replay profiled)", flush=True)
        print(f"  warm-up episode stats: {json.dumps(warm)}")
        print(f"  LossQ per update: {json.dumps([round(v, 4) for v in losses])}")
        print(f"  iteration: {json.dumps(metrics)}")
        print(f"  test episodes: {json.dumps({k: float(v.mean()) for k, v in test.items()})}")
        print(f"  on the training path: calls on the card {train_card}; launches by the "
              f"wrappers {train_launches} (each program's first call runs eagerly, then is "
              f"captured; its replays pass no wrapper); env_schedule {window.env} calls",
              flush=True)
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
        episodes = train.N_WARMUPS + trainer.interleave + 1
        if train_card != want or window.env != episodes * (T + 1) or not all(
                train_launches[k] for k in want if want[k]):
            raise AssertionError(f"expected {want} calls on the card, {episodes * (T + 1)} of "
                                 f"env_schedule, and a wrapper launch of each kernel; got "
                                 f"{train_card}, {window.env}, {train_launches}")

    run_config = json.loads((RUN_DIR / "config.json").read_text())
    columns, jax_rows = progress_rows(RUN_DIR)       # run_fast.py's columns, in its order
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_run_fast_"))
    phase_launches = {}

    def driven_launches(n_updates, policy_steps):
        want = {k: n_updates * v for k, v in per_update.items()}
        want["flash_gat_fused"] += 2 * policy_steps
        want["tarmac_step"] += policy_steps
        return want

    with phase(f"run_fast: a fresh start of the {run_config['map_id']} TarMAC+QMIX run, 2 epochs "
               f"of 2000 steps, {N_WORLDS} worlds, interleave {run_config['interleave']}"):
        fresh_dir = scratch / "fresh"
        with torch.enable_grad(), card_launches() as window:   # the programs replay
            t0 = time.perf_counter()
            fresh = run_fast.train_fast(
                "exp3", run_config["map_id"], seed=0, n_worlds=N_WORLDS,
                interleave=run_config["interleave"],
                train_overrides=dict(c="tarmac", mixer=True, epochs=2, steps_per_epoch=2000,
                                     update_after=2000, save_freq=1, device=DEVICE),
                logger_kwargs=dict(output_dir=str(fresh_dir), exp_name="chip_smoke_fresh"))
            torch.cuda.synchronize()
            fresh_s = time.perf_counter() - t0
        phase_launches["fresh"] = window.calls
        head, rows = progress_rows(fresh_dir)
        losses = [float(r["LossQ"]) for r in rows]
        print(f"  {fresh_s:.2f} s; rows (Epoch, TotalEnvInteracts, LossQ, AverageEpRet, "
              f"AverageTestEpRet): {[(r['Epoch'], r['TotalEnvInteracts'], r['LossQ'], r['AverageEpRet'], r['AverageTestEpRet']) for r in rows]}",
              flush=True)
        print(f"  calls on the card: {phase_launches['fresh']}", flush=True)
        ckpts = sorted(p.name for p in fresh_dir.glob("checkpoint_epoch*.pt"))
        if head != columns or [r["Epoch"] for r in rows] != ["1", "2"] \
                or [r["TotalEnvInteracts"] for r in rows] != ["2000", "4000"]:
            raise AssertionError(f"progress.txt: header {head}, rows {rows}")
        if not (math.isnan(losses[0]) and math.isfinite(losses[1])):
            raise AssertionError(f"LossQ per epoch {losses}: epoch 1 must be all warm-up "
                                 "(nan), epoch 2 finite")
        if ckpts != ["checkpoint_epoch1.pt", "checkpoint_epoch2.pt"]:
            raise AssertionError(f"checkpoints {ckpts}")
        fresh_steps = fresh.learner.optimizer.state[fresh.learner.parameters()[0]]["step"]
        if fresh_steps.item() != fresh.updates_per_iter:
            raise AssertionError(f"the fresh run took {fresh_steps.item()} updates, not "
                                 f"{fresh.updates_per_iter}")
        # a warm-up, a test, the sub-iterations, a test
        want = driven_launches(fresh.updates_per_iter, (1 + 1 + fresh.interleave + 1) * T)
        if phase_launches["fresh"] != want:
            raise AssertionError(f"expected {want} launches, got {phase_launches['fresh']}")
        del fresh

    with phase(f"run_fast: resume {RUN_DIR.name} from checkpoint_epoch200.pt for one 2000-step "
               f"epoch at its own settings"):
        resume_dir = scratch / "resume"
        resume_dir.mkdir()
        shutil.copy(RUN_DIR / "checkpoint_epoch200.pt", resume_dir)
        saved = checkpoint.load(RUN_DIR / "checkpoint_epoch200.pt")
        count0 = int(checkpoint.find_state(saved["optimizer_state_dict"],
                                           "ScaleByAdamState").args[0])
        with torch.enable_grad(), card_launches() as window:   # the programs replay
            t0 = time.perf_counter()
            resumed = run_fast.train_fast(
                run_config["exp"], run_config["map_id"], seed=run_config["seed"],
                n_worlds=run_config["n_worlds"], interleave=run_config["interleave"],
                train_overrides=dict(run_config["args"], epochs=201, steps_per_epoch=2000,
                                     device=DEVICE),
                logger_kwargs=dict(output_dir=str(resume_dir), exp_name=run_config["exp_name"]),
                resume=True)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
        phase_launches["resume"] = window.calls
        rl = resumed.learner
        step = rl.optimizer.state[rl.parameters()[0]]["step"].item()
        head, rows = progress_rows(resume_dir)
        jax_201 = next(r for r in jax_rows if r["Epoch"] == "201")
        print(f"  {resume_s:.2f} s; AdamW step {count0} -> {step:.0f}, lr_scale {rl.lr_scale}, "
              f"scheduler epoch {rl._epoch}; row: Epoch {rows[0]['Epoch']}, TotalEnvInteracts "
              f"{rows[0]['TotalEnvInteracts']}, LossQ {rows[0]['LossQ']}, AverageEpRet "
              f"{rows[0]['AverageEpRet']}, AverageTestEpRet {rows[0]['AverageTestEpRet']} (the "
              f"JAX run's epoch 201, 30,000 steps: LossQ {jax_201['LossQ']}, AverageEpRet "
              f"{jax_201['AverageEpRet']})", flush=True)
        print(f"  calls on the card: {phase_launches['resume']}", flush=True)
        if (count0, step, rl.lr_scale, rl._epoch) != (119_600, 119_600 + resumed.updates_per_iter,
                                                       0.4, 201):
            raise AssertionError(f"AdamW step {count0} -> {step}, lr_scale {rl.lr_scale}, "
                                 f"epoch {rl._epoch}")
        if head != columns or len(rows) != 1 or rows[0]["Epoch"] != "201" \
                or int(rows[0]["TotalEnvInteracts"]) != int(saved["t"]) + 2000 \
                or not math.isfinite(float(rows[0]["LossQ"])):
            raise AssertionError(f"progress.txt: header {head}, rows {rows}")
        written = resume_dir / "checkpoint_epoch201.pt"
        args = make_args(run_config["args"], DEVICE)
        env_info = dict(obs_shape=fused.obs_shape(resumed.env_params, "gnn"),
                        n_actions=resumed.env_params.n_actions,
                        n_agents=resumed.env_params.n_ubs, episode_limit=T,
                        state_shape=fused.state_shape(resumed.env_params))
        reloaded = MultiAgentQLearner(env_info, args, seed=1)
        stamp = reloaded.load_checkpoint(written)
        same = learner_bits_equal(rl, reloaded)
        print(f"  {written.name}: stamp {stamp}; a fresh learner loading it holds the "
              f"trainer's params and AdamW state bit for bit: {same}", flush=True)
        if not same or stamp != {"epoch": 201, "t": int(saved["t"]) + 2000}:
            raise AssertionError(f"{written.name} does not hold the trainer's state")
        # two warm-ups, the sub-iterations, a test
        want = driven_launches(resumed.updates_per_iter, (2 + resumed.interleave + 1) * T)
        if phase_launches["resume"] != want:
            raise AssertionError(f"expected {want} launches, got {phase_launches['resume']}")
        del resumed, reloaded
    shutil.rmtree(scratch)

    with phase("one update through the kernels against the plain path, then again bit for bit"):
        batch = trainer.sample_batch()
        snap = learner.state_dict()
        check_update(learner, batch, per_update, counts)

    def resumed_training(run_dir, per_update_of, label):
        """``train.py``'s path on a committed run: resumed with its AdamW state,
        two warm-ups and one iteration, then ``N_WORLDS`` test episodes; the
        launches checked against ``per_update_of(T)`` per update and one
        forward per policy step; then the update gates on a sampled batch.
        Returns the trainer and the batch."""
        print(f"  {card_line()}", flush=True)
        with torch.enable_grad():
            t0 = time.perf_counter()
            tr = train.build_trainer(run_dir, DEVICE)
            lr = tr.learner
            with card_launches() as card:                   # the programs replay
                t1 = time.perf_counter()
                for _ in range(train.N_WARMUPS):
                    tr.run_iteration(EPS, warmup=True)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                metrics = tr.run_iteration(EPS)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                test = tr.evaluate(N_WORLDS, eps=EPS)
            launches = card.calls
        phase_launches[label] = launches
        losses = tr.last_losses.tolist()
        print(f"  {type(lr.net).__name__}, {tr.n_worlds} worlds, interleave {tr.interleave}, "
              f"{tr.updates_per_iter} updates at B={lr.batch_size}, T={tr.T}; ring of "
              f"{tr.capacity} chunks; lr {lr.lr} x {lr.lr_scale}; AdamW resumed at step "
              f"{lr.optimizer.state[lr.parameters()[0]]['step'].item() - tr.updates_per_iter:.0f}",
              flush=True)
        print(f"  load {t1 - t0:.2f} s, {train.N_WARMUPS} warm-ups {t2 - t1:.2f} s, iteration "
              f"{t3 - t2:.2f} s (eps {EPS})", flush=True)
        print(f"  LossQ per update: {json.dumps([round(v, 4) for v in losses])}")
        print(f"  iteration: {json.dumps(metrics)}")
        print(f"  test episodes: {json.dumps({k: float(v.mean()) for k, v in test.items()})}")
        print(f"  calls on the card: {launches}", flush=True)
        if len(losses) != tr.updates_per_iter or not all(np.isfinite(losses)):
            raise AssertionError(f"expected {tr.updates_per_iter} finite LossQ values, "
                                 f"got {losses}")
        per_upd = per_update_of(tr.T)
        policy_steps = (train.N_WARMUPS + tr.interleave + 1) * tr.T
        want = {k: tr.updates_per_iter * v for k, v in per_upd.items()}
        for k, n in (("flash_gat_fused", 2), ("tarmac_step", 1)):   # per policy step
            if per_upd[k]:
                want[k] += n * policy_steps
        if launches != want:
            raise AssertionError(f"expected {want} launches, got {launches}")
        batch = tr.sample_batch()
        noise = lr.draw_noise(batch)
        check_update(lr, batch, per_upd, counts, noise)
        ms = ms_per_update(lr, batch, True, noise, n=3)
        print(f"  one update (kernels): {ms:.2f} ms, {1e3 / ms:.2f} updates/s; the iteration "
              f"{t3 - t2:.2f} s", flush=True)
        return tr, batch

    with phase(f"train {DISC_QMIX_DIR.name}: resume with the AdamW state, {train.N_WARMUPS} "
               f"warm-ups and one iteration; the update on the same Gumbel noise"):
        disc_trainer, _ = resumed_training(
            DISC_QMIX_DIR, lambda T: dict(dict.fromkeys(all_kernels, 0),
                                          flash_gat_fused=2 * (2 * T + 1),
                                          flash_gat_fused_bwd=2 * T), "disc_train")
        del disc_trainer

    with phase(f"train {EXP2_DIR.name} (the MLP encoder, TarMAC on r400): resume, "
               f"{train.N_WARMUPS} warm-ups and one iteration"):
        exp2_trainer, exp2_batch = resumed_training(
            EXP2_DIR, lambda T: dict(dict.fromkeys(all_kernels, 0), tarmac_step=2 * T + 1,
                                     tarmac_step_bwd=T), "exp2_train")
        adj_share = exp2_batch["obs"]["adj"].float().mean().item()
        print(f"  the talk graph's valid share in the sampled batch: {adj_share:.4f} "
              f"(r_comm {exp2_trainer.env_params.r_comm:g} m)", flush=True)
        if not adj_share < 1.0:
            raise AssertionError("the sampled batch's talk graph is complete: the phase does "
                                 "not exercise #4/#5 on missing edges")
        del exp2_trainer, exp2_batch

    with phase(f"run_fast: a fresh start of exp2 r400 DiscreteComm, one epoch of two "
               f"iterations, {N_WORLDS} worlds, the second with updates"):
        print(f"  {card_line()}", flush=True)
        exp2_scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_exp2_"))
        it_steps = N_WORLDS * torch_env.make_params("r400").episode_limit   # an iteration's
        iteration_s = []
        run_iteration = fused.FusedMadrqnTrainer.run_iteration

        def timed_iteration(self, eps, warmup=False):
            t0 = time.perf_counter()
            out = run_iteration(self, eps, warmup)
            torch.cuda.synchronize()
            iteration_s.append((warmup, time.perf_counter() - t0))
            return out

        fused.FusedMadrqnTrainer.run_iteration = timed_iteration
        try:
            with torch.enable_grad():
                reset_counts()
                t0 = time.perf_counter()
                exp2 = run_fast.train_fast(
                    "exp2", "r400", seed=0, n_worlds=N_WORLDS,
                    train_overrides=dict(c="disc", epochs=1, steps_per_epoch=2 * it_steps,
                                         update_after=it_steps, save_freq=1, device=DEVICE),
                    logger_kwargs=dict(output_dir=str(exp2_scratch / "run"),
                                       exp_name="chip_smoke_exp2"))
                torch.cuda.synchronize()
                exp2_s = time.perf_counter() - t0
                phase_launches["exp2_run_fast"] = counts()
        finally:
            fused.FusedMadrqnTrainer.run_iteration = run_iteration
        head, rows = progress_rows(exp2_scratch / "run")
        el = exp2.learner
        n_taken = el.optimizer.state[el.parameters()[0]]["step"].item()
        cols = ("Epoch", "TotalEnvInteracts", "LossQ", "AverageEpRet", "AverageTestEpRet")
        print(f"  {exp2_s:.2f} s; {type(el.net).__name__} with DiscreteComm; iterations "
              f"(warm-up, s): {[(w, round(t, 2)) for w, t in iteration_s]}; rows {cols}: "
              f"{[tuple(r[c] for c in cols) for r in rows]}", flush=True)
        print(f"  launches: {phase_launches['exp2_run_fast']} (the MLP encoder and "
              f"DiscreteComm have no kernel)", flush=True)
        if head != columns or [(r["Epoch"], r["TotalEnvInteracts"]) for r in rows] != \
                [("1", str(2 * it_steps))] or not math.isfinite(float(rows[0]["LossQ"])):
            raise AssertionError(f"progress.txt: header {head}, rows {rows}")
        if n_taken != exp2.updates_per_iter or [w for w, _ in iteration_s] != [True, False]:
            raise AssertionError(f"{n_taken} updates in iterations {iteration_s}")
        reloaded = MultiAgentQLearner(
            dict(obs_shape=fused.obs_shape(exp2.env_params, "mlp"),
                 state_shape=fused.state_shape(exp2.env_params),
                 n_actions=exp2.env_params.n_actions, n_agents=exp2.env_params.n_ubs,
                 episode_limit=exp2.T), exp2.args, seed=1)
        stamp = reloaded.load_checkpoint(exp2_scratch / "run" / "checkpoint_epoch1.pt")
        same = learner_bits_equal(el, reloaded)
        print(f"  checkpoint_epoch1.pt: stamp {stamp}; a fresh learner loading it holds the "
              f"trainer's params and AdamW state bit for bit: {same}", flush=True)
        if not same or stamp != {"epoch": 1, "t": 2 * it_steps}:
            raise AssertionError("checkpoint_epoch1.pt does not hold the trainer's state")
        batch2 = exp2.sample_batch()
        ms = ms_per_update(el, batch2, True, el.draw_noise(batch2), n=3)
        print(f"  one update: {ms:.2f} ms, {1e3 / ms:.2f} updates/s; the iteration with "
              f"updates {iteration_s[1][1]:.2f} s", flush=True)
        if any(phase_launches["exp2_run_fast"].values()):
            raise AssertionError(f"a kernel launched: {phase_launches['exp2_run_fast']}")
        del exp2, reloaded
        shutil.rmtree(exp2_scratch)

    e1 = exp1_phases(SimpleNamespace(rng=rng, worst=worst, counts=counts,
                                     reset_counts=reset_counts, phase_launches=phase_launches))
    host_loop = host_loop_phases(SimpleNamespace(counts=counts, reset_counts=reset_counts,
                                                 phase_launches=phase_launches))
    bench = bench_phases(SimpleNamespace(counts=counts, counts_bf16=counts_bf16,
                                         reset_counts=reset_counts))
    slice13_phases(SimpleNamespace(counts=counts, reset_counts=reset_counts,
                                   phase_launches=phase_launches, check_env=check_env))
    parallel_phases(SimpleNamespace(batch=batch, phase_launches=phase_launches))
    split_records = mp_split_phases(SimpleNamespace(batch=batch, phase_launches=phase_launches))
    graph_phases(SimpleNamespace(batch=batch, counts=counts, reset_counts=reset_counts,
                                 check_env=check_env))
    program_phases(SimpleNamespace(counts=counts, reset_counts=reset_counts,
                                   check_env=check_env, phase_launches=phase_launches))

    record = []
    with phase("times"):
        print(f"  card: {card}", flush=True)
        for cname, args in calls:
            fn, plain = kernels[cname]
            cost = step_cost(args) if cname == "tarmac_step" else gat_cost(args)
            time_case(f"serving {cname} {tuple(args[0].shape)}", "serving", fn, plain, args, cost)
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
                share = (args[3] > 0).float().mean().item()
                case = time_case(
                    f"4-UBS serving flash_gat, step {step} '{rel}' {tuple(args[0].shape)}, valid "
                    f"share {share:.4f}, {disc_launches['flash_gat'] // disc_steps} launches "
                    f"per env step", f"step {step} {rel}", flash_gat, flash_gat_plain, args,
                    flash_gat_cost(args[0], args[3], args[4]))
                timed["flash_gat"].append(case)
                flash_cases.append(dict(case, valid_share=share))
        for name, captured in bwd_calls:
            fwd_args = captured[0]
            if name == "flash_gat_fused_bwd":
                out, mstat, lstat = flash_gat_fused(*fwd_args)
                fwd_name, fwd_cost = "flash_gat_fused", gat_cost(fwd_args)
                bwd_args = fwd_args[:6] + (out, mstat, lstat, captured[1]) + fwd_args[6:] + \
                    (False,)
                bwd_cost = gat_bwd_cost(bwd_args)
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
                shape = tuple(kargs[0].shape)
                timed[kname].append(time_case(f"training {kname} {shape}", f"training {shape}",
                                              fn, plain, kargs, cost))
        # tarmac_step_bwd at 512 worlds (R = 4096), random inputs of the training width.
        c = step_case(rng, 512, A, 256, 64, 16, 9)
        big = tuple(c.values()) + (torch.randn((512 * A, 9), device=device),
                                   torch.randn((512 * A, 256), device=device), A, 16, False)
        big_fwd = big[:17] + big[19:]
        big_cases = {
            "tarmac_step_bwd": [time_case("tarmac_step_bwd (4096, 256), 512 worlds",
                                          "512 worlds, R=4096", tarmac_step_bwd,
                                          tarmac_step_bwd_plain, big, step_bwd_cost(big))],
            "tarmac_step": [time_case("tarmac_step (4096, 256), 512 worlds",
                                      "512 worlds, R=4096", tarmac_step, tarmac_step_plain,
                                      big_fwd, step_cost(big_fwd))]}
        for name, more in bf16_table_cells(rng, big).items():
            big_cases.setdefault(name, []).extend(more)
        exp1_cases = exp1_times(e1)
        # Each kernel's launches on its main path: flash_gat's the 4-UBS 'pallas'
        # serving, the others' the training path.
        path_launches = dict(train_launches, flash_gat=disc_launches["flash_gat"])
        card_path = dict(train_card, flash_gat=disc_card.calls["flash_gat"])
        for name, rows in timed.items():
            record.append({
                "name": name, "route": "cuda",
                "source": f"uav_bs_ctrl_tpu_torch/ops/csrc/{name}.cu",
                "replaces": REPLACES[name], "launches": path_launches[name],
                "card_launches": card_path[name], "max_abs_err": worst[name],
                "ms": statistics.mean(r["ms"] for r in rows),
                "plain_ms": statistics.mean(r["plain_ms"] for r in rows),
                "bound_ms": statistics.mean(r["bound_ms"] for r in rows),
                "bound_by": rows[0]["bound_by"], "library_ms": None,
                "phase_launches": {k: v[name] for k, v in phase_launches.items()}})
            if name == "flash_gat":
                record[-1]["cases"] = flash_cases
            if name in exp1_cases:
                record[-1]["cases"] = exp1_cases[name]
            if name in big_cases:
                record[-1].setdefault("cases", []).extend(big_cases[name])
            if name in host_loop.kernel_cases:
                record[-1].setdefault("cases", []).extend(host_loop.kernel_cases[name])

        learner.load_state_dict(snap)
        upd = {True: [], False: []}
        for use_kernels in (False, True, True, False):
            upd[use_kernels].append(ms_per_update(learner, batch, use_kernels))
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
                reset_counts()
                t0 = time.perf_counter()
                collect.evaluate_policy(env, pol, pool, hidden, generator, n_worlds,
                                        device, EPS)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                check_env(f"{label}, {n_worlds} worlds")
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

        record.append({
            "name": "env_schedule", "route": "cuda",
            "source": "uav_bs_ctrl_tpu_torch/ops/csrc/env_schedule.cu",
            "replaces": REPLACES["env_schedule"], "launches": serve_env_launches,
            "card_launches": serve_card.env,
            "max_abs_err": env_sched.abs_err, "max_rel_err": env_sched.err,
            **{k: env_sched.cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None, "near_ties": len(env_sched.ties), "cases": env_sched.cases})

    print(json.dumps({"kernels": record + split_records + bench.records}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
