#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``uav_bs_ctrl_tpu_torch``) on one GPU.

Run from anywhere: ``python3 chip_smoke.py``. Phases, each printed with its wall
time: the device; the nvcc build of every kernel; each kernel against its plain
PyTorch version on the card; serving the committed exp3 8-UBS TarMAC policy
(40 worlds, one 50-step episode) through the kernels, with every step's Q
checked against the plain path; and timings. Any failed phase exits non-zero
with no result line. The last line is the JSON device record.
"""

import contextlib
import faulthandler
import json
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
N_WORLDS = 40             # the run's n_worlds
EPS = 0.05                # evaluate_policy's test epsilon
DEVICE = "cuda"
REPLACES = {"flash_gat_fused": "uav_bs_ctrl_tpu/ops/pallas_kernels.py:329",
            "tarmac_step": "uav_bs_ctrl_tpu/ops/step_kernels.py:314"}


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


def gat_case(rng, n, m, d, hf, heads, masked_rows):
    f = hf // heads
    arr = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)
    mask = (rng.random((n, m)) > 0.3).astype(np.float32)
    mask[masked_rows] = 0.0
    return dict(
        x=arr(rng.normal(size=(n, m, d))),
        w=arr(rng.normal(size=(d, hf)) / np.sqrt(d)),
        b=arr(0.1 * rng.normal(size=hf)),
        er=arr(rng.normal(size=(n, hf))),
        attn=arr(rng.normal(size=(heads, f)) / np.sqrt(f)),
        mask=arr(mask))


def step_case(rng, w, a, hidden, msg, key, n_act):
    arr = lambda t: torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(DEVICE)
    lin = lambda i, o: rng.normal(size=(i, o)) / np.sqrt(i)
    adjf = (rng.random((w * a, a)) > 0.4).astype(np.float32)
    adjf[np.arange(w * a), np.arange(w * a) % a] = 1.0      # self-loops ...
    adjf[0:a, 1] = 0.0                                       # ... but world 0, agent 1 hears no one
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


def bound(ops, nbytes):
    t_ops, t_bytes = ops / F32_PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def capture_kernel_calls(agent, obs, h):
    """The (name, args) of every kernel call one policy forward makes."""
    from uav_bs_ctrl_tpu_torch.models import agents, encoders
    calls = []
    orig_gat, orig_step = encoders.flash_gat_fused, agents.tarmac_step

    def rec_gat(*args):
        calls.append(("flash_gat_fused", args))
        return orig_gat(*args)

    def rec_step(*args):
        calls.append(("tarmac_step", args))
        return orig_step(*args)

    encoders.flash_gat_fused, agents.tarmac_step = rec_gat, rec_step
    try:
        agent(obs, h)
    finally:
        encoders.flash_gat_fused, agents.tarmac_step = orig_gat, orig_step
    return calls


def training_log_test_stats(run_dir, epoch):
    lines = (run_dir / "progress.txt").read_text().splitlines()
    head = lines[0].split("\t")
    for line in lines[1:]:
        row = dict(zip(head, line.split("\t")))
        if int(float(row["Epoch"])) == epoch:
            return {k: float(v) for k, v in row.items()
                    if k in ("AverageTestEpRet", "TestFairIdx", "TestAvgGlobalUtility",
                             "TestTotalThroughput", "TestProbCollision")}
    return {}


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "uav_bs_ctrl_tpu_torch").is_dir() or not RUN_DIR.is_dir():
        print(f"chip_smoke: the uav_bs_ctrl_tpu_torch package and {RUN_DIR.relative_to(ROOT)} "
              f"must sit beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from uav_bs_ctrl_tpu_torch import serve
    from uav_bs_ctrl_tpu_torch.algos import collect
    from uav_bs_ctrl_tpu_torch.envs import torch_env
    from uav_bs_ctrl_tpu_torch.ops import build
    from uav_bs_ctrl_tpu_torch.ops.gat_kernels import flash_gat_fused, flash_gat_fused_plain
    from uav_bs_ctrl_tpu_torch.ops.step_kernels import tarmac_step, tarmac_step_plain
    kernels = {"flash_gat_fused": (flash_gat_fused, flash_gat_fused_plain),
               "tarmac_step": (tarmac_step, tarmac_step_plain)}

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
        build.build(list(kernels))

    worst = dict.fromkeys(kernels, 0.0)
    rng = np.random.default_rng(0)
    with phase("kernels against plain versions"):
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

    with phase(f"serve {RUN_DIR.name}: {N_WORLDS} worlds, one episode, eps={EPS}"):
        flash_gat_fused.launches = 0
        tarmac_step.launches = 0
        t0 = time.perf_counter()
        stats = serve.evaluate(RUN_DIR, N_WORLDS, eps=EPS, seed=0, device=DEVICE)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, (fn, _) in kernels.items()}
        steps = torch_env.make_params("8ubs").episode_limit
        print(f"  launches on the main path: {launches} over {steps} env steps "
              f"({serve_s:.2f} s, loading included)", flush=True)
        if launches != {"flash_gat_fused": 2 * steps, "tarmac_step": steps}:
            raise AssertionError(f"expected {2 * steps} flash_gat_fused and {steps} "
                                 f"tarmac_step launches, got {launches}")
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

        def checked(obs, h):
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

    record = []
    with phase("times"):
        print(f"  card: {card}", flush=True)
        for name, (fn, plain) in kernels.items():
            rows = []
            for cname, args in calls:
                if cname != name:
                    continue
                ms = time_cuda(lambda: fn(*args))
                plain_ms = time_cuda(lambda: plain(*args))
                cost = (gat_cost(args[0], args[5], args[1].shape[1], args[6])
                        if name == "flash_gat_fused" else step_cost(args))
                bound_ms, bound_by = bound(*cost)
                print(f"  {name} {tuple(args[0].shape)}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"bound {bound_ms:.5f} ms ({bound_by}: {cost[0]:.3e} ops, "
                      f"{cost[1]:.3e} bytes)", flush=True)
                rows.append((ms, plain_ms, bound_ms, bound_by))
            record.append({
                "name": name, "route": "cuda",
                "source": f"uav_bs_ctrl_tpu_torch/ops/csrc/{name}.cu",
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": worst[name],
                "ms": statistics.mean(r[0] for r in rows),
                "plain_ms": statistics.mean(r[1] for r in rows),
                "bound_ms": statistics.mean(r[2] for r in rows),
                "bound_by": rows[0][3], "library_ms": None})
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
        pool = serve.test_pool(config["map_id"], 0)
        for n_worlds in (N_WORLDS, 512):
            generator = torch.Generator().manual_seed(1)
            t0 = time.perf_counter()
            collect.evaluate_policy(env_params, agent, pool, agent.hidden, generator,
                                    n_worlds, device, EPS)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"  {n_worlds} worlds x {steps} steps with the policy in the loop: "
                  f"{dt:.3f} s, {n_worlds * steps / dt:.1f} env steps/s "
                  f"({steps / dt:.2f} batched steps/s)", flush=True)

    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
