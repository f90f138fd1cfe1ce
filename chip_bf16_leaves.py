#!/usr/bin/env python3
"""How far each gradient leaf of a bf16 update of the committed 8-UBS
TarMAC+QMIX checkpoint lies from its f64 referee, on one GPU.

    python3 chip_bf16_leaves.py [N_BATCHES]

The script resumes ``chip_smoke.RUN_DIR``'s trainer from its newest
checkpoint, runs two warm-up iterations to fill the ring, samples
``N_BATCHES`` (default 16) batches of B = 32, and takes on each the raw
gradients of one bf16 update of the checkpoint, clipped as ``apply_grads``
clips them, four ways:

- ``kernels``: the update through #2-#5 (the path a bf16 run trains on);
- ``plain``: ``use_kernels=False``, every op in bf16 (the yardstick of
  ``chip_smoke.py``'s leaf rule);
- ``ideal``: #2-#5 replaced by their plain versions computed in f32 on the
  same bf16 operands, each output rounded to bf16 once: an implementation
  independent of the kernels that rounds only where a bf16 kernel must;
- ``fault``: ``kernels`` with #3's dW zeroed (``chip_smoke.zeroed_gat_dw``).

Each leaf's error is ``chip_smoke.leaf_errs``' (max |got - referee| over
the leaf's own scale) against the f64 plain-path referee
(``chip_smoke.referee_of``, ``referee_batch``), taken three ways: on the
clipped gradients (``clipped``: the scale floor a share of the largest
clipped entry), on the raw ones (``raw``: of the largest raw entry), and on
the raw ones with the clipped gradients' floor (``raw_clipped_floor``). The
script prints, per batch, the median and largest clipped leaf error of each
way and the leaves the clip cuts (a raw referee entry beyond 1), then, for each, the leaf
rule (a leaf beyond ``LEAF_RATIO`` x the plain path's error + ``BF16_TOL``)
on the errors averaged over disjoint groups of K consecutive batches, K = 1,
2, 4: for each way the groups that fail and their leaves. It writes every
leaf's errors to ``chiprun_out/bf16_leaves.json``. The card's name and power
limit come first.
"""

import contextlib
import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

WAYS = ("kernels", "plain", "ideal", "fault")
GROUPS = (1, 2, 4)


def _f32(ts):
    return [t.float() if torch.is_tensor(t) and t.is_floating_point() else t for t in ts]


def _bf16(ts):
    return tuple(None if t is None else t.to(torch.bfloat16) for t in ts)


@contextlib.contextmanager
def ideal_kernels():
    """#2-#5 as their plain versions in f32 on the bf16 operands, the outputs
    rounded to bf16 (the softmax statistics stay f32, as the kernel's)."""
    from uav_bs_ctrl_tpu_torch.ops import gat_kernels as gk, step_kernels as sk
    saved = (gk.flash_gat_fused, gk.flash_gat_fused_bwd, sk.tarmac_step, sk.tarmac_step_bwd)

    def gat_fwd(x, w, b, er, attn, mask, heads, slope=0.2):
        out, m, l = gk.flash_gat_fused_plain(*_f32((x, w, b, er, attn, mask)), heads, slope)
        return out.to(torch.bfloat16), m, l

    def gat_bwd(x, w, b, er, attn, mask, out, m, l, g, heads, slope=0.2, need_dx=False):
        return _bf16(gk.flash_gat_fused_bwd_plain(*_f32((x, w, b, er, attn, mask, out)), m, l,
                                                  g.float(), heads, slope, need_dx))

    gk.flash_gat_fused, gk.flash_gat_fused_bwd = gat_fwd, gat_bwd
    sk.tarmac_step = lambda *a: _bf16(sk.tarmac_step_plain(*_f32(a[:17]), *a[17:]))
    sk.tarmac_step_bwd = lambda *a: _bf16(sk.tarmac_step_bwd_plain(*_f32(a[:19]), *a[19:]))
    try:
        yield
    finally:
        gk.flash_gat_fused, gk.flash_gat_fused_bwd, sk.tarmac_step, sk.tarmac_step_bwd = saved


def leaf_rule(errs, plain, names):
    """The leaves beyond ``LEAF_RATIO`` x the plain path's error + ``BF16_TOL``."""
    return [n for n, e, p in zip(names, errs, plain) if e > cs.LEAF_RATIO * p + cs.BF16_TOL]


def main():
    from uav_bs_ctrl_tpu_torch import serve, train
    from uav_bs_ctrl_tpu_torch.algos.madrqn import fused
    from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
    from uav_bs_ctrl_tpu_torch.config import make_args
    from uav_bs_ctrl_tpu_torch.envs import torch_env
    from uav_bs_ctrl_tpu_torch.ops import gat_kernels
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    n_batches = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    run = json.loads((cs.RUN_DIR / "config.json").read_text())
    ckpt = serve.latest_checkpoint(cs.RUN_DIR)
    with torch.enable_grad():
        trainer = train.build_trainer(cs.RUN_DIR, cs.DEVICE)
        for _ in range(train.N_WARMUPS):
            trainer.run_iteration(cs.EPS, warmup=True)
    batches = [trainer.sample_batch() for _ in range(n_batches)]
    del trainer
    torch.cuda.empty_cache()
    env = torch_env.make_params(run["map_id"])
    env_info = dict(obs_shape=fused.obs_shape(env, "gnn"), state_shape=fused.state_shape(env),
                    n_actions=env.n_actions, n_agents=env.n_ubs, episode_limit=env.episode_limit)
    learner = MultiAgentQLearner(
        env_info, make_args(dict(run["args"], compute_dtype="bfloat16"), cs.DEVICE), seed=0)
    learner.load_checkpoint(ckpt)
    names = [f"{g}.{k}" for g, mod in (("net", learner.net), ("mixer", learner.mixer))
             for k, _ in mod.named_parameters()]
    print(f"set-up {time.perf_counter() - t0:.1f} s: {n_batches} batches of B = "
          f"{batches[0]['act'].shape[0]}, {len(names)} leaves", flush=True)
    ways = {"kernels": (contextlib.nullcontext, True), "plain": (contextlib.nullcontext, False),
            "ideal": (ideal_kernels, True),
            "fault": (lambda: cs.zeroed_gat_dw(gat_kernels), True)}
    kinds = {"clipped": "clipped", "raw": "raw", "raw_clipped_floor": "raw"}   # grads used
    errs = {kind: {w: [] for w in WAYS} for kind in kinds}
    for i, batch in enumerate(batches):
        ref = MultiAgentQLearner(env_info, make_args(dict(run["args"]), cs.DEVICE), seed=0)
        ref.load_checkpoint(ckpt)
        ref_grads = cs.loss_q_grads(cs.referee_of(ref), cs.referee_batch(batch), False)[2]
        refs = {"clipped": cs.clip_like_update(ref, ref_grads), "raw": ref_grads}
        del ref
        largest = {k: max(g.abs().max().item() for g in v) for k, v in refs.items()}
        largest["raw_clipped_floor"] = largest["clipped"]
        cut = [n for n, g in zip(names, ref_grads) if n.startswith("net.") and g.abs().max() > 1]
        for way, (context, use_kernels) in ways.items():
            with context():
                grads = cs.loss_q_grads(learner, batch, use_kernels)[2]
            got = {"clipped": cs.clip_like_update(learner, grads), "raw": grads}
            for kind, grads_of in kinds.items():
                errs[kind][way].append(cs.leaf_errs(got[grads_of], refs[grads_of],
                                                    largest[kind]))
        last = {w: errs["clipped"][w][-1] for w in WAYS}
        print(f"batch {i}: largest clipped grad {largest['clipped']:.4g}, raw "
              f"{largest['raw']:.4g}; clipped leaf errors (median, max): " +
              ", ".join(f"{w} {np.median(last[w]):.4f} {max(last[w]):.4f}" for w in WAYS) +
              f"; leaves the clip cuts: {cut}", flush=True)
    for kind in errs:
        for k in GROUPS:
            groups = [range(g, g + k) for g in range(0, n_batches - k + 1, k)]
            mean = lambda way, grp: np.mean([errs[kind][way][i] for i in grp], axis=0)
            for way in ("kernels", "ideal", "fault"):
                failed = [(grp.start, leaf_rule(mean(way, grp), mean("plain", grp), names))
                          for grp in groups]
                failed = [(start, leaves) for start, leaves in failed if leaves]
                print(f"{kind}, K = {k}: {way}: {len(failed)} of {len(groups)} groups beyond "
                      f"{cs.LEAF_RATIO} x plain + {cs.BF16_TOL}: {failed}", flush=True)
    out_dir = cs.ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bf16_leaves.json").write_text(json.dumps(dict(names=names, errs=errs)))
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
