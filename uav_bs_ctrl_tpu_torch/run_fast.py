r"""Train a policy at full budget: the exp1, exp2 and exp3 paths of the JAX
package's ``run_fast.py``.

    python -m uav_bs_ctrl_tpu_torch.run_fast --exp exp2 --map r400 --c disc \
        [--mixer] [--resume] [--retries N] [--device cpu]
    python -m uav_bs_ctrl_tpu_torch.run_fast --exp exp3 --map 8ubs --c tarmac --mixer \
        --interleave 10 [--o mlp]
    python -m uav_bs_ctrl_tpu_torch.run_fast --exp exp1 --agent gnn --n-grps 4 \
        --gts-per-grp 5

``--exp`` defaults to exp2 and ``--map`` to r400 for exp2, 4ubs otherwise, as
in JAX. exp2 runs the MLP encoder (``o='mlp'``; without a protocol the
``RnnAgent``), exp3 the GNN encoder; ``--o`` overrides it; ``--c`` takes
every protocol (``none`` for independent Q-learning). exp1 is the single-UBS
DRQN (``--agent`` rnn or gnn, ``--n-grps`` GT groups of ``--gts-per-grp``).

Each iteration runs a fused trainer: ``algos/madrqn/fused.py`` for exp2 and
exp3 (on-device collection, the device replay ring, ``n_worlds`` updates in
``interleave`` sub-iterations), ``algos/drqn/fused.py`` for exp1 (one episode
on ``n_worlds`` worlds sliced into ``max_seq_len`` chunks, one update per
``max_seq_len`` env steps). The epsilon schedule, the epoch-stepped LR scale,
the test episodes, ``checkpoint_epoch{N}.pt`` files (which the JAX package's
learner resumes, AdamW moments included), ``config.json`` and
``progress.txt`` are those of ``run_fast.py:train_fast`` and
``train_fast_exp1``; runs go to ``data_torch/`` by default. ``--resume``
continues from the run directory's newest checkpoint and ``--retries N``
relaunches a crashed run with ``--resume`` up to N times. Runs on ``cuda``
unless ``--device cpu`` is given. ``--compute-dtype bfloat16`` trains with
bf16 compute and f32 master params (``algos/core.py``); the checkpoints hold
the f32 masters, which the JAX learner resumes.
"""

import argparse
import glob
import os
import os.path as osp
import re
import signal
import subprocess
import sys
import time

from uav_bs_ctrl_tpu_torch.utils.logx import EpochLogger
from uav_bs_ctrl_tpu_torch.utils.run_utils import setup_logger_kwargs

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))

# The reference grid's hyperparameters (run_exp1.py, run_exp2.py, run_exp3.py), as
# run_fast.py's.
EXP1_PRESET = dict(agent="rnn", lr=5e-4, polyak=0.999, replay_size=int(5e4),
                   decay_steps=int(2e5), epochs=50, steps_per_epoch=20000,
                   update_after=10000, anneal_lr=True)
EXP_PRESETS = {
    "exp2": dict(o="mlp", hidden_size=256, n_layers=2, msg_size=64,
                 lr=2.5e-4, polyak=0.999, decay_steps=int(5e4),
                 replay_size=int(5e3), max_seq_len=None,
                 epochs=100, steps_per_epoch=20000, update_after=10000,
                 norm_r=True, anneal_lr=True, double_q=True, dueling=False),
    "exp3": dict(o="gnn", hidden_size=256, n_layers=2, msg_size=64,
                 lr=2.5e-4, polyak=0.999, decay_steps=int(2e5),
                 replay_size=int(5e3), max_seq_len=None,
                 epochs=100, steps_per_epoch=30000, update_after=20000,
                 save_freq=10, norm_r=True, anneal_lr=True, double_q=True,
                 dueling=False),
}
EPS_START, EPS_END = 1.0, 0.05
TEST_COLUMNS = ("TestFairIdx", "TestAvgGlobalUtility", "TestTotalThroughput")


def check_supported(exp, kw):
    """Raise ``ValueError`` on an experiment the driver does not have."""
    if exp != "exp1" and exp not in EXP_PRESETS:
        raise ValueError(f"--exp must be one of exp1, exp2, exp3, got {exp!r}")


def epsilon(t, decay_steps):
    """Linear decay from 1 to 0.05 over ``decay_steps`` env steps, then flat."""
    return max(EPS_END, -(EPS_START - EPS_END) / decay_steps * t + EPS_START)


def should_save(epoch, it, iters_per_epoch, n_iters, save_freq):
    """Checkpoint decision at an epoch boundary (``(it+1) % iters_per_epoch == 0``).

    The final save keys on the LAST EPOCH BOUNDARY, not the last iteration:
    when ``iters_per_epoch`` does not divide ``n_iters`` the trailing
    iterations never reach an epoch boundary, and an ``it+1 == n_iters``
    condition would skip the final checkpoint.
    """
    return (epoch % save_freq == 0) or (it + 1 + iters_per_epoch > n_iters)


def _maybe_inject_crash(it, fresh_start):
    """Test hook: ``UAVBS_TEST_CRASH_AT_ITER=k`` raises once, at iteration
    ``k`` of a fresh (not resumed) start, so that the retry path can be
    tested end to end."""
    at = os.environ.get("UAVBS_TEST_CRASH_AT_ITER")
    if at is not None and fresh_start and it == int(at):
        raise RuntimeError(f"injected crash at iteration {it}")


def _supervise(argv, retries):
    """Run this command as a supervised child and relaunch it with
    ``--resume`` after a crash, up to ``retries`` times; returns only through
    ``sys.exit``.

    The supervisor holds no device state (it imports neither torch nor the
    kernels); each child is a fresh interpreter that builds its kernels on
    first use. ``UAVBS_SUPERVISED`` marks the child so that it does not
    recurse. On SIGTERM/SIGINT the child is terminated and not relaunched.
    """
    env = dict(os.environ, UAVBS_SUPERVISED="1",
               PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    child = None
    interrupted = []

    def _forward(signum, frame):
        interrupted.append(signum)
        if child is not None and child.poll() is None:
            child.terminate()

    signal.signal(signal.SIGTERM, _forward)
    signal.signal(signal.SIGINT, _forward)

    for attempt in range(retries + 1):
        cmd = [sys.executable, "-m", "uav_bs_ctrl_tpu_torch.run_fast"] + list(argv)
        if attempt and "--resume" not in cmd:
            cmd.append("--resume")
        child = subprocess.Popen(cmd, env=env)
        rc = child.wait()
        if rc == 0:
            sys.exit(0)
        if interrupted:
            sys.exit(128 + interrupted[0])
        if attempt < retries:
            print(f"[run_fast] child exit={rc}; relaunching with --resume "
                  f"({retries - attempt - 1} retries left)", flush=True)
    sys.exit(rc)


def _maybe_resume(trainer, output_dir, eps_fn):
    """Load the newest checkpoint in ``output_dir`` and refill the replay.

    The device ring is not checkpointed (nor is the reference's buffer):
    after params, AdamW state and LR scale are restored, two warm-up
    collections at the resumed epsilon refill it. Returns the resumed
    ``(epoch, t)``, or ``(0, 0)`` when there is nothing to resume.
    """
    ckpts = glob.glob(osp.join(output_dir, "checkpoint_epoch*.pt"))
    if not ckpts:
        print(f"[run_fast] no checkpoint found in {output_dir!r}; starting fresh", flush=True)
        return 0, 0
    latest = max(ckpts, key=lambda p: int(re.search(r"epoch(\d+)", p).group(1)))
    stamp = trainer.learner.load_checkpoint(latest)
    for _ in range(2):
        trainer.run_iteration(eps_fn(int(stamp["t"])), warmup=True)
    return int(stamp["epoch"]), int(stamp["t"])


def train_fast(exp, map_id, seed=0, train_overrides=None, logger_kwargs=None,
               n_worlds=40, n_layouts=256, resume=False, interleave=1):
    """``run_fast.py:train_fast``: ``epochs`` x ``steps_per_epoch`` env steps
    on the fused trainer; returns the trainer."""
    from uav_bs_ctrl_tpu_torch.algos.madrqn.fused import FusedMadrqnTrainer

    kw = dict(EXP_PRESETS.get(exp, {}))
    kw.update(train_overrides or {})
    check_supported(exp, kw)

    logger = EpochLogger(append=resume, **(logger_kwargs or {}))
    logger.save_config(dict(exp=exp, map_id=map_id, seed=seed,
                            n_worlds=n_worlds, interleave=interleave, args=kw))

    capacity = kw["replay_size"] - kw["replay_size"] % n_worlds
    trainer = FusedMadrqnTrainer(map_id, train_kwargs=kw, n_worlds=n_worlds,
                                 capacity_chunks=capacity, n_layouts=n_layouts,
                                 seed=seed, interleave=interleave)
    _train_loop(trainer, logger, n_worlds, trainer.T, resume,
                TEST_COLUMNS + ("TestProbCollision",))
    return trainer


def train_fast_exp1(env_kwargs, seed=0, train_overrides=None, logger_kwargs=None,
                    n_worlds=8, n_layouts=256, resume=False):
    """``run_fast.py:train_fast_exp1``: the single-UBS DRQN at full budget on
    the fused DRQN trainer; returns the trainer."""
    from uav_bs_ctrl_tpu_torch.algos.drqn.fused import FusedDrqnTrainer

    kw = dict(EXP1_PRESET)
    kw.update(train_overrides or {})
    check_supported("exp1", kw)

    logger = EpochLogger(append=resume, **(logger_kwargs or {}))
    logger.save_config(dict(exp="exp1", env_kwargs=env_kwargs, seed=seed,
                            n_worlds=n_worlds, args=kw))

    trainer = FusedDrqnTrainer(env_kwargs, train_kwargs=kw, n_worlds=n_worlds,
                               n_layouts=n_layouts, seed=seed)
    _train_loop(trainer, logger, n_worlds, trainer.L, resume, TEST_COLUMNS)
    return trainer


def _train_loop(trainer, logger, n_worlds, chunk_len, resume, test_columns):
    """The iterations of both ``train_fast``s: ``steps_per_epoch x epochs //
    (n_worlds T)`` iterations, an epoch every ``steps_per_epoch // (n_worlds
    T)``, warm-up (collection only) until ``max(update_after, B chunk_len)``
    env steps; at each epoch boundary the test episodes, the LR scheduler
    step, ``should_save``'s checkpoint and one ``progress.txt`` row (the
    ``Test*`` columns ``test_columns``)."""
    args, T = trainer.args, trainer.T
    learner = trainer.learner

    total_steps = args.steps_per_epoch * args.epochs
    steps_per_iter = n_worlds * T
    n_iters = max(1, total_steps // steps_per_iter)
    iters_per_epoch = max(1, args.steps_per_epoch // steps_per_iter)
    update_after = max(args.update_after, args.batch_size * chunk_len)
    eps = lambda t: epsilon(t, args.decay_steps)

    epoch0, t_global = (0, 0)
    if resume:
        epoch0, t_global = _maybe_resume(trainer, logger.output_dir, eps)
    t_resumed = t_global
    start_time = time.time()
    for it in range(epoch0 * iters_per_epoch, n_iters):
        _maybe_inject_crash(it, fresh_start=epoch0 == 0)
        warmup = t_global < update_after
        metrics = trainer.run_iteration(eps(t_global), warmup=warmup)
        t_global += steps_per_iter
        logger.store(**metrics)

        if (it + 1) % iters_per_epoch == 0:
            epoch = (it + 1) // iters_per_epoch
            logger.store(**trainer.evaluate(n_episodes=args.num_test_episodes))
            learner.step_lr_scheduler()

            if should_save(epoch, it, iters_per_epoch, n_iters, args.save_freq):
                learner.save_checkpoint(osp.join(logger.output_dir, f"checkpoint_epoch{epoch}.pt"),
                                        stamp=dict(epoch=epoch, t=t_global))

            logger.log_tabular("Epoch", epoch)
            logger.log_tabular("EpRet", with_min_and_max=True)
            logger.log_tabular("AvgGlobalUtility", average_only=True)
            logger.log_tabular("FairIdx", average_only=True)
            logger.log_tabular("TestEpRet", with_min_and_max=True)
            for column in test_columns:
                logger.log_tabular(column, average_only=True)
            logger.log_tabular("TotalEnvInteracts", t_global)
            if logger.epoch_dict.get("LossQ"):
                logger.log_tabular("LossQ", average_only=True)
            else:
                logger.log_tabular("LossQ", float("nan"))  # the epoch was all warm-up
            logger.log_tabular("StepsPerSec",
                               (t_global - t_resumed) / (time.time() - start_time))
            logger.log_tabular("Time", time.time() - start_time)
            logger.dump_tabular()

    print("Complete.")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--exp", choices=("exp1", "exp2", "exp3"), default="exp2")
    parser.add_argument("--map", dest="map_id", default=None,
                        help="default r400 for exp2, 4ubs otherwise")
    parser.add_argument("--c", default=None,
                        help="comm protocol (none|base|disc|commnet|tarmac|econv)")
    parser.add_argument("--o", dest="obs_enc", default=None,
                        help="override observation encoder (mlp|gnn)")
    parser.add_argument("--mixer", action="store_true")
    parser.add_argument("--agent", default="rnn", help="exp1 agent type (rnn|gnn)")
    parser.add_argument("--n-grps", type=int, default=2, help="exp1 GT groups")
    parser.add_argument("--gts-per-grp", type=int, default=5, help="exp1 GTs per group")
    parser.add_argument("--seed", "-s", type=int, default=0)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("--replay-size", type=int, default=None)
    parser.add_argument("--update-after", type=int, default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--n-worlds", type=int, default=40)
    parser.add_argument("--interleave", type=int, default=1,
                        help="sub-iterations per fused iteration (collect "
                             "n_worlds/S episodes -> updates/S, x S)")
    parser.add_argument("--n-layouts", type=int, default=256)
    parser.add_argument("--compute-dtype", default="float32")
    parser.add_argument("--matmul-precision", default=None,
                        help="None|default|high|highest: 'highest' turns TF32 off")
    parser.add_argument("--data-dir", default=None, help="default <repo root>/data_torch")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the newest checkpoint in the run dir")
    parser.add_argument("--name-suffix", default=None,
                        help="append '_<suffix>' to the auto run name")
    parser.add_argument("--save-freq", type=int, default=None,
                        help="checkpoint cadence in epochs (default: preset)")
    parser.add_argument("--retries", type=int, default=0,
                        help="on crash, relaunch with --resume up to N times")
    cli = parser.parse_args(argv)

    if cli.exp == "exp1":
        overrides = dict(agent=cli.agent, compute_dtype=cli.compute_dtype,
                         matmul_precision=cli.matmul_precision)
        preset = EXP1_PRESET
        name = f"exp1_fast_grp{cli.n_grps}_size{cli.gts_per_grp}_{cli.agent}"
    else:
        map_id = cli.map_id or ("r400" if cli.exp == "exp2" else "4ubs")
        c = None if cli.c in (None, "none") else cli.c
        overrides = dict(c=c, mixer=cli.mixer, compute_dtype=cli.compute_dtype,
                         matmul_precision=cli.matmul_precision)
        if cli.obs_enc:
            overrides["o"] = cli.obs_enc
        preset = EXP_PRESETS.get(cli.exp, {})
        name = f"{cli.exp}_fast_{map_id}_{c or 'iql'}" + ("_qmix" if cli.mixer else "")
        if cli.obs_enc:
            name += f"_{cli.obs_enc}"
        if cli.interleave > 1:
            name += f"_il{cli.interleave}"
    for k in ("epochs", "steps_per_epoch", "replay_size", "update_after", "device",
              "save_freq"):
        v = getattr(cli, k)
        if v is not None:
            overrides[k] = v
    # Here too, so that the supervisor does not relaunch a run the port cannot train.
    check_supported(cli.exp, dict(preset, **overrides))
    if cli.retries > 0 and os.environ.get("UAVBS_SUPERVISED") != "1":
        _supervise(argv, cli.retries)      # exits; training runs in supervised children

    if cli.name_suffix:
        name += f"_{cli.name_suffix}"
    logger_kwargs = setup_logger_kwargs(name, cli.seed, data_dir=cli.data_dir)
    if cli.exp == "exp1":
        train_fast_exp1(dict(n_grps=cli.n_grps, gts_per_grp=cli.gts_per_grp), seed=cli.seed,
                        train_overrides=overrides, logger_kwargs=logger_kwargs,
                        n_worlds=cli.n_worlds, n_layouts=cli.n_layouts, resume=cli.resume)
    else:
        train_fast(cli.exp, map_id, seed=cli.seed, train_overrides=overrides,
                   logger_kwargs=logger_kwargs, n_worlds=cli.n_worlds,
                   n_layouts=cli.n_layouts, resume=cli.resume, interleave=cli.interleave)

if __name__ == "__main__":
    main()
