"""Resume a run's policy from its checkpoint and take N fused iterations on
the device, a short check of the training path (a full run, with logging,
checkpoints, the epsilon and LR schedules, ``--resume`` and ``--retries``,
is :mod:`uav_bs_ctrl_tpu_torch.run_fast`):

    python -m uav_bs_ctrl_tpu_torch.train --run-dir <run dir> [--iterations N] [--eps E]
        [--n-layouts P]

It reads the run's ``config.json`` and newest checkpoint (net, mixer, AdamW
state, LR scale), builds the fused trainer at the run's own settings (the
DRQN trainer for an exp1 run, ``"exp": "exp1"``) with a
pool of ``--n-layouts`` layouts (default 256, as ``run_fast.py``), runs two
warm-up iterations (collection only, as ``run_fast.py:_maybe_resume``) and N
training iterations, evaluates, and prints one JSON line of mean metrics.
Runs on ``cuda`` unless ``--device cpu`` is given; ``--tiny`` shrinks the run
to a few seconds at full width for a check on the CPU.
"""

import argparse
import json
from pathlib import Path

import numpy as np

from uav_bs_ctrl_tpu_torch.algos.drqn.fused import FusedDrqnTrainer
from uav_bs_ctrl_tpu_torch.algos.madrqn.fused import FusedMadrqnTrainer
from uav_bs_ctrl_tpu_torch.serve import is_exp1, latest_checkpoint

N_LAYOUTS = 256           # run_fast.py --n-layouts default
N_WARMUPS = 2             # run_fast.py:_maybe_resume refills the ring with two collections
TINY = dict(n_worlds=2, interleave=1, updates_per_iter=1, batch_size=2, capacity_chunks=4)
TINY_EXP1 = dict(n_worlds=2, updates_per_iter=1, batch_size=2, capacity_chunks=80)  # 2 episodes


def build_trainer(run_dir, device=None, n_layouts=N_LAYOUTS, n_worlds=None, interleave=None,
                  updates_per_iter=None, batch_size=None, capacity_chunks=None):
    """The run's fused trainer (:class:`FusedDrqnTrainer` for an exp1 run,
    else :class:`FusedMadrqnTrainer`) at the run's settings (``None`` keeps
    the run's value), loaded from the run's newest checkpoint. An exp1 run
    takes no ``interleave``."""
    config = json.loads((Path(run_dir) / "config.json").read_text())
    kw = dict(config["args"], device=device or "cuda")
    if batch_size is not None:
        kw["batch_size"] = batch_size
    n_worlds = n_worlds or config["n_worlds"]
    if is_exp1(config):
        if interleave is not None:
            raise ValueError("an exp1 run takes no interleave")
        # capacity_chunks None: replay_size rounded down to an iteration's chunks
        trainer = FusedDrqnTrainer(config["env_kwargs"], train_kwargs=kw, n_worlds=n_worlds,
                                   capacity_chunks=capacity_chunks,
                                   updates_per_iter=updates_per_iter, n_layouts=n_layouts,
                                   seed=config["seed"])
    else:
        if capacity_chunks is None:    # run_fast.py: replay_size rounded down to n_worlds
            capacity_chunks = kw["replay_size"] - kw["replay_size"] % n_worlds
        trainer = FusedMadrqnTrainer(config["map_id"], train_kwargs=kw, n_worlds=n_worlds,
                                     capacity_chunks=capacity_chunks,
                                     updates_per_iter=updates_per_iter, n_layouts=n_layouts,
                                     seed=config["seed"],
                                     interleave=interleave or config.get("interleave") or 1)
    trainer.learner.load_checkpoint(latest_checkpoint(run_dir))
    return trainer


def train(trainer, iterations, eps, eval_episodes):
    """Two warm-ups, ``iterations`` training iterations, evaluation; mean metrics."""
    for _ in range(N_WARMUPS):
        trainer.run_iteration(eps, warmup=True)
    history = [trainer.run_iteration(eps) for _ in range(iterations)]
    out = {k: float(np.mean([m[k] for m in history])) for k in history[0]} if history else {}
    out.update({k: float(np.mean(v))
                for k, v in trainer.evaluate(eval_episodes, eps=0.05).items()})
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--run-dir", required=True)
    parser.add_argument("--iterations", type=int, default=1)
    parser.add_argument("--eps", type=float, default=0.05,
                        help="exploration epsilon (run_fast's floor, where the run ended)")
    parser.add_argument("--n-layouts", type=int, default=N_LAYOUTS,
                        help="layouts in the training and test pools")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--tiny", action="store_true",
                        help=f"a quick check: {TINY} (exp1: {TINY_EXP1}) and 2 test episodes")
    cli = parser.parse_args(argv)
    tiny = {}
    if cli.tiny:
        config = json.loads((Path(cli.run_dir) / "config.json").read_text())
        tiny = TINY_EXP1 if is_exp1(config) else TINY
    trainer = build_trainer(cli.run_dir, cli.device, cli.n_layouts, **tiny)
    eval_episodes = 2 if cli.tiny else trainer.n_worlds
    print(json.dumps(train(trainer, cli.iterations, cli.eps, eval_episodes)))


if __name__ == "__main__":
    main()
