r"""Classic host-loop driver CLI for single exp2/exp3 cells (counterpart of the
root ``run_classic.py``).

Runs the reference's own training architecture — a SINGLE sequentially
exploring world, host NumPy env, update every ``max_seq_len`` steps
(reference ``algos/madrqn/run.py:81-99``) — through this repo's classic
driver (``uav_bs_ctrl_tpu_torch/algos/madrqn/run.py``).  Exists as the
round-4 discriminator for the exp3 takeoff-lag investigation: the fused
trainer always feeds ``n_worlds`` parallel worlds per policy version,
and this driver is the one configuration that exactly reproduces the
reference's one-world data cadence.

Usage:
    python -m uav_bs_ctrl_tpu_torch.run_classic --exp exp3 --map 4ubs --c disc --epochs 50

It trains on ``cuda`` unless ``--device cpu`` is given; runs go to
``data_torch/`` unless ``--data-dir`` says otherwise.
"""

import argparse

from uav_bs_ctrl_tpu_torch.algos.madrqn.run import train as madrqn_train
from uav_bs_ctrl_tpu_torch.utils.run_utils import setup_logger_kwargs

# Reference grid hyperparameters (reference run_exp2.py:31-52 / run_exp3.py:27-52).
PRESETS = {
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


def main(argv=None):
    """Parse the CLI and train one cell; returns the learner."""
    from uav_bs_ctrl_tpu_torch.envs.mubs_cov import MultiUbsCoverageEnv

    parser = argparse.ArgumentParser()
    parser.add_argument("--exp", choices=("exp2", "exp3"), default="exp3")
    parser.add_argument("--map", dest="map_id", default="4ubs")
    parser.add_argument("--c", default=None)
    parser.add_argument("--mixer", action="store_true")
    parser.add_argument("--seed", "-s", type=int, default=0)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("--update-after", type=int, default=None,
                        help="default: the preset's (updates start at max(this, B T) steps)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--name-suffix", default=None)
    cli = parser.parse_args(argv)

    kw = dict(PRESETS[cli.exp])
    kw["c"] = None if cli.c in (None, "none") else cli.c
    kw["mixer"] = cli.mixer
    for k in ("epochs", "steps_per_epoch", "update_after", "device"):
        v = getattr(cli, k.replace("-", "_"))
        if v is not None:
            kw[k] = v

    name = f"{cli.exp}_classic_{cli.map_id}_{kw['c'] or 'iql'}" + ("_qmix" if cli.mixer else "")
    if cli.name_suffix:
        name += f"_{cli.name_suffix}"
    logger_kwargs = setup_logger_kwargs(name, cli.seed, data_dir=cli.data_dir)

    return madrqn_train(MultiUbsCoverageEnv,
                        dict(map_id=cli.map_id, fair_service=True, avoid_collision=True),
                        cli.seed, train_kwargs=kw, logger_kwargs=logger_kwargs)


if __name__ == "__main__":
    main()
