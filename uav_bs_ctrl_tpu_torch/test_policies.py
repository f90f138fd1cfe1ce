"""Trained-policy evaluation harness (counterpart of the root ``test_policies.py``).

Walks run directories, rebuilds each run's host env from its saved
``config.json`` (the env class name -> ``envs.REGISTRY``), loads the
checkpoint, rolls N test episodes (eps 0.05) with ``load_and_run_policy``,
merges the runs of an experiment, and writes ``test_summary.csv`` and
``test_summary_t.csv`` in the layout the JAX harness writes through pandas
(the ``csv`` module here; the GPU machine has no pandas), plus each episode's
CSVs under ``<output_dir>/<exp_name>_seed<seed>/episode{n}/``. The JAX harness
also draws ``test_summary.png`` and each episode's ``trajectories.png``; the
port draws no figure. Results are kept as dicts of columns.

    python -m uav_bs_ctrl_tpu_torch.test_policies --logdirs <run dirs> \\
        [--ckpt checkpoint_epoch50.pt] [--episodes 10] [--out <dir>] [--device cpu]

Every run plays on ``--device`` (default ``cuda``); the ``device`` a run's
``config.json`` stores is not read. A GNN agent's step goes through the
GATv2 kernel (#2 ``flash_gat_fused``) and a one-round TarMAC agent's through
the fused step (#4 ``tarmac_step``) on the card.
"""

import json
import os
import os.path as osp

import numpy as np

from uav_bs_ctrl_tpu_torch.algos.drqn.run import load_and_run_policy as test_drqn
from uav_bs_ctrl_tpu_torch.algos.madrqn.run import load_and_run_policy as test_madrqn
from uav_bs_ctrl_tpu_torch.envs import REGISTRY as env_REGISTRY
from uav_bs_ctrl_tpu_torch.envs.recorder import format_column, write_frame_csv

TEST_FUNCTIONS = {
    'drqn': test_drqn,
    'madrqn': test_madrqn,
}
METRICS = ['EpRet', 'AvgGlobalUtility', 'TotalThroughput', 'FairIdx']


def parse_run_config(config, device=None):
    """Normalize a saved ``config.json`` into (algo, env_fn, env_kwargs, args).

    Two on-disk formats exist:
    - classic ``train()`` runs (reference layout, ``test_policies.py:47-60``):
      ``env_fn`` holds the env class name and ``args`` is a single-entry dict.
    - ``run_fast.py`` fused-trainer runs: ``exp`` in {exp1, exp2, exp3} with
      ``env_kwargs`` (exp1) or ``map_id`` (exp2/3) and a flat ``args`` dict.
    ``args['device']`` becomes ``device`` (None: ``cuda``), whatever the run
    stored.
    """
    args = config['args']
    if isinstance(args, dict) and args and isinstance(list(args.values())[0], dict):
        args = list(args.values())[0]
    args = dict(args)
    args['device'] = device

    if 'env_fn' in config:
        algo = config.get('algo', 'madrqn')
        env_fn = env_REGISTRY[config['env_fn']]
        env_kwargs = config['env_kwargs']
    elif config.get('exp') == 'exp1':
        algo = 'drqn'
        env_fn = env_REGISTRY['SingleUbsCoverageEnv']
        env_kwargs = dict(config['env_kwargs'])
    else:
        algo = 'madrqn'
        env_fn = env_REGISTRY['MultiUbsCoverageEnv']
        env_kwargs = dict(map_id=config['map_id'])
    return algo, env_fn, env_kwargs, args


def insert_data(dataset, exp_name, new_data):
    """Merge results of one run (``{key: [value per episode]}``) into the
    per-experiment dataset."""
    if exp_name not in dataset:
        dataset[exp_name] = dict()
    for k, v in new_data.items():
        dataset[exp_name].setdefault(k, []).extend(v)
    return dataset


def write_summaries(dataset, metrics, output_dir):
    """``test_summary.csv`` (a column per (metric, exp_name), sorted; rows the
    episodes) and ``test_summary_t.csv`` (its transpose, metrics in the given
    order), as pandas writes the JAX harness' frames. Returns the summary as
    ``{(metric, exp_name): [values]}``."""
    summary = {(m, e): dataset[e][m] for e in dataset for m in metrics if m in dataset[e]}
    keys = sorted(summary)
    n_rows = max(len(v) for v in summary.values())
    cells = {k: format_column(v) + [""] * (n_rows - len(v)) for k, v in summary.items()}
    os.makedirs(output_dir, exist_ok=True)
    write_frame_csv(osp.join(output_dir, 'test_summary.csv'), list(range(n_rows)),
                    [cells[k] for k in keys],
                    [['metric'] + [m for m, _ in keys], ['exp_name'] + [e for _, e in keys]])
    exps = list(dataset)
    write_frame_csv(osp.join(output_dir, 'test_summary_t.csv'), list(metrics),
                    [[cells[(m, e)][i] if (m, e) in cells else "" for m in metrics]
                     for e in exps for i in range(n_rows)],
                    [['exp_name'] + [e for e in exps for _ in range(n_rows)],
                     ['episode'] + [i for _ in exps for i in range(n_rows)]])
    return summary


def test_series(algo_name, metrics, all_logdirs, checkpoint, n_episodes, output_dir,
                device=None, timer=None):
    """Evaluate every run directory containing the requested checkpoint, on
    ``device`` (default ``cuda``); ``timer`` (a ``StepTimer``) gets every
    step's ``Act`` and ``Env`` phases. Returns the summary's columns."""
    dataset = {}

    for logdir in all_logdirs:
        for root, dirs, files in os.walk(logdir):
            if checkpoint in files:
                with open(os.path.join(root, 'config.json')) as f:
                    config = json.load(f)

                exp_name = config['exp_name']
                seed = config['seed']
                algo, env_fn, env_kwargs, args = parse_run_config(config, device)
                model_path = osp.join(root, checkpoint)

                subdir = osp.join(output_dir, exp_name + f'_seed{seed}')
                os.makedirs(subdir, exist_ok=True)

                test_fn = TEST_FUNCTIONS[algo_name or algo]
                test_rsts = test_fn(model_path, env_fn, env_kwargs, seed, args,
                                    n_episodes, subdir, device=device, timer=timer)
                dataset = insert_data(dataset, exp_name, test_rsts)

    return write_summaries(dataset, metrics, output_dir)


if __name__ == '__main__':
    import argparse

    parser = argparse.ArgumentParser(
        description="Evaluate trained checkpoints (classic or run_fast outputs).")
    parser.add_argument('--logdirs', nargs='+', default=None,
                        help="run directories to walk (default: exp1 grid)")
    parser.add_argument('--ckpt', default='checkpoint_epoch50.pt')
    parser.add_argument('--algo', default=None, choices=(None, 'drqn', 'madrqn'),
                        help="override; inferred from each config.json if omitted")
    parser.add_argument('--episodes', '-n', type=int, default=10)
    parser.add_argument('--out', default=None)
    parser.add_argument('--device', default=None, help="cuda (default) or cpu")
    parser.add_argument('--metrics', nargs='+', default=METRICS)
    cli = parser.parse_args()

    base_dir = './data'
    if cli.logdirs:
        out = cli.out or osp.join('./data_torch', 'test_series')
        summary = test_series(cli.algo, cli.metrics, cli.logdirs, cli.ckpt, cli.episodes,
                              out, device=cli.device)
        print(json.dumps({f"{m}/{e}": float(np.mean(v)) for (m, e), v in summary.items()}))
    else:
        # Reference default: all candidates in experiment 1.
        for n_grps in [2, 3, 4]:
            all_logdirs = [osp.join(base_dir, f"exp1_grp{n_grps}_{agent}")
                           for agent in ['rnn', 'gnn']]
            output_dir = osp.join('./data_torch', 'test_exp1', f'{n_grps}grps')
            test_series('drqn', cli.metrics, all_logdirs, cli.ckpt, cli.episodes,
                        output_dir, device=cli.device)
