"""Aggregate training curves across seeds into CSVs (counterpart of the root
``collect_curves.py``; parity surface: reference ``collect_curves.py``).

Walks experiment dirs, takes an x-vs-metric column pair from each
``progress.txt``, joins the runs keyed by (exp_name, seed) and writes
``<xaxis>_vs_<metric>.csv``: the file the JAX script writes through pandas
(``read_table``, an outer ``concat`` on x, ``to_csv``), written here with the
``csv`` module (the GPU machine has no pandas):

- x is divided by 1e6 when it is ``TotalEnvInteracts``; a resumed run's
  re-logged x keeps its last row, then the run's rows are sorted by x;
- the joined x is the first run's, then each later run's new values in its
  order (pandas' unsorted union); a run without a value at an x is empty;
- a column whose entries are all integers stays integral unless the join
  leaves a hole in it (pandas then turns it into floats); floats are written
  in their shortest round-trip form.

    python -m uav_bs_ctrl_tpu_torch.collect_curves   # the port's own runs, data_torch/
"""

import json
import os
import os.path as osp

import numpy as np

from uav_bs_ctrl_tpu_torch.envs.recorder import write_frame_csv


def _parse(column):
    """A ``progress.txt`` column as ints when every entry is one, else floats."""
    try:
        return [int(v) for v in column]
    except ValueError:
        return [float(v) for v in column]


def read_curve(path, xaxis, metric):
    """``(x, y)`` of one ``progress.txt``: x (divided by 1e6 for
    ``TotalEnvInteracts``) deduplicated keeping the last row, sorted."""
    with open(path) as f:
        lines = f.read().splitlines()
    head = lines[0].split('\t')
    rows = [line.split('\t') for line in lines[1:] if line]
    xs = _parse([r[head.index(xaxis)] for r in rows])
    ys = _parse([r[head.index(metric)] for r in rows])
    if xaxis == 'TotalEnvInteracts':
        xs = [x / 1e6 for x in xs]
    last = {}
    for x, y in zip(xs, ys):
        last[x] = y
    order = sorted(last)
    return order, [last[x] for x in order]


def collect_curves(all_logdirs, xaxis, metric, output_dir):
    """Write ``<output_dir>/<xaxis>_vs_<metric>.csv``; returns ``(x, {(exp_name,
    'seed<seed>'): [y or None per x]})``."""
    curves = []
    for logdir in all_logdirs:
        for root, dirs, files in os.walk(logdir):
            if 'progress.txt' in files:
                try:
                    with open(os.path.join(root, 'config.json')) as f:
                        config = json.load(f)
                    key = (config['exp_name'], f"seed{config['seed']}")
                    curves.append((key,) + read_curve(os.path.join(root, 'progress.txt'),
                                                      xaxis, metric))
                except Exception:
                    print('Could not read from %s' % root)
                    continue
    if not curves:
        raise ValueError("No objects to concatenate")

    index, seen = [], set()
    for _, xs, _ in curves:
        for x in xs:
            if x not in seen:
                seen.add(x)
                index.append(x)
    columns = {}
    for key, xs, ys in curves:
        at = dict(zip(xs, ys))
        col = [at.get(x) for x in index]
        if any(v is None for v in col) or any(isinstance(v, float) for v in col):
            col = [np.nan if v is None else float(v) for v in col]
        columns[key] = col

    os.makedirs(output_dir, exist_ok=True)
    write_frame_csv(osp.join(output_dir, f'{xaxis}_vs_{metric}.csv'), index,
                    list(columns.values()),
                    [[''] + [k[0] for k in columns], [''] + [k[1] for k in columns]],
                    index_name=xaxis)
    return index, columns


if __name__ == '__main__':
    base_dir = './data_torch'

    grps = [2, 3, 4]
    agents = ['rnn', 'gnn']
    all_logdirs = [osp.join(base_dir, f"exp1_grp{g}_{a}") for g in grps for a in agents]
    collect_curves(all_logdirs, 'TotalEnvInteracts', 'AverageEpRet', './data_torch/exp1_curves')

    maps = ['r400', 'r800', 'inf']
    agents = ['none', 'none_qmix', 'tarmac', 'disc']
    all_logdirs = [osp.join(base_dir, f"exp2_{m}_{a}") for m in maps for a in agents]
    collect_curves(all_logdirs, 'TotalEnvInteracts', 'AverageEpRet', './data_torch/exp2_curves')

    maps = ['4ubs', '6ubs', '8ubs']
    all_logdirs = [osp.join(base_dir, f"exp3_{m}_gnn_{a}") for m in maps for a in agents]
    collect_curves(all_logdirs, 'TotalEnvInteracts', 'AverageEpRet', './data_torch/exp3_curves')
