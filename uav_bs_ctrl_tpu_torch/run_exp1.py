r"""Experiment 1: DRQN on single-UBS coverage, MLP vs GNN encoders.

Counterpart of the root ``run_exp1.py`` (parity surface: reference
``run_exp1.py``) — same grid (2/3/4 GT groups x 5,
rnn vs gnn agents, 3 seeds, 50 epochs x 20k steps).

Runs go to ``data_torch/`` (each variant in a fresh subprocess) and train on
``cuda``: the grid sets no device. ``python -m uav_bs_ctrl_tpu_torch.run_exp1``.
"""
from uav_bs_ctrl_tpu_torch.utils.run_utils import ExperimentGrid
from uav_bs_ctrl_tpu_torch.algos.drqn.run import train as drqn

ALGOS = {
    'drqn': drqn,
}

if __name__ == '__main__':
    num_runs = 3
    run_kwargs = {'num_cpu': 1, 'data_dir': None, 'datestamp': False}

    from uav_bs_ctrl_tpu_torch.envs.subs_cov import SingleUbsCoverageEnv

    algo_name = 'drqn'
    eg = ExperimentGrid(name='exp1')
    eg.add('seed', [10 * (i + 1) for i in range(num_runs)])

    eg.add('env_fn', SingleUbsCoverageEnv,)
    eg.add('env_kwargs:n_grps', [2, 3, 4], 'grp')
    eg.add('env_kwargs:gts_per_grp', [5], 'size')


    eg.add('train_kwargs:agent', ['rnn', 'gnn'], '',)

    eg.add('train_kwargs:lr', 5e-4, 'lr')
    eg.add('train_kwargs:polyak', 0.999, 'polyak')
    eg.add('train_kwargs:replay_size', int(5e4), 'mem')
    eg.add('train_kwargs:decay_steps', int(2e5), 'dec')

    eg.add('train_kwargs:epochs', 50)
    eg.add('train_kwargs:steps_per_epoch', 20000)
    eg.add('train_kwargs:update_after', 10000)

    eg.run(ALGOS[algo_name], **run_kwargs)
