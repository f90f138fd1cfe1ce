"""DRQN classic host-loop driver (counterpart of
``uav_bs_ctrl_tpu/algos/drqn/run.py``; parity surface: reference
``algos/drqn/run.py``).

The single-agent variant of ``algos/madrqn/run.py``: the env returns obs only
(a 4-tuple step) and replay chunks of ``max_seq_len`` steps (default 10)
slice the episodes. Every NumPy draw comes from one
``np.random.RandomState(seed)``, in the order of the JAX package's
``run.py``; the learner runs on ``cuda`` unless ``device='cpu'`` is given.
"""

import copy
import os.path as osp
import time
from copy import deepcopy
from functools import partial
from types import SimpleNamespace as SN

from uav_bs_ctrl_tpu_torch.algos.drqn.config import DEFAULT_CONFIG, check_args
from uav_bs_ctrl_tpu_torch.algos.drqn.learner import QLearner
from uav_bs_ctrl_tpu_torch.algos.drqn.wrappers import make_env
from uav_bs_ctrl_tpu_torch.config import set_rand_seed
from uav_bs_ctrl_tpu_torch.utils.logx import EpochLogger
from uav_bs_ctrl_tpu_torch.utils.profiling import StepTimer


def train(env_fn, env_kwargs, seed, train_kwargs=dict(), logger_kwargs=dict()):
    logger = EpochLogger(**logger_kwargs)
    del logger_kwargs

    config = copy.deepcopy(DEFAULT_CONFIG)
    config.update(train_kwargs)
    args = SN(**config)
    del train_kwargs, config
    args = check_args(args)

    logger.save_config(locals())
    rng = set_rand_seed(seed)

    env = make_env(partial(env_fn, **env_kwargs, record=False, rng=rng), args)
    test_env = make_env(partial(env_fn, **env_kwargs, record=True, rng=rng), args)

    env_info = env.get_env_info()
    learner = QLearner(env_info, args, seed=seed)

    total_steps = args.steps_per_epoch * args.epochs
    update_after = max(args.update_after, learner.batch_size * learner.max_seq_len)
    update_every = learner.max_seq_len

    eps_start, eps_end = 1, 0.05
    eps_thres = lambda t: max(eps_end, -(eps_start - eps_end) / args.decay_steps * t + eps_start)

    epoch = 0

    def test_agent():
        for n in range(args.num_test_episodes):
            o, h, d = test_env.reset(), learner.init_hidden(), False
            while not d:
                a, h = learner.act(o, h, 0.05, rng)
                o, _, d, info = test_env.step(a[0])
            logger.store(TestEpRet=info.get('EpRet'))
            if epoch % args.save_freq == 0:
                test_env.replay(save_dir=osp.join(logger.output_dir, f'epoch{epoch}_episode{n}'))

    episode = 0
    timer = StepTimer()
    start_time = time.time()
    o, h = env.reset(), learner.init_hidden()

    for t in range(total_steps):
        with timer.phase('Act'):
            a, h2 = learner.act(o, h, eps_thres(t), rng)
        with timer.phase('Env'):
            o2, r, d, info = env.step(a[0])
        learner.cache(o, h, a[0], r, o2, h2, d, info.get("BadMask"))
        o, h = o2, h2

        if d:
            episode += 1
            logger.store(**{k: v for k, v in info.items() if k != 'BadMask'})
            o, h = env.reset(), learner.init_hidden()

        if (t >= update_after) and (t % update_every == 0):
            with timer.phase('Update'):
                diagnostic = learner.update(rng)
            logger.store(**diagnostic)

        if (t + 1) % args.steps_per_epoch == 0:
            epoch = (t + 1) // args.steps_per_epoch
            test_agent()
            learner.step_lr_scheduler()
            if (epoch % args.save_freq == 0) or (epoch == args.epochs):
                save_path = osp.join(logger.output_dir, f'checkpoint_epoch{epoch}.pt')
                learner.save_checkpoint(save_path, stamp=dict(epoch=epoch, t=t))

            logger.log_tabular('Epoch', epoch)
            logger.log_tabular('Episode', episode)
            logger.log_tabular('EpRet', with_min_and_max=True)
            logger.log_tabular('EpLen', average_only=True)
            logger.log_tabular('AvgGlobalUtility', with_min_and_max=True)
            logger.log_tabular('TotalThroughput', average_only=True)
            logger.log_tabular('FairIdx', average_only=True)
            logger.log_tabular('TestEpRet', with_min_and_max=True)
            logger.log_tabular('TotalEnvInteracts', t + 1)
            logger.log_tabular('LossQ', average_only=True)
            times = timer.flush()
            logger.log_tabular('TimeActMs', times.get('TimeActMs', 0.0))
            logger.log_tabular('TimeEnvMs', times.get('TimeEnvMs', 0.0))
            logger.log_tabular('TimeUpdateMs', times.get('TimeUpdateMs', 0.0))
            logger.log_tabular('Time', time.time() - start_time)
            logger.dump_tabular()

    print("Complete.")
    return learner


def load_and_run_policy(model_path, env_fn, env_kwargs, seed, agent_kwargs, n_episodes,
                        output_dir, device=None, timer=None):
    """``algos/madrqn/run.py:load_and_run_policy`` for the single-UBS DRQN."""
    rng = set_rand_seed(seed)
    timer = StepTimer() if timer is None else timer

    config = deepcopy(DEFAULT_CONFIG)
    config.update(agent_kwargs)
    config['device'] = device
    args = SN(**config)
    args = check_args(args)

    env = make_env(partial(env_fn, **env_kwargs, record=True, rng=rng), args)
    env_info = env.get_env_info()
    learner = QLearner(env_info, args, seed=seed)
    learner.load_checkpoint(model_path)

    rsts = {}
    for n in range(n_episodes):
        o, h, d = env.reset(), learner.init_hidden(), False
        while not d:
            with timer.phase('Act'):
                a, h = learner.act(o, h, 0.05, rng)
            with timer.phase('Env'):
                o, _, d, info = env.step(a[0])

        env.replay(save_dir=osp.join(output_dir, f'episode{n}'))
        for k, v in info.items():
            rsts.setdefault(k, []).append(v)

    return rsts


if __name__ == '__main__':
    import argparse
    from uav_bs_ctrl_tpu_torch.envs.subs_cov import SingleUbsCoverageEnv
    from uav_bs_ctrl_tpu_torch.utils.run_utils import setup_logger_kwargs

    parser = argparse.ArgumentParser()
    parser.add_argument('--seed', '-s', type=int, default=0)
    parser.add_argument('--exp', type=str, default='drqn')
    parser.add_argument('--device', default=None, help="cuda (default) or cpu")
    cli = parser.parse_args()

    logger_kwargs = setup_logger_kwargs(cli.exp, cli.seed)
    train(SingleUbsCoverageEnv, dict(n_grps=2, gts_per_grp=5), cli.seed,
          train_kwargs=dict(agent='rnn', device=cli.device), logger_kwargs=logger_kwargs)
