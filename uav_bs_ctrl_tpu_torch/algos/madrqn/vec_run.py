"""Vectorized MADRQN training: the on-device env driven one chunk at a time
from the host (counterpart of ``algos/madrqn/vec_run.py``).

Each chunk rolls one episode on ``n_worlds`` worlds on the device
(``algos.collect.collect_chunk``: the batched torch env with the policy in
the loop), copies it into the learner's host replay buffer in one
``push_chunks``, then runs ``updates_per_chunk`` updates, each on a batch
sampled from that buffer.

Equivalences to the classic driver (``algos/madrqn/run.py``), as in JAX:
- the epsilon schedule runs on total env steps (worlds x steps);
- the update-to-data ratio is the reference cadence by default (one update
  per ``max_seq_len`` env steps: ``updates_per_chunk = n_worlds``), and no
  update runs until the buffer holds ``batch_size`` chunks;
- ``progress.txt`` has JAX's columns in JAX's order, with ``TimeCollectMs``,
  ``TimeUpdateMs`` and ``EnvStepsPerSec``.

``max_seq_len`` must be the episode (chunk = episode). Runs on ``cuda``
unless ``train_kwargs`` has ``device='cpu'``. The draws (layout picks, GT
priorities, exploration, test episodes) come from one CPU
``torch.Generator`` seeded with ``seed`` and the replay samples from
``np.random.RandomState(seed)``, so a seed's episodes differ from the JAX
run's, whose draws come from ``jax.random``.
"""

import os.path as osp
import time

import torch

from uav_bs_ctrl_tpu_torch.algos import collect
from uav_bs_ctrl_tpu_torch.algos.buffer import tree_map
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import make_args, set_rand_seed
from uav_bs_ctrl_tpu_torch.envs import torch_env
from uav_bs_ctrl_tpu_torch.utils.logx import EpochLogger
from uav_bs_ctrl_tpu_torch.utils.profiling import StepTimer

EPS_START, EPS_END = 1.0, 0.05


def env_info(env_params, o, fair_service=True):
    """The learner's env info (JAX ``vec_run.py:66-76``): per-slot feature
    widths for the GNN encoder (the flag column is the mask), the flat width
    for the MLP one."""
    fair = 1 if fair_service else 0
    nf_gt = 4 + fair
    if o == "gnn":
        obs_shape = dict(agent=2, gt=nf_gt - 1, ubs=2)
    else:
        obs_shape = 2 + env_params.n_gts * nf_gt + (env_params.n_ubs - 1) * 3
    return dict(obs_shape=obs_shape,
                state_shape=env_params.n_ubs * 2 + env_params.n_gts * (3 + fair),
                n_actions=env_params.n_actions, n_agents=env_params.n_ubs,
                episode_limit=env_params.episode_limit)


def train_vectorized(map_id, seed=0, train_kwargs=dict(), logger_kwargs=dict(),
                     n_worlds=32, n_layouts=256, fair_service=True,
                     avoid_collision=True, updates_per_chunk=None):
    """Train MADRQN with on-device vectorized collection on ``map_id``;
    returns the learner."""
    logger = EpochLogger(**logger_kwargs)
    rng = set_rand_seed(seed)

    args = make_args(train_kwargs, train_kwargs.get("device"))
    logger.save_config(dict(map_id=map_id, seed=seed, n_worlds=n_worlds, args=vars(args)))
    device = args.device

    env_params = torch_env.make_params(map_id, fair_service=fair_service,
                                       avoid_collision=avoid_collision)
    T = env_params.episode_limit
    assert args.max_seq_len in (None, T), \
        "vectorized path requires chunk == episode (max_seq_len=None)"
    args.max_seq_len = None

    learner = MultiAgentQLearner(env_info(env_params, args.o, fair_service), args, seed=seed)
    policy = collect.make_policy(learner._apply_net, args.o)

    pool = collect.make_layout_pool(map_id, n_layouts, seed=seed)
    test_pool = collect.make_layout_pool(map_id, n_layouts, seed=seed + 10_000)
    generator = torch.Generator().manual_seed(seed)

    total_steps = args.steps_per_epoch * args.epochs
    steps_per_chunk = n_worlds * T
    n_chunks = max(1, total_steps // steps_per_chunk)
    chunks_per_epoch = max(1, args.steps_per_epoch // steps_per_chunk)
    if updates_per_chunk is None:
        # Reference cadence: one update per max_seq_len env steps.
        updates_per_chunk = max(1, n_worlds)

    eps_thres = lambda t: max(EPS_END, -(EPS_START - EPS_END) / args.decay_steps * t
                              + EPS_START)

    timer = StepTimer()
    start_time = time.time()
    t_global = 0

    for it in range(n_chunks):
        with timer.phase('Collect'), torch.no_grad():
            states = collect.reset_worlds(env_params, pool, generator, n_worlds, device)
            h0 = torch.zeros((n_worlds, env_params.n_ubs, args.hidden_size), device=device)
            chunk, _, stats = collect.collect_chunk(env_params, policy, states, h0, T,
                                                    generator, eps_thres(t_global))
            stats = {k: v.cpu().numpy() for k, v in stats.items()}

        with timer.phase('Push'):
            if args.o == "mlp":
                chunk["obs"] = collect.flatten_obs(chunk["obs"])
            chunk = tree_map(lambda x: x.cpu().numpy(), chunk)
            if learner.share_reward:
                chunk["rew"] = chunk["rew"].mean(-1, keepdims=True)
            learner.buffer.push_chunks(chunk)

        t_global += steps_per_chunk

        n_upd = updates_per_chunk if len(learner.buffer) >= learner.batch_size else 0
        for _ in range(n_upd):
            with timer.phase('Update'):
                diagnostic = learner.update(rng)
            logger.store(**diagnostic)

        logger.store(EpRet=stats["EpRet"].mean(),
                     AvgGlobalUtility=stats["AvgGlobalUtility"].mean(),
                     FairIdx=stats["FairIdx"].mean(),
                     TotalThroughput=stats["TotalThroughput"].mean(),
                     ProbCollision=stats["ProbCollision"].mean())

        if (it + 1) % chunks_per_epoch == 0:
            epoch = (it + 1) // chunks_per_epoch

            # Test episodes on the device (eps=0.05, the reference test_agent)
            # on held-out layouts.
            with torch.no_grad():
                test_stats = collect.evaluate_policy(
                    env_params, policy, test_pool, args.hidden_size, generator,
                    args.num_test_episodes, device)
            logger.store(**{k: v.cpu().numpy() for k, v in test_stats.items()})

            learner.step_lr_scheduler()
            if (epoch % args.save_freq == 0) or (it + 1 == n_chunks):
                save_path = osp.join(logger.output_dir, f'checkpoint_epoch{epoch}.pt')
                learner.save_checkpoint(save_path, stamp=dict(epoch=epoch, t=t_global))

            times = timer.flush()
            collect_ms = times.get('TimeCollectMs', 1.0)
            logger.log_tabular('Epoch', epoch)
            logger.log_tabular('EpRet', with_min_and_max=True)
            logger.log_tabular('AvgGlobalUtility', average_only=True)
            logger.log_tabular('FairIdx', average_only=True)
            logger.log_tabular('TotalThroughput', average_only=True)
            logger.log_tabular('ProbCollision', average_only=True)
            logger.log_tabular('TestEpRet', with_min_and_max=True)
            logger.log_tabular('TestFairIdx', average_only=True)
            logger.log_tabular('TestAvgGlobalUtility', average_only=True)
            logger.log_tabular('TestTotalThroughput', average_only=True)
            logger.log_tabular('TestProbCollision', average_only=True)
            logger.log_tabular('TotalEnvInteracts', t_global)
            logger.log_tabular('LossQ', average_only=True)
            logger.log_tabular('TimeCollectMs', collect_ms)
            logger.log_tabular('TimeUpdateMs', times.get('TimeUpdateMs', 0.0))
            logger.log_tabular('EnvStepsPerSec', steps_per_chunk / (collect_ms / 1e3))
            logger.log_tabular('Time', time.time() - start_time)
            logger.dump_tabular()

    print("Complete.")
    return learner
