"""Multi-agent Q-learner (counterpart of ``algos/madrqn/learner.py``): the
agent of ``build_agent``'s rule (``RnnAgent`` or ``GnnAgent``) and, with
``mixer``, the QMIX mixer, on the shared core."""

import torch

from uav_bs_ctrl_tpu_torch.algos.core import RecurrentQLearner
from uav_bs_ctrl_tpu_torch.models.agents import build_agent
from uav_bs_ctrl_tpu_torch.models.heads import QMixer


class MultiAgentQLearner(RecurrentQLearner):
    def __init__(self, env_info, args, seed=0, graphs=True):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            agent = build_agent(env_info["obs_shape"], env_info["n_actions"], args)
            mixer = (QMixer(env_info["state_shape"], env_info["n_agents"], args.embed_dim)
                     if args.mixer else None)
        super().__init__(env_info, args, agent, mixer, seed, graphs)
