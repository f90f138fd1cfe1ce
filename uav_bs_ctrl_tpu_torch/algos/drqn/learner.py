"""Single-agent recurrent Q-learner (counterpart of ``algos/drqn/learner.py``).

The agent follows the observation shape, as JAX's ``QLearner`` (reference
``:48-52``): an int takes ``RnnAgent`` on the flat observation, a dict
``DrqnGnnAgent``; one agent, no mixer, no double-Q, no dueling head, on the
shared core.
"""

import torch

from uav_bs_ctrl_tpu_torch.algos.core import RecurrentQLearner
from uav_bs_ctrl_tpu_torch.models.agents import DrqnGnnAgent, RnnAgent


class QLearner(RecurrentQLearner):
    def __init__(self, env_info, args, seed=0):
        obs_shape = env_info["obs_shape"]
        agent_cls = RnnAgent if isinstance(obs_shape, int) else DrqnGnnAgent
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            agent = agent_cls(obs_shape, env_info["n_actions"], args)
        super().__init__(dict(env_info, n_agents=1), args, agent, seed=seed)

    def cache(self, obs, h, act, rew, next_obs, next_h, done, bad_mask):
        super().cache(obs, h, None, [act], [rew], next_obs, next_h, None, done, bad_mask)
