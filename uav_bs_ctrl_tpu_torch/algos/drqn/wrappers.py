"""Single-agent env wrapper (exp1): flat or padded-graph observations
(counterpart of ``uav_bs_ctrl_tpu/algos/drqn/wrappers.py``).

Parity surface: reference ``algos/drqn/utils/env_wrappers.py`` — agent type
picks flat ('rnn') vs graph ('gnn') obs; the graph form attaches ALL GT rows
with their full feature vectors (no visibility flag; reference ``:63-77``).

Obs pytrees (leading agent axis of size 1, shared model code with madrqn):
- 'rnn': {'agent': [1, flat_dim]}
- 'gnn': {'agent': [1, d_own], 'gt': [1, M, d_gt]}
"""

import numpy as np

from uav_bs_ctrl_tpu_torch.envs import spaces


def make_env(env_fn, args):
    return Wrapper(env_fn(), args)


class Wrapper:
    def __init__(self, env, args):
        self.env = env
        self.agent_type = args.agent
        self.obs_wrapper = (FlattenObservation(env) if self.agent_type == "rnn"
                            else GraphObservation(env))

    def get_obs_size(self):
        return self.obs_wrapper.get_obs_size()

    def get_env_info(self):
        return dict(obs_shape=self.get_obs_size(), n_actions=self.n_actions,
                    episode_limit=self.episode_limit)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(f"attempted to get missing private attribute '{name}'")
        return getattr(self.env, name)

    def step(self, act):
        obs, rew, done, info = self.env.step(act)
        return self.obs_wrapper.observation(obs), rew, done, info

    def reset(self):
        return self.obs_wrapper.observation(self.env.reset())


class FlattenObservation:
    def __init__(self, env):
        self.env = env
        self._flat = spaces.flatten_space(env.observation_space)

    def get_obs_size(self) -> int:
        return self._flat.shape[0]

    def observation(self, obs):
        return {"agent": spaces.flatten(self.env.observation_space, obs)[None, :]}


class GraphObservation:
    def __init__(self, env):
        self.env = env

    def get_obs_size(self) -> dict:
        return dict(agent=self.env.obs_own_feats_size, gt=self.env.obs_gt_feats_size[1])

    def observation(self, obs):
        return {"agent": np.asarray(obs["agent"], np.float32)[None, :],
                "gt": np.asarray(obs["gt"], np.float32)[None, :, :]}
