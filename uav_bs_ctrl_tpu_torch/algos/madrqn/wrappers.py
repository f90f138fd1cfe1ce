"""Multi-agent env wrapper: obs -> fixed-shape padded arrays (counterpart of
``uav_bs_ctrl_tpu/algos/madrqn/wrappers.py``).

Replaces the reference's dynamic DGL graph construction
(``algos/madrqn/utils/env_wrappers.py``): instead of visibility-*filtered*
heterographs batched with ``dgl.batch``/``dgl.merge`` (reference ``:56-89,
122-137``), observations stay as the env's dense padded neighborhoods —
the visibility flag column *is* the edge mask — so every step produces arrays
of identical shape and the jitted policy never recompiles.

Obs pytree layouts (leading agent axis A):

- ``o='gnn'``: {'agent': [A, d_own], 'gt': [A, M, 1+d_gt], 'ubs': [A, K, 1+d_ubs]}
  (+ 'adj': [A, A] when a comm protocol is active — reference
  ``build_comm_graph:139-154``, includes self-loops).
- ``o='mlp'``: {'agent': [A, flat_dim]} (+ 'adj' when comm); flattening uses
  the gym sorted-key order (agent, gt, ubs), the same vector as the fused
  trainer's ``algos/collect.py:flatten_obs``, so a run trained on either
  path serves on the other.

The reward-normalizer (``ZFilter``) remains intentionally unwired, matching
the reference where ``MultiAgentWrapper.step`` never calls ``reward()``
(SURVEY.md §2.4 quirk 1).
"""

import numpy as np

from uav_bs_ctrl_tpu_torch.envs import spaces
from uav_bs_ctrl_tpu_torch.envs.multi_agent_env import MultiAgentWrapper
from uav_bs_ctrl_tpu_torch.utils.reward_normalizer import ZFilter


def make_env(env_fn, args):
    return MultiUbsCoverageWrapper(env_fn(), args)


class FlattenedObservation:
    """Flatten per-agent dict obs to 1-D vectors (sorted key order)."""

    def __init__(self, env):
        self.env = env
        self._space = env.observation_space[0]
        self._flat = spaces.flatten_space(self._space)

    def get_obs_size(self) -> int:
        return self._flat.shape[0]

    def local_observation(self, local_obs):
        return {"agent": np.stack([spaces.flatten(self._space, o) for o in local_obs])}


class PaddedGraphObservation:
    """Keep the env's padded neighborhood arrays as the graph representation."""

    def __init__(self, env):
        self.env = env

    def get_obs_size(self) -> dict:
        # Feature dims exclude the visibility flag column (reference
        # ``env_wrappers.py:63``).
        return dict(agent=self.env.obs_own_feats_size,
                    ubs=self.env.obs_ubs_feats_size[1] - 1,
                    gt=self.env.obs_gt_feats_size[1] - 1)

    def local_observation(self, local_obs):
        return {
            "agent": np.stack([o["agent"] for o in local_obs]),
            "gt": np.stack([o["gt"] for o in local_obs]),
            "ubs": np.stack([o["ubs"] for o in local_obs]),
        }


class MultiUbsCoverageWrapper(MultiAgentWrapper):
    def __init__(self, env, args):
        super().__init__(env)

        self._enc_type = args.o
        self._comm_protocol = args.c

        if self._enc_type == "mlp":
            self.local_obs_wrapper = FlattenedObservation(env)
        elif self._enc_type == "gnn":
            self.local_obs_wrapper = PaddedGraphObservation(env)
        else:
            raise KeyError(f"Unknown encoder type {self._enc_type!r}")

        # Instantiated-but-unwired, as in the reference (quirk 1).
        self._normalize_reward = getattr(args, "norm_r", False)
        if self._normalize_reward:
            reward_shape = 1 if args.share_reward else self.n_agents
            self.reward_normalizer = ZFilter(shape=(1, reward_shape), clip=10)

    def get_env_info(self) -> dict:
        return dict(obs_shape=self.get_obs_size(), state_shape=self.get_state_size(),
                    n_actions=self.n_actions, n_agents=self.n_agents,
                    episode_limit=self.episode_limit)

    def get_obs_size(self):
        return self.local_obs_wrapper.get_obs_size()

    def observation(self, obs):
        wrapped = self.local_obs_wrapper.local_observation(obs)
        if self._comm_protocol is not None:
            # Talk graph: d_u2u <= r_comm, self-loops included (env.adj).
            wrapped["adj"] = np.asarray(self.env.adj, dtype=bool)
        return wrapped

    def state(self, state):
        return np.asarray(state, dtype=np.float32)

    def reward(self, reward):
        if self._normalize_reward:
            reward = self.reward_normalizer(reward)
        return reward
