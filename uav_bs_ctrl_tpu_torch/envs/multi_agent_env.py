"""Abstract multi-agent env API and wrapper base (a copy of
``uav_bs_ctrl_tpu/envs/multi_agent_env.py``).

Parity surface: reference ``envs/multi_agent_env.py`` — 5-tuple
``step(actions) -> (obs, state, reward, done, info)``, ``reset() ->
(obs, state)``, plus a wrapper base that transforms obs/state.

Documented reference quirk (SURVEY.md §2.4 #1): the wrapper's ``reward`` hook
is declared but never invoked by ``step``, so reward normalization is dead
code.  We reproduce that: ``MultiAgentWrapper.step`` forwards raw rewards.
"""

from abc import abstractmethod


class MultiAgentEnv:
    """Base class for multi-agent environments."""

    def seed(self, seed):
        raise NotImplementedError

    @abstractmethod
    def reset(self):
        """Reset and return (obs_list, state)."""
        raise NotImplementedError

    @abstractmethod
    def step(self, actions):
        """Advance one step; return (obs_list, state, reward, done, info)."""
        raise NotImplementedError

    @abstractmethod
    def get_obs(self):
        raise NotImplementedError

    @abstractmethod
    def get_state(self):
        raise NotImplementedError

    def close(self):
        pass

    def render(self):
        raise NotImplementedError

    @property
    def unwrapped(self):
        return self


class MultiAgentWrapper:
    """Base wrapper transforming observations and state (not rewards; see module doc)."""

    def __init__(self, env: MultiAgentEnv):
        self.env = env

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(f"attempted to get missing private attribute '{name}'")
        return getattr(self.env, name)

    def step(self, actions):
        obs, state, rew, done, info = self.env.step(actions)
        return self.observation(obs), self.state(state), rew, done, info

    def reset(self):
        obs, state = self.env.reset()
        return self.observation(obs), self.state(state)

    @abstractmethod
    def observation(self, obs):
        raise NotImplementedError

    @abstractmethod
    def state(self, state):
        raise NotImplementedError

    def reward(self, reward):
        return reward

    @property
    def unwrapped(self) -> MultiAgentEnv:
        return self.env.unwrapped
