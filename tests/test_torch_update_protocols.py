"""One BPTT update of every agent the port trains against the JAX package's
``_update_fn``: the GNN and the MLP observation encoder, each with no comm (a
GRU; under the MLP encoder that is the ``RnnAgent``) and with every comm
protocol (TarMAC at two rounds; one-round TarMAC is ``test_torch_update.py``'s),
QMIX on for some cases. LossQ, QVals, clipped grads, updated params, targets
and Adam moments, through the kernels' Functions (their plain versions on the
CPU) and through the unfused path.

DiscreteComm's Gumbel noise is JAX's own: the update's key splits into the
policy's and the target's, and each step of each unroll splits a fresh key off
its chain (``uav_bs_ctrl_tpu/algos/core.py:263-283``); the port gets
``jax.random.gumbel`` of every step's key. Its hard bits are discontinuous, so
the test also reports the smallest Gumbel margin |z0 - z1| of the policy's
first step: a bit that flips between the packages would sit within 1e-5 of
its tie, and this draw has none there.

Small width (hidden 16, msg 8, key 4; 3 agents, T = 5, B = 4); inputs from a
numpy seed; tolerance 1e-5.
"""

import functools
from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_update import (A_DBG, DS_DBG, HID, K_DBG, M_DBG, MSG, TOL, _batch,
                               _check_first_update, _jax_first_update, _kw, _torch_tree)
from uav_bs_ctrl_tpu.algos.common import check_args_sanity as jax_check_args
from uav_bs_ctrl_tpu.algos.madrqn.config import DEFAULT_CONFIG as JAX_DEFAULTS
from uav_bs_ctrl_tpu.algos.madrqn.learner import MultiAgentQLearner as JaxLearner
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import make_args

T, B = 5, 4
TIE = 1e-5
CASES = [(o, c, n_rounds, mixer)
         for o in ("gnn", "mlp")
         for c, n_rounds, mixer in ((None, 1, True), ("base", 1, False), ("disc", 1, True),
                                    ("commnet", 2, False), ("tarmac", 2, True),
                                    ("econv", 1, False))]


def _flat(batch):
    """The batch as the MLP encoder's replay holds it: per agent its own
    position, GT rows and UBS rows end to end, and the talk graph."""
    obs = batch["obs"]
    lead = obs["agent"].shape[:-1]
    flat = np.concatenate([obs["agent"], obs["gt"].reshape(lead + (-1,)),
                           obs["ubs"].reshape(lead + (-1,))], -1)
    return dict(batch, obs={"agent": flat, "adj": obs["adj"]})


def _jax_noise(key, shape, T=T):
    """The Gumbel noise JAX's per-step schedule draws: ``{"pol": [T+1, ...],
    "targ": [T, ...]}``."""
    key_pol, key_targ = jax.random.split(key)

    def chain(k, n):
        out = []
        for _ in range(n):
            k, sub = jax.random.split(k)
            out.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
        return torch.from_numpy(np.stack(out))
    return {"pol": chain(key_pol, T + 1), "targ": chain(key_targ, T)}


@pytest.mark.parametrize("o,c,n_rounds,mixer", CASES)
def test_first_update_of_every_protocol_matches_jax(o, c, n_rounds, mixer):
    batch = _batch(np.random.default_rng(8), B, T, A_DBG, M_DBG, K_DBG, DS_DBG, HID,
                   1 if mixer else A_DBG)
    if o == "mlp":
        batch = _flat(batch)
    obs_shape = batch["obs"]["agent"].shape[-1] if o == "mlp" else \
        {"agent": 2, "gt": 4, "ubs": 2}
    env_info = dict(obs_shape=obs_shape, state_shape=DS_DBG, n_actions=9, n_agents=A_DBG,
                    episode_limit=T)
    kw = dict(_kw(mixer, False), o=o, c=c, n_rounds=n_rounds, n_layers=2)
    jl = JaxLearner(env_info, jax_check_args(SN(**{**JAX_DEFAULTS, **kw, "device": "cpu"})))
    tl = MultiAgentQLearner(env_info, make_args(kw, device="cpu"))
    tl.load_params(jax.tree_util.tree_map(np.asarray, jl.params))
    assert type(tl.net).__name__ == type(jl.agent).__name__

    noise = None
    shape = tl.net.noise_shape((B,), A_DBG)
    assert (shape is None) == (c != "disc")
    if shape is not None:
        noise = _jax_noise(jax.random.PRNGKey(0), shape)      # _jax_first_update's key
        with torch.no_grad():
            x = tl.net.encode(_torch_tree({k: v[:, 0] for k, v in batch["obs"].items()}))
            h = torch.from_numpy(batch["h"][:, 0])
            logits = tl.net.f_comm.f_enc(torch.cat([x, h], -1))
        z = logits.reshape(B, A_DBG, 1, MSG, 2) + noise["pol"][0]
        margin = (z[..., 0] - z[..., 1]).abs().min().item()
        print(f"smallest Gumbel margin of the policy's first step: {margin:.3e}")
        assert margin > TIE
        # The port's update on JAX's draws, in place of its own generator's.
        tl.update_on_batch = functools.partial(tl.update_on_batch, noise=noise)
    state = tl.noise_generator.get_state()

    want = _jax_first_update(jl, jax.tree_util.tree_map(jnp.asarray, batch))
    for use_kernels in (True, False):
        _check_first_update(tl, want, batch, use_kernels, TOL)
    assert torch.equal(tl.noise_generator.get_state(), state)     # nothing drawn


def test_update_draws_noise_only_for_an_agent_that_reads_a_key():
    """A DiscreteComm update draws the noise of both unrolls from the
    learner's generator, seeded with the learner's seed: the same seed gives
    the same update, another seed another one; given noise, the update draws
    nothing. A TarMAC update draws nothing."""
    batch = _torch_tree(_batch(np.random.default_rng(9), B, T, A_DBG, M_DBG, K_DBG, DS_DBG,
                               HID, 1))
    env_info = dict(obs_shape={"agent": 2, "gt": 4, "ubs": 2}, state_shape=DS_DBG,
                    n_actions=9, n_agents=A_DBG, episode_limit=T)

    def learner(c, seed):
        return MultiAgentQLearner(env_info, make_args(dict(_kw(True, False), c=c),
                                                      device="cpu"), seed=seed)
    losses = {}
    for seed in (0, 0, 1):
        tl = learner("disc", seed)
        start = tl.noise_generator.get_state()
        noise = tl.draw_noise(batch)
        assert noise["pol"].shape == (T + 1, B, A_DBG, A_DBG, MSG, 2)
        assert noise["targ"].shape == (T, B, A_DBG, A_DBG, MSG, 2)
        tl.noise_generator.set_state(start)
        losses.setdefault(seed, []).append(tl.update_on_batch(batch)["LossQ"].item())
        after = tl.noise_generator.get_state()
        tl.noise_generator.set_state(start)
        given = learner("disc", seed)
        given.update_on_batch(batch, noise=noise)
        assert torch.equal(given.noise_generator.get_state(), start)
        assert not torch.equal(after, start)
    assert losses[0][0] == losses[0][1] != losses[1][0]
    tl = learner("tarmac", 0)
    start = tl.noise_generator.get_state()
    assert tl.draw_noise(batch) is None
    tl.update_on_batch(batch)
    assert torch.equal(tl.noise_generator.get_state(), start)
