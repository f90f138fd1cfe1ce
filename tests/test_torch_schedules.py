"""The ``hoisted`` and ``merged`` BPTT schedules of the port's update against
its ``per_step`` schedule and against the JAX package's same schedule.

The configurations of ``tests/test_learner.py:245-369`` (gnn + DiscreteComm
and gnn + TarMAC, each with QMIX, double-Q and dueling; hidden 16, 4 heads,
B = 3, T = 5, 3 agents, 6 GT and 2 UBS slots, the same numpy-seeded batch)
and the exp1 DRQN learner (``DrqnGnnAgent``, B = 4, L = 5). f32 through the
kernels' plain versions on the CPU. DiscreteComm gets JAX's own per-step
Gumbel draws, which every schedule reads at the same step. Tolerances as
JAX's own (``tests/test_learner.py``): LossQ rtol 1e-5, gradients atol 2e-5
and rtol 1e-4.
"""

from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_update import _named, _torch_tree
from test_torch_update_protocols import _jax_noise
from uav_bs_ctrl_tpu.algos.common import check_args_sanity as jax_check_args
from uav_bs_ctrl_tpu.algos.drqn.config import DEFAULT_CONFIG as JAX_DRQN_DEFAULTS
from uav_bs_ctrl_tpu.algos.drqn.learner import QLearner as JaxQLearner
from uav_bs_ctrl_tpu.algos.madrqn.config import DEFAULT_CONFIG as JAX_DEFAULTS
from uav_bs_ctrl_tpu.algos.madrqn.learner import MultiAgentQLearner as JaxLearner
from uav_bs_ctrl_tpu_torch.algos.drqn import config as drqn_config
from uav_bs_ctrl_tpu_torch.algos.drqn.learner import QLearner
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import make_args

LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
SCHEDULES = ("per_step", "hoisted", "merged")
B, T, A, M, K = 3, 5, 3, 6, 2


def _learner_batch():
    """``tests/test_learner.py``'s batch (the same numpy draws)."""
    rng = np.random.default_rng(0)
    obs = {
        "agent": rng.normal(size=(B, T + 1, A, 2)).astype(np.float32),
        "gt": np.concatenate([(rng.random((B, T + 1, A, M, 1)) > 0.4).astype(np.float32),
                              rng.normal(size=(B, T + 1, A, M, 4)).astype(np.float32)], -1),
        "ubs": np.concatenate([(rng.random((B, T + 1, A, K, 1)) > 0.4).astype(np.float32),
                               rng.normal(size=(B, T + 1, A, K, 2)).astype(np.float32)], -1),
        "adj": np.ones((B, T + 1, A, A), dtype=bool),
    }
    return dict(obs=obs, h=np.zeros((B, 2, A, 16), np.float32),
                state=rng.normal(size=(B, T + 1, A * 2 + M * 4)).astype(np.float32),
                act=rng.integers(5, size=(B, T, A)).astype(np.int32),
                rew=rng.normal(size=(B, T, 1)).astype(np.float32),
                done=np.zeros((B, T), np.float32))


def _madrqn(c, sched):
    kw = dict(o="gnn", c=c, mixer=True, double_q=True, dueling=True, hidden_size=16,
              msg_size=8, key_size=4, n_heads=4, batch_size=3, max_seq_len=5,
              bptt_encoder=sched)
    env_info = dict(obs_shape=dict(agent=2, gt=4, ubs=2), state_shape=A * 2 + M * 4,
                    n_actions=5, n_agents=A, episode_limit=T)
    jl = JaxLearner(env_info, jax_check_args(SN(**{**JAX_DEFAULTS, **kw, "device": "cpu"})))
    return jl, lambda: MultiAgentQLearner(env_info, make_args(kw, device="cpu"))


def _drqn(sched):
    from test_torch_drqn import _env_info, _kw
    kw = dict(_kw("gnn"), bptt_encoder=sched)
    jl = JaxQLearner(_env_info("gnn"), jax_check_args(SN(**{**JAX_DRQN_DEFAULTS, **kw,
                                                            "device": "cpu"})))
    return jl, lambda: QLearner(_env_info("gnn"), drqn_config.check_args(
        SN(**{**drqn_config.DEFAULT_CONFIG, **kw, "device": "cpu"})))


def _port(make, tree, batch, noise):
    """The port's loss and raw gradients, by name, through the kernels' path."""
    tl = make()
    tl.load_params(tree)
    tl.backward(_torch_tree(batch), True, noise)
    groups = {"net": tl.net, "mixer": tl.mixer}
    grads = {f"{g}.{k}": p.grad.numpy() for g, mod in groups.items() if mod is not None
             for k, p in mod.named_parameters()}
    with torch.no_grad():
        loss = float(tl._loss(_torch_tree(batch), True, noise)[0])
    return loss, grads


@pytest.mark.parametrize("config", ["gnn_disc_qmix", "gnn_tarmac_qmix", "exp1_drqn_gnn"])
def test_hoisted_and_merged_equal_per_step_in_the_port_and_against_jax(config):
    if config == "exp1_drqn_gnn":
        from test_torch_drqn import _batch as drqn_batch
        batch = drqn_batch(np.random.default_rng(13), "gnn", 16)
        learners = {s: _drqn(s) for s in SCHEDULES}
    else:
        batch = _learner_batch()
        learners = {s: _madrqn(config.split("_")[1], s) for s in SCHEDULES}
    key = jax.random.PRNGKey(9)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    tree = jax.tree_util.tree_map(np.asarray, learners["per_step"][0].params)
    probe = learners["per_step"][1]()
    shape = probe.net.noise_shape((batch["h"].shape[0],), batch["h"].shape[2])
    noise = None if shape is None else _jax_noise(key, shape, T)
    got = {sched: _port(make, tree, batch, noise) for sched, (_, make) in learners.items()}
    for sched in ("hoisted", "merged"):
        assert probe.bptt_encoder == "per_step" and learners[sched][1]().bptt_encoder == sched
        np.testing.assert_allclose(got[sched][0], got["per_step"][0], rtol=LOSS_RTOL)
        for name, g in got[sched][1].items():
            np.testing.assert_allclose(g, got["per_step"][1][name], **GRAD_TOL,
                                       err_msg=f"{sched} {name} against per_step")
        jl = learners[sched][0]
        (loss_j, _), grads_j = jax.jit(jax.value_and_grad(jl._loss_fn, has_aux=True))(
            jl.params, jl.target_params, jbatch, key)
        loss_p, grads_p = got[sched]
        np.testing.assert_allclose(loss_p, float(loss_j), rtol=LOSS_RTOL, err_msg=sched)
        grads_j = _named(grads_j)
        assert sorted(grads_p) == sorted(grads_j)
        for name, g in grads_p.items():
            np.testing.assert_allclose(g, grads_j[name], **GRAD_TOL,
                                       err_msg=f"{sched} {name} against JAX")


def test_hoisted_runs_the_gat_kernel_once_per_relation_and_net():
    """With the encoder hoisted, a gnn update calls #2 twice per net (one call
    per relation over all its steps) and #3 once per relation, where
    ``per_step`` calls #2 twice a step; the step kernel (#4, #5) still runs
    every step. Counted on the CPU through the plain versions the wrappers
    call."""
    from uav_bs_ctrl_tpu_torch.ops import gat_kernels, step_kernels
    batch = _torch_tree(_learner_batch())
    calls = {}
    for sched in SCHEDULES:
        _, make = _madrqn("tarmac", sched)
        tl = make()
        count = {name: 0 for name in ("gat", "gat_bwd", "step", "step_bwd")}

        def probe(name, fn):
            def run(*args, **kw):
                count[name] += 1
                return fn(*args, **kw)
            return run
        with pytest.MonkeyPatch.context() as mp:
            for mod, attr, name in ((gat_kernels, "flash_gat_fused_plain", "gat"),
                                    (gat_kernels, "flash_gat_fused_bwd_plain", "gat_bwd"),
                                    (step_kernels, "tarmac_step_plain", "step"),
                                    (step_kernels, "tarmac_step_bwd_plain", "step_bwd")):
                mp.setattr(mod, attr, probe(name, getattr(mod, attr)))
            tl.backward(batch, True)
        calls[sched] = count
    per_step = dict(gat=2 * (2 * T + 1), gat_bwd=2 * T, step=2 * T + 1, step_bwd=T)
    assert calls["per_step"] == per_step == calls["merged"]
    # #3 runs for every policy step the loss reaches (T of T+1): per_step's T
    # calls a relation become one over all T+1 steps.
    assert calls["hoisted"] == dict(gat=4, gat_bwd=2, step=2 * T + 1, step_bwd=T)
