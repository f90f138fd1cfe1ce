"""The port's BPTT update against the JAX package's.

The first update at small width (exp3's config, QMIX + double-Q, non-dueling,
and a dueling config without the mixer, through the kernels' Functions and
the unfused path), AdamW + value clip + Polyak against optax for three steps,
a 60-update loss trajectory, and the first update at full width from the
committed exp3 8-UBS checkpoint. Inputs are made with numpy from a seed and
handed to both packages.

Tolerances: 1e-5 at small width; at full width 1e-4 of the gradients' scale
(see ``_check_first_update``); the loss trajectory within what
``test_update_dynamics_parity.py`` allows: 0.2 % over the first 20 updates,
5 % over all 60.
"""

import json
from pathlib import Path
from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uav_bs_ctrl_tpu.algos.common import check_args_sanity as jax_check_args
from uav_bs_ctrl_tpu.algos.madrqn.config import DEFAULT_CONFIG as JAX_DEFAULTS
from uav_bs_ctrl_tpu.algos.madrqn.learner import MultiAgentQLearner as JaxLearner
from uav_bs_ctrl_tpu_torch.algos import collect
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import make_args
from uav_bs_ctrl_tpu_torch.envs import torch_env
from uav_bs_ctrl_tpu_torch.utils import checkpoint
from uav_bs_ctrl_tpu_torch.utils.convert import flatten

ROOT = Path(__file__).resolve().parents[1]
RUN_DIR = (ROOT / "data" / "exp3_fast_8ubs_tarmac_qmix_il10_lay64k"
           / "exp3_fast_8ubs_tarmac_qmix_il10_lay64k_s0")
TOL = dict(atol=1e-5, rtol=1e-5)
FULL_TOL = dict(atol=1e-4, rtol=1e-4)
OBS_SHAPE = {"agent": 2, "gt": 4, "ubs": 2}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **tol)


A_DBG, M_DBG, K_DBG, DS_DBG = 3, 4, 2, 22
HID, HEADS, MSG, KEY, N_ACT = 16, 2, 8, 4, 9


def _kw(mixer, dueling, **extra):
    return dict(o="gnn", c="tarmac", hidden_size=HID, n_heads=HEADS, msg_size=MSG,
                key_size=KEY, n_rounds=1, mixer=mixer, double_q=True, dueling=dueling,
                lr=2.5e-4, polyak=0.999, replay_size=16, **extra)


def _learners(kw, env_info, seed=0):
    """The JAX learner (dense/XLA path) and the port's, with the JAX weights."""
    jl = JaxLearner(env_info, jax_check_args(SN(**{**JAX_DEFAULTS, **kw, "device": "cpu"})),
                    seed=seed)
    tl = MultiAgentQLearner(env_info, make_args(kw, device="cpu"), seed=seed)
    tl.load_params(_np(jl.params))
    return jl, tl


def _env_info(a=A_DBG, ds=DS_DBG, t=5):
    return dict(obs_shape=OBS_SHAPE, state_shape=ds, n_actions=N_ACT, n_agents=a,
                episode_limit=t)


def _batch(rng, b, t, a, m, k, ds, hidden, rew_width):
    """A batch in the replay layout with masked slots, an agent that sees no
    GT, a destination that hears no one, stored h and a few done flags."""
    def slots(n, d):
        x = rng.normal(size=(b, t + 1, a, n, 1 + d)).astype(np.float32)
        x[..., 0] = rng.random((b, t + 1, a, n)) > 0.4
        x[..., 1:] *= x[..., :1]
        return x
    gt, ubs = slots(m, 4), slots(k, 2)
    gt[:, :, 0, :, 0] = 0.0
    adj = rng.random((b, t + 1, a, a)) > 0.4
    adj[..., np.arange(a), np.arange(a)] = True
    adj[:, :, :, 1] = False
    done = np.zeros((b, t), np.float32)
    done[0, -1] = 1.0
    return dict(obs={"agent": rng.random((b, t + 1, a, 2)).astype(np.float32), "gt": gt,
                     "ubs": ubs, "adj": adj},
                h=(0.5 * rng.normal(size=(b, 2, a, hidden))).astype(np.float32),
                state=rng.random((b, t + 1, ds)).astype(np.float32),
                act=rng.integers(0, N_ACT, size=(b, t, a)).astype(np.int32),
                rew=rng.normal(size=(b, t, rew_width)).astype(np.float32), done=done)


def _named(tree):
    return {k: np.asarray(v) for k, v in flatten(_np(tree)).items()}


def _port_named(learner, attr):
    mods = {"net": learner.net, "mixer": learner.mixer} if attr == "params" else \
        {"net": learner.target_net, "mixer": learner.target_mixer}
    return {f"{name}.{k}": v for name, mod in mods.items() if mod is not None
            for k, v in mod.state_dict().items()}


def _adam_moments(opt_state):
    adam = opt_state.inner_state[0]
    return _named(adam.mu), _named(adam.nu)


def _jax_first_update(jl, jbatch):
    key = jax.random.PRNGKey(0)
    (loss, qvals), grads = jax.value_and_grad(jl._loss_fn, has_aux=True)(
        jl.params, jl.target_params, jbatch, key)
    raw = _named(grads)
    grads["net"] = jax.tree_util.tree_map(lambda g: jnp.clip(g, -1.0, 1.0), grads["net"])
    params, targets, opt_state, metrics = jl._update_jit(
        jl.params, jl.target_params, jl.opt_state, jbatch, key, jnp.float32(jl.lr_scale))
    return dict(loss=float(loss), qvals=float(jnp.mean(qvals)), raw=raw, grads=_named(grads),
                params=_named(params), targets=_named(targets),
                moments=_adam_moments(opt_state), metrics=metrics)


def _check_first_update(tl, want, batch, use_kernels, tol, scaled=False):
    """The port's update against ``want`` (JAX's). With ``scaled``, the grads
    and Adam moments are held to ``tol`` times the largest raw gradient entry
    of their group (net or mixer): every entry is a sum over the same BPTT
    graph, whose scale sets the f32 roundoff. Params are then held to ``tol``
    only where the raw gradient exceeds that roundoff scale: where it is zero
    in exact arithmetic (the signature bias under the shift-invariant softmax,
    an er column whose LeakyReLU has one sign on every slot) both packages
    hand Adam roundoff, and its first step moves such an entry by +-lr either
    way; there the test checks that bound."""
    state = tl.state_dict()
    got = tl.update_on_batch(_torch_tree(batch), use_kernels=use_kernels)
    _close(got["LossQ"], want["loss"], tol, "LossQ")
    _close(got["LossQ"], want["metrics"]["LossQ"], tol, "LossQ")
    _close(got["QVals"], want["qvals"], tol, "QVals")
    names = [f"net.{k}" for k, _ in tl.net.named_parameters()] + \
        ([f"mixer.{k}" for k, _ in tl.mixer.named_parameters()] if tl.mixer else [])
    assert sorted(names) == sorted(want["grads"])
    scale = {grp: max(np.abs(v).max() for k, v in want["raw"].items() if k.startswith(grp))
             for grp in ("net", "mixer") if any(k.startswith(grp) for k in want["raw"])}
    gtol = (lambda name: dict(atol=tol["atol"] * scale[name.split(".")[0]], rtol=0)) \
        if scaled else (lambda name: tol)
    mu, nu = want["moments"]
    for name, p in zip(names, tl.parameters()):
        _close(p.grad, want["grads"][name], gtol(name), f"grad {name}")
        _close(tl.optimizer.state[p]["exp_avg"], mu[name], gtol(name), f"mu {name}")
        _close(tl.optimizer.state[p]["exp_avg_sq"], nu[name], tol, f"nu {name}")
    lr_step = tl.lr * tl.lr_scale
    for attr in ("params", "targets"):
        got_named = _port_named(tl, attr)
        assert sorted(got_named) == sorted(want[attr])
        for name, v in got_named.items():
            if not scaled:
                _close(v, want[attr][name], tol, f"{attr} {name}")
                continue
            v = v.numpy()
            sure = np.abs(want["raw"][name]) > gtol(name)["atol"]
            _close(v[sure], want[attr][name][sure], tol, f"{attr} {name}")
            bound = 2 * lr_step * (1.0 if attr == "params" else 1.0 - tl.polyak)
            assert np.all(np.abs(v - want[attr][name])[~sure] <= bound * 1.001 + 1e-7), name
    tl.load_state_dict(state)


@pytest.mark.parametrize("mixer,dueling", [(True, False), (False, True)])
def test_first_update_matches_jax(mixer, dueling):
    """exp3's config (QMIX + double-Q, non-dueling) and a dueling config
    without the mixer: LossQ, QVals, clipped grads, updated params, targets
    and Adam moments, through the kernels' Functions and the unfused path."""
    T, B = 5, 4
    jl, tl = _learners(_kw(mixer, dueling), _env_info(t=T))
    assert tl.share_reward == mixer
    batch = _batch(np.random.default_rng(2), B, T, A_DBG, M_DBG, K_DBG, DS_DBG, HID,
                   1 if mixer else A_DBG)
    want = _jax_first_update(jl, jax.tree_util.tree_map(jnp.asarray, batch))
    for use_kernels in (True, False):
        _check_first_update(tl, want, batch, use_kernels, TOL)


def test_adamw_clip_polyak_match_optax_for_three_steps():
    """The step after the backward (value clip of the net only, AdamW,
    Polyak) on given gradients, three times, against optax."""
    jl, tl = _learners(_kw(True, False), _env_info())
    rng = np.random.default_rng(4)
    params, targets, opt_state = jl.params, jl.target_params, jl.opt_state
    names = [f"net.{k}" for k, _ in tl.net.named_parameters()] + \
        [f"mixer.{k}" for k, _ in tl.mixer.named_parameters()]
    for step in range(3):
        grads = {k: (3.0 * rng.normal(size=v.shape)).astype(np.float32)
                 for k, v in _named(params).items()}
        for name, p in zip(names, tl.parameters()):
            p.grad = torch.from_numpy(grads[name].copy())
        tl.lr_scale = 0.4 if step == 2 else 1.0
        tl.apply_grads()
        tree = {"net": {}, "mixer": {}}
        for name, g in grads.items():
            node = tree
            *path, leaf = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(g)
        tree["net"] = jax.tree_util.tree_map(lambda g: jnp.clip(g, -1.0, 1.0), tree["net"])
        opt_state.hyperparams["learning_rate"] = jl.lr * jnp.float32(tl.lr_scale)
        updates, opt_state = jl.optimizer.update(tree, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        targets = jax.tree_util.tree_map(lambda t, p: jl.polyak * t + (1.0 - jl.polyak) * p,
                                         targets, params)
        for attr, want in (("params", _named(params)), ("targets", _named(targets))):
            for name, v in _port_named(tl, attr).items():
                _close(v, want[name], TOL, f"step {step} {attr} {name}")


def test_loss_trajectory_tracks_jax_over_20_updates():
    """60 updates (``test_update_dynamics_parity.py``'s horizon): the first 20
    within 0.2 %, all within 5 %."""
    T, B = 5, 4
    jl, tl = _learners(_kw(True, False), _env_info(t=T), seed=1)
    rng = np.random.default_rng(5)
    batches = [_batch(rng, B, T, A_DBG, M_DBG, K_DBG, DS_DBG, HID, 1) for _ in range(4)]
    params, targets, opt_state = jl.params, jl.target_params, jl.opt_state
    key = jax.random.PRNGKey(0)
    rel = []
    for step in range(60):
        batch = batches[step % len(batches)]
        params, targets, opt_state, m = jl._update_jit(
            params, targets, opt_state, jax.tree_util.tree_map(jnp.asarray, batch), key,
            jnp.float32(1.0))
        got = float(tl.update_on_batch(_torch_tree(batch))["LossQ"])
        rel.append(abs(got - float(m["LossQ"])) / max(float(m["LossQ"]), 1e-6))
    assert rel[0] < 1e-5, rel[0]
    assert max(rel[:20]) < 2e-3, max(rel[:20])
    assert max(rel) < 0.05, (int(np.argmax(rel)), max(rel))


def test_first_update_at_full_width_from_the_checkpoint():
    """The committed exp3 8-UBS run's net and mixer (hidden 256, 4 heads of
    64, msg 64, key 16, QMIX embed 32): T = 4, B = 2; tolerance 1e-4."""
    config = json.loads((RUN_DIR / "config.json").read_text())
    kw = dict(config["args"], max_seq_len=4, batch_size=2)
    env_info = dict(obs_shape=OBS_SHAPE, state_shape=216, n_actions=9, n_agents=8,
                    episode_limit=50)
    ckpt = checkpoint.load(RUN_DIR / "checkpoint_epoch200.pt")
    tree = {"net": ckpt["model_state_dict"], "mixer": ckpt["mixer_state_dict"]}
    jl = JaxLearner(env_info, jax_check_args(SN(**{**JAX_DEFAULTS, **kw, "device": "cpu"})))
    jl.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jl.target_params = jax.tree_util.tree_map(jnp.asarray, tree)
    jl.opt_state = jl.optimizer.init(jl.params)
    tl = MultiAgentQLearner(env_info, make_args(kw, device="cpu"))
    tl.load_params(tree)
    # A batch of real experience: the trained policy playing two worlds for
    # T = 4 steps (random observations give Q values, and so gradients, three
    # orders of magnitude beyond what the run trains on).
    tp = torch_env.make_params("8ubs")
    gen = torch.Generator().manual_seed(6)
    states = collect.reset_worlds(tp, collect.make_layout_pool("8ubs", 4, seed=6), gen, 2,
                                  torch.device("cpu"))
    with torch.no_grad():
        chunk, _, _ = collect.collect_chunk(tp, tl.net, states, torch.zeros((2, 8, 256)), 4,
                                            gen, 0.5)
    chunk["rew"] = chunk["rew"].mean(-1, keepdim=True)
    batch = jax.tree_util.tree_map(lambda t: t.numpy(), chunk)
    want = _jax_first_update(jl, jax.tree_util.tree_map(jnp.asarray, batch))
    assert want["loss"] > 1.0
    _check_first_update(tl, want, batch, True, FULL_TOL, scaled=True)
