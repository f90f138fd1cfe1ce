"""The port's modules against the JAX package's, with converted parameters.

Small widths (hidden 32, 4 heads of 8); tolerance 1e-5 (f32, sums taken in
another order). The JAX agent runs both dense/XLA and through its Pallas
kernels (interpret mode); the port both through its kernel path (the plain
versions on the CPU) and its unfused reference path.
"""

import warnings
from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uav_bs_ctrl_tpu.models import agents as jagents
from uav_bs_ctrl_tpu.models import comm as jcomm
from uav_bs_ctrl_tpu.models import encoders as jenc
from uav_bs_ctrl_tpu.models import heads as jheads
from uav_bs_ctrl_tpu.models import modules as jmod
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import make_args
from uav_bs_ctrl_tpu_torch.models import modules
from uav_bs_ctrl_tpu_torch.models.agents import GnnAgent
from uav_bs_ctrl_tpu_torch.models.comm import TarMAC
from uav_bs_ctrl_tpu_torch.models.encoders import GATv2, GraphObservationEncoder
from uav_bs_ctrl_tpu_torch.models.heads import DuelingLayer
from uav_bs_ctrl_tpu_torch.utils.convert import flatten, params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
OBS_SHAPE = {"agent": 2, "gt": 4, "ubs": 2}
HIDDEN, HEADS, MSG, KEY, N_ACT = 32, 4, 16, 8, 9


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, jax_params):
    module.load_state_dict(params_from_jax(_np_tree(jax_params), module))
    return module


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _obs(rng, w=3, a=4, m=6, k=3):
    """Random padded-neighbourhood obs with fully masked agents and an
    asymmetric talk graph with one destination that hears no one."""
    gt = rng.normal(size=(w, a, m, 1 + OBS_SHAPE["gt"])).astype(np.float32)
    gt[..., 0] = rng.random((w, a, m)) > 0.4
    gt[0, 1, :, 0] = 0.0
    ubs = rng.normal(size=(w, a, k, 1 + OBS_SHAPE["ubs"])).astype(np.float32)
    ubs[..., 0] = rng.random((w, a, k)) > 0.3
    ubs[1, 2, :, 0] = 0.0
    adj = rng.random((w, a, a)) > 0.4
    adj[:, np.arange(a), np.arange(a)] = True
    adj[0, :, 1] = False
    return {"agent": rng.random((w, a, 2)).astype(np.float32), "gt": gt, "ubs": ubs,
            "adj": adj}


def _torch_obs(obs):
    return {k: torch.from_numpy(v.copy()) for k, v in obs.items()}


def test_linear_gru_mlp_match_jax():
    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    h = rng.normal(size=(5, 7)).astype(np.float32)
    p_lin = jmod.linear_init(keys[0], 6, 7)
    _close(_load(modules.Linear(6, 7), p_lin)(torch.from_numpy(x)), jmod.linear(p_lin, x))
    p_gru = jmod.gru_init(keys[1], 6, 7)
    _close(_load(modules.GRUCell(6, 7), p_gru)(torch.from_numpy(x), torch.from_numpy(h)),
           jmod.gru(p_gru, x, h))
    p_mlp = jmod.mlp_init(keys[2], 6, 7, 2)
    _close(_load(modules.MLP(6, 7, 2), p_mlp)(torch.from_numpy(x)), jmod.mlp(p_mlp, x))


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("n_slots", [6, 0])
def test_gatv2_matches_jax(use_kernels, n_slots):
    rng = np.random.default_rng(n_slots)
    p = jenc.gatv2_init(jax.random.PRNGKey(1), 4, 2, HEADS, HIDDEN // HEADS)
    x_src = rng.normal(size=(3, 4, n_slots, 4)).astype(np.float32)
    x_dst = rng.normal(size=(3, 4, 2)).astype(np.float32)
    mask = rng.random((3, 4, n_slots)) > 0.4
    want = jenc.gatv2(p, x_src, x_dst, mask, HEADS)
    port = _load(GATv2(4, 2, HEADS, HIDDEN // HEADS), p)
    got = port(torch.from_numpy(x_src), torch.from_numpy(x_dst), torch.from_numpy(mask),
               use_kernels=use_kernels)
    _close(got, want)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_encoder_matches_jax(use_kernels):
    obs = _obs(np.random.default_rng(2))
    args = SN(hidden_size=HIDDEN, n_heads=HEADS, gat_backend="dense")
    enc = jenc.GraphObservationEncoder(OBS_SHAPE, args)
    p = enc.init(jax.random.PRNGKey(2))
    port = _load(GraphObservationEncoder(OBS_SHAPE, HIDDEN, HEADS), p)
    _close(port(_torch_obs(obs), use_kernels=use_kernels), enc.apply(p, obs))


def test_tarmac_and_dueling_match_jax():
    rng = np.random.default_rng(3)
    obs = _obs(rng)
    x = rng.normal(size=(3, 4, HIDDEN)).astype(np.float32)
    h = rng.normal(size=(3, 4, HIDDEN)).astype(np.float32)
    args = SN(hidden_size=HIDDEN, msg_size=MSG, key_size=KEY, n_rounds=1)
    jt = jcomm.TarMAC(args)
    p = jt.init(jax.random.PRNGKey(3))
    port = _load(TarMAC(HIDDEN, MSG, KEY), p)
    _close(port(torch.from_numpy(obs["adj"]), torch.from_numpy(x), torch.from_numpy(h)),
           jt.apply(p, obs["adj"], x, h))
    jd = jheads.DuelingLayer(HIDDEN, N_ACT)
    pd = jd.init(jax.random.PRNGKey(4))
    _close(_load(DuelingLayer(HIDDEN, N_ACT), pd)(torch.from_numpy(x)), jd.apply(pd, x))


def _agent_args(dueling, **kw):
    return dict(o="gnn", c="tarmac", hidden_size=HIDDEN, n_heads=HEADS, msg_size=MSG,
                key_size=KEY, n_rounds=1, dueling=dueling, **kw)


@pytest.mark.parametrize("dueling", [False, True])
@pytest.mark.parametrize("jax_backends", [("dense", "xla"), ("pallas_fused_mxu", "pallas")])
def test_agent_matches_jax(dueling, jax_backends):
    gat_backend, step_backend = jax_backends
    rng = np.random.default_rng(5)
    obs = _obs(rng)
    h = rng.normal(size=(3, 4, HIDDEN)).astype(np.float32)
    jagent = jagents.GnnAgent(OBS_SHAPE, N_ACT, SN(**_agent_args(
        dueling, gat_backend=gat_backend, step_backend=step_backend)))
    p = jagent.init(jax.random.PRNGKey(5))
    q_want, h_want = jagent.apply(p, {k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(h))
    agent = _load(GnnAgent(OBS_SHAPE, N_ACT, make_args(_agent_args(dueling), device="cpu")), p)
    for use_kernels in (True, False):
        q, h2 = agent(_torch_obs(obs), torch.from_numpy(h), use_kernels=use_kernels)
        _close(q, q_want)
        _close(h2, h_want)


def test_params_from_jax_uses_every_leaf_and_fills_every_parameter():
    jagent = jagents.GnnAgent(OBS_SHAPE, N_ACT, SN(**_agent_args(True)))
    tree = _np_tree(jagent.init(jax.random.PRNGKey(6)))
    agent = GnnAgent(OBS_SHAPE, N_ACT, make_args(_agent_args(True), device="cpu"))
    state = params_from_jax(tree, agent)
    assert set(state) == set(flatten(tree)) == set(agent.state_dict())
    with pytest.raises(KeyError, match="enc.extra"):
        params_from_jax({**tree, "enc": {**tree["enc"], "extra": np.zeros(1)}}, agent)
    with pytest.raises(KeyError, match="f_out"):
        params_from_jax({k: v for k, v in tree.items() if k != "f_out"}, agent)
    bad = dict(tree, f_out={**tree["f_out"], "v": {"w": np.zeros((HIDDEN, 2)),
                                                   "b": tree["f_out"]["v"]["b"]}})
    with pytest.raises(ValueError, match="f_out.v.w"):
        params_from_jax(bad, agent)


def test_config_accepts_jax_backend_names_but_not_unported_ones():
    """Serving and training take both encoders and every comm protocol,
    serving every GATv2 backend ('pallas': the flash_gat kernel); training
    rejects 'pallas' as JAX does (no gradient); bf16 compute and the
    'hoisted'/'merged' BPTT schedules are accepted, and another compute
    dtype or schedule raises JAX's error (``algos/common.py:37-40``,
    ``algos/core.py:80-82``)."""
    for gat in ("dense", "pallas", "pallas_fused", "pallas_fused_mxu", "graph_parallel"):
        make_args(_agent_args(False, gat_backend=gat, step_backend="pallas"), device="cpu")
    for c in (None, "base", "disc", "commnet", "tarmac", "econv"):
        make_args(dict(_agent_args(False), c=c, n_rounds=2), device="cpu")
    env_info = dict(obs_shape=OBS_SHAPE, state_shape=22, n_actions=N_ACT, n_agents=3,
                    episode_limit=5)
    with pytest.raises(ValueError, match="no custom VJP"):
        MultiAgentQLearner(env_info, make_args(_agent_args(False, gat_backend="pallas"),
                                               device="cpu"))
    for o, c in (("gnn", "disc"), ("gnn", None), ("mlp", None), ("mlp", "econv")):
        info = dict(env_info, obs_shape=OBS_SHAPE if o == "gnn" else 31)
        MultiAgentQLearner(info, make_args(dict(_agent_args(False), o=o, c=c), device="cpu"))
    with pytest.raises(ValueError):
        make_args(_agent_args(False, gat_backend="flash"), device="cpu")
    with pytest.raises(ValueError, match="requires c='tarmac'"):
        make_args(dict(_agent_args(False), c="disc", step_backend="pallas"), device="cpu")
    with pytest.raises(KeyError):
        make_args(dict(_agent_args(False), c="gossip"), device="cpu")
    for accepted in (dict(compute_dtype="bfloat16"), dict(bptt_encoder="hoisted"),
                     dict(bptt_encoder="merged")):
        args = make_args(dict(_agent_args(False), **accepted), device="cpu")
        assert all(getattr(args, k) == v for k, v in accepted.items())
    with pytest.raises(ValueError, match="compute_dtype must be 'float32' or 'bfloat16', "
                                         "got 'float16'"):
        make_args(dict(_agent_args(False), compute_dtype="float16"), device="cpu")
    with pytest.raises(AssertionError, match="^scan$"):
        make_args(dict(_agent_args(False), bptt_encoder="scan"), device="cpu")
    with pytest.raises(ValueError, match="o must be"):
        make_args(dict(_agent_args(False), o="cnn"), device="cpu")


@pytest.mark.parametrize("backend", ["gat_backend", "comm_backend"])
def test_graph_parallel_warns_once_per_slot_count_in_both_packages(backend):
    """``'graph_parallel'`` with no mesh runs dense after a one-time
    ``RuntimeWarning`` per slot count (JAX ``models/encoders.py:31-50``,
    ``models/comm.py:149-160``): 'seen' (M = 6) and 'near' (K = 3) under
    ``gat_backend``, the TarMAC talk attention under ``comm_backend``, with
    JAX's text; a second forward warns no more. The port's one-round TarMAC
    step runs fused (the JAX step under ``step_backend='xla'``) and warns the
    same."""
    from uav_bs_ctrl_tpu_torch.models import encoders as tenc
    kw = dict(_agent_args(False), **{backend: "graph_parallel"})
    slots = ("6", "3") if backend == "gat_backend" else ("tarmac_talk",)
    want = sorted(f"backend='graph_parallel' ({n}) fell back to dense: no mesh registered "
                  "(parallel.graph_parallel.set_graph_parallel_mesh)" for n in slots)
    obs = _obs(np.random.default_rng(11))
    h = np.zeros((3, 4, HIDDEN), np.float32)
    jagent = jagents.GnnAgent(OBS_SHAPE, N_ACT, SN(**kw))
    p = jagent.init(jax.random.PRNGKey(11))
    agent = _load(GnnAgent(OBS_SHAPE, N_ACT, make_args(kw, device="cpu")), p)
    runs = {"jax": lambda: jagent.apply(p, {k: jnp.asarray(v) for k, v in obs.items()},
                                        jnp.asarray(h)),
            "port": lambda: agent(_torch_obs(obs), torch.from_numpy(h))}
    for name, warned in (("jax", jenc._gp_fallback_warned), ("port", tenc._gp_fallback_warned)):
        warned.clear()
        for expected in (want, []):
            with warnings.catch_warnings(record=True) as record:
                warnings.simplefilter("always")
                runs[name]()
            got = sorted(str(w.message) for w in record if w.category is RuntimeWarning
                         and "graph_parallel" in str(w.message))
            assert got == expected, (name, got)
        warned.clear()
