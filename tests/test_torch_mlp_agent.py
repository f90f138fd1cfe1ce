"""The MLP encoder and the agents built on it against the JAX package's, with
converted parameters: ``MLP``, ``DenseObservationEncoder``, ``RnnAgent``
and the MLP-encoder ``GnnAgent`` with every comm protocol, the agent rule
``build_agent``, and the committed exp2 and exp3 MLP/DiscreteComm
checkpoints loaded by the port and written back leaf for leaf.

Small widths (hidden 16, msg 8, key 4) on a flat observation of width 31
(exp2's: 2 + 4 x 5 + 3 x 3); inputs from a numpy seed; DiscreteComm gets
JAX's own Gumbel draw of the agent's key. Tolerance 1e-5 (f32, sums taken in
another order); the re-written checkpoints bit for bit.
"""

import json
import pickle
from pathlib import Path
from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uav_bs_ctrl_tpu.models import agents as jagents
from uav_bs_ctrl_tpu.models import encoders as jenc
from uav_bs_ctrl_tpu.models import modules as jmod
from uav_bs_ctrl_tpu_torch.algos import collect
from uav_bs_ctrl_tpu_torch.algos.madrqn import fused
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import make_args
from uav_bs_ctrl_tpu_torch.envs import torch_env
from uav_bs_ctrl_tpu_torch.models import agents
from uav_bs_ctrl_tpu_torch.models.encoders import DenseObservationEncoder
from uav_bs_ctrl_tpu_torch.models.modules import MLP
from uav_bs_ctrl_tpu_torch.utils.convert import flatten, params_from_jax, params_to_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
D_FLAT, HID, MSG, KEY, N_ACT = 31, 16, 8, 4, 9
W, A = 3, 4
PROTOCOLS = [(None, 1), ("base", 1), ("disc", 1), ("commnet", 2), ("tarmac", 1), ("tarmac", 2),
             ("econv", 2)]
RUNS = ["exp2_fast_r400_iql_qmix/exp2_fast_r400_iql_qmix_s0",
        "exp2_fast_r400_disc/exp2_fast_r400_disc_s0",
        "exp2_fast_r400_tarmac/exp2_fast_r400_tarmac_s0",
        "exp3_fast_4ubs_tarmac_mlp/exp3_fast_4ubs_tarmac_mlp_s0",
        "exp3_fast_4ubs_disc_qmix_lay64k/exp3_fast_4ubs_disc_qmix_lay64k_s0"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, tree):
    module.load_state_dict(params_from_jax(_np(tree), module))
    return module


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=what, **TOL)


def _flat_obs(rng):
    """A flat observation [W, A, 31] and a talk graph with self-loops, except
    one destination (world 0, agent 1) that hears no one."""
    adj = rng.random((W, A, A)) > 0.4
    adj[:, np.arange(A), np.arange(A)] = True
    adj[0, :, 1] = False
    return {"agent": rng.normal(size=(W, A, D_FLAT)).astype(np.float32), "adj": adj}


def _kw(c, n_rounds=1, **extra):
    return dict(o="mlp", c=c, hidden_size=HID, n_layers=2, n_heads=2, msg_size=MSG,
                key_size=KEY, n_rounds=n_rounds, **extra)


@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_mlp_and_dense_encoder_match_jax(n_layers):
    """``MLP`` on a tensor and ``DenseObservationEncoder`` on ``obs["agent"]``,
    from one JAX ``mlp_init`` tree."""
    x = np.random.default_rng(n_layers).normal(size=(W, A, D_FLAT)).astype(np.float32)
    p = jmod.mlp_init(jax.random.PRNGKey(n_layers), D_FLAT, HID, n_layers)
    want = jmod.mlp(p, jnp.asarray(x))
    _close(_load(MLP(D_FLAT, HID, n_layers), p)(torch.from_numpy(x)), want)
    jdense = jenc.DenseObservationEncoder(D_FLAT, SN(hidden_size=HID, n_layers=n_layers))
    enc = _load(DenseObservationEncoder(D_FLAT, HID, n_layers), p)
    _close(enc({"agent": torch.from_numpy(x)}), jdense.apply(p, {"agent": jnp.asarray(x)}))


@pytest.mark.parametrize("dueling", [False, True])
def test_rnn_agent_matches_jax(dueling):
    """MLP -> GRU -> (dueling) head, over two steps carrying h; the talk
    graph is ignored."""
    rng = np.random.default_rng(3)
    obs = [_flat_obs(rng) for _ in range(2)]
    h0 = np.tanh(rng.normal(size=(W, A, HID))).astype(np.float32)
    args = SN(**_kw(None, dueling=dueling))
    jagent = jagents.RnnAgent(D_FLAT, N_ACT, args)
    p = jagent.init(jax.random.PRNGKey(4))
    agent = _load(agents.RnnAgent(D_FLAT, N_ACT, make_args(_kw(None, dueling=dueling),
                                                           device="cpu")), p)
    jh, th = jnp.asarray(h0), torch.from_numpy(h0)
    with torch.no_grad():
        for o in obs:
            jq, jh = jagent.apply(p, {k: jnp.asarray(v) for k, v in o.items()}, jh)
            tq, th = agent({k: torch.from_numpy(v) for k, v in o.items()}, th)
            _close(tq, jq, "q")
            _close(th, jh, "h")
    assert agent.noise_shape((W,), A) is None


@pytest.mark.parametrize("c,n_rounds", PROTOCOLS)
def test_mlp_encoder_gnn_agent_matches_jax(c, n_rounds):
    """The MLP-encoder GnnAgent (exp2's agent with a protocol, the exp3 MLP
    ablation's), through the kernel path (the fused TarMAC step's plain
    version on the CPU for one-round TarMAC) and the unfused one."""
    rng = np.random.default_rng(5)
    obs = _flat_obs(rng)
    h = np.tanh(rng.normal(size=(W, A, HID))).astype(np.float32)
    jagent = jagents.GnnAgent(D_FLAT, N_ACT, SN(**_kw(c, n_rounds)))
    p = jagent.init(jax.random.PRNGKey(6))
    key = jax.random.PRNGKey(7)
    q_want, h_want = jagent.apply(p, {k: jnp.asarray(v) for k, v in obs.items()},
                                  jnp.asarray(h), key)
    agent = _load(agents.GnnAgent(D_FLAT, N_ACT, make_args(_kw(c, n_rounds), device="cpu")), p)
    assert isinstance(agent.enc, DenseObservationEncoder) and ("rnn" in p) == (c is None)
    assert agent.fused_step == (c == "tarmac" and n_rounds == 1)
    shape = agent.noise_shape((W,), A)
    assert (shape is None) == (c != "disc")
    noise = None if shape is None else torch.from_numpy(
        np.array(jax.random.gumbel(key, shape, jnp.float32)))
    with torch.no_grad():
        for use_kernels in (True, False):
            q, h2 = agent({k: torch.from_numpy(v) for k, v in obs.items()}, torch.from_numpy(h),
                          use_kernels=use_kernels, key=noise)
            _close(q, q_want, f"q use_kernels={use_kernels}")
            _close(h2, h_want, f"h use_kernels={use_kernels}")


@pytest.mark.parametrize("o,c", [("mlp", None), ("mlp", "disc"), ("gnn", None), ("gnn", "tarmac")])
def test_build_agent_follows_the_jax_rule(o, c):
    """``RnnAgent`` iff o='mlp' and c is None, else ``GnnAgent``, with the
    JAX agent's parameter tree."""
    shape = D_FLAT if o == "mlp" else {"agent": 2, "gt": 4, "ubs": 2}
    kw = dict(_kw(c), o=o)
    jagent = jagents.build_agent(shape, N_ACT, SN(**kw, gat_backend="dense"))
    agent = agents.build_agent(shape, N_ACT, make_args(kw, device="cpu"))
    assert type(agent).__name__ == type(jagent).__name__
    assert agents.REGISTRY["rnn" if c is None and o == "mlp" else "gnn"] is type(agent)
    want = flatten(_np(jagent.init(jax.random.PRNGKey(0))))
    assert sorted(agent.state_dict()) == sorted(want)
    assert all(tuple(v.shape) == want[k].shape for k, v in agent.state_dict().items())


def test_flatten_obs_lays_out_the_env_obs_as_jax():
    """The flat observation of the exp2 env: own position, GT rows, UBS rows
    (JAX ``fused.py:_agent_apply``), at the width ``obs_shape`` gives."""
    tp = torch_env.make_params("r400")
    gen = torch.Generator().manual_seed(0)
    states = collect.reset_worlds(tp, collect.make_layout_pool("r400", 4, seed=0), gen, 2,
                                  torch.device("cpu"))
    obs = torch_env.get_obs(tp, states)
    flat = collect.flatten_obs(obs)
    assert set(flat) == {"agent", "adj"} and flat["adj"] is obs["adj"]
    assert flat["agent"].shape == (2, tp.n_ubs, fused.obs_shape(tp, "mlp")) == (2, 4, D_FLAT)
    want = jnp.concatenate([jnp.asarray(obs["agent"].numpy()),
                            jnp.asarray(obs["gt"].numpy()).reshape(2, 4, -1),
                            jnp.asarray(obs["ubs"].numpy()).reshape(2, 4, -1)], axis=-1)
    np.testing.assert_array_equal(flat["agent"].numpy(), np.asarray(want))


@pytest.mark.parametrize("run", RUNS)
def test_committed_checkpoint_loads_and_is_rewritten_leaf_for_leaf(run, tmp_path):
    """A committed exp2 run (the iql+QMIX RnnAgent, the DiscreteComm and the
    TarMAC MLP-encoder agents), the exp3 MLP ablation and the exp3 4-UBS
    DiscreteComm+QMIX run: the port's learner, built by the run's
    ``config.json``, loads the newest checkpoint (net, mixer, AdamW state)
    and writes a file that unpickles under optax to the same tree with equal
    leaves."""
    run_dir = ROOT / "data" / run
    config = json.loads((run_dir / "config.json").read_text())
    tp = torch_env.make_params(config["map_id"])
    args = make_args(config["args"], device="cpu")
    env_info = dict(obs_shape=fused.obs_shape(tp, args.o), state_shape=fused.state_shape(tp),
                    n_actions=tp.n_actions, n_agents=tp.n_ubs, episode_limit=tp.episode_limit)
    learner = MultiAgentQLearner(env_info, args)
    assert type(learner.net).__name__ == ("RnnAgent" if args.o == "mlp" and args.c is None
                                          else "GnnAgent")
    ckpt = max(run_dir.glob("checkpoint_epoch*.pt"), key=lambda p: int(p.stem[16:]))
    stamp = learner.load_checkpoint(ckpt)
    path = tmp_path / ckpt.name
    learner.save_checkpoint(path, stamp)
    with open(ckpt, "rb") as f:
        want = pickle.load(f)
    with open(path, "rb") as f:
        got = pickle.load(f)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (p, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                              jax.tree_util.tree_leaves_with_path(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(p)
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(p))
    back = params_to_jax(learner.net.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want["model_state_dict"])
