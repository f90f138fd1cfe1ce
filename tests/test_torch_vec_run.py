"""The port's vectorized trainer (``algos/madrqn/vec_run.py``) and
``torch_env.reset``/``rollout`` against the JAX package's.

- ``reset``: shapes, positions in ``[0, range_pos)``, priority permutations,
  the same draws from the same seed, and the state equal to
  ``reset_from_positions`` of the positions it drew.
- ``rollout`` at ``eps=0`` on ``debug``: a TarMAC ``GnnAgent`` whose JAX
  params are carried across by ``utils/convert.py``, from the same initial
  states (the debug layout, JAX's priority draws); rewards and final positions within
  1e-5 of ``jax_env.rollout`` per world. An exact tie of two GTs' average
  rates can fall an ulp apart in the two packages and reorder the next
  priorities (``tests/test_torch_env.py``); none occurs on these worlds.
- ``train_vectorized`` on ``debug`` at ``tests/test_vec_train.py``'s sizes
  (``gnn``/``tarmac`` and ``mlp``/``double_q``): ``progress.txt`` has JAX's
  header in JAX's order and the JAX run's ``Epoch`` and
  ``TotalEnvInteracts`` columns at the same kwargs; the last checkpoint loads
  into JAX's ``MultiAgentQLearner`` and into the port's classic learner, and
  both act the same on the same observation.
- Without ``device='cpu'`` it raises on a machine without CUDA.
"""

import functools
from pathlib import Path
from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uav_bs_ctrl_tpu.algos import collect as jcollect
from uav_bs_ctrl_tpu.algos.common import check_args_sanity as jax_check_args
from uav_bs_ctrl_tpu.algos.madrqn.config import DEFAULT_CONFIG as JAX_DEFAULTS
from uav_bs_ctrl_tpu.algos.madrqn.learner import MultiAgentQLearner as JaxLearner
from uav_bs_ctrl_tpu.algos.madrqn.vec_run import train_vectorized as jax_train_vectorized
from uav_bs_ctrl_tpu.algos.madrqn.wrappers import make_env as jax_make_env
from uav_bs_ctrl_tpu.envs import jax_env
from uav_bs_ctrl_tpu.envs.mubs_cov import MultiUbsCoverageEnv as JaxMubs
from uav_bs_ctrl_tpu.models.agents import GnnAgent as JaxGnnAgent
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.algos.madrqn.vec_run import train_vectorized
from uav_bs_ctrl_tpu_torch.algos.madrqn.wrappers import make_env
from uav_bs_ctrl_tpu_torch.config import make_args
from uav_bs_ctrl_tpu_torch.envs import torch_env
from uav_bs_ctrl_tpu_torch.envs.mubs_cov import MultiUbsCoverageEnv
from uav_bs_ctrl_tpu_torch.models.agents import GnnAgent
from uav_bs_ctrl_tpu_torch.utils.convert import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
AGENT_ARGS = dict(hidden_size=32, n_layers=1, n_heads=4, msg_size=16, key_size=8,
                  n_rounds=1, dueling=False, c="tarmac", o="gnn")
OBS_SHAPE = dict(agent=2, gt=4, ubs=2)
# tests/test_vec_train.py:test_train_vectorized_end_to_end's kwargs.
VEC_KW = dict(device="cpu", hidden_size=16, msg_size=8, batch_size=4, replay_size=64,
              steps_per_epoch=80, epochs=2, decay_steps=100, save_freq=10)
VEC_CASES = [dict(o="gnn", c="tarmac"), dict(o="mlp", c=None, double_q=True)]


def _table(path):
    lines = Path(path).read_text().splitlines()
    head = lines[0].split("\t")
    return head, [dict(zip(head, line.split("\t"))) for line in lines[1:]]


# ------------------------------------------------------------------- reset

@pytest.mark.parametrize("map_id", ["debug", "4ubs", "8ubs"])
def test_reset_draws_uniform_worlds_through_reset_from_positions(map_id):
    params = torch_env.make_params(map_id)
    state = torch_env.reset(params, torch.Generator().manual_seed(0), "cpu", 64)
    N, M = params.n_ubs, params.n_gts
    assert state.pos_ubs.shape == (64, N, 2) and state.pos_gts.shape == (64, M, 2)
    for pos in (state.pos_ubs, state.pos_gts):
        assert pos.dtype == torch.float32
        assert (pos >= 0).all() and (pos < params.range_pos).all()
        assert pos.std() > params.range_pos / 5        # spread over the map, not a pool layout
    assert torch.equal(state.prior_gts.sort(-1).values, torch.arange(M).expand(64, M))
    assert (state.t == 0).all()
    again = torch_env.reset(params, torch.Generator().manual_seed(0), "cpu", 64)
    other = torch_env.reset(params, torch.Generator().manual_seed(1), "cpu", 64)
    assert torch.equal(again.pos_ubs, state.pos_ubs) and torch.equal(again.prior_gts,
                                                                      state.prior_gts)
    assert not torch.equal(other.pos_ubs, state.pos_ubs)
    # The reset's own positions and priorities, before its service pass reordered them.
    gen = torch.Generator().manual_seed(0)
    pos_ubs = torch.rand((64, N, 2), generator=gen) * params.range_pos
    pos_gts = torch.rand((64, M, 2), generator=gen) * params.range_pos
    prior = torch.argsort(torch.rand((64, M), generator=gen), dim=-1)
    want = torch_env.reset_from_positions(params, pos_ubs, pos_gts, prior)
    for name in torch_env.EnvState._fields:
        assert torch.equal(getattr(state, name), getattr(want, name)), name


# ----------------------------------------------------------------- rollout

def test_rollout_matches_jax_rollout_at_eps_0():
    params_j = jax_env.make_params("debug")
    params = torch_env.make_params("debug")
    n_worlds, n_steps = 3, params.episode_limit
    jagent = JaxGnnAgent(OBS_SHAPE, params.n_actions, SN(**AGENT_ARGS))
    p = jagent.init(jax.random.PRNGKey(0))
    agent = GnnAgent(OBS_SHAPE, params.n_actions, make_args(AGENT_ARGS, device="cpu"))
    agent.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, p), agent))

    # The debug map's own layout (UBSs within range of GTs: a uniform reset
    # of its 1 km square serves no one), with each world's priorities drawn.
    pool = jcollect.make_layout_pool("debug", 1, seed=0)
    states_j = jcollect.reset_worlds(params_j, pool, jax.random.PRNGKey(1), n_worlds)
    h0 = jnp.zeros((n_worlds, params.n_ubs, AGENT_ARGS["hidden_size"]))
    roll = jax.jit(jax.vmap(functools.partial(jax_env.rollout, params_j, jagent.apply, p),
                            in_axes=(0, 0, 0, None)), static_argnums=3)
    final_j, rews_j = roll(states_j, h0, jax.random.split(jax.random.PRNGKey(2), n_worlds),
                           n_steps)

    state0 = torch_env.reset_from_positions(
        params, *(torch.as_tensor(np.array(getattr(states_j, k)))
                  for k in ("pos_ubs", "pos_gts", "prior_gts")))
    with torch.no_grad():
        final, rews = torch_env.rollout(params, agent, state0, torch.zeros(tuple(h0.shape)),
                                        torch.Generator().manual_seed(3), n_steps, eps=0.0)
    assert rews.shape == (n_worlds, n_steps, params.n_ubs)
    assert (final.t == n_steps).all()
    np.testing.assert_allclose(rews.numpy(), np.asarray(rews_j), **TOL)
    np.testing.assert_allclose(final.pos_ubs.numpy(), np.asarray(final_j.pos_ubs), **TOL)
    np.testing.assert_allclose(final.ep_ret.numpy(), np.asarray(final_j.ep_ret), **TOL)
    assert np.abs(np.asarray(rews_j)).sum() > 0


def test_rollout_is_greedy_at_eps_0_and_explores_at_eps_1():
    params = torch_env.make_params("debug")
    state0 = torch_env.reset(params, torch.Generator().manual_seed(0), "cpu", 4)
    calls = []

    def policy(obs, h, key=None):
        calls.append(int(key) is not None)
        q = torch.zeros(tuple(obs["agent"].shape[:2]) + (params.n_actions,))
        q[..., 3] = 1.0                                   # greedy: action 3 everywhere
        return q, h

    h0 = torch.zeros((4, params.n_ubs, 1))
    greedy, _ = torch_env.rollout(params, policy, state0, h0, torch.Generator(), 5, eps=0.0)
    moves = torch.tensor(params.avail_moves[3], dtype=torch.float32)
    want = torch.clamp(state0.pos_ubs + 5 * moves, 0, params.range_pos)
    assert torch.allclose(greedy.pos_ubs, want) and len(calls) == 5
    explored, _ = torch_env.rollout(params, policy, state0, h0,
                                    torch.Generator().manual_seed(0), 5, eps=1.0)
    assert not torch.allclose(explored.pos_ubs, want)


# -------------------------------------------------------- train_vectorized

@pytest.fixture(scope="module", params=range(len(VEC_CASES)), ids=["gnn_tarmac", "mlp_double_q"])
def vec_runs(request, tmp_path_factory):
    kw = dict(VEC_KW, **VEC_CASES[request.param])
    root = tmp_path_factory.mktemp(f"vec{request.param}")
    common = dict(seed=0, n_worlds=2, n_layouts=4, updates_per_chunk=2)
    learner = train_vectorized("debug", train_kwargs=kw,
                               logger_kwargs=dict(output_dir=str(root / "port"),
                                                  exp_name="vec"), **common)
    jax_train_vectorized("debug", train_kwargs=kw,
                         logger_kwargs=dict(output_dir=str(root / "jax"), exp_name="vec"),
                         **common)
    return SN(kw=kw, learner=learner, port=root / "port", jax=root / "jax")


def test_train_vectorized_writes_jax_columns_and_epochs(vec_runs):
    head, rows = _table(vec_runs.port / "progress.txt")
    jax_head, jax_rows = _table(vec_runs.jax / "progress.txt")
    assert head == jax_head
    assert head[-4:] == ["TimeCollectMs", "TimeUpdateMs", "EnvStepsPerSec", "Time"]
    cols = ("Epoch", "TotalEnvInteracts")
    assert [[r[c] for c in cols] for r in rows] == [[r[c] for c in cols] for r in jax_rows] \
        == [["1", "80"], ["2", "160"]]
    for row in rows:
        assert all(np.isfinite(float(v)) for v in row.values())
        assert float(row["EnvStepsPerSec"]) > 0
    # debug: 10-step episodes, 2 worlds -> 8 chunks of 2 episodes; updates from the second.
    assert len(vec_runs.learner.buffer) == 16
    assert vec_runs.learner.optimizer.state[vec_runs.learner.parameters()[0]]["step"] == 14
    ckpts = sorted(p.name for p in vec_runs.port.glob("checkpoint_epoch*.pt"))
    assert ckpts == sorted(p.name for p in vec_runs.jax.glob("checkpoint_epoch*.pt")) \
        == ["checkpoint_epoch2.pt"]


def test_train_vectorized_checkpoint_loads_in_both_learners(vec_runs):
    """The last checkpoint in JAX's ``MultiAgentQLearner`` (as
    ``tests/test_vec_train.py`` loads its own) and in the port's classic
    learner: the same greedy actions and h' on the same first observation."""
    ckpt = str(vec_runs.port / "checkpoint_epoch2.pt")
    cfg = dict(JAX_DEFAULTS)
    cfg.update(vec_runs.kw, max_seq_len=None)
    jargs = jax_check_args(SN(**cfg))
    np.random.seed(0)
    jenv = jax_make_env(lambda: JaxMubs(map_id="debug", record=False, use_native=False), jargs)
    jlearner = JaxLearner(jenv.get_env_info(), jargs, seed=9)
    assert jlearner.load_checkpoint(ckpt) == {"epoch": 2, "t": 160}

    args = make_args(dict(vec_runs.kw, max_seq_len=None), "cpu")
    env = make_env(functools.partial(MultiUbsCoverageEnv, "debug", record=False,
                                     rng=np.random.RandomState(0)), args)
    learner = MultiAgentQLearner(env.get_env_info(), args, seed=9)
    assert learner.load_checkpoint(ckpt) == {"epoch": 2, "t": 160}
    for got, want in zip(learner.parameters(), vec_runs.learner.parameters()):
        assert torch.equal(got, want)

    (o, _), h = env.reset(), learner.init_hidden()
    (jo, _), jh = jenv.reset(), jlearner.init_hidden()
    a, h2 = learner.act(o, h, 0.0, np.random.RandomState(1))
    np.random.seed(1)
    ja, jh2 = jlearner.act(jo, jh, 0.0)
    assert len(a) == env.n_agents and list(a) == list(ja)
    np.testing.assert_allclose(h2, np.asarray(jh2), **TOL)


def test_train_vectorized_runs_on_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available, so the default device works")
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        train_vectorized("debug", train_kwargs=dict(VEC_KW, device=None),
                         logger_kwargs=dict(output_dir=str(tmp_path / "run")))
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        train_vectorized("debug", train_kwargs={k: v for k, v in VEC_KW.items()
                                                if k != "device"},
                         logger_kwargs=dict(output_dir=str(tmp_path / "run2")))
