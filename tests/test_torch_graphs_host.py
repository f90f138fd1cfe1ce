"""The host loop's one-world ``act``, ``vec_run``'s collection and
``torch_env.rollout`` as programs (JAX's ``_act_jit``, the jitted
``collect_chunk`` and the ``lax.scan`` of ``jax_env.rollout``) on the CPU.

On a CPU device a program calls its body directly, so these tests run the
bodies on the draws the host makes before the call: each must give its
eager twin's bits, leave every generator (the NumPy stream too) where the
eager path leaves it, and pass ``check_capturable``; the programs' greedy
actions, h' and rollouts also hold to the JAX package on the same inputs.
"""

import json
from functools import partial
from pathlib import Path
from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_host_drivers as host_drivers
from uav_bs_ctrl_tpu.algos import collect as jcollect
from uav_bs_ctrl_tpu.envs import jax_env
from uav_bs_ctrl_tpu.models.agents import GnnAgent as JaxGnnAgent
from uav_bs_ctrl_tpu_torch import graphs, test_policies
from uav_bs_ctrl_tpu_torch.algos import collect
from uav_bs_ctrl_tpu_torch.algos.buffer import tree_leaves
from uav_bs_ctrl_tpu_torch.algos.drqn.config import DEFAULT_CONFIG as DRQN_DEFAULTS
from uav_bs_ctrl_tpu_torch.algos.drqn.config import check_args
from uav_bs_ctrl_tpu_torch.algos.drqn.learner import QLearner
from uav_bs_ctrl_tpu_torch.algos.drqn.wrappers import make_env as make_drqn_env
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.algos.madrqn.vec_run import collection_body, train_vectorized
from uav_bs_ctrl_tpu_torch.algos.madrqn.vec_run import env_info as vec_env_info
from uav_bs_ctrl_tpu_torch.algos.madrqn.wrappers import make_env
from uav_bs_ctrl_tpu_torch.config import DEFAULT_CONFIG, check_args_sanity, make_args
from uav_bs_ctrl_tpu_torch.envs import torch_env, torch_env_subs
from uav_bs_ctrl_tpu_torch.models.agents import GnnAgent
from uav_bs_ctrl_tpu_torch.models.modules import gumbel_draw
from uav_bs_ctrl_tpu_torch.utils.convert import params_from_jax

from test_torch_graphs import _assert_same_bits, _learner_state, check_capturable
from test_torch_vec_run import AGENT_ARGS, OBS_SHAPE, VEC_CASES, VEC_KW, _table


def test_a_namedtuple_state_round_trips_through_a_programs_tree():
    """A program's inputs and outputs keep an env state's class: the state
    comes back with its fields (and ``_replace``), beside plain tuples and
    lists."""
    params = torch_env.make_params("debug")
    state = torch_env.reset(params, torch.Generator().manual_seed(0), "cpu", 2)
    subs = torch_env_subs.reset_from_positions(
        torch_env_subs.make_params(), torch.zeros((2, 2)), torch.zeros((2, 2, 2)),
        torch.arange(2).expand(2, 2))
    tree = (state, [subs, (state.t, None)], {"h": torch.ones(1)})
    leaves, spec = graphs._flatten(tree)
    assert len(leaves) == len(state) + len(subs) + 2
    back = graphs._unflatten(leaves, spec)
    assert type(back[0]) is torch_env.EnvState and type(back[1][0]) is torch_env_subs.SubsState
    assert type(back[1]) is list and type(back[1][1]) is tuple and back[1][1][1] is None
    for a, b in zip(back[0], state):
        assert a is b
    assert back[0]._replace(t=state.t + 1).t.tolist() == [1, 1]
    kept = graphs.clone_tree(tree)
    assert type(kept[0]) is torch_env.EnvState and kept[0].pos_ubs is not state.pos_ubs
    assert torch.equal(kept[0].pos_ubs, state.pos_ubs)


# ------------------------------------------------------------------- act

ROOT = Path(__file__).resolve().parents[1]
ACT_RUNS = {   # the classic host loop's runs, and the 4-UBS DiscreteComm (its Gumbel key)
    "exp1_gnn": host_drivers.RUNS["exp1_gnn"],
    "4ubs_tarmac_qmix": host_drivers.RUNS["4ubs_tarmac_qmix"],
    "4ubs_disc": ("exp3_fast_4ubs_disc_lay64k/exp3_fast_4ubs_disc_lay64k_s0",
                  "checkpoint_epoch200.pt"),
}
RUN_8UBS = ("exp3_fast_8ubs_tarmac_qmix_il10_lay64k/exp3_fast_8ubs_tarmac_qmix_il10_lay64k_s0",
            "checkpoint_epoch200.pt")


def _port_learner(run, seed, graphs_on):
    """The port's learner of a committed run (its checkpoint loaded) on its
    host env, which draws from ``RandomState(seed)``; returns ``(algo,
    learner, env, rng)``."""
    run_dir, ckpt = ACT_RUNS[run]
    config = json.loads((ROOT / "data" / run_dir / "config.json").read_text())
    algo, env_fn, env_kwargs, saved = test_policies.parse_run_config(config, device="cpu")
    rng = np.random.RandomState(seed)
    if algo == "drqn":
        args = check_args(SN(**{**DRQN_DEFAULTS, **saved}))
        env = make_drqn_env(partial(env_fn, **env_kwargs, record=False, rng=rng), args)
        learner = QLearner(env.get_env_info(), args, seed=seed, graphs=graphs_on)
    else:
        args = check_args_sanity(SN(**{**DEFAULT_CONFIG, **saved}))
        env = make_env(partial(env_fn, **env_kwargs, record=False, rng=rng), args)
        learner = MultiAgentQLearner(env.get_env_info(), args, seed=seed, graphs=graphs_on)
    learner.load_checkpoint(str(ROOT / "data" / run_dir / ckpt))
    return algo, learner, env, rng


def _host_steps(run, graphs_on, n_steps=12, eps=0.3):
    """``n_steps`` host steps of ``act`` and the env; each step's actions,
    h', and the streams' states after."""
    algo, learner, env, rng = _port_learner(run, 4, graphs_on)
    o, h, out = env.reset(), learner.init_hidden(), []
    o = o[0] if algo == "madrqn" else o                  # the madrqn env's (obs, state)
    for _ in range(n_steps):
        a, h = learner.act(o, h, eps, rng)
        out.append((a, h))
        o = env.step(a if algo == "madrqn" else a[0])[0]
    return learner, out, rng.random(), learner.noise_generator.get_state()


@pytest.mark.parametrize("run", sorted(ACT_RUNS))
def test_the_act_program_gives_the_eager_act_over_a_host_episode(run):
    """``act`` at ``graphs`` on and off over a short host episode of a
    committed run at full width, each from its own ``RandomState`` of the
    same seed: the actions, h' bit for bit (dtype, shape and layout too),
    the NumPy stream and the learner's noise generator (DiscreteComm draws
    its key from it) where the eager path leaves them; the program is the
    learner's ``"act"``."""
    prog, got, got_rng, got_noise = _host_steps(run, True)
    eager, want, want_rng, want_noise = _host_steps(run, False)
    for (a, h), (a2, h2) in zip(got, want):
        assert a == a2 and all(type(x) is int for x in a)
        assert h.dtype == h2.dtype and h.flags.c_contiguous and np.array_equal(h, h2)
    assert got_rng == want_rng and torch.equal(got_noise, want_noise)
    assert set(prog._programs) == {"act"} and not eager._programs
    assert len({tuple(a) for a, _ in got}) > 1


@pytest.mark.parametrize("run", ["exp1_gnn", "4ubs_disc"])
def test_the_act_body_makes_no_host_sync_and_no_host_tensor(run):
    algo, learner, env, _ = _port_learner(run, 4, True)
    o = env.reset()
    o = o[0] if algo == "madrqn" else o
    shape = learner.net.noise_shape((1,), learner.n_agents)
    key = None if shape is None else gumbel_draw(shape, learner.noise_generator, "cpu")
    obs = {k: learner._staged(k, v) for k, v in o.items()}
    h = learner._staged("h", learner.init_hidden())
    learner._act_body(obs, h, key)                       # the first call
    out = check_capturable(learner._act_body, obs, h, key)
    assert tuple(out.shape) == (learner.n_agents, 1 + learner.net.hidden)


@pytest.mark.parametrize("run", ["8ubs", "exp1_gnn"])
def test_the_act_program_matches_jax_act_fn_at_full_width(monkeypatch, run):
    """The act program's greedy actions and h' (``act`` at eps 0, its
    program on) against JAX's ``_act_fn`` on the same observations and h,
    for the committed 8-UBS TarMAC+QMIX and exp1 4 x 5 gnn checkpoints:
    actions equal, h' within 1e-4 over 10 host steps."""
    if run == "8ubs":
        monkeypatch.setitem(host_drivers.RUNS, "8ubs", RUN_8UBS)
    algo, (jl, jenv), (tl, env, rng) = host_drivers._learner_pair(run, 4)
    assert tl.graphs
    o = env.reset()
    o = o[0] if algo == "madrqn" else o
    h = tl.init_hidden()
    for t in range(10):
        a, h2 = tl.act(o, h, 0.0, rng)
        jg, jh = jl._act_jit(jl.params, {k: jnp.asarray(v) for k, v in o.items()},
                             jnp.asarray(h), jax.random.PRNGKey(t))
        assert a == np.asarray(jg).tolist(), f"step {t}"
        np.testing.assert_allclose(h2, np.asarray(jh), atol=1e-4, rtol=1e-4, err_msg=f"step {t}")
        o = env.step(a if algo == "madrqn" else a[0])[0]
        h = h2
    assert set(tl._programs) == {"act"}


# --------------------------------------------------------------- vec_run

@pytest.mark.parametrize("case", range(len(VEC_CASES)), ids=["gnn_tarmac", "mlp_double_q"])
def test_vec_run_on_programs_gives_the_eager_run(tmp_path, case):
    """``train_vectorized`` on ``debug`` at ``tests/test_torch_vec_run.py``'s
    sizes with and without programs: every non-time ``progress.txt`` column,
    the replay buffer, and the learner's params, targets, AdamW state and
    ``.grad``, bit for bit."""
    kw = dict(VEC_KW, **VEC_CASES[case])
    runs = {}
    for graphs_on in (True, False):
        out = tmp_path / str(graphs_on)
        learner = train_vectorized("debug", train_kwargs=kw, seed=0, n_worlds=2, n_layouts=4,
                                   updates_per_chunk=2, graphs=graphs_on,
                                   logger_kwargs=dict(output_dir=str(out), exp_name="vec"))
        head, rows = _table(out / "progress.txt")
        runs[graphs_on] = (learner, [{k: v for k, v in r.items() if not k.startswith("Time")
                                      and k != "EnvStepsPerSec"} for r in rows])
    (prog, got), (eager, want) = runs[True], runs[False]
    assert got == want and len(got) == 2
    assert set(prog._programs) == {("batch", True)} and not eager._programs
    for a, b in zip(tree_leaves(prog.buffer._storage), tree_leaves(eager.buffer._storage)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    _assert_same_bits(_learner_state(prog), _learner_state(eager))


@pytest.mark.parametrize("o", ["gnn", "mlp"])
def test_vec_runs_collection_body_gives_the_eager_chunk_and_is_capturable(o):
    params = torch_env.make_params("debug")
    kw = dict(VEC_KW, **VEC_CASES[o == "mlp"])
    args = make_args(dict(kw, max_seq_len=None), "cpu")
    learner = MultiAgentQLearner(vec_env_info(params, args.o), args, seed=0)
    policy = collect.make_policy(learner._apply_net, args.o)
    pool = collect.make_layout_pool("debug", 4, seed=0)
    draws, noise = collect.draw_episode(params, 4, torch.Generator().manual_seed(1), 3, 0.5,
                                        None, "cpu")
    chunk, stats = check_capturable(collection_body, draws, noise, params, policy,
                                    collect.pool_on(pool, "cpu"), args.hidden_size, args.o)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        states = collect.reset_worlds(params, pool, gen, 3, "cpu")
        want, _, want_stats = collect.collect_chunk(
            params, policy, states, torch.zeros((3, params.n_ubs, args.hidden_size)),
            params.episode_limit, gen, 0.5)
    if o == "mlp":
        want["obs"] = collect.flatten_obs(want["obs"])
    for a, b in zip(tree_leaves(chunk), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(torch.equal(stats[k], want_stats[k]) for k in want_stats)


# --------------------------------------------------------------- rollout

def _tiny_agent(c):
    params = torch_env.make_params("debug")
    args = make_args(dict(AGENT_ARGS, c=c), device="cpu")
    torch.manual_seed(0)
    return params, GnnAgent(OBS_SHAPE, params.n_actions, args)


@pytest.mark.parametrize("eps", [0.0, 0.5])
@pytest.mark.parametrize("c", ["tarmac", "disc"])
def test_the_rollout_program_gives_the_eager_rollout(c, eps):
    """``torch_env.rollout`` with ``graphs`` on and off from the same state,
    h0 and generator seed (DiscreteComm: the noise drawn from each step's
    seed): the final state (an ``EnvState``), the rewards and the generator
    bit for bit; a second program call is the kept program's."""
    params, agent = _tiny_agent(c)
    state0 = torch_env.reset(params, torch.Generator().manual_seed(0), "cpu", 3)
    h0 = torch.zeros((3, params.n_ubs, AGENT_ARGS["hidden_size"]))
    shape = agent.noise_shape((3,), params.n_ubs)
    torch_env._rollouts.clear()
    runs = {}
    for graphs_on in (True, True, False):
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            final, rews = torch_env.rollout(params, agent, state0, h0, gen, 6, eps,
                                            noise_shape=shape, graphs=graphs_on)
        runs.setdefault(graphs_on, []).append((final, rews, gen.get_state()))
    want = runs[False][0]
    for got in runs[True]:
        assert type(got[0]) is torch_env.EnvState
        for a, b in zip(got[0], want[0]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert len(torch_env._rollouts) == 1
    if eps:
        greedy = torch_env.rollout(params, agent, state0, h0, torch.Generator().manual_seed(5),
                                   6, 0.0, noise_shape=shape, graphs=True)[1]
        assert not torch.equal(greedy, want[1])                 # the coins decided some steps
    torch_env._rollouts.clear()


@pytest.mark.parametrize("c", ["tarmac", "disc"])
def test_the_rollout_body_makes_no_host_sync_and_no_host_tensor(c):
    params, agent = _tiny_agent(c)
    state0 = torch_env.reset(params, torch.Generator().manual_seed(0), "cpu", 3)
    h0 = torch.zeros((3, params.n_ubs, AGENT_ARGS["hidden_size"]))
    shape = agent.noise_shape((3,), params.n_ubs)
    rand, explore, seeds = collect.draw_steps(torch.Generator().manual_seed(1), 4,
                                              (3, params.n_ubs), params.n_actions, 0.5,
                                              shape is not None)
    noise = None if shape is None else torch.stack(
        [collect.gumbel_noise(shape, s, "cpu") for s in seeds])
    with torch.no_grad():
        check_capturable(torch_env._rollout_body, state0, h0, rand, explore, noise, params,
                         agent)


def test_a_rollout_program_whose_policy_reads_an_undrawn_key_raises():
    """A DiscreteComm policy run as a program without ``noise_shape`` reads a
    key that was not drawn: it raises, where a draw inside the body would
    silently leave the eager path's stream."""
    params, agent = _tiny_agent("disc")
    state0 = torch_env.reset(params, torch.Generator().manual_seed(0), "cpu", 2)
    h0 = torch.zeros((2, params.n_ubs, AGENT_ARGS["hidden_size"]))
    with pytest.raises(RuntimeError, match="no noise was drawn"), torch.no_grad():
        torch_env.rollout(params, agent, state0, h0, torch.Generator(), 3, graphs=True)
    torch_env._rollouts.clear()


def test_the_rollout_program_matches_jax_rollout_at_eps_0():
    """``tests/test_torch_vec_run.py``'s comparison with ``jax_env.rollout``
    (the debug layout, JAX's priority draws, a TarMAC agent on JAX's
    weights) on the program path: rewards and the final positions and
    returns within 1e-5."""
    params_j, params = jax_env.make_params("debug"), torch_env.make_params("debug")
    n_worlds, n_steps = 3, params.episode_limit
    jagent = JaxGnnAgent(OBS_SHAPE, params.n_actions, SN(**AGENT_ARGS))
    p = jagent.init(jax.random.PRNGKey(0))
    agent = GnnAgent(OBS_SHAPE, params.n_actions, make_args(AGENT_ARGS, device="cpu"))
    agent.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, p), agent))
    pool = jcollect.make_layout_pool("debug", 1, seed=0)
    states_j = jcollect.reset_worlds(params_j, pool, jax.random.PRNGKey(1), n_worlds)
    h0 = jnp.zeros((n_worlds, params.n_ubs, AGENT_ARGS["hidden_size"]))
    roll = jax.jit(jax.vmap(partial(jax_env.rollout, params_j, jagent.apply, p),
                            in_axes=(0, 0, 0, None)), static_argnums=3)
    final_j, rews_j = roll(states_j, h0, jax.random.split(jax.random.PRNGKey(2), n_worlds),
                           n_steps)
    state0 = torch_env.reset_from_positions(
        params, *(torch.as_tensor(np.array(getattr(states_j, k)))
                  for k in ("pos_ubs", "pos_gts", "prior_gts")))
    with torch.no_grad():
        final, rews = torch_env.rollout(params, agent, state0, torch.zeros(tuple(h0.shape)),
                                        torch.Generator().manual_seed(3), n_steps, eps=0.0,
                                        graphs=True)
    np.testing.assert_allclose(rews.numpy(), np.asarray(rews_j), rtol=1e-5, atol=1e-5)
    for k in ("pos_ubs", "ep_ret", "avg_rate_per_gt", "t"):
        np.testing.assert_allclose(getattr(final, k).numpy(), np.asarray(getattr(final_j, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert np.abs(np.asarray(rews_j)).sum() > 0
    torch_env._rollouts.clear()
