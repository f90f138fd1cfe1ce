"""exp1's programs (the single-UBS env's step, its episodes on draws, the
DRQN fused trainer's collection and ring-fed updates, its test episodes and
the served exp1 episode) on the CPU.

On a CPU device a program calls its body directly, so these tests run the
bodies on the draws the host makes before the call: each must give the
eager path's bits and leave the generator where the eager path leaves it,
and pass ``check_capturable`` (no host sync, no tensor made from host data).
The capture itself needs a card (``chip_smoke.py``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uav_bs_ctrl_tpu.algos import collect_subs as jcollect_subs
from uav_bs_ctrl_tpu.envs import jax_env_subs
from uav_bs_ctrl_tpu.models.agents import DRQN_REGISTRY as JAX_DRQN_REGISTRY
from uav_bs_ctrl_tpu_torch import serve
from uav_bs_ctrl_tpu_torch.algos import collect, collect_subs
from uav_bs_ctrl_tpu_torch.algos.buffer import tree_leaves
from uav_bs_ctrl_tpu_torch.algos.drqn.fused import FusedDrqnTrainer, obs_shape
from uav_bs_ctrl_tpu_torch.envs import torch_env_subs
from uav_bs_ctrl_tpu_torch.models.agents import DRQN_REGISTRY
from uav_bs_ctrl_tpu_torch.utils.convert import params_from_jax

from test_torch_collect_subs import ARGS, HID, TOL, W, _jax_apply
from test_torch_graphs import _assert_same_bits, _learner_state, check_capturable

ENV = dict(n_grps=2, gts_per_grp=3, episode_limit=20)
EXP1_DIRS = {a: Path(__file__).resolve().parents[1] / "data" / f"exp1_fast_grp4_size5_{a}" /
             f"exp1_fast_grp4_size5_{a}_s0" for a in ("gnn", "rnn")}


def _step_before_its_moves_were_cached(params, state, action):
    """``torch_env_subs.step`` as it was: the moves table made from the
    host's tuples at every call."""
    move = torch.tensor(params.avail_moves, dtype=torch.float32, device=action.device)[action]
    pos = torch.clamp(state.pos_ubs + move, 0, params.range_pos)
    state = torch_env_subs._transmit(params, state._replace(t=state.t + 1, pos_ubs=pos))
    rew = params.reward_scale_rate * state.global_util / params.max_rate
    state = state._replace(ep_ret=state.ep_ret + rew)
    return state, torch_env_subs.get_obs(params, state), rew, state.t == params.episode_limit


def _subs_state(params, n_worlds=3):
    gen = torch.Generator().manual_seed(0)
    gts = torch.rand((n_worlds, params.n_gts, 2), generator=gen) * 400 + 300
    prior = torch.argsort(torch.rand((n_worlds, params.n_gts), generator=gen), -1)
    return torch_env_subs.reset_from_positions(
        params, torch.full((n_worlds, 2), params.range_pos / 2), gts, prior)


@pytest.mark.parametrize("old", [False, True])
def test_a_subs_step_copies_nothing_from_the_host(old):
    """The single-UBS env step reads its moves table from a device constant
    made once (at a program's first call, which runs eagerly before the
    capture); the step as it was, which made the table at every call, fails
    the check."""
    params = torch_env_subs.make_params(**ENV)
    state, action = _subs_state(params), torch.tensor([0, 1, 3])
    step = _step_before_its_moves_were_cached if old else torch_env_subs.step
    step(params, state, action)                   # the first call
    if old:
        with pytest.raises(AssertionError, match="lift_fresh"):
            check_capturable(step, params, state, action)
        return
    got = check_capturable(step, params, state, action)
    want = _step_before_its_moves_were_cached(params, state, action)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[2], want[2])


# ------------------------------------------------------------ the episodes

def _policy(agent, env=ENV):
    """A port exp1 agent at hidden 16 from JAX's initial weights, as a
    rollout policy, and the JAX agent and its params."""
    jagent, jparams, tagent = _jax_agents(agent, env)
    return collect_subs.make_policy(tagent, agent), jagent, jparams


def _jax_agents(agent, env):
    params = jax_env_subs.make_params(**env)
    shape = obs_shape(params, agent)
    jagent = JAX_DRQN_REGISTRY[agent](shape, params.n_actions, ARGS)
    jparams = jagent.init(jax.random.PRNGKey(3))
    tagent = DRQN_REGISTRY[agent](shape, params.n_actions, ARGS)
    tagent.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tagent))
    return jagent, jparams, tagent


def test_draw_episode_at_one_agent_draws_what_the_eager_exp1_episode_draws():
    """``collect.draw_episode`` on the single-UBS params (A = 1) makes the
    draws of ``reset_subs_worlds`` and ``collect_episode_subs``, in their
    order, and leaves the generator where they leave it; the ring slots of
    S chunks a world come back world-major."""
    params = torch_env_subs.make_params(**ENV)
    pool = collect_subs.make_subs_layout_pool(4, seed=1, **ENV)
    policy, _, _ = _policy("gnn")
    gen_a, gen_b = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    slots = torch.arange(12).reshape(W, 4) + 30
    draws, noise = collect.draw_episode(params, 4, gen_a, W, 0.4, None, "cpu", slots)
    assert noise is None
    states = collect_subs.reset_subs_worlds(params, pool, gen_b, W, torch.device("cpu"))
    with torch.no_grad():
        collect_subs.collect_episode_subs(params, policy, states, torch.zeros((W, 1, HID)),
                                          params.episode_limit, 5, gen_b, 0.4)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    d = collect.unpack_draws(draws, params)
    assert tuple(d.rand.shape) == (params.episode_limit, W, 1)
    assert tuple(d.explore.shape) == (params.episode_limit, W, 1)
    assert torch.equal(d.slot, torch.arange(30, 42))


@pytest.mark.parametrize("agent", ["gnn", "rnn"])
def test_the_collection_body_gives_the_eager_chunks_bit_for_bit(agent):
    """``collect_subs.collect_on_draws`` on the draws against
    ``reset_subs_worlds`` and ``collect_episode_subs`` from the same
    generator: every chunk leaf, the stats and the slots; the body passes
    ``check_capturable``."""
    params = torch_env_subs.make_params(**ENV)
    pool = collect_subs.make_subs_layout_pool(4, seed=1, **ENV)
    policy, _, _ = _policy(agent)
    slots = torch.arange(W * 4)
    draws, noise = collect.draw_episode(params, 4, torch.Generator().manual_seed(2), W, 0.5,
                                        None, "cpu", slots)
    with torch.no_grad():
        got, stats, got_slots = check_capturable(
            collect_subs.collect_on_draws, params, policy, collect.pool_on(pool, "cpu"), HID, 5,
            draws, noise)
        gen = torch.Generator().manual_seed(2)
        states = collect_subs.reset_subs_worlds(params, pool, gen, W, torch.device("cpu"))
        want, _, want_stats = collect_subs.collect_episode_subs(
            params, policy, states, torch.zeros((W, 1, HID)), params.episode_limit, 5, gen, 0.5)
    assert torch.equal(got_slots, slots)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(torch.equal(stats[k], want_stats[k]) for k in want_stats)
    assert len(torch.unique(want["act"])) > 1                    # the draws decided some


def test_the_collection_body_fails_the_check_with_the_step_as_it_was(monkeypatch):
    """The exp1 collection body, run with the single-UBS step as it was
    (its moves table made from the host at every call), fails
    ``check_capturable``."""
    params = torch_env_subs.make_params(**ENV)
    pool = collect.pool_on(collect_subs.make_subs_layout_pool(4, seed=1, **ENV), "cpu")
    policy, _, _ = _policy("gnn")
    draws, noise = collect.draw_episode(params, 4, torch.Generator().manual_seed(2), W, 0.5,
                                        None, "cpu")
    monkeypatch.setattr(torch_env_subs, "step", _step_before_its_moves_were_cached)
    with pytest.raises(AssertionError, match="lift_fresh"), torch.no_grad():
        check_capturable(collect_subs.collect_on_draws, params, policy, pool, HID, 5, draws,
                         noise)


@pytest.mark.parametrize("agent", ["gnn", "rnn"])
def test_the_episode_body_matches_jax_eval_rollout_subs_at_eps_0(agent):
    """``collect_subs.episode_body`` on the same worlds as JAX's
    ``eval_rollout_subs`` (the pool's layouts, JAX's priority permutations,
    the UBS at the centre of a 300 m region, so that it serves from the
    start) at eps 0, where no draw decides anything: the stats within 1e-5."""
    env = dict(ENV, range_pos=300)
    jp, tp = jax_env_subs.make_params(**env), torch_env_subs.make_params(**env)
    policy, jagent, jparams = _policy(agent, env)
    pos_ubs, gts = collect_subs.make_subs_layout_pool(W, seed=4, **env)
    keys = jax.random.split(jax.random.PRNGKey(5), W)
    prior = np.stack([np.asarray(jax.random.permutation(k, tp.n_gts)) for k in keys])
    js = jax.vmap(lambda g, k: jax_env_subs.reset_from_positions(jp, jnp.asarray(pos_ubs), g, k))(
        jnp.asarray(gts), keys)
    want = jcollect_subs.eval_rollout_subs(jp, _jax_apply(jagent, agent), jparams, js,
                                           jnp.zeros((W, 1, HID)), tp.episode_limit,
                                           jax.random.PRNGKey(0), jnp.float32(0.0))
    draws, noise = collect.draw_episode(tp, W, torch.Generator().manual_seed(0), W, 0.0, None,
                                        "cpu")
    draws[:, 0] = torch.arange(W)                                # world w on layout w
    draws[:, 1:1 + tp.n_gts] = torch.from_numpy(prior)
    with torch.no_grad():
        got = collect_subs.episode_body(tp, policy, collect.pool_on((pos_ubs, gts), "cpu"), HID,
                                        draws, noise)
    for key, v in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(v), err_msg=key, **TOL)
    assert float(got["TestEpRet"].max()) > 0.1


# ----------------------------------------------------- the fused trainer

SIZES = dict(n_worlds=2, capacity_chunks=16, n_layouts=4, seed=0)


def _trainer(agent, graphs_on, **extra):
    kw = dict(agent=agent, device="cpu", hidden_size=16, n_heads=2, n_layers=1,
              max_seq_len=5, batch_size=2, replay_size=16, **extra)
    return FusedDrqnTrainer(ENV, kw, graphs=graphs_on, updates_per_iter=3, **SIZES)


@pytest.mark.parametrize("agent", ["gnn", "rnn"])
def test_the_exp1_iteration_program_gives_the_eager_iteration_bit_for_bit(agent):
    """A warm-up and three iterations (the ring of 16 chunks wraps: each
    iteration writes 2 worlds x 4 slices) on both paths: the metrics, every
    ring slot, the ring's books, the losses, params, targets, AdamW's
    moments, ``.grad`` and the generator after each."""
    prog, eager = _trainer(agent, True), _trainer(agent, False)
    for warmup in (True, False, False, False):
        got, want = prog.run_iteration(0.5, warmup), eager.run_iteration(0.5, warmup)
        assert got == want
        assert torch.equal(prog.generator.get_state(), eager.generator.get_state())
        assert (prog._ptr, prog._size) == (eager._ptr, eager._size)
    assert (prog._ptr, prog._size) == (0, 16)
    for a, b in zip(tree_leaves(prog.replay), tree_leaves(eager.replay)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(prog.last_losses, eager.last_losses)
    _assert_same_bits(_learner_state(prog.learner), _learner_state(eager.learner))
    assert set(prog.learner._programs) == {"ring"}


@pytest.mark.parametrize("agent", ["gnn", "rnn"])
def test_the_exp1_test_episode_program_gives_the_eager_episode(agent):
    prog, eager = _trainer(agent, True), _trainer(agent, False)
    for n in (3, 3):
        got, want = prog.evaluate(n, eps=0.3), eager.evaluate(n, eps=0.3)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in got)
        assert torch.equal(prog.generator.get_state(), eager.generator.get_state())


@pytest.mark.parametrize("agent,dtype", [("gnn", "float32"), ("rnn", "float32"),
                                         ("gnn", "bfloat16")])
def test_the_exp1_program_bodies_make_no_host_sync_and_no_host_tensor(agent, dtype):
    """The trainer's collection, ring-fed update and test episode bodies,
    with inputs made as their callers make them, after a first iteration."""
    trainer = _trainer(agent, True, compute_dtype=dtype)
    trainer.run_iteration(0.5, warmup=True)
    learner = trainer.learner
    slots = trainer._claim(trainer.chunks_per_iter).reshape(trainer.n_worlds, -1)
    draws, noise = collect.draw_episode(trainer.env_params, 4, trainer.generator, 2, 0.5, None,
                                        "cpu", slots)
    test_draws, test_noise = collect.draw_episode(trainer.env_params, 4, trainer.generator, 3,
                                                  0.5, None, "cpu")
    learner._prepare_step()
    for fn, args in ((trainer._collect_body, (draws, noise)),
                     (trainer._ring_update_body, (trainer._draw_sample(), None)),
                     (trainer._episodes._body, (test_draws, test_noise))):
        check_capturable(fn, *args)


# ------------------------------------------------------------- serving

@pytest.mark.parametrize("agent", ["gnn", "rnn"])
def test_serving_an_exp1_run_as_a_program_gives_the_eager_episode(agent):
    """``serve.evaluate`` of the committed exp1 4 x 5 run (full width, two
    worlds) with and without programs, and the kept program is the one a
    second call replays."""
    run_dir = EXP1_DIRS[agent]
    serve._served.clear()
    got = serve.evaluate(run_dir, 2, device="cpu")
    kept = serve.episode_program(run_dir, "cpu")[2]
    again = serve.evaluate(run_dir, 2, device="cpu")
    assert serve.episode_program(run_dir, "cpu")[2] is kept
    want = serve.evaluate(run_dir, 2, device="cpu", graphs=False)
    assert set(got) == {"TestEpRet", "TestFairIdx", "TestAvgGlobalUtility",
                        "TestTotalThroughput"}
    assert all(torch.equal(got[k], want[k]) and torch.equal(again[k], want[k]) for k in want)
    assert float(want["TestEpRet"].mean()) > 50
    serve._served.clear()
