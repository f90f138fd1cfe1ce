"""The port's programs (``uav_bs_ctrl_tpu_torch/graphs.py``, the counterpart of
JAX's jitted update, fused iteration and test episode) on the CPU.

On a CPU device a program calls its body directly, so these tests run the
bodies: the update (``RecurrentQLearner._update_body``), the fused trainer's
collection with its ring write and its ring-fed update, and the test episode
(``collect.episode_body``), each fed the draws the host makes before the
call. They must give the eager path's results bit for bit (the same
operations on the same draws) and leave every generator where the eager
path leaves it. The capture itself needs a card: ``chip_smoke.py``'s
``graph_phases`` holds each replayed graph to its eager twin there.

``check_capturable`` runs each body under a dispatch mode that fails
on a host sync, a shape that depends on the data, or a tensor made from
Python or NumPy data (an env step of the kind the port had before its
device constants were cached must fail it). The update's AdamW step
(``RecurrentQLearner._adamw``, its scalars made on the host) holds to
``torch.optim.AdamW``, and a learner's checkpoint after program updates
loads into the JAX learner.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

from uav_bs_ctrl_tpu.algos.common import check_args_sanity as jax_check_args
from uav_bs_ctrl_tpu.algos.madrqn.config import DEFAULT_CONFIG as JAX_DEFAULTS
from uav_bs_ctrl_tpu.algos.madrqn.learner import MultiAgentQLearner as JaxLearner
from uav_bs_ctrl_tpu_torch import graphs, serve
from uav_bs_ctrl_tpu_torch.algos import collect
from uav_bs_ctrl_tpu_torch.algos.buffer import tree_leaves
from uav_bs_ctrl_tpu_torch.algos.core import ADAM_EPS, BETAS, WEIGHT_DECAY
from uav_bs_ctrl_tpu_torch.algos.madrqn.fused import FusedMadrqnTrainer
from uav_bs_ctrl_tpu_torch.envs import torch_env
from uav_bs_ctrl_tpu_torch.ops import gat_kernels
from uav_bs_ctrl_tpu_torch.utils.convert import learner_params_to_jax

from test_torch_serve import DISC_DIR

SIZES = dict(n_worlds=4, capacity_chunks=8, updates_per_iter=4, n_layouts=4, seed=0,
             interleave=2)
CASES = {"tarmac": dict(c="tarmac", bptt_encoder="per_step"),
         "tarmac-hoisted": dict(c="tarmac", bptt_encoder="hoisted"),
         "disc": dict(c="disc", bptt_encoder="per_step")}


SYNC_OPS = frozenset((
    "_local_scalar_dense", "is_nonzero", "equal", "nonzero", "nonzero_static", "argwhere",
    "masked_select", "unique", "_unique", "_unique2", "unique_dim", "unique_consecutive"))
HOST_DATA_OPS = frozenset(("lift_fresh", "lift_fresh_copy"))


class HostSyncCheck(TorchDispatchMode):
    """Records every operation a body dispatches that a capture cannot hold:
    a host sync or a shape that depends on the data (``SYNC_OPS``), and a
    tensor made from Python or NumPy data (``HOST_DATA_OPS``: on the card,
    a host-to-device copy at every call)."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in SYNC_OPS | HOST_DATA_OPS:
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


def check_capturable(fn, *args):
    """``fn(*args)`` under :class:`HostSyncCheck`; raises ``AssertionError``
    naming what a capture cannot hold."""
    with HostSyncCheck() as mode:
        out = fn(*args)
    if mode.found:
        raise AssertionError(f"not capturable: {sorted(set(mode.found))} "
                             f"({len(mode.found)} calls)")
    return out


def _kw(case, **extra):
    return dict(device="cpu", o="gnn", hidden_size=16, msg_size=8, n_heads=2, key_size=4,
                batch_size=4, mixer=True, double_q=True, **CASES[case], **extra)


def _trainer(case, graphs_on, **extra):
    return FusedMadrqnTrainer("debug", _kw(case, **extra), graphs=graphs_on, **SIZES)


def _learner_state(learner):
    """Params, targets, AdamW's state and ``.grad`` of a learner, by name."""
    out = {}
    for i, (p, t) in enumerate(zip(learner.parameters(), learner.target_parameters())):
        out[f"param.{i}"], out[f"target.{i}"], out[f"grad.{i}"] = p, t, p.grad
        for k, v in learner.optimizer.state.get(p, {}).items():
            out[f"adam.{i}.{k}"] = v
    return out


def _assert_same_bits(a, b, what=""):
    assert sorted(a) == sorted(b), what
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, f"{what} {k}"
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), f"{what} {k}"


def _same_trainers(case, **extra):
    """A program trainer and an eager one, the same after a warm-up each."""
    pair = _trainer(case, True, **extra), _trainer(case, False, **extra)
    for t in pair:
        t.run_iteration(0.5, warmup=True)
    return pair


@pytest.mark.parametrize("case,dtype", [("tarmac", "float32"), ("tarmac-hoisted", "float32"),
                                        ("disc", "float32"), ("tarmac", "bfloat16")])
def test_update_program_gives_the_eager_update_bit_for_bit(case, dtype):
    """Two updates through ``update_on_batch`` on the program path and on the
    eager one, from the same learner state and batch (DiscreteComm: the
    same noise, each learner drawing it from its own generator): metrics,
    params, targets, AdamW's state, ``.grad`` and the noise generator."""
    prog, eager = _same_trainers(case, compute_dtype=dtype)
    batch = eager.sample_batch()
    for _ in range(2):
        got = prog.learner.update_on_batch(batch)
        want = eager.learner.update_on_batch(batch)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in got)
    _assert_same_bits(_learner_state(prog.learner), _learner_state(eager.learner))
    assert torch.equal(prog.learner.noise_generator.get_state(),
                       eager.learner.noise_generator.get_state())
    assert list(prog.learner._programs) == [("batch", True)]


def test_adamw_step_holds_to_torchs_adamw():
    """Four steps of ``_adamw`` with its scalars from ``_prepare_step`` (the
    learning rate changed between them, a gradient missing) against
    ``torch.optim.AdamW`` on copies of the same params: the step counts and
    the moments equal, the params within one rounding of torch's (the CPU's
    ``addcmul_`` and ``_foreach_addcdiv_`` round the last op apart; on the
    card they agree, and ``chip_smoke.py`` holds the learner's update to the
    same update through torch's own AdamW bit for bit)."""
    learner = _trainer("tarmac", True).learner
    params = learner.parameters()
    ref = [p.detach().clone().requires_grad_(True) for p in params]
    torch_adamw = torch.optim.AdamW(ref, lr=learner.lr, betas=BETAS, eps=ADAM_EPS,
                                    weight_decay=WEIGHT_DECAY)
    gen = torch.Generator().manual_seed(3)
    for k, scale in enumerate((1.0, 0.4, 1.0, 0.7)):
        grads = [torch.randn(p.shape, generator=gen) * 10.0 ** (k - 2) for p in params]
        grads[1] = torch.zeros_like(grads[1])        # a leaf with no gradient: zeros
        for p, q, g in zip(params, ref, grads):
            p.grad, q.grad = g.clone(), g.clone()
        learner.lr_scale = scale
        learner._prepare_step()
        learner._adamw()
        torch_adamw.param_groups[0]["lr"] = learner.lr * scale
        torch_adamw.step()
    for p, q in zip(params, ref):
        mine, theirs = learner.optimizer.state[p], torch_adamw.state[q]
        assert torch.equal(mine["step"], theirs["step"]) and float(mine["step"]) == 4
        assert torch.equal(mine["exp_avg"], theirs["exp_avg"])
        assert torch.equal(mine["exp_avg_sq"], theirs["exp_avg_sq"])
        ulp = 2.0 ** -23 * q.detach().abs().max().item()
        torch.testing.assert_close(p.detach(), q.detach(), rtol=0.0, atol=ulp)


@pytest.mark.parametrize("case", ["tarmac", "disc"])
def test_fused_iteration_program_gives_the_eager_iteration_bit_for_bit(case):
    """A warm-up and two iterations of ``interleave=2`` (sub-iterations of
    two worlds and two updates) on both paths: the metrics, every ring slot,
    the ring's books, the losses, params, targets and AdamW's moments, and
    the CPU generator's state after each."""
    prog, eager = _trainer(case, True), _trainer(case, False)
    for warmup in (True, False, False):
        got, want = prog.run_iteration(0.5, warmup), eager.run_iteration(0.5, warmup)
        assert got == want
        assert torch.equal(prog.generator.get_state(), eager.generator.get_state())
        assert (prog._ptr, prog._size) == (eager._ptr, eager._size)
    assert (prog._ptr, prog._size) == (4, 8)            # wrapped once, capped at capacity
    for a, b in zip(tree_leaves(prog.replay), tree_leaves(eager.replay)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(prog.last_losses, eager.last_losses)
    _assert_same_bits(_learner_state(prog.learner), _learner_state(eager.learner))
    assert set(prog.learner._programs) == {"ring"}


@pytest.mark.parametrize("case", ["tarmac", "disc"])
def test_test_episode_program_gives_the_eager_episode(case):
    """``evaluate`` on both paths, twice (the program is reused at its shape):
    the same stats and the same generator state."""
    prog, eager = _trainer(case, True), _trainer(case, False)
    for n in (3, 3):
        got, want = prog.evaluate(n, eps=0.3), eager.evaluate(n, eps=0.3)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in got)
        assert torch.equal(prog.generator.get_state(), eager.generator.get_state())


def test_served_episode_program_gives_the_eager_episode():
    """``serve.evaluate`` of the committed 4-UBS DiscreteComm run (full width,
    two worlds) through ``flash_gat``'s backend, with and without programs."""
    got = serve.evaluate(DISC_DIR, 2, device="cpu", gat_backend="pallas")
    want = serve.evaluate(DISC_DIR, 2, device="cpu", gat_backend="pallas", graphs=False)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_a_program_draws_only_what_the_eager_path_draws():
    """``draw_episode`` draws what ``reset_worlds`` and ``collect_chunk`` draw,
    in their order, for a policy that reads no key and one that does."""
    params = torch_env.make_params("debug")
    pool = collect.make_layout_pool("debug", 4)
    for reads_key in (False, True):
        shape = (3, params.n_ubs, params.n_ubs, 2, 2) if reads_key else None
        gen_a, gen_b = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
        draws, noise = collect.draw_episode(params, 4, gen_a, 3, 0.4, shape, "cpu")
        assert (noise is None) != reads_key
        idx, prior = collect.draw_reset(params.n_gts, 4, gen_b, 3)
        for t in range(params.episode_limit):
            if reads_key:
                collect.StepKey(gen_b).__int__()
            collect.draw_explore(gen_b, (3, params.n_ubs), params.n_actions, 0.4)
        assert torch.equal(gen_a.get_state(), gen_b.get_state())
        d = collect.unpack_draws(draws, params)
        assert torch.equal(d.idx, idx) and torch.equal(d.prior, prior) and d.slot is None
        assert tuple(d.rand.shape) == (params.episode_limit, 3, params.n_ubs)
        assert tuple(d.explore.shape) == (params.episode_limit, 3, 1)
        assert d.explore.dtype == torch.bool
    assert len(pool[0]) == 4


def _bodies(trainer):
    """Each program body of ``trainer`` with inputs made as its caller makes
    them: ``{name: (fn, args)}``."""
    learner, A = trainer.learner, trainer.env_params.n_ubs
    slots = trainer._claim(2)
    draws, noise = collect.draw_episode(trainer.env_params, 4, trainer.generator, 2, 0.5,
                                        trainer._noise_shape(2), "cpu", slots)
    test_draws, test_noise = collect.draw_episode(trainer.env_params, 4, trainer.generator, 3,
                                                  0.5, trainer._noise_shape(3), "cpu")
    update_noise = learner.draw_noise_for(learner.batch_size, A)
    learner._prepare_step()
    batch = trainer.sample_batch()
    return {"collection": (trainer._collect_body, (draws, noise)),
            "ring update": (trainer._ring_update_body, (trainer._draw_sample(), update_noise)),
            "update, kernels": (learner._update_body, (batch, update_noise, True)),
            "update, plain path": (learner._update_body, (batch, update_noise, False)),
            "test episode": (trainer._episodes._body, (test_draws, test_noise))}


@pytest.mark.parametrize("case,dtype", [("tarmac", "float32"), ("tarmac-hoisted", "bfloat16"),
                                        ("disc", "float32")])
def test_program_bodies_make_no_host_sync_and_no_host_tensor(case, dtype):
    trainer = _trainer(case, True, compute_dtype=dtype)
    trainer.run_iteration(0.5, warmup=True)
    for name, (fn, args) in _bodies(trainer).items():
        check_capturable(fn, *args)


def _step_before_its_constants_were_cached(params, state, actions):
    """``torch_env.step`` as it was: the moves table made from the host's
    tuples at every call."""
    moves = torch.tensor(params.avail_moves, dtype=torch.float32,
                         device=actions.device)[actions]
    pos_ubs = torch.clamp(state.pos_ubs + moves, 0, params.range_pos)
    state = state._replace(t=state.t + 1, pos_ubs=pos_ubs)
    state = torch_env._transmit(params, state)
    rew = torch_env._reward(params, state)
    state = state._replace(ep_ret=state.ep_ret + rew.mean(-1))
    return state, torch_env.get_obs(params, state), rew, state.t == params.episode_limit


def _others_index_made_at_every_call(n, device):
    idx = np.arange(n)[None, :].repeat(n, 0)
    return torch.as_tensor(np.stack([np.delete(idx[i], i) for i in range(n)]), device=device)


@pytest.mark.parametrize("old", ["step", "_others_index"])
def test_the_check_fails_on_an_env_step_that_copies_from_the_host(monkeypatch, old):
    trainer = _trainer("tarmac", True)
    trainer.run_iteration(0.5, warmup=True)
    fn, args = _bodies(trainer)["collection"]
    monkeypatch.setattr(torch_env, old, {"step": _step_before_its_constants_were_cached,
                                         "_others_index": _others_index_made_at_every_call}[old])
    with pytest.raises(AssertionError, match="lift_fresh"):
        check_capturable(fn, *args)


def test_the_check_fails_on_a_host_sync():
    x = torch.ones(3)
    for fn in (lambda: x.sum().item(), lambda: x.nonzero(), lambda: bool(x.any())):
        with pytest.raises(AssertionError, match="not capturable"):
            check_capturable(fn)
    assert torch.equal(check_capturable(lambda: torch.where(x > 0, x, 0.0) * 2), 2 * x)


def test_a_learners_checkpoint_after_program_updates_round_trips_through_jax(tmp_path):
    """Two program updates, then the checkpoint: the JAX learner loads it
    (count 2, the params and moments leaf for leaf), and a port learner
    loads it back bit for bit, each parameter's ``step`` a CPU tensor of its
    own, as ``torch.optim.AdamW`` keeps it."""
    prog, _ = _same_trainers("tarmac")
    learner = prog.learner
    batch = prog.sample_batch()
    for _ in range(2):
        learner.update_on_batch(batch)
    path = tmp_path / "checkpoint_epoch1.pt"
    learner.save_checkpoint(path, dict(epoch=1, t=80))

    tp = prog.env_params
    env_info = dict(obs_shape={"agent": 2, "gt": 4, "ubs": 2}, n_actions=tp.n_actions,
                    n_agents=tp.n_ubs, episode_limit=prog.T, state_shape=tp.n_ubs * 2 + tp.n_gts * 4)
    jl = JaxLearner(env_info, jax_check_args(SimpleNamespace(**{
        **JAX_DEFAULTS, **_kw("tarmac"), "max_seq_len": None})))
    jl.load_checkpoint(str(path))
    adam = jl.opt_state.inner_state[0]
    assert int(adam.count) == 2
    for key, jtree in (("params", jl.params), ("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        tree = learner_params_to_jax(learner._by_group(
            lambda p: (p if key == "params" else learner.optimizer.state[p][key]).detach()))
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jtree)
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(jtree)):
            np.testing.assert_array_equal(np.asarray(b), a, err_msg=key)

    again = _trainer("tarmac", True).learner
    again.load_checkpoint(path)
    for p, q in zip(learner.parameters(), again.parameters()):
        assert torch.equal(p, q)
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(learner.optimizer.state[p][k], again.optimizer.state[q][k])
        assert again.optimizer.state[q]["step"].device.type == "cpu"
    steps = {again.optimizer.state[q]["step"].data_ptr() for q in again.parameters()}
    assert len(steps) == len(again.parameters())          # a step tensor for each
    again.update_on_batch(batch)                           # and the next update runs


def test_loading_state_drops_the_programs():
    """Programs read the optimizer's tensors: loading new ones drops them."""
    prog, _ = _same_trainers("tarmac")
    learner = prog.learner
    learner.update_on_batch(prog.sample_batch())
    snap = learner.state_dict()
    assert learner._programs
    learner.load_state_dict(snap)
    assert not learner._programs
    prog.run_iteration(0.5)
    assert set(learner._programs) == {"ring"}


def test_program_on_the_cpu_calls_its_body_and_counts_nothing_twice():
    """A CPU program is one direct call of its body a call, with its fixed
    arguments after the inputs, and it adds to no kernel wrapper's count."""
    calls = []

    def body(x, tree, scale):
        calls.append(scale)
        return {"y": x * scale, "z": [tree["a"] + 1, None]}

    before = gat_kernels.flash_gat_fused.launches
    program = graphs.Program(body, "cpu", extra=(3.0,))
    out = program(torch.ones(2), {"a": torch.zeros(1)})
    out = program(torch.ones(2), {"a": torch.zeros(1)})
    assert calls == [3.0, 3.0] and torch.equal(out["y"], torch.full((2,), 3.0))
    assert gat_kernels.flash_gat_fused.launches == before and not program.captured
    kept = graphs.clone_tree(out)
    assert torch.equal(kept["z"][0], torch.ones(1)) and kept["z"][1] is None

    leaves, spec = graphs._flatten(({"a": torch.ones(1), "b": None}, [torch.zeros(2)]))
    assert len(leaves) == 2
    rebuilt = graphs._unflatten(leaves, spec)
    assert rebuilt[0]["b"] is None and torch.equal(rebuilt[1][0], torch.zeros(2))


@pytest.mark.parametrize("capturing", [False, True])
def test_a_wrapper_counts_no_launch_recorded_into_a_capture(monkeypatch, capturing):
    """``build.count_launch`` adds one (and one bf16 for a bf16 launch) where
    the wrapper launched its kernel, and nothing for a launch recorded into a
    capturing stream: a captured graph's replays launch it."""
    from uav_bs_ctrl_tpu_torch.ops import build
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    fn = SimpleNamespace(launches=3, launches_bf16=1)
    build.count_launch(fn, torch.bfloat16)
    build.count_launch(fn, torch.float32)
    assert (fn.launches, fn.launches_bf16) == ((3, 1) if capturing else (5, 2))


def test_serve_keeps_its_episode_program_across_calls():
    """``serve.episode_program`` returns the program it made for the same
    run, checkpoint, device, backend and seed, and a new one (the old one
    freed) for another seed."""
    first = serve.episode_program(DISC_DIR, "cpu", gat_backend="pallas")
    assert serve.episode_program(DISC_DIR, "cpu", gat_backend="pallas")[2] is first[2]
    other = serve.episode_program(DISC_DIR, "cpu", gat_backend="pallas", seed=1)
    assert other[2] is not first[2] and len(serve._served) == 1
