"""The port's training slice against the JAX package's, around the update
(which ``test_torch_update.py`` holds to JAX): the QMIX mixer, the global
state vector, the replay buffer's sampling, ``collect_chunk``, the fused
trainer, resuming a checkpoint with its AdamW state, and the ``train`` entry
point. Inputs are made with numpy from a seed and handed to both packages.
Tolerance 1e-5 (f32, sums taken in another order).
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uav_bs_ctrl_tpu.algos import collect as jcollect
from uav_bs_ctrl_tpu.algos.buffer import SequenceReplayBuffer as JaxBuffer
from uav_bs_ctrl_tpu.algos.common import check_args_sanity as jax_check_args
from uav_bs_ctrl_tpu.algos.madrqn.config import DEFAULT_CONFIG as JAX_DEFAULTS
from uav_bs_ctrl_tpu.algos.madrqn.learner import MultiAgentQLearner as JaxLearner
from uav_bs_ctrl_tpu.algos.madrqn.fused import FusedMadrqnTrainer as JaxTrainer
from uav_bs_ctrl_tpu.envs import jax_env
from uav_bs_ctrl_tpu.models import agents as jagents
from uav_bs_ctrl_tpu.models import heads as jheads
from uav_bs_ctrl_tpu_torch import train
from uav_bs_ctrl_tpu_torch.algos import collect
from uav_bs_ctrl_tpu_torch.algos.buffer import SequenceReplayBuffer
from uav_bs_ctrl_tpu_torch.algos.core import BETAS
from uav_bs_ctrl_tpu_torch.algos.madrqn.fused import FusedMadrqnTrainer
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import make_args
from uav_bs_ctrl_tpu_torch.envs import torch_env
from uav_bs_ctrl_tpu_torch.models.agents import GnnAgent
from uav_bs_ctrl_tpu_torch.models.heads import QMixer
from uav_bs_ctrl_tpu_torch.utils.convert import flatten, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
RUN_DIR = (ROOT / "data" / "exp3_fast_8ubs_tarmac_qmix_il10_lay64k"
           / "exp3_fast_8ubs_tarmac_qmix_il10_lay64k_s0")
TOL = dict(atol=1e-5, rtol=1e-5)
TIE_RTOL = 1e-6
OBS_SHAPE = {"agent": 2, "gt": 4, "ubs": 2}
BLOCKED = ["flax", "jax", "jaxlib", "matplotlib", "optax", "orbax", "pandas",
           "uav_bs_ctrl_tpu"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **tol)


# ---------------------------------------------------------------- small modules

def test_qmixer_matches_jax():
    rng = np.random.default_rng(0)
    jm = jheads.QMixer(22, 3, SN(embed_dim=8))
    p = jm.init(jax.random.PRNGKey(0))
    qs = rng.normal(size=(5, 4, 3)).astype(np.float32)
    states = rng.normal(size=(5, 4, 22)).astype(np.float32)
    port = QMixer(22, 3, 8)
    port.load_state_dict(params_from_jax(_np(p), port))
    _close(port(torch.from_numpy(qs), torch.from_numpy(states)), jm.apply(p, qs, states))


@pytest.mark.parametrize("map_id,width", [("debug", 22), ("8ubs", 216)])
def test_get_state_vec_matches_jax(map_id, width):
    jp, tp = jax_env.make_params(map_id), torch_env.make_params(map_id)
    ubs, gts = collect.make_layout_pool(map_id, 2, seed=3)
    ubs = gts[:, ::max(1, jp.n_gts // jp.n_ubs)][:, :jp.n_ubs] + 20.0   # serve from step 0
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    prior = np.stack([np.asarray(jax.random.permutation(k, jp.n_gts)) for k in keys])
    js = jax.vmap(lambda u, g, k: jax_env.reset_from_positions(jp, u, g, k))(
        jnp.asarray(ubs), jnp.asarray(gts), keys)
    ts = torch_env.reset_from_positions(tp, torch.from_numpy(ubs), torch.from_numpy(gts),
                                        torch.from_numpy(prior))
    want = jax.vmap(lambda s: jax_env.get_state_vec(jp, s))(js)
    got = torch_env.get_state_vec(tp, ts)
    assert tuple(got.shape) == (2, width)
    assert float(np.abs(np.asarray(want)[:, 2 * jp.n_ubs:]).max()) > 0
    _close(got, want)


def _chunks(rng, n, t, a):
    return dict(obs={"agent": rng.normal(size=(n, t + 1, a, 2)).astype(np.float32),
                     "adj": rng.random((n, t + 1, a, a)) > 0.5},
                h=rng.normal(size=(n, 2, a, 4)).astype(np.float32),
                act=rng.integers(0, 5, size=(n, t, a)).astype(np.int32),
                rew=rng.normal(size=(n, t, a)).astype(np.float32),
                done=np.zeros((n, t), np.float32))


def test_replay_buffer_samples_the_same_chunks_as_jax():
    """Chunks pushed at once (wrapping around the ring) and transitions pushed
    one by one (T+1 entries for obs/h, T for act/rew/done); then the same
    indices, without replacement, from the same RandomState."""
    rng = np.random.default_rng(1)
    port, ref = SequenceReplayBuffer(7, 3), JaxBuffer(7, 3)
    for n in (3, 4, 2):
        chunks = _chunks(rng, n, 3, 2)
        port.push_chunks(chunks)
        ref.push_chunks(chunks)
    port_tr, ref_tr = SequenceReplayBuffer(4, 3), JaxBuffer(4, 3)
    for step in range(9):                   # three chunks of T=3
        tr = dict(obs={"agent": rng.normal(size=(2, 2)).astype(np.float32),
                       "adj": rng.random((2, 2)) > 0.5},
                  h=rng.normal(size=(2, 4)).astype(np.float32),
                  act=np.asarray([1, step % 5], np.int32), rew=np.float32(step),
                  done=np.float32(0), next_obs={"agent": np.ones((2, 2), np.float32),
                                                "adj": np.ones((2, 2), bool)},
                  next_h=np.ones((2, 4), np.float32))
        port_tr.push(tr)
        ref_tr.push(tr)
    for p, r, n in ((port, ref, 7), (port_tr, ref_tr, 3)):
        assert len(p) == len(r) == n and p._write_ptr == r._write_ptr
        for seed in (0, 1):
            got = p.sample(3, np.random.RandomState(seed))
            want = r.sample(3, np.random.RandomState(seed))
            assert got["obs"]["agent"].shape[1] == 4 and got["act"].shape[1] == 3
            for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- collection, trainer

HID, HEADS, MSG, KEY = 16, 2, 8, 4


def _kw(mixer, dueling):
    return dict(o="gnn", c="tarmac", hidden_size=HID, n_heads=HEADS, msg_size=MSG,
                key_size=KEY, n_rounds=1, mixer=mixer, double_q=True, dueling=dueling)


def _assert_priority_equal_up_to_ties(got, want_prior, want_avg):
    g, w, avg = got.numpy(), np.asarray(want_prior), np.asarray(want_avg)
    for world in range(g.shape[0]):
        assert sorted(g[world]) == list(range(g.shape[1]))
        np.testing.assert_allclose(avg[world][g[world]], avg[world][w[world]],
                                   rtol=TIE_RTOL, atol=0, err_msg="prior_gts")


def test_collect_chunk_matches_jax(monkeypatch):
    """eps = 0 from the same reset states; the torch env continues from the
    JAX priority order after each step, where the two may differ only by an
    exact rate tie (as in test_torch_env.py)."""
    map_id, n_w = "debug", 3
    jp, tp = jax_env.make_params(map_id), torch_env.make_params(map_id)
    T = jp.episode_limit
    ubs, gts = collect.make_layout_pool(map_id, n_w, seed=4)
    ubs = gts[:, :jp.n_ubs] + 15.0
    keys = jax.random.split(jax.random.PRNGKey(4), n_w)
    prior = np.stack([np.asarray(jax.random.permutation(k, jp.n_gts)) for k in keys])
    js = jax.vmap(lambda u, g, k: jax_env.reset_from_positions(jp, u, g, k))(
        jnp.asarray(ubs), jnp.asarray(gts), keys)
    ts = torch_env.reset_from_positions(tp, torch.from_numpy(ubs), torch.from_numpy(gts),
                                        torch.from_numpy(prior))
    args = SN(**_kw(False, False))
    jagent = jagents.GnnAgent(OBS_SHAPE, jp.n_actions, args)
    p = jagent.init(jax.random.PRNGKey(7))
    agent = GnnAgent(OBS_SHAPE, jp.n_actions, make_args(_kw(False, False), device="cpu"))
    agent.load_state_dict(params_from_jax(_np(p), agent))
    h0 = np.zeros((n_w, jp.n_ubs, HID), np.float32)
    want, _, want_stats = jcollect.collect_chunk(jp, jagent.apply, p, js, jnp.asarray(h0), T,
                                                 jax.random.PRNGKey(0), jnp.float32(0.0))

    # The JAX env's states after each step, from the chunk's actions.
    jstep = jax.jit(jax.vmap(lambda s, a: jax_env.step(jp, s, a)))
    jstates = []
    for t in range(T):
        js = jstep(js, want["act"][:, t])[0]
        jstates.append(js)
    step, calls = torch_env.step, []

    def resynced_step(params, state, actions):
        state, obs, rew, done = step(params, state, actions)
        ref = jstates[len(calls)]
        calls.append(None)
        _assert_priority_equal_up_to_ties(state.prior_gts, ref.prior_gts, ref.avg_rate_per_gt)
        prior_j = torch.from_numpy(np.asarray(ref.prior_gts, np.int64))
        return state._replace(prior_gts=prior_j), obs, rew, done

    monkeypatch.setattr(torch_env, "step", resynced_step)
    with torch.no_grad():
        got, _, got_stats = collect.collect_chunk(tp, agent, ts, torch.from_numpy(h0), T,
                                                  torch.Generator().manual_seed(0), 0.0)
    assert len(calls) == T
    for k in ("agent", "gt", "ubs"):
        _close(got["obs"][k], want["obs"][k], what=k)
    np.testing.assert_array_equal(got["obs"]["adj"].numpy(), np.asarray(want["obs"]["adj"]))
    np.testing.assert_array_equal(got["act"].numpy(), np.asarray(want["act"]))
    assert got["act"].dtype == torch.int32
    for k in ("h", "state", "rew", "done"):
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k], want[k], what=k)
    assert not got["done"].any()
    for k in want_stats:
        _close(got_stats[k], want_stats[k], what=k)
    assert float(np.abs(np.asarray(want["rew"])).sum()) > 0


def test_fused_trainer_runs_and_moves_the_ring_as_jax():
    kw = dict(device="cpu", o="gnn", c="tarmac", hidden_size=16, msg_size=8, batch_size=4,
              mixer=True, double_q=True)
    sizes = dict(n_worlds=4, capacity_chunks=8, updates_per_iter=4, n_layouts=4, seed=0,
                 interleave=2)
    port, ref = FusedMadrqnTrainer("debug", kw, **sizes), JaxTrainer("debug", kw, **sizes)
    p0 = {k: v.clone() for k, v in port.learner.net.state_dict().items()}
    for warmup in (True, False, False):
        mp = port.run_iteration(eps=0.5, warmup=warmup)
        mr = ref.run_iteration(eps=0.5, warmup=warmup)
        assert (port._ptr, port._size) == (ref._ptr, ref._size)
        assert set(mp) == set(mr) and all(np.isfinite(v) for v in mp.values())
    assert (port._ptr, port._size) == (4, 8)          # wrapped once, capped at capacity
    assert port.replay["obs"]["gt"].shape == ref.replay["obs"]["gt"].shape
    assert port.replay["rew"].shape[-1] == 1          # QMIX: one shared reward
    assert any(not torch.equal(p0[k], v) for k, v in port.learner.net.state_dict().items())
    stats = port.evaluate(n_episodes=3)
    assert all(v.shape == (3,) and np.isfinite(v).all() for v in stats.values())


@pytest.mark.parametrize("c,mixer", [(None, True), ("disc", False)])
def test_mlp_fused_trainer_fills_the_ring_with_the_flat_obs_as_jax(c, mixer):
    """``o='mlp'`` on exp2's r400 map (the ``RnnAgent`` under QMIX, and
    DiscreteComm): the ring holds the flat observation and the talk graph at
    JAX's shapes, and an iteration updates the net."""
    kw = dict(device="cpu", o="mlp", c=c, hidden_size=16, msg_size=8, n_layers=2,
              batch_size=2, mixer=mixer, double_q=True)
    sizes = dict(n_worlds=2, capacity_chunks=4, updates_per_iter=2, n_layouts=4, seed=0)
    port, ref = FusedMadrqnTrainer("r400", kw, **sizes), JaxTrainer("r400", kw, **sizes)
    p0 = {k: v.clone() for k, v in port.learner.net.state_dict().items()}
    for warmup in (True, False):
        mp = port.run_iteration(eps=0.5, warmup=warmup)
        ref.run_iteration(eps=0.5, warmup=warmup)
        assert all(np.isfinite(v) for v in mp.values())
    assert set(port.replay["obs"]) == set(ref.replay["obs"]) == {"agent", "adj"}
    for key in ("agent", "adj"):
        assert tuple(port.replay["obs"][key].shape) == ref.replay["obs"][key].shape
    assert port.replay["obs"]["agent"].shape[-1] == 2 + 4 * 5 + 3 * 3
    assert tuple(port.replay["state"].shape) == ref.replay["state"].shape
    assert type(port.learner.net).__name__ == type(ref.learner.agent).__name__
    assert any(not torch.equal(p0[k], v) for k, v in port.learner.net.state_dict().items())


@pytest.mark.parametrize("run", ["exp2_fast_r400_disc/exp2_fast_r400_disc_s0",
                                 "exp3_fast_4ubs_disc_qmix_lay64k/"
                                 "exp3_fast_4ubs_disc_qmix_lay64k_s0"])
def test_build_trainer_resumes_exp2_and_exp3_disc_runs(tmp_path, run):
    """``build_trainer`` on a committed exp2 run and the exp3 4-UBS
    DiscreteComm+QMIX run, with the run's ``config.json`` saying
    ``"interleave": null`` (taken as 1, as a missing key is: the committed
    ``exp2_fast_r400_tarmac_s0`` has none): the run's agent, and a tiny
    iteration."""
    src = ROOT / "data" / run
    config = json.loads((src / "config.json").read_text())
    (tmp_path / "config.json").write_text(json.dumps(dict(config, interleave=None)))
    ckpt = max(src.glob("checkpoint_epoch*.pt"), key=lambda p: int(p.stem[16:]))
    os.symlink(ckpt, tmp_path / ckpt.name)
    trainer = train.build_trainer(tmp_path, "cpu", n_layouts=4, **train.TINY)
    assert trainer.interleave == 1 and trainer.args.o == config["args"]["o"]
    assert trainer.learner.net.noise_shape((1,), 4) is not None      # DiscreteComm
    out = train.train(trainer, 1, 0.05, 2)
    assert {"LossQ", "EpRet", "TestEpRet"} <= set(out) and all(np.isfinite(list(out.values())))


def test_train_entry_point_runs_where_jax_optax_pandas_are_missing():
    """``train --device cpu`` with the modules the GPU machine lacks blocked:
    one tiny iteration from the committed checkpoint at full width."""
    code = (
        "import sys, runpy\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = ['train', '--run-dir', {str(RUN_DIR)!r}, '--device', 'cpu',"
        " '--iterations', '1', '--tiny']\n"
        "runpy.run_module('uav_bs_ctrl_tpu_torch.train', run_name='__main__')\n"
        f"assert not any(sys.modules.get(n) for n in {BLOCKED!r})\n")
    # One torch thread: the suite's workers share the cores, and a child with
    # a thread per core slows by an order of magnitude among them.
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=240, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"LossQ", "EpRet", "TestEpRet"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())


# ---------------------------------------------------------------- resuming a checkpoint

def _named(tree):
    return {k: np.array(v) for k, v in flatten(_np(tree)).items()}


def test_resume_restores_adamw_and_the_first_update_matches_jax():
    """Both packages resume the committed 8-UBS checkpoint (net, mixer, LR
    scale 0.4 and optax's ScaleByAdamState: count 119,600, mu and nu of 38
    leaves each) and take one update on the same batch of real experience
    (B = 2, T = 4). LossQ to 1e-5 relative. Every gradient entry is a sum over
    one BPTT graph, so its f32 roundoff scales with the group's largest raw
    gradient: clipped grads are held to gtol = 1e-5 of it, the moments to what
    that allows (mu: (1 - b1) gtol, nu: (1 - b2)(2|g| + gtol) gtol, each plus
    1e-5 relative). Params and targets are held to 1e-5 where the raw gradient
    exceeds gtol; below it (zero in exact arithmetic, see PERF.md §6) Adam
    normalises roundoff, and the two updates differ by at most the sum of the
    two packages' Adam steps."""
    config = json.loads((RUN_DIR / "config.json").read_text())
    kw = dict(config["args"], max_seq_len=4, batch_size=2)
    env_info = dict(obs_shape=OBS_SHAPE, state_shape=216, n_actions=9, n_agents=8,
                    episode_limit=50)
    path = RUN_DIR / "checkpoint_epoch200.pt"
    jl = JaxLearner(env_info, jax_check_args(SN(**{**JAX_DEFAULTS, **kw, "device": "cpu"})))
    jl.load_checkpoint(str(path))
    tl = MultiAgentQLearner(env_info, make_args(kw, device="cpu"))
    assert tl.load_checkpoint(path) == {"epoch": 200, "t": 6_000_000}
    assert tl.lr_scale == pytest.approx(jl.lr_scale) == 0.4
    names = [f"net.{k}" for k, _ in tl.net.named_parameters()] + \
        [f"mixer.{k}" for k, _ in tl.mixer.named_parameters()]
    adam = jl.opt_state.inner_state[0]
    mu0, nu0 = _named(adam.mu), _named(adam.nu)
    assert int(adam.count) == 119_600 and len(mu0) == len(nu0) == len(names) == 38
    for name, p in zip(names, tl.parameters()):       # the resumed state itself
        st = tl.optimizer.state[p]
        assert st["step"].item() == 119_600
        assert torch.equal(st["exp_avg"], torch.from_numpy(mu0[name]))
        assert torch.equal(st["exp_avg_sq"], torch.from_numpy(nu0[name]))

    tp = torch_env.make_params("8ubs")
    gen = torch.Generator().manual_seed(6)
    states = collect.reset_worlds(tp, collect.make_layout_pool("8ubs", 4, seed=6), gen, 2,
                                  torch.device("cpu"))
    with torch.no_grad():
        chunk, _, _ = collect.collect_chunk(tp, tl.net, states, torch.zeros((2, 8, 256)), 4,
                                            gen, 0.5)
    chunk["rew"] = chunk["rew"].mean(-1, keepdim=True)
    jbatch = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), chunk)
    key = jax.random.PRNGKey(0)
    (loss, _), grads = jax.value_and_grad(jl._loss_fn, has_aux=True)(
        jl.params, jl.target_params, jbatch, key)
    raw = _named(grads)
    grads["net"] = jax.tree_util.tree_map(lambda g: jnp.clip(g, -1.0, 1.0), grads["net"])
    clipped = _named(grads)
    params, targets, opt_state, _ = jl._update_jit(
        jl.params, jl.target_params, jl.opt_state, jbatch, key, jnp.float32(jl.lr_scale))
    mu, nu = _named(opt_state.inner_state[0].mu), _named(opt_state.inner_state[0].nu)
    want = {"params": _named(params), "targets": _named(targets)}

    got = tl.update_on_batch(chunk)
    _close(got["LossQ"], float(loss), dict(atol=0, rtol=1e-5), "LossQ")
    assert int(opt_state.inner_state[0].count) == 119_601
    scale = {grp: max(np.abs(v).max() for k, v in raw.items() if k.startswith(grp))
             for grp in ("net", "mixer")}
    lr_step = tl.lr * tl.lr_scale
    b1, b2 = BETAS
    got_named = {attr: {f"{grp}.{k}": v.numpy() for grp, mod in mods.items()
                        for k, v in mod.state_dict().items()}
                 for attr, mods in (("params", {"net": tl.net, "mixer": tl.mixer}),
                                    ("targets", {"net": tl.target_net,
                                                 "mixer": tl.target_mixer}))}
    n_unresolved = 0
    for name, p in zip(names, tl.parameters()):
        gtol = 1e-5 * scale[name.split(".")[0]]
        st = tl.optimizer.state[p]
        assert st["step"].item() == 119_601
        g, m_got, v_got = p.grad.numpy(), st["exp_avg"].numpy(), st["exp_avg_sq"].numpy()
        assert np.all(np.abs(g - clipped[name]) <= gtol), f"grad {name}"
        assert np.all(np.abs(m_got - mu[name]) <= (1 - b1) * gtol + 1e-5 * np.abs(mu[name])), \
            f"mu {name}"
        assert np.all(np.abs(v_got - nu[name]) <= (1 - b2) * (2 * np.abs(clipped[name]) + gtol)
                      * gtol + 1e-5 * np.abs(nu[name])), f"nu {name}"
        resolved = np.abs(raw[name]) > gtol
        n_unresolved += int((~resolved).sum())
        steps = lr_step * (np.abs(m_got) / (np.sqrt(v_got) + 1e-8)
                           + np.abs(mu[name]) / (np.sqrt(nu[name]) + 1e-8))
        for attr, shrink in (("params", 1.0), ("targets", 1.0 - tl.polyak)):
            diff = got_named[attr][name] - want[attr][name]
            _close(got_named[attr][name][resolved], want[attr][name][resolved], TOL,
                   f"{attr} {name}")
            assert np.all(np.abs(diff[~resolved]) <= shrink * steps[~resolved] * 1.001 + 1e-7), \
                f"{attr} {name} (unresolved)"
    assert 0 < n_unresolved < sum(p.numel() for p in tl.parameters())


def test_train_runs_two_warmups_and_takes_the_layout_pool_size(monkeypatch):
    """``train.train`` refills the ring with two warm-up collections before
    its first update (``run_fast.py:_maybe_resume``), and ``--n-layouts``
    (default 256, as ``run_fast.py``) reaches the trainer's pools."""
    built = {}
    calls = []

    class FakeTrainer:
        n_worlds = 2

        def run_iteration(self, eps, warmup=False):
            calls.append(warmup)
            return {"LossQ": 1.0}

        def evaluate(self, n_episodes, eps):
            return {"TestEpRet": np.zeros(n_episodes)}

    def fake_build(run_dir, device=None, n_layouts=train.N_LAYOUTS, **kw):
        built.update(n_layouts=n_layouts, **kw)
        return FakeTrainer()

    monkeypatch.setattr(train, "build_trainer", fake_build)
    train.main(["--run-dir", str(RUN_DIR), "--iterations", "2", "--device", "cpu"])
    assert calls == [True, True, False, False] and built["n_layouts"] == 256
    train.main(["--run-dir", str(RUN_DIR), "--n-layouts", "3", "--tiny", "--device", "cpu"])
    assert built["n_layouts"] == 3 and built["n_worlds"] == 2
    monkeypatch.undo()
    trainer = train.build_trainer(RUN_DIR, "cpu", 3, **train.TINY)
    assert len(trainer.pool[0]) == len(trainer.test_pool[0]) == 3
