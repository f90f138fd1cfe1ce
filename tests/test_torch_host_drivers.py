"""The port's classic host-loop drivers against the JAX package's.

- ``act`` and ``init_hidden``: on the committed 4-UBS TarMAC+QMIX, exp2 r400
  TarMAC and exp1 4 x 5 gnn/rnn checkpoints at full width, each package's
  learner and host env play 20 steps from the same seed (the port's
  ``RandomState(seed)`` against JAX's ``np.random``); at eps 0 and 0.05 the
  actions are equal, and h' within 1e-4 (the repo's full-width tolerance;
  one call at hidden 256 differs by up to about 2e-5), both for each call
  from the same h (JAX's h of the step before) and for the port's own
  recurrence over the 20 steps.
- A tiny classic ``train()``: madrqn (GNN encoder, TarMAC, QMIX, double-Q) on
  ``debug`` at hidden 16 and drqn (both agents) on 2 x 1 GTs, the port's
  learner starting from JAX's initial weights: every non-time
  ``progress.txt`` column within 1e-4 (LossQ too), and the port's checkpoint
  loads into JAX's learner leaf for leaf.
- ``ExperimentGrid``: the port's ``run_exp{1,2,3}`` grids have JAX's variant
  names and nesting (the JAX grids' one extra key, ``device='tpu'``, aside);
  a one-variant exp1 grid runs through the pickled-thunk subprocess on the
  CPU and writes ``progress.txt`` and ``config.json``.
- ``run_classic``'s CLI at full width on the CPU; its presets are JAX's
  without a device.
"""

import json
import pickle
import runpy
from functools import partial
from pathlib import Path
from types import SimpleNamespace as SN

import jax
import numpy as np
import pytest
import torch

import run_classic as jax_run_classic
from uav_bs_ctrl_tpu.algos.common import check_args_sanity as jax_check_args
from uav_bs_ctrl_tpu.algos.drqn import run as jax_drqn_run
from uav_bs_ctrl_tpu.algos.drqn.config import DEFAULT_CONFIG as JAX_DRQN_DEFAULTS
from uav_bs_ctrl_tpu.algos.drqn.learner import QLearner as JaxQLearner
from uav_bs_ctrl_tpu.algos.drqn.wrappers import make_env as jax_make_drqn_env
from uav_bs_ctrl_tpu.algos.madrqn import run as jax_madrqn_run
from uav_bs_ctrl_tpu.algos.madrqn.config import DEFAULT_CONFIG as JAX_DEFAULTS
from uav_bs_ctrl_tpu.algos.madrqn.learner import MultiAgentQLearner as JaxLearner
from uav_bs_ctrl_tpu.algos.madrqn.wrappers import make_env as jax_make_env
from uav_bs_ctrl_tpu.envs.mubs_cov import MultiUbsCoverageEnv as JaxMubs
from uav_bs_ctrl_tpu.envs.subs_cov import SingleUbsCoverageEnv as JaxSubs
from uav_bs_ctrl_tpu.utils import run_utils as jax_run_utils
from uav_bs_ctrl_tpu_torch import run_classic, test_policies
from uav_bs_ctrl_tpu_torch.algos.drqn import run as drqn_run
from uav_bs_ctrl_tpu_torch.algos.drqn.config import DEFAULT_CONFIG as DRQN_DEFAULTS
from uav_bs_ctrl_tpu_torch.algos.drqn.config import check_args
from uav_bs_ctrl_tpu_torch.algos.drqn.learner import QLearner
from uav_bs_ctrl_tpu_torch.algos.drqn.wrappers import make_env as make_drqn_env
from uav_bs_ctrl_tpu_torch.algos.madrqn import run as madrqn_run
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.algos.madrqn.wrappers import make_env
from uav_bs_ctrl_tpu_torch.config import DEFAULT_CONFIG, check_args_sanity
from uav_bs_ctrl_tpu_torch.envs.mubs_cov import MultiUbsCoverageEnv
from uav_bs_ctrl_tpu_torch.envs.subs_cov import SingleUbsCoverageEnv
from uav_bs_ctrl_tpu_torch.utils import run_utils
from uav_bs_ctrl_tpu_torch.utils.convert import learner_params_to_jax

ROOT = Path(__file__).resolve().parents[1]
RUNS = {
    "4ubs_tarmac_qmix": ("exp3_fast_4ubs_tarmac_qmix/exp3_fast_4ubs_tarmac_qmix_s0",
                         "checkpoint_epoch200.pt"),
    "r400_tarmac": ("exp2_fast_r400_tarmac/exp2_fast_r400_tarmac_s0", "checkpoint_epoch100.pt"),
    "exp1_gnn": ("exp1_fast_grp4_size5_gnn/exp1_fast_grp4_size5_gnn_s0", "checkpoint_epoch50.pt"),
    "exp1_rnn": ("exp1_fast_grp4_size5_rnn/exp1_fast_grp4_size5_rnn_s0", "checkpoint_epoch50.pt"),
}
TIME_COLUMNS = ("TimeActMs", "TimeEnvMs", "TimeUpdateMs", "Time")


def _learner_pair(run, seed):
    """Both packages' learners loaded from a committed run, on their host envs
    (record off); the port's env draws from ``RandomState(seed)``."""
    run_dir, ckpt = RUNS[run]
    config = json.loads((ROOT / "data" / run_dir / "config.json").read_text())
    algo, _, env_kwargs, saved = test_policies.parse_run_config(config, device="cpu")
    rng = np.random.RandomState(seed)
    if algo == "drqn":
        jargs = jax_check_args(SN(**{**JAX_DRQN_DEFAULTS, **saved, "device": "cpu"}))
        args = check_args(SN(**{**DRQN_DEFAULTS, **saved}))
        jenv = jax_make_drqn_env(partial(JaxSubs, **env_kwargs, record=False), jargs)
        env = make_drqn_env(partial(SingleUbsCoverageEnv, **env_kwargs, record=False,
                                    rng=rng), args)
        jl, tl = (JaxQLearner(jenv.get_env_info(), jargs, seed=seed),
                  QLearner(env.get_env_info(), args, seed=seed))
    else:
        jargs = jax_check_args(SN(**{**JAX_DEFAULTS, **saved, "device": "cpu"}))
        args = check_args_sanity(SN(**{**DEFAULT_CONFIG, **saved}))
        jenv = jax_make_env(partial(JaxMubs, **env_kwargs, record=False), jargs)
        env = make_env(partial(MultiUbsCoverageEnv, **env_kwargs, record=False, rng=rng), args)
        jl, tl = (JaxLearner(jenv.get_env_info(), jargs, seed=seed),
                  MultiAgentQLearner(env.get_env_info(), args, seed=seed))
    assert env.get_env_info() == jenv.get_env_info()
    for learner in (jl, tl):
        learner.load_checkpoint(str(ROOT / "data" / run_dir / ckpt))
    return algo, (jl, jenv), (tl, env, rng)


@pytest.mark.parametrize("eps", [0.0, 0.05])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_act_matches_jax_on_committed_checkpoints(run, eps):
    seed = 4
    np.random.seed(seed)
    algo, (jl, jenv), (tl, env, rng) = _learner_pair(run, seed)
    jo, o = jenv.reset(), env.reset()
    if algo == "madrqn":
        jo, o = jo[0], o[0]
    jh, h = jl.init_hidden(), tl.init_hidden()
    assert h.shape == jh.shape == (tl.n_agents, tl.net.hidden) and not h.any()
    h_free = h
    for t in range(20):
        h_in = np.asarray(jh)
        ja, jh = jl.act(jo, jh, eps)
        a, h = tl.act(o, h_in, eps, rng)
        assert a == ja, f"step {t}"
        np.testing.assert_allclose(h, np.asarray(jh), atol=1e-4, rtol=1e-4, err_msg=f"step {t}")
        with torch.no_grad():
            h_free = tl._act_q({k: torch.as_tensor(np.asarray(v))[None] for k, v in o.items()},
                               torch.as_tensor(h_free)[None], None)[1][0].numpy()
        np.testing.assert_allclose(h_free, np.asarray(jh), atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {t}")
        if algo == "madrqn":
            jo, o = jenv.step(ja)[0], env.step(a)[0]
        else:
            jo, o = jenv.step(ja[0])[0], env.step(a[0])[0]
        for k in o:
            np.testing.assert_array_equal(o[k], jo[k], err_msg=f"step {t} obs {k}")
    assert rng.random() == np.random.random()         # both streams at the same draw


def _table(path):
    lines = Path(path).read_text().splitlines()
    head = lines[0].split("\t")
    return head, [[float(v) for v in line.split("\t")] for line in lines[1:]]


MADRQN_TINY = dict(o="gnn", c="tarmac", mixer=True, double_q=True, hidden_size=16, n_heads=2,
                   msg_size=8, key_size=4, embed_dim=8, batch_size=4, replay_size=40,
                   steps_per_epoch=80, epochs=2, update_after=40, decay_steps=100,
                   num_test_episodes=2, save_freq=10, device="cpu")
DRQN_TINY = dict(hidden_size=16, n_heads=2, n_layers=1, max_seq_len=5, batch_size=4,
                 replay_size=50, steps_per_epoch=60, epochs=2, update_after=20,
                 decay_steps=100, num_test_episodes=2, save_freq=10, device="cpu")


def _jax_initialised(port_cls, jax_cls, jax_defaults):
    """A stand-in for the port's learner class that starts from the weights
    JAX's learner of the same seed starts from."""
    def make(env_info, args, seed=0):
        kw = {k: v for k, v in vars(args).items() if k in jax_defaults}
        jargs = jax_check_args(SN(**{**jax_defaults, **kw, "device": "cpu"}))
        jl = jax_cls(env_info, jargs, seed=seed)
        learner = port_cls(env_info, args, seed=seed)
        learner.load_params(jax.tree_util.tree_map(np.asarray, jl.params))
        return learner
    return make


@pytest.mark.parametrize("algo", ["madrqn", "drqn_gnn", "drqn_rnn"])
def test_tiny_classic_train_matches_jax(monkeypatch, tmp_path, algo):
    if algo == "madrqn":
        env_fn, jax_env_fn, env_kwargs = MultiUbsCoverageEnv, JaxMubs, dict(map_id="debug")
        kw, port, jax_run = MADRQN_TINY, madrqn_run, jax_madrqn_run
        monkeypatch.setattr(port, "MultiAgentQLearner",
                            _jax_initialised(MultiAgentQLearner, JaxLearner, JAX_DEFAULTS))
        jax_cls = JaxLearner
    else:
        env_fn, jax_env_fn = SingleUbsCoverageEnv, JaxSubs
        env_kwargs = dict(n_grps=2, gts_per_grp=1, episode_limit=20)
        kw, port, jax_run = dict(DRQN_TINY, agent=algo[5:]), drqn_run, jax_drqn_run
        monkeypatch.setattr(port, "QLearner",
                            _jax_initialised(QLearner, JaxQLearner, JAX_DRQN_DEFAULTS))
        jax_cls = JaxQLearner
    jax_run.train(jax_env_fn, env_kwargs, 3, train_kwargs=dict(kw),
                  logger_kwargs=dict(output_dir=str(tmp_path / "jax"), exp_name="tiny"))
    learner = port.train(env_fn, env_kwargs, 3, train_kwargs=dict(kw),
                         logger_kwargs=dict(output_dir=str(tmp_path / "port"), exp_name="tiny"))
    head, rows = _table(tmp_path / "port" / "progress.txt")
    jhead, jrows = _table(tmp_path / "jax" / "progress.txt")
    assert head == jhead and len(rows) == len(jrows) == 2
    keep = [i for i, k in enumerate(head) if k not in TIME_COLUMNS]
    for row, jrow in zip(rows, jrows):
        np.testing.assert_allclose([row[i] for i in keep], [jrow[i] for i in keep],
                                   rtol=1e-4, atol=1e-6, err_msg=str([head[i] for i in keep]))
    assert np.isfinite(rows[1][head.index("LossQ")])
    assert sorted(p.name for p in (tmp_path / "port").glob("checkpoint_epoch*.pt")) == \
        sorted(p.name for p in (tmp_path / "jax").glob("checkpoint_epoch*.pt")) == \
        ["checkpoint_epoch2.pt"]
    config = json.loads((tmp_path / "port" / "config.json").read_text())
    jconfig = json.loads((tmp_path / "jax" / "config.json").read_text())
    assert config.keys() == jconfig.keys()
    saved = list(config["args"].values())[0]
    assert saved.keys() >= set(kw) and saved["device"] == "cpu"

    # The port's checkpoint in JAX's learner, leaf for leaf.
    defaults = JAX_DEFAULTS if algo == "madrqn" else JAX_DRQN_DEFAULTS
    jargs = jax_check_args(SN(**{**defaults, **kw}))
    wrap = jax_make_env if algo == "madrqn" else jax_make_drqn_env
    env_info = wrap(partial(jax_env_fn, **env_kwargs, record=False), jargs).get_env_info()
    jl = jax_cls(env_info, jargs, seed=11)
    stamp = jl.load_checkpoint(str(tmp_path / "port" / "checkpoint_epoch2.pt"))
    assert stamp == {"epoch": 2, "t": 2 * kw["steps_per_epoch"] - 1}
    want = learner_params_to_jax(learner._by_group(lambda p: p.detach()))
    got = jax.tree_util.tree_map(np.asarray, jl.params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)


def _grid_of(path, module, monkeypatch):
    """The ExperimentGrid a grid script builds, and the thunk it would run."""
    seen = []
    monkeypatch.setattr(module.ExperimentGrid, "run",
                        lambda self, thunk, **kw: seen.append((self, thunk, kw)))
    runpy.run_path(str(path), run_name="__main__")
    monkeypatch.undo()
    return seen[0]


def _named(variant):
    """A variant with classes by name, and without the JAX grids' device key."""
    out = {}
    for k, v in variant.items():
        if isinstance(v, dict):
            v = _named(v)
        elif isinstance(v, type):
            v = v.__name__
        if k != "device":
            out[k] = v
    return out


@pytest.mark.parametrize("n", [1, 2, 3])
def test_experiment_grids_match_jax(monkeypatch, n):
    jeg, jthunk, jkw = _grid_of(ROOT / f"run_exp{n}.py", jax_run_utils, monkeypatch)
    eg, thunk, kw = _grid_of(ROOT / "uav_bs_ctrl_tpu_torch" / f"run_exp{n}.py", run_utils,
                             monkeypatch)
    assert kw == jkw
    assert thunk.__module__.startswith("uav_bs_ctrl_tpu_torch.algos.")
    assert thunk.__name__ == jthunk.__name__ == "train"
    jvariants, variants = jeg.variants(), eg.variants()
    assert [jeg.variant_name(v) for v in jvariants] == [eg.variant_name(v) for v in variants]
    assert [_named(v) for v in variants] == [_named(v) for v in jvariants]
    assert all(v["train_kwargs"]["device"] == "tpu" for v in jvariants)
    assert not any("device" in v["train_kwargs"] for v in variants)
    assert len(variants) == (18 if n == 1 else 27)


def test_grid_naming_and_nesting_match_jax():
    grids = []
    for mod in (run_utils, jax_run_utils):
        eg = mod.ExperimentGrid(name="exp2")
        eg.add("seed", [0, 10])
        eg.add("env_kwargs:map_id", ["inf", "r400"], "", True)
        eg.add("train_kwargs:c", [None, "tarmac"], "", True)
        eg.add("train_kwargs:mixer", [True, False], "qmix")
        eg.add("train_kwargs:lr", [1e-3, 2.5e-4])
        grids.append(eg)
    assert [grids[0].variant_name(v) for v in grids[0].variants()] == \
        [grids[1].variant_name(v) for v in grids[1].variants()]
    assert grids[0].variants() == grids[1].variants()
    assert run_utils.test_eg() == jax_run_utils.test_eg()


def test_one_variant_grid_runs_in_a_subprocess(tmp_path):
    """The exp1 DRQN gnn agent through ``call_experiment``'s pickled thunk."""
    eg = run_utils.ExperimentGrid(name="grid")
    eg.add("seed", [0])
    eg.add("env_fn", SingleUbsCoverageEnv)
    eg.add("env_kwargs:n_grps", [2], "grp", True)
    eg.add("env_kwargs:gts_per_grp", 2)
    eg.add("env_kwargs:episode_limit", 20)
    eg.add("train_kwargs:agent", "gnn", "", True)
    for k, v in DRQN_TINY.items():
        eg.add(f"train_kwargs:{k}", v)
    assert eg.run(drqn_run.train, data_dir=str(tmp_path)) == []
    run_dir = tmp_path / "grid_grp2_gnn" / "grid_grp2_gnn_s0"
    head, rows = _table(run_dir / "progress.txt")
    assert len(rows) == 2 and head[0] == "Epoch" and np.isfinite(rows[1][head.index("LossQ")])
    config = json.loads((run_dir / "config.json").read_text())
    assert config["env_fn"] == "SingleUbsCoverageEnv" and config["seed"] == 0
    assert list(config["args"].values())[0]["agent"] == "gnn"
    assert (run_dir / "checkpoint_epoch2.pt").exists()
    # What goes to the subprocess pickles without cloudpickle.
    pickle.loads(pickle.dumps(partial(drqn_run.train, env_fn=SingleUbsCoverageEnv)))


def test_run_classic_presets_are_jax_without_a_device():
    for exp, preset in jax_run_classic.PRESETS.items():
        assert run_classic.PRESETS[exp] == {k: v for k, v in preset.items() if k != "device"}


def test_run_classic_cli_at_full_width_on_the_cpu(tmp_path):
    """One epoch of 340 steps on ``debug`` (10-step episodes): updates start
    at B T = 320 steps, so the epoch takes two (an epoch without one has no
    LossQ to log, in both packages)."""
    learner = run_classic.main(["--exp", "exp3", "--map", "debug", "--c", "tarmac", "--mixer",
                                "--device", "cpu", "--epochs", "1", "--steps-per-epoch", "340",
                                "--update-after", "0", "--data-dir", str(tmp_path)])
    assert learner.net.hidden == 256 and learner.mixer is not None
    run_dir = tmp_path / "exp3_classic_debug_tarmac_qmix" / "exp3_classic_debug_tarmac_qmix_s0"
    head, rows = _table(run_dir / "progress.txt")
    assert len(rows) == 1 and rows[0][head.index("TotalEnvInteracts")] == 340
    assert np.isfinite(rows[0][head.index("LossQ")])
    assert (run_dir / "checkpoint_epoch1.pt").exists()
    assert len(learner.buffer) == 34                      # 340 steps of 10-step chunks
    step = learner.optimizer.state[learner.parameters()[0]]["step"]
    assert step.item() == 2
