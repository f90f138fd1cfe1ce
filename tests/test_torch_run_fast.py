"""The port's ``run_fast`` (``uav_bs_ctrl_tpu_torch/run_fast.py``) against
the JAX package's ``run_fast.py``.

- The schedules, on a grid of run shapes, as one parametrised test: both
  ``train_fast`` loops run a recording stand-in trainer whose learner steps its LR
  scale with each package's own ``step_lr_scheduler``; the epsilon and warm-up
  of every iteration, the LR scale at every iteration and save, the saved
  epochs and their stamps, the test episodes, and the ``progress.txt`` files
  (all but the two wall-clock columns) are equal, fresh and resumed.
- Both ``train_fast``s on the real trainers at a tiny shape on the CPU: the same
  header, ``Epoch`` and ``TotalEnvInteracts`` per row, the same warm-up rows
  (nan ``LossQ``) and the same checkpoint names, fresh and resumed. The
  values differ: the two packages draw from different generators.
- The loggers: the same stored values give byte-identical ``progress.txt``
  files, appended on resume without a second header.
- The CLI under a subprocess with an injected crash and ``--retries 2``
  resumes to the full budget, as ``tests/test_retry.py`` holds ``run_fast.py``.
- ``run_fast`` imports and runs where jax, optax, pandas, matplotlib and
  cloudpickle are missing; ``--compute-dtype bfloat16`` (which raised until
  ROADMAP.md Queue 1 item 5) reaches the drivers and gives a bf16 learner;
  the CLI runs exp2, the exp3 MLP ablation and every protocol, and its
  defaults are JAX's.
- exp2 and exp3 DiscreteComm on both packages' real trainers at a tiny width,
  and a port-written exp2 DiscreteComm checkpoint resumed by the JAX learner,
  whose next update matches the port's.
- exp1 (``train_fast_exp1``): the schedules against JAX's on the recording
  stand-in, fresh and resumed, and at the committed config the 62 epochs and
  the ``TotalEnvInteracts`` column of the committed ``progress.txt``; both
  packages' real DRQN trainers at a tiny width write the committed header,
  the same rows and checkpoints, and ``--resume`` appends; the CLI's exp1
  defaults and run names are JAX's, and it runs both agents at full width.
"""

import ast
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace as SN

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import run_fast as jax_run_fast
from test_torch_update import TOL, _check_first_update, _jax_first_update
from test_torch_update_protocols import _jax_noise
from uav_bs_ctrl_tpu.algos.common import check_args_sanity as jax_check_args
from uav_bs_ctrl_tpu.algos.madrqn.learner import MultiAgentQLearner as JaxLearner
from uav_bs_ctrl_tpu.algos.core import RecurrentQLearner as JaxCore
from uav_bs_ctrl_tpu.algos.madrqn.config import DEFAULT_CONFIG as JAX_DEFAULTS
from uav_bs_ctrl_tpu.utils.logx import EpochLogger as JaxLogger
from uav_bs_ctrl_tpu.utils.run_utils import setup_logger_kwargs as jax_setup_logger_kwargs
from uav_bs_ctrl_tpu_torch import run_fast
from uav_bs_ctrl_tpu_torch.algos.core import RecurrentQLearner as PortCore
from uav_bs_ctrl_tpu_torch.algos.madrqn import fused
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import DEFAULT_CONFIG, make_args
from uav_bs_ctrl_tpu_torch.utils.logx import EpochLogger as PortLogger
from uav_bs_ctrl_tpu_torch.utils.run_utils import setup_logger_kwargs

ROOT = Path(__file__).resolve().parents[1]
WALL_CLOCK = ("StepsPerSec", "Time")
BLOCKED = ["cloudpickle", "flax", "jax", "jaxlib", "matplotlib", "optax", "orbax", "pandas",
           "uav_bs_ctrl_tpu"]


def _table(path):
    lines = Path(path).read_text().splitlines()
    head = lines[0].split("\t")
    return head, [dict(zip(head, line.split("\t"))) for line in lines[1:]]


# ---------------------------------------------------------------- schedules

def _fake_trainer_class(T, record, core, defaults):
    """A trainer with the fused trainer's interface that records what
    ``train_fast`` asks of it; its learner steps the LR scale with ``core``'s own
    ``step_lr_scheduler`` and saves to a JSON file."""

    class Learner:
        step_lr_scheduler = core.step_lr_scheduler

        def __init__(self, anneal_lr):
            self.anneal_lr, self.lr_scale, self._epoch = anneal_lr, 1.0, 0

        def save_checkpoint(self, path, stamp):
            stamp = {k: int(v) for k, v in stamp.items()}
            record.append(("save", Path(path).name, stamp, self.lr_scale, self._epoch))
            Path(path).write_text(json.dumps(dict(stamp, epoch_lr=self._epoch,
                                                  lr_scale=self.lr_scale)))

        def load_checkpoint(self, path):
            saved = json.loads(Path(path).read_text())
            self._epoch, self.lr_scale = saved["epoch_lr"], saved["lr_scale"]
            record.append(("load", Path(path).name))
            return dict(epoch=saved["epoch"], t=saved["t"])

    class Trainer:
        def __init__(self, map_id, train_kwargs, n_worlds, capacity_chunks, n_layouts, seed,
                     interleave):
            self.args = SN(**{**defaults, **train_kwargs})
            self.T = T
            self.learner = Learner(self.args.anneal_lr)
            self.n = 0
            record.append(("trainer", capacity_chunks, n_worlds, interleave))

        def run_iteration(self, eps, warmup=False):
            self.n += 1
            record.append(("iteration", eps, warmup, self.learner.lr_scale))
            out = dict(EpRet=0.5 * self.n, FairIdx=1.0 / self.n, AvgGlobalUtility=0.25 * self.n)
            if not warmup:
                out["LossQ"] = 2.0 / self.n
            return out

        def evaluate(self, n_episodes=8, eps=0.05):
            record.append(("evaluate", n_episodes))
            x = np.arange(n_episodes, dtype=np.float32) + self.n
            return dict(TestEpRet=x, TestFairIdx=x / 7, TestAvgGlobalUtility=x / 3,
                        TestTotalThroughput=x * 2, TestProbCollision=x / 100)

    return Trainer


# (n_worlds, T, steps_per_epoch, epochs, resumed epochs, overrides)
SHAPES = {
    "exp3-flagship": (40, 50, 30000, 4, 6, {}),
    "epoch-not-a-multiple": (4, 40, 2000, 2, 3, dict(update_after=500, save_freq=1)),
    "epoch-under-an-iteration": (40, 50, 1000, 3, 5, dict(update_after=2000)),
    "no-anneal-sparse-saves": (8, 40, 640, 7, 9, dict(anneal_lr=False, save_freq=3,
                                                      decay_steps=1000, update_after=320)),
    "past-the-lr-and-eps-floors": (16, 50, 800, 104, 110, dict(save_freq=25, decay_steps=20000,
                                                              update_after=1600)),
    # exp2 (run as exp2 on r400): 40-step episodes, 12 iterations an epoch of
    # 20,000 steps, 37 iterations in 3 epochs; the preset saves every 10.
    "exp2-disc-preset": (40, 40, 20000, 3, 5, dict(c="disc", mixer=False)),
    "exp2-iql-qmix": (8, 40, 960, 4, 7, dict(c=None, save_freq=2, update_after=1600)),
}


def _drive(monkeypatch, tmp_path, package, shape):
    n_worlds, T, spe, epochs, resumed, extra = SHAPES[shape]
    record = []
    if package == "jax":
        module, logger_cls, core = jax_run_fast, JaxLogger, JaxCore
        defaults = JAX_DEFAULTS
    else:
        module, logger_cls, core = run_fast, PortLogger, PortCore
        defaults = DEFAULT_CONFIG
    trainer = _fake_trainer_class(T, record, core, defaults)
    monkeypatch.setattr(jax_run_fast if package == "jax" else fused, "FusedMadrqnTrainer",
                        trainer)
    assert module.EpochLogger is logger_cls
    out = tmp_path / package
    overrides = {**dict(c="tarmac", mixer=True, steps_per_epoch=spe), **extra}
    exp, map_id = ("exp2", "r400") if shape.startswith("exp2") else ("exp3", "8ubs")
    for epochs_now, resume in ((epochs, False), (resumed, True)):
        module.train_fast(exp, map_id, train_overrides=dict(overrides, epochs=epochs_now),
                          logger_kwargs=dict(output_dir=str(out), exp_name=shape),
                          n_worlds=n_worlds, resume=resume, interleave=2)
    monkeypatch.undo()
    head, rows = _table(out / "progress.txt")
    rows = [{k: v for k, v in row.items() if k not in WALL_CLOCK} for row in rows]
    return record, head, rows, sorted(p.name for p in out.glob("checkpoint_epoch*.pt"))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_schedules_saves_and_rows_match_jax_run_fast(monkeypatch, tmp_path, shape):
    want = _drive(monkeypatch, tmp_path, "jax", shape)
    got = _drive(monkeypatch, tmp_path, "port", shape)
    assert got[0] == want[0]
    assert got[1:] == want[1:]
    record, head, rows, names = got
    epochs = [int(r["Epoch"]) for r in rows]
    assert epochs == list(range(1, len(epochs) + 1)) and len(epochs) > 1
    assert head[0] == "Epoch" and head[-2:] == list(WALL_CLOCK)
    assert [r[0] for r in record].count("load") == 1
    assert f"checkpoint_epoch{epochs[-1]}.pt" in names


@pytest.mark.parametrize("n_iters,iters_per_epoch,save_freq",
                         [(1041, 10, 10), (1500, 15, 10), (1, 1, 10), (25, 12, 1), (63, 9, 4)])
def test_should_save_matches_jax(n_iters, iters_per_epoch, save_freq):
    for it in range(n_iters):
        if (it + 1) % iters_per_epoch == 0:
            epoch = (it + 1) // iters_per_epoch
            assert run_fast.should_save(epoch, it, iters_per_epoch, n_iters, save_freq) == \
                jax_run_fast.should_save(epoch, it, iters_per_epoch, n_iters, save_freq)


def test_setup_logger_kwargs_matches_jax_under_data_torch(tmp_path):
    for seed in (0, None, 3):
        assert setup_logger_kwargs("exp3_fast_8ubs", seed, data_dir=str(tmp_path)) == \
            jax_setup_logger_kwargs("exp3_fast_8ubs", seed, data_dir=str(tmp_path))
    default = setup_logger_kwargs("x", 1)["output_dir"]
    assert default == str(ROOT / "data_torch" / "x" / "x_s1")
    assert "data_torch/" in (ROOT / ".gitignore").read_text().splitlines()


def test_loggers_write_the_same_progress_txt_and_append_on_resume(tmp_path):
    rng = np.random.default_rng(0)
    rows = [dict(EpRet=rng.normal(size=5).astype(np.float32), LossQ=float(rng.normal()),
                 Step=int(rng.integers(100))) for _ in range(4)]
    for cls, name in ((JaxLogger, "jax"), (PortLogger, "port")):
        for part, append in ((rows[:2], False), (rows[2:], True)):
            logger = cls(output_dir=str(tmp_path / name), append=append)
            for row in part:
                logger.store(EpRet=row["EpRet"], LossQ=row["LossQ"])
                logger.log_tabular("EpRet", with_min_and_max=True)
                logger.log_tabular("LossQ", average_only=True)
                logger.log_tabular("Step", row["Step"])
                logger.log_tabular("Nan", float("nan"))
                logger.dump_tabular()
            logger.output_file.close()
    got = (tmp_path / "port" / "progress.txt").read_text()
    assert got == (tmp_path / "jax" / "progress.txt").read_text()
    assert got.count("AverageEpRet") == 1 and len(got.splitlines()) == 5


# ---------------------------------------------------------------- real trainers

TINY = dict(c="tarmac", mixer=True, device="cpu", hidden_size=16, msg_size=8, n_heads=2,
            key_size=4, steps_per_epoch=160, update_after=160, replay_size=8, batch_size=2,
            save_freq=1)


def _tiny_run(train_fast, out, epochs, resume):
    train_fast("exp3", "debug", seed=0, train_overrides=dict(TINY, epochs=epochs),
               logger_kwargs=dict(output_dir=str(out), exp_name="tiny"), n_worlds=2,
               n_layouts=4, resume=resume)
    head, rows = _table(out / "progress.txt")
    return head, [(r["Epoch"], r["TotalEnvInteracts"], math.isnan(float(r["LossQ"])))
                  for r in rows], sorted(p.name for p in out.glob("checkpoint_epoch*.pt"))


def test_train_fast_writes_what_jax_train_fast_writes(tmp_path):
    """2 worlds x 10 steps an iteration, 8 iterations an epoch; the first
    epoch is all warm-up, the second takes 16 updates at B = 2. Two epochs in
    both packages; then the port resumes for a third (the schedule test holds
    resuming to JAX's)."""
    got = _tiny_run(run_fast.train_fast, tmp_path / "port", 2, False)
    assert got == _tiny_run(jax_run_fast.train_fast, tmp_path / "jax", 2, False)
    head, rows, names = _tiny_run(run_fast.train_fast, tmp_path / "port", 3, True)
    assert head == got[0]
    assert rows == [("1", "160", True), ("2", "320", False), ("3", "480", False)]
    assert names == [f"checkpoint_epoch{e}.pt" for e in (1, 2, 3)]
    config = json.loads((tmp_path / "port" / "config.json").read_text())
    assert config["args"]["device"] == "cpu" and config["exp_name"] == "tiny"


# (exp, map, protocol, QMIX): exp2's MLP-encoder agents on r400 (RnnAgent for
# iql) and exp3's 4-UBS DiscreteComm+QMIX run
PROTOCOL_RUNS = [("exp2", "r400", "disc", False), ("exp2", "r400", None, True),
                 ("exp2", "r400", "tarmac", False), ("exp3", "4ubs", "disc", True)]


def _tiny_protocol_run(train_fast, out, exp, map_id, c, mixer):
    """2 worlds, two iterations an epoch, two epochs; the first iteration is
    warm-up (B x T steps), every later one takes 2 updates at B = 2."""
    T = 40 if exp == "exp2" else 50
    overrides = dict(TINY, c=c, mixer=mixer, epochs=2, steps_per_epoch=4 * T,
                     update_after=2 * T)
    trainer = train_fast(exp, map_id, seed=0, train_overrides=overrides,
                         logger_kwargs=dict(output_dir=str(out), exp_name="tiny"), n_worlds=2,
                         n_layouts=4)
    head, rows = _table(out / "progress.txt")
    return trainer, (head, [(r["Epoch"], r["TotalEnvInteracts"], math.isnan(float(r["LossQ"])))
                            for r in rows],
                     sorted(p.name for p in out.glob("checkpoint_epoch*.pt")))


@pytest.mark.parametrize("exp,map_id,c,mixer", PROTOCOL_RUNS)
def test_train_fast_of_every_protocol_writes_what_jax_writes(tmp_path, exp, map_id, c, mixer):
    """exp2 and the exp3 DiscreteComm run at a tiny width on both packages'
    real trainers: the same header, epochs, steps and checkpoints, finite
    LossQ from the first iteration past warm-up, and the config the JAX
    driver writes."""
    trainer, got = _tiny_protocol_run(run_fast.train_fast, tmp_path / "port", exp, map_id, c,
                                      mixer)
    _, want = _tiny_protocol_run(jax_run_fast.train_fast, tmp_path / "jax", exp, map_id, c,
                                 mixer)
    assert got == want
    T = trainer.T
    assert got[1] == [("1", str(4 * T), False), ("2", str(8 * T), False)]
    assert type(trainer.learner.net).__name__ == ("RnnAgent" if c is None else "GnnAgent")
    assert trainer.replay["obs"].keys() == ({"agent", "adj"} if exp == "exp2"
                                            else {"agent", "gt", "ubs", "adj"})
    assert trainer.learner.optimizer.state[trainer.learner.parameters()[0]]["step"] == 6
    for name in ("port", "jax"):
        config = json.loads((tmp_path / name / "config.json").read_text())
        assert (config["exp"], config["map_id"], config["args"]["o"], config["args"]["c"]) == \
            (exp, map_id, "mlp" if exp == "exp2" else "gnn", c)


def test_jax_learner_resumes_a_port_exp2_disc_checkpoint_and_takes_the_same_update(tmp_path):
    """The port's exp2 DiscreteComm run (MLP encoder, 6 updates) writes its
    epoch-2 checkpoint; the JAX learner loads it (AdamW count 6) and its next
    update, on a batch from the port's ring and JAX's Gumbel noise of the
    update's key, matches the port's from the same file, under
    ``test_torch_update.py``'s rules."""
    trainer, _ = _tiny_protocol_run(run_fast.train_fast, tmp_path, "exp2", "r400", "disc", False)
    config = json.loads((tmp_path / "config.json").read_text())
    tp = trainer.env_params
    env_info = dict(obs_shape=fused.obs_shape(tp, "mlp"), state_shape=fused.state_shape(tp),
                    n_actions=tp.n_actions, n_agents=tp.n_ubs, episode_limit=tp.episode_limit)
    kw = dict(config["args"], max_seq_len=None)
    jl = JaxLearner(env_info, jax_check_args(SN(**{**JAX_DEFAULTS, **kw})))
    stamp = jl.load_checkpoint(str(tmp_path / "checkpoint_epoch2.pt"))
    assert (int(stamp["epoch"]), int(stamp["t"])) == (2, 8 * tp.episode_limit)
    assert int(jl.opt_state.inner_state[0].count) == 6
    port = MultiAgentQLearner(env_info, make_args(kw, device="cpu"), seed=3)
    port.load_checkpoint(tmp_path / "checkpoint_epoch2.pt")
    batch = {k: v.numpy() if not isinstance(v, dict) else {kk: vv.numpy() for kk, vv in v.items()}
             for k, v in trainer.sample_batch().items()}
    noise = _jax_noise(jax.random.PRNGKey(0), port.net.noise_shape((2,), tp.n_ubs),
                       tp.episode_limit)
    port.update_on_batch = functools.partial(port.update_on_batch, noise=noise)
    want = _jax_first_update(jl, jax.tree_util.tree_map(jnp.asarray, batch))
    _check_first_update(port, want, batch, True, TOL, scaled=True)


CLI = ["--exp", "exp3", "--map", "debug", "--c", "tarmac", "--mixer", "--seed", "0",
       "--epochs", "2", "--steps-per-epoch", "160", "--replay-size", "8", "--n-worlds", "2",
       "--n-layouts", "4", "--device", "cpu", "--save-freq", "1"]


def _clean_env():
    """The test's environment for a child run: the repo importable, no crash
    or supervisor marker, and one torch thread (the suite's workers share
    the cores)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for key in ("UAVBS_SUPERVISED", "UAVBS_TEST_CRASH_AT_ITER"):
        env.pop(key, None)
    return env


def test_cli_crash_with_retries_resumes_to_the_full_budget(tmp_path):
    """16 iterations of 2 worlds x 10 steps at full width, all warm-up (B = 32
    needs 320 steps first); epoch 1's checkpoint is written at iteration 7, the
    crash comes at iteration 10, and the relaunched child resumes from epoch 1."""
    env = _clean_env()
    env["UAVBS_TEST_CRASH_AT_ITER"] = "10"
    out = subprocess.run([sys.executable, "-m", "uav_bs_ctrl_tpu_torch.run_fast", *CLI,
                          "--retries", "2", "--data-dir", str(tmp_path)],
                         env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("relaunching with --resume") == 1
    assert "injected crash at iteration 10" in out.stderr
    run_dir = tmp_path / "exp3_fast_debug_tarmac_qmix" / "exp3_fast_debug_tarmac_qmix_s0"
    head, rows = _table(run_dir / "progress.txt")
    assert [r["Epoch"] for r in rows] == ["1", "2"] and head.count("Epoch") == 1
    assert [r["TotalEnvInteracts"] for r in rows] == ["160", "320"]
    assert sorted(p.name for p in run_dir.glob("*.pt")) == ["checkpoint_epoch1.pt",
                                                           "checkpoint_epoch2.pt"]


def test_supervised_child_does_not_recurse(tmp_path):
    env = _clean_env()
    env.update(UAVBS_SUPERVISED="1", UAVBS_TEST_CRASH_AT_ITER="0")
    out = subprocess.run([sys.executable, "-m", "uav_bs_ctrl_tpu_torch.run_fast", *CLI,
                          "--retries", "2", "--data-dir", str(tmp_path)],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "relaunching" not in out.stdout and "injected crash at iteration 0" in out.stderr


def test_run_fast_runs_where_jax_optax_pandas_are_missing(tmp_path):
    """``run_fast``'s modules import without torch; the CLI then runs two
    epochs and resumes for a third, all warm-up at full width (B = 32 needs
    320 steps first), with every module the GPU machine lacks blocked."""
    code = (
        "import sys, runpy\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import uav_bs_ctrl_tpu_torch.run_fast\n"
        "assert 'torch' not in sys.modules\n"
        f"base = ['run_fast', *{CLI!r}, '--data-dir', {str(tmp_path)!r}]\n"
        "for extra in ([], ['--resume', '--epochs', '3']):\n"
        "    sys.argv = base + extra\n"
        "    runpy.run_module('uav_bs_ctrl_tpu_torch.run_fast', run_name='__main__')\n"
        f"assert not any(sys.modules.get(n) for n in {BLOCKED!r})\n")
    out = subprocess.run([sys.executable, "-c", code], env=_clean_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    run_dir = tmp_path / "exp3_fast_debug_tarmac_qmix" / "exp3_fast_debug_tarmac_qmix_s0"
    _, rows = _table(run_dir / "progress.txt")
    assert [(r["Epoch"], r["TotalEnvInteracts"], r["LossQ"]) for r in rows] == \
        [("1", "160", "nan"), ("2", "320", "nan"), ("3", "480", "nan")]
    assert sorted(p.name for p in run_dir.glob("*.pt")) == [f"checkpoint_epoch{e}.pt"
                                                           for e in (1, 2, 3)]


@pytest.mark.parametrize("extra,item", [
    (["--exp", "exp1", "--agent", "gnn", "--compute-dtype", "bfloat16"], "item 5"),
    (["--compute-dtype", "bfloat16"], "item 5"),
    (["--exp", "exp2", "--c", "disc", "--compute-dtype", "bfloat16"], "item 5"),
])
def test_options_the_port_does_not_run_raise_naming_their_queue_item(tmp_path, monkeypatch,
                                                                     extra, item):
    """The options that raised until ROADMAP.md Queue 1 ``item`` was ported
    (bf16 compute) now run: the CLI accepts them and hands them to its
    driver, and the learner built from the driver's arguments computes in
    bf16 with f32 master params. The drivers are recorded, not run."""
    from uav_bs_ctrl_tpu_torch.algos.drqn import config as drqn_config
    from uav_bs_ctrl_tpu_torch.algos.drqn import fused as drqn_fused
    from uav_bs_ctrl_tpu_torch.algos.drqn.learner import QLearner
    from uav_bs_ctrl_tpu_torch.envs import torch_env, torch_env_subs
    calls = []
    monkeypatch.setattr(run_fast, "train_fast", lambda *a, **kw: calls.append(("fast", a, kw)))
    monkeypatch.setattr(run_fast, "train_fast_exp1",
                        lambda *a, **kw: calls.append(("exp1", a, kw)))
    argv = ["--exp", "exp3", "--c", "tarmac", "--device", "cpu", "--data-dir", str(tmp_path)]
    run_fast.main(argv + extra)
    (kind, args, kw), = calls
    overrides = kw["train_overrides"]
    assert overrides["compute_dtype"] == "bfloat16" and overrides["device"] == "cpu"
    if kind == "exp1":
        env_params = torch_env_subs.make_params(**args[0])
        cfg = {**drqn_config.DEFAULT_CONFIG, **run_fast.EXP1_PRESET, **overrides}
        learner = QLearner(dict(obs_shape=drqn_fused.obs_shape(env_params, cfg["agent"]),
                                n_actions=env_params.n_actions,
                                episode_limit=env_params.episode_limit),
                           drqn_config.check_args(SN(**cfg)))
    else:
        exp, map_id = args
        env_params = torch_env.make_params(map_id)
        kw_all = {**run_fast.EXP_PRESETS[exp], **overrides}
        learner = MultiAgentQLearner(
            dict(obs_shape=fused.obs_shape(env_params, kw_all["o"]),
                 state_shape=fused.state_shape(env_params), n_actions=env_params.n_actions,
                 n_agents=env_params.n_ubs, episode_limit=env_params.episode_limit),
            make_args(kw_all, device="cpu"))
    assert learner.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in learner.parameters())
    assert not list(tmp_path.iterdir())


# exp2 (the MLP encoder), the exp3 MLP ablation, and exp3 with DiscreteComm
# and without comm.
@pytest.mark.parametrize("extra,run", [
    (["--exp", "exp2", "--c", "tarmac"], "exp2_fast_r400_tarmac"),
    (["--exp", "exp3", "--c", "tarmac", "--o", "mlp"], "exp3_fast_4ubs_tarmac_mlp"),
    (["--exp", "exp3", "--c", "disc", "--mixer"], "exp3_fast_4ubs_disc_qmix"),
    (["--exp", "exp3", "--c", "none"], "exp3_fast_4ubs_iql"),
])
def test_cli_runs_exp2_the_mlp_ablation_and_every_protocol(tmp_path, extra, run):
    """One epoch of one all-warm-up iteration (2 worlds) at full width on the
    CPU: the run's directory, ``config.json``, ``progress.txt`` and the
    checkpoint the JAX learner reads."""
    T = 40 if "exp2" in extra else 50
    run_fast.main(extra + ["--device", "cpu", "--data-dir", str(tmp_path), "--epochs", "1",
                           "--steps-per-epoch", str(2 * T), "--n-worlds", "2",
                           "--n-layouts", "4", "--replay-size", "8", "--save-freq", "1"])
    run_dir = tmp_path / run / f"{run}_s0"
    _, rows = _table(run_dir / "progress.txt")
    assert [(r["Epoch"], r["TotalEnvInteracts"], r["LossQ"]) for r in rows] == \
        [("1", str(2 * T), "nan")]
    assert sorted(p.name for p in run_dir.glob("*.pt")) == ["checkpoint_epoch1.pt"]
    args = json.loads((run_dir / "config.json").read_text())["args"]
    assert args["o"] == ("mlp" if "exp2" in extra or "mlp" in extra else "gnn")
    assert args["c"] == (None if "none" in extra else extra[extra.index("--c") + 1])


def _jax_cli_defaults(exp):
    """``run_fast.py``'s ``--exp`` default and its map for ``exp``, read from
    its source (the parser lives under ``__main__``)."""
    tree = ast.parse((ROOT / "run_fast.py").read_text())
    default_exp = map_expr = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument" \
                and node.args and getattr(node.args[0], "value", None) == "--exp":
            default_exp = next(k.value.value for k in node.keywords if k.arg == "default")
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "map_id":
            map_expr = ast.Expression(node.value)
    cli = SN(map_id=None, exp=exp or default_exp)
    return cli.exp, eval(compile(map_expr, "run_fast.py", "eval"), {"cli": cli})


@pytest.mark.parametrize("exp", [None, "exp2", "exp3"])
def test_cli_defaults_equal_jax_run_fast(monkeypatch, tmp_path, exp):
    """No ``--exp`` trains exp2; the map defaults to r400 for exp2 and 4ubs
    otherwise, as ``run_fast.py:283`` and ``:346``."""
    seen = []
    monkeypatch.setattr(run_fast, "train_fast", lambda exp, map_id, **kw: seen.append(
        (exp, map_id, kw["logger_kwargs"]["exp_name"])))
    run_fast.main(([] if exp is None else ["--exp", exp]) + ["--device", "cpu", "--data-dir",
                                                             str(tmp_path)])
    want_exp, want_map = _jax_cli_defaults(exp)
    assert seen == [(want_exp, want_map, f"{want_exp}_fast_{want_map}_iql")]
    assert seen[0][:2] == (("exp2", "r400") if exp in (None, "exp2") else ("exp3", "4ubs"))


# ---------------------------------------------------------------- exp1

EXP1_ROWS = ROOT / "data" / "exp1_fast_grp4_size5_gnn" / "exp1_fast_grp4_size5_gnn_s0"


def _fake_exp1_trainer_class(T, L, record, core, defaults):
    """The DRQN trainer's interface over ``_fake_trainer_class``'s recorder."""
    base = _fake_trainer_class(T, record, core, defaults)

    class Trainer(base):
        def __init__(self, env_kwargs, train_kwargs, n_worlds, n_layouts, seed):
            super().__init__(None, train_kwargs, n_worlds, None, n_layouts, seed, None)
            self.L = L
            record.append(("exp1", dict(env_kwargs)))

        def evaluate(self, n_episodes=5, eps=0.05):
            stats = super().evaluate(n_episodes, eps)
            stats.pop("TestProbCollision")
            return stats

    return Trainer


# (n_worlds, T, L, steps_per_epoch, epochs, resumed epochs, overrides)
EXP1_SHAPES = {
    "committed": (40, 200, 10, 20000, 50, None, {}),
    "small": (4, 40, 10, 320, 3, 5, dict(update_after=100, save_freq=2, batch_size=4)),
    "epoch-not-a-multiple": (2, 30, 5, 150, 4, 6, dict(update_after=0, decay_steps=500,
                                                       save_freq=3)),
}


def _drive_exp1(monkeypatch, tmp_path, package, shape):
    from uav_bs_ctrl_tpu_torch.algos.drqn import fused as drqn_fused
    from uav_bs_ctrl_tpu.algos.drqn.config import DEFAULT_CONFIG as JAX_DRQN_DEFAULTS
    from uav_bs_ctrl_tpu_torch.algos.drqn.config import DEFAULT_CONFIG as DRQN_DEFAULTS
    n_worlds, T, L, spe, epochs, resumed, extra = EXP1_SHAPES[shape]
    record = []
    if package == "jax":
        module, core, defaults, target = jax_run_fast, JaxCore, JAX_DRQN_DEFAULTS, jax_run_fast
    else:
        module, core, defaults, target = run_fast, PortCore, DRQN_DEFAULTS, drqn_fused
    monkeypatch.setattr(target, "FusedDrqnTrainer",
                        _fake_exp1_trainer_class(T, L, record, core, defaults))
    out = tmp_path / package
    runs = [(epochs, False)] + ([(resumed, True)] if resumed else [])
    for epochs_now, resume in runs:
        module.train_fast_exp1(dict(n_grps=4, gts_per_grp=5), seed=3,
                               train_overrides=dict(extra, agent="gnn", steps_per_epoch=spe,
                                                    epochs=epochs_now),
                               logger_kwargs=dict(output_dir=str(out), exp_name=shape),
                               n_worlds=n_worlds, resume=resume)
    monkeypatch.undo()
    head, rows = _table(out / "progress.txt")
    rows = [{k: v for k, v in row.items() if k not in WALL_CLOCK} for row in rows]
    config = json.loads((out / "config.json").read_text())
    return record, head, rows, sorted(p.name for p in out.glob("checkpoint_epoch*.pt")), config


@pytest.mark.parametrize("shape", sorted(EXP1_SHAPES))
def test_exp1_schedules_saves_and_rows_match_jax_run_fast(monkeypatch, tmp_path, shape):
    want = _drive_exp1(monkeypatch, tmp_path, "jax", shape)
    got = _drive_exp1(monkeypatch, tmp_path, "port", shape)
    assert got[:4] == want[:4]
    assert got[4] == want[4] and got[4]["exp"] == "exp1"
    record, head, rows, names, _ = got
    committed_head, committed = _table(EXP1_ROWS / "progress.txt")
    assert head == committed_head
    warm = [r[2] for r in record if r[0] == "iteration"]
    assert warm[0] and not warm[-1]
    if shape == "committed":
        assert len(rows) == 62 and [r[0] for r in record].count("iteration") == 125
        assert [r["TotalEnvInteracts"] for r in rows] == \
            [r["TotalEnvInteracts"] for r in committed] == [str(16000 * e) for e in range(1, 63)]
        assert [r["Epoch"] for r in rows] == [r["Epoch"] for r in committed]
        assert names == [f"checkpoint_epoch{e}.pt" for e in (10, 20, 30, 40, 50, 60, 62)]
        assert sum(warm) == 2                  # update_after 10,000 at 8,000 steps an iteration
    else:
        assert [r[0] for r in record].count("load") == 1


TINY_EXP1 = dict(device="cpu", hidden_size=16, n_heads=2, n_layers=1, batch_size=2,
                 replay_size=40, save_freq=1, steps_per_epoch=80, update_after=80)


def _tiny_exp1_run(train_fast_exp1, out, agent, epochs, resume=False):
    """T = 20 (L = 10, two slices), 2 worlds: two iterations an epoch; the
    first epoch all warm-up, later ones 4 updates an iteration at B = 2."""
    trainer = train_fast_exp1(dict(n_grps=2, gts_per_grp=3, episode_limit=20), seed=0,
                              train_overrides=dict(TINY_EXP1, agent=agent, epochs=epochs),
                              logger_kwargs=dict(output_dir=str(out), exp_name="tiny"),
                              n_worlds=2, n_layouts=4, resume=resume)
    head, rows = _table(out / "progress.txt")
    return trainer, (head, [(r["Epoch"], r["TotalEnvInteracts"], math.isnan(float(r["LossQ"])))
                            for r in rows], sorted(p.name for p in out.glob("checkpoint_*.pt")))


@pytest.mark.parametrize("agent", ["gnn", "rnn"])
def test_train_fast_exp1_writes_what_jax_writes_and_resumes(tmp_path, agent):
    trainer, got = _tiny_exp1_run(run_fast.train_fast_exp1, tmp_path / "port", agent, 2)
    _, want = _tiny_exp1_run(jax_run_fast.train_fast_exp1, tmp_path / "jax", agent, 2)
    assert got == want
    assert got[0] == _table(EXP1_ROWS / "progress.txt")[0]
    assert got[1] == [("1", "80", True), ("2", "160", False)]
    assert got[2] == ["checkpoint_epoch1.pt", "checkpoint_epoch2.pt"]
    assert type(trainer.learner.net).__name__ == ("DrqnGnnAgent" if agent == "gnn" else "RnnAgent")
    assert trainer.learner.optimizer.state[trainer.learner.parameters()[0]]["step"] == 8
    assert trainer.capacity == 40 and trainer._size == 16
    _, again = _tiny_exp1_run(run_fast.train_fast_exp1, tmp_path / "port", agent, 3, resume=True)
    assert again[0] == got[0]
    assert again[1] == got[1] + [("3", "240", False)]
    assert again[2] == got[2] + ["checkpoint_epoch3.pt"]


def _jax_exp1_cli():
    """``run_fast.py``'s exp1 CLI, read from its source (the parser lives under
    ``__main__``): the defaults of its exp1 options and its run-name format."""
    tree = ast.parse((ROOT / "run_fast.py").read_text())
    defaults, name_expr = {}, None
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument" \
                and node.args and getattr(node.args[0], "value", None) in (
                    "--agent", "--n-grps", "--gts-per-grp", "--n-worlds"):
            defaults[node.args[0].value] = next(k.value.value for k in node.keywords
                                                if k.arg == "default")
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "name" \
                and isinstance(node.value, ast.JoinedStr) \
                and "exp1_fast" in ast.unparse(node.value):
            name_expr = ast.Expression(node.value)
    return defaults, lambda cli: eval(compile(name_expr, "run_fast.py", "eval"), {"cli": cli})


@pytest.mark.parametrize("extra", [[], ["--agent", "gnn", "--n-grps", "4", "--name-suffix", "x"]])
def test_exp1_cli_defaults_and_run_name_equal_jax(monkeypatch, tmp_path, extra):
    seen = []
    monkeypatch.setattr(run_fast, "train_fast_exp1", lambda env_kwargs, **kw: seen.append(
        (env_kwargs, kw)))
    run_fast.main(["--exp", "exp1", "--device", "cpu", "--data-dir", str(tmp_path)] + extra)
    (env_kwargs, kw), = seen
    defaults, name_of = _jax_exp1_cli()
    cli = SN(agent=defaults["--agent"], n_grps=defaults["--n-grps"],
             gts_per_grp=defaults["--gts-per-grp"])
    for flag, value in zip(extra[::2], extra[1::2]):
        if flag != "--name-suffix":
            setattr(cli, flag[2:].replace("-", "_"),
                    value if flag == "--agent" else int(value))
    want = name_of(cli) + ("_x" if "x" in extra else "")
    assert kw["logger_kwargs"]["exp_name"] == want
    assert want == ("exp1_fast_grp2_size5_rnn" if not extra else "exp1_fast_grp4_size5_gnn_x")
    assert env_kwargs == dict(n_grps=cli.n_grps, gts_per_grp=cli.gts_per_grp)
    assert kw["train_overrides"]["agent"] == cli.agent
    assert kw["n_worlds"] == defaults["--n-worlds"] == 40


@pytest.mark.parametrize("agent", ["gnn", "rnn"])
def test_cli_runs_exp1_at_full_width(tmp_path, agent):
    """One all-warm-up epoch of one 200-step iteration (2 worlds) at the
    preset's width on the CPU: the run's directory, ``config.json``,
    ``progress.txt`` with exp1's columns, and the checkpoint."""
    run_fast.main(["--exp", "exp1", "--agent", agent, "--n-grps", "4", "--device", "cpu",
                   "--data-dir", str(tmp_path), "--epochs", "1", "--steps-per-epoch", "400",
                   "--n-worlds", "2", "--n-layouts", "4", "--save-freq", "1"])
    run = f"exp1_fast_grp4_size5_{agent}"
    run_dir = tmp_path / run / f"{run}_s0"
    head, rows = _table(run_dir / "progress.txt")
    assert head == _table(EXP1_ROWS / "progress.txt")[0]
    assert [(r["Epoch"], r["TotalEnvInteracts"], r["LossQ"]) for r in rows] == [("1", "400", "nan")]
    assert sorted(p.name for p in run_dir.glob("*.pt")) == ["checkpoint_epoch1.pt"]
    config = json.loads((run_dir / "config.json").read_text())
    assert (config["exp"], config["env_kwargs"], config["args"]["agent"]) == \
        ("exp1", dict(n_grps=4, gts_per_grp=5), agent)


def test_exp1_cli_without_a_card_raises_unless_device_cpu(monkeypatch, tmp_path):
    """The default device is CUDA: where ``torch.cuda.is_available()`` is False
    the exp1 CLI raises instead of running on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        run_fast.main(["--exp", "exp1", "--agent", "gnn", "--epochs", "1",
                       "--data-dir", str(tmp_path)])
