"""The port's evaluation harness and curve collector against the JAX package's
root ``test_policies.py`` and ``collect_curves.py``.

- ``test_series`` of both packages over the committed exp1 2 x 5 gnn run
  (seed 10, epoch 50) and the 4-UBS TarMAC+QMIX run (epoch 200), 2 episodes
  each, one call: ``test_summary.csv`` and ``test_summary_t.csv`` read back
  by pandas as the same frames within 1e-5 (the port writes them with the
  ``csv`` module), and every episode's CSVs the same.
- ``load_and_run_policy`` of both packages on the exp1 rnn and exp2 r400
  TarMAC runs (the flat-observation agents): the same per-episode info.
- The harness never reads a run's stored ``device``: with none given it
  needs CUDA and raises here, though every committed exp1 config stores
  ``"cpu"``.
- The CLI runs where jax, pandas, matplotlib and cloudpickle are missing.
- ``collect_curves`` writes JAX's CSV byte for byte on committed runs.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import collect_curves as jax_collect_curves
import test_policies as jax_test_policies
from uav_bs_ctrl_tpu_torch import collect_curves, test_policies
from uav_bs_ctrl_tpu_torch.utils.profiling import StepTimer

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "data"
EXP1_GNN = DATA / "exp1_fast_grp2_size5_gnn" / "exp1_fast_grp2_size5_gnn_s10"
EXP3_4UBS = DATA / "exp3_fast_4ubs_tarmac_qmix" / "exp3_fast_4ubs_tarmac_qmix_s0"
BLOCKED = ["cloudpickle", "flax", "jax", "jaxlib", "matplotlib", "optax", "orbax", "pandas",
           "uav_bs_ctrl_tpu"]


def _frame(path, header):
    return pd.read_csv(path, header=header, index_col=0)


def _same_episode_csvs(got_dir, want_dir):
    names = sorted(p.relative_to(want_dir) for p in want_dir.rglob("*.csv"))
    assert names == sorted(p.relative_to(got_dir) for p in got_dir.rglob("*.csv"))
    assert names
    for name in names:
        header = [0, 1, 2] if name.name == "path_ubs.csv" else 0
        if (want_dir / name).read_text() == '""\n':
            assert (got_dir / name).read_text() == '""\n'
            continue
        pd.testing.assert_frame_equal(_frame(got_dir / name, header),
                                      _frame(want_dir / name, header), rtol=1e-5, atol=1e-5)


def test_test_series_matches_jax(tmp_path):
    """One call over an exp1 run and a 4-UBS run (each run's algo from its
    config.json), checkpoints at epochs 50 and 200 (each run has its own)."""
    outs = {}
    for name, module in (("port", test_policies), ("jax", jax_test_policies)):
        out = tmp_path / name
        kw = dict(device="cpu")
        if name == "port":
            timer = kw["timer"] = StepTimer()
        for run, ckpt in ((EXP1_GNN, "checkpoint_epoch50.pt"),
                          (EXP3_4UBS, "checkpoint_epoch200.pt")):
            module.test_series(None, ["EpRet", "AvgGlobalUtility", "TotalThroughput", "FairIdx"],
                               [str(run)], ckpt, 2, str(out / run.name), **kw)
        outs[name] = out
    times = timer.flush()
    assert set(times) == {"TimeActMs", "TimeEnvMs"}
    for run in (EXP1_GNN, EXP3_4UBS):
        got, want = outs["port"] / run.name, outs["jax"] / run.name
        summary = _frame(got / "test_summary.csv", [0, 1])
        assert summary.shape == (2, 4)
        pd.testing.assert_frame_equal(summary, _frame(want / "test_summary.csv", [0, 1]),
                                      rtol=1e-5, atol=1e-5)
        pd.testing.assert_frame_equal(_frame(got / "test_summary_t.csv", [0, 1]),
                                      _frame(want / "test_summary_t.csv", [0, 1]),
                                      rtol=1e-5, atol=1e-5)
        assert (got / "test_summary.csv").read_text().splitlines()[:2] == \
            (want / "test_summary.csv").read_text().splitlines()[:2]
        assert not (got / "test_summary.png").exists()
        _same_episode_csvs(got, want)


def test_test_series_merges_two_experiments_as_jax(tmp_path):
    """Two runs of two experiments in one summary (an exp1 rnn run has 200-step
    episodes, the 4-UBS run 50), one episode each."""
    runs = [str(DATA / "exp1_fast_grp2_size5_rnn" / "exp1_fast_grp2_size5_rnn_s10"),
            str(EXP3_4UBS)]
    metrics = ["EpRet", "FairIdx"]
    for run in runs:
        assert (Path(run) / "checkpoint_epoch50.pt").exists()
    test_policies.test_series(None, metrics, runs, "checkpoint_epoch50.pt", 1,
                              str(tmp_path / "port"), device="cpu")
    jax_test_policies.test_series(None, metrics, runs, "checkpoint_epoch50.pt", 1,
                                  str(tmp_path / "jax"), device="cpu")
    for name in ("test_summary.csv", "test_summary_t.csv"):
        got = _frame(tmp_path / "port" / name, [0, 1])
        assert got.shape == ((1, 4) if name == "test_summary.csv" else (2, 2))
        pd.testing.assert_frame_equal(got, _frame(tmp_path / "jax" / name, [0, 1]),
                                      rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("run,ckpt", [
    ("exp1_fast_grp4_size5_rnn/exp1_fast_grp4_size5_rnn_s0", "checkpoint_epoch50.pt"),
    ("exp2_fast_r400_tarmac/exp2_fast_r400_tarmac_s0", "checkpoint_epoch100.pt"),
])
def test_load_and_run_policy_matches_jax(tmp_path, run, ckpt):
    config = json.loads((DATA / run / "config.json").read_text())
    results = []
    for module in (test_policies, jax_test_policies):
        algo, env_fn, env_kwargs, args = module.parse_run_config(config, "cpu")
        fn = module.TEST_FUNCTIONS[algo]
        kw = dict(device="cpu") if module is test_policies else {}   # not read from args
        results.append(fn(str(DATA / run / ckpt), env_fn, env_kwargs, config["seed"], args, 1,
                          str(tmp_path / module.__name__), **kw))
    got, want = results
    assert isinstance(got, dict) and list(got) == list(want.columns)
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   want[k].to_numpy(np.float64), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_the_stored_device_is_never_read(monkeypatch, tmp_path):
    """Every committed exp1 config stores ``"device": "cpu"``; the harness
    takes the caller's device (default ``cuda``), so without CUDA it raises."""
    config = json.loads((EXP1_GNN / "config.json").read_text())
    assert config["args"]["device"] == "cpu"
    assert test_policies.parse_run_config(config)[3]["device"] is None
    assert test_policies.parse_run_config(config, "cpu")[3]["device"] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        test_policies.test_series(None, ["EpRet"], [str(EXP1_GNN)], "checkpoint_epoch50.pt", 1,
                                  str(tmp_path))


def test_cli_runs_where_jax_pandas_matplotlib_are_missing(tmp_path):
    code = (
        "import sys, runpy\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = ['test_policies', '--logdirs', {str(EXP3_4UBS)!r}, '--ckpt',"
        f" 'checkpoint_epoch200.pt', '--episodes', '1', '--out', {str(tmp_path)!r},"
        " '--device', 'cpu']\n"
        "runpy.run_module('uav_bs_ctrl_tpu_torch.test_policies', run_name='__main__')\n"
        f"assert not any(sys.modules.get(n) for n in {BLOCKED!r})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(stats) == {f"{m}/exp3_fast_4ubs_tarmac_qmix" for m in test_policies.METRICS}
    assert (tmp_path / "test_summary.csv").exists() and (tmp_path / "test_summary_t.csv").exists()
    assert sorted(p.name for p in (tmp_path / "exp3_fast_4ubs_tarmac_qmix_seed0" /
                                   "episode0").iterdir()) == \
        ["others.csv", "path_ubs.csv", "pos_gts.csv"]


@pytest.mark.parametrize("xaxis,metric", [("TotalEnvInteracts", "AverageEpRet"),
                                          ("Epoch", "LossQ"), ("Epoch", "AverageTestEpRet")])
def test_collect_curves_matches_jax_byte_for_byte(tmp_path, xaxis, metric):
    dirs = [str(DATA / d) for d in ("exp1_fast_grp2_size5_gnn", "exp3_fast_4ubs_tarmac_qmix",
                                    "exp2_fast_r400_tarmac", "exp2_fast_r400_iql")]
    jax_collect_curves.collect_curves(dirs, xaxis, metric, str(tmp_path / "jax"))
    collect_curves.collect_curves(dirs, xaxis, metric, str(tmp_path / "port"))
    name = f"{xaxis}_vs_{metric}.csv"
    assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
