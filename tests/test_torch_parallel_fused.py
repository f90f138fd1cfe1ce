"""The dp-sharded fused trainer (``FusedMadrqnTrainer(mesh=...)``) against
the single-rank port trainer, and the cross-rank statistics and logger
(``parallel/dist.py``, ``utils/logx.py``) against the JAX package's math.

Two process groups are spawned once for the module: 4 gloo ranks (the dp =
4 trainer and ``dist_statistics_scalar``) and 2 (the dp = 2 trainer, a dp =
2 DiscreteComm trainer, and the rank-0 logger). The trainers run
``tests/test_parallel.py:388-421``'s setting ('debug', ``o='mlp'``, TarMAC,
8 worlds, a 16-chunk ring, seed 3, a warm-up and two iterations): LossQ and
EpRet rtol 1e-5, params atol 2e-5, rtol 1e-3, as there.
"""

import numpy as np
import pytest
import torch

from uav_bs_ctrl_tpu.parallel.dist import combine_host_stats, local_stat_row
from uav_bs_ctrl_tpu_torch.algos.madrqn.fused import FusedMadrqnTrainer
from uav_bs_ctrl_tpu_torch.parallel import launch, workers

KW = dict(o="mlp", c="tarmac", hidden_size=16, msg_size=8, batch_size=8, replay_size=64,
          max_seq_len=None, double_q=True)
SIZES = dict(n_worlds=8, capacity_chunks=16, n_layouts=4, seed=3)
SCHEDULE = [(1.0, True), (0.7, False), (0.5, False)]
TRAINERS = {"tarmac": KW, "disc": dict(KW, c="disc")}
SAMPLES = [np.random.default_rng(r).normal(loc=3.0 * r, scale=1.0 + r, size=10 + 7 * r)
           for r in range(4)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{(name, dp): [each rank's result]}`` and the logger's directory."""
    log_dir = tmp_path_factory.mktemp("ranks_logger")
    four = launch.spawn(4, [
        (workers.fused_train, dict(map_id="debug", train_kwargs=KW, trainer_kw=SIZES,
                                   schedule=SCHEDULE)),
        (workers.stats_probe, dict(samples=SAMPLES))], "cpu")
    two = launch.spawn(2, [
        (workers.fused_train, dict(map_id="debug", train_kwargs=kw, trainer_kw=SIZES,
                                   schedule=SCHEDULE)) for kw in TRAINERS.values()] + [
        (workers.logger_probe, dict(out_dir=str(log_dir), samples=SAMPLES[:2]))], "cpu")
    return {("tarmac", 4): four[0], "stats": four[1], ("tarmac", 2): two[0],
            ("disc", 2): two[1], "logger": two[2], "log_dir": log_dir}


def _single(kw):
    """The single-rank port trainer's metrics and params on the same schedule."""
    trainer = FusedMadrqnTrainer("debug", dict(kw, device="cpu"), **SIZES)
    with torch.enable_grad():
        metrics = [trainer.run_iteration(eps, warmup=warmup) for eps, warmup in SCHEDULE]
    names = [f"{g}.{k}" for g, ps in trainer.learner._by_group(lambda p: p).items() for k in ps]
    params = {n: p.detach().numpy() for n, p in zip(names, trainer.learner.parameters())}
    return metrics, params, (trainer._size, trainer._ptr)


@pytest.mark.parametrize("name,dp", [("tarmac", 2), ("tarmac", 4), ("disc", 2)])
def test_dp_fused_trainer_matches_single_rank(ranks, name, dp):
    """Each rank collects its block of the worlds into its shard of the
    ring, trains on its rows of the single-rank trainer's batches (fetched
    from their owners) and ends with the single-rank trainer's metrics and
    params; the DiscreteComm trainer draws its per-step noise at the full 8
    worlds and keeps its rows."""
    metrics, params, ring = _single(TRAINERS[name])
    for rank in ranks[name, dp]:
        assert rank["ring"] == ring == (16, 8)      # 24 chunks written into 16 slots
        assert rank["local_rows"] == 16 // dp
        for got, want in zip(rank["metrics"], metrics):
            assert got.keys() == want.keys()
            for k in ("LossQ", "EpRet") if "LossQ" in want else want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        assert rank["params"].keys() == params.keys()
        for k, v in params.items():
            np.testing.assert_allclose(rank["params"][k], v, atol=2e-5, rtol=1e-3, err_msg=k)


def test_dist_statistics_scalar_matches_jax_combine(ranks):
    """Four ranks' samples of different means and spreads: the port's
    all-gathered statistics are JAX's ``combine_host_stats`` of JAX's
    per-host rows, and NumPy's over the concatenation (each sample rounded
    to float32 first, as both loggers do)."""
    rows = np.asarray([local_stat_row(np.float32(s)) for s in SAMPLES])
    want = combine_host_stats(rows, with_min_and_max=True)
    both = np.concatenate([np.float32(s) for s in SAMPLES]).astype(np.float64)
    for got in ranks["stats"]:
        np.testing.assert_allclose(got, want, rtol=1e-12)
        np.testing.assert_allclose(got, [both.mean(), both.std(), both.min(), both.max()],
                                   rtol=1e-9)


def test_rank_zero_logger_writes_both_ranks_statistics(ranks):
    """Only rank 0 makes its directory and writes ``progress.txt`` and
    ``config.json``; its ``X`` columns cover both ranks' samples."""
    r0, r1 = ranks["logger"]
    assert (r0["proc_id"], r1["proc_id"]) == (0, 1) and r1["output_dir"] is None
    log_dir = ranks["log_dir"]
    assert sorted(p.name for p in log_dir.iterdir()) == ["rank0"]
    assert sorted(p.name for p in (log_dir / "rank0").iterdir()) == ["config.json",
                                                                     "progress.txt"]
    head, row = (line.split("\t") for line in
                 (log_dir / "rank0" / "progress.txt").read_text().splitlines())
    assert head == ["Epoch", "AverageX", "StdX", "MaxX", "MinX"]
    both = np.concatenate([np.float32(s) for s in SAMPLES[:2]]).astype(np.float64)
    np.testing.assert_allclose([float(v) for v in row[1:]],
                               [both.mean(), both.std(), both.max(), both.min()], rtol=1e-9)
