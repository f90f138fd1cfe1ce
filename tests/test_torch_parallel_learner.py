"""The port's sharded learner (``parallel/mesh.py:distribute_learner``) and
the dry run (``graft_entry.dryrun_multichip``) against the JAX package.

One process group of 4 gloo ranks is spawned once for the module; it runs
one update each of: the dp update (mp = 1), dp x mp = 2 x 2 (which also
writes a checkpoint), a gp = 4 step with ``gat_backend`` and
``comm_backend='graph_parallel'``, and a DiscreteComm dp update on JAX's
noise, all from ``learner_params_from_jax`` weights of one JAX learner and
one global batch. Each is held to JAX's single-device update on that batch:
LossQ rtol 1e-5, raw gradients and params atol 1e-5 (dp, dp x mp, disc;
``tests/test_parallel.py:56-99``), LossQ rtol 1e-5 and params atol 5e-5,
rtol 1e-3 for the gp step (``tests/test_parallel.py:166-243``). The flagship
dry-run case runs only on the card (``chip_smoke.py``).
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from test_torch_update import (A_DBG, DS_DBG, HID, K_DBG, M_DBG, _batch, _jax_first_update, _kw,
                               _learners, _np, _port_named)
from test_torch_update_protocols import _jax_noise
from uav_bs_ctrl_tpu.parallel import make_mesh as jax_make_mesh
from uav_bs_ctrl_tpu.parallel import shard_params_spec as jax_shard_params_spec
from uav_bs_ctrl_tpu_torch import graft_entry
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import make_args
from uav_bs_ctrl_tpu_torch.parallel import launch, workers

T, B = 5, 8
TOL = dict(atol=1e-5, rtol=1e-5)
GP_TOL = dict(atol=5e-5, rtol=1e-3)
ENV_INFO = dict(obs_shape={"agent": 2, "gt": 4, "ubs": 2}, state_shape=DS_DBG, n_actions=9,
                n_agents=A_DBG, episode_limit=T)
KW = dict(_kw(True, False), batch_size=B)
RUNS = {   # name: (config, (dp, mp, gp))
    "dp": (KW, (4, 1, 1)),
    "dp_mp": (KW, (2, 2, 1)),
    "gp": (dict(KW, gat_backend="graph_parallel", comm_backend="graph_parallel"), (1, 1, 4)),
    "disc": (dict(KW, c="disc"), (4, 1, 1)),
}


def _global_batch():
    return _batch(np.random.default_rng(8), B, T, A_DBG, M_DBG, K_DBG, DS_DBG, HID, 1)


def _dense(name):
    """Run ``name``'s configuration on the dense backends (JAX's reference)."""
    return tuple(sorted(dict(RUNS[name][0], gat_backend="dense", comm_backend="dense").items()))


@functools.lru_cache(maxsize=None)
def _jax_learner(kw):
    """The JAX learner of ``kw``, its weights as numpy (taken before its
    update donates them) and the port learner holding them."""
    jl, tl = _learners(dict(kw), ENV_INFO)
    return jl, _np(jl.params), tl


@functools.lru_cache(maxsize=None)
def _jax_update(kw):
    """JAX's single-device first update of ``kw`` on the global batch."""
    return _jax_first_update(_jax_learner(kw)[0],
                             jax.tree_util.tree_map(jnp.asarray, _global_batch()))


def _jax_run(name):
    """``(weights, port learner, JAX's update)`` of run ``name``."""
    _, tree, tl = _jax_learner(_dense(name))
    return tree, tl, _jax_update(_dense(name))


def _noise(tl):
    return {k: v.numpy() for k, v in _jax_noise(jax.random.PRNGKey(0),
                                                 tl.net.noise_shape((B,), A_DBG), T).items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{run: [each rank's learner_update result]}``; ``dp_mp`` wrote
    ``checkpoint.pt`` into ``ranks["dir"]``. JAX's updates compile here
    while the ranks run."""
    out_dir = tmp_path_factory.mktemp("parallel_learner")
    tasks = []
    for name, (cfg, dims) in RUNS.items():
        _, tree, tl = _jax_learner(_dense(name))
        tasks.append((workers.learner_update, dict(
            cfg=cfg, env_info=ENV_INFO, batch=_global_batch(), dims=dims, tree=tree,
            graph_parallel=dims[2] > 1, noise=_noise(tl) if name == "disc" else None,
            save=str(out_dir / "checkpoint.pt") if name == "dp_mp" else None)))
    out = {}

    def run():
        try:
            out["results"] = launch.spawn(4, tasks, "cpu")
        except BaseException as err:      # raised below, in the test's thread
            out["error"] = err

    thread = threading.Thread(target=run)
    thread.start()
    for name in RUNS:
        _jax_update(_dense(name))
    thread.join()
    if "error" in out:
        raise out["error"]
    results = dict(zip(RUNS, out["results"]))
    results["dir"] = out_dir
    return results


def _check(got, want, tol, grads=True):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["qvals"], want["qvals"], **TOL)
    pairs = [("params", "params"), ("targets", "targets")] + ([("grads", "raw")] if grads else [])
    for ours, theirs in pairs:
        assert got[ours].keys() == want[theirs].keys()
        for k, v in want[theirs].items():
            np.testing.assert_allclose(got[ours][k], v, err_msg=f"{ours} {k}", **tol)


@pytest.mark.parametrize("name", ("dp", "dp_mp"))
def test_sharded_update_matches_jax_single_device(ranks, name):
    """dp = 4 (2 rows a rank) and dp x mp = 2 x 2 (params, targets and AdamW
    moments kept as last-axis shards): every rank ends with JAX's update."""
    want = _jax_run(name)[2]
    for rank in ranks[name]:
        _check(rank, want, TOL)


def test_graph_parallel_step_matches_jax_dense(ranks):
    """gp = 4: 'seen' M = 4, 'near' K = 2 padded to 4 and the A = 3 talk
    graph padded to 4 sources, all edge-partitioned inside the update, held
    to JAX's dense step (no fallback warning: the worker's backends would
    have warned into the log, and ``graft_entry`` fails on one)."""
    want = _jax_run("gp")[2]
    for rank in ranks["gp"]:
        _check(rank, want, GP_TOL, grads=False)


def test_discrete_comm_dp_update_takes_its_noise_rows(ranks):
    """A DiscreteComm learner's ``draw_noise`` on a dp rank gives its rows
    of the single-rank learner's draw for the global batch (same generator
    stream), and the dp update on JAX's noise rows is JAX's update."""
    _, tl, want = _jax_run("disc")
    full = tl.draw_noise({"h": torch.zeros((B, 2, A_DBG, HID))})
    b = B // 4
    for r, rank in enumerate(ranks["disc"]):
        for k, v in full.items():
            np.testing.assert_array_equal(rank["drawn"][k], v[:, r * b:(r + 1) * b].numpy())
        _check(rank, want, TOL)


def test_shard_params_spec_names_the_same_leaves_as_jax(ranks):
    """At mp = 2 the port's rule shards exactly the leaves JAX's does, on
    the same axis, with at least one leaf each way."""
    specs, _ = jax.tree_util.tree_flatten_with_path(
        jax_shard_params_spec(_jax_run("dp_mp")[0], jax_make_mesh(8, mp=2)),
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(s)
            for path, s in specs}
    got = ranks["dp_mp"][0]["spec"]
    assert got == want
    assert {(), (None, "mp"), ("mp",)} <= set(got.values())


def test_distributed_checkpoint_is_the_single_rank_one(ranks, tmp_path):
    """The dp x mp learner's checkpoint (AdamW moments gathered over mp,
    written by rank 0) read by JAX's ``load_checkpoint`` equals the
    single-rank port learner's after the same update."""
    single = MultiAgentQLearner(ENV_INFO, make_args(KW, device="cpu"))
    single.load_params(_jax_run("dp_mp")[0])
    with torch.enable_grad():
        single.update_on_batch(jax.tree_util.tree_map(torch.from_numpy, _global_batch()))
    single.save_checkpoint(tmp_path / "single.pt", dict(epoch=1, t=0))
    loaded = []
    for path in (ranks["dir"] / "checkpoint.pt", tmp_path / "single.pt"):
        jax_learner = _learners(KW, ENV_INFO)[0]
        assert jax_learner.load_checkpoint(str(path)) == {"epoch": 1, "t": 0}
        adam = jax_learner.opt_state.inner_state[0]
        loaded.append([np.asarray(x) for x in jax.tree_util.tree_leaves(
            (jax_learner.params, adam.mu, adam.nu, adam.count))])
    for a, b in zip(*loaded):
        np.testing.assert_allclose(a, b, **TOL)
    port = _port_named(single, "params")
    assert len(loaded[0]) == 3 * len(port) + 1


@pytest.mark.parametrize("n", (4, 8))
def test_graft_dryrun_multichip_toy(n, capsys):
    """``dryrun_multichip`` on JAX's mesh rule: 4 ranks dp = 2, mp = 2; 8
    ranks dp = 2, mp = 2, gp = 2 with both relations and the talk graph
    edge-partitioned. Each rank's update is held to its single-rank twin at
    JAX's tolerances inside the ranks; a fallback warning fails it."""
    out = graft_entry.dryrun_multichip(n, "cpu", cases=("toy",))
    dims = graft_entry.mesh_dims(n)
    assert dims == ((2, 2, 1) if n == 4 else (2, 2, 2))
    assert [r["dims"] for r in out["toy"]] == [dims] * n
    assert all(r["backend"] == "gloo" and np.isfinite(r["loss"]) for r in out["toy"])
    assert "OK" in capsys.readouterr().out
