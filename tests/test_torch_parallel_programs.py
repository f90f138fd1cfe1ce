"""The sharded learner's update and the dp fused trainer as programs
(``algos/core.py:update_on_batch`` with ``sharding.captures``,
``FusedMadrqnTrainer(mesh=..., graphs=True)``) against their eager twins and
the JAX package, on 2 gloo ranks.

A capture holds no collective, so the program path cuts each update where
its collectives are: a gradient program (the backward, packed flat), the dp
all-reduce on the host, a step program (the division by dp, the clip, AdamW,
Polyak on the rank's shards), then the mp all-gather; the fused trainer's
collection is a program over the rank's block of worlds, and a
sub-iteration's batches are fetched by one fill program and one all-reduce.
On the CPU a program calls its body directly, so these tests hold the split
into pieces (the capture itself is held on the card by ``chip_smoke.py``'s
``parallel_phases``).

One process group of 2 ranks is spawned once for the module. It runs, bit
for bit against the eager path on each rank: a dp = 2 update of the
learner of ``tests/test_torch_parallel_learner.py`` (also against JAX's
single-device update at that file's tolerances), a dp = 2 update with the
program path's sum over the ranks stubbed to the identity (a planted fault
that must fail; ``tests/sharded_program_faults.py``), an mp = 2 learner
whose only split is its storage (the ``RnnAgent`` of ``o='mlp'`` with no
comm plans no compute split, so it ``captures``), and the dp = 2 fused
trainer, TarMAC and DiscreteComm, with its test episodes after, at
``tests/test_torch_parallel_fused.py``'s sizes (also against the
single-rank trainer at that file's tolerances). A learner with the mp
compute split and one with gp routing report ``captures`` false and make no
update program.
"""

import threading

import numpy as np
import pytest
import torch

import sharded_program_faults
from test_torch_graphs import check_capturable
from test_torch_parallel_fused import KW as FUSED_KW
from test_torch_parallel_fused import SCHEDULE, SIZES, TRAINERS
from test_torch_parallel_learner import ENV_INFO, KW, TOL, _check, _global_batch, _jax_run
from uav_bs_ctrl_tpu_torch.algos import buffer
from uav_bs_ctrl_tpu_torch.algos.madrqn import fused
from uav_bs_ctrl_tpu_torch.parallel import launch, workers

DP = (2, 1, 1)
UPDATE_KEYS = ("after_grads", "params", "targets", "adam")
FUSED_KEYS = ("params", "replay", "losses", "generators", "evaluate")
N_EVAL = 2          # test episodes after the schedule (``EpisodeProgram`` against eager)


def _mlp_case():
    """The ``o='mlp'`` learners' env info and a global batch of 8 chunks
    sampled from a single-rank fused trainer's ring after a warm-up."""
    trainer = fused.FusedMadrqnTrainer("debug", dict(FUSED_KW, device="cpu"), **SIZES)
    trainer.run_iteration(1.0, warmup=True)
    p = trainer.env_params
    env_info = dict(obs_shape=fused.obs_shape(p, "mlp"), state_shape=fused.state_shape(p),
                    n_actions=p.n_actions, n_agents=p.n_ubs, episode_limit=trainer.T)
    batch = buffer.tree_map(lambda x: x.numpy(), trainer.sample_batch())
    return env_info, batch


def _tasks():
    """``{name: (fn, kwargs)}`` of every case, in the order the ranks run them."""
    tree = _jax_run("dp")[0]
    update = dict(cfg=KW, env_info=ENV_INFO, batch=_global_batch(), tree=tree)
    env_info, batch = _mlp_case()
    mlp = dict(cfg=dict(FUSED_KW, c=None, batch_size=8), env_info=env_info, batch=batch,
               dims=(1, 2, 1))
    tasks = {
        "dp_eager": (workers.learner_update, dict(update, dims=DP)),
        "dp_programs": (workers.learner_update, dict(update, dims=DP, graphs=True)),
        "dp_planted": (sharded_program_faults.identity_sum_update,
                       dict(update, dims=DP, graphs=True)),
        "mp_storage_eager": (workers.learner_update, mlp),
        "mp_storage_programs": (workers.learner_update, dict(mlp, graphs=True)),
        "mp_split": (workers.learner_update, dict(update, dims=(1, 2, 1), graphs=True)),
        "gp": (workers.learner_update, dict(
            update, cfg=dict(KW, gat_backend="graph_parallel", comm_backend="graph_parallel"),
            dims=(1, 1, 2), graph_parallel=True, graphs=True)),
    }
    for name, kw in TRAINERS.items():
        for graphs in (False, True):
            tasks[f"fused_{name}_{'programs' if graphs else 'eager'}"] = (workers.fused_train, dict(
                map_id="debug", train_kwargs=kw, trainer_kw=SIZES, schedule=SCHEDULE,
                graphs=graphs, evaluate=N_EVAL))
    return tasks


@pytest.fixture(scope="module")
def ranks():
    """``{case: [each rank's result]}``; JAX's update compiles here while
    the ranks run."""
    tasks = _tasks()
    out = {}

    def run():
        try:
            out["results"] = launch.spawn(2, list(tasks.values()), "cpu")
        except BaseException as err:      # raised below, in the test's thread
            out["error"] = err

    thread = threading.Thread(target=run)
    thread.start()
    _jax_run("dp")
    thread.join()
    if "error" in out:
        raise out["error"]
    return dict(zip(tasks, out["results"]))


def _leaves(tree, prefix=""):
    """``{path: leaf}`` of nested dicts and lists of arrays and numbers."""
    if isinstance(tree, dict):
        items = [(f"{prefix}{key}.", sub) for key, sub in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(f"{prefix}{i}.", sub) for i, sub in enumerate(tree)]
    else:
        return {prefix: tree}
    return {k: v for path, sub in items for k, v in _leaves(sub, path).items()}


def _same_bits(got, want, keys):
    """Every leaf under ``keys`` equal bit for bit (NaN nowhere)."""
    for key in keys:
        a, b = _leaves(got[key]), _leaves(want[key])
        assert a.keys() == b.keys(), key
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"{key} {name}")


def test_dp_update_programs_equal_eager(ranks):
    """dp = 2: the gradient program, the host's all-reduce and the step
    program give the eager update's metrics, clipped ``.grad``, params,
    targets and AdamW state on each rank, bit for bit."""
    for got, want in zip(ranks["dp_programs"], ranks["dp_eager"]):
        assert got["captures"] and got["captures_reason"] is None
        assert got["programs"] == ["('grads', True)", "step"]
        assert (got["loss"], got["qvals"]) == (want["loss"], want["qvals"])
        _same_bits(got, want, UPDATE_KEYS)


def test_dp_update_programs_match_jax(ranks):
    """The program path's dp = 2 update against JAX's single-device update
    on the same batch: LossQ rtol 1e-5, the clipped gradients, params and
    targets atol 1e-5 (``tests/test_torch_parallel_learner.py``)."""
    want = _jax_run("dp")[2]
    for got in ranks["dp_programs"]:
        _check(got, want, TOL, grads=False)
        for k, v in want["grads"].items():
            np.testing.assert_allclose(got["after_grads"][k], v, err_msg=f"clipped {k}", **TOL)


def test_planted_identity_sum_fails(ranks):
    """The program path with the sum over the ranks between its two
    programs stubbed to the identity trains each rank on its own rows: it
    must fail the comparison with the eager path on every rank."""
    for got, want in zip(ranks["dp_planted"], ranks["dp_eager"]):
        with pytest.raises(AssertionError):
            _same_bits(got, want, UPDATE_KEYS)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_mp_storage_update_programs_equal_eager(ranks):
    """mp = 2 with no compute split (``RnnAgent`` plans none): the
    last-axis shards of the params, targets and AdamW moments step in the
    step program and are gathered after it; the eager bits on each rank."""
    for got, want in zip(ranks["mp_storage_programs"], ranks["mp_storage_eager"]):
        assert got["captures"] and got["programs"] == ["('grads', True)", "step"]
        assert any(v == (None, "mp") for v in got["spec"].values())
        assert (got["loss"], got["qvals"]) == (want["loss"], want["qvals"])
        _same_bits(got, want, UPDATE_KEYS)


@pytest.mark.parametrize("name,what", [("mp_split", "the mp compute split"),
                                       ("gp", "the gp routing")])
def test_collectives_inside_autograd_stay_eager(ranks, name, what):
    """A learner whose forward and backward hold collectives (the mp compute
    split, the gp routing) reports ``captures`` false with the reason and
    makes no update program, though it was made with programs."""
    for got in ranks[name]:
        assert not got["captures"]
        assert got["captures_reason"].startswith(what)
        assert got["programs"] == []
        assert np.isfinite(got["loss"])


@pytest.mark.parametrize("name", list(TRAINERS))
def test_dp_fused_programs_equal_eager(ranks, name):
    """The dp = 2 fused trainer on programs (the collection over the rank's
    block, the ring fetched by one fill and one all-reduce, the split
    updates, then the test episodes as ``EpisodeProgram``) gives the eager
    trainer's metrics, ring shard, losses, params, both generators' states
    and test stats on each rank, bit for bit."""
    for got, want in zip(ranks[f"fused_{name}_programs"], ranks[f"fused_{name}_eager"]):
        assert got["metrics"] == want["metrics"]
        assert got["ring"] == want["ring"] == (16, 8)
        assert got["evaluate"]["TestEpRet"].shape == (N_EVAL,)
        _same_bits(got, want, FUSED_KEYS)


def _single(kw):
    """The single-rank port trainer (programs) on the same schedule: its
    metrics, params by name and generator state."""
    trainer = fused.FusedMadrqnTrainer("debug", dict(kw, device="cpu"), **SIZES)
    with torch.enable_grad():
        metrics = [trainer.run_iteration(eps, warmup=warmup) for eps, warmup in SCHEDULE]
    learner = trainer.learner
    names = [f"{g}.{k}" for g, ps in learner._by_group(lambda p: p).items() for k in ps]
    params = {n: p.detach().numpy() for n, p in zip(names, learner.parameters())}
    return metrics, params, trainer.generator.get_state().numpy()


@pytest.mark.parametrize("name", list(TRAINERS))
def test_dp_fused_programs_match_single_rank(ranks, name):
    """The program path's dp = 2 trainer against the single-rank trainer:
    LossQ and EpRet rtol 1e-5, params atol 2e-5 rtol 1e-3
    (``tests/test_torch_parallel_fused.py``), and the host generator where
    the single-rank one ends."""
    metrics, params, generator = _single(TRAINERS[name])
    for rank in ranks[f"fused_{name}_programs"]:
        np.testing.assert_array_equal(rank["generators"][0], generator)
        for got, want in zip(rank["metrics"], metrics):
            assert got.keys() == want.keys()
            for k in ("LossQ", "EpRet") if "LossQ" in want else want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        for k, v in params.items():
            np.testing.assert_allclose(rank["params"][k], v, atol=2e-5, rtol=1e-3, err_msg=k)


def test_ring_fill_is_capturable_and_fetches_the_eager_rows():
    """``RingShard.fill`` (the sharded fetch's device half, eager and in a
    program alike) on a 2-rank ring's books: every rank's fill summed is
    the batch the ring holds at those slots (each entry one rank's), with no
    host sync or data-dependent shape (``check_capturable``)."""
    rng = np.random.default_rng(0)
    shards, replays = [], []
    for rank in range(2):
        shard = buffer.RingShard(8, 2, rank, None)
        for ptr in (0, 4):
            shard.record(ptr, 4)
        shards.append(shard)
        replays.append(dict(x=torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
                            act=torch.from_numpy(rng.integers(9, size=(4, 2)).astype(np.int32))))
    idx = torch.tensor([7, 0, 3, 3, 5, 2])
    fills = [check_capturable(s.fill, r, idx) for s, r in zip(shards, replays)]
    for key in ("x", "act"):
        whole = torch.stack([replays[int(o)][key][int(l)] for o, l in
                             zip(shards[0].owner[idx], shards[0].local[idx])])
        summed = fills[0][key] + fills[1][key]
        assert summed.dtype == whole.dtype
        torch.testing.assert_close(summed, whole, rtol=0, atol=0)
        for fill, shard in zip(fills, shards):
            assert not fill[key][shard.owner[idx] != shard.rank].any()
