"""The mp compute split (``parallel/mp_split.py``, ``parallel/mesh.py:compute_plan``)
against the JAX package's single-device update.

Two process groups of gloo ranks are spawned once for the module, side by
side: 2 ranks run dims (dp, mp, gp) = (1, 2, 1) at the debug width (hidden
16, 2 heads, dueling) and the two planted faults; 4 ranks run (2, 2, 1)
(without dueling) and (1, 4, 1) at a 4-head width (hidden 32). Each update
runs through the kernels' wrappers (their plain versions on the CPU), so
every rank runs GATv2 on its heads, the encoder's ``aggr`` on its rows and
the TarMAC step's GRU on its hidden columns. The gate, every rank against
JAX's single-device update on the same weights and global batch: LossQ rtol
1e-5, Q values, raw gradients, params and targets atol and rtol 1e-5
(``tests/test_parallel.py:56-99``). An entry whose JAX raw gradient is not
resolved (at most ``RESOLVED_RTOL`` of its group's largest, 0 included) takes
an AdamW step of up to about lr from roundoff alone, in either package: its
param and target are held at the same tolerance to the port's own
single-rank update instead (the 4-head width has such entries, where JAX's
gradient is 0 and the port's 8e-10). Each rank's recorded call shapes show
the split (#2/#3 at ``n_heads = H/mp``, the split #4/#5 on ``H/mp``
columns), and each planted fault (a replicated gradient summed over mp, mp
rank 0's GRU columns one column off) must fail the gate. Without processes,
the plain split step and its backward summed over simulated ranks must equal
``tarmac_step_plain`` and ``tarmac_step_bwd_plain`` to 1e-6. The faults are
planted by ``tests/mp_split_faults.py``.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mp_split_faults
from test_torch_step_bwd_emulated import _case as step_case
from test_torch_update import (A_DBG, DS_DBG, HEADS, K_DBG, M_DBG, _batch,
                               _jax_first_update, _kw, _learners, _np)
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import make_args
from uav_bs_ctrl_tpu_torch.ops import step_kernels
from uav_bs_ctrl_tpu_torch.parallel import launch, workers

T, B = 5, 8
TOL = dict(atol=1e-5, rtol=1e-5)
RESOLVED_RTOL = 1e-5      # a raw gradient resolved: above this share of its group's largest
ENV_INFO = dict(obs_shape={"agent": 2, "gt": 4, "ubs": 2}, state_shape=DS_DBG, n_actions=9,
                n_agents=A_DBG, episode_limit=T)
WIDE = dict(hidden_size=32, n_heads=4)
CONFIGS = {"dueling": dict(_kw(True, True), batch_size=B),
           "plain_head": dict(_kw(True, False), batch_size=B),
           "wide": dict(_kw(True, True), batch_size=B, **WIDE)}
RUNS = {   # name: (config, (dp, mp, gp), plant)
    "mp2": ("dueling", (1, 2, 1), None),
    "twice": ("dueling", (1, 2, 1), "replicated_twice"),
    "offset": ("dueling", (1, 2, 1), "column_offset"),
    "dp2_mp2": ("plain_head", (2, 2, 1), None),
    "mp4": ("wide", (1, 4, 1), None),
}


def _global_batch(hidden):
    return _batch(np.random.default_rng(8), B, T, A_DBG, M_DBG, K_DBG, DS_DBG, hidden, 1)


@functools.lru_cache(maxsize=None)
def _jax(config):
    """``(weights, JAX's single-device first update, the port's single-rank
    params and targets after the same update)`` of ``config``."""
    kw = CONFIGS[config]
    jl, _ = _learners(kw, ENV_INFO)
    tree = _np(jl.params)
    batch = _global_batch(kw["hidden_size"])
    want = _jax_first_update(jl, jax.tree_util.tree_map(jnp.asarray, batch))
    single = MultiAgentQLearner(ENV_INFO, make_args(kw, device="cpu"), seed=0)
    single.load_params(tree)
    with torch.enable_grad():
        single.update_on_batch(jax.tree_util.tree_map(torch.from_numpy, batch))
    port = {what: workers._numpy(workers._named(single, tensors)) for what, tensors in (
        ("params", single.parameters()), ("targets", single.target_parameters()))}
    return tree, want, port


@pytest.fixture(scope="module")
def ranks():
    """``{run: [each rank's learner_update result]}``; JAX's updates compile
    here while the ranks run."""
    groups = {}
    for name, (config, dims, plant) in RUNS.items():
        kw = CONFIGS[config]
        task = dict(cfg=kw, env_info=ENV_INFO, batch=_global_batch(kw["hidden_size"]),
                    dims=dims, tree=_jax(config)[0])
        groups.setdefault(dims[0] * dims[1] * dims[2], []).append((name, (
            (workers.learner_update, task) if plant is None
            else (mp_split_faults.planted_update, dict(task, fault=plant)))))
    out, errors = {}, []

    def run(n, tasks):
        try:
            results = launch.spawn(n, [task for _, task in tasks], "cpu")
            out.update({name: r for (name, _), r in zip(tasks, results)})
        except BaseException as err:      # raised below, in the test's thread
            errors.append(err)

    threads = [threading.Thread(target=run, args=item) for item in groups.items()]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]
    return out


def _errors(got, config):
    """Each gated quantity's largest excess over its tolerance (<= 0: within)."""
    _, want, port = _jax(config)
    excess = lambda a, b: np.abs(a - b) - (TOL["atol"] + TOL["rtol"] * np.abs(b))
    out = {"loss": abs(got["loss"] - want["loss"]) - 1e-5 * abs(want["loss"]),
           "qvals": excess(np.float64(got["qvals"]), np.float64(want["qvals"]))}
    raw = want["raw"]
    assert got["grads"].keys() == raw.keys()
    out["grads"] = max(excess(got["grads"][k], v).max() for k, v in raw.items())
    largest = {g: max(np.abs(v).max() for k, v in raw.items() if k.startswith(g + "."))
               for g in ("net", "mixer")}
    for what in ("params", "targets"):
        assert got[what].keys() == want[what].keys() == port[what].keys()
        worst = -np.inf
        for k, v in want[what].items():
            resolved = np.abs(raw[k]) > RESOLVED_RTOL * largest[k.split(".")[0]]
            worst = max(worst, np.where(resolved, excess(got[what][k], v),
                                        excess(got[what][k], port[what][k])).max())
        out[what] = worst
    return out


@pytest.mark.parametrize("name", ("mp2", "dp2_mp2", "mp4"))
def test_mp_split_update_matches_jax_single_device(ranks, name):
    """Every rank's LossQ, Q values, raw gradients, params and targets are
    JAX's single-device update's."""
    for r, rank in enumerate(ranks[name]):
        errs = _errors(rank, RUNS[name][0])
        assert max(errs.values()) <= 0, f"rank {r}: excess over the tolerance {errs}"


@pytest.mark.parametrize("name", ("mp2", "dp2_mp2", "mp4"))
def test_each_rank_ran_its_share(ranks, name):
    """The recorded shapes: #2/#3 at H/mp heads (of F columns), the split
    #4/#5 on the rank's H/mp columns; the plan names the split modules."""
    config, (_, mp, _), _ = RUNS[name]
    hidden = CONFIGS[config]["hidden_size"]
    heads = CONFIGS[config].get("n_heads", HEADS)
    c = hidden // mp
    for r, rank in enumerate(ranks[name]):
        lo = (r % mp) * c
        assert rank["shapes"] == {
            "flash_gat_fused": [(heads // mp, hidden // mp)],
            "flash_gat_fused_bwd": [(heads // mp, hidden // mp)],
            "tarmac_step_cols": [(lo, lo + c, hidden)],
            "tarmac_step_bwd_cols": [(lo, lo + c, hidden)]}, f"rank {r}"
        assert rank["plan"]["net.enc.seen"] == f"heads [{(r % mp) * heads // mp}, " \
                                               f"{(r % mp + 1) * heads // mp}) of {heads}"
        assert rank["plan"]["net.enc.aggr"] == f"rows [{lo}, {lo + c}) of {hidden}"
        assert rank["plan"]["net.f_comm.f_udt"] == f"columns [{lo}, {lo + c}) of {hidden}"
        assert rank["plan"]["net.f_comm.f_val"] == "replicated"
        mixer = [v for k, v in rank["plan"].items() if k.startswith("mixer.")]
        assert mixer and set(mixer) == {"replicated"}


@pytest.mark.parametrize("name", ("twice", "offset"))
def test_planted_fault_fails_the_gate(ranks, name):
    """A replicated gradient summed over mp (counted twice), or mp rank 0's
    GRU columns one column off, is caught by the gate on every rank."""
    for r, rank in enumerate(ranks[name]):
        errs = _errors(rank, RUNS[name][0])
        assert errs["grads"] > 0, f"rank {r}: the planted {name} fault passed: {errs}"


@pytest.mark.parametrize("mp,dueling", [(2, True), (4, False), (8, True)])
def test_plain_split_summed_over_ranks_is_the_whole_step(mp, dueling):
    """The plain split step (h2's columns gathered, then the head) and its
    backward (``red`` summed over the simulated ranks; the split weights'
    shares summed, the replicated ones from one rank) equal the whole plain
    step and backward to 1e-6 of max(1, max |whole|)."""
    w, a, hidden, msg, key, n_act = 3, 4, 32, 8, 4, 5
    args = step_case(np.random.default_rng(mp), w, a, hidden, msg, key, n_act, True)
    cols = [(r * hidden // mp, (r + 1) * hidden // mp) for r in range(mp)]
    h2f = torch.cat([step_kernels.tarmac_step_cols_plain(*args[:13], a, 4.0, c) for c in cols], 1)
    got = step_kernels.tarmac_step_head_plain(h2f, *args[13:17], dueling)
    want = step_kernels.tarmac_step_plain(*args[:17], a, 4.0, dueling)
    halves = [step_kernels.tarmac_step_bwd_cols_plain(*args, a, 4.0, dueling, c) for c in cols]
    red = sum(r for r, _ in halves)
    ranks = [step_kernels.tarmac_step_bwd_rest_plain(*args[:17], red, saved, a, 4.0, dueling, c)
             for (_, saved), c in zip(halves, cols)]
    split = {8, 9, 10, 11, 12, 14}           # wi, wh, bi, bh, wo, wvh after dx, dh
    whole = step_kernels.tarmac_step_bwd_plain(*args, a, 4.0, dueling)
    for i, ref in enumerate(whole):
        outs = [sum(r[i] for r in ranks)] if i in split else [r[i] for r in ranks]
        got += tuple(outs)
        want += (ref,) * len(outs)
    for i, (g, r) in enumerate(zip(got, want)):
        err = (g - r).abs().max().item() / max(1.0, r.abs().max().item())
        assert err <= 1e-6, f"output {i}: {err:.3e}"
