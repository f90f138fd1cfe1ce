"""What the spawned ranks run (``launch.spawn``): each task is
``fn(rank, world_size, device, **kwargs)`` and returns numpy and plain
values. The CPU tests, ``chip_smoke.py`` and ``graft_entry.py`` spawn them;
this module imports neither the tests nor JAX, so that the ranks stay light.

- :func:`graph_probe`: the edge-partitioned GATv2 and TarMAC attention on
  given inputs, outputs and the gradients of ``sum(out * cotangent)``;
- :func:`learner_update`: one update of a ``MultiAgentQLearner`` distributed
  over a ``(dp, mp, gp)`` mesh, from given weights or a checkpoint, on a
  given global batch;
- :func:`fused_train`: the dp-sharded fused trainer's iterations;
- :func:`stats_probe` and :func:`logger_probe`: the cross-rank statistics
  and the rank-0 logger.

Every rank also returns the launches of kernels #1-#5 in its work (0 on the
CPU, where the wrappers run their plain versions) and the host time of its
collectives (``parallel.dist.COLLECTIVES``).
"""

import contextlib
import time
from types import SimpleNamespace as SN

import torch

from uav_bs_ctrl_tpu_torch.algos.buffer import tree_map
from uav_bs_ctrl_tpu_torch.algos.madrqn.fused import FusedMadrqnTrainer
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import DEFAULT_CONFIG, check_args_sanity
from uav_bs_ctrl_tpu_torch.models.encoders import GATv2
from uav_bs_ctrl_tpu_torch.ops import gat_kernels, step_kernels
from uav_bs_ctrl_tpu_torch.parallel import dist as pdist
from uav_bs_ctrl_tpu_torch.parallel import graph_parallel as gpl
from uav_bs_ctrl_tpu_torch.parallel.mesh import (distribute_learner, make_mesh, shard_batch,
                                                 shard_params_spec)
from uav_bs_ctrl_tpu_torch.utils.convert import params_from_jax
from uav_bs_ctrl_tpu_torch.utils.logx import EpochLogger, proc_id

KERNELS = {"flash_gat": gat_kernels.flash_gat, "flash_gat_fused": gat_kernels.flash_gat_fused,
           "flash_gat_fused_bwd": gat_kernels.flash_gat_fused_bwd,
           "tarmac_step": step_kernels.tarmac_step,
           "tarmac_step_bwd": step_kernels.tarmac_step_bwd}


def reset_counts():
    for fn in KERNELS.values():
        fn.launches = fn.launches_bf16 = 0


def counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_update(learner, batch, use_kernels=True, noise=None):
    """Host ms of one more update on ``batch`` (the card synchronised before
    and after), and its collectives ``{"ms", "calls"}``."""
    device = learner.device
    _sync(device)
    pdist.reset_collectives()
    t0 = time.perf_counter()
    with torch.enable_grad():
        learner.update_on_batch(batch, use_kernels, noise)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    return ms, dict(ms=pdist.COLLECTIVES["seconds"] * 1e3, calls=pdist.COLLECTIVES["calls"])


def _numpy(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


@contextlib.contextmanager
def _inverted(rule):
    """Rule (b) or (c) of ``graph_parallel`` inverted for the span (a planted
    fault the tests must see): (b)'s backward without its all-reduce, or
    (c)'s backward all-reducing the replicated cotangent."""
    saved = gpl.Replicate.backward, gpl.Combine.backward
    if rule == "b":
        gpl.Replicate.backward = staticmethod(lambda ctx, g: (g, None))
    elif rule == "c":
        gpl.Combine.backward = staticmethod(lambda ctx, g: (
            pdist.all_reduce(g.contiguous(), gpl.get_graph_parallel_group()), None))
    try:
        yield
    finally:
        gpl.Replicate.backward, gpl.Combine.backward = saved


def graph_probe(rank, world, device, gp, cases, plant=None):
    """Each case through the edge-partitioned function on the ``gp`` axis of
    a ``(world/gp, 1, gp)`` mesh: ``{"out", "grads": {input or param:
    gradient of sum(out * cot)}}``. A GATv2 case holds ``params`` (JAX's
    ``gatv2_init`` tree), ``x_src``, ``x_dst``, ``mask``, ``n_heads``,
    ``cot``; a TarMAC case ``s``, ``q``, ``v``, ``adj``, ``key_size``,
    ``cot``. ``plant`` inverts rule ``"b"`` or ``"c"``."""
    gpl.set_graph_parallel_mesh(make_mesh(world, gp=gp), "gp")
    group = gpl.get_graph_parallel_group()
    results = []
    try:
        with _inverted(plant):
            for case in cases:
                t = {k: torch.tensor(case[k], device=device, requires_grad=case[k].dtype != bool)
                     for k in ("x_src", "x_dst", "mask", "s", "q", "v", "adj") if k in case}
                if "params" in case:
                    d_src, d_dst = t["x_src"].shape[-1], t["x_dst"].shape[-1]
                    hf = case["params"]["attn"].size
                    gat = GATv2(d_src, d_dst, case["n_heads"], hf // case["n_heads"]).to(device)
                    gat.load_state_dict(params_from_jax(case["params"], gat))
                    x_src, mask = gpl.pad_slot_axis(t["x_src"], t["mask"],
                                                    torch.distributed.get_world_size(group))
                    out = gpl.gatv2_graph_parallel(gat, x_src, t["x_dst"], mask,
                                                   case["n_heads"], group)
                    wrt = dict(x_src=t["x_src"], x_dst=t["x_dst"], **dict(gat.named_parameters()))
                else:
                    out = gpl.tarmac_attention_graph_parallel(t["s"], t["q"], t["v"], t["adj"],
                                                              case["key_size"], group)
                    wrt = dict(s=t["s"], q=t["q"], v=t["v"])
                grads = torch.autograd.grad((out * torch.tensor(case["cot"], device=device)).sum(),
                                            list(wrt.values()))
                results.append(dict(out=out.detach().cpu().numpy(),
                                    grads=_numpy(dict(zip(wrt, grads)))))
    finally:
        gpl.set_graph_parallel_mesh(None)
    return results


def _named(learner, tensors):
    names = [f"{g}.{k}" for g, ps in learner._by_group(lambda p: p).items() for k in ps]
    return dict(zip(names, tensors))


def learner_update(rank, world, device, cfg, env_info, batch, dims, tree=None, ckpt=None,
                   graph_parallel=False, noise=None, save=None):
    """One update of a ``MultiAgentQLearner`` (``DEFAULT_CONFIG`` overlaid
    with ``cfg``; weights from the JAX tree ``tree`` or the checkpoint
    ``ckpt``, else seed 0's) distributed over a ``dims`` = (dp, mp, gp)
    mesh, on this rank's rows of the global ``batch`` (numpy leaves). With
    ``noise`` (the global batch's per-step noise) the update takes its rows;
    ``drawn`` is what ``draw_noise`` gives this rank first. ``save`` writes
    the checkpoint after the update. Returns the dp-mean raw gradients, the
    params and targets after, as full tensors keyed by name, then times one
    more update (``ms``, ``collectives``)."""
    args = check_args_sanity(SN(**{**DEFAULT_CONFIG, **cfg, "device": str(device)}))
    learner = MultiAgentQLearner(env_info, args, seed=0)
    if tree is not None:
        learner.load_params(tree)
    if ckpt is not None:
        learner.load_checkpoint(ckpt)
    dp, mp, gp = dims
    mesh = make_mesh(world, mp=mp, gp=gp)
    spec = shard_params_spec(_named(learner, learner.parameters()), mesh)
    distribute_learner(learner, mesh, graph_parallel=graph_parallel)
    try:
        local = shard_batch(tree_map(lambda x: torch.as_tensor(x, device=device), batch), mesh)
        drawn = learner.draw_noise(local)
        if noise is not None:
            lo, hi, _ = learner.sharding.rows(local["h"].shape[0])
            noise = {k: torch.as_tensor(v, device=device)[:, lo:hi] for k, v in noise.items()}
        reset_counts()
        _sync(device)
        t0 = time.perf_counter()
        with torch.enable_grad():
            metrics = learner.backward(local, noise=noise)
            grads = [p.grad.detach().clone() for p in learner.parameters()]
            learner.apply_grads()
        _sync(device)
        out = dict(ms_first=(time.perf_counter() - t0) * 1e3, launches=counts(),
                   loss=float(metrics["LossQ"]), qvals=float(metrics["QVals"]), spec=spec,
                   backend=torch.distributed.get_backend(),
                   grads=_numpy(_named(learner, grads)),
                   params=_numpy(_named(learner, learner.parameters())),
                   targets=_numpy(_named(learner, learner.target_parameters())),
                   drawn=None if drawn is None else _numpy(drawn))
        if save is not None:
            learner.save_checkpoint(save, dict(epoch=1, t=0))
        out["ms"], out["collectives"] = timed_update(learner, local, noise=noise)
    finally:
        gpl.set_graph_parallel_mesh(None)
    return out


def fused_train(rank, world, device, map_id, train_kwargs, trainer_kw, schedule, ckpt=None):
    """The fused trainer sharded over a dp mesh of every rank, resumed from
    the checkpoint ``ckpt`` if given: ``schedule`` is a list of ``(eps,
    warmup)`` iterations. Returns each iteration's metrics, the params after,
    the ring's size and pointer, the launches, the wall seconds and the
    collectives."""
    mesh = make_mesh(world)
    trainer = FusedMadrqnTrainer(map_id, dict(train_kwargs, device=str(device)), mesh=mesh,
                                 **trainer_kw)
    if ckpt is not None:
        trainer.learner.load_checkpoint(ckpt)
    reset_counts()
    pdist.reset_collectives()
    _sync(device)
    t0 = time.perf_counter()
    with torch.enable_grad():
        metrics = [trainer.run_iteration(eps, warmup=warmup) for eps, warmup in schedule]
    _sync(device)
    learner = trainer.learner
    return dict(metrics=metrics, seconds=time.perf_counter() - t0, launches=counts(),
                params=_numpy(_named(learner, learner.parameters())),
                ring=(trainer._size, trainer._ptr), local_rows=tree_map(
                    lambda x: x.shape[0], trainer.replay)["act"],
                collectives=dict(ms=pdist.COLLECTIVES["seconds"] * 1e3,
                                 calls=pdist.COLLECTIVES["calls"]))


def stats_probe(rank, world, device, samples, with_min_and_max=True):
    """``dist_statistics_scalar`` of this rank's ``samples[rank]``."""
    return [float(v) for v in pdist.dist_statistics_scalar(samples[rank], with_min_and_max)]


def logger_probe(rank, world, device, out_dir, samples):
    """An ``EpochLogger`` per rank (``out_dir/rank<r>``) that stores this
    rank's ``samples[rank]`` as ``X`` and logs one row of ``Epoch`` and ``X``'s
    statistics; returns the rank's ``proc_id`` and the logger's output dir."""
    logger = EpochLogger(output_dir=f"{out_dir}/rank{rank}", exp_name="ranks")
    logger.save_config(dict(world=world))
    for v in samples[rank]:
        logger.store(X=v)
    logger.log_tabular("Epoch", 1)
    logger.log_tabular("X", with_min_and_max=True)
    logger.dump_tabular()
    if logger.output_file is not None:
        logger.output_file.close()
    return dict(proc_id=proc_id(), output_dir=logger.output_dir)
