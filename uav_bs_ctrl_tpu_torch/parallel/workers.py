"""What the spawned ranks run (``launch.spawn``): each task is
``fn(rank, world_size, device, **kwargs)`` and returns numpy and plain
values. The CPU tests, ``chip_smoke.py`` and ``graft_entry.py`` spawn them;
this module imports neither the tests nor JAX, so that the ranks stay light.

- :func:`graph_probe`: the edge-partitioned GATv2 and TarMAC attention on
  given inputs, outputs and the gradients of ``sum(out * cotangent)``;
- :func:`learner_update`: one update of a ``MultiAgentQLearner`` distributed
  over a ``(dp, mp, gp)`` mesh, from given weights or a checkpoint, on a
  given global batch, eagerly or, with ``graphs``, as programs;
- :func:`fused_train`: the dp-sharded fused trainer's iterations, eagerly or
  as programs;
- :func:`stats_probe` and :func:`logger_probe`: the cross-rank statistics
  and the rank-0 logger.

Every rank also returns the launches of kernels #1-#5 and of #4/#5's
column-split entry points in its work (0 on the CPU, where the wrappers run
their plain versions), the shapes #2/#3 and the split #4/#5 ran at
(``shapes``: heads and width, the GRU's columns) and the host time of its
collectives (``parallel.dist.COLLECTIVES``; ``parallel.mp_split``'s own by
kind). A replayed program passes no wrapper, so on the program path the
caller counts the card's launches: ``launches`` is a context manager
factory (``chip_smoke.card_launches``) whose namespace has ``calls`` set
when its block ends.
"""

import contextlib
import time
import warnings
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
from uav_bs_ctrl_tpu_torch.parallel import mp_split
from uav_bs_ctrl_tpu_torch.parallel.mesh import (distribute_learner, make_mesh, shard_batch,
                                                 shard_params_spec)
from uav_bs_ctrl_tpu_torch.utils.convert import params_from_jax
from uav_bs_ctrl_tpu_torch.utils.logx import EpochLogger, proc_id

KERNELS = {"flash_gat": gat_kernels.flash_gat, "flash_gat_fused": gat_kernels.flash_gat_fused,
           "flash_gat_fused_bwd": gat_kernels.flash_gat_fused_bwd,
           "tarmac_step": step_kernels.tarmac_step,
           "tarmac_step_bwd": step_kernels.tarmac_step_bwd,
           "tarmac_step_cols": step_kernels.tarmac_step_cols,
           "tarmac_step_head": step_kernels.tarmac_step_head,
           "tarmac_step_bwd_cols": step_kernels.tarmac_step_bwd_cols,
           "tarmac_step_bwd_rest": step_kernels.tarmac_step_bwd_rest}
SHAPED = ("flash_gat_fused", "flash_gat_fused_bwd", "tarmac_step_cols", "tarmac_step_bwd_cols")


def reset_counts():
    for name, fn in KERNELS.items():
        fn.launches = fn.launches_bf16 = 0
        if name in SHAPED:
            fn.shapes.clear()
    mp_split.reset_collectives()


def counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def shapes():
    """The shapes #2/#3 ran at, ``(n_heads, H*F)``, and the split #4/#5's
    GRU columns, ``(lo, hi, H)``, since :func:`reset_counts`."""
    return {name: sorted(KERNELS[name].shapes) for name in SHAPED}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_update(learner, batch, use_kernels=True, noise=None, n=1):
    """Host ms of one more update on ``batch`` (the card synchronised before
    and after; with ``n`` > 1 the median of ``n`` updates), and the
    collectives of one ``{"ms", "calls"}``."""
    device = learner.device
    times, colls = [], []
    for _ in range(n):
        _sync(device)
        pdist.reset_collectives()
        mp_split.reset_collectives()
        t0 = time.perf_counter()
        with torch.enable_grad():
            learner.update_on_batch(batch, use_kernels, noise)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        colls.append(dict(ms=pdist.COLLECTIVES["seconds"] * 1e3,
                          calls=pdist.COLLECTIVES["calls"], split=dict(mp_split.COLLECTIVES)))
    mid = sorted(range(n), key=times.__getitem__)[n // 2]
    return times[mid], colls[mid]


def device_ms(learner, batch, use_kernels=True, noise=None):
    """The card's busy ms in one more update on ``batch`` (``torch.profiler``'s
    device-side events; None off the card or when it records none)."""
    if torch.device(learner.device).type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync(learner.device)
    with warnings.catch_warnings(), torch.enable_grad(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        warnings.filterwarnings("ignore", ".*Profiler clears events")
        learner.update_on_batch(batch, use_kernels, noise)
        _sync(learner.device)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return busy or None


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


def _adam_state(learner):
    """AdamW's state of each master (the rank's shards), keyed by the
    module param's name."""
    masters = (learner.parameters() if learner.sharding is None
               else learner.sharding.masters)
    state = learner.optimizer.state
    return {name: {k: v.detach().cpu().numpy().copy() for k, v in state[m].items()}
            for name, m in _named(learner, masters).items() if m in state}


def learner_update(rank, world, device, cfg, env_info, batch, dims, tree=None, ckpt=None,
                   graph_parallel=False, noise=None, save=None, profile=False, graphs=False,
                   n_timed=1, launches=None):
    """One update of a ``MultiAgentQLearner`` (``DEFAULT_CONFIG`` overlaid
    with ``cfg``; weights from the JAX tree ``tree`` or the checkpoint
    ``ckpt``, else seed 0's) distributed over a ``dims`` = (dp, mp, gp)
    mesh, on this rank's rows of the global ``batch`` (numpy leaves). With
    ``noise`` (the global batch's per-step noise) the update takes its rows;
    ``drawn`` is what ``draw_noise`` gives this rank first. ``save`` writes
    the checkpoint after the update. Returns the params and targets after,
    as full tensors keyed by name, ``.grad`` after (``after_grads``), the
    rank's AdamW state (``adam``), the launches, shapes and mp plan of the
    update and whether it ``captures`` (with the reason not), then times
    ``n_timed`` more updates (``ms``, their median; ``collectives``) and,
    with ``profile``, takes the card's busy ms of another (``device_ms``).

    ``graphs=False`` (the eager path) runs ``backward`` and ``apply_grads``
    and also returns the dp-mean raw gradients (``grads``); ``graphs=True``
    runs ``update_on_batch`` on a learner made with programs, which are its
    gradient and step programs where the sharding ``captures``, and counts
    the timed updates' launches on the card by ``launches`` (``timed_calls``:
    the calls of one)."""
    args = check_args_sanity(SN(**{**DEFAULT_CONFIG, **cfg, "device": str(device)}))
    learner = MultiAgentQLearner(env_info, args, seed=0, graphs=graphs)
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
        grads = None
        with torch.enable_grad():
            if graphs:
                metrics = learner.update_on_batch(local, noise=noise)
            else:
                metrics = learner.backward(local, noise=noise)
                grads = [p.grad.detach().clone() for p in learner.parameters()]
                learner.apply_grads()
        _sync(device)
        sharding = learner.sharding
        out = dict(ms_first=(time.perf_counter() - t0) * 1e3, launches=counts(),
                   shapes=shapes(), plan=sharding.plan, plan_line=sharding.plan_line,
                   captures=sharding.captures, captures_reason=sharding.captures_reason,
                   programs=sorted(str(k) for k in learner._programs),
                   loss=float(metrics["LossQ"]), qvals=float(metrics["QVals"]), spec=spec,
                   backend=torch.distributed.get_backend(),
                   grads=None if grads is None else _numpy(_named(learner, grads)),
                   after_grads=_numpy(_named(learner, [p.grad for p in learner.parameters()])),
                   params=_numpy(_named(learner, learner.parameters())),
                   targets=_numpy(_named(learner, learner.target_parameters())),
                   adam=_adam_state(learner),
                   drawn=None if drawn is None else _numpy(drawn))
        if save is not None:
            learner.save_checkpoint(save, dict(epoch=1, t=0))
        out["ms"], out["collectives"] = timed_update(learner, local, noise=noise, n=n_timed)
        if launches is not None:
            with launches() as seen:
                timed_update(learner, local, noise=noise)
            out["timed_calls"] = seen.calls
        out["program_stats"] = {str(k): v.stats() for k, v in learner._programs.items()}
        if profile:
            t0 = time.perf_counter()
            out["device_ms"] = device_ms(learner, local, noise=noise)
            out["profile_s"] = time.perf_counter() - t0
    finally:
        gpl.set_graph_parallel_mesh(None)
    return out


def fused_train(rank, world, device, map_id, train_kwargs, trainer_kw, schedule, ckpt=None,
                graphs=False, launches=None, timed=(), evaluate=0):
    """The fused trainer sharded over a dp mesh of every rank, resumed from
    the checkpoint ``ckpt`` if given: ``schedule`` is a list of ``(eps,
    warmup)`` iterations, eager or, with ``graphs``, as programs. Returns
    each iteration's metrics and wall seconds (``iter_seconds``), the params
    after, the rank's ring and its size and pointer, the last iteration's
    losses, both generators' states, the launches (by ``launches``, the
    card's calls, when given), the wall seconds and the collectives; then,
    after the results are taken, the test stats of ``evaluate`` episodes
    (``evaluate``, when non-zero) and the wall seconds of the iterations
    ``timed`` (``timed_seconds``)."""
    mesh = make_mesh(world)
    trainer = FusedMadrqnTrainer(map_id, dict(train_kwargs, device=str(device)), mesh=mesh,
                                 graphs=graphs, **trainer_kw)
    if ckpt is not None:
        trainer.learner.load_checkpoint(ckpt)
    reset_counts()
    pdist.reset_collectives()

    def run(entries):
        metrics, seconds = [], []
        for eps, warmup in entries:
            _sync(device)
            t0 = time.perf_counter()
            metrics.append(trainer.run_iteration(eps, warmup=warmup))
            _sync(device)
            seconds.append(time.perf_counter() - t0)
        return metrics, seconds

    with torch.enable_grad(), (launches() if launches else contextlib.nullcontext()) as seen:
        metrics, iter_seconds = run(schedule)
    learner = trainer.learner
    out = dict(metrics=metrics, iter_seconds=iter_seconds, seconds=sum(iter_seconds),
               launches=counts() if seen is None else seen.calls,
               env_calls=None if seen is None else seen.env,
               params=_numpy(_named(learner, learner.parameters())),
               ring=(trainer._size, trainer._ptr), local_rows=tree_map(
                   lambda x: x.shape[0], trainer.replay)["act"],
               replay=tree_map(lambda x: x.cpu().numpy(), trainer.replay),
               losses=trainer.last_losses.cpu().numpy(),
               generators=[trainer.generator.get_state().numpy(),
                           learner.noise_generator.get_state().cpu().numpy()],
               collectives=dict(ms=pdist.COLLECTIVES["seconds"] * 1e3,
                                calls=pdist.COLLECTIVES["calls"]))
    if evaluate:
        out["evaluate"] = trainer.evaluate(evaluate)
    with torch.enable_grad():
        out["timed_seconds"] = run(timed)[1]
    out["program_stats"] = {name: program.stats() for name, program in (
        [(str(k), v) for k, v in learner._programs.items()] +
        [("collection", getattr(trainer, "_collection", None)),
         ("ring fetch", trainer._fill)]) if program is not None}
    return out


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
