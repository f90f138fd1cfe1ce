"""Device meshes and the sharded learner (counterpart of ``parallel/mesh.py``).

- Mesh axes ``('dp', 'mp')``, or ``('dp', 'mp', 'gp')`` when ``gp > 1``, over
  the ranks of the default process group, row-major as JAX lays its devices.
- ``dp``: each rank trains on its rows of the global batch; the dp group sums
  the raw gradients and each rank divides by dp (``ReduceOp.AVG`` is
  NCCL-only). The loss is a plain mean over equal shards, so the mean of the
  ranks' gradients is the global gradient. The value clip then runs on the
  reduced gradient: clipping does not commute with the mean.
- ``mp``, storage: params, targets and AdamW moments whose last axis
  divides ``mp`` (JAX's shape rule) are kept as last-axis shards; each rank
  clips, steps AdamW and Polyak-averages only its own shard (all
  elementwise, so the single-device math), and the mp group all-gathers the
  shards into the modules before the next forward.
- ``mp``, compute (:func:`compute_plan`, ``sharding.plan``): where XLA
  partitions JAX's products over ``mp``, the port splits the work of the
  modules whose kernels it can split (``parallel/mp_split.py``). The agent
  says which (``GnnAgent.mp_plan``, beside the routing that runs them):
  each relation's GATv2 by heads when ``mp`` divides ``n_heads`` (#2/#3 on
  the rank's heads), the encoder's ``aggr`` by rows with it, and the
  one-round TarMAC step's GRU by hidden columns when ``mp`` divides
  ``hidden`` (the column-split #4/#5). A module whose widths do not divide
  ``mp``, a gp-routed or ``'pallas'`` GATv2, the other protocols, the mixer
  and the loss compute whole on every rank. ``reduce`` sums the split
  gradients over mp, each replicated one from mp rank 0 alone, fused with
  the dp sum.
- ``gp``: ``distribute_learner(..., graph_parallel=True)`` registers the
  ``gp`` group, so that ``gat_backend``/``comm_backend='graph_parallel'`` run
  the edge-partitioned functions of :mod:`.graph_parallel`; they give every
  gp rank the dense gradient, so nothing is reduced over ``gp``.

The update as programs (``graphs.Program``, CUDA graphs on the card): a
capture may hold no collective (NCCL refuses two ranks on one card, and gloo
stages through the host), so a sharded update is cut where its collectives
are. :meth:`LearnerSharding.reduce` is :meth:`~LearnerSharding.pack` (the
flat ``[grads | metrics]``), :meth:`~LearnerSharding.sum_ranks` (the
collectives) and :meth:`~LearnerSharding.unpack` (the division by dp and the
``.grad`` leaves); the learner's gradient program ends in ``pack``, its step
program starts from ``unpack``, and the host runs ``sum_ranks`` between the
two replays and :meth:`~LearnerSharding.gather` after the second. That holds
whenever the forward and backward themselves hold no collective
(:attr:`~LearnerSharding.captures`): the mp compute split and the gp routing
run theirs inside autograd, so those updates stay eager.
"""

import contextlib

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import init_device_mesh

from uav_bs_ctrl_tpu_torch.algos.buffer import tree_map
from uav_bs_ctrl_tpu_torch.parallel import mp_split
from uav_bs_ctrl_tpu_torch.parallel.dist import all_gather, all_reduce
from uav_bs_ctrl_tpu_torch.parallel.graph_parallel import set_graph_parallel_mesh


def make_mesh(n_devices=None, mp=1, gp=1):
    """A ``DeviceMesh`` ``('dp', 'mp'[, 'gp'])`` over the default group's
    ``n_devices`` ranks (all of them), ``gp`` only when ``gp > 1``."""
    world = dist.get_world_size()
    n = n_devices or world
    assert n % (mp * gp) == 0, f"n_devices={n} not divisible by mp*gp={mp * gp}"
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if gp > 1:
        return init_device_mesh(device_type, (n // (mp * gp), mp, gp),
                                mesh_dim_names=("dp", "mp", "gp"))
    return init_device_mesh(device_type, (n // mp, mp), mesh_dim_names=("dp", "mp"))


def shard_params_spec(params, mesh):
    """JAX's ``PartitionSpec`` of each leaf of ``params`` (nested dicts of
    tensors or arrays, e.g. ``{name: tensor}`` keyed like ``params_from_jax``)
    as a tuple: ``(None, ..., 'mp')`` when its last axis divides ``mp`` (and
    is at least ``mp``), else ``()`` (replicated)."""
    mp = mesh.size(mesh.mesh_dim_names.index("mp"))

    def rule(leaf):
        shape = tuple(leaf.shape)
        if mp > 1 and shape and shape[-1] % mp == 0 and shape[-1] >= mp:
            return (None,) * (len(shape) - 1) + ("mp",)
        return ()

    return tree_map(rule, params)


def _coords(mesh, axis):
    i = mesh.mesh_dim_names.index(axis)
    return mesh.size(i), mesh.get_local_rank(i), mesh.get_group(i)


def shard_batch(batch, mesh):
    """This rank's rows ``[r B/dp, (r+1) B/dp)`` of a batch (leaves ``[B, ...]``),
    ``r`` its dp coordinate."""
    dp, r, _ = _coords(mesh, "dp")

    def rows(x):
        if x.shape[0] % dp:
            raise ValueError(f"batch of {x.shape[0]} rows over dp={dp}")
        b = x.shape[0] // dp
        return x[r * b:(r + 1) * b]

    return tree_map(rows, batch)


def compute_plan(agent, mesh):
    """The modules of ``agent`` that split their work over the mesh's ``mp``
    axis, as the agent plans them (its ``mp_plan``), with this rank's share:
    ``({module path: Share}, {the params whose gradient is the rank's
    share})``; empty when ``mp`` is 1 or the agent splits nothing."""
    mp, rank, group = _coords(mesh, "mp")
    if mp == 1 or not hasattr(agent, "mp_plan"):
        return {}, set()
    units, split = agent.mp_plan(mp)
    shares = {path: mp_split.Share(unit, rank * whole // mp, (rank + 1) * whole // mp, whole,
                                   group)
              for path, (unit, whole) in units.items()}
    return shares, split


class LearnerSharding:
    """What :func:`distribute_learner` adds to a ``RecurrentQLearner``
    (``learner.sharding``): the dp reduction of each update's gradients and
    metrics, the mp shards (``masters``, ``target_masters``) that AdamW
    steps and Polyak reads, all-gathered into the modules after each step,
    and the mp compute split (``plan``: ``{module: its share, or
    'replicated'}``; ``split``: per param, whether its gradient is a share)."""

    METRICS = ("LossQ", "QVals")      # an update's metrics, packed after the gradients

    def __init__(self, learner, mesh, graph_parallel=False):
        self.mesh = mesh
        self.dp, self.dp_rank, self.dp_group = _coords(mesh, "dp")
        self.mp, self.mp_rank, self.mp_group = _coords(mesh, "mp")
        self.rank = dist.get_rank()
        named = {f"{g}.{k}": p for g, ps in learner._by_group(lambda p: p).items()
                 for k, p in ps.items()}
        spec = shard_params_spec(named, mesh)
        self.params, self.targets = learner.parameters(), learner.target_parameters()
        self.sliced = [bool(spec[name]) for name in named]
        self.n_net = len(list(learner.net.parameters()))
        self.masters = [nn.Parameter(self._shard(p)) if s else p
                        for p, s in zip(self.params, self.sliced)]
        self.target_masters = [self._shard(t) if s else t
                               for t, s in zip(self.targets, self.sliced)]
        shares, split = compute_plan(learner.net, mesh)
        for net in (learner.net, learner.target_net):
            for path, share in shares.items():
                net.get_submodule(path).mp_share = share
        self.split = [name.startswith("net.") and name[len("net."):] in split for name in named]
        self.split_active = False
        self.plan = {f"net.{path}": repr(share) for path, share in shares.items()}
        split_modules = tuple(f"net.{path}" for path in shares)
        replicated = sorted({name.rsplit(".", 1)[0] for name in named
                             if not name.startswith(split_modules)})
        self.plan.update({module: "replicated" for module in replicated})
        self.plan_line = (
            f"mp compute split (mp = {self.mp}, updates through the kernels): " + (", ".join(
                f"net.{path} {share.hi - share.lo} of {share.whole} {share.unit}"
                for path, share in shares.items()) or "none") +
            "; computed whole on every mp rank: " + ", ".join(replicated))
        self.gp_routed = graph_parallel and any(
            getattr(m, "backend", None) == "graph_parallel" for m in learner.net.modules())
        self.captures_reason = (
            "the mp compute split runs its collectives inside the forward and backward"
            if any(self.split) else
            "the gp routing runs its collectives inside the forward and backward"
            if self.gp_routed else None)
        if self.rank == 0 and self.mp > 1:
            print(self.plan_line, flush=True)
        if self.rank == 0 and not self.captures:
            print(f"sharded update eager, not programs: {self.captures_reason}", flush=True)
        optimizer = learner._make_optimizer(self.masters)
        for p, m, s in zip(self.params, self.masters, self.sliced):
            if p in learner.optimizer.state:
                optimizer.state[m] = {k: self._shard(v) if s and v.dim() else v.clone()
                                      for k, v in learner.optimizer.state[p].items()}
        learner.optimizer = optimizer

    def _shard(self, t):
        n = t.shape[-1] // self.mp
        return t.detach()[..., self.mp_rank * n:(self.mp_rank + 1) * n].clone()

    def rows(self, b):
        """``(lo, hi, B)``: this rank's rows of the global batch of ``B`` =
        ``b`` dp rows."""
        return self.dp_rank * b, (self.dp_rank + 1) * b, b * self.dp

    def split_compute(self, use_kernels=True):
        """The span in which the planned modules run their shares (an update's
        loss); with ``use_kernels=False`` every module runs whole, and
        :meth:`reduce` sums over dp only."""
        self.split_active = bool(use_kernels) and any(self.split)
        return mp_split.splitting() if self.split_active else contextlib.nullcontext()

    @property
    def captures(self):
        """Whether the update can run as programs: its forward and backward
        hold no collective (no mp compute split planned, no gp routing); else
        ``captures_reason`` says why not."""
        return self.captures_reason is None

    def reduce(self, metrics):
        """The dp mean of the module params' raw gradients (in ``.grad``) and
        of ``metrics`` (0-d tensors, :attr:`METRICS`), by one sum and a
        division by dp: :meth:`pack`, :meth:`sum_ranks`, :meth:`unpack`.
        Under the compute split the sum also runs over mp, where a split
        gradient is the rank's share and a replicated one (and the metrics)
        comes from mp rank 0 alone: one collective over dp x mp (over mp,
        then dp, when the mesh also has a gp axis)."""
        return self.unpack(self.sum_ranks(self.pack(metrics)))

    def pack(self, metrics):
        """The raw gradients (zeros where there is none) and ``metrics``, in
        :attr:`METRICS`' order, as one flat tensor; under the compute split
        an mp rank other than 0 gives zeros for every replicated part."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad.reshape(-1) for p in self.params]
        values = [metrics[k].reshape(1).to(self.params[0].dtype) for k in self.METRICS]
        if self.split_active and self.mp_rank != 0:
            grads = [g if s else torch.zeros_like(g) for g, s in zip(grads, self.split)]
            values = [torch.zeros_like(v) for v in values]
        return torch.cat(grads + values)

    def sum_ranks(self, flat):
        """The sum of :meth:`pack`'s tensor over the ranks that share it, out
        of place: dp, or under the compute split dp x mp (none at dp = 1
        without it)."""
        if not self.split_active:
            groups = [self.dp_group] if self.dp > 1 else []
        elif "gp" in self.mesh.mesh_dim_names:      # dp x mp is not every rank
            groups = [self.mp_group] + ([self.dp_group] if self.dp > 1 else [])
        else:
            groups = [None]                          # every rank: dp x mp
        for group in groups:
            flat = all_reduce(flat, group)
        return flat

    def unpack(self, flat):
        """The summed tensor divided by dp, its gradients made the params'
        ``.grad`` (views of it); returns the metrics."""
        if self.dp > 1:
            flat = flat / self.dp
        parts = torch.split(flat, [p.numel() for p in self.params] + [1] * len(self.METRICS))
        for p, g in zip(self.params, parts):
            p.grad = g.view(p.shape)
        return {k: v.reshape(()) for k, v in zip(self.METRICS, parts[len(self.params):])}

    def take_grads(self):
        """Each master's gradient: its shard of the module's reduced one."""
        for p, m, s in zip(self.params, self.masters, self.sliced):
            if s:
                m.grad = self._shard(p.grad)

    def gather(self):
        """All-gather the masters' and target masters' shards (one collective)
        into the modules' full tensors."""
        pairs = [(p, m) for p, m, s in zip(self.params + self.targets,
                                            self.masters + self.target_masters,
                                            self.sliced * 2) if s]
        if not pairs:
            return
        sizes = [m.numel() for _, m in pairs]
        parts = [torch.split(part, sizes) for part in all_gather(
            torch.cat([m.detach().reshape(-1) for _, m in pairs]), self.mp_group)]
        with torch.no_grad():
            for i, (p, m) in enumerate(pairs):
                p.copy_(torch.cat([part[i].reshape(m.shape) for part in parts], -1))

    def full_adam_state(self, optimizer):
        """AdamW's state keyed by the module params, the moments of sharded
        ones all-gathered over mp."""
        state = {}
        for p, m, s in zip(self.params, self.masters, self.sliced):
            if m not in optimizer.state:
                continue
            state[p] = {k: torch.cat(all_gather(v, self.mp_group), -1) if s and v.dim() else v
                        for k, v in optimizer.state[m].items()}
        return state


def distribute_learner(learner, mesh, graph_parallel=False):
    """Shard a ``RecurrentQLearner``'s update over ``mesh`` (see the module
    docstring); ``learner.batch_size`` is the global batch and must divide by
    dp. Call it on every rank, after the weights and AdamW state are loaded;
    each update then takes this rank's rows (:func:`shard_batch`).

    ``graph_parallel=True`` also registers the mesh's ``gp`` axis, so that
    ``'graph_parallel'`` backends route the GATv2 slot aggregation and the
    TarMAC talk attention through :mod:`.graph_parallel` inside the update.

    Over ``mp > 1`` the update also splits its work (:func:`compute_plan`;
    ``learner.sharding.plan``, and one line on rank 0 naming each split
    module, its share and what stays whole). An update whose forward and
    backward hold no collective runs as programs on a learner made with
    ``graphs`` (``learner.sharding.captures``); else rank 0 prints why it
    stays eager."""
    dp = mesh.size(mesh.mesh_dim_names.index("dp"))
    assert learner.batch_size % dp == 0, \
        f"batch_size={learner.batch_size} must divide dp={dp}"
    if graph_parallel:
        assert "gp" in mesh.mesh_dim_names and mesh.size(mesh.mesh_dim_names.index("gp")) > 1, \
            "graph_parallel=True needs a mesh with a 'gp' axis (make_mesh(gp=...))"
        set_graph_parallel_mesh(mesh, "gp")
    learner.sharding = LearnerSharding(learner, mesh, graph_parallel)
    return learner
