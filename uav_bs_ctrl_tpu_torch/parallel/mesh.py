"""Device meshes and the sharded learner (counterpart of ``parallel/mesh.py``).

- Mesh axes ``('dp', 'mp')``, or ``('dp', 'mp', 'gp')`` when ``gp > 1``, over
  the ranks of the default process group, row-major as JAX lays its devices.
- ``dp``: each rank trains on its rows of the global batch; the dp group sums
  the raw gradients and each rank divides by dp (``ReduceOp.AVG`` is
  NCCL-only). The loss is a plain mean over equal shards, so the mean of the
  ranks' gradients is the global gradient. The value clip then runs on the
  reduced gradient: clipping does not commute with the mean.
- ``mp``: parameter and optimizer-state sharding. Params, targets and AdamW
  moments whose last axis divides ``mp`` (JAX's shape rule) are kept as
  last-axis shards; each rank clips, steps AdamW and Polyak-averages only its
  own shard (all elementwise, so the single-device math), and the mp group
  all-gathers the shards into the modules before the next forward. Each mp
  rank runs the whole forward and backward of its dp rows: the compute is
  not split, as XLA splits matmuls over ``mp``, which would need
  column-split variants of kernels #2-#5 (ROADMAP.md Queue 1).
- ``gp``: ``distribute_learner(..., graph_parallel=True)`` registers the
  ``gp`` group, so that ``gat_backend``/``comm_backend='graph_parallel'`` run
  the edge-partitioned functions of :mod:`.graph_parallel`; they give every
  gp rank the dense gradient, so nothing is reduced over ``gp``.
"""

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import init_device_mesh

from uav_bs_ctrl_tpu_torch.algos.buffer import tree_map
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


class LearnerSharding:
    """What :func:`distribute_learner` adds to a ``RecurrentQLearner``
    (``learner.sharding``): the dp reduction of each update's gradients and
    metrics, and the mp shards (``masters``, ``target_masters``) that AdamW
    steps and Polyak reads, all-gathered into the modules after each step."""

    def __init__(self, learner, mesh):
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

    def reduce(self, metrics):
        """The dp mean of the module params' raw gradients (in ``.grad``) and
        of ``metrics`` (0-d tensors), by one sum and a division by dp."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.dp == 1:
            return metrics
        keys = list(metrics)
        flat = torch.cat([p.grad.reshape(-1) for p in self.params] +
                         [metrics[k].reshape(1).to(self.params[0].dtype) for k in keys])
        flat = all_reduce(flat, self.dp_group) / self.dp
        parts = torch.split(flat, [p.numel() for p in self.params] + [1] * len(keys))
        for p, g in zip(self.params, parts):
            p.grad.copy_(g.reshape(p.shape))
        return {k: v.reshape(()) for k, v in zip(keys, parts[len(self.params):])}

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
    TarMAC talk attention through :mod:`.graph_parallel` inside the update."""
    dp = mesh.size(mesh.mesh_dim_names.index("dp"))
    assert learner.batch_size % dp == 0, \
        f"batch_size={learner.batch_size} must divide dp={dp}"
    if graph_parallel:
        assert "gp" in mesh.mesh_dim_names and mesh.size(mesh.mesh_dim_names.index("gp")) > 1, \
            "graph_parallel=True needs a mesh with a 'gp' axis (make_mesh(gp=...))"
        set_graph_parallel_mesh(mesh, "gp")
    learner.sharding = LearnerSharding(learner, mesh)
    return learner
