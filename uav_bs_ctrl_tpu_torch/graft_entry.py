"""Entry points of the port (the twin of ``__graft_entry__.py``).

``entry()`` returns the flagship model's forward step, the exp3 8-UBS
``GnnAgent`` (hetero-GATv2 encoder, TarMAC, dueling Q head), and example
args. ``dryrun_multichip(n)`` spawns ``n`` ranks on JAX's mesh rule, shards
the full training update (BPTT, double-Q, QMIX, AdamW, Polyak) over them,
and holds each rank's update against a single-rank one on the same batch,
with JAX's tolerances; a ``'graph_parallel'`` fallback to dense fails it.
Over ``mp > 1`` the sharded update splits its work (``parallel/mp_split.py``):
the flagship case's ranks run #2/#3 on their heads and the column-split
#4/#5 on their hidden columns. Run it as ``python -m
uav_bs_ctrl_tpu_torch.graft_entry [n] [--dims DP MP GP] [--device cpu]``.
"""

import argparse
import warnings
from types import SimpleNamespace as SN

import numpy as np
import torch

from uav_bs_ctrl_tpu_torch.algos.buffer import tree_map
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import DEFAULT_CONFIG, check_args_sanity
from uav_bs_ctrl_tpu_torch.device import resolve_device
from uav_bs_ctrl_tpu_torch.models.agents import GnnAgent
from uav_bs_ctrl_tpu_torch.parallel import launch, workers
from uav_bs_ctrl_tpu_torch.parallel.graph_parallel import set_graph_parallel_mesh
from uav_bs_ctrl_tpu_torch.parallel.mesh import distribute_learner, make_mesh, shard_batch

NF_GT, NF_UBS = 5, 3
# JAX's two cases (``__graft_entry__.py:207-215``) and their tolerances. ``kernels``: the
# updates run through kernels #2-#5; the toy's heads of F = 8 features take the plain
# path (the GATv2 kernels need F a multiple of 32), as JAX's dry run runs XLA's.
CASES = {
    "toy": dict(A=4, M=6, K=3, hidden=32, msg=16, keysz=8, n_heads=4, T=4, n_actions=5,
                grad_atol=1e-6, params_atol=2e-4, kernels=False),
    "flagship-8ubs": dict(A=8, M=50, K=7, hidden=256, msg=64, keysz=16, n_heads=4, T=40,
                          n_actions=9, grad_atol=1e-4, params_atol=1e-3, kernels=True),
}
LOSS_RTOL, GRAD_RTOL, PARAMS_RTOL = 1e-4, 1e-4, 1e-2


def make_obs(rng, B, A, M, K, nf_gt=NF_GT, nf_ubs=NF_UBS, with_batch=True):
    """Random observations (JAX's ``_make_obs``): flag column 0 of each
    GT/UBS row half set, the talk graph complete."""
    shape = (B,) if with_batch else ()
    return {
        "agent": rng.normal(size=shape + (A, 2)).astype(np.float32),
        "gt": np.concatenate([
            (rng.random(shape + (A, M, 1)) > 0.5).astype(np.float32),
            rng.normal(size=shape + (A, M, nf_gt - 1)).astype(np.float32)], -1),
        "ubs": np.concatenate([
            (rng.random(shape + (A, K, 1)) > 0.5).astype(np.float32),
            rng.normal(size=shape + (A, K, nf_ubs - 1)).astype(np.float32)], -1),
        "adj": np.ones(shape + (A, A), dtype=bool),
    }


def entry(device=None):
    """The flagship agent's forward step and example args: ``(fn, (obs, h))``
    with ``fn(obs, h) -> (q, h')``, 32 worlds of 8 agents, on ``device``
    (default the card)."""
    device = resolve_device(device)
    args = SN(hidden_size=256, n_layers=2, n_heads=4, msg_size=64, key_size=16, n_rounds=1,
              dueling=True, c="tarmac", o="gnn", gat_backend="dense", comm_backend="dense")
    A, M, K = 8, 50, 7
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        agent = GnnAgent(dict(agent=2, gt=NF_GT - 1, ubs=NF_UBS - 1), 9, args).to(device)
    obs = {k: torch.as_tensor(v, device=device)
           for k, v in make_obs(np.random.default_rng(0), 32, A, M, K).items()}
    h = torch.zeros((32, A, args.hidden_size), device=device)
    return agent, (obs, h)


def mesh_dims(n_devices):
    """JAX's mesh rule (``__graft_entry__.py:95-99``): ``(dp, mp, gp)``."""
    gp = 2 if n_devices % 8 == 0 else 1
    mp = 2 if n_devices % (2 * gp) == 0 and n_devices > 1 else 1
    return n_devices // (mp * gp), mp, gp


def run_case(rank, world, device, label, dims):
    """One rank of a dry-run case: the sharded update on ``dims`` = (dp, mp,
    gp) against a single-rank update of the same seed-0 weights on the same
    batch (both in this rank). Raises when they disagree or a
    ``'graph_parallel'`` path fell back to dense; returns the numbers."""
    c = CASES[label]
    dp, mp, gp = dims
    A, M, K, T, hidden = c["A"], c["M"], c["K"], c["T"], c["hidden"]
    batch_size = max(dp, 4 - 4 % dp)
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(o="gnn", c="tarmac", hidden_size=hidden, msg_size=c["msg"], key_size=c["keysz"],
               n_heads=c["n_heads"], batch_size=batch_size, max_seq_len=T, mixer=True,
               double_q=True, dueling=True, replay_size=max(16, batch_size), device=str(device))
    if gp > 1:
        cfg.update(gat_backend="graph_parallel", comm_backend="graph_parallel")
    env_info = dict(obs_shape=dict(agent=2, gt=NF_GT - 1, ubs=NF_UBS - 1),
                    state_shape=A * 2 + M * 4, n_actions=c["n_actions"], n_agents=A,
                    episode_limit=T)
    single = MultiAgentQLearner(env_info, check_args_sanity(SN(**{
        **cfg, "gat_backend": "dense", "comm_backend": "dense"})), seed=0)
    learner = MultiAgentQLearner(env_info, check_args_sanity(SN(**cfg)), seed=0)

    rng = np.random.default_rng(0)
    for _ in range(batch_size):
        for t in range(T):
            single.cache(
                obs=make_obs(rng, None, A, M, K, with_batch=False),
                h=rng.normal(size=(A, hidden)).astype(np.float32),
                state=rng.normal(size=(env_info["state_shape"],)).astype(np.float32),
                act=rng.integers(c["n_actions"], size=A),
                rew=rng.normal(size=A).astype(np.float32),
                next_obs=make_obs(rng, None, A, M, K, with_batch=False),
                next_h=rng.normal(size=(A, hidden)).astype(np.float32),
                next_state=rng.normal(size=(env_info["state_shape"],)).astype(np.float32),
                done=float(t == T - 1), bad_mask=float(t == T - 1))
    batch = tree_map(lambda x: torch.as_tensor(x, device=device),
                     single.buffer.sample(batch_size, rng=np.random.default_rng(1)))

    mesh = make_mesh(world, mp=mp, gp=gp)
    distribute_learner(learner, mesh, graph_parallel=gp > 1)
    local = shard_batch(batch, mesh)
    try:
        loss_single, grads_single, params_single = _update(single, batch, c["kernels"])
        workers.reset_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loss, grads, params = _update(learner, local, c["kernels"])
            launches, shapes = workers.counts(), workers.shapes()
            ms, coll = workers.timed_update(learner, local, c["kernels"])
    finally:
        set_graph_parallel_mesh(None)
    fallbacks = [str(w.message) for w in caught if "fell back to dense" in str(w.message)]
    if fallbacks:
        raise AssertionError(f"graph-parallel path fell back to dense: {fallbacks}")
    if not np.isfinite(loss):
        raise AssertionError(f"LossQ {loss}")
    np.testing.assert_allclose(loss, loss_single, rtol=LOSS_RTOL)
    for a, b in zip(grads_single, grads):
        np.testing.assert_allclose(b, a, atol=c["grad_atol"], rtol=GRAD_RTOL)
    for a, b in zip(params_single, params):
        np.testing.assert_allclose(b, a, atol=c["params_atol"], rtol=PARAMS_RTOL)
    return dict(label=label, dims=dims, backend=torch.distributed.get_backend(), loss=loss,
                loss_single=loss_single, launches=launches, shapes=shapes,
                plan=learner.sharding.plan, plan_line=learner.sharding.plan_line,
                captures=learner.sharding.captures,
                captures_reason=learner.sharding.captures_reason, ms=ms,
                collective_ms=coll["ms"], collective_calls=coll["calls"],
                grad_err=max(float(np.abs(a - b).max()) for a, b in zip(grads_single, grads)),
                params_err=max(float(np.abs(a - b).max())
                               for a, b in zip(params_single, params)))


def _update(learner, batch, use_kernels):
    """One update: ``(LossQ, raw gradients, params after)`` as numpy."""
    with torch.enable_grad():
        m = learner.backward(batch, use_kernels)
        grads = [p.grad.detach().cpu().numpy().copy() for p in learner.parameters()]
        learner.apply_grads()
    return (float(m["LossQ"]), grads,
            [p.detach().cpu().numpy().copy() for p in learner.parameters()])


def dryrun_multichip(n_devices, device=None, cases=tuple(CASES), dims=None):
    """Spawn ``n_devices`` ranks (NCCL with a card each, else gloo: on the
    CPU, or with several ranks on one card), run ``cases`` on JAX's mesh
    rule (or ``dims`` = (dp, mp, gp)) and print one line each; returns
    ``{label: [each rank's numbers]}``. Raises when a rank fails or
    disagrees with the single-rank update."""
    device = resolve_device(device)
    dims = tuple(dims) if dims is not None else mesh_dims(n_devices)
    results = launch.spawn(n_devices, [(run_case, dict(label=label, dims=dims))
                                       for label in cases], device)
    out = {}
    for label, ranks in zip(cases, results):
        r0 = ranks[0]
        c = CASES[label]
        print(f"dryrun_multichip({n_devices}) [{label}]: {r0['backend']} on {device}, mesh "
              f"dp={dims[0]} mp={dims[1]} gp={dims[2]}"
              f"{' (graph-parallel GATv2 + TarMAC talk attention in-step)' if dims[2] > 1 else ''}"
              f", A={c['A']} M={c['M']} hidden={c['hidden']} T={c['T']}, LossQ="
              f"{r0['loss']:.6f} == single-rank {r0['loss_single']:.6f} (grads max |diff| "
              f"{max(r['grad_err'] for r in ranks):.2e}, params "
              f"{max(r['params_err'] for r in ranks):.2e}) OK", flush=True)
        if not r0["captures"]:
            print(f"  the sharded update stays eager: {r0['captures_reason']}", flush=True)
        if dims[1] > 1 and c["kernels"]:
            for r, x in enumerate(ranks):
                print(f"  rank {r}: #2/#3 at (heads, H*F) {x['shapes']['flash_gat_fused']}, the "
                      f"split #4/#5 on GRU columns (lo, hi, H) {x['shapes']['tarmac_step_cols']}",
                      flush=True)
        out[label] = ranks
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_devices", type=int, nargs="?", default=None,
                        help="ranks (default: the cards, at most 8)")
    parser.add_argument("--dims", type=int, nargs=3, default=None, metavar=("DP", "MP", "GP"),
                        help="the mesh (default: JAX's rule for the ranks)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    cli = parser.parse_args()
    device = resolve_device(cli.device)
    fn, example = entry(device)
    with torch.no_grad():
        q, h = fn(*example)
    print(f"entry forward: q {tuple(q.shape)}, h {tuple(h.shape)}", flush=True)
    n = cli.n_devices or min(8, max(1, torch.cuda.device_count() if device.type == "cuda"
                                    else 1))
    dryrun_multichip(n, device, dims=cli.dims)


if __name__ == "__main__":
    main()
