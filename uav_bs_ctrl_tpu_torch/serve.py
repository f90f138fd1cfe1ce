"""Serve a trained policy: load a run's checkpoint and play test episodes.

The port's counterpart of the load-and-evaluate step in ``test_policies.py`` /
``algos/madrqn/run.py:load_and_run_policy``, run on the on-device env:

    python -m uav_bs_ctrl_tpu_torch.serve --run-dir <run dir> --episodes 40 \
        [--gat-backend pallas]

Any agent the port has loads from its ``config.json``, as the JAX learner
builds it (``build_agent``): the GNN agent with every comm protocol or a GRU
only, the MLP-encoder agent of exp2 and of the exp3 MLP ablation (with a
protocol), and ``RnnAgent`` (``o='mlp'`` without one), which play on the flat
observation. An exp1 run (``"exp": "exp1"`` in its ``config.json``) is the
single-UBS DRQN: its ``args.agent`` picks ``DrqnGnnAgent`` or ``RnnAgent``
(on the flat ``[agent | gt]`` observation), and it plays the single-UBS env
on the run's ``env_kwargs``. ``--gat-backend`` overrides the run's GATv2
backend (the JAX package reaches its ``flash_gat`` kernel only through
``gat_backend``): ``pallas`` runs ``flash_gat``, every other backend the
projection-fused kernels; ``DrqnGnnAgent`` has no backend, so an exp1 run
refuses it, and so does a bf16 run (``flash_gat`` is float32 only). Runs on ``cuda`` unless ``--device cpu`` is given; the GATv2
encoder and the one-round TarMAC step then go through the hand-written CUDA
kernels. The policy runs at the run's ``compute_dtype`` (bf16 compute on the
f32 checkpoint's weights, as the JAX learner's ``_apply_net``).
"""

import argparse
import functools
import json
import re
from pathlib import Path
from types import SimpleNamespace

import torch

from uav_bs_ctrl_tpu_torch.algos import collect, collect_subs
from uav_bs_ctrl_tpu_torch.algos.core import COMPUTE_DTYPES, apply_net
from uav_bs_ctrl_tpu_torch.algos.drqn import config as drqn_config
from uav_bs_ctrl_tpu_torch.algos.drqn import fused as drqn_fused
from uav_bs_ctrl_tpu_torch.algos.madrqn.fused import obs_shape
from uav_bs_ctrl_tpu_torch.config import DEFAULT_CONFIG, make_args
from uav_bs_ctrl_tpu_torch.envs import torch_env, torch_env_subs
from uav_bs_ctrl_tpu_torch.models.agents import DRQN_REGISTRY, build_agent
from uav_bs_ctrl_tpu_torch.utils import checkpoint
from uav_bs_ctrl_tpu_torch.utils.convert import params_from_jax

N_TEST_LAYOUTS = 256        # held-out layout pool, as the fused trainer's test pool
TEST_POOL_SEED = 10_000


def latest_checkpoint(run_dir) -> Path:
    found = sorted(Path(run_dir).glob("checkpoint_epoch*.pt"),
                   key=lambda p: int(re.search(r"epoch(\d+)", p.name).group(1)))
    if not found:
        raise FileNotFoundError(f"no checkpoint_epoch*.pt in {run_dir}")
    return found[-1]


def load_policy(run_dir, device=None, checkpoint_path=None, gat_backend=None):
    """``(agent, config)`` for a run directory: its ``config.json`` (with
    ``gat_backend`` over the run's own when given) and its newest (or the
    given) checkpoint, on ``device`` (default ``cuda``). The agent is frozen
    (no parameter requires grad): it only serves."""
    config = json.loads((Path(run_dir) / "config.json").read_text())
    if is_exp1(config):
        if gat_backend is not None:
            raise ValueError("an exp1 run's DrqnGnnAgent has no gat_backend")
        args = drqn_config.check_args(SimpleNamespace(
            **dict(drqn_config.DEFAULT_CONFIG, **config["args"],
                   device=device or drqn_config.DEFAULT_CONFIG["device"])))
        env_params = torch_env_subs.make_params(**config["env_kwargs"])
        agent = DRQN_REGISTRY[args.agent](drqn_fused.obs_shape(env_params, args.agent),
                                          env_params.n_actions, args)
    else:
        if gat_backend is not None:
            config["args"] = dict(config["args"], gat_backend=gat_backend)
        args = make_args(config["args"], device)
        if args.gat_backend == "pallas" and args.compute_dtype == "bfloat16":
            raise NotImplementedError(
                "gat_backend='pallas' runs flash_gat (#1), which is float32 only in both "
                "packages (the JAX package's flash_gat cannot store its f32 accumulator into "
                "bf16 outputs either). Serve a bf16 run with 'pallas_fused' or "
                "'pallas_fused_mxu'.")
        env_params = torch_env.make_params(config["map_id"])
        agent = build_agent(obs_shape(env_params, args.o), env_params.n_actions, args)
    ckpt = checkpoint.load(checkpoint_path or latest_checkpoint(run_dir))
    agent.load_state_dict(params_from_jax(ckpt["model_state_dict"], agent))
    return agent.to(args.device).eval().requires_grad_(False), config


def is_exp1(config):
    """Whether a run's ``config.json`` is an exp1 (single-UBS DRQN) run."""
    return config.get("exp") == "exp1"


def test_pool(map_id, seed):
    return collect.make_layout_pool(map_id, N_TEST_LAYOUTS, seed=seed + TEST_POOL_SEED)


def test_pool_subs(env_kwargs, seed):
    """exp1's held-out pool, as the DRQN trainer's test pool."""
    return collect_subs.make_subs_layout_pool(N_TEST_LAYOUTS, seed=seed + TEST_POOL_SEED,
                                              **env_kwargs)


@torch.no_grad()
def evaluate(run_dir, n_episodes, eps=0.05, seed=0, device=None, checkpoint_path=None,
             gat_backend=None):
    """Episode statistics ([n_episodes] tensors) of the run's policy playing
    ``n_episodes`` worlds, one episode each, in parallel."""
    agent, config = load_policy(run_dir, device, checkpoint_path, gat_backend)
    generator = torch.Generator().manual_seed(seed)
    device = next(agent.parameters()).device
    net = functools.partial(apply_net, agent, dtype=COMPUTE_DTYPES[config["args"].get(
        "compute_dtype", "float32")])
    if is_exp1(config):
        env_params = torch_env_subs.make_params(**config["env_kwargs"])
        policy = collect_subs.make_policy(net, config["args"].get(
            "agent", drqn_config.DEFAULT_CONFIG["agent"]))
        return collect_subs.evaluate_policy_subs(
            env_params, policy, test_pool_subs(config["env_kwargs"], seed), agent.hidden,
            generator, n_episodes, device, eps)
    env_params = torch_env.make_params(config["map_id"])
    policy = collect.make_policy(net, config["args"].get("o", DEFAULT_CONFIG["o"]))
    return collect.evaluate_policy(env_params, policy, test_pool(config["map_id"], seed),
                                   agent.hidden, generator, n_episodes, device, eps)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--run-dir", required=True)
    parser.add_argument("--episodes", type=int, default=40)
    parser.add_argument("--eps", type=float, default=0.05)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--gat-backend", default=None,
                        help="override the run's gat_backend (pallas: the flash_gat kernel)")
    cli = parser.parse_args(argv)
    stats = evaluate(cli.run_dir, cli.episodes, cli.eps, cli.seed, cli.device, cli.checkpoint,
                     cli.gat_backend)
    print(json.dumps({k: float(v.mean()) for k, v in stats.items()}))


if __name__ == "__main__":
    main()
