"""Serving the committed exp3 checkpoints: the 8-UBS TarMAC run (hidden 256, 4
heads of 64, msg 64, key 16) through the fused GATv2 kernels and through
'pallas' (``flash_gat``), and the 4-UBS DiscreteComm run (msg 64, no mixer)
fed JAX's own Gumbel noise; and the committed exp2 runs (the MLP encoder on
the flat observation: the iql ``RnnAgent``, DiscreteComm and TarMAC); and the
committed exp1 runs (4 groups x 5 GTs, ``DrqnGnnAgent`` and ``RnnAgent``) on
the single-UBS env; the port against JAX at full width, tolerance 1e-4. Also
the serving and training entry points with JAX, optax, pandas and matplotlib
absent, and no import of them anywhere in the port or in ``chip_smoke.py``.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uav_bs_ctrl_tpu.algos.madrqn.config import DEFAULT_CONFIG as JAX_DEFAULTS
from uav_bs_ctrl_tpu.envs import jax_env
from uav_bs_ctrl_tpu.models.agents import GnnAgent as JaxGnnAgent
from uav_bs_ctrl_tpu.models.agents import build_agent as jax_build_agent
from uav_bs_ctrl_tpu_torch import serve
from uav_bs_ctrl_tpu_torch.algos import collect
from uav_bs_ctrl_tpu_torch.envs import torch_env
from uav_bs_ctrl_tpu_torch.utils import checkpoint

ROOT = Path(__file__).resolve().parents[1]
RUN_DIR = (ROOT / "data" / "exp3_fast_8ubs_tarmac_qmix_il10_lay64k"
           / "exp3_fast_8ubs_tarmac_qmix_il10_lay64k_s0")
DISC_DIR = ROOT / "data" / "exp3_fast_4ubs_disc_lay64k" / "exp3_fast_4ubs_disc_lay64k_s0"
EXP2_DIRS = {c: ROOT / "data" / f"exp2_fast_r400_{c}" / f"exp2_fast_r400_{c}_s0"
             for c in ("iql_qmix", "disc", "tarmac")}
TOL = dict(atol=1e-4, rtol=1e-4)
FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "flax", "pandas", "matplotlib",
             "cloudpickle", "uav_bs_ctrl_tpu"}


def _jax_policy(run_dir=RUN_DIR):
    config = json.loads((run_dir / "config.json").read_text())
    args = SN(**{**JAX_DEFAULTS, **config["args"]})
    params = checkpoint.load(serve.latest_checkpoint(run_dir))["model_state_dict"]
    env_params = jax_env.make_params(config["map_id"])
    agent = JaxGnnAgent({"agent": 2, "gt": 4, "ubs": 2}, env_params.n_actions, args)
    return agent, params, env_params


def _worlds(env_params, seed, map_id="8ubs"):
    """Two worlds from the serving test pool; in the second every UBS starts
    next to a GT group, so its 'seen' slots are populated."""
    ubs, gts = serve.test_pool(map_id, seed)
    ubs, gts = ubs[:2].copy(), gts[:2].copy()
    ubs[1] = gts[1][::gts.shape[1] // ubs.shape[1]][:ubs.shape[1]] + 30.0
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    prior = np.stack([np.asarray(jax.random.permutation(k, env_params.n_gts)) for k in keys])
    return ubs, gts, keys, prior


def _to_torch_obs(obs):
    return {k: torch.from_numpy(np.array(v)) for k, v in obs.items()}


def test_checkpoint_q_matches_jax_at_full_width():
    jagent, params, jp = _jax_policy()
    ubs, gts, keys, _ = _worlds(jp, seed=0)
    states = jax.vmap(lambda u, g, k: jax_env.reset_from_positions(jp, u, g, k))(
        jnp.asarray(ubs), jnp.asarray(gts), keys)
    obs = jax.vmap(lambda s: jax_env.get_obs(jp, s))(states)
    assert float(obs["gt"][..., 0].sum()) > 0
    h = np.tanh(np.random.default_rng(0).normal(size=(2, jp.n_ubs, 256))).astype(np.float32)
    q_want, h_want = jax.jit(jagent.apply)(params, obs, jnp.asarray(h))

    agent, _ = serve.load_policy(RUN_DIR, device="cpu")
    with torch.no_grad():
        for use_kernels in (True, False):
            q, h2 = agent(_to_torch_obs(obs), torch.from_numpy(h), use_kernels=use_kernels)
            np.testing.assert_allclose(q.numpy(), np.asarray(q_want), **TOL)
            np.testing.assert_allclose(h2.numpy(), np.asarray(h_want), **TOL)


def test_checkpoint_pallas_backend_matches_jax_dense():
    """``--gat-backend pallas`` (both relations through ``flash_gat``) gives
    the JAX dense agent's Q and h'."""
    jagent, params, jp = _jax_policy()
    ubs, gts, keys, _ = _worlds(jp, seed=2)
    states = jax.vmap(lambda u, g, k: jax_env.reset_from_positions(jp, u, g, k))(
        jnp.asarray(ubs), jnp.asarray(gts), keys)
    obs = jax.vmap(lambda s: jax_env.get_obs(jp, s))(states)
    h = np.tanh(np.random.default_rng(2).normal(size=(2, jp.n_ubs, 256))).astype(np.float32)
    assert jagent.enc.backend == "dense"
    q_want, h_want = jax.jit(jagent.apply)(params, obs, jnp.asarray(h))
    agent, _ = serve.load_policy(RUN_DIR, device="cpu", gat_backend="pallas")
    assert agent.enc.seen.backend == agent.enc.near.backend == "pallas"
    with torch.no_grad():
        q, h2 = agent(_to_torch_obs(obs), torch.from_numpy(h))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_want), **TOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h_want), **TOL)


def test_disc_checkpoint_teacher_forced_rollout_matches_jax():
    """The 4-UBS DiscreteComm run (epoch 200), five greedy steps of both envs
    and both policies from the same layouts; each step splits a fresh policy
    key for the JAX agent, and the port gets that key's Gumbel noise. The port
    serves through 'pallas' and through its default backend."""
    jagent, params, jp = _jax_policy(DISC_DIR)
    tp = torch_env.make_params("4ubs")
    ubs, gts, keys, prior = _worlds(jp, seed=3, map_id="4ubs")
    js = jax.vmap(lambda u, g, k: jax_env.reset_from_positions(jp, u, g, k))(
        jnp.asarray(ubs), jnp.asarray(gts), keys)
    agents = [serve.load_policy(DISC_DIR, device="cpu", gat_backend=b)[0]
              for b in ("pallas", None)]
    states = [torch_env.reset_from_positions(tp, torch.from_numpy(ubs), torch.from_numpy(gts),
                                             torch.from_numpy(prior)) for _ in agents]
    jh = jnp.zeros((2, jp.n_ubs, 256))
    hs = [torch.zeros((2, jp.n_ubs, 256)) for _ in agents]
    jstep = jax.jit(jax.vmap(lambda s, a: jax_env.step(jp, s, a)))
    japply = jax.jit(jagent.apply)
    key = jax.random.PRNGKey(3)
    with torch.no_grad():
        for _ in range(5):
            key, k_pol = jax.random.split(key)
            jq, jh = japply(params, jax.vmap(lambda s: jax_env.get_obs(jp, s))(js), jh, k_pol)
            noise = torch.from_numpy(np.array(jax.random.gumbel(
                k_pol, (2, jp.n_ubs, jp.n_ubs, 64, 2), jnp.float32)))
            acts = np.array(jnp.argmax(jq, axis=-1))
            js, _, _, jrew, _ = jstep(js, jnp.asarray(acts))
            for i, agent in enumerate(agents):
                tq, hs[i] = agent(torch_env.get_obs(tp, states[i]), hs[i], key=noise)
                np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
                np.testing.assert_allclose(hs[i].numpy(), np.asarray(jh), **TOL)
                states[i], _, trew, _ = torch_env.step(tp, states[i], torch.from_numpy(acts))
                np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **TOL)
                states[i] = states[i]._replace(
                    prior_gts=torch.from_numpy(np.asarray(js.prior_gts, np.int64)))


def test_teacher_forced_rollout_matches_jax():
    """Five steps of both envs and both policies from the same worlds; both envs
    take the JAX policy's greedy actions."""
    jagent, params, jp = _jax_policy()
    tp = torch_env.make_params("8ubs")
    ubs, gts, keys, prior = _worlds(jp, seed=1)
    js = jax.vmap(lambda u, g, k: jax_env.reset_from_positions(jp, u, g, k))(
        jnp.asarray(ubs), jnp.asarray(gts), keys)
    ts = torch_env.reset_from_positions(tp, torch.from_numpy(ubs), torch.from_numpy(gts),
                                        torch.from_numpy(prior))
    agent, _ = serve.load_policy(RUN_DIR, device="cpu")
    jh = jnp.zeros((2, jp.n_ubs, 256))
    th = torch.zeros((2, jp.n_ubs, 256))
    jstep = jax.jit(jax.vmap(lambda s, a: jax_env.step(jp, s, a)))
    japply = jax.jit(jagent.apply)
    with torch.no_grad():
        for _ in range(5):
            jq, jh = japply(params, jax.vmap(lambda s: jax_env.get_obs(jp, s))(js), jh)
            tq, th = agent(torch_env.get_obs(tp, ts), th)
            np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
            acts = np.array(jnp.argmax(jq, axis=-1))
            js, _, _, jrew, _ = jstep(js, jnp.asarray(acts))
            ts, _, trew, _ = torch_env.step(tp, ts, torch.from_numpy(acts))
            np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **TOL)
            for name in ("ep_ret", "fair_idx", "avg_global_util", "total_throughput", "n_colls"):
                np.testing.assert_allclose(getattr(ts, name).numpy(),
                                           np.asarray(getattr(js, name)), err_msg=name, **TOL)
            # Exact rate ties may order differently (see test_torch_env.py).
            ts = ts._replace(prior_gts=torch.from_numpy(np.asarray(js.prior_gts, np.int64)))


def test_serve_runs_where_jax_optax_pandas_are_missing():
    """The GPU machine has none of these; reproduce that here, in a subprocess."""
    blocked = sorted(FORBIDDEN | {"jaxlib"})
    code = (
        "import sys, runpy\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "from uav_bs_ctrl_tpu_torch import serve\n"
        f"agent, config = serve.load_policy({str(RUN_DIR)!r}, device='cpu')\n"
        "assert config['map_id'] == '8ubs' and agent.hidden == 256\n"
        f"for run_dir in ({str(RUN_DIR)!r}, {str(DISC_DIR)!r}):\n"
        "    sys.argv = ['serve', '--run-dir', run_dir, '--episodes', '2', '--device', 'cpu',"
        " '--gat-backend', 'pallas']\n"
        "    runpy.run_module('uav_bs_ctrl_tpu_torch.serve', run_name='__main__')\n"
        f"assert not any(sys.modules.get(n) for n in {blocked!r})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()[-2:]
    for line in lines:
        stats = json.loads(line)
        assert set(stats) == {"TestEpRet", "TestFairIdx", "TestAvgGlobalUtility",
                              "TestTotalThroughput", "TestProbCollision"}
        assert all(np.isfinite(v) for v in stats.values())


F6_RUN = ROOT / "data" / "exp3_fast_4ubs_tarmac_mlp" / "exp3_fast_4ubs_tarmac_mlp_s0"


def test_load_policy_takes_the_callers_device_not_the_runs(monkeypatch):
    """F6: the exp3 MLP-ablation run stores ``"device": "cpu"``; serving it with
    no device must ask for CUDA (and raise where there is none), not follow
    the stored device onto the CPU. With ``device='cpu'`` it serves."""
    config = json.loads((F6_RUN / "config.json").read_text())
    assert config["args"]["device"] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        serve.load_policy(F6_RUN)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        serve.evaluate(F6_RUN, 2)
    agent, _ = serve.load_policy(F6_RUN, device="cpu")
    assert next(agent.parameters()).device.type == "cpu"
    stats = serve.evaluate(F6_RUN, 2, device="cpu")
    assert all(tuple(v.shape) == (2,) and bool(torch.isfinite(v).all()) for v in stats.values())


def test_port_and_chip_smoke_import_nothing_of_jax():
    files = sorted((ROOT / "uav_bs_ctrl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    port = ROOT / "uav_bs_ctrl_tpu_torch"
    assert {port / "envs" / "torch_env_subs.py", port / "algos" / "collect_subs.py",
            port / "algos" / "drqn" / "fused.py", port / "algos" / "drqn" / "learner.py",
            port / "algos" / "drqn" / "config.py"} <= set(files)
    host_loop = {port / name for name in (
        "envs/spaces.py", "envs/multi_agent_env.py", "envs/recorder.py", "envs/subs_cov.py",
        "envs/mubs_cov.py", "envs/__init__.py", "algos/madrqn/wrappers.py",
        "algos/drqn/wrappers.py", "algos/madrqn/run.py", "algos/drqn/run.py",
        "utils/reward_normalizer.py", "utils/profiling.py", "utils/run_utils.py",
        "utils/run_entrypoint.py", "test_policies.py", "collect_curves.py", "run_exp1.py",
        "run_exp2.py", "run_exp3.py", "run_classic.py")}
    assert host_loop <= set(files)
    slice13 = {port / name for name in (
        "native/__init__.py", "native/build.py", "native/env_core.py",
        "algos/madrqn/vec_run.py", "ops/segment.py")}
    assert slice13 <= set(files)
    parallel = {port / name for name in (
        "parallel/__init__.py", "parallel/dist.py", "parallel/mesh.py",
        "parallel/graph_parallel.py", "parallel/launch.py", "parallel/workers.py",
        "graft_entry.py")}
    assert parallel <= set(files)
    assert {"cloudpickle", "pandas", "matplotlib"} <= FORBIDDEN
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, f"{path}: relative import"
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("run", sorted(EXP2_DIRS))
def test_exp2_checkpoint_teacher_forced_rollout_matches_jax(run):
    """A committed exp2 r400 run (hidden 256, two MLP layers over the flat
    observation of width 31), three greedy steps of both envs from the same
    layouts: the JAX agent on ``fused.py:_agent_apply``'s flat observation
    (DiscreteComm with a fresh key a step, the port with its noise), the
    port's served policy on the env's obs, through the kernels (the fused
    TarMAC step's plain version on the CPU) and the unfused path."""
    run_dir = EXP2_DIRS[run]
    config = json.loads((run_dir / "config.json").read_text())
    jp = jax_env.make_params("r400")
    jagent = jax_build_agent(31, jp.n_actions, SN(**{**JAX_DEFAULTS, **config["args"]}))
    params = checkpoint.load(serve.latest_checkpoint(run_dir))["model_state_dict"]
    agent, _ = serve.load_policy(run_dir, device="cpu")
    assert type(agent).__name__ == type(jagent).__name__
    policy = collect.make_policy(agent, "mlp")
    tp = torch_env.make_params("r400")
    ubs, gts, keys, prior = _worlds(jp, seed=4, map_id="r400")
    js = jax.vmap(lambda u, g, k: jax_env.reset_from_positions(jp, u, g, k))(
        jnp.asarray(ubs), jnp.asarray(gts), keys)
    ts = torch_env.reset_from_positions(tp, torch.from_numpy(ubs), torch.from_numpy(gts),
                                        torch.from_numpy(prior))

    def flat(obs):
        lead = obs["agent"].shape[:-1]
        return {"agent": jnp.concatenate([obs["agent"], obs["gt"].reshape(lead + (-1,)),
                                          obs["ubs"].reshape(lead + (-1,))], -1),
                "adj": obs["adj"]}
    japply = jax.jit(jagent.apply)
    jstep = jax.jit(jax.vmap(lambda s, a: jax_env.step(jp, s, a)))
    jh, th = jnp.zeros((2, jp.n_ubs, 256)), torch.zeros((2, jp.n_ubs, 256))
    key = jax.random.PRNGKey(4)
    with torch.no_grad():
        for _ in range(3):
            key, k_pol = jax.random.split(key)
            jq, jh_next = japply(params, flat(jax.vmap(lambda s: jax_env.get_obs(jp, s))(js)),
                                 jh, k_pol)
            noise = torch.from_numpy(np.array(jax.random.gumbel(
                k_pol, (2, jp.n_ubs, jp.n_ubs, 64, 2), jnp.float32)))
            obs = torch_env.get_obs(tp, ts)
            for use_kernels in (True, False):
                tq, th_next = policy(obs, th, use_kernels, noise)
                np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
                np.testing.assert_allclose(th_next.numpy(), np.asarray(jh_next), **TOL)
            jh, th = jh_next, th_next
            acts = np.array(jnp.argmax(jq, axis=-1))
            js, _, _, jrew, _ = jstep(js, jnp.asarray(acts))
            ts, _, trew, _ = torch_env.step(tp, ts, torch.from_numpy(acts))
            np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **TOL)
            ts = ts._replace(prior_gts=torch.from_numpy(np.asarray(js.prior_gts, np.int64)))


def test_exp2_runs_are_served_where_jax_optax_pandas_are_missing():
    """``serve`` on the committed exp2 iql+QMIX (``RnnAgent``) and TarMAC runs,
    in a subprocess with every module the GPU machine lacks blocked."""
    blocked = sorted(FORBIDDEN | {"jaxlib"})
    code = (
        "import sys, runpy\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        f"for run_dir in ({str(EXP2_DIRS['iql_qmix'])!r}, {str(EXP2_DIRS['tarmac'])!r}):\n"
        "    sys.argv = ['serve', '--run-dir', run_dir, '--episodes', '3', '--device', 'cpu']\n"
        "    runpy.run_module('uav_bs_ctrl_tpu_torch.serve', run_name='__main__')\n"
        f"assert not any(sys.modules.get(n) for n in {blocked!r})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    for line in out.stdout.strip().splitlines()[-2:]:
        stats = json.loads(line)
        assert set(stats) == {"TestEpRet", "TestFairIdx", "TestAvgGlobalUtility",
                              "TestTotalThroughput", "TestProbCollision"}
        assert all(np.isfinite(v) for v in stats.values())


EXP1_DIRS = {a: ROOT / "data" / f"exp1_fast_grp4_size5_{a}" / f"exp1_fast_grp4_size5_{a}_s0"
             for a in ("gnn", "rnn")}


@pytest.mark.parametrize("agent", sorted(EXP1_DIRS))
def test_exp1_checkpoint_teacher_forced_rollout_matches_jax(agent):
    """A committed exp1 run (epoch 50, hidden 256), five greedy steps of both
    single-UBS envs and both policies from held-out layouts with the UBS
    beside a GT group; the JAX agent on ``drqn/fused.py:_agent_apply``'s
    observation, the port's served policy on the env's, through the kernels'
    plain versions and the unfused path."""
    from uav_bs_ctrl_tpu.algos.drqn.config import DEFAULT_CONFIG as JAX_DRQN_DEFAULTS
    from uav_bs_ctrl_tpu.envs import jax_env_subs
    from uav_bs_ctrl_tpu.models.agents import DRQN_REGISTRY as JAX_DRQN_REGISTRY
    from uav_bs_ctrl_tpu_torch.algos import collect_subs
    from uav_bs_ctrl_tpu_torch.envs import torch_env_subs
    run_dir = EXP1_DIRS[agent]
    config = json.loads((run_dir / "config.json").read_text())
    jp = jax_env_subs.make_params(**config["env_kwargs"])
    tp = torch_env_subs.make_params(**config["env_kwargs"])
    shape = dict(agent=2, gt=4) if agent == "gnn" else 2 + 4 * jp.n_gts
    jagent = JAX_DRQN_REGISTRY[agent](shape, jp.n_actions,
                                      SN(**{**JAX_DRQN_DEFAULTS, **config["args"]}))
    params = checkpoint.load(serve.latest_checkpoint(run_dir))["model_state_dict"]
    tagent, _ = serve.load_policy(run_dir, device="cpu")
    assert type(tagent).__name__ == type(jagent).__name__
    policy = collect_subs.make_policy(tagent, agent)
    _, gts = serve.test_pool_subs(config["env_kwargs"], 0)
    gts = gts[:3].copy()
    ubs = gts[:, 0] + np.float32(25.0)
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    prior = np.stack([np.asarray(jax.random.permutation(k, jp.n_gts)) for k in keys])
    js = jax.vmap(lambda u, g, k: jax_env_subs.reset_from_positions(jp, u, g, k))(
        jnp.asarray(ubs), jnp.asarray(gts), keys)
    ts = torch_env_subs.reset_from_positions(tp, torch.from_numpy(ubs), torch.from_numpy(gts),
                                             torch.from_numpy(prior))

    def flat(obs):
        if agent == "gnn":
            return obs
        lead = obs["agent"].shape[:-1]
        return {"agent": jnp.concatenate([obs["agent"], obs["gt"].reshape(lead + (-1,))], -1)}
    japply = jax.jit(jagent.apply)
    jstep = jax.jit(jax.vmap(lambda s, a: jax_env_subs.step(jp, s, a)))
    jh, th = jnp.zeros((3, 1, 256)), torch.zeros((3, 1, 256))
    with torch.no_grad():
        for _ in range(5):
            jq, jh_next = japply(params, flat(jax.vmap(lambda s: jax_env_subs.get_obs(jp, s))(js)),
                                 jh)
            obs = torch_env_subs.get_obs(tp, ts)
            for use_kernels in (True, False):
                tq, th_next = policy(obs, th, use_kernels)
                np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
                np.testing.assert_allclose(th_next.numpy(), np.asarray(jh_next), **TOL)
            jh, th = jh_next, th_next
            acts = np.array(jnp.argmax(jq, axis=-1))[:, 0]
            js, _, jrew, _ = jstep(js, jnp.asarray(acts))
            ts, _, trew, _ = torch_env_subs.step(tp, ts, torch.from_numpy(acts))
            np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **TOL)
            ts = ts._replace(prior_gts=torch.from_numpy(np.asarray(js.prior_gts, np.int64)))
    assert float(ts.ep_ret.min()) > 0


def test_exp1_runs_are_served_and_trained_where_jax_optax_pandas_are_missing():
    """``serve`` on both committed exp1 runs and ``train --tiny`` on the gnn
    run (2 worlds, the ring of two episodes, one update at B = 2), in a
    subprocess with every module the GPU machine lacks blocked; then an exp1
    run refuses ``--gat-backend``."""
    blocked = sorted(FORBIDDEN | {"jaxlib"})
    code = (
        "import sys, runpy\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        f"for run_dir in ({str(EXP1_DIRS['gnn'])!r}, {str(EXP1_DIRS['rnn'])!r}):\n"
        "    sys.argv = ['serve', '--run-dir', run_dir, '--episodes', '3', '--device', 'cpu']\n"
        "    runpy.run_module('uav_bs_ctrl_tpu_torch.serve', run_name='__main__')\n"
        f"sys.argv = ['train', '--run-dir', {str(EXP1_DIRS['gnn'])!r}, '--iterations', '1',"
        " '--device', 'cpu', '--tiny', '--n-layouts', '8']\n"
        "runpy.run_module('uav_bs_ctrl_tpu_torch.train', run_name='__main__')\n"
        f"assert not any(sys.modules.get(n) for n in {blocked!r})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    test_keys = {"TestEpRet", "TestFairIdx", "TestAvgGlobalUtility", "TestTotalThroughput"}
    lines = [json.loads(line) for line in out.stdout.strip().splitlines() if line.startswith("{")]
    assert len(lines) == 3
    for stats in lines[:2]:
        assert set(stats) == test_keys and all(np.isfinite(v) for v in stats.values())
        assert stats["TestEpRet"] > 50          # the trained policies (an untrained one: ~8)
    assert set(lines[2]) == {"LossQ", "EpRet", "FairIdx", "AvgGlobalUtility"} | test_keys
    assert all(np.isfinite(v) for v in lines[2].values())
    with pytest.raises(ValueError, match="gat_backend"):
        serve.load_policy(EXP1_DIRS["gnn"], device="cpu", gat_backend="pallas")
