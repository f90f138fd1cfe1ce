"""The port's checkpoint writer against the JAX package's reader.

A file the port writes (``RecurrentQLearner.save_checkpoint``) holds the JAX
package's keys, layout and optax optimizer state: the port resumes it and
repeats the next update bit for bit; the JAX learner's own
``load_checkpoint`` reads it, its params give the JAX agent the port's Q, and
JAX's next update from it matches the port's (which shows that the AdamW
moments and count went into optax's state right); the file names no class
but numpy's and optax's three; and the port re-writes the committed JAX
checkpoint leaf for leaf.

Tolerances: bit for bit within the port and for the re-written file; the
JAX agent's Q 1e-5; JAX's next update under ``test_torch_update.py``'s rules
(LossQ 1e-5 relative, grads and mu 1e-5 of the group's largest raw gradient,
params 1e-5 where the raw gradient is resolved).
"""

import io
import json
import pickle
import pickletools
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from test_torch_update import (A_DBG, DS_DBG, HID, K_DBG, M_DBG, TOL, _batch,
                               _check_first_update, _env_info, _jax_first_update, _kw,
                               _learners, _torch_tree)
from uav_bs_ctrl_tpu.models import modules as jmodules
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import make_args
from uav_bs_ctrl_tpu_torch.models.modules import MLP
from uav_bs_ctrl_tpu_torch.utils import checkpoint
from uav_bs_ctrl_tpu_torch.utils.convert import flatten, params_from_jax, params_to_jax

ROOT = Path(__file__).resolve().parents[1]
RUN_DIR = (ROOT / "data" / "exp3_fast_8ubs_tarmac_qmix_il10_lay64k"
           / "exp3_fast_8ubs_tarmac_qmix_il10_lay64k_s0")
T, B = 5, 4
OPTAX_NAMES = {("optax.schedules._inject", "InjectStatefulHyperparamsState"),
               ("optax._src.transform", "ScaleByAdamState"),
               ("optax._src.base", "EmptyState")}


def _batches(seed, n):
    rng = np.random.default_rng(seed)
    return [_batch(rng, B, T, A_DBG, M_DBG, K_DBG, DS_DBG, HID, 1) for _ in range(n)]


def _trained_port_learner(seed=0):
    """A port learner after three updates and two LR-scheduler steps."""
    learner = MultiAgentQLearner(_env_info(t=T), make_args(_kw(True, False), device="cpu"),
                                 seed=seed)
    for batch in _batches(7, 3):
        learner.update_on_batch(_torch_tree(batch))
    learner.step_lr_scheduler()
    learner.step_lr_scheduler()
    return learner


def _state(learner):
    """Params, targets and AdamW state of every parameter, as tensors."""
    out = {f"{m}.{k}": v for m, sd in learner.state_dict().items() if isinstance(sd, dict)
           and m != "optimizer" for k, v in sd.items()}
    for i, p in enumerate(learner.parameters()):
        for k, v in learner.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v
    return out


def _assert_same_bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_save_then_load_repeats_the_next_update_bit_for_bit(tmp_path):
    """Save, load into a fresh learner of another seed, and take the next
    update in both; a resume resets the targets to the params (JAX
    ``core.py:361``), so the saving learner does the same before its update."""
    saver = _trained_port_learner()
    path = tmp_path / "checkpoint_epoch2.pt"
    saver.save_checkpoint(path, dict(epoch=2, t=1000))
    loader = MultiAgentQLearner(_env_info(t=T), make_args(_kw(True, False), device="cpu"),
                                seed=3)
    assert loader.load_checkpoint(path) == {"epoch": 2, "t": 1000}
    saver.target_net.load_state_dict(saver.net.state_dict())
    saver.target_mixer.load_state_dict(saver.mixer.state_dict())
    assert (loader.lr_scale, loader._epoch) == (saver.lr_scale, saver._epoch) == (0.98, 2)
    _assert_same_bits(_state(loader), _state(saver))
    assert loader.optimizer.state[loader.parameters()[0]]["step"].item() == 3

    batch = _torch_tree(_batches(8, 1)[0])
    got, want = loader.update_on_batch(batch), saver.update_on_batch(batch)
    assert got["LossQ"].item() == want["LossQ"].item()
    _assert_same_bits(_state(loader), _state(saver))


def test_jax_learner_resumes_a_port_file_and_takes_the_same_next_update(tmp_path):
    """JAX ``load_checkpoint`` on a port-written file: stamp, LR scale,
    optax's count; the loaded params give the JAX agent the port's Q; then
    JAX's ``_update_jit`` from that state and the port's next update from the
    same file, on one batch."""
    jl, _ = _learners(_kw(True, False), _env_info(t=T), seed=1)
    port = _trained_port_learner()
    path = tmp_path / "checkpoint_epoch2.pt"
    port.save_checkpoint(path, dict(epoch=2, t=1000))
    stamp = jl.load_checkpoint(str(path))
    assert (int(stamp["epoch"]), int(stamp["t"])) == (2, 1000)
    assert float(jl.lr_scale) == port.lr_scale and int(jl._epoch) == 2
    assert int(jl.opt_state.count) == int(jl.opt_state.inner_state[0].count) == 3
    port.load_checkpoint(path)

    batch = _batches(8, 1)[0]
    obs = {k: v[:, 0] for k, v in batch["obs"].items()}
    q_want, h_want = jl.agent.apply(jl.params["net"], jax.tree_util.tree_map(jnp.asarray, obs),
                                    jnp.asarray(batch["h"][:, 0]))
    with torch.no_grad():
        q, h = port.net(_torch_tree(obs), torch.from_numpy(batch["h"][:, 0]))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_want), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), **TOL)

    want = _jax_first_update(jl, jax.tree_util.tree_map(jnp.asarray, batch))
    _check_first_update(port, want, batch, True, TOL, scaled=True)


def _globals(data):
    """Every (module, name) the pickle resolves, and the GLOBAL opcodes'."""
    opcodes = {tuple(arg.split(" ", 1)) for op, arg, _ in pickletools.genops(data)
               if op.name == "GLOBAL"}
    resolved = set()

    class Recorder(checkpoint._NumpyOnlyUnpickler):
        def find_class(self, module, name):
            resolved.add((module, name))
            return super().find_class(module, name)

    Recorder(io.BytesIO(data)).load()
    return opcodes, resolved


def test_a_port_file_names_only_numpy_and_the_three_optax_classes(tmp_path):
    path = tmp_path / "checkpoint_epoch2.pt"
    _trained_port_learner().save_checkpoint(path, dict(epoch=2, t=1000))
    data = path.read_bytes()
    ops = {op.name for op, _, _ in pickletools.genops(data)}
    assert not ops & {"INST", "OBJ", "EXT1", "EXT2", "EXT4", "PERSID", "BINPERSID"}
    opcodes, resolved = _globals(data)
    assert opcodes == OPTAX_NAMES
    numpy_side = resolved - OPTAX_NAMES
    assert OPTAX_NAMES <= resolved and numpy_side
    assert all(m.split(".")[0] == "numpy" and n in checkpoint._NUMPY_GLOBALS
               for m, n in numpy_side), numpy_side


def test_port_rewrites_the_committed_checkpoint_leaf_for_leaf(tmp_path):
    """Load the committed exp3 8-UBS checkpoint (full width) into the port and
    save it: under optax the two files unpickle to the same tree structure
    with equal leaves (the learning rate, lr x lr_scale, rounded alike)."""
    config = json.loads((RUN_DIR / "config.json").read_text())
    env_info = dict(obs_shape={"agent": 2, "gt": 4, "ubs": 2}, state_shape=216, n_actions=9,
                    n_agents=8, episode_limit=50)
    learner = MultiAgentQLearner(env_info, make_args(config["args"], device="cpu"))
    stamp = learner.load_checkpoint(RUN_DIR / "checkpoint_epoch200.pt")
    path = tmp_path / "checkpoint_epoch200.pt"
    learner.save_checkpoint(path, stamp)
    with open(RUN_DIR / "checkpoint_epoch200.pt", "rb") as f:
        want = pickle.load(f)
    with open(path, "rb") as f:
        got = pickle.load(f)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert type(got["optimizer_state_dict"]) is type(want["optimizer_state_dict"])
    for (p, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                              jax.tree_util.tree_leaves_with_path(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(p)
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(p))


def test_params_to_jax_inverts_params_from_jax_with_list_levels():
    """An MLP's ``layers`` are a list in the JAX tree and a ModuleList in the
    port: the round trip gives the JAX tree back, list and all."""
    tree = jax.tree_util.tree_map(np.asarray, jmodules.mlp_init(jax.random.PRNGKey(0), 3, 8, 3))
    mlp = MLP(3, 8, 3)
    mlp.load_state_dict(params_from_jax(tree, mlp))
    back = params_to_jax(mlp.state_dict())
    assert isinstance(back["layers"], list) and len(back["layers"]) == 3
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for k, v in flatten(tree).items():
        np.testing.assert_array_equal(flatten(back)[k], v)
