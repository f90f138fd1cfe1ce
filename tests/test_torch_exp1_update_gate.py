"""exp1's update through the kernels against the plain path and JAX, at the
committed gnn run's full width (hidden 256, M = 20 GTs, L = 10) on a B = 2
batch of its own episodes: the state and batch at which rehearsing
``chip_smoke.py``'s exp1 phases on the CPU missed ``check_update``'s LossQ
gate (1e-5 relative) by 1.28e-5.

The two port paths differ only in ``DrqnGnnAgent.encode``: the kernel path's
GATv2 is ``flash_gat_fused_train`` (on the CPU its plain version), the plain
path the module's products; the GRU and the Q head are one code. Each path
is held to JAX's ``QLearner`` update on the same batch by
``tests/test_torch_drqn.py``'s rule (``_check_first_update``, scaled to the
group's largest raw gradient, at ``tests/test_torch_update.py``'s
full-width tolerance). The Q values reach |Q| ~ 50 while the TD errors are
~0.1-0.7, so one ulp of Q (3.8e-6) in every TD error moves LossQ by
``2 ulp / sqrt(LossQ)``, 3.1e-5 relative on this batch: both paths' Q are
within 2 ulps of each other and 8-9 of JAX's, their LossQ part by 1.28e-5,
and each is 3.9e-5 and 5.2e-5 from JAX's. The smoke's gate asks for less
than one ulp here; at the card's B = 32 the loss is the mean of 16 times as
many TD errors, whose roundoff partly cancels, and the gate holds.
"""

import json
from pathlib import Path
from types import SimpleNamespace as SN

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_drqn import _env_info
from test_torch_update import FULL_TOL, _check_first_update, _jax_first_update
from uav_bs_ctrl_tpu.algos.common import check_args_sanity as jax_check_args
from uav_bs_ctrl_tpu.algos.drqn.config import DEFAULT_CONFIG as JAX_DRQN_DEFAULTS
from uav_bs_ctrl_tpu.algos.drqn.learner import QLearner as JaxQLearner
from uav_bs_ctrl_tpu_torch import train
from uav_bs_ctrl_tpu_torch.algos.buffer import tree_map
from uav_bs_ctrl_tpu_torch.utils.convert import learner_params_to_jax

RUN_DIR = (Path(__file__).resolve().parents[1] / "data" / "exp1_fast_grp4_size5_gnn" /
           "exp1_fast_grp4_size5_gnn_s0")
B = 2
GATE_RTOL = 1e-5          # chip_smoke.UPDATE_LOSS_RTOL


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The smoke rehearsal's learner and batch: a 2-world port trainer of
    the committed run after its warm-ups and one iteration of 2 updates at
    B = 2, and a batch sampled from its ring; JAX's ``QLearner`` with the
    same params, targets and AdamW state (the port's checkpoint, which JAX
    loads, then the port's targets)."""
    trainer = train.build_trainer(RUN_DIR, "cpu", n_worlds=2, updates_per_iter=2, batch_size=B,
                                  capacity_chunks=200)
    for _ in range(train.N_WARMUPS):
        trainer.run_iteration(0.05, warmup=True)
    with torch.enable_grad():
        trainer.run_iteration(0.05)
    tl = trainer.learner
    batch = tree_map(lambda x: x.numpy().copy(), trainer.sample_batch())
    path = tmp_path_factory.mktemp("exp1_gate") / "checkpoint.pt"
    tl.save_checkpoint(path, dict(epoch=tl._epoch, t=0))
    config = json.loads((RUN_DIR / "config.json").read_text())
    kw = dict(config["args"], device="cpu", batch_size=B)
    jl = JaxQLearner(_env_info("gnn", config["env_kwargs"]),
                     jax_check_args(SN(**{**JAX_DRQN_DEFAULTS, **kw})))
    jl.load_checkpoint(str(path))
    targets = learner_params_to_jax({"net": dict(tl.target_net.named_parameters())})
    # Copies: JAX's update donates its inputs, which must not alias the port's tensors.
    jl.target_params = jax.tree_util.tree_map(lambda x: jnp.array(np.array(x)), targets)
    return jl, tl, batch


@pytest.fixture(scope="module")
def jax_side(case):
    """JAX's LossQ and Q of the taken actions [B, L, 1] on the batch, then
    its update (which donates the params, so it comes last)."""
    jl, _, batch = case
    jbatch = jax.tree_util.tree_map(jnp.array, batch)      # copies, as the targets'
    loss, q = jl._loss_fn(jl.params, jl.target_params, jbatch, jax.random.PRNGKey(0))
    return float(loss), np.array(q).transpose(1, 0, 2), _jax_first_update(jl, jbatch)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_both_paths_hold_to_jax(case, jax_side, use_kernels):
    """Each path's update against JAX's on the batch: LossQ, QVals, the
    clipped gradients and the AdamW moments (scaled to the group's largest
    raw gradient), params and targets where the gradient is resolved."""
    _, tl, batch = case
    _check_first_update(tl, jax_side[2], batch, use_kernels, FULL_TOL, scaled=True)


def test_paths_part_by_ulps_of_q_amplified_in_the_loss(case, jax_side):
    """The two paths' Q of the taken actions agree within 2 ulps of |Q|max
    and each is within 12 of JAX's. One ulp of |Q|max in every TD error
    moves LossQ by ``2 ulp / sqrt(LossQ)`` relative, which on this batch is
    above the smoke's 1e-5 gate: the gate asks for less than one ulp. The
    paths' LossQ part by at most that of 2 ulps on each side of the TD
    error, and each stays within that of 12 of JAX's."""
    _, tl, batch = case
    jloss, jq, _ = jax_side
    got = {}
    for use_kernels in (True, False):
        with torch.no_grad():
            loss, q = tl._loss(tree_map(torch.from_numpy, batch), use_kernels, None)
        got[use_kernels] = float(loss), q.numpy()
    ulp = float(np.spacing(np.float32(np.abs(jq).max())))
    assert np.abs(got[True][1] - got[False][1]).max() <= 2 * ulp
    for use_kernels in (True, False):
        assert np.abs(got[use_kernels][1] - jq).max() <= 12 * ulp
    loss = got[False][0]
    per_ulp = 2 * ulp / np.sqrt(loss)
    assert per_ulp > GATE_RTOL
    assert abs(got[True][0] - loss) / loss <= 2 * 2 * per_ulp
    for use_kernels in (True, False):
        assert abs(got[use_kernels][0] - jloss) / jloss <= 2 * 12 * per_ulp
