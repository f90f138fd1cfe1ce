"""``check_args_sanity`` of the port rejects what the JAX package's rejects:
a ``matmul_precision`` outside None|'default'|'high'|'highest'
(``uav_bs_ctrl_tpu/algos/common.py:46-49``) and ``step_backend='pallas'``
with ``comm_backend='graph_parallel'`` (``:79-83``), and takes the four
precisions JAX takes. JAX's check runs only on rejected values: an accepted
'high' or 'highest' would set JAX's process-wide matmul precision for the
worker's later tests."""

from types import SimpleNamespace

import pytest

from uav_bs_ctrl_tpu.algos.common import check_args_sanity as jax_check_args
from uav_bs_ctrl_tpu.algos.madrqn.config import DEFAULT_CONFIG as JAX_DEFAULTS
from uav_bs_ctrl_tpu_torch.config import make_args

BASE = dict(o="gnn", c="tarmac")
REJECTED = {
    "matmul_precision": dict(BASE, matmul_precision="bogus"),
    "pallas_step_with_graph_parallel_comm": dict(BASE, step_backend="pallas",
                                                 comm_backend="graph_parallel"),
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_port_rejects_what_jax_rejects(name):
    config = REJECTED[name]
    with pytest.raises(ValueError):
        make_args(config, device="cpu")
    with pytest.raises(ValueError):
        jax_check_args(SimpleNamespace(**{**JAX_DEFAULTS, **config, "device": "cpu"}))


@pytest.mark.parametrize("precision", [None, "default", "high", "highest"])
def test_port_accepts_every_matmul_precision_jax_takes(precision):
    args = make_args(dict(BASE, matmul_precision=precision), device="cpu")
    assert args.matmul_precision == precision


def test_port_takes_the_pallas_step_with_dense_comm():
    args = make_args(dict(BASE, step_backend="pallas", comm_backend="dense"), device="cpu")
    assert (args.step_backend, args.comm_backend) == ("pallas", "dense")
