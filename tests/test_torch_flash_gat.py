"""``flash_gat`` (the JAX package's ``gat_backend='pallas'`` kernel) in the port:
its plain version against the JAX kernel (interpret mode) and its dense
twin ``flash_gat_reference``; the wrapper on the CPU; and the 'pallas'
GATv2 backend against the JAX dense GATv2 (JAX's own 'pallas' path needs a
TPU, and its tests hold ``flash_gat`` to the dense twin).

Tolerances as ``tests/test_pallas_kernels.py``: 2e-4 absolute and 1e-4
relative, 2e-3 and 1e-3 at x50 score magnitudes (f32 sums taken in another
order, scores of a few hundred); 1e-5 for the GATv2 layer at small width.
"""

from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uav_bs_ctrl_tpu.models import encoders as jenc
from uav_bs_ctrl_tpu.ops.pallas_kernels import flash_gat as jax_flash_gat
from uav_bs_ctrl_tpu.ops.pallas_kernels import flash_gat_reference
from uav_bs_ctrl_tpu_torch.models import encoders
from uav_bs_ctrl_tpu_torch.models.encoders import GATv2, GraphObservationEncoder
from uav_bs_ctrl_tpu_torch.ops import gat_kernels
from uav_bs_ctrl_tpu_torch.utils.convert import params_from_jax

TOL = dict(atol=2e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


def _case(rng, n, m, heads, f, scale=1.0):
    hf = heads * f
    mask = rng.random((n, m)) > 0.4
    mask[1] = False                          # an all-masked destination -> exact zeros
    return dict(el=(scale * rng.normal(size=(n, m, hf))).astype(np.float32),
                er=(scale * rng.normal(size=(n, hf))).astype(np.float32),
                attn=rng.normal(size=(heads, f)).astype(np.float32), mask=mask)


def _torch_args(c):
    return (torch.from_numpy(c["el"]), torch.from_numpy(c["er"]), torch.from_numpy(c["attn"]),
            torch.from_numpy(c["mask"]))


@pytest.mark.parametrize("n,m,heads,f,tile_m", [
    (16, 128, 4, 64, 128),     # the shapes of tests/test_pallas_kernels.py
    (10, 200, 4, 64, 128),
    (8, 256, 2, 128, 128),
    (4, 50, 4, 32, 32),
    (160, 50, 4, 64, 128),     # the 4-UBS serving call: 40 worlds x 4 agents, 50 GT slots
])
def test_flash_gat_plain_matches_jax_kernel_and_reference(n, m, heads, f, tile_m):
    c = _case(np.random.default_rng(n + m), n, m, heads, f)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    want_kernel = jax_flash_gat(j["el"], j["er"], j["attn"], j["mask"], heads, tile_n=8,
                                tile_m=tile_m, interpret=True)
    want_ref = flash_gat_reference(j["el"], j["er"], j["attn"], j["mask"], heads)
    got = gat_kernels.flash_gat_plain(*_torch_args(c), heads).numpy()
    np.testing.assert_allclose(got, np.asarray(want_kernel), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_ref), **TOL)
    assert np.all(got[1] == 0.0)


def test_flash_gat_plain_online_softmax_stability():
    """x50 score magnitudes: finite, and the JAX kernel's answer."""
    c = _case(np.random.default_rng(1), 8, 256, 2, 64, scale=50.0)
    c["mask"][:] = True
    j = {k: jnp.asarray(v) for k, v in c.items()}
    want = jax_flash_gat(j["el"], j["er"], j["attn"], j["mask"], 2, tile_n=8, tile_m=128,
                         interpret=True)
    got = gat_kernels.flash_gat_plain(*_torch_args(c), 2).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got, np.asarray(flash_gat_reference(
        j["el"], j["er"], j["attn"], j["mask"], 2)), atol=2e-3, rtol=1e-3)


def test_flash_gat_wrapper_runs_plain_on_cpu_and_refuses_autograd():
    c = _case(np.random.default_rng(2), 9, 7, 4, 8)
    args = _torch_args(c)
    mask_f = args[3].to(torch.float32)
    before = gat_kernels.flash_gat.launches
    got = gat_kernels.flash_gat(*args[:3], mask_f, 4)
    assert gat_kernels.flash_gat.launches == before
    assert torch.equal(got, gat_kernels.flash_gat_plain(*args, 4))
    el = args[0].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        gat_kernels.flash_gat(el, *args[1:3], mask_f, 4)
    with torch.no_grad():
        assert torch.equal(gat_kernels.flash_gat(el, *args[1:3], mask_f, 4), got)


def _load(module, tree):
    module.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, tree), module))
    return module.requires_grad_(False)


@pytest.mark.parametrize("n_slots", [6, 0])
def test_gatv2_pallas_backend_matches_jax_dense(n_slots):
    rng = np.random.default_rng(n_slots)
    heads, hidden = 4, 32
    p = jenc.gatv2_init(jax.random.PRNGKey(1), 4, 2, heads, hidden // heads)
    x_src = rng.normal(size=(3, 4, n_slots, 4)).astype(np.float32)
    x_dst = rng.normal(size=(3, 4, 2)).astype(np.float32)
    mask = rng.random((3, 4, n_slots)) > 0.4
    if n_slots:
        mask[0, 1] = False
    want = jenc.gatv2(p, x_src, x_dst, mask, heads, backend="dense")
    port = _load(GATv2(4, 2, heads, hidden // heads, backend="pallas"), p)
    got = port(torch.from_numpy(x_src), torch.from_numpy(x_dst), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_encoder_pallas_backend_launches_flash_gat_twice(monkeypatch):
    """Both relations go through flash_gat, and the output is the JAX dense
    encoder's."""
    rng = np.random.default_rng(4)
    shape = {"agent": 2, "gt": 4, "ubs": 2}
    gt = rng.normal(size=(3, 4, 6, 5)).astype(np.float32)
    gt[..., 0] = rng.random((3, 4, 6)) > 0.4
    ubs = rng.normal(size=(3, 4, 3, 3)).astype(np.float32)
    ubs[..., 0] = rng.random((3, 4, 3)) > 0.3
    obs = {"agent": rng.random((3, 4, 2)).astype(np.float32), "gt": gt, "ubs": ubs}
    enc = jenc.GraphObservationEncoder(shape, SN(hidden_size=32, n_heads=4, gat_backend="dense"))
    p = enc.init(jax.random.PRNGKey(2))
    port = _load(GraphObservationEncoder(shape, 32, 4, backend="pallas"), p)
    calls = []

    def recording(*args):
        calls.append(tuple(args[0].shape))
        return gat_kernels.flash_gat(*args)

    monkeypatch.setattr(encoders, "flash_gat", recording)
    got = port({k: torch.from_numpy(v) for k, v in obs.items()})
    assert calls == [(12, 6, 32), (12, 3, 32)]
    np.testing.assert_allclose(got.numpy(), np.asarray(enc.apply(p, obs)), **LAYER_TOL)
