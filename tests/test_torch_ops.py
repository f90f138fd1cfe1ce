"""The port's ops against the JAX package: masked softmax and the plain
versions of the two CUDA kernels (the JAX Pallas kernels run in interpret mode).

Tolerance: 1e-5 (f32, small widths, sums taken in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uav_bs_ctrl_tpu.ops import masked as jmasked
from uav_bs_ctrl_tpu.ops import pallas_kernels as jpk
from uav_bs_ctrl_tpu.ops import step_kernels as jsk
from uav_bs_ctrl_tpu_torch.device import resolve_device
from uav_bs_ctrl_tpu_torch.ops import gat_kernels, step_kernels
from uav_bs_ctrl_tpu_torch.ops.masked import NEG_BIG, masked_softmax

TOL = dict(atol=1e-5, rtol=1e-5)
STEP_ORDER = ("wv", "bv", "ws", "bs", "wq", "bq", "wi", "wh", "bi", "bh",
              "wo", "bo", "wvh", "bvh")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_masked_softmax_matches_jax(dim):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 5, 6)).astype(np.float32)
    mask = rng.random((4, 5, 6)) > 0.5
    index = [slice(None)] * 3
    index[(dim + 1) % 3] = 0
    mask[tuple(index)] = False          # whole rows along ``dim`` fully masked
    want = np.asarray(jmasked.masked_softmax(jnp.asarray(x), jnp.asarray(mask), dim))
    got = masked_softmax(_t(x), torch.from_numpy(mask), dim).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[tuple(index)] == 0.0)


def _gat_case(rng, n, m, d, heads, f, cut=0.4):
    """Slots valid where a uniform draw exceeds ``cut`` (1 - cut of them)."""
    hf = heads * f
    mask = rng.random((n, m)) > cut
    mask[1:2] = False                   # a fully masked destination
    return dict(x=rng.normal(size=(n, m, d)).astype(np.float32),
                w=(rng.normal(size=(d, hf)) / np.sqrt(d)).astype(np.float32),
                b=rng.normal(size=hf).astype(np.float32),
                er=rng.normal(size=(n, hf)).astype(np.float32),
                attn=rng.normal(size=(heads, f)).astype(np.float32),
                mask=mask.astype(np.float32))


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("n,m,d", [(13, 7, 2), (10, 50, 4)])
def test_flash_gat_fused_plain_matches_jax(n, m, d, mxu):
    heads, f = 4, 8
    c = _gat_case(np.random.default_rng(n * m), n, m, d, heads, f)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    out_k, m_k, l_k = jpk.flash_gat_fused(j["x"], j["w"], j["b"], j["er"], j["attn"],
                                          j["mask"], heads, interpret=True,
                                          return_stats=True, mxu=mxu)
    out_r = jpk.flash_gat_fused_reference(j["x"], j["w"], j["b"], j["er"], j["attn"],
                                          j["mask"] > 0, heads)
    out, mstat, lstat = gat_kernels.flash_gat_fused_plain(
        *(_t(c[k]) for k in ("x", "w", "b", "er", "attn", "mask")), heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_k), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), **TOL)
    np.testing.assert_allclose(mstat.numpy(), np.asarray(m_k), **TOL)
    np.testing.assert_allclose(lstat.numpy(), np.asarray(l_k), **TOL)
    assert np.all(out.numpy()[1] == 0.0)


def test_kernel_wrappers_run_plain_on_cpu_without_launching():
    rng = np.random.default_rng(3)
    c = _gat_case(rng, 9, 7, 2, 4, 8)
    args = [_t(c[k]) for k in ("x", "w", "b", "er", "attn", "mask")]
    before = gat_kernels.flash_gat_fused.launches
    got = gat_kernels.flash_gat_fused(*args, 4)
    want = gat_kernels.flash_gat_fused_plain(*args, 4)
    assert gat_kernels.flash_gat_fused.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    x, h, adjf, wt = _step_case(rng, 3, 4, 16, 8, 4, 5)
    before = step_kernels.tarmac_step.launches
    got = step_kernels.tarmac_step(_t(x), _t(h), _t(adjf), *(_t(wt[k]) for k in STEP_ORDER),
                                   4, 4, True)
    want = step_kernels.tarmac_step_plain(_t(x), _t(h), _t(adjf),
                                          *(_t(wt[k]) for k in STEP_ORDER), 4, 4, True)
    assert step_kernels.tarmac_step.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _step_case(rng, w, a, hidden, msg, key, n_act):
    """Asymmetric random talk graph with self-loops, except one destination
    (world 0, agent 1) that has no in-edge at all."""
    adjf = (rng.random((w * a, a)) > 0.4).astype(np.float32)
    adjf[np.arange(w * a), np.arange(w * a) % a] = 1.0
    adjf[0:a, 1] = 0.0
    lin = lambda i, o: (0.3 * rng.normal(size=(i, o))).astype(np.float32)
    vec = lambda o: (0.3 * rng.normal(size=o)).astype(np.float32)
    wt = dict(wv=lin(2 * hidden, msg), bv=vec(msg), ws=lin(2 * hidden, key), bs=vec(key),
              wq=lin(2 * hidden, key), bq=vec(key), wi=lin(hidden + msg, 3 * hidden),
              wh=lin(hidden, 3 * hidden), bi=vec(3 * hidden), bh=vec(3 * hidden),
              wo=lin(hidden, n_act), bo=vec(n_act), wvh=lin(hidden, 1), bvh=vec(1))
    x = rng.normal(size=(w * a, hidden)).astype(np.float32)
    h = rng.normal(size=(w * a, hidden)).astype(np.float32)
    return x, h, adjf, wt


@pytest.mark.parametrize("dueling", [False, True])
def test_tarmac_step_plain_matches_jax(dueling):
    w, a, hidden, msg, key, n_act = 5, 4, 32, 16, 8, 7
    x, h, adjf, wt = _step_case(np.random.default_rng(int(dueling)), w, a, hidden, msg, key, n_act)
    assert not np.array_equal(adjf.reshape(w, a, a), adjf.reshape(w, a, a).transpose(0, 2, 1))
    jargs = [jnp.asarray(wt[k]) for k in STEP_ORDER]
    q_k, h_k = jsk.tarmac_step(jnp.asarray(x), jnp.asarray(h), jnp.asarray(adjf), *jargs,
                               a, key, dueling, interpret=True)
    q_r, h_r = jsk.tarmac_step_reference(jnp.asarray(x), jnp.asarray(h), jnp.asarray(adjf),
                                         *jargs, a=a, key_size=key, dueling=dueling)
    q, h2 = step_kernels.tarmac_step_plain(_t(x), _t(h), _t(adjf),
                                           *(_t(wt[k]) for k in STEP_ORDER), a, key, dueling)
    for got, want in ((q, q_k), (q, q_r), (h2, h_k), (h2, h_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture
def cuda_device():
    """The card, with float32 products in full precision; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d,heads,f,cut", [
    (320, 7, 2, 4, 32, 0.4), (13, 50, 4, 4, 32, 0.4),
    (256, 50, 4, 4, 64, 0.62), (256, 7, 2, 4, 64, 0.62),   # the update's shapes, ~38 % valid
    (37, 50, 4, 2, 128, 0.62), (1, 50, 4, 4, 64, 0.62),
    (37, 33, 2, 2, 128, -1.0), (1, 7, 2, 2, 128, -1.0),    # every slot valid (row 1 aside)
    (37, 50, 4, 4, 64, 1.0)])                              # every slot masked
def test_flash_gat_fused_kernel_matches_plain(cuda_device, n, m, d, heads, f, cut):
    """Also: rows with no valid slot give out 0, m -1e30 and l 0, and a repeat is
    bit-identical."""
    c = _gat_case(np.random.default_rng(m), n, m, d, heads, f, cut)
    args = [_t(c[k]).to(cuda_device) for k in ("x", "w", "b", "er", "attn", "mask")]
    before = gat_kernels.flash_gat_fused.launches
    got = gat_kernels.flash_gat_fused(*args, heads)
    assert gat_kernels.flash_gat_fused.launches == before + 1
    for g, w in zip(got, gat_kernels.flash_gat_fused_plain(*args, heads)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    empty = args[5].sum(1) == 0
    assert torch.all(got[0][empty] == 0) and torch.all(got[1][empty] == NEG_BIG)
    assert torch.all(got[2][empty] == 0)
    assert all(torch.equal(a, b) for a, b in zip(got, gat_kernels.flash_gat_fused(*args, heads)))


@pytest.mark.cuda
@pytest.mark.parametrize("dueling", [False, True])
def test_tarmac_step_kernel_matches_plain(cuda_device, dueling):
    x, h, adjf, wt = _step_case(np.random.default_rng(7), 5, 8, 64, 16, 8, 9)
    args = [_t(a).to(cuda_device) for a in (x, h, adjf)] + \
        [_t(wt[k]).to(cuda_device) for k in STEP_ORDER]
    got = step_kernels.tarmac_step(*args, 8, 8, dueling)
    for g, w in zip(got, step_kernels.tarmac_step_plain(*args, 8, 8, dueling)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
