"""The backward kernels' plain versions against the JAX package's custom VJPs.

``flash_gat_fused_bwd_plain`` against ``jax.vjp`` of
``pallas_kernels.flash_gat_fused_train`` (interpret mode, ``need_dx`` and
``mxu`` on and off) and against torch autograd through
``flash_gat_fused_plain``; ``tarmac_step_bwd_plain`` against ``jax.vjp`` of
``step_kernels.tarmac_step_train`` (interpret mode) and of
``tarmac_step_reference``, dueling on and off. Every case has a fully masked
row or a destination with no in-edge. Small widths; tolerance 1e-5 (f32, sums
taken in another order). The CUDA kernels are held against these plain
versions on the card by ``tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uav_bs_ctrl_tpu.ops import pallas_kernels as jpk
from uav_bs_ctrl_tpu.ops import step_kernels as jsk
from uav_bs_ctrl_tpu_torch.ops import gat_kernels, step_kernels

TOL = dict(atol=1e-5, rtol=1e-5)
GAT_ORDER = ("x", "w", "b", "er", "attn", "mask")
STEP_ORDER = ("wv", "bv", "ws", "bs", "wq", "bq", "wi", "wh", "bi", "bh",
              "wo", "bo", "wvh", "bvh")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _gat_case(rng, n, m, d, heads, f):
    hf = heads * f
    mask = rng.random((n, m)) > 0.4
    mask[1] = False                     # a fully masked destination
    return dict(x=rng.normal(size=(n, m, d)).astype(np.float32),
                w=(rng.normal(size=(d, hf)) / np.sqrt(d)).astype(np.float32),
                b=(0.3 * rng.normal(size=hf)).astype(np.float32),
                er=rng.normal(size=(n, hf)).astype(np.float32),
                attn=(rng.normal(size=(heads, f)) / np.sqrt(f)).astype(np.float32),
                mask=mask.astype(np.float32),
                g=rng.normal(size=(n, hf)).astype(np.float32))


def _gat_plain_bwd(c, heads, need_dx):
    args = [_t(c[k]) for k in GAT_ORDER]
    out, mstat, lstat = gat_kernels.flash_gat_fused_plain(*args, heads)
    return gat_kernels.flash_gat_fused_bwd_plain(*args, out, mstat, lstat, _t(c["g"]), heads,
                                                 need_dx=need_dx)


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("n,m,d", [(13, 7, 2), (10, 20, 4)])
def test_flash_gat_fused_bwd_plain_matches_jax_vjp(n, m, d, mxu, need_dx):
    heads, f = 4, 8
    c = _gat_case(np.random.default_rng(n * m + d), n, m, d, heads, f)
    mask = jnp.asarray(c["mask"])

    def fn(x, w, b, er, attn):
        return jpk.flash_gat_fused_train(x, w, b, er, attn, mask, heads, 0.2, 8, 128,
                                         True, mxu, need_dx)

    _, vjp = jax.vjp(fn, *(jnp.asarray(c[k]) for k in GAT_ORDER[:5]))
    want = vjp(jnp.asarray(c["g"]))
    dx, dw, db, der, dattn = _gat_plain_bwd(c, heads, need_dx)
    for got, w in ((dw, want[1]), (db, want[2]), (der, want[3]), (dattn, want[4])):
        assert tuple(got.shape) == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)
    if need_dx:
        np.testing.assert_allclose(dx.numpy(), np.asarray(want[0]), **TOL)
    else:
        assert dx is None
    assert np.all(der.numpy()[1] == 0.0)           # the fully masked row adds nothing


@pytest.mark.parametrize("n,m,d", [(13, 7, 2), (10, 50, 4)])
def test_flash_gat_fused_bwd_plain_matches_torch_autograd(n, m, d):
    heads, f = 4, 8
    c = _gat_case(np.random.default_rng(7 * m), n, m, d, heads, f)
    args = [_t(c[k]).requires_grad_(k != "mask") for k in GAT_ORDER]
    out, _, _ = gat_kernels.flash_gat_fused_plain(*args, heads)
    want = torch.autograd.grad(out, args[:5], _t(c["g"]))
    got = _gat_plain_bwd(c, heads, need_dx=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_flash_gat_fused_train_function_on_cpu():
    """Autograd through the Function equals the plain backward; dx only when
    x requires grad; the mask gets none."""
    heads, f = 4, 8
    c = _gat_case(np.random.default_rng(1), 9, 7, 2, heads, f)
    for x_grad in (False, True):
        args = [_t(c[k]) for k in GAT_ORDER]
        for k, a in enumerate(args[:5]):
            a.requires_grad_(k > 0 or x_grad)
        out = gat_kernels.flash_gat_fused_train(*args, heads)
        out.backward(_t(c["g"]))
        want = _gat_plain_bwd(c, heads, need_dx=True)
        assert (args[0].grad is not None) == x_grad and args[5].grad is None
        for a, w in zip(args[int(not x_grad):5], want[int(not x_grad):]):
            torch.testing.assert_close(a.grad, w, atol=0, rtol=0)


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
    h = np.tanh(rng.normal(size=(w * a, hidden))).astype(np.float32)
    gq = rng.normal(size=(w * a, n_act)).astype(np.float32)
    gh2 = rng.normal(size=(w * a, hidden)).astype(np.float32)
    return x, h, adjf, wt, gq, gh2


@pytest.mark.parametrize("dueling", [False, True])
def test_tarmac_step_bwd_plain_matches_jax_vjp(dueling):
    w, a, hidden, msg, key, n_act = 5, 4, 32, 16, 8, 7
    x, h, adjf, wt, gq, gh2 = _step_case(np.random.default_rng(10 + dueling), w, a, hidden,
                                         msg, key, n_act)
    primals = [jnp.asarray(v) for v in (x, h, adjf)] + [jnp.asarray(wt[k]) for k in STEP_ORDER]
    cot = (jnp.asarray(gq), jnp.asarray(gh2))
    kern = lambda *p: jsk.tarmac_step_train(*p, a, key, dueling, None, True)
    ref = lambda *p: jsk.tarmac_step_reference(*p, a=a, key_size=key, dueling=dueling)
    got = step_kernels.tarmac_step_bwd_plain(_t(x), _t(h), _t(adjf),
                                             *(_t(wt[k]) for k in STEP_ORDER),
                                             _t(gq), _t(gh2), a, key, dueling)
    assert len(got) == 16
    for fn in (kern, ref):
        want = jax.vjp(fn, *primals)[1](cot)
        want = want[:2] + want[3:]                  # adjf gets no gradient
        for name, g, wnt in zip(("dx", "dh") + tuple("d" + k for k in STEP_ORDER), got, want):
            assert tuple(g.shape) == wnt.shape, name
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), err_msg=name, **TOL)
    if not dueling:
        assert not got[14].any() and not got[15].any()


@pytest.mark.parametrize("dueling", [False, True])
def test_tarmac_step_train_function_on_cpu(dueling):
    """Autograd through the Function equals autograd through the plain
    forward (with h stop-gradient into v/s/q)."""
    x, h, adjf, wt, gq, gh2 = _step_case(np.random.default_rng(20 + dueling), 3, 4, 16, 8,
                                         4, 5)
    grads = []
    for fn in (step_kernels.tarmac_step_train, step_kernels.tarmac_step_plain):
        args = [_t(x).requires_grad_(), _t(h).requires_grad_(), _t(adjf)] + \
            [_t(wt[k]).requires_grad_() for k in STEP_ORDER]
        q, h2 = fn(*args, 4, 4, dueling)
        torch.autograd.backward((q, h2), (_t(gq), _t(gh2)))
        grads.append([a.grad for i, a in enumerate(args) if i != 2])
        assert args[2].grad is None
    for g, w in zip(*grads):
        if w is None:                               # the unused dueling head
            assert not dueling and not g.any()
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
