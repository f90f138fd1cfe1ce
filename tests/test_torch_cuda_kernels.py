"""The backward CUDA kernels and ``flash_gat`` against their plain versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has no JAX: ``python -m pytest --noconftest
tests/test_torch_cuda_kernels.py -q``. Without a card every test skips.
Tolerance: 1e-4 of each output's largest entry (f32, sums taken in another
order); a second launch on the same inputs must give bit-identical outputs
(the kernels reduce across CTAs in a fixed order, with no atomics).
"""

import numpy as np
import pytest
import torch

from uav_bs_ctrl_tpu_torch.ops import gat_kernels, step_kernels

GAT_ORDER = ("x", "w", "b", "er", "attn", "mask")
STEP_ORDER = ("wv", "bv", "ws", "bs", "wq", "bq", "wi", "wh", "bi", "bh",
              "wo", "bo", "wvh", "bvh")


@pytest.fixture
def cuda_device():
    """The card, with float32 products in full precision; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _on(device, a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _gat_case(device, rng, n, m, d, heads, f):
    hf = heads * f
    mask = rng.random((n, m)) > 0.4
    mask[1] = False                     # a fully masked destination
    case = dict(x=rng.normal(size=(n, m, d)), w=rng.normal(size=(d, hf)) / np.sqrt(d),
                b=0.3 * rng.normal(size=hf), er=rng.normal(size=(n, hf)),
                attn=rng.normal(size=(heads, f)) / np.sqrt(f), mask=mask,
                g=rng.normal(size=(n, hf)))
    return {k: _on(device, v) for k, v in case.items()}


def _step_case(device, rng, w, a, hidden, msg, key, n_act):
    """Random talk graph with self-loops, except one destination (world 0,
    agent 1) that has no in-edge at all."""
    adjf = (rng.random((w * a, a)) > 0.4).astype(np.float32)
    adjf[np.arange(w * a), np.arange(w * a) % a] = 1.0
    adjf[0:a, 1] = 0.0
    lin = lambda i, o: rng.normal(size=(i, o)) / np.sqrt(i)
    vec = lambda o: 0.1 * rng.normal(size=o)
    case = dict(x=np.maximum(rng.normal(size=(w * a, hidden)), 0.0),
                h=np.tanh(rng.normal(size=(w * a, hidden))), adjf=adjf,
                wv=lin(2 * hidden, msg), bv=vec(msg), ws=lin(2 * hidden, key), bs=vec(key),
                wq=lin(2 * hidden, key), bq=vec(key), wi=lin(hidden + msg, 3 * hidden),
                wh=lin(hidden, 3 * hidden), bi=vec(3 * hidden), bh=vec(3 * hidden),
                wo=lin(hidden, n_act), bo=vec(n_act), wvh=lin(hidden, 1), bvh=vec(1),
                gq=rng.normal(size=(w * a, n_act)), gh2=rng.normal(size=(w * a, hidden)))
    return {k: _on(device, v) for k, v in case.items()}


def _assert_close_to_scale(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, what
            continue
        scale = max(1.0, w.abs().max().item())
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * scale, f"{what} output {i}: {err:.3e} beyond 1e-4 x {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("n,m,d", [(256, 50, 4), (256, 7, 2), (37, 50, 4)])
def test_flash_gat_fused_bwd_kernel_matches_plain(cuda_device, n, m, d, need_dx):
    c = _gat_case(cuda_device, np.random.default_rng(m + need_dx), n, m, d, 4, 64)
    args = [c[k] for k in GAT_ORDER]
    out, mstat, lstat = gat_kernels.flash_gat_fused(*args, 4)
    before = gat_kernels.flash_gat_fused_bwd.launches
    got = gat_kernels.flash_gat_fused_bwd(*args, out, mstat, lstat, c["g"], 4, need_dx=need_dx)
    assert gat_kernels.flash_gat_fused_bwd.launches == before + 1
    want = gat_kernels.flash_gat_fused_bwd_plain(*args, out, mstat, lstat, c["g"], 4,
                                                 need_dx=need_dx)
    _assert_close_to_scale(got, want, "flash_gat_fused_bwd")
    assert torch.all(got[3][1] == 0)                 # the fully masked row adds nothing
    again = gat_kernels.flash_gat_fused_bwd(*args, out, mstat, lstat, c["g"], 4,
                                            need_dx=need_dx)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,heads,f", [(160, 50, 4, 64), (160, 3, 4, 64), (37, 256, 2, 128),
                                         (9, 20, 4, 8)])
def test_flash_gat_kernel_matches_plain(cuda_device, n, m, heads, f):
    """Serving shapes (4-UBS: 50 GT slots, 3 UBS slots), several slot chunks,
    and F = 8 (heads padded to whole warps); an all-masked row gives 0."""
    rng = np.random.default_rng(n + m)
    mask = rng.random((n, m)) > 0.4
    mask[1] = False
    el = _on(cuda_device, rng.normal(size=(n, m, heads * f)))
    er = _on(cuda_device, rng.normal(size=(n, heads * f)))
    attn = _on(cuda_device, rng.normal(size=(heads, f)) / np.sqrt(f))
    maskf = _on(cuda_device, mask)
    before = gat_kernels.flash_gat.launches
    got = gat_kernels.flash_gat(el, er, attn, maskf, heads)
    assert gat_kernels.flash_gat.launches == before + 1
    _assert_close_to_scale([got], [gat_kernels.flash_gat_plain(el, er, attn, maskf, heads)],
                           "flash_gat")
    assert torch.all(got[1] == 0)
    assert torch.equal(got, gat_kernels.flash_gat(el, er, attn, maskf, heads))


@pytest.mark.cuda
@pytest.mark.parametrize("dueling", [False, True])
@pytest.mark.parametrize("w", [32, 5])
def test_tarmac_step_bwd_kernel_matches_plain(cuda_device, w, dueling):
    c = _step_case(cuda_device, np.random.default_rng(w), w, 8, 256, 64, 16, 9)
    args = [c[k] for k in ("x", "h", "adjf", *STEP_ORDER, "gq", "gh2")]
    before = step_kernels.tarmac_step_bwd.launches
    got = step_kernels.tarmac_step_bwd(*args, 8, 16, dueling)
    assert step_kernels.tarmac_step_bwd.launches == before + 1
    _assert_close_to_scale(got, step_kernels.tarmac_step_bwd_plain(*args, 8, 16, dueling),
                           "tarmac_step_bwd")
    again = step_kernels.tarmac_step_bwd(*args, 8, 16, dueling)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_autograd_functions_launch_the_kernels(cuda_device):
    """One backward through each Function launches its backward kernel once
    and gives the plain version's gradients."""
    c = _gat_case(cuda_device, np.random.default_rng(3), 64, 50, 4, 4, 64)
    args = [c[k].requires_grad_(k not in ("x", "mask")) for k in GAT_ORDER]
    before = gat_kernels.flash_gat_fused_bwd.launches
    gat_kernels.flash_gat_fused_train(*args, 4).backward(c["g"])
    assert gat_kernels.flash_gat_fused_bwd.launches == before + 1
    assert args[0].grad is None and args[5].grad is None
    out, mstat, lstat = gat_kernels.flash_gat_fused_plain(*(a.detach() for a in args), 4)
    want = gat_kernels.flash_gat_fused_bwd_plain(*(a.detach() for a in args), out, mstat,
                                                 lstat, c["g"], 4)
    _assert_close_to_scale([a.grad for a in args[1:5]], want[1:], "flash_gat_fused_train")

    c = _step_case(cuda_device, np.random.default_rng(4), 8, 8, 256, 64, 16, 9)
    args = [c[k].requires_grad_(k != "adjf") for k in ("x", "h", "adjf", *STEP_ORDER)]
    before = step_kernels.tarmac_step_bwd.launches
    q, h2 = step_kernels.tarmac_step_train(*args, 8, 16, False)
    torch.autograd.backward((q, h2), (c["gq"], c["gh2"]))
    assert step_kernels.tarmac_step_bwd.launches == before + 1
    want = step_kernels.tarmac_step_bwd_plain(*(a.detach() for a in args), c["gq"], c["gh2"],
                                              8, 16, False)
    got = [a.grad for i, a in enumerate(args) if i != 2]
    _assert_close_to_scale(got, want, "tarmac_step_train")
