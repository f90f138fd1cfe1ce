"""The CUDA kernels against their plain versions, on the card: both backwards,
``flash_gat``, ``flash_gat_fused``, ``tarmac_step`` and the env scheduler
``env_schedule`` (held to ``env_kernels.compare_schedules``, its own rule).

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

from env_schedule_cases import SHAPES, WORLDS, edge_outcomes, make_case, params_of
from uav_bs_ctrl_tpu_torch.envs import torch_env
from uav_bs_ctrl_tpu_torch.ops import env_kernels, gat_kernels, step_kernels

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


def _gat_case(device, rng, n, m, d, heads, f, cut=0.4):
    """Slots valid where a uniform draw exceeds ``cut`` (1 - cut of them)."""
    hf = heads * f
    mask = rng.random((n, m)) > cut
    mask[1:2] = False                   # a fully masked destination
    case = dict(x=rng.normal(size=(n, m, d)), w=rng.normal(size=(d, hf)) / np.sqrt(d),
                b=0.3 * rng.normal(size=hf), er=rng.normal(size=(n, hf)),
                attn=rng.normal(size=(heads, f)) / np.sqrt(f), mask=mask,
                g=rng.normal(size=(n, hf)))
    return {k: _on(device, v) for k, v in case.items()}


def _step_case(device, rng, w, a, hidden, msg, key, n_act, empty_world=False):
    """Random talk graph with self-loops, except one destination (world 0,
    agent 1) that has no in-edge at all; with ``empty_world``, world 1 has no
    edge at all (no self-loops either)."""
    adjf = (rng.random((w * a, a)) > 0.4).astype(np.float32)
    adjf[np.arange(w * a), np.arange(w * a) % a] = 1.0
    adjf[0:a, 1] = 0.0
    if empty_world:
        adjf[a:2 * a] = 0.0
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


# n, m, d, heads, f, cut: the update's shapes ("seen" M = 50, D = 4; "near" M = 7, D = 2)
# at 60 % and about 38 % valid slots (the update's share), the 2x128 width, N = 1 and
# N = 37, every slot valid (row 1 aside) and every slot masked.
FUSED_CASES = [(256, 50, 4, 4, 64, 0.4), (256, 7, 2, 4, 64, 0.4), (37, 50, 4, 4, 64, 0.4),
               (256, 50, 4, 4, 64, 0.62), (256, 7, 2, 4, 64, 0.62), (37, 50, 4, 2, 128, 0.62),
               (1, 50, 4, 4, 64, 0.62), (37, 33, 2, 2, 128, -1.0), (1, 7, 2, 2, 128, -1.0),
               (37, 50, 4, 4, 64, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d,heads,f,cut", FUSED_CASES)
def test_flash_gat_fused_forward_kernel_matches_plain_and_repeats(cuda_device, n, m, d, heads,
                                                                  f, cut):
    """Tolerance 1e-4 (atol and rtol, f32 sums in another order); rows with no valid
    slot give out 0, m -1e30 and l 0 exactly."""
    c = _gat_case(cuda_device, np.random.default_rng(m), n, m, d, heads, f, cut)
    args = [c[k] for k in GAT_ORDER]
    got = gat_kernels.flash_gat_fused(*args, heads)
    for g, w in zip(got, gat_kernels.flash_gat_fused_plain(*args, heads)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    empty = args[5].sum(1) == 0
    assert torch.all(got[0][empty] == 0) and torch.all(got[1][empty] == -1e30)
    assert torch.all(got[2][empty] == 0)
    assert all(torch.equal(a, b) for a, b in zip(got, gat_kernels.flash_gat_fused(*args, heads)))


@pytest.mark.cuda
@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("n,m,d,heads,f,cut", FUSED_CASES)
def test_flash_gat_fused_bwd_kernel_matches_plain(cuda_device, n, m, d, heads, f, cut,
                                                  need_dx):
    c = _gat_case(cuda_device, np.random.default_rng(m + need_dx), n, m, d, heads, f, cut)
    args = [c[k] for k in GAT_ORDER]
    out, mstat, lstat = gat_kernels.flash_gat_fused(*args, heads)
    before = gat_kernels.flash_gat_fused_bwd.launches
    got = gat_kernels.flash_gat_fused_bwd(*args, out, mstat, lstat, c["g"], heads,
                                          need_dx=need_dx)
    assert gat_kernels.flash_gat_fused_bwd.launches == before + 1
    want = gat_kernels.flash_gat_fused_bwd_plain(*args, out, mstat, lstat, c["g"], heads,
                                                 need_dx=need_dx)
    _assert_close_to_scale(got, want, "flash_gat_fused_bwd")
    empty = args[5].sum(1) == 0                      # fully masked rows add nothing
    assert torch.all(got[3][empty] == 0)
    assert not need_dx or torch.all(got[0][empty] == 0)
    again = gat_kernels.flash_gat_fused_bwd(*args, out, mstat, lstat, c["g"], heads,
                                            need_dx=need_dx)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,heads,f,cut", [(160, 50, 4, 64, 0.4), (160, 50, 4, 64, 0.62),
                                             (160, 3, 4, 64, 0.4), (37, 256, 2, 128, 0.4),
                                             (9, 20, 4, 8, 0.4), (37, 50, 2, 96, 0.4)])
def test_flash_gat_kernel_matches_plain(cuda_device, n, m, heads, f, cut):
    """Serving shapes (4-UBS: 50 GT slots, 60 % and mid-episode's 38 % valid; 3 UBS
    slots), eight mask words (M = 256), and F = 8 and 96 (lanes beyond F guarded); an
    all-masked row gives 0."""
    rng = np.random.default_rng(n + m)
    mask = rng.random((n, m)) > cut
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
@pytest.mark.parametrize("empty_world", [False, True])
@pytest.mark.parametrize("dueling", [False, True])
@pytest.mark.parametrize("a", [8, 4])
@pytest.mark.parametrize("w", [32, 5, 512])
def test_tarmac_step_bwd_kernel_matches_plain(cuda_device, w, a, dueling, empty_world):
    """Training's A = 8 and the 4-UBS A = 4; W = 5 leaves R = W*A ragged
    against the kernel's 32-row tiles, W = 32 is the training batch, W = 512
    fills the card many times over."""
    c = _step_case(cuda_device, np.random.default_rng(w + a), w, a, 256, 64, 16, 9,
                   empty_world)
    args = [c[k] for k in ("x", "h", "adjf", *STEP_ORDER, "gq", "gh2")]
    before = step_kernels.tarmac_step_bwd.launches
    got = step_kernels.tarmac_step_bwd(*args, a, 16, dueling)
    assert step_kernels.tarmac_step_bwd.launches == before + 1
    _assert_close_to_scale(got, step_kernels.tarmac_step_bwd_plain(*args, a, 16, dueling),
                           "tarmac_step_bwd")
    again = step_kernels.tarmac_step_bwd(*args, a, 16, dueling)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("empty_world", [False, True])
@pytest.mark.parametrize("dueling", [False, True])
@pytest.mark.parametrize("a", [8, 4])
@pytest.mark.parametrize("w", [40, 5, 512])
def test_tarmac_step_kernel_matches_plain(cuda_device, w, a, dueling, empty_world):
    """The forward at training's A = 8 and the 4-UBS A = 4; W = 5 leaves R
    ragged against the 32-row product tiles and the 4-row head blocks, W = 40
    is the serving batch, W = 512 fills the card. World 0's agent 1 has no
    in-edge (c = 0 there); with ``empty_world`` world 1 has no edge at all."""
    c = _step_case(cuda_device, np.random.default_rng(w + a + 1), w, a, 256, 64, 16, 9,
                   empty_world)
    args = [c[k] for k in ("x", "h", "adjf", *STEP_ORDER)]
    before = step_kernels.tarmac_step.launches
    got = step_kernels.tarmac_step(*args, a, 16, dueling)
    assert step_kernels.tarmac_step.launches == before + 1
    _assert_close_to_scale(got, step_kernels.tarmac_step_plain(*args, a, 16, dueling),
                           "tarmac_step")
    again = step_kernels.tarmac_step(*args, a, 16, dueling)
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_env_schedule_kernel_matches_scatter_body_and_repeats(cuda_device, name):
    """One launch for every world, held to the scatter body on the same inputs:
    the same serving UBS and RB for every GT, rates within 1e-6 of the world's
    largest rate, the edge cases of ``env_schedule_cases.py``; a repeat bit
    for bit."""
    params = params_of(torch_env, name)
    case = make_case(params, WORLDS[name], seed=len(name) + 20)
    args = [torch.from_numpy(case[k]).to(cuda_device) for k in ("d", "gain", "prior")]
    before = env_kernels.schedule_and_rate.launches
    rate_gt, rate_ubs, assign = env_kernels.schedule_and_rate(params, *args,
                                                              with_assignment=True)
    assert env_kernels.schedule_and_rate.launches == before + 1
    sched, plain_gt, plain_ubs = torch_env._schedule_body_scatter(params, *args)
    res = env_kernels.compare_schedules(params, *args, (assign, rate_gt, rate_ubs),
                                        (env_kernels.schedule_assignment(sched), plain_gt,
                                         plain_ubs))
    assert not res["faults"] and res["err"] <= env_kernels.RATE_RTOL, res
    outcomes = edge_outcomes(params, case, assign.cpu())
    assert all(outcomes.values()), outcomes
    again = env_kernels.schedule_and_rate(params, *args, with_assignment=True)
    assert all(torch.equal(a, b) for a, b in zip(again, (rate_gt, rate_ubs, assign)))
    rates = torch_env._schedule(params, *args)
    assert rates[0] is None and torch.equal(rates[1], rate_gt)
    with pytest.raises(ValueError, match="not contiguous"):
        env_kernels.schedule_and_rate(params, args[0].transpose(1, 2).contiguous()
                                      .transpose(1, 2), *args[1:])
    with pytest.raises(TypeError, match="int64"):
        env_kernels.schedule_and_rate(params, args[0], args[1], args[2].to(torch.int32))
