"""The comm protocols, the masked reductions, the Gumbel-softmax sample and the
generic GNN agent step against the JAX package, with converted parameters.

Small widths (hidden 16, msg 8, key 4); inputs from a numpy seed; the
DiscreteComm Gumbel noise is JAX's own draw (``jax.random.gumbel`` of the
agent's key), handed to the port as a tensor. Tolerance 1e-5 (f32, sums taken
in another order).
"""

from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uav_bs_ctrl_tpu.models import agents as jagents
from uav_bs_ctrl_tpu.models import comm as jcomm
from uav_bs_ctrl_tpu.models import modules as jmod
from uav_bs_ctrl_tpu.ops import masked as jmasked
from uav_bs_ctrl_tpu_torch.algos import collect
from uav_bs_ctrl_tpu_torch.config import make_args
from uav_bs_ctrl_tpu_torch.models import comm
from uav_bs_ctrl_tpu_torch.models.agents import GnnAgent
from uav_bs_ctrl_tpu_torch.models.modules import gumbel_noise, gumbel_softmax
from uav_bs_ctrl_tpu_torch.ops import masked
from uav_bs_ctrl_tpu_torch.utils.convert import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
OBS_SHAPE = {"agent": 2, "gt": 4, "ubs": 2}
HID, MSG, KEY, N_ACT = 16, 8, 4, 9
W, A = 3, 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, tree):
    module.load_state_dict(params_from_jax(_np(tree), module))
    return module


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=what, **TOL)


def _talk(rng):
    """x, h and an asymmetric talk graph with self-loops, except one
    destination (world 0, agent 1) that hears no one."""
    adj = rng.random((W, A, A)) > 0.4
    adj[:, np.arange(A), np.arange(A)] = True
    adj[0, :, 1] = False
    x = np.maximum(rng.normal(size=(W, A, HID)), 0).astype(np.float32)
    h = np.tanh(rng.normal(size=(W, A, HID))).astype(np.float32)
    return adj, x, h


def _disc_noise(key):
    return np.array(jax.random.gumbel(key, (W, A, A, MSG, 2), jnp.float32))


@pytest.mark.parametrize("fn", ["masked_sum", "masked_mean", "masked_max"])
def test_masked_reductions_match_jax(fn):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 5, 6)).astype(np.float32)
    mask = rng.random((4, 5, 1)) > 0.5
    mask[2] = False                          # an empty row along dim 1 -> 0
    want = np.asarray(getattr(jmasked, fn)(jnp.asarray(x), jnp.asarray(mask), 1))
    got = getattr(masked, fn)(torch.from_numpy(x), torch.from_numpy(mask), 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[2] == 0.0)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_with_jax_noise_matches_jax(hard):
    """The soft sample, and the hard one (bits exactly 0 or 1), on JAX's own
    Gumbel draw; the smallest margin |z0 - z1| of these logits is 9e-3, far
    from a roundoff tie."""
    key = jax.random.PRNGKey(3)
    logits = np.random.default_rng(3).normal(size=(5, 7, 2)).astype(np.float32)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, logits.shape)))
    want = jmod.gumbel_softmax(key, jnp.asarray(logits), tau=0.5, hard=hard)
    got = gumbel_softmax(torch.from_numpy(logits), tau=0.5, hard=hard, noise=noise)
    _close(got, want)
    if hard:
        assert set(np.unique(got.numpy())) <= {0.0, 1.0}


def test_gumbel_noise_repeats_from_its_seed_with_gumbel_moments():
    """A seeded draw: float32 whatever the default dtype, the same noise from
    the same seed, Gumbel(0, 1) moments."""
    default = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        assert gumbel_noise((4,), 1, torch.device("cpu")).dtype == torch.float32
    finally:
        torch.set_default_dtype(default)
    draw = gumbel_noise((20000,), 1, torch.device("cpu"))
    assert draw.dtype == torch.float32
    assert torch.equal(draw, gumbel_noise((20000,), 1, torch.device("cpu")))
    assert abs(draw.mean().item() - 0.5772) < 0.03 and abs(draw.var().item() - 1.6449) < 0.08


@pytest.mark.parametrize("name,n_rounds", [("base", 1), ("disc", 1), ("commnet", 2),
                                           ("tarmac", 1), ("tarmac", 2), ("econv", 2)])
def test_comm_protocol_matches_jax(name, n_rounds):
    adj, x, h = _talk(np.random.default_rng(n_rounds))
    args = SN(hidden_size=HID, msg_size=MSG, key_size=KEY, n_rounds=n_rounds, c=name)
    jc = jcomm.COMM_REGISTRY[name](args)
    p = jc.init(jax.random.PRNGKey(7))
    key = jax.random.PRNGKey(8)
    want = jc.apply(p, jnp.asarray(adj), jnp.asarray(x), jnp.asarray(h), key)
    port = _load(comm.make_comm(args), p)
    noise = torch.from_numpy(_disc_noise(key)) if name == "disc" else None
    got = port(torch.from_numpy(adj), torch.from_numpy(x), torch.from_numpy(h), noise)
    _close(got, want)


def test_discrete_comm_straight_through_gradient_matches_jax():
    """d/d f_enc of a weighted sum of h' through the hard bits' soft
    (straight-through) gradient and the OR's max, ties shared evenly."""
    adj, x, h = _talk(np.random.default_rng(5))
    args = SN(hidden_size=HID, msg_size=MSG)
    jc = jcomm.DiscreteComm(args)
    p = jc.init(jax.random.PRNGKey(9))
    key = jax.random.PRNGKey(10)
    g = np.random.default_rng(6).normal(size=(W, A, HID)).astype(np.float32)

    def loss(pe):
        return jnp.sum(g * jc.apply({**p, "f_enc": pe}, jnp.asarray(adj), jnp.asarray(x),
                                    jnp.asarray(h), key))
    want = jax.grad(loss)(p["f_enc"])
    port = _load(comm.DiscreteComm(HID, MSG), p)
    out = port(torch.from_numpy(adj), torch.from_numpy(x), torch.from_numpy(h),
               torch.from_numpy(_disc_noise(key)))
    (out * torch.from_numpy(g)).sum().backward()
    assert float(np.abs(np.asarray(want["w"])).max()) > 1e-3
    _close(port.f_enc.w.grad, want["w"], "f_enc.w")
    _close(port.f_enc.b.grad, want["b"], "f_enc.b")


def _obs(rng, m=6, k=3):
    gt = rng.normal(size=(W, A, m, 1 + OBS_SHAPE["gt"])).astype(np.float32)
    gt[..., 0] = rng.random((W, A, m)) > 0.4
    ubs = rng.normal(size=(W, A, k, 1 + OBS_SHAPE["ubs"])).astype(np.float32)
    ubs[..., 0] = rng.random((W, A, k)) > 0.3
    adj, _, _ = _talk(rng)
    return {"agent": rng.random((W, A, 2)).astype(np.float32), "gt": gt, "ubs": ubs, "adj": adj}


@pytest.mark.parametrize("c,n_rounds", [(None, 1), ("base", 1), ("disc", 1), ("commnet", 2),
                                        ("tarmac", 2), ("econv", 1)])
def test_agent_step_matches_jax(c, n_rounds):
    """The generic GnnAgent step, every path: the kernels' (the encoder's
    plain versions on the CPU; 'pallas' for one case) and the unfused one."""
    rng = np.random.default_rng(11)
    obs = _obs(rng)
    h = np.tanh(rng.normal(size=(W, A, HID))).astype(np.float32)
    kw = dict(o="gnn", c=c, hidden_size=HID, n_heads=2, msg_size=MSG, key_size=KEY,
              n_rounds=n_rounds, dueling=c == "base")
    jagent = jagents.GnnAgent(OBS_SHAPE, N_ACT, SN(**kw, gat_backend="dense"))
    p = jagent.init(jax.random.PRNGKey(12))
    key = jax.random.PRNGKey(13)
    q_want, h_want = jagent.apply(p, {k: jnp.asarray(v) for k, v in obs.items()},
                                  jnp.asarray(h), key)
    agent = _load(GnnAgent(OBS_SHAPE, N_ACT, make_args(
        dict(kw, gat_backend="pallas" if c == "disc" else "dense"), device="cpu")), p)
    assert ("rnn" in p) == (c is None) and not agent.fused_step
    noise = torch.from_numpy(_disc_noise(key)) if c == "disc" else None
    tobs = {k: torch.from_numpy(v.copy()) for k, v in obs.items()}
    with torch.no_grad():
        for use_kernels in (True, False):
            q, h2 = agent(tobs, torch.from_numpy(h), use_kernels=use_kernels, key=noise)
            _close(q, q_want, f"q use_kernels={use_kernels}")
            _close(h2, h_want, f"h use_kernels={use_kernels}")


def test_discrete_comm_draws_from_the_generator_it_is_given():
    """The key is a seed of a generator on the inputs' device (or anything
    int() takes: a rollout's StepKey draws its seed once, when first read)."""
    adj, x, h = _talk(np.random.default_rng(14))
    port = comm.DiscreteComm(HID, MSG)
    args = (torch.from_numpy(adj), torch.from_numpy(x), torch.from_numpy(h))
    with torch.no_grad():
        a = port(*args, 0)
        noise = gumbel_noise((W, A, A, MSG, 2), 0, torch.device("cpu"))
        assert torch.equal(a, port(*args, 0)) and torch.equal(a, port(*args, noise))
        assert not torch.equal(a, port(*args, 1))
        gen = torch.Generator().manual_seed(5)
        key = collect.StepKey(gen)
        assert torch.equal(port(*args, key), port(*args, key))
        seed = int(torch.randint(0, 2**62, (), generator=torch.Generator().manual_seed(5)))
        assert int(key) == seed and torch.equal(port(*args, key), port(*args, seed))
    with pytest.raises(ValueError, match="seed"):
        port(*args, None)


def test_rollout_draws_a_policy_seed_only_when_the_policy_reads_it():
    """A policy that samples nothing leaves the rollout's generator stream as
    it was without the key; one that reads the key takes one draw per step."""
    def draws(read_key):
        gen = torch.Generator().manual_seed(9)

        def policy(obs, h, key):
            if read_key:
                int(key)
                int(key)
            return torch.zeros(h.shape[:-1] + (3,)), h
        collect._act(policy, None, torch.zeros((2, 4, 1)), gen, 0.5, 3)
        return torch.rand((), generator=gen).item()

    gen = torch.Generator().manual_seed(9)
    torch.randint(0, 3, (2, 4), generator=gen)
    torch.rand((2, 1), generator=gen)
    untouched = torch.rand((), generator=gen).item()
    assert draws(False) == untouched and draws(True) != untouched
