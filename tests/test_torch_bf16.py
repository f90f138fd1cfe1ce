"""bf16 compute in the port against the JAX package's, both judged against a
float64 referee.

- The plain bf16 versions of #2/#3 (``flash_gat_fused_plain`` and
  ``flash_gat_fused_bwd_plain``) against JAX's ``flash_gat_fused_train`` and
  its VJP at bf16 in interpret mode (``pallas_fused`` and
  ``pallas_fused_mxu``), and of #4/#5 against JAX's ``tarmac_step_train``
  and its VJP at bf16 in interpret mode.
- One bf16 update's LossQ, Q and gradients: the port's kernel path (the
  plain versions on the CPU) against JAX's ``_loss_fn`` under
  ``value_and_grad`` on the same params, batch and noise, for gnn + TarMAC +
  QMIX + dueling, gnn + DiscreteComm, the MLP encoder (exp2's TarMAC) and
  exp1's ``DrqnGnnAgent``.
- After a bf16 update every master param and AdamW moment is f32, and a bf16
  run's checkpoint resumes in the JAX learner.
- Every GATv2 and step call on the bf16 path gets bf16 operands: the plain
  versions the wrappers call on the CPU are probed for their dtypes.

The referee is the port's plain path in float64 on the same bf16-rounded
inputs (the bf16 copies of the net's params, obs and h; the mixer stays f32
in both packages, so its f64 copy is unrounded). Tolerance: each package's
output within 2e-2 of max(1, max |referee|) of that output (ROADMAP.md
"Numerics"); an update's gradients within 2e-2 of max(1, the largest
referee gradient of their group, net or mixer), since every entry is a sum
over the same BPTT graph, whose scale sets the roundoff (as
``test_torch_update.py:_check_first_update`` scales f32 gradients); and
where JAX's error exceeds 1e-2 the port's is at most twice JAX's. Two
functions jump: DiscreteComm's hard bits, and LeakyReLU's derivative at
z = 0, which the plain bf16 #3 takes on a bf16-rounded z. Where the f64
referee's own argument lies within a bf16 rounding of the jump, the port's
referee takes the bf16 path's side (the test prints how often), as
``chip_smoke.py`` does between two paths; JAX's referee is the plain f64.
"""

import json
from pathlib import Path
from types import SimpleNamespace as SN

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_update import (A_DBG, DS_DBG, HID, K_DBG, M_DBG, _batch, _kw, _named,
                               _torch_tree)
from test_torch_update_protocols import _flat
from uav_bs_ctrl_tpu.algos.common import check_args_sanity as jax_check_args
from uav_bs_ctrl_tpu.algos.drqn.config import DEFAULT_CONFIG as JAX_DRQN_DEFAULTS
from uav_bs_ctrl_tpu.algos.drqn.learner import QLearner as JaxQLearner
from uav_bs_ctrl_tpu.algos.madrqn.config import DEFAULT_CONFIG as JAX_DEFAULTS
from uav_bs_ctrl_tpu.algos.madrqn.learner import MultiAgentQLearner as JaxLearner
from uav_bs_ctrl_tpu.ops import pallas_kernels as jpk
from uav_bs_ctrl_tpu.ops import step_kernels as jsk
from uav_bs_ctrl_tpu_torch.algos.drqn import config as drqn_config
from uav_bs_ctrl_tpu_torch.algos.drqn.learner import QLearner
from uav_bs_ctrl_tpu_torch.algos.madrqn.learner import MultiAgentQLearner
from uav_bs_ctrl_tpu_torch.config import make_args
from uav_bs_ctrl_tpu_torch.models import comm
from uav_bs_ctrl_tpu_torch.ops import gat_kernels, step_kernels

BF16_TOL = 2e-2     # of max(1, max |referee|), each output (ROADMAP.md "Numerics")
JAX_FLOOR = 1e-2    # above this JAX error the port's is held to RATIO times JAX's
RATIO = 2.0
LEAF_FLOOR = 1e-3   # a leaf's own scale: at least this share of its group's largest |referee|
T, B = 5, 4


def _bf16(a):
    """numpy f32 rounded to bf16 (as the JAX and the port casts round)."""
    return np.asarray(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float())


def _err(got, ref, scale=None):
    """max |got - ref| / max(1, scale), the scale max |ref| unless given."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max() if scale is None else scale
    return float(np.abs(got - ref).max() / max(1.0, scale))


def _judge(port, jaxv, ref, what, scale=None):
    """Both packages within BF16_TOL of the referee; where JAX's error
    exceeds JAX_FLOOR, the port's at most RATIO times it."""
    e_port, e_jax = _err(port, ref, scale), _err(jaxv, ref, scale)
    print(f"{what}: port {e_port:.2e}, jax {e_jax:.2e}")
    assert e_port <= BF16_TOL, f"{what}: port {e_port:.3e}"
    assert e_jax <= BF16_TOL, f"{what}: jax {e_jax:.3e}"
    if e_jax > JAX_FLOOR:
        assert e_port <= RATIO * e_jax, f"{what}: port {e_port:.3e}, jax {e_jax:.3e}"
    return e_port, e_jax


def _judge_leaf(port, jaxv, ref, what, group_scale):
    """One gradient leaf on its own scale, max(max |referee|, LEAF_FLOOR *
    group_scale): the port's error at most BF16_TOL, or RATIO times JAX's.
    bf16 leaves deep in the chain are off by up to about 0.3 of their own
    scale in both packages; a wrong or zero leaf is off by 1 or more."""
    port, jaxv, ref = (np.asarray(v, np.float64) for v in (port, jaxv, ref))
    scale = max(np.abs(ref).max(), LEAF_FLOOR * group_scale)
    e_port, e_jax = np.abs(port - ref).max() / scale, np.abs(jaxv - ref).max() / scale
    print(f"{what} on its own scale {scale:.2e}: port {e_port:.2e}, jax {e_jax:.2e}")
    assert e_port <= max(BF16_TOL, RATIO * e_jax), f"{what}: port {e_port:.3e}, jax {e_jax:.3e}"


# --------------------------------------------------------------------------- #
# The kernels' plain bf16 versions against JAX's kernels at bf16.

@pytest.mark.parametrize("mxu", [False, True])
def test_plain_bf16_gat_matches_jax_kernel_at_bf16(mxu):
    """#2 and #3: out and the VJP's dx, dW, db, der, dattn (row 2 fully
    masked), the plain bf16 version and JAX's kernel in interpret mode."""
    rng = np.random.default_rng(3)
    n, m, d, heads, f = 12, 20, 4, 4, 32
    hf = heads * f
    vals = dict(x=rng.normal(size=(n, m, d)), w=rng.normal(size=(d, hf)) / np.sqrt(d),
                b=0.1 * rng.normal(size=hf), er=rng.normal(size=(n, hf)),
                attn=0.5 * rng.normal(size=(heads, f)) / np.sqrt(f))
    mask = (rng.random((n, m)) > 0.4).astype(np.float32)
    mask[2] = 0.0
    cot = _bf16(rng.normal(size=(n, hf)))
    vals = {k: _bf16(v) for k, v in vals.items()}
    order = ("x", "w", "b", "er", "attn")

    j_in = [jnp.asarray(vals[k], jnp.bfloat16) for k in order]
    j_mask = jnp.asarray(mask, jnp.bfloat16)
    out_j, vjp = jax.vjp(lambda *a: jpk.flash_gat_fused_train(
        *a, j_mask, heads, 0.2, 8, 128, True, mxu), *j_in)
    grads_j = vjp(jnp.asarray(cot, jnp.bfloat16))

    def port(dtype, need_dx=True):
        t = [torch.from_numpy(vals[k]).to(dtype) for k in order]
        tm = torch.from_numpy(mask).to(dtype)
        out, ms, ls = gat_kernels.flash_gat_fused_plain(*t, tm, heads)
        g = gat_kernels.flash_gat_fused_bwd_plain(*t, tm, out, ms, ls,
                                                  torch.from_numpy(cot).to(dtype), heads,
                                                  0.2, need_dx)
        return out, g

    out_p, g_p = port(torch.bfloat16)
    out_r, g_r = port(torch.float64)
    assert out_p.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in g_p)
    _judge(out_p.float(), np.asarray(out_j, np.float32), out_r, "out")
    # LeakyReLU's derivative jumps at z = 0, and the plain bf16 version rounds
    # el = x W + b before z = el + er (JAX's kernel and the port's keep z in
    # f32): the port's own referee takes the plain bf16 branch where the f64
    # z lies within a bf16 rounding of 0, and JAX's referee is the plain f64.
    t16 = [torch.from_numpy(vals[k]).to(torch.bfloat16) for k in order]
    t64 = [torch.from_numpy(vals[k]).double() for k in order]
    z16 = ((t16[0] @ t16[1] + t16[2]).reshape(n, m, heads, f)
           + t16[3].reshape(n, 1, heads, f)).double()
    el64 = (t64[0] @ t64[1] + t64[2]).reshape(n, m, heads, f)
    z64 = el64 + t64[3].reshape(n, 1, heads, f)
    flip = (z16 >= 0) != (z64 >= 0)
    tie = z64.abs() <= 2.0 ** -7 * (el64.abs() + t64[3].reshape(n, 1, heads, f).abs())
    assert not (flip & ~tie).any(), "the LeakyReLU branch differs beyond a bf16 tie"
    own = gat_kernels.leaky_grad
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gat_kernels, "leaky_grad", lambda z, s: torch.where(
            flip, own(z16, s).to(z.dtype), own(z, s)))
        _, g_own = port(torch.float64)
    valid = torch.from_numpy(mask > 0)[:, :, None, None]
    print(f"LeakyReLU branches at bf16 ties: {int((flip & valid).sum())} of "
          f"{int(valid.sum()) * hf // heads * heads}")
    for name, gp, gj, gr, go in zip(("dx", "dw", "db", "der", "dattn"), g_p, grads_j, g_r,
                                    g_own):
        e_port = _err(gp.float(), go)
        e_jax = _err(np.asarray(gj, np.float32), gr)
        print(f"{name}: port {e_port:.2e} (plain f64 referee {_err(gp.float(), gr):.2e}), "
              f"jax {e_jax:.2e}")
        assert e_port <= BF16_TOL and e_jax <= BF16_TOL, name
        if e_jax > JAX_FLOOR:
            assert e_port <= RATIO * e_jax, name


@pytest.mark.parametrize("dueling", [False, True])
def test_plain_bf16_step_matches_jax_kernel_at_bf16(dueling):
    """#4 and #5: q, h' and the VJP's dx, dh and 14 weight gradients, the
    plain bf16 version and JAX's kernel in interpret mode (world 0's agent 1
    hears no one)."""
    rng = np.random.default_rng(5)
    w, a, hid, msg, key, n_act = 3, 4, 32, 16, 8, 9
    lin = lambda i, o: rng.normal(size=(i, o)) / np.sqrt(i)
    vec = lambda o: 0.1 * rng.normal(size=o)
    adjf = (rng.random((w * a, a)) > 0.4).astype(np.float32)
    adjf[np.arange(w * a), np.arange(w * a) % a] = 1.0
    adjf[0:a, 1] = 0.0
    vals = [np.maximum(rng.normal(size=(w * a, hid)), 0.0), np.tanh(rng.normal(size=(w * a, hid))),
            adjf, lin(2 * hid, msg), vec(msg), lin(2 * hid, key), vec(key), lin(2 * hid, key),
            vec(key), lin(hid + msg, 3 * hid), lin(hid, 3 * hid), vec(3 * hid), vec(3 * hid),
            lin(hid, n_act), vec(n_act), lin(hid, 1), vec(1)]
    vals = [_bf16(v) for v in vals]
    gq, gh2 = _bf16(rng.normal(size=(w * a, n_act))), _bf16(rng.normal(size=(w * a, hid)))
    cfg = (a, key, dueling)

    j_in = [jnp.asarray(v, jnp.bfloat16) for v in vals]

    def jax_step(x, h, *weights):
        return jsk.tarmac_step_train(x, h, j_in[2], *weights, *cfg, None, True)
    out_j, vjp = jax.vjp(jax_step, *j_in[:2], *j_in[3:])
    grads_j = vjp((jnp.asarray(gq, jnp.bfloat16), jnp.asarray(gh2, jnp.bfloat16)))

    def port(dtype):
        t = [torch.from_numpy(v).to(dtype) for v in vals]
        out = step_kernels.tarmac_step_plain(*t, *cfg)
        g = step_kernels.tarmac_step_bwd_plain(*t, torch.from_numpy(gq).to(dtype),
                                               torch.from_numpy(gh2).to(dtype), *cfg)
        return out, g

    out_p, g_p = port(torch.bfloat16)
    out_r, g_r = port(torch.float64)
    assert all(x.dtype == torch.bfloat16 for x in out_p + g_p)
    for name, op, oj, orf in zip(("q", "h2"), out_p, out_j, out_r):
        _judge(op.float(), np.asarray(oj, np.float32), orf, name)
    names = ["dx", "dh"] + [f"d{k}" for k in step_kernels._WEIGHTS]
    for name, gp, gj, gr in zip(names, g_p, grads_j, g_r):
        if not dueling and name in ("dwvh", "dbvh"):
            continue            # JAX's kernel reads no V head without dueling
        _judge(gp.float(), np.asarray(gj, np.float32), gr, name)


# --------------------------------------------------------------------------- #
# One bf16 update against JAX's, both against the f64 referee.

def _bf16_batch(batch):
    """The referee's batch: obs and h rounded to bf16 (as both packages cast
    them), everything in f64."""
    def cast(k, v):
        if v.dtype.kind != "f":
            return torch.from_numpy(np.array(v))
        return torch.from_numpy(_bf16(v) if k in ("obs", "h") else np.asarray(v)).double()
    out = {}
    for k, v in batch.items():
        out[k] = ({kk: cast("obs", vv) for kk, vv in v.items()} if isinstance(v, dict)
                  else cast(k, v))
    return out


def _jax_bf16_noise(key, shape):
    """DiscreteComm's per-step Gumbel noise as JAX's per-step schedule draws
    it at bf16 (``jax.random.gumbel(sub, shape, logits.dtype)``), in f32."""
    key_pol, key_targ = jax.random.split(key)

    def chain(k, n):
        out = []
        for _ in range(n):
            k, sub = jax.random.split(k)
            out.append(np.asarray(jax.random.gumbel(sub, shape, jnp.bfloat16), np.float32))
        return torch.from_numpy(np.stack(out))
    return {"pol": chain(key_pol, T + 1), "targ": chain(key_targ, T)}


class _FollowBits:
    """The f64 referee's DiscreteComm samples take the bf16 path's hard bits
    where the referee's own Gumbel margin |z0 - z1| is within ``tie`` (bf16
    logits round a sample either way there); a wider difference fails."""

    def __init__(self, tie):
        self.tie, self.recorded, self.follow, self.followed = tie, [], False, 0

    def __call__(self, logits, tau=1.0, hard=False, seed=None, noise=None):
        bits = self._orig(logits, tau, hard, seed, noise)
        if not self.follow:
            self.recorded.append(bits.detach().float())
            return bits
        want = self.recorded.pop(0).to(bits.dtype)
        z = logits + noise.to(logits.dtype)
        margin = (z[..., 0] - z[..., 1]).abs()
        differ = (bits.detach() != want).any(-1)
        assert not (differ & (margin > self.tie)).any(), "a bit differs beyond a bf16 tie"
        self.followed += int(differ.sum())
        return bits + torch.where(differ[..., None], want - bits.detach(), torch.zeros_like(bits))

    def __enter__(self):
        self._orig = comm.gumbel_softmax
        comm.gumbel_softmax = self
        return self

    def __exit__(self, *exc):
        comm.gumbel_softmax = self._orig


def _port_loss(tl, batch, noise, use_kernels=True):
    tl.optimizer.zero_grad(set_to_none=True)
    loss, qvals = tl._loss(batch, use_kernels, noise)
    loss.backward()
    return loss.item(), qvals.detach(), [p.grad.detach().clone() for p in tl.parameters()]


def _referee(tl, make, tree):
    """The port's learner in f64 on bf16-rounded net params (mixer unrounded)."""
    ref = make()
    ref.load_params(tree)
    for net in (ref.net, ref.target_net):
        for p in net.parameters():
            p.data = p.data.to(torch.bfloat16).double()
    for mod in (ref.mixer, ref.target_mixer):
        if mod is not None:
            mod.double()
    ref.compute_dtype = torch.float64
    return ref


MADRQN_CASES = {
    "gnn_tarmac_qmix_dueling": dict(_kw(True, True)),
    "gnn_disc": dict(_kw(False, False), c="disc"),
    "mlp_tarmac": dict(_kw(False, False), o="mlp", n_layers=2),
}


@pytest.mark.parametrize("case", list(MADRQN_CASES) + ["exp1_drqn_gnn"])
def test_bf16_update_matches_jax_against_f64_referee(case):
    """LossQ, Q and the gradients of every param of one bf16 update: each
    leaf on its group's scale (``_judge``) and on its own (``_judge_leaf``)."""
    rng = np.random.default_rng(21)
    if case == "exp1_drqn_gnn":
        from test_torch_drqn import _batch as drqn_batch, _env_info as drqn_env_info
        from test_torch_drqn import _kw as drqn_kw
        kw = dict(drqn_kw("gnn"), compute_dtype="bfloat16")
        env_info = drqn_env_info("gnn")
        jl = JaxQLearner(env_info, jax_check_args(SN(**{**JAX_DRQN_DEFAULTS, **kw,
                                                        "device": "cpu"})))
        make = lambda: QLearner(env_info, drqn_config.check_args(SN(
            **{**drqn_config.DEFAULT_CONFIG, **kw, "device": "cpu"})))
        batch = drqn_batch(rng, "gnn", 16)
    else:
        kw = dict(MADRQN_CASES[case], compute_dtype="bfloat16")
        mixer = kw["mixer"]
        batch = _batch(rng, B, T, A_DBG, M_DBG, K_DBG, DS_DBG, HID, 1 if mixer else A_DBG)
        obs_shape = {"agent": 2, "gt": 4, "ubs": 2}
        if kw.get("o") == "mlp":
            batch = _flat(batch)
            obs_shape = batch["obs"]["agent"].shape[-1]
        env_info = dict(obs_shape=obs_shape, state_shape=DS_DBG, n_actions=9,
                        n_agents=A_DBG, episode_limit=T)
        jl = JaxLearner(env_info, jax_check_args(SN(**{**JAX_DEFAULTS, **kw, "device": "cpu"})))
        make = lambda: MultiAgentQLearner(env_info, make_args(kw, device="cpu"))
    tree = jax.tree_util.tree_map(np.asarray, jl.params)
    tl = make()
    tl.load_params(tree)
    assert tl.compute_dtype == torch.bfloat16

    key = jax.random.PRNGKey(0)
    shape = tl.net.noise_shape((B,), A_DBG)
    noise = None if shape is None else _jax_bf16_noise(key, shape)
    (loss_j, q_j), grads_j = jax.jit(jax.value_and_grad(jl._loss_fn, has_aux=True))(
        jl.params, jl.target_params, jax.tree_util.tree_map(jnp.asarray, batch), key)
    grads_j = _named(grads_j)

    ref = _referee(tl, make, tree)
    with _FollowBits(tie=0.1) as follow:
        loss_p, q_p, g_p = _port_loss(tl, _torch_tree(batch), noise)
        follow.follow = True
        noise64 = None if noise is None else {k: v.double() for k, v in noise.items()}
        loss_r, q_r, g_r = _port_loss(ref, _bf16_batch(batch), noise64)
    if noise is not None:
        print(f"referee bits taken from the bf16 path at bf16 ties: {follow.followed}")

    _judge(loss_p, float(loss_j), loss_r, "LossQ")
    q_j = np.moveaxis(np.asarray(q_j), 0, 1)          # JAX's Q is time-major
    _judge(q_p.float().numpy(), q_j, q_r.numpy(), "Q")
    groups = {"net": tl.net, "mixer": tl.mixer}
    names = [f"{g}.{k}" for g, mod in groups.items() if mod is not None
             for k, _ in mod.named_parameters()]
    assert sorted(names) == sorted(grads_j)
    scale = {g: max(r.abs().max().item() for n, r in zip(names, g_r) if n.startswith(g + "."))
             for g in groups if groups[g] is not None}
    for name, gp, gr in zip(names, g_p, g_r):
        assert gp.dtype == torch.float32
        _judge(gp.numpy(), grads_j[name], gr.numpy(), f"grad {name}", scale[name.split(".")[0]])
        _judge_leaf(gp.numpy(), grads_j[name], gr.numpy(), f"grad {name}",
                    scale[name.split(".")[0]])


# --------------------------------------------------------------------------- #
# State after bf16 updates, and the dtypes every kernel call gets.

def test_bf16_updates_keep_f32_masters_and_adamw_state_and_jax_resumes_them(tmp_path):
    """Three bf16 updates (``hoisted``): params, targets and both AdamW
    moments stay f32; the checkpoint they write resumes in JAX's bf16 learner
    leaf for leaf (params and moments exactly), and JAX's next bf16 loss on
    it is within BF16_TOL of the port's."""
    kw = dict(_kw(True, True), compute_dtype="bfloat16", bptt_encoder="hoisted")
    env_info = dict(obs_shape={"agent": 2, "gt": 4, "ubs": 2}, state_shape=DS_DBG,
                    n_actions=9, n_agents=A_DBG, episode_limit=T)
    tl = MultiAgentQLearner(env_info, make_args(kw, device="cpu"))
    rng = np.random.default_rng(31)
    batches = [_batch(rng, B, T, A_DBG, M_DBG, K_DBG, DS_DBG, HID, 1) for _ in range(4)]
    for batch in batches[:3]:
        metrics = tl.update_on_batch(_torch_tree(batch))
        assert metrics["LossQ"].dtype == torch.float32 and torch.isfinite(metrics["LossQ"])
    mods = (tl.net, tl.target_net, tl.mixer, tl.target_mixer)
    assert all(p.dtype == torch.float32 for m in mods for p in m.parameters())
    for p in tl.parameters():
        state = tl.optimizer.state[p]
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.float32

    path = tmp_path / "checkpoint_epoch1.pt"
    tl.save_checkpoint(path, dict(epoch=1, t=600))
    jl = JaxLearner(env_info, jax_check_args(SN(**{**JAX_DEFAULTS, **kw, "device": "cpu"})))
    jl.load_checkpoint(str(path))
    assert jl.compute_dtype == jnp.bfloat16
    groups = {"net": tl.net, "mixer": tl.mixer}
    params = {f"{g}.{k}": p.detach().numpy() for g, mod in groups.items()
              for k, p in mod.named_parameters()}
    adam = jl.opt_state.inner_state[0]
    assert int(adam.count) == 3
    for tree, want in ((jl.params, params),
                       (adam.mu, {n: tl.optimizer.state[p]["exp_avg"].numpy()
                                  for n, p in zip(params, tl.parameters())}),
                       (adam.nu, {n: tl.optimizer.state[p]["exp_avg_sq"].numpy()
                                  for n, p in zip(params, tl.parameters())})):
        got = _named(tree)
        assert sorted(got) == sorted(want)
        for name, v in got.items():
            assert v.dtype == np.float32 and np.array_equal(v, want[name]), name
    batch = batches[3]
    loss_j = jax.jit(jl._loss_fn)(jl.params, jl.params,
                                  jax.tree_util.tree_map(jnp.asarray, batch),
                                  jax.random.PRNGKey(0))[0]
    tl.target_net.load_state_dict(tl.net.state_dict())      # JAX's resume resets the targets
    tl.target_mixer.load_state_dict(tl.mixer.state_dict())
    with torch.no_grad():
        loss_p = tl._loss(_torch_tree(batch), True, None)[0]
    assert abs(float(loss_p) - float(loss_j)) <= BF16_TOL * max(1.0, abs(float(loss_j)))


def _dtype_probe(mp):
    """Record the dtypes of the tensor operands of every call of the four
    plain versions (the wrappers call them on CPU tensors)."""
    seen = {name: [] for name in ("flash_gat_fused", "flash_gat_fused_bwd", "tarmac_step",
                                  "tarmac_step_bwd")}
    for mod, name in ((gat_kernels, "flash_gat_fused"), (gat_kernels, "flash_gat_fused_bwd"),
                      (step_kernels, "tarmac_step"), (step_kernels, "tarmac_step_bwd")):
        plain = getattr(mod, f"{name}_plain")

        def probe(*args, _plain=plain, _name=name, **kw):
            seen[_name].append({t.dtype for t in args if isinstance(t, torch.Tensor)})
            return _plain(*args, **kw)
        mp.setattr(mod, f"{name}_plain", probe)
    return seen


@pytest.mark.parametrize("sched", ["per_step", "hoisted", "merged"])
def test_every_kernel_call_on_the_bf16_path_gets_bf16_operands(sched):
    """A bf16 update, ``act`` and a fused trainer's collection, update and
    test episodes: every call of #2-#5 gets bf16 tensors only (the f32 row
    statistics m, l of #3 aside), none is silently promoted to f32 by an f32
    tensor on the way, and each kernel is called."""
    from uav_bs_ctrl_tpu_torch.algos.madrqn.fused import FusedMadrqnTrainer
    kw = dict(_kw(True, True), compute_dtype="bfloat16", bptt_encoder=sched)
    env_info = dict(obs_shape={"agent": 2, "gt": 4, "ubs": 2}, state_shape=DS_DBG,
                    n_actions=9, n_agents=A_DBG, episode_limit=T)
    tl = MultiAgentQLearner(env_info, make_args(kw, device="cpu"))
    batch = _torch_tree(_batch(np.random.default_rng(41), B, T, A_DBG, M_DBG, K_DBG, DS_DBG,
                               HID, 1))
    with pytest.MonkeyPatch.context() as mp:
        seen = _dtype_probe(mp)
        tl.update_on_batch(batch)
        obs = {k: v[0, 0].numpy() for k, v in batch["obs"].items()}
        acts, h2 = tl.act(obs, tl.init_hidden(), 0.0, np.random.RandomState(0))
        assert h2.dtype == np.float32 and len(acts) == A_DBG
        trainer = FusedMadrqnTrainer("debug", train_kwargs=dict(
            kw, mixer=True, device="cpu", batch_size=2, replay_size=8), n_worlds=2,
            capacity_chunks=4, updates_per_iter=1, n_layouts=4)
        trainer.run_iteration(1.0, warmup=True)
        trainer.run_iteration(0.5)
        trainer.evaluate(n_episodes=2)
    for name, calls in seen.items():
        assert calls, f"{name} was never called"
        for dtypes in calls:
            # #3 also takes #2's f32 row statistics m and l
            want = {torch.bfloat16, torch.float32} if name == "flash_gat_fused_bwd" \
                else {torch.bfloat16}
            assert dtypes == want, (name, dtypes)


def test_serving_a_bf16_run_with_flash_gat_raises_naming_its_queue_item(tmp_path):
    """``flash_gat`` (#1) is float32 only, in both packages: serving a bf16
    run through it is refused before anything is built, saying so; the same
    run with the fused backend builds its bf16 policy."""
    from uav_bs_ctrl_tpu_torch import serve
    run = Path(__file__).resolve().parents[1] / "data" / "exp3_fast_4ubs_disc_lay64k" / \
        "exp3_fast_4ubs_disc_lay64k_s0"
    config = json.loads((run / "config.json").read_text())
    config["args"]["compute_dtype"] = "bfloat16"
    (tmp_path / "config.json").write_text(json.dumps(config))
    with pytest.raises(NotImplementedError, match="flash_gat \\(#1\\), which is float32 only "
                                                  "in both packages"):
        serve.load_policy(tmp_path, "cpu", run / "checkpoint_epoch200.pt", gat_backend="pallas")
    agent, _ = serve.load_policy(tmp_path, "cpu", run / "checkpoint_epoch200.pt",
                                 gat_backend="pallas_fused")
    assert all(p.dtype == torch.float32 for p in agent.parameters())
