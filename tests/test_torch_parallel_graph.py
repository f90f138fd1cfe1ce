"""The port's edge-partitioned GATv2 and TarMAC attention
(``uav_bs_ctrl_tpu_torch/parallel/graph_parallel.py``) against the JAX
package's graph-parallel functions on its ``('gp',)`` mesh of conftest's
virtual CPU devices.

One process group of 8 gloo ranks is spawned once for the module
(``parallel.launch.spawn``); it runs every case at gp = 2, 4 and 8, and at gp
= 4 twice more with rule (b) or (c) of the autograd rule inverted. Outputs
are held to JAX's at atol 2e-5, rtol 1e-5 (``tests/test_parallel.py:113-135``),
the input and parameter gradients of ``sum(out * cot)`` to JAX's (its
``jax.vjp`` with ``cot``, the gradient of the same scalar) at atol 5e-5,
rtol 1e-5 (f32 sums of up to 1,024 terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from uav_bs_ctrl_tpu.models.encoders import gatv2_init
from uav_bs_ctrl_tpu.parallel import graph_parallel as jgp
from uav_bs_ctrl_tpu_torch.parallel import launch, workers
from uav_bs_ctrl_tpu_torch.utils.convert import flatten

GPS = (2, 4, 8)
ATOL, RTOL = 2e-5, 1e-5
GRAD_ATOL = 5e-5


def _gat_case(seed, lead, m, d_src, d_dst, n_heads, feats, masked):
    """A GATv2 case: JAX's init tree, random inputs, a mask with one
    all-masked destination, and a cotangent."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, gatv2_init(
        jax.random.PRNGKey(0), d_src, d_dst, n_heads, feats))
    mask = rng.random(lead + (m,)) > 0.4
    mask[masked] = False
    return dict(params=params, n_heads=n_heads,
                x_src=rng.normal(size=lead + (m, d_src)).astype(np.float32),
                x_dst=rng.normal(size=lead + (d_dst,)).astype(np.float32), mask=mask,
                cot=rng.normal(size=lead + (n_heads * feats,)).astype(np.float32))


def _tarmac_case():
    """``tests/test_parallel.py``'s TarMAC case: S = 5 sources (padded on
    every axis size here) and a destination with no in-edge."""
    rng = np.random.default_rng(11)
    n, s, d, k, m = 4, 5, 5, 8, 16
    adj = rng.random((n, s, d)) > 0.3
    adj[0, :, 2] = False
    return dict(s=rng.normal(size=(n, s, k)).astype(np.float32),
                q=rng.normal(size=(n, d, k)).astype(np.float32),
                v=rng.normal(size=(n, s, m)).astype(np.float32), adj=adj, key_size=k,
                cot=rng.normal(size=(n, d, m)).astype(np.float32))


# test_parallel.py:113-135 ('seen'-like, M = 64), :156-165 (M = 7, not
# divisible by 2, 4 or 8), and a 'near'-like relation (K = 7 slots of 2
# features into a 2-feature agent, a residual projection) with two lead dims.
GAT_CASES = {"seen": _gat_case(0, (16,), 64, 5, 3, 4, 8, 2),
             "pad7": _gat_case(3, (6,), 7, 5, 3, 4, 8, 1),
             "near": _gat_case(5, (3, 4), 7, 2, 2, 2, 16, (1, 2))}
CASES = list(GAT_CASES.values()) + [_tarmac_case()]
NAMES = list(GAT_CASES) + ["tarmac"]
PLANTS = ("b", "c")


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results: ``{(gp, plant): [rank 0's cases, ...]}``."""
    runs = [(gp, None) for gp in GPS] + [(4, plant) for plant in PLANTS]
    results = launch.spawn(8, [(workers.graph_probe, dict(gp=gp, cases=CASES, plant=plant))
                               for gp, plant in runs], "cpu")
    return dict(zip(runs, results))


def _mesh(gp):
    return Mesh(np.asarray(jax.devices()[:gp]), ("gp",))


def _jax_gat(case, gp):
    """JAX's ``gatv2_graph_parallel`` on a ``('gp',)`` mesh (the slot axis
    padded by JAX's ``pad_slot_axis``): the output and the gradients of
    ``sum(out * cot)`` by input and parameter name."""
    mesh = _mesh(gp)
    mask = jnp.asarray(case["mask"])

    def f(p, x_src, x_dst):
        xs, m = jgp.pad_slot_axis(x_src, mask, gp)
        return jgp.gatv2_graph_parallel(p, xs, x_dst, m, case["n_heads"], mesh)

    args = (jax.tree_util.tree_map(jnp.asarray, case["params"]), jnp.asarray(case["x_src"]),
            jnp.asarray(case["x_dst"]))
    out, (dp, dx_src, dx_dst) = _value_and_vjp(f, args, case["cot"])
    grads = dict(x_src=dx_src, x_dst=dx_dst, **flatten(dp))
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


def _value_and_vjp(f, args, cot):
    """``f(*args)`` and the gradients of ``sum(f(*args) * cot)``, jitted."""
    @jax.jit
    def run(*a):
        out, vjp = jax.vjp(f, *a)
        return out, vjp(jnp.asarray(cot))
    return run(*args)


def _jax_tarmac(case, gp):
    mesh = _mesh(gp)
    adj = jnp.asarray(case["adj"])

    def f(s, q, v):
        return jgp.tarmac_attention_graph_parallel(s, q, v, adj, case["key_size"], mesh)

    out, grads = _value_and_vjp(f, tuple(jnp.asarray(case[k]) for k in ("s", "q", "v")),
                                case["cot"])
    return np.asarray(out), {k: np.asarray(g) for k, g in zip("sqv", grads)}


_JAX = {}


def _reference(name, gp):
    if (name, gp) not in _JAX:
        case = CASES[NAMES.index(name)]
        _JAX[name, gp] = (_jax_tarmac(case, gp) if name == "tarmac" else _jax_gat(case, gp))
    return _JAX[name, gp]


def _check(got, name, gp):
    out, grads = _reference(name, gp)
    np.testing.assert_allclose(got["out"], out, atol=ATOL, rtol=RTOL)
    assert got["grads"].keys() == grads.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(got["grads"][k], g, atol=GRAD_ATOL, rtol=RTOL,
                                   err_msg=f"{name} d/d{k}")


@pytest.mark.parametrize("gp", GPS)
def test_gatv2_graph_parallel_matches_jax(ranks, gp):
    """The M = 64 'seen'-like case (an all-masked destination): output and
    the gradients of x_src, x_dst and every parameter, on every rank."""
    for rank in ranks[gp, None]:
        _check(rank[0], "seen", gp)


@pytest.mark.parametrize("gp", GPS)
@pytest.mark.parametrize("name", ("pad7", "near"))
def test_gatv2_graph_parallel_pads_nondivisible_slots(ranks, gp, name):
    """M = 7 slots padded with masked slots to the axis size (exact), with
    one or two lead dims and a residual projection."""
    for rank in ranks[gp, None]:
        _check(rank[NAMES.index(name)], name, gp)


@pytest.mark.parametrize("gp", GPS)
def test_tarmac_attention_graph_parallel_matches_jax(ranks, gp):
    """S = 5 sources padded over the axis, a destination with no in-edge
    (c = 0): c and the gradients of s, q and v, on every rank."""
    for rank in ranks[gp, None]:
        _check(rank[NAMES.index("tarmac")], "tarmac", gp)


def test_graph_parallel_output_is_replicated(ranks):
    """Every rank of every gp group ends with the same output and gradients."""
    for gp in GPS:
        first = ranks[gp, None][0]
        for rank in ranks[gp, None][1:]:
            for a, b in zip(first, rank):
                np.testing.assert_array_equal(a["out"], b["out"])
                for k in a["grads"]:
                    np.testing.assert_array_equal(a["grads"][k], b["grads"][k])


@pytest.mark.parametrize("plant", PLANTS)
def test_inverted_autograd_rule_is_caught(ranks, plant):
    """With rule (b) inverted (no all-reduce of a replicated input's
    cotangent) the gradients of x_dst, fc_dst, attn and TarMAC's q lose the
    other ranks' terms; with rule (c) inverted (an all-reduce of the
    combining sums' cotangent) the replicated loss counts gp times. Either
    leaves the outputs right and puts gradients far outside the tolerance."""
    rank = ranks[4, plant][0]
    for i, name in enumerate(NAMES):
        out, grads = _reference(name, 4)
        np.testing.assert_allclose(rank[i]["out"], out, atol=ATOL, rtol=RTOL)
        worst = max(float(np.max(np.abs(rank[i]["grads"][k] - g) /
                                 (GRAD_ATOL + RTOL * np.abs(g)))) for k, g in grads.items())
        assert worst > 100, (plant, name, worst)
    if plant == "b":     # the sharded inputs' gradients stay right
        _, grads = _reference("tarmac", 4)
        np.testing.assert_allclose(rank[NAMES.index("tarmac")]["grads"]["v"], grads["v"],
                                   atol=GRAD_ATOL, rtol=RTOL)
