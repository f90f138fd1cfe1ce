"""The port's padded edge-list ops (``uav_bs_ctrl_tpu_torch/ops/segment.py``)
against the JAX package's ``ops/segment.py``.

The same seeded edge lists (``dense_to_edges`` of a random adjacency with an
isolated destination, and shuffled padded lists whose masked edges point
anywhere, some destinations with every in-edge masked) go through every op
of both packages, each backend, within 1e-6; ``dense_to_edges`` exactly.
The gradients of ``tests/test_ops.py``'s loss (gather, softmax, attention
SpMM) agree within 1e-5, and a masked edge with a huge score sends no nan
back. The indices are JAX's int32 or int64.

One difference is kept on purpose: with a destination that has no valid
in-edge, JAX's gradient through the ``'onehot'`` backend is nan (the
softmax's ``denom ** 2`` underflows to 0 there, 0/0 is nan, and the one-hot
product's ``0 * nan`` carries it to every edge), while its ``'xla'``
gradient is finite. The port's ``'onehot'`` gradient is finite and is held
to JAX's ``'xla'`` one, the same function.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uav_bs_ctrl_tpu.ops import segment as jseg
from uav_bs_ctrl_tpu_torch.ops import segment

TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
BACKENDS = ("xla", "onehot")


def _dense_graph(rng, n_src=7, n_dst=5, p=0.5):
    adj = rng.random((n_src, n_dst)) > p
    adj[:, 0] = False                                   # one isolated destination
    return adj


def _padded_edges(rng, n_src=9, n_dst=6, n_edges=40):
    """A shuffled padded edge list: a third of the edges masked; destination
    ``n_dst - 1`` has only masked in-edges, destination 0 none at all."""
    src = rng.integers(0, n_src, n_edges)
    dst = rng.integers(1, n_dst, n_edges)
    mask = rng.random(n_edges) > 0.33
    mask[dst == n_dst - 1] = False
    return src, dst, mask, n_src, n_dst


def _graphs():
    rng = np.random.default_rng(0)
    out = []
    adj = _dense_graph(rng)
    src, dst, mask = (np.asarray(a) for a in jseg.dense_to_edges(jnp.asarray(adj)))
    out.append(("dense", src, dst, mask, adj.shape[0], adj.shape[1]))
    out.append(("padded",) + _padded_edges(rng))
    return out


GRAPHS = _graphs()


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=what, **tol)


def test_dense_to_edges_matches_jax():
    adj = _dense_graph(np.random.default_rng(1), 6, 4)
    got = segment.dense_to_edges(torch.as_tensor(adj))
    for g, w in zip(got, jseg.dense_to_edges(jnp.asarray(adj))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("graph", GRAPHS, ids=lambda g: g[0])
@pytest.mark.parametrize("feat", [(), (3,), (2, 4)], ids=["scalar", "d3", "h2d4"])
def test_segment_reductions_match_jax(graph, feat):
    """segment_sum (both backends), segment_mean (both), segment_max, with the
    destinations that have no valid in-edge at 0 in both."""
    _, src, dst, mask, n_src, n_dst = graph
    rng = np.random.default_rng(len(feat))
    x = rng.normal(size=(n_src,) + feat).astype(np.float32)
    e = jseg.gather_src(jnp.asarray(x), jnp.asarray(src))
    e_t = segment.gather_src(_t(x), _t(src))
    _close(e_t, e, what="gather_src")
    args_j = (jnp.asarray(dst), jnp.asarray(mask), n_dst)
    args_t = (_t(dst), _t(mask), n_dst)
    no_valid = np.ones(n_dst, bool)
    no_valid[dst[mask]] = False
    for backend in BACKENDS:
        got = segment.segment_sum(e_t, *args_t, backend=backend)
        _close(got, jseg.segment_sum(e, *args_j, backend=backend), what=f"sum {backend}")
        assert (got[_t(no_valid)] == 0).all()
        got = segment.segment_mean(e_t, *args_t, backend=backend)
        _close(got, jseg.segment_mean(e, *args_j, backend=backend), what=f"mean {backend}")
        assert (got[_t(no_valid)] == 0).all()
    got = segment.segment_max(e_t, *args_t)
    _close(got, jseg.segment_max(e, *args_j), what="max")
    assert no_valid.any() and (got[_t(no_valid)] == 0).all()


@pytest.mark.parametrize("graph", GRAPHS, ids=lambda g: g[0])
@pytest.mark.parametrize("heads", [None, 3])
def test_sddmm_softmax_and_attention_spmm_match_jax(graph, heads):
    _, src, dst, mask, n_src, n_dst = graph
    rng = np.random.default_rng(7)
    lead = () if heads is None else (heads,)
    a = rng.normal(size=(n_src,) + lead + (8,)).astype(np.float32)
    b = rng.normal(size=(n_dst,) + lead + (8,)).astype(np.float32)
    v = rng.normal(size=(n_src,) + lead + (5,)).astype(np.float32)
    s_j = jseg.sddmm_dot(jnp.asarray(a), jnp.asarray(b), jnp.asarray(src), jnp.asarray(dst))
    s_t = segment.sddmm_dot(_t(a), _t(b), _t(src), _t(dst))
    _close(s_t, s_j, what="sddmm_dot")
    for backend in BACKENDS:
        al_j = jseg.segment_softmax(s_j, jnp.asarray(dst), jnp.asarray(mask), n_dst, backend)
        al_t = segment.segment_softmax(s_t, _t(dst), _t(mask), n_dst, backend)
        _close(al_t, al_j, what=f"softmax {backend}")
        assert (al_t[~_t(mask)] == 0).all()
        out_j = jseg.spmm_attention(al_j, jnp.asarray(v), jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(mask), n_dst, backend)
        out_t = segment.spmm_attention(al_t, _t(v), _t(src), _t(dst), _t(mask), n_dst, backend)
        _close(out_t, out_j, what=f"spmm {backend}")


@pytest.mark.parametrize("graph", GRAPHS, ids=lambda g: g[0])
@pytest.mark.parametrize("backend", BACKENDS)
def test_gradients_of_the_ops_loss_match_jax(graph, backend):
    """``tests/test_ops.py:test_segment_ops_jit_and_grad``'s loss: sum of
    squares of the attention SpMM, the softmax of the summed gathered
    features; its gradient within 1e-5."""
    _, src, dst, mask, n_src, n_dst = graph
    vals = np.random.default_rng(3).normal(size=(n_src, 3)).astype(np.float32)

    def jax_loss(v, backend):
        e = jseg.gather_src(v, jnp.asarray(src))
        a = jseg.segment_softmax(jnp.sum(e, -1), jnp.asarray(dst), jnp.asarray(mask), n_dst,
                                 backend)
        return jnp.sum(jseg.spmm_attention(a, v, jnp.asarray(src), jnp.asarray(dst),
                                           jnp.asarray(mask), n_dst, backend) ** 2)

    want_loss = jax_loss(jnp.asarray(vals), backend)
    want_grad = jax.grad(jax_loss)(jnp.asarray(vals), backend)
    if backend == "onehot":
        assert np.isnan(np.asarray(want_grad)).any()    # JAX's quirk (module docstring)
        want_grad = jax.grad(jax_loss)(jnp.asarray(vals), "xla")
    v = _t(vals).requires_grad_(True)
    e = segment.gather_src(v, _t(src))
    a = segment.segment_softmax(e.sum(-1), _t(dst), _t(mask), n_dst, backend)
    loss = (segment.spmm_attention(a, v, _t(src), _t(dst), _t(mask), n_dst, backend) ** 2).sum()
    loss.backward()
    _close(loss, want_loss, GRAD_TOL, "loss")
    _close(v.grad, want_grad, GRAD_TOL, "grad")


def test_masked_edge_with_a_huge_score_sends_no_nan():
    src, dst = torch.tensor([0, 1, 2]), torch.tensor([0, 0, 1])
    mask = torch.tensor([True, False, True])
    scores = torch.tensor([0.5, 1e4, -2.0], requires_grad=True)
    alpha = segment.segment_softmax(scores, dst, mask, 2)
    (alpha * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    assert torch.equal(alpha.detach(), torch.tensor([1.0, 0.0, 1.0]))
    assert torch.isfinite(scores.grad).all() and scores.grad[1] == 0


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        segment.segment_sum(torch.ones(2), torch.tensor([0, 1]), torch.ones(2, dtype=torch.bool),
                            2, backend="pallas")
