"""Fused recurrent step (TarMAC + GRU + Q head): the CUDA kernels and their plain versions.

Counterpart of ``uav_bs_ctrl_tpu/ops/step_kernels.py``, with the same
flattened contract: ``tarmac_step`` (forward, ``csrc/tarmac_step.cu``),
``tarmac_step_bwd`` (the recompute backward of ``_tst_bwd``,
``csrc/tarmac_step_bwd.cu``) and ``tarmac_step_train``, the
``torch.autograd.Function`` that joins them (``tarmac_step_train``'s custom VJP).

Both take float32 or bfloat16 operands (one type for all) and launch that
type's instantiation, as JAX's kernels widen every bf16 input to f32 inside:
``q``, ``h'`` and every gradient come back in the operands' type, the scratch
is f32. Each wrapper counts its launches (``launches``) and its bf16 ones
(``launches_bf16``).
"""

import ctypes

import torch

from uav_bs_ctrl_tpu_torch.models.modules import gru
from uav_bs_ctrl_tpu_torch.ops import build
from uav_bs_ctrl_tpu_torch.ops.masked import masked_softmax

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = (_I, [_P] * 20 + [_I] * 7 + [ctypes.c_float, _P])
_BWD_ARGS = (_I, [_P] * 36 + [_I] * 7 + [ctypes.c_float, _P])
_SIGNATURES = {
    "tarmac_step_forward": _FWD_ARGS,
    "tarmac_step_forward_bf16": _FWD_ARGS,
    "tarmac_step_error_string": (ctypes.c_char_p, [_I]),
}
_BWD_SIGNATURES = {
    "tarmac_step_backward": _BWD_ARGS,
    "tarmac_step_backward_bf16": _BWD_ARGS,
    "tarmac_step_bwd_error_string": (ctypes.c_char_p, [_I]),
}
_WEIGHTS = ("wv", "bv", "ws", "bs", "wq", "bq", "wi", "wh", "bi", "bh",
            "wo", "bo", "wvh", "bvh")


def tarmac_step_plain(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh,
                      wo, bo, wvh, bvh, a, key_size, dueling):
    """Plain PyTorch version of :func:`tarmac_step` (same flattened contract)."""
    w = x.shape[0] // a
    x3 = x.reshape(w, a, -1)
    h3 = h.reshape(w, a, -1)
    adj = adjf.reshape(w, a, a) > 0
    inputs = torch.cat([x3, h3.detach()], dim=-1)
    v = inputs @ wv + bv
    s = inputs @ ws + bs
    q = inputs @ wq + bq
    scores = torch.einsum("wsk,wdk->wsd", s, q) / key_size
    alpha = masked_softmax(scores, adj, dim=-2)          # over sources, per destination
    c = torch.einsum("wsd,wsm->wdm", alpha, v)
    h2 = gru(torch.cat([x3, c], dim=-1), h3, wi, wh, bi, bh)
    adv = h2 @ wo + bo
    if dueling:
        qv = (h2 @ wvh + bvh) + adv - adv.mean(-1, keepdim=True)
    else:
        qv = adv
    return qv.reshape(w * a, -1), h2.reshape(w * a, -1)


def _check_shapes(what, x, h, adjf, weights, a, **backward):
    """Raise unless the operands fit the kernels; ``backward`` holds the
    backward's cotangents (``gq``, ``gh2``). Returns ``(rows, hidden, n_act)``."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    n_rows, hidden = x.shape
    wv, ws, wo = weights["wv"], weights["ws"], weights["wo"]
    msg, ks, n_act = wv.shape[1], ws.shape[1], wo.shape[1]
    if n_rows % a:
        raise ValueError(f"{n_rows} rows is not a whole number of worlds of {a} agents")
    expected = {"wv": (2 * hidden, msg), "bv": (msg,), "ws": (2 * hidden, ks), "bs": (ks,),
                "wq": (2 * hidden, ks), "bq": (ks,), "wi": (hidden + msg, 3 * hidden),
                "wh": (hidden, 3 * hidden), "bi": (3 * hidden,), "bh": (3 * hidden,),
                "wo": (hidden, n_act), "bo": (n_act,), "wvh": (hidden, 1), "bvh": (1,),
                "h": (n_rows, hidden), "adjf": (n_rows, a), "gq": (n_rows, n_act),
                "gh2": (n_rows, hidden)}
    for name, t in (("h", h), ("adjf", adjf), *weights.items(), *backward.items()):
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")
    return n_rows, hidden, n_act


def tarmac_step(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo,
                wvh, bvh, a, key_size, dueling):
    """One TarMAC round + GRU cell + (dueling) Q head for every (world, agent) row.

    x, h: [W*A, H] rows world-major; adjf: [W*A, A] float, adjf[w*A+i, j] > 0
    for the edge i -> j in world w (rows are sources). Weights are ``[in, out]``
    as in the JAX package; ``wvh``/``bvh`` are read only when ``dueling``.
    Returns ``(q [W*A, n_act], h2 [W*A, H])``.

    A CPU tensor runs the plain version; a CUDA tensor always launches the
    kernel of its dtype (float32 or bfloat16, one for every operand,
    contiguous) or raises.
    """
    weights = dict(zip(_WEIGHTS, (wv, bv, ws, bs, wq, bq, wi, wh, bi, bh,
                                  wo, bo, wvh, bvh)))
    if x.device.type == "cpu":
        return tarmac_step_plain(x, h, adjf, *weights.values(), a, key_size, dueling)
    rows, hidden, n_act = _check_shapes("tarmac_step", x, h, adjf, weights, a)
    dtype = build.storage_type("tarmac_step", x, h, adjf, *weights.values())
    msg, ks = wv.shape[1], ws.shape[1]
    q = torch.empty((rows, n_act), dtype=dtype, device=x.device)
    h2 = torch.empty((rows, hidden), dtype=dtype, device=x.device)
    scratch = torch.empty(max(1, fwd_scratch_floats(rows, hidden, msg, ks)),
                          dtype=torch.float32, device=x.device)
    ptrs = build.pointers(x.device, {"x": x, "h": h, "adjf": adjf, **weights,
                                     "q": q, "h2": h2, "scratch": scratch},
                          dtype, f32=("scratch",))
    lib = build.load("tarmac_step", _SIGNATURES)
    launch = getattr(lib, "tarmac_step_forward" + build.SUFFIX[dtype])
    err = launch(*ptrs, rows // a, a, hidden, msg, ks, n_act, int(bool(dueling)),
                 float(key_size), build.stream_of(x.device))
    build.check_launch(lib, "tarmac_step_error_string", err, "tarmac_step")
    build.count_launch(tarmac_step, dtype)
    return q, h2


tarmac_step.launches = tarmac_step.launches_bf16 = 0


def tarmac_step_bwd_plain(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh,
                          wo, bo, wvh, bvh, gq, gh2, a, key_size, dueling):
    """Plain PyTorch version of :func:`tarmac_step_bwd`, in the order of
    ``step_kernels.py:_step_bwd_kernel``: recompute, head, GRU, attention, then
    the v/s/q linears. ``h`` reaches v/s/q without gradient, so ``dh`` carries
    the GRU path only, while ``dwv/dws/dwq`` still see ``h`` as an input.
    """
    n_rows, hid = x.shape
    w = n_rows // a
    x3, h3 = x.reshape(w, a, hid), h.reshape(w, a, hid)
    gq3, gh3 = gq.reshape(w, a, -1), gh2.reshape(w, a, hid)
    adj = adjf.reshape(w, a, a) > 0
    flat = lambda t: t.reshape(-1, t.shape[-1])
    # forward recompute
    inputs = torch.cat([x3, h3], dim=-1)
    v = inputs @ wv + bv
    s = inputs @ ws + bs
    q = inputs @ wq + bq
    alpha = masked_softmax(torch.einsum("wsk,wdk->wsd", s, q) / key_size, adj, dim=-2)
    c = torch.einsum("wsd,wsm->wdm", alpha, v)
    u = torch.cat([x3, c], dim=-1)
    i_r, i_z, i_n = torch.chunk(u @ wi + bi, 3, dim=-1)
    h_r, h_z, hn = torch.chunk(h3 @ wh + bh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * hn)
    h2 = (1 - z) * n + z * h3
    # head
    if dueling:
        dvh = gq3.sum(-1, keepdim=True)
        dadv = gq3 - gq3.mean(-1, keepdim=True)
        dh2 = dadv @ wo.T + dvh @ wvh.T
    else:
        dvh = torch.zeros_like(gq3[..., :1])
        dadv = gq3
        dh2 = dadv @ wo.T
    dh2 = dh2 + gh3
    # GRU
    dn = dh2 * (1 - z)
    dz = dh2 * (h3 - n)
    dpre_n = dn * (1 - n * n)
    dr = dpre_n * hn
    dhn = dpre_n * r
    dpre_z = dz * z * (1 - z)
    dpre_r = dr * r * (1 - r)
    dgi = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1)
    dgh = torch.cat([dpre_r, dpre_z, dhn], dim=-1)
    du = dgi @ wi.T
    dx, dc = du[..., :hid], du[..., hid:]
    dh = dh2 * z + dgh @ wh.T
    # attention
    dalpha = torch.einsum("wsm,wdm->wsd", v, dc)
    dv = torch.einsum("wsd,wdm->wsm", alpha, dc)
    dscore = alpha * (dalpha - (alpha * dalpha).sum(1, keepdim=True))
    ds = torch.einsum("wsd,wdk->wsk", dscore, q) / key_size
    dq = torch.einsum("wsd,wsk->wdk", dscore, s) / key_size
    # v/s/q linears
    dx = dx + dv @ wv[:hid].T + ds @ ws[:hid].T + dq @ wq[:hid].T
    grads = []
    for inp, g_out in ((inputs, dv), (inputs, ds), (inputs, dq)):
        grads += [flat(inp).T @ flat(g_out), flat(g_out).sum(0)]
    grads += [flat(u).T @ flat(dgi), flat(h3).T @ flat(dgh), flat(dgi).sum(0),
              flat(dgh).sum(0), flat(h2).T @ flat(dadv), flat(dadv).sum(0),
              flat(h2).T @ flat(dvh), flat(dvh).sum(0)]
    return (dx.reshape(n_rows, hid), dh.reshape(n_rows, hid), *grads)


def fwd_scratch_floats(rows, hidden, msg, key):
    """Floats of the scratch buffer ``tarmac_step``'s launches hand on to each
    other: per row v|s|q, c, and the GRU's two pre-activations gi and gh."""
    return rows * (2 * msg + 2 * key + 6 * hidden)


SPLIT_ROWS, MAX_SPLIT = 256, 16    # csrc/tarmac_step_bwd.cu's kSplitRows, kMaxSplit


def split_chunks(rows):
    """The row chunks each weight gradient's sum over ``rows`` rows is split
    into (``csrc/tarmac_step_bwd.cu:split_chunks``)."""
    return max(1, min(MAX_SPLIT, -(-rows // SPLIT_ROWS)))


def weight_floats(hidden, msg, key, n_act):
    """Entries of all 14 weight and bias gradients."""
    return (2 * hidden * (msg + 2 * key) + 6 * hidden * hidden + 3 * msg * hidden
            + hidden * (n_act + 1) + msg + 2 * key + 6 * hidden + n_act + 1)


def bwd_scratch_floats(rows, hidden, msg, key, n_act, bf16=False):
    """Floats of the scratch buffer ``tarmac_step_bwd``'s launches hand on to
    each other: per row dpre_r|dpre_z|dpre_n|dhn, c, h2, dv, ds, dq, dadv,
    dvh, v|s|q, the GRU's two pre-activations gi and gh, and dc; at bf16 also
    the f32 sums of dx and dh; then each weight gradient's f32 partials, one
    per row chunk."""
    per_row = rows * (11 * hidden + 4 * msg + 4 * key + n_act + 1 + (2 * hidden if bf16 else 0))
    return per_row + split_chunks(rows) * weight_floats(hidden, msg, key, n_act)


def tarmac_step_bwd(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo,
                    wvh, bvh, gq, gh2, a, key_size, dueling):
    """Backward of :func:`tarmac_step` by recompute, from its inputs and the
    cotangents ``gq`` [W*A, n_act], ``gh2`` [W*A, H].

    Returns ``(dx, dh, dwv, dbv, dws, dbs, dwq, dbq, dwi, dwh, dbi, dbh, dwo,
    dbo, dwvh, dbvh)`` in the operands' shapes; ``dh`` is the GRU path only
    (``h`` is stop-gradient into v/s/q); ``dwvh``/``dbvh`` are zero without
    ``dueling``; all in the operands' dtype. A CPU tensor runs the plain
    version; a CUDA tensor always launches the kernel of its dtype or raises.
    """
    weights = dict(zip(_WEIGHTS, (wv, bv, ws, bs, wq, bq, wi, wh, bi, bh,
                                  wo, bo, wvh, bvh)))
    if x.device.type == "cpu":
        return tarmac_step_bwd_plain(x, h, adjf, *weights.values(), gq, gh2, a,
                                     key_size, dueling)
    rows, hidden, n_act = _check_shapes("tarmac_step_bwd", x, h, adjf, weights, a,
                                        gq=gq, gh2=gh2)
    dtype = build.storage_type("tarmac_step_bwd", x, h, adjf, *weights.values(), gq, gh2)
    msg, ks = wv.shape[1], ws.shape[1]
    dx = torch.empty_like(x)
    dh = torch.empty_like(h)
    dweights = {f"d{k}": torch.empty_like(t) for k, t in weights.items()}
    scratch = torch.empty(max(1, bwd_scratch_floats(rows, hidden, msg, ks, n_act,
                                                    dtype == torch.bfloat16)),
                          dtype=torch.float32, device=x.device)
    ptrs = build.pointers(x.device, {"x": x, "h": h, "adjf": adjf, **weights, "gq": gq,
                                     "gh2": gh2, "dx": dx, "dh": dh, **dweights,
                                     "scratch": scratch}, dtype, f32=("scratch",))
    lib = build.load("tarmac_step_bwd", _BWD_SIGNATURES)
    launch = getattr(lib, "tarmac_step_backward" + build.SUFFIX[dtype])
    err = launch(*ptrs, rows // a, a, hidden, msg, ks, n_act, int(bool(dueling)),
                 float(key_size), build.stream_of(x.device))
    build.check_launch(lib, "tarmac_step_bwd_error_string", err, "tarmac_step_bwd")
    build.count_launch(tarmac_step_bwd, dtype)
    return (dx, dh, *dweights.values())


tarmac_step_bwd.launches = tarmac_step_bwd.launches_bf16 = 0


class _TarmacStepFn(torch.autograd.Function):
    """``tarmac_step`` forward + ``tarmac_step_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, h, adjf, *rest):
        tensors = tuple(t.detach() for t in (x, h, adjf) + rest[:14])
        q, h2 = tarmac_step(*tensors, *rest[14:])
        ctx.save_for_backward(*tensors)
        ctx.cfg = rest[14:]
        return q, h2

    @staticmethod
    def backward(ctx, gq, gh2):
        grads = tarmac_step_bwd(*ctx.saved_tensors, gq.contiguous(), gh2.contiguous(),
                                *ctx.cfg)
        need = ctx.needs_input_grad
        grads = grads[:2] + (None,) + grads[2:]
        return tuple(g if need[i] else None for i, g in enumerate(grads)) + (None,) * 3


def tarmac_step_train(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo,
                      wvh, bvh, a, key_size, dueling):
    """Differentiable :func:`tarmac_step` (same contract): one forward launch,
    and autograd's backward is one :func:`tarmac_step_bwd` call. ``adjf``
    gets no gradient."""
    return _TarmacStepFn.apply(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh,
                               wo, bo, wvh, bvh, a, key_size, dueling)
