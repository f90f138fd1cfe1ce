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

The column split, an mp rank's share of the step's GRU (the hidden columns
``cols = (lo, hi)`` of each gate; ``parallel/mp_split.py`` joins them with
the collectives): :func:`tarmac_step_cols` (h2's columns in f32), then
:func:`tarmac_step_head` on h2 gathered over the ranks (q, h2);
:func:`tarmac_step_bwd_cols` (full-width partials ``red`` of dx, dc and dh),
then :func:`tarmac_step_bwd_rest` on ``red`` summed over the ranks (dx, dh,
the replicated weights' gradients and the columns' share of the others).
Each has a plain version here, and records the ``(lo, hi, H)`` of its calls
in ``shapes``. With ``cols = (0, H)`` the pairs give :func:`tarmac_step`'s
and :func:`tarmac_step_bwd`'s outputs bit for bit on the card.
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
_COLS_SIGNATURES = {
    "tarmac_step_forward_cols": (_I, [_P] * 15 + [_I] * 7 + [ctypes.c_float, _P]),
    "tarmac_step_forward_cols_bf16": (_I, [_P] * 15 + [_I] * 7 + [ctypes.c_float, _P]),
    "tarmac_step_forward_head": (_I, [_P] * 7 + [_I] * 4 + [_P]),
    "tarmac_step_forward_head_bf16": (_I, [_P] * 7 + [_I] * 4 + [_P]),
}
_BWD_COLS_SIGNATURES = {
    "tarmac_step_backward_cols": (_I, [_P] * 19 + [_I] * 9 + [ctypes.c_float, _P]),
    "tarmac_step_backward_cols_bf16": (_I, [_P] * 19 + [_I] * 9 + [ctypes.c_float, _P]),
    "tarmac_step_backward_rest": (_I, [_P] * 24 + [_I] * 8 + [ctypes.c_float, _P]),
    "tarmac_step_backward_rest_bf16": (_I, [_P] * 24 + [_I] * 8 + [ctypes.c_float, _P]),
}
_LIB = {"tarmac_step": {**_SIGNATURES, **_COLS_SIGNATURES},     # every entry point of a library
        "tarmac_step_bwd": {**_BWD_SIGNATURES, **_BWD_COLS_SIGNATURES}}
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
    wv, ws = weights["wv"], weights["ws"]
    msg, ks = wv.shape[1], ws.shape[1]
    n_act = weights["wo"].shape[1] if "wo" in weights else None     # no head: tarmac_step_cols
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
    lib = build.load("tarmac_step", _LIB["tarmac_step"])
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
    lib = build.load("tarmac_step_bwd", _LIB["tarmac_step_bwd"])
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


# ---- the column split ----

def gate_columns(hidden, cols):
    """The columns of ``[.., 3H]`` that hold the columns ``cols = (lo, hi)``
    of each gate r, z, n: ``[lo, hi) + g H``."""
    lo, hi = cols
    return torch.cat([torch.arange(lo, hi) + g * hidden for g in range(3)])


def _check_cols(hidden, cols):
    lo, hi = cols
    if not 0 <= lo < hi <= hidden:
        raise ValueError(f"columns {cols} are not a range of the hidden width {hidden}")
    return lo, hi


def _stat_type(dtype):
    return torch.promote_types(dtype, torch.float32)


def tarmac_step_cols_plain(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, a, key_size,
                           cols):
    """Plain PyTorch version of :func:`tarmac_step_cols`."""
    lo, hi = cols
    w = x.shape[0] // a
    x3, h3 = x.reshape(w, a, -1), h.reshape(w, a, -1)
    inputs = torch.cat([x3, h3], dim=-1)
    scores = torch.einsum("wsk,wdk->wsd", inputs @ ws + bs, inputs @ wq + bq) / key_size
    alpha = masked_softmax(scores, adjf.reshape(w, a, a) > 0, dim=-2)
    c = torch.einsum("wsd,wsm->wdm", alpha, inputs @ wv + bv)
    idx = gate_columns(x.shape[1], cols).to(x.device)
    i_r, i_z, i_n = torch.chunk(torch.cat([x3, c], dim=-1) @ wi[:, idx] + bi[idx], 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(h3 @ wh[:, idx] + bh[idx], 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    h2 = (1 - z) * n + z * h3[..., lo:hi]
    return h2.reshape(w * a, hi - lo).to(_stat_type(x.dtype))


def tarmac_step_cols(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, a, key_size, cols):
    """A column split's first half of :func:`tarmac_step`: the columns
    ``cols = (lo, hi)`` of h2, ``[W*A, hi - lo]`` in float32 (v|s|q and c
    whole, the GRU on those columns of each gate). A CPU tensor runs the
    plain version; a CUDA tensor always launches the kernel of its dtype or
    raises."""
    rows, hidden = x.shape
    lo, hi = _check_cols(hidden, cols)
    tarmac_step_cols.shapes.add((lo, hi, hidden))
    weights = dict(zip(_WEIGHTS[:10], (wv, bv, ws, bs, wq, bq, wi, wh, bi, bh)))
    if x.device.type == "cpu":
        return tarmac_step_cols_plain(x, h, adjf, *weights.values(), a, key_size, cols)
    _check_shapes("tarmac_step_cols", x, h, adjf, weights, a)
    dtype = build.storage_type("tarmac_step_cols", x, h, adjf, *weights.values())
    msg, ks = wv.shape[1], ws.shape[1]
    h2c = torch.empty((rows, hi - lo), dtype=torch.float32, device=x.device)
    scratch = torch.empty(max(1, fwd_scratch_floats(rows, hi - lo, msg, ks)),
                          dtype=torch.float32, device=x.device)
    ptrs = build.pointers(x.device, {"x": x, "h": h, "adjf": adjf, **weights, "h2c": h2c,
                                     "scratch": scratch}, dtype, f32=("h2c", "scratch"))
    lib = build.load("tarmac_step", _LIB["tarmac_step"])
    launch = getattr(lib, "tarmac_step_forward_cols" + build.SUFFIX[dtype])
    err = launch(*ptrs, rows // a, a, hidden, msg, ks, lo, hi, float(key_size),
                 build.stream_of(x.device))
    build.check_launch(lib, "tarmac_step_error_string", err, "tarmac_step_cols")
    build.count_launch(tarmac_step_cols, dtype)
    return h2c


def tarmac_step_head_plain(h2f, wo, bo, wvh, bvh, dueling):
    """Plain PyTorch version of :func:`tarmac_step_head`."""
    h2 = h2f.to(wo.dtype)
    adv = h2 @ wo + bo
    q = (h2 @ wvh + bvh) + adv - adv.mean(-1, keepdim=True) if dueling else adv
    return q, h2


def tarmac_step_head(h2f, wo, bo, wvh, bvh, dueling):
    """A column split's second half of :func:`tarmac_step`: from h2
    ``[W*A, H]`` in float32 (every rank's columns gathered), ``(q, h2)`` in
    ``wo``'s dtype. A CPU tensor runs the plain version; a CUDA tensor always
    launches the kernel or raises."""
    if h2f.device.type == "cpu":
        return tarmac_step_head_plain(h2f, wo, bo, wvh, bvh, dueling)
    rows, hidden = h2f.shape
    n_act = wo.shape[1]
    if (tuple(wo.shape), tuple(bo.shape), tuple(wvh.shape), tuple(bvh.shape)) != \
            ((hidden, n_act), (n_act,), (hidden, 1), (1,)):
        raise ValueError(f"head weights {tuple(wo.shape)}, {tuple(bo.shape)}, "
                         f"{tuple(wvh.shape)}, {tuple(bvh.shape)} for h2 {tuple(h2f.shape)}")
    dtype = build.storage_type("tarmac_step_head", wo, bo, wvh, bvh)
    q = torch.empty((rows, n_act), dtype=dtype, device=h2f.device)
    h2 = torch.empty((rows, hidden), dtype=dtype, device=h2f.device)
    ptrs = build.pointers(h2f.device, {"h2f": h2f, "wo": wo, "bo": bo, "wvh": wvh, "bvh": bvh,
                                       "q": q, "h2": h2}, dtype, f32=("h2f",))
    lib = build.load("tarmac_step", _LIB["tarmac_step"])
    launch = getattr(lib, "tarmac_step_forward_head" + build.SUFFIX[dtype])
    err = launch(*ptrs, rows, hidden, n_act, int(bool(dueling)), build.stream_of(h2f.device))
    build.check_launch(lib, "tarmac_step_error_string", err, "tarmac_step_head")
    build.count_launch(tarmac_step_head, dtype)
    return q, h2


def red_floats(rows, hidden, msg):
    """Floats of a column split's ``red``: dx, dc and dh, ``[rows, H]``,
    ``[rows, MSG]``, ``[rows, H]``, one after another."""
    return rows * (2 * hidden + msg)


def split_red(red, rows, hidden, msg):
    """``red``'s three blocks ``(dx, dc, dh)``."""
    dx, dc, dh = torch.split(red, [rows * hidden, rows * msg, rows * hidden])
    return dx.reshape(rows, hidden), dc.reshape(rows, msg), dh.reshape(rows, hidden)


def tarmac_step_bwd_cols_plain(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh,
                               wo, bo, wvh, bvh, gq, gh2, a, key_size, dueling, cols):
    """Plain PyTorch version of :func:`tarmac_step_bwd_cols`; its ``saved``
    is a dict of the intermediates the second half reads."""
    lo, hi = cols
    n_rows, hid = x.shape
    w = n_rows // a
    x3, h3 = x.reshape(w, a, hid), h.reshape(w, a, hid)
    gq3, gh3 = gq.reshape(w, a, -1), gh2.reshape(w, a, hid)
    inputs = torch.cat([x3, h3], dim=-1)
    v, s, q = inputs @ wv + bv, inputs @ ws + bs, inputs @ wq + bq
    alpha = masked_softmax(torch.einsum("wsk,wdk->wsd", s, q) / key_size,
                           adjf.reshape(w, a, a) > 0, dim=-2)
    c = torch.einsum("wsd,wsm->wdm", alpha, v)
    u = torch.cat([x3, c], dim=-1)
    idx = gate_columns(hid, cols).to(x.device)
    i_r, i_z, i_n = torch.chunk(u @ wi[:, idx] + bi[idx], 3, dim=-1)
    h_r, h_z, hn = torch.chunk(h3 @ wh[:, idx] + bh[idx], 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * hn)
    hs = h3[..., lo:hi]
    h2 = (1 - z) * n + z * hs
    if dueling:
        dvh = gq3.sum(-1, keepdim=True)
        dadv = gq3 - gq3.mean(-1, keepdim=True)
        dh2 = dadv @ wo[lo:hi].T + dvh @ wvh[lo:hi].T
    else:
        dvh = torch.zeros_like(gq3[..., :1])
        dadv = gq3
        dh2 = dadv @ wo[lo:hi].T
    dh2 = dh2 + gh3[..., lo:hi]
    dn = dh2 * (1 - z)
    dz = dh2 * (hs - n)
    dpre_n = dn * (1 - n * n)
    dhn = dpre_n * r
    dpre_z = dz * z * (1 - z)
    dpre_r = dpre_n * hn * r * (1 - r)
    dgi = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1)
    dgh = torch.cat([dpre_r, dpre_z, dhn], dim=-1)
    du = dgi @ wi[:, idx].T
    dh = dgh @ wh[:, idx].T
    dh[..., lo:hi] += dh2 * z
    stat = _stat_type(x.dtype)
    red = torch.cat([du[..., :hid].reshape(-1), du[..., hid:].reshape(-1),
                     dh.reshape(-1)]).to(stat)
    saved = dict(inputs=inputs, u=u, alpha=alpha, v=v, s=s, q=q, dgi=dgi, dgh=dgh, h2=h2,
                 dadv=dadv, dvh=dvh)
    return red, saved


def tarmac_step_bwd_rest_plain(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh,
                               wo, bo, wvh, bvh, red, saved, a, key_size, dueling, cols):
    """Plain PyTorch version of :func:`tarmac_step_bwd_rest`."""
    lo, hi = cols
    n_rows, hid = x.shape
    w = n_rows // a
    flat = lambda t: t.reshape(-1, t.shape[-1])
    dx, dc, dh = (t.to(x.dtype).reshape(w, a, -1)
                  for t in split_red(red, n_rows, hid, wv.shape[1]))
    alpha, v, s, q = saved["alpha"], saved["v"], saved["s"], saved["q"]
    dalpha = torch.einsum("wsm,wdm->wsd", v, dc)
    dv = torch.einsum("wsd,wdm->wsm", alpha, dc)
    dscore = alpha * (dalpha - (alpha * dalpha).sum(1, keepdim=True))
    ds = torch.einsum("wsd,wdk->wsk", dscore, q) / key_size
    dq = torch.einsum("wsd,wsk->wdk", dscore, s) / key_size
    dx = dx + dv @ wv[:hid].T + ds @ ws[:hid].T + dq @ wq[:hid].T
    grads = []
    for g_out in (dv, ds, dq):
        grads += [flat(saved["inputs"]).T @ flat(g_out), flat(g_out).sum(0)]
    idx = gate_columns(hid, cols).to(x.device)
    dwi, dwh = torch.zeros_like(wi), torch.zeros_like(wh)
    dbi, dbh = torch.zeros_like(bi), torch.zeros_like(bh)
    dgi, dgh = flat(saved["dgi"]), flat(saved["dgh"])
    dwi[:, idx] = flat(saved["u"]).T @ dgi
    dwh[:, idx] = flat(h.reshape(w, a, hid)).T @ dgh
    dbi[idx], dbh[idx] = dgi.sum(0), dgh.sum(0)
    dwo, dwvh = torch.zeros_like(wo), torch.zeros_like(wvh)
    h2, dadv, dvh = flat(saved["h2"]), flat(saved["dadv"]), flat(saved["dvh"])
    dwo[lo:hi], dwvh[lo:hi] = h2.T @ dadv, h2.T @ dvh
    grads += [dwi, dwh, dbi, dbh, dwo, dadv.sum(0), dwvh, dvh.sum(0)]
    return (dx.reshape(n_rows, hid), dh.reshape(n_rows, hid), *grads)


def bwd_cols_scratch_floats(rows, hidden, msg, key, n_act, cols):
    """Floats of the scratch a column split's backward hands from
    :func:`tarmac_step_bwd_cols` to :func:`tarmac_step_bwd_rest`
    (``csrc/tarmac_step_bwd.cu:carve_cols``): per row dg, c, h2, dv, ds, dq,
    dadv, dvh, v|s|q, gi and gh, the GRU's ``w = hi - lo`` wide; then each
    weight gradient's f32 partials, one per row chunk, the columns' share of
    wi, wh, bi, bh, wo and wvh only."""
    w = cols[1] - cols[0]
    per_row = rows * (11 * w + 3 * msg + 4 * key + n_act + 1)
    weights = (2 * hidden * (msg + 2 * key) + 3 * w * (hidden + msg) + 3 * hidden * w
               + w * (n_act + 1) + msg + 2 * key + 6 * w + n_act + 1)
    return per_row + split_chunks(rows) * weights


def tarmac_step_bwd_cols(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo,
                         wvh, bvh, gq, gh2, a, key_size, dueling, cols):
    """A column split's first half of :func:`tarmac_step_bwd`: recompute,
    then the head and the GRU backward on the columns ``cols = (lo, hi)`` of
    each gate, and their products into full-width partials of dx, dc and dh
    (dh2 z on the columns added to dh). Returns ``(red, saved)``: ``red``
    float32 ``[W*A*(2H + MSG)]`` (:func:`split_red`), to be summed over the
    ranks, and what :func:`tarmac_step_bwd_rest` reads (the kernel's scratch
    on the card). A CPU tensor runs the plain version; a CUDA tensor always
    launches the kernel of its dtype or raises."""
    weights = dict(zip(_WEIGHTS, (wv, bv, ws, bs, wq, bq, wi, wh, bi, bh,
                                  wo, bo, wvh, bvh)))
    rows, hidden = x.shape
    lo, hi = _check_cols(hidden, cols)
    tarmac_step_bwd_cols.shapes.add((lo, hi, hidden))
    if x.device.type == "cpu":
        return tarmac_step_bwd_cols_plain(x, h, adjf, *weights.values(), gq, gh2, a,
                                          key_size, dueling, cols)
    _, _, n_act = _check_shapes("tarmac_step_bwd_cols", x, h, adjf, weights, a, gq=gq, gh2=gh2)
    dtype = build.storage_type("tarmac_step_bwd_cols", x, h, adjf, *weights.values(), gq, gh2)
    msg, ks = wv.shape[1], ws.shape[1]
    red = torch.empty(red_floats(rows, hidden, msg), dtype=torch.float32, device=x.device)
    scratch = torch.empty(max(1, bwd_cols_scratch_floats(rows, hidden, msg, ks, n_act, cols)),
                          dtype=torch.float32, device=x.device)
    del weights["bo"], weights["bvh"]
    ptrs = build.pointers(x.device, {"x": x, "h": h, "adjf": adjf, **weights, "gq": gq,
                                     "gh2": gh2, "red": red, "scratch": scratch}, dtype,
                          f32=("red", "scratch"))
    lib = build.load("tarmac_step_bwd", _LIB["tarmac_step_bwd"])
    launch = getattr(lib, "tarmac_step_backward_cols" + build.SUFFIX[dtype])
    err = launch(*ptrs, rows // a, a, hidden, msg, ks, n_act, int(bool(dueling)), lo, hi,
                 float(key_size), build.stream_of(x.device))
    build.check_launch(lib, "tarmac_step_bwd_error_string", err, "tarmac_step_bwd_cols")
    build.count_launch(tarmac_step_bwd_cols, dtype)
    return red, scratch


def tarmac_step_bwd_rest(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo,
                         wvh, bvh, red, saved, a, key_size, dueling, cols):
    """A column split's second half of :func:`tarmac_step_bwd`, from ``red``
    summed over the ranks and the first half's ``saved``: the attention
    backward and the products of ``[dv|ds|dq]``. Returns ``(dx, dh, dwv,
    ..., dbvh)`` as :func:`tarmac_step_bwd`, each weight's gradient full
    size: the whole gradient of wv, bv, ws, bs, wq, bq, bo and bvh (the
    replicated compute), the columns ``cols`` of each gate of wi, wh, bi,
    bh and the rows ``cols`` of wo and wvh, zeros elsewhere. The kernel sums
    dx into ``red``'s dx block in place. A CPU tensor runs the plain version;
    a CUDA tensor always launches the kernel of its dtype or raises."""
    weights = dict(zip(_WEIGHTS, (wv, bv, ws, bs, wq, bq, wi, wh, bi, bh,
                                  wo, bo, wvh, bvh)))
    rows, hidden = x.shape
    lo, hi = _check_cols(hidden, cols)
    tarmac_step_bwd_rest.shapes.add((lo, hi, hidden))
    if x.device.type == "cpu":
        return tarmac_step_bwd_rest_plain(x, h, adjf, *weights.values(), red, saved, a,
                                          key_size, dueling, cols)
    _, _, n_act = _check_shapes("tarmac_step_bwd_rest", x, h, adjf, weights, a)
    dtype = build.storage_type("tarmac_step_bwd_rest", x, h, adjf, *weights.values())
    msg, ks = wv.shape[1], ws.shape[1]
    if red.numel() != red_floats(rows, hidden, msg) or saved.numel() < bwd_cols_scratch_floats(
            rows, hidden, msg, ks, n_act, cols):
        raise ValueError("red or the saved scratch does not fit the call")
    dx = torch.empty_like(x)
    dh = torch.empty_like(h)
    dweights = {f"d{k}": torch.zeros_like(t) for k, t in weights.items()}
    ptrs = build.pointers(x.device, {"x": x, "h": h, "adjf": adjf, "wv": wv, "ws": ws,
                                     "wq": wq, "red": red, "dx": dx, "dh": dh, **dweights,
                                     "scratch": saved}, dtype, f32=("red", "scratch"))
    lib = build.load("tarmac_step_bwd", _LIB["tarmac_step_bwd"])
    launch = getattr(lib, "tarmac_step_backward_rest" + build.SUFFIX[dtype])
    err = launch(*ptrs, rows // a, a, hidden, msg, ks, n_act, lo, hi, float(key_size),
                 build.stream_of(x.device))
    build.check_launch(lib, "tarmac_step_bwd_error_string", err, "tarmac_step_bwd_rest")
    build.count_launch(tarmac_step_bwd_rest, dtype)
    return (dx, dh, *dweights.values())


for _fn in (tarmac_step_cols, tarmac_step_head, tarmac_step_bwd_cols, tarmac_step_bwd_rest):
    _fn.launches = _fn.launches_bf16 = 0
    _fn.shapes = set()
