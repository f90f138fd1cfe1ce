"""Fused recurrent step (TarMAC + GRU + Q head): the CUDA kernel and its plain version.

Counterpart of ``uav_bs_ctrl_tpu/ops/step_kernels.py:tarmac_step``, with the
same flattened contract. The kernel is ``csrc/tarmac_step.cu`` (forward only).
"""

import ctypes

import torch

from uav_bs_ctrl_tpu_torch.models.modules import gru
from uav_bs_ctrl_tpu_torch.ops import build
from uav_bs_ctrl_tpu_torch.ops.masked import masked_softmax

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tarmac_step_forward": (_I, [_P] * 19 + [_I] * 7 + [ctypes.c_float, _P]),
    "tarmac_step_error_string": (ctypes.c_char_p, [_I]),
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


def tarmac_step(x, h, adjf, wv, bv, ws, bs, wq, bq, wi, wh, bi, bh, wo, bo,
                wvh, bvh, a, key_size, dueling):
    """One TarMAC round + GRU cell + (dueling) Q head for every (world, agent) row.

    x, h: [W*A, H] rows world-major; adjf: [W*A, A] float, adjf[w*A+i, j] > 0
    for the edge i -> j in world w (rows are sources). Weights are ``[in, out]``
    as in the JAX package; ``wvh``/``bvh`` are read only when ``dueling``.
    Returns ``(q [W*A, n_act], h2 [W*A, H])``.

    A CPU tensor runs the plain version; a CUDA tensor always launches the
    kernel (float32, contiguous) or raises.
    """
    weights = dict(zip(_WEIGHTS, (wv, bv, ws, bs, wq, bq, wi, wh, bi, bh,
                                  wo, bo, wvh, bvh)))
    if x.device.type == "cpu":
        return tarmac_step_plain(x, h, adjf, *weights.values(), a, key_size, dueling)
    if x.device.type != "cuda":
        raise ValueError(f"tarmac_step runs on cpu or cuda, not {x.device}")
    rows, hidden = x.shape
    msg, ks, n_act = wv.shape[1], ws.shape[1], wo.shape[1]
    if rows % a:
        raise ValueError(f"{rows} rows is not a whole number of worlds of {a} agents")
    expected = {"wv": (2 * hidden, msg), "bv": (msg,), "ws": (2 * hidden, ks), "bs": (ks,),
                "wq": (2 * hidden, ks), "bq": (ks,), "wi": (hidden + msg, 3 * hidden),
                "wh": (hidden, 3 * hidden), "bi": (3 * hidden,), "bh": (3 * hidden,),
                "wo": (hidden, n_act), "bo": (n_act,), "wvh": (hidden, 1), "bvh": (1,)}
    for name, t in (("h", h), ("adjf", adjf)):
        want = (rows, hidden) if name == "h" else (rows, a)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
    for name, t in weights.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")
    q = torch.empty((rows, n_act), dtype=torch.float32, device=x.device)
    h2 = torch.empty((rows, hidden), dtype=torch.float32, device=x.device)
    ptrs = build.pointers(x.device, {"x": x, "h": h, "adjf": adjf, **weights,
                                     "q": q, "h2": h2})
    lib = build.load("tarmac_step", _SIGNATURES)
    err = lib.tarmac_step_forward(*ptrs, rows // a, a, hidden, msg, ks, n_act,
                                  int(bool(dueling)), float(key_size),
                                  build.stream_of(x.device))
    build.check_launch(lib, "tarmac_step_error_string", err, "tarmac_step")
    tarmac_step.launches += 1
    return q, h2


tarmac_step.launches = 0
