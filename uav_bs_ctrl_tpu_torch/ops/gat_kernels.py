"""Projection-fused GATv2 attention: the CUDA kernel and its plain version.

Counterpart of ``uav_bs_ctrl_tpu/ops/pallas_kernels.py:flash_gat_fused``. The
kernel is ``csrc/flash_gat_fused.cu`` (forward only); one kernel serves both of
the JAX package's ``pallas_fused`` and ``pallas_fused_mxu`` backends, whose
difference is a TPU layout choice.
"""

import ctypes

import torch
import torch.nn.functional as F

from uav_bs_ctrl_tpu_torch.ops import build
from uav_bs_ctrl_tpu_torch.ops.masked import NEG_BIG

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_gat_fused_forward": (_I, [_P] * 9 + [_I] * 5 + [ctypes.c_float, _P]),
    "flash_gat_fused_error_string": (ctypes.c_char_p, [_I]),
}


def flash_gat_fused_plain(x, w, b, er, attn, mask, n_heads, negative_slope=0.2):
    """Plain PyTorch version of :func:`flash_gat_fused` (materializes ``el``).

    Same contract and the same all-masked rule; returns ``(out, m, l)``.
    """
    n, m, _ = x.shape
    hf = w.shape[1]
    f = hf // n_heads
    el = (x @ w + b).reshape(n, m, n_heads, f)
    e = F.leaky_relu(el + er.reshape(n, 1, n_heads, f), negative_slope)
    valid = (mask > 0)[:, :, None]
    scores = torch.where(valid, (e * attn).sum(-1), NEG_BIG)     # [N, M, H]
    mstat = torch.full((n, n_heads), NEG_BIG, dtype=x.dtype, device=x.device)
    if m:
        mstat = torch.maximum(mstat, scores.amax(1))
    shift = torch.where(mstat <= NEG_BIG / 2, 0.0, mstat)
    p = torch.where(valid, torch.exp(scores - shift[:, None, :]), 0.0)
    lstat = p.sum(1)
    out = torch.einsum("nmh,nmhf->nhf", p, el) / torch.clamp_min(lstat, 1e-30)[..., None]
    return out.reshape(n, hf), mstat, lstat


def flash_gat_fused(x, w, b, er, attn, mask, n_heads, negative_slope=0.2):
    """Fused projection + masked GATv2 attention + aggregation.

    x: [N, M, D] raw source features per destination slot; w: [D, H*F] and
    b: [H*F], the source projection; er: [N, H*F] projected destination
    features; attn: [H, F]; mask: [N, M] float, > 0 where a slot is valid.
    Returns ``(out [N, H*F], m [N, H], l [N, H])``: the aggregation and the
    f32 softmax statistics. Rows with no valid slot give 0.

    A CPU tensor runs the plain version; a CUDA tensor always launches the
    kernel (float32, contiguous, H*F <= 1024, F a multiple of 32) or raises.
    """
    if x.device.type == "cpu":
        return flash_gat_fused_plain(x, w, b, er, attn, mask, n_heads, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"flash_gat_fused runs on cpu or cuda, not {x.device}")
    n, m, d = x.shape
    hf = w.shape[1]
    f = hf // n_heads
    expected = {"w": (d, hf), "b": (hf,), "er": (n, hf), "attn": (n_heads, f),
                "mask": (n, m)}
    for name, t in (("w", w), ("b", b), ("er", er), ("attn", attn), ("mask", mask)):
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")
    if hf % n_heads or f % 32 or hf > 1024:
        raise ValueError(f"the kernel needs H*F <= 1024 with F a multiple of 32; "
                         f"got H={n_heads}, H*F={hf}")
    out = torch.empty((n, hf), dtype=torch.float32, device=x.device)
    mstat = torch.empty((n, n_heads), dtype=torch.float32, device=x.device)
    lstat = torch.empty_like(mstat)
    ptrs = build.pointers(x.device, {"x": x, "w": w, "b": b, "er": er, "attn": attn,
                                     "mask": mask, "out": out, "m": mstat, "l": lstat})
    lib = build.load("flash_gat_fused", _SIGNATURES)
    err = lib.flash_gat_fused_forward(*ptrs, n, m, d, hf, n_heads, float(negative_slope),
                                      build.stream_of(x.device))
    build.check_launch(lib, "flash_gat_fused_error_string", err, "flash_gat_fused")
    flash_gat_fused.launches += 1
    return out, mstat, lstat


flash_gat_fused.launches = 0
