"""GATv2 attention: the CUDA kernels and their plain versions.

Counterpart of ``uav_bs_ctrl_tpu/ops/pallas_kernels.py``: ``flash_gat`` (over a
pre-projected ``el``, inference only, ``csrc/flash_gat.cu``),
``flash_gat_fused`` (forward, ``csrc/flash_gat_fused.cu``),
``flash_gat_fused_bwd`` (the
recompute backward of ``_fgf_bwd``, ``csrc/flash_gat_fused_bwd.cu``) and
``flash_gat_fused_train``, the ``torch.autograd.Function`` that joins them
(``flash_gat_fused_train``'s custom VJP). One kernel pair serves both of the
JAX package's ``pallas_fused`` and ``pallas_fused_mxu`` backends, whose
difference is a TPU layout choice.

The fused pair takes float32 or bfloat16 operands (one type for all) and
launches that type's instantiation; f32 accumulation inside both, ``out``
and the gradients in the operands' type, the row statistics ``m``, ``l`` in
f32. At bf16 it computes the unrounded form: JAX's ``pallas_fused_mxu`` also
rounds the scores' input and the softmax weights to bf16 before its dots,
``pallas_fused`` does not (``tests/test_torch_bf16.py`` judges both packages
against an f64 referee). Each wrapper counts its launches (``launches``) and
its bf16 launches (``launches_bf16``). ``flash_gat`` (#1) is float32 only.
"""

import ctypes

import torch
import torch.nn.functional as F

from uav_bs_ctrl_tpu_torch.ops import build
from uav_bs_ctrl_tpu_torch.ops.masked import NEG_BIG

MAX_D = 8                 # source feature width the backward kernel holds in registers
_P, _I = ctypes.c_void_p, ctypes.c_int
_FLASH_SIGNATURES = {
    "flash_gat_forward": (_I, [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P]),
    "flash_gat_error_string": (ctypes.c_char_p, [_I]),
}
MAX_CTAS = 1024           # the backward's first launch's CTAs, one partial row each (kMaxCtas)
_FWD_ARGS = (_I, [_P] * 9 + [_I] * 5 + [ctypes.c_float, _P])
_BWD_ARGS = (_I, [_P] * 16 + [_I] * 5 + [ctypes.c_float, _P])
_SIGNATURES = {
    "flash_gat_fused_forward": _FWD_ARGS,
    "flash_gat_fused_forward_bf16": _FWD_ARGS,
    "flash_gat_fused_error_string": (ctypes.c_char_p, [_I]),
}
_BWD_SIGNATURES = {
    "flash_gat_fused_backward": _BWD_ARGS,
    "flash_gat_fused_backward_bf16": _BWD_ARGS,
    "flash_gat_fused_bwd_error_string": (ctypes.c_char_p, [_I]),
}


def flash_gat_plain(el, er, attn, mask, n_heads, negative_slope=0.2):
    """Plain PyTorch version of :func:`flash_gat` (the contract of the JAX
    package's ``flash_gat_reference``): materialized scores, a masked
    softmax over M with the all-masked rule, then ``sum alpha * el``."""
    n, m, hf = el.shape
    if not m:                               # no slot: every row is fully masked
        return el.new_zeros((n, hf))
    f = hf // n_heads
    el_h = el.reshape(n, m, n_heads, f)
    e = F.leaky_relu(el_h + er.reshape(n, 1, n_heads, f), negative_slope)
    valid = (mask > 0)[:, :, None]
    scores = torch.where(valid, (e * attn).sum(-1), NEG_BIG)      # [N, M, H]
    smax = scores.amax(1, keepdim=True)
    smax = torch.where(smax <= NEG_BIG / 2, 0.0, smax)
    p = torch.where(valid, torch.exp(scores - smax), 0.0)
    denom = torch.clamp_min(p.sum(1), 1e-30)
    return (torch.einsum("nmh,nmhf->nhf", p, el_h) / denom[..., None]).reshape(n, hf)


def flash_gat(el, er, attn, mask, n_heads, negative_slope=0.2):
    """Masked GATv2 attention + aggregation over pre-projected sources.

    el: [N, M, H*F] projected source features per destination slot; er:
    [N, H*F] projected destination features; attn: [H, F]; mask: [N, M],
    > 0 (or True) where a slot is valid. Returns [N, H*F] =
    ``sum_m softmax_m(attn . LeakyReLU(el + er)) * el`` per head; rows with
    no valid slot give exactly 0.

    The JAX kernel has no VJP, so neither has this: it raises when autograd
    would need its gradient. A CPU tensor runs the plain version; a CUDA
    tensor always launches the kernel (float32, contiguous, H * ceil(F/32) *
    32 <= 1024) or raises.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (el, er, attn)):
        raise NotImplementedError(
            "flash_gat (gat_backend='pallas') is inference only: it has no gradient, as "
            "the JAX kernel has no VJP; train with the fused backends")
    if el.device.type == "cpu":
        return flash_gat_plain(el, er, attn, mask, n_heads, negative_slope)
    if el.device.type != "cuda":
        raise ValueError(f"flash_gat runs on cpu or cuda, not {el.device}")
    n, m, hf = el.shape
    if hf % n_heads:
        raise ValueError(f"H*F = {hf} is not a multiple of H = {n_heads}")
    f = hf // n_heads
    expected = {"er": (n, hf), "attn": (n_heads, f), "mask": (n, m)}
    for name, t in (("er", er), ("attn", attn), ("mask", mask)):
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")
    f_pad = -(-f // 32) * 32
    if n_heads * f_pad > 1024:
        raise ValueError(f"the kernel takes H * ceil(F/32) * 32 <= 1024 (a CTA of one warp a "
                         f"head, a lane holding ceil(F/32) columns), got {n_heads * f_pad}")
    out = torch.empty((n, hf), dtype=torch.float32, device=el.device)
    if n == 0:
        return out
    mask = mask.to(torch.float32)          # held until the launch is queued
    ptrs = build.pointers(el.device, {"el": el, "er": er, "attn": attn, "mask": mask,
                                      "out": out})
    lib = build.load("flash_gat", _FLASH_SIGNATURES)
    err = lib.flash_gat_forward(*ptrs, n, m, hf, n_heads, float(negative_slope),
                                build.stream_of(el.device))
    build.check_launch(lib, "flash_gat_error_string", err, "flash_gat")
    flash_gat.launches += 1
    return out


flash_gat.launches = flash_gat.launches_bf16 = 0    # f32 only: launches_bf16 stays 0


def flash_gat_fused_plain(x, w, b, er, attn, mask, n_heads, negative_slope=0.2):
    """Plain PyTorch version of :func:`flash_gat_fused` (materializes ``el``).

    Same contract and the same all-masked rule; returns ``(out, m, l)``. It
    computes in ``x.dtype`` with torch's rounding after every op (bf16 too);
    ``m`` and ``l`` come back in f32 (f64 for f64 inputs), as the kernel's.
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
    stat = torch.promote_types(x.dtype, torch.float32)          # f32, or f64 for f64
    return out.reshape(n, hf), mstat.to(stat), lstat.to(stat)


def _check_shapes(what, x, w, b, er, attn, mask, n_heads, **backward):
    """Raise unless the operands fit the kernels; ``backward`` holds the
    backward's extra operands (``out``, ``g``, ``mstat``, ``lstat``)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    n, m, d = x.shape
    hf = w.shape[1]
    f = hf // n_heads
    expected = {"w": (d, hf), "b": (hf,), "er": (n, hf), "attn": (n_heads, f),
                "mask": (n, m), "out": (n, hf), "g": (n, hf), "mstat": (n, n_heads),
                "lstat": (n, n_heads)}
    operands = {"w": w, "b": b, "er": er, "attn": attn, "mask": mask, **backward}
    for name, t in operands.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")
    if hf % n_heads or f % 32 or hf > 1024 or d > MAX_D:
        raise ValueError(f"the kernels need H*F <= 1024 with F a multiple of 32 and "
                         f"D <= {MAX_D}; got H={n_heads}, H*F={hf}, D={d}")
    return n, m, d


def flash_gat_fused(x, w, b, er, attn, mask, n_heads, negative_slope=0.2):
    """Fused projection + masked GATv2 attention + aggregation.

    x: [N, M, D] raw source features per destination slot; w: [D, H*F] and
    b: [H*F], the source projection; er: [N, H*F] projected destination
    features; attn: [H, F]; mask: [N, M] float, > 0 where a slot is valid.
    Returns ``(out [N, H*F], m [N, H], l [N, H])``: the aggregation (in the
    operands' dtype) and the f32 softmax statistics. Rows with no valid slot
    give 0.

    A CPU tensor runs the plain version; a CUDA tensor always launches the
    kernel of its dtype (float32 or bfloat16, one for every operand,
    contiguous, H*F <= 1024, F a multiple of 32) or raises.
    """
    if x.device.type == "cpu":
        return flash_gat_fused_plain(x, w, b, er, attn, mask, n_heads, negative_slope)
    n, m, d = _check_shapes("flash_gat_fused", x, w, b, er, attn, mask, n_heads)
    dtype = build.storage_type("flash_gat_fused", x, w, b, er, attn, mask)
    hf = w.shape[1]
    out = torch.empty((n, hf), dtype=dtype, device=x.device)
    mstat = torch.empty((n, n_heads), dtype=torch.float32, device=x.device)
    lstat = torch.empty_like(mstat)
    ptrs = build.pointers(x.device, {"x": x, "w": w, "b": b, "er": er, "attn": attn,
                                     "mask": mask, "out": out, "m": mstat, "l": lstat},
                          dtype, f32=("m", "l"))
    lib = build.load("flash_gat_fused", _SIGNATURES)
    launch = getattr(lib, "flash_gat_fused_forward" + build.SUFFIX[dtype])
    err = launch(*ptrs, n, m, d, hf, n_heads, float(negative_slope), build.stream_of(x.device))
    build.check_launch(lib, "flash_gat_fused_error_string", err, "flash_gat_fused")
    build.count_launch(flash_gat_fused, dtype)
    return out, mstat, lstat


flash_gat_fused.launches = flash_gat_fused.launches_bf16 = 0


def leaky_grad(z, negative_slope):
    """LeakyReLU's derivative at ``z``, in ``z``'s dtype: 1 where z >= 0."""
    return torch.where(z >= 0, 1.0, negative_slope).to(z.dtype)


def flash_gat_fused_bwd_plain(x, w, b, er, attn, mask, out, mstat, lstat, g, n_heads,
                              negative_slope=0.2, need_dx=False):
    """Plain PyTorch version of :func:`flash_gat_fused_bwd`.

    The recompute formulas of ``pallas_kernels.py:_flash_gat_fused_bwd_kernel``:
    with ``D[n,h] = sum_f g*out``, ``d_alpha = sum_f g*el``,
    ``d_s = alpha (d_alpha - D)`` (taken as ``alpha sum_f g (el - out)``), ``d_z = d_s attn leaky'(z)`` and
    ``d_el = alpha g + d_z``: ``der = sum_m d_z``, ``dattn = sum d_s leaky(z)``,
    ``dW = x^T d_el``, ``db = sum d_el`` and, when ``need_dx``, ``dx = d_el W^T``.
    Returns ``(dx or None, dw, db, der, dattn)``.
    """
    n, m, d = x.shape
    hf = w.shape[1]
    f = hf // n_heads
    el = (x @ w + b).reshape(n, m, n_heads, f)
    z = el + er.reshape(n, 1, n_heads, f)
    lz = F.leaky_relu(z, negative_slope)
    scores = (lz * attn).sum(-1)                                  # [N, M, H]
    mstat, lstat = mstat.to(x.dtype), lstat.to(x.dtype)           # the f32 stats, at x's dtype
    shift = torch.where(mstat <= NEG_BIG / 2, 0.0, mstat)
    p = torch.where((mask > 0)[:, :, None], torch.exp(scores - shift[:, None, :]), 0.0)
    alpha = p / torch.clamp_min(lstat, 1e-30)[:, None, :]
    g4 = g.reshape(n, 1, n_heads, f)
    # d_alpha - D = sum_f g (el - out): the difference before the sum, so that
    # at bf16 two nearly equal rounded sums do not cancel.
    d_s = alpha * (g4 * (el - out.reshape(n, 1, n_heads, f))).sum(-1)   # [N, M, H]
    d_z = d_s[..., None] * attn * leaky_grad(z, negative_slope)
    d_el = (alpha[..., None] * g4 + d_z).reshape(n * m, hf)
    der = d_z.sum(1).reshape(n, hf)
    dattn = (d_s[..., None] * lz).sum((0, 1))
    dw = x.reshape(n * m, d).T @ d_el
    db = d_el.sum(0)
    dx = (d_el @ w.T).reshape(n, m, d) if need_dx else None
    return dx, dw, db, der, dattn


def flash_gat_fused_bwd(x, w, b, er, attn, mask, out, mstat, lstat, g, n_heads,
                        negative_slope=0.2, need_dx=False):
    """Backward of :func:`flash_gat_fused` from its saved row statistics.

    ``out, mstat, lstat`` are the forward's outputs and ``g = dL/dout``
    [N, H*F]. Returns ``(dx or None, dw [D, H*F], db [H*F], der [N, H*F],
    dattn [H, F])`` in the operands' dtype; ``dx`` [N, M, D] only when
    ``need_dx``. The mask gets no gradient. A CPU tensor runs the plain
    version; a CUDA tensor always launches the kernel of its dtype or raises.
    Its scratch is one f32 partial row of (D+2)*H*F a CTA, ``min(N,
    MAX_CTAS)`` rows.
    """
    if x.device.type == "cpu":
        return flash_gat_fused_bwd_plain(x, w, b, er, attn, mask, out, mstat, lstat, g,
                                         n_heads, negative_slope, need_dx)
    n, m, d = _check_shapes("flash_gat_fused_bwd", x, w, b, er, attn, mask, n_heads,
                            out=out, mstat=mstat, lstat=lstat, g=g)
    dtype = build.storage_type("flash_gat_fused_bwd", x, w, b, er, attn, mask, out, g)
    hf = w.shape[1]
    dev = x.device
    dw = torch.empty((d, hf), dtype=dtype, device=dev)
    db = torch.empty((hf,), dtype=dtype, device=dev)
    der = torch.empty((n, hf), dtype=dtype, device=dev)
    dattn = torch.empty_like(attn, dtype=dtype)
    dx = torch.empty((n, m, d), dtype=dtype, device=dev) if need_dx else None
    partial = torch.empty((max(min(n, MAX_CTAS), 1), (d + 2) * hf), dtype=torch.float32,
                          device=dev)
    ptrs = build.pointers(dev, {"x": x, "w": w, "b": b, "er": er, "attn": attn, "mask": mask,
                                "g": g, "out": out, "m": mstat, "l": lstat, "dw": dw,
                                "db": db, "der": der, "dattn": dattn, "partial": partial},
                          dtype, f32=("m", "l", "partial"))
    lib = build.load("flash_gat_fused_bwd", _BWD_SIGNATURES)
    dx_ptr = build.pointers(dev, {"dx": dx}, dtype)[0] if need_dx else _P(None)
    launch = getattr(lib, "flash_gat_fused_backward" + build.SUFFIX[dtype])
    err = launch(*ptrs[:14], dx_ptr, ptrs[14], n, m, d, hf, n_heads, float(negative_slope),
                 build.stream_of(dev))
    build.check_launch(lib, "flash_gat_fused_bwd_error_string", err, "flash_gat_fused_bwd")
    build.count_launch(flash_gat_fused_bwd, dtype)
    return dx, dw, db, der, dattn


flash_gat_fused_bwd.launches = flash_gat_fused_bwd.launches_bf16 = 0


class _FlashGatFusedFn(torch.autograd.Function):
    """``flash_gat_fused`` forward + ``flash_gat_fused_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, w, b, er, attn, mask, n_heads, negative_slope):
        x, w, b, er, attn, mask = (t.detach() for t in (x, w, b, er, attn, mask))
        out, mstat, lstat = flash_gat_fused(x, w, b, er, attn, mask, n_heads, negative_slope)
        ctx.save_for_backward(x, w, b, er, attn, mask, out, mstat, lstat)
        ctx.cfg = (n_heads, negative_slope)
        return out

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        dx, dw, db, der, dattn = flash_gat_fused_bwd(
            *ctx.saved_tensors, g.contiguous(), *ctx.cfg, need_dx=need[0])
        grads = (dx, dw, db, der, dattn)
        return tuple(gr if need[i] else None for i, gr in enumerate(grads)) + (None,) * 3


def flash_gat_fused_train(x, w, b, er, attn, mask, n_heads, negative_slope=0.2):
    """Differentiable :func:`flash_gat_fused`; returns ``out`` [N, H*F] only.

    One forward launch; autograd's backward is one :func:`flash_gat_fused_bwd`
    call, with ``dx`` computed only when ``x`` requires grad (the JAX
    package's ``need_dx``). The mask gets no gradient.
    """
    return _FlashGatFusedFn.apply(x, w, b, er, attn, mask, n_heads, negative_slope)
