"""The device env's scheduler: the CUDA kernel, the rule that holds it to its plain version.

``schedule_and_rate`` replaces no ``pallas_call``. It ports the loop that
``uav_bs_ctrl_tpu/envs/jax_env.py`` keeps on the TPU inside its jitted step:
the ``fori_loop`` over the GTs in priority order (``:158-185``) and
``_rates_from_schedule`` (``:225-235``). Its plain version is
``envs/torch_env.py:_schedule_body_scatter``, a Python loop of some two dozen
launches a GT; ``csrc/env_schedule.cu`` runs the loop and the rates of every
world in one launch. The wrapper counts its launches in
``schedule_and_rate.launches``.

``schedule_assignment`` and ``compare_schedules`` are the rule the tests and
``chip_smoke.py`` hold two schedules of the same inputs to: the same serving
UBS and RB for every GT, and rates within ``RATE_RTOL`` of the world's largest
rate; where two schedules part, the RBs they chose must tie in interference
within the roundoff of summing it in another order.
"""

import ctypes

import numpy as np
import torch

from uav_bs_ctrl_tpu_torch.ops import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "env_schedule_forward": (_I, [_P] * 6 + [_I] * 4 + [_F] * 5 + [_P]),
    "env_schedule_staged": (_I, [_I, _I]),
    "env_schedule_error_string": (ctypes.c_char_p, [_I]),
}
MAX_UBS, MAX_GTS, MAX_RBS = 64, 2048, 32   # csrc/env_schedule.cu's kMaxUbs, kMaxGts, kMaxRbs
RATE_SCALE = 1e-6                          # bps -> Mbps, as _rates_from_schedule
RATE_RTOL = 1e-6                           # of the world's largest rate (native/env_core.cpp:8)


def schedule_and_rate(params, d_u2g, gain, prior_gts, with_assignment=False):
    """Priority/interference-aware RB assignment and the SINR rates of every world.

    ``d_u2g``, ``gain``: [W, N, M] float32; ``prior_gts``: [W, M] int64, each
    world's GTs in priority order (a permutation). Returns ``(rate_per_gt
    [W, M], rate_per_ubs [W, N])``, float32, and with ``with_assignment`` also
    :func:`schedule_assignment`'s ``[W, M]`` int32 of the schedule.

    A CPU tensor runs the plain version, ``torch_env._schedule_body_scatter``;
    a CUDA tensor always launches the kernel (N <= 64, M <= 2048, R <= 32;
    contiguous operands on one card) or raises.
    """
    if d_u2g.device.type == "cpu":
        from uav_bs_ctrl_tpu_torch.envs import torch_env   # torch_env imports this module
        sched, rate_gt, rate_ubs = torch_env._schedule_body_scatter(params, d_u2g, gain,
                                                                    prior_gts)
        return (rate_gt, rate_ubs) + ((schedule_assignment(sched),) if with_assignment else ())
    n_w, N, M, R = _check(params, d_u2g, gain, prior_gts)
    dev = d_u2g.device
    rate_gt = torch.empty((n_w, M), dtype=torch.float32, device=dev)
    rate_ubs = torch.empty((n_w, N), dtype=torch.float32, device=dev)
    assign = torch.empty((n_w, M), dtype=torch.int32, device=dev) if with_assignment else None
    ptrs = [_P(t.data_ptr()) if t is not None else None
            for t in (d_u2g, gain, prior_gts, rate_gt, rate_ubs, assign)]
    lib = build.load("env_schedule", _SIGNATURES)
    err = lib.env_schedule_forward(*ptrs, n_w, N, M, R, params.r_cov, params.p_tx,
                                   params.noise, params.bw, RATE_SCALE, build.stream_of(dev))
    build.check_launch(lib, "env_schedule_error_string", err, "env_schedule")
    build.count_launch(schedule_and_rate)
    return (rate_gt, rate_ubs) + ((assign,) if with_assignment else ())


schedule_and_rate.launches = 0


def _check(params, d_u2g, gain, prior_gts):
    """Raise unless the operands fit the kernel; returns ``(W, N, M, R)``."""
    if d_u2g.device.type != "cuda":
        raise ValueError(f"schedule_and_rate runs on cpu or cuda, not {d_u2g.device}")
    N, M, R = params.n_ubs, params.n_gts, params.n_rbs
    if not (1 <= N <= MAX_UBS and 0 <= M <= MAX_GTS and 1 <= R <= MAX_RBS):
        raise ValueError(f"the kernel takes N <= {MAX_UBS}, M <= {MAX_GTS}, R <= {MAX_RBS}; "
                         f"got N = {N}, M = {M}, R = {R}")
    n_w = d_u2g.shape[0]
    for name, t, shape, dtype in (("d_u2g", d_u2g, (n_w, N, M), torch.float32),
                                  ("gain", gain, (n_w, N, M), torch.float32),
                                  ("prior_gts", prior_gts, (n_w, M), torch.int64)):
        if t.device != d_u2g.device:
            raise ValueError(f"{name} is on {t.device}, expected {d_u2g.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return n_w, N, M, R


def staged(n_ubs, n_gts) -> bool:
    """Whether the kernel stages a world of ``n_ubs`` x ``n_gts`` in shared
    memory (else it reads ``d_u2g`` and ``gain`` from device memory)."""
    return bool(build.load("env_schedule", _SIGNATURES).env_schedule_staged(n_ubs, n_gts))


def schedule_assignment(sched):
    """``[W, M]`` int32 of a schedule ``sched [W, N, M, R]``: ``i * R + c`` of
    GT m's serving UBS i and RB c, -1 where m is not served."""
    n_w, N, M, R = sched.shape
    flat = sched.permute(0, 2, 1, 3).reshape(n_w, M, N * R)
    return torch.where(flat.any(-1), flat.to(torch.int32).argmax(-1),
                       -1).to(torch.int32)


def _radiated(params, d, g):
    """f64 of the f32 power each UBS radiates at each GT, ``where(d <= r_cov,
    p_tx * gain, 0)`` rounded as the plain version rounds it."""
    p = np.where(d <= np.float32(params.r_cov), np.float32(params.p_tx) * g, np.float32(0))
    return p.astype(np.float64)


def first_divergence(params, d, g, prior, a, b):
    """Where schedules ``a`` and ``b`` ([M] assignments) of one world part:
    replay them from the start, in priority order, up to the first GT they
    place differently. Returns ``None`` when they agree, else a dict: the GT,
    each side's ``(ubs, rb)`` (-1, -1 unserved), each chosen RB's exact
    interference at that point (f64 sums of the f32 powers over the UBSs that
    occupy it) and ``terms``, the most nonzero powers either sum holds."""
    R = params.n_rbs
    rad = _radiated(params, d, g)                        # [N, M]
    occ = np.zeros((params.n_ubs, R), bool)
    for m in prior:
        if a[m] != b[m]:
            sides = [divmod(int(x), R) if x >= 0 else (-1, -1) for x in (a[m], b[m])]
            terms = [rad[:, m] * occ[:, c] if c >= 0 else np.zeros(len(rad))
                     for _, c in sides]
            return dict(gt=int(m), a=sides[0], b=sides[1],
                        itf=[float(t.sum()) for t in terms],
                        terms=max(int((t > 0).sum()) for t in terms))
        if a[m] >= 0:
            occ[divmod(int(a[m]), R)] = True
    return None


def is_interference_tie(div) -> bool:
    """Whether a :func:`first_divergence` is a roundoff tie: both sides serve
    the GT from the same UBS, on RBs whose exact interference sums differ by
    at most what summing k f32 terms in two orders can move them, 2(k - 1)
    ulps of the larger (k = ``terms``). A sum of at most two terms is the same
    in every order, so there an exact tie must go to the first RB, as argmin's."""
    (ia, ca), (ib, cb) = div["a"], div["b"]
    k = div["terms"]
    if ia != ib or ia < 0 or ca == cb or k < 3:
        return False
    hi = max(div["itf"])
    return abs(div["itf"][0] - div["itf"][1]) <= 2 * (k - 1) * float(np.spacing(np.float32(hi)))


def compare_schedules(params, d_u2g, gain, prior_gts, got, want):
    """Hold ``got`` to ``want``, each ``(assignment [W, M], rate_per_gt
    [W, M], rate_per_ubs [W, N])`` of the same inputs: returns ``dict(err,
    abs_err, ties, faults)``. ``err`` is the largest rate difference over the
    worlds whose schedules are equal, each over its largest rate (of both
    outputs of ``want``), ``abs_err`` the largest in Mbps; a world whose
    schedules part gives its :func:`first_divergence` to ``ties`` when it is
    an interference tie (its rates then differ by the schedule, and are not
    compared) and to ``faults`` when it is not."""
    host = lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    d, g, prior = host(d_u2g), host(gain), host(prior_gts)
    (ga, gr, gu), (wa, wr, wu) = (tuple(host(t) for t in x) for x in (got, want))
    same = (ga == wa).all(-1)
    out = dict(err=0.0, abs_err=0.0, ties=[], faults=[])
    for w in np.nonzero(~same)[0]:
        div = first_divergence(params, d[w], g[w], prior[w], ga[w], wa[w])
        out["ties" if div is not None and is_interference_tie(div) else "faults"].append(
            dict(world=int(w), **(div or {})))
    if same.any():
        diff = np.maximum(np.abs(gr - wr).max(-1, initial=0.0), np.abs(gu - wu).max(-1, initial=0.0))
        scale = np.maximum(np.abs(wr).max(-1, initial=0.0), np.abs(wu).max(-1, initial=0.0))
        out["abs_err"] = float(diff[same].max())
        out["err"] = float((diff / np.maximum(scale, 1e-30))[same].max())
    return out
