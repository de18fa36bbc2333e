"""K5/K6/K7 wrappers: the lane-layout products' smoother, forward filter
and path draw.

:func:`lanes_smooth_bwd` (K5) is the Durbin-Koopman univariate
smoother's backward pass: from K3's segment boundaries it replays each
segment forward (keeping the predicted moments and each observed slot's
``(d, f, v)``), runs the adjoint recursion on ``(r, N)`` in reverse slot
order and emits per step the smoothed mean ``m_s = m_p + P_p r``, its
projection ``Z m_s`` and, with ``want_cov``, the projected variances
``max(diag(Z P_p Z') - diag(Z P_p N P_p Z'), 0)`` (zeros otherwise, the
N recursion skipped).

:func:`lanes_forward` (K6) is K3's forward filter with per-step outputs
in one of four modes: ``"project"`` (the filtered mean, ``Z m_f`` and
``max(diag(Z P_f Z'), 0)``), ``"innovations"`` (the joint ``v = y - Z
m_p`` and ``f = max(diag(Z P_p Z'), 0) + r`` from the predicted
moments), ``"latch"`` (each lane's filtered ``(m, P)`` after step
``t_last - 1``; a ``t_last`` outside ``[1, T]`` keeps ``N(0, I)``) or
``"store"`` (the stored sequential filter: per step the predicted and
the filtered moments and the step's ``sigma``/``detf``, what the RTS
smoother K8 reads).

:func:`lanes_sample` (K7) is the simulation smoother's path draw: from
standard normals ``x0``, ``w``, ``e``, the AR path ``x_t = phi o x_{t-1}
+ sqrt(max(q, 0)) o w_t`` from ``x_0 = x0`` and its pseudo-observations
``y*_t = Z x_t + sqrt(max(r, 0)) o e_t``.

On CUDA tensors each wrapper launches its hand-written kernel
(``csrc/lanes_smooth.cu``, ``csrc/lanes_forward.cu``,
``csrc/lanes_sample.cu``) and raises if that cannot build or launch; on
CPU tensors it runs the plain PyTorch version beside it (``*_plain``).

Layouts: the lane constants as in :mod:`.lanes` (``phi``, ``q`` (n, L),
``z`` (N, n, L), ``r`` (N, L)), the data (D, T, N) with a ``lane_map``;
outputs are lane-major, (L, T, n) and (L, T, N), the latch (L, n)
and (L, n, n), the store ``(mean_p, cov_p, mean_f, cov_f, sigma,
detf)`` (L, T, n), (L, T, n, n), (L, T, n), (L, T, n, n), (L, T),
(L, T); K7's normals and outputs are (L, n), (L, T, n) and (L, T, N).

Replaces ``metran_tpu/ops/lanes_products.py``: ``lanes_smooth`` (B3:
``_series_bwd``, ``_smooth_emit``), and of B4 ``lanes_filter_project``,
``lanes_innovations``, the latch of ``lanes_forecast`` and the path
draw of ``lanes_sample``; and ``metran_tpu/ops/kalman.py::kalman_filter(
engine="sequential", store=True)`` (``_sequential_update``), the forward
half of B5.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .lanes import (
    _check,
    _check_cuda,
    _plain_setup,
    _predict,
    _ptr,
    _stream,
    _update,
    scratch_stride,
)

#: K6's output modes and their codes in the kernel
FORWARD_MODES = {"project": 0, "innovations": 1, "latch": 2, "store": 3}


def _new(phi):
    return dict(dtype=phi.dtype, device=phi.device)


# ----------------------------------------------------------------------
# K5: the smoother's backward pass
# ----------------------------------------------------------------------
def _check_smooth(phi, q, z, r, y, mask, lane_map, seg, bounds_mean,
                  bounds_cov):
    out = _check(phi, q, z, r, y, mask, lane_map, seg)
    lanes, _, _, _, n, _, n_seg, _ = out
    for name, t, shape in (("bounds_mean", bounds_mean, (n_seg, n, lanes)),
                           ("bounds_cov", bounds_cov,
                            (n_seg, n, n, lanes))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != phi.dtype:
            raise TypeError(f"{name} is {t.dtype}, phi is {phi.dtype}")
        if t.device != phi.device:
            raise ValueError(f"{name} is on {t.device}, phi on {phi.device}")
    return out


def lanes_smooth_bwd(phi, q, z, r, y, mask, lane_map, seg, bounds_mean,
                     bounds_cov, want_cov: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mean_s (L, T, n), proj_mean (L, T, N), proj_var (L, T, N))``
    of the smoother, from K3's segment boundaries at the same ``seg``."""
    args = (phi, q, z, r, y, mask, lane_map, seg, bounds_mean, bounds_cov,
            want_cov)
    _check_smooth(*args[:-1])
    if phi.device.type == "cpu":
        return lanes_smooth_bwd_plain(*args)
    return lanes_smooth_bwd_kernel(*args)


def lanes_smooth_bwd_kernel(phi, q, z, r, y, mask, lane_map, seg,
                            bounds_mean, bounds_cov, want_cov: bool = True):
    """Launch K5 (CUDA tensors only).  Its replay scratch, ``seg *
    scratch_stride(N, n)`` values per lane, is allocated here."""
    lanes, _, t_steps, big_n, n, seg, _, lane_map = _check_smooth(
        phi, q, z, r, y, mask, lane_map, seg, bounds_mean, bounds_cov)
    _check_cuda("smooth", phi, big_n, n)
    args = [t.contiguous() for t in (phi, q, z, r, y, mask, lane_map,
                                     bounds_mean, bounds_cov)]
    new = _new(phi)
    scratch = torch.empty((lanes, seg, scratch_stride(big_n, n)), **new)
    mean_s = torch.empty((lanes, t_steps, n), **new)
    proj_mean = torch.empty((lanes, t_steps, big_n), **new)
    proj_var = torch.empty((lanes, t_steps, big_n), **new)
    lib = build.load_library("lanes_smooth")
    fn = (lib.metran_lanes_smooth_f64 if phi.dtype == torch.float64
          else lib.metran_lanes_smooth_f32)
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], scratch.data_ptr(),
                 mean_s.data_ptr(), proj_mean.data_ptr(), proj_var.data_ptr(),
                 lanes, t_steps, big_n, n, seg, int(bool(want_cov)),
                 _stream(phi))
    build.check(lib, err, "lanes_smooth_bwd")
    if lanes:
        build.count_launch("lanes_smooth_bwd")
    return mean_s, proj_mean, proj_var


def _lane_major(steps, t_steps, shape, like):
    """Stack per-step (x, L) tensors into (L, T, x)."""
    if not steps:
        return like.new_zeros((shape[1], 0, shape[0]))
    return torch.stack(steps)[:t_steps].permute(2, 0, 1).contiguous()


def lanes_smooth_bwd_plain(phi, q, z, r, y, mask, lane_map, seg,
                           bounds_mean, bounds_cov, want_cov: bool = True):
    """The same backward pass in PyTorch ops (``lanes_smooth``'s
    ``seg_replay``, ``_series_bwd`` and ``_smooth_emit``): a Python loop
    over steps and slots, each update batched over the lanes."""
    lanes, _, t_steps, big_n, n, seg, n_seg, lane_map = _check_smooth(
        phi, q, z, r, y, mask, lane_map, seg, bounds_mean, bounds_cov)
    new = _new(phi)
    with torch.no_grad():
        c = _plain_setup(phi, q, z, r, y, mask, lane_map, seg)
        r_adj = torch.zeros((n, lanes), **new)
        n_adj = torch.zeros((n, n, lanes), **new) if want_cov else None
        t_pad = n_seg * seg
        out_m, out_pm, out_pv = [None] * t_pad, [None] * t_pad, [None] * t_pad
        zero_pv = torch.zeros((big_n, lanes), **new)
        for g in range(n_seg - 1, -1, -1):
            m, p = bounds_mean[g], bounds_cov[g]
            stored = []
            for k in range(seg):
                m_p, p_p = _predict(c, phi, m, p)
                m, p, _, _, res = _update(c, m_p, p_p, g * seg + k,
                                          keep_res=True)
                stored.append((m_p, p_p, res))
            for k in range(seg - 1, -1, -1):
                t = g * seg + k
                m_p, p_p, res = stored[k]
                obs_t = c.obs[t]
                for i, flag, d, f, v in reversed(res):
                    z_i = c.z_rows[i]
                    gain = d / f
                    kr = torch.linalg.vecdot(gain, r_adj, dim=0)
                    r_new = r_adj + z_i * (v / f - kr)
                    if want_cov:
                        # N is symmetric: one N k serves both sides
                        nk = torch.linalg.vecdot(n_adj, gain[None], dim=1)
                        knk = torch.linalg.vecdot(gain, nk, dim=0)
                        n_new = (n_adj - z_i[:, None] * nk[None]
                                 - nk[:, None] * z_i[None]
                                 + z_i[:, None] * z_i[None] * (knk + 1.0 / f))
                    if flag == 1:
                        r_adj = torch.where(obs_t[i], r_new, r_adj)
                        if want_cov:
                            n_adj = torch.where(obs_t[i], n_new, n_adj)
                    else:
                        r_adj = r_new
                        if want_cov:
                            n_adj = n_new
                mean_s = m_p + torch.linalg.vecdot(p_p, r_adj[None], dim=1)
                out_m[t] = mean_s
                out_pm[t] = torch.einsum("iaL,aL->iL", z, mean_s)
                if want_cov:
                    dp = torch.einsum("iaL,ajL->ijL", z, p_p)  # rows Z P_p
                    out_pv[t] = torch.clamp(
                        torch.einsum("ijL,ijL->iL", z, dp)
                        - torch.einsum("iaL,abL,ibL->iL", dp, n_adj, dp),
                        min=0.0)
                    n_adj = c.phi_a * n_adj * c.phi_b
                else:
                    out_pv[t] = zero_pv
                r_adj = phi * r_adj
    return (_lane_major(out_m, t_steps, (n, lanes), phi),
            _lane_major(out_pm, t_steps, (big_n, lanes), phi),
            _lane_major(out_pv, t_steps, (big_n, lanes), phi))


# ----------------------------------------------------------------------
# K6: the forward filter with per-step outputs
# ----------------------------------------------------------------------
def _check_forward(phi, q, z, r, y, mask, lane_map, mode, t_last):
    out = _check(phi, q, z, r, y, mask, lane_map, None)
    if mode not in FORWARD_MODES:
        raise ValueError(
            f"unknown mode {mode!r}; expected one of {tuple(FORWARD_MODES)}")
    lanes = out[0]
    if mode == "latch":
        if t_last is None:
            raise ValueError("mode='latch' needs t_last (L,) int32")
        if t_last.dtype != torch.int32 or tuple(t_last.shape) != (lanes,):
            raise ValueError(
                f"t_last must be int32 ({lanes},), got {t_last.dtype} "
                f"{tuple(t_last.shape)}")
        if t_last.device != phi.device:
            raise ValueError(f"t_last is on {t_last.device}, phi on "
                             f"{phi.device}")
    return out


def lanes_forward(phi, q, z, r, y, mask, mode: str, lane_map=None,
                  t_last=None) -> Tuple[torch.Tensor, ...]:
    """The forward filter's outputs in ``mode``: ``(mean_f, proj_mean,
    proj_var)`` for ``"project"``, ``(v, f)`` for ``"innovations"``,
    ``(mean, cov)`` for ``"latch"``, ``(mean_p, cov_p, mean_f, cov_f,
    sigma, detf)`` for ``"store"`` (see the module doc)."""
    _check_forward(phi, q, z, r, y, mask, lane_map, mode, t_last)
    if phi.device.type == "cpu":
        return lanes_forward_plain(phi, q, z, r, y, mask, mode, lane_map,
                                   t_last)
    return lanes_forward_kernel(phi, q, z, r, y, mask, mode, lane_map,
                                t_last)


def lanes_forward_kernel(phi, q, z, r, y, mask, mode: str, lane_map=None,
                         t_last=None):
    """Launch K6 (CUDA tensors only)."""
    lanes, _, t_steps, big_n, n, _, _, lane_map = _check_forward(
        phi, q, z, r, y, mask, lane_map, mode, t_last)
    _check_cuda("forward", phi, big_n, n)
    args = [t.contiguous() for t in (phi, q, z, r, y, mask, lane_map)]
    new = _new(phi)
    if mode == "project":
        outs = (torch.empty((lanes, t_steps, n), **new),
                torch.empty((lanes, t_steps, big_n), **new),
                torch.empty((lanes, t_steps, big_n), **new))
    elif mode == "innovations":
        outs = (torch.empty((lanes, t_steps, big_n), **new),
                torch.empty((lanes, t_steps, big_n), **new))
    elif mode == "latch":
        outs = (torch.empty((lanes, n), **new),
                torch.empty((lanes, n, n), **new))
    else:
        moments = ((lanes, t_steps, n), (lanes, t_steps, n, n))
        outs = tuple(torch.empty(shape, **new)
                     for shape in (*moments, *moments, (lanes, t_steps),
                                   (lanes, t_steps)))
    ptrs = [o.data_ptr() for o in outs] + [None] * (6 - len(outs))
    tl = None if t_last is None else t_last.contiguous()
    lib = build.load_library("lanes_forward")
    fn = (lib.metran_lanes_forward_f64 if phi.dtype == torch.float64
          else lib.metran_lanes_forward_f32)
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], _ptr(tl), *ptrs, lanes,
                 t_steps, big_n, n, FORWARD_MODES[mode], _stream(phi))
    build.check(lib, err, "lanes_forward")
    if lanes:
        build.count_launch("lanes_forward")
    return outs


def lanes_forward_plain(phi, q, z, r, y, mask, mode: str, lane_map=None,
                        t_last=None):
    """The same forward filter in PyTorch ops (``lanes_filter_project``,
    ``lanes_innovations``, ``lanes_forecast``'s latch and the stored
    ``_sequential_update`` filter)."""
    lanes, _, t_steps, big_n, n, _, _, lane_map = _check_forward(
        phi, q, z, r, y, mask, lane_map, mode, t_last)
    new = _new(phi)
    with torch.no_grad():
        c = _plain_setup(phi, q, z, r, y, mask, lane_map, max(t_steps, 1))
        m = torch.zeros((n, lanes), **new)
        p = c.eye.expand(n, n, lanes)
        outs = ([], [], [], [], [], [])
        if mode == "latch":
            stop = torch.where((t_last >= 1) & (t_last <= t_steps), t_last, 0)
            latch_m, latch_p = m, p
        for t in range(t_steps):
            m_p, p_p = _predict(c, phi, m, p)
            if mode == "store":
                outs[0].append(m_p)
                outs[1].append(p_p)
            if mode == "innovations":
                pv = torch.clamp(torch.einsum("iaL,abL,ibL->iL", z, p_p, z),
                                 min=0.0)
                y_t = torch.stack(c.y_rows[t])
                outs[0].append(y_t - torch.einsum("iaL,aL->iL", z, m_p))
                outs[1].append(pv + r)
            m, p, sig, det, _ = _update(c, m_p, p_p, t)
            if mode == "store":
                for out, value in zip(outs[2:], (m, p, sig, det)):
                    out.append(value)
            if mode == "project":
                outs[0].append(m)
                outs[1].append(torch.einsum("iaL,aL->iL", z, m))
                outs[2].append(torch.clamp(
                    torch.einsum("iaL,abL,ibL->iL", z, p, z), min=0.0))
            elif mode == "latch":
                hit = stop == t + 1
                latch_m = torch.where(hit, m, latch_m)
                latch_p = torch.where(hit, p, latch_p)
        if mode == "latch":
            return (latch_m.T.contiguous(),
                    latch_p.permute(2, 0, 1).contiguous())
        if mode == "store":
            return _stored(outs, t_steps, lanes, n, phi)
        sizes = {"project": (n, big_n, big_n), "innovations": (big_n, big_n)}
        return tuple(_lane_major(o, t_steps, (size, lanes), phi)
                     for o, size in zip(outs, sizes[mode]))


def _stored(outs, t_steps, lanes, n, like):
    """The store mode's per-step lists, each step's value with the lane
    axis last, as lane-major ``(mean_p, cov_p, mean_f, cov_f, sigma,
    detf)``."""
    if not t_steps:
        new = dict(dtype=like.dtype, device=like.device)
        moments = ((lanes, 0, n), (lanes, 0, n, n))
        return tuple(torch.zeros(shape, **new) for shape in
                     (*moments, *moments, (lanes, 0), (lanes, 0)))
    means = [torch.stack(o).permute(2, 0, 1).contiguous()
             for o in (outs[0], outs[2])]
    covs = [torch.stack(o).permute(3, 0, 1, 2).contiguous()
            for o in (outs[1], outs[3])]
    terms = [torch.stack(o).T.contiguous() for o in (outs[4], outs[5])]
    return means[0], covs[0], means[1], covs[1], terms[0], terms[1]


# ----------------------------------------------------------------------
# K7: the path draw
# ----------------------------------------------------------------------
def _check_sample(phi, q, z, r, x0, w, e):
    dtype = phi.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the path draw takes float32/float64, got {dtype}")
    if phi.dim() != 2:
        raise ValueError(f"phi must be (n, L), got {tuple(phi.shape)}")
    n, lanes = phi.shape
    if z.dim() != 3 or z.shape[1:] != (n, lanes):
        raise ValueError(f"z must be (N, {n}, {lanes}), got {tuple(z.shape)}")
    big_n = z.shape[0]
    if w.dim() != 3 or w.shape[0] != lanes or w.shape[2] != n:
        raise ValueError(f"w must be ({lanes}, T, {n}), got {tuple(w.shape)}")
    t_steps = w.shape[1]
    for name, t, shape in (("q", q, (n, lanes)), ("r", r, (big_n, lanes)),
                           ("x0", x0, (lanes, n)),
                           ("e", e, (lanes, t_steps, big_n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("q", q), ("z", z), ("r", r), ("x0", x0), ("w", w),
                    ("e", e)):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, phi is {dtype}")
    devices = {t.device for t in (phi, q, z, r, x0, w, e)}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    return lanes, t_steps, big_n, n


def lanes_sample(phi, q, z, r, x0, w, e) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xs (L, T, n), y_star (L, T, N))``: each lane's AR path from the
    standard normals ``x0`` (L, n), ``w`` (L, T, n) and its
    pseudo-observations with the normals ``e`` (L, T, N)."""
    _check_sample(phi, q, z, r, x0, w, e)
    if phi.device.type == "cpu":
        return lanes_sample_plain(phi, q, z, r, x0, w, e)
    return lanes_sample_kernel(phi, q, z, r, x0, w, e)


def lanes_sample_kernel(phi, q, z, r, x0, w, e):
    """Launch K7 (CUDA tensors only)."""
    lanes, t_steps, big_n, n = _check_sample(phi, q, z, r, x0, w, e)
    _check_cuda("sample", phi, big_n, n)
    args = [t.contiguous() for t in (phi, q, z, r, x0, w, e)]
    new = _new(phi)
    xs = torch.empty((lanes, t_steps, n), **new)
    y_star = torch.empty((lanes, t_steps, big_n), **new)
    lib = build.load_library("lanes_sample")
    fn = (lib.metran_lanes_sample_f64 if phi.dtype == torch.float64
          else lib.metran_lanes_sample_f32)
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], xs.data_ptr(),
                 y_star.data_ptr(), lanes, t_steps, big_n, n, _stream(phi))
    build.check(lib, err, "lanes_sample")
    if lanes:
        build.count_launch("lanes_sample")
    return xs, y_star


def lanes_sample_plain(phi, q, z, r, x0, w, e):
    """The same path draw in PyTorch ops (``lanes_sample``'s ``ar_step``
    scan and pseudo-observations)."""
    lanes, t_steps, big_n, n = _check_sample(phi, q, z, r, x0, w, e)
    with torch.no_grad():
        phi_l = phi.T
        w = w * torch.sqrt(torch.clamp(q, min=0.0)).T[:, None]
        x = x0
        steps = []
        for t in range(t_steps):
            x = phi_l * x + w[:, t]
            steps.append(x)
        xs = (torch.stack(steps, dim=1) if steps
              else x0.new_zeros((lanes, 0, n)))
        y_star = (torch.einsum("iaL,LTa->LTi", z, xs)
                  + e * torch.sqrt(torch.clamp(r, min=0.0)).T[:, None])
    return xs, y_star


__all__ = [
    "FORWARD_MODES",
    "lanes_forward",
    "lanes_forward_kernel",
    "lanes_forward_plain",
    "lanes_sample",
    "lanes_sample_kernel",
    "lanes_sample_plain",
    "lanes_smooth_bwd",
    "lanes_smooth_bwd_kernel",
    "lanes_smooth_bwd_plain",
]
