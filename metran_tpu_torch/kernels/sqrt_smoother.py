"""K10 wrapper: the factored RTS smoother over a square-root filter's
stored factors.

:func:`sqrt_smooth` runs the square-root engine's Rauch-Tung-Striebel
recursion of ``L`` independent lanes backward over what K9 stored: per
step ``t < T - 1``, with ``(m_s', S_s')`` the smoothed moments at
``t + 1`` and ``(m_p, S_p)`` the predicted ones at ``t + 1``,

    G   = P_f diag(phi) (S_p S_p')^-1      (two triangular solves)
    m_s = m_f + G (m_s' - m_p)
    S_s = tria([(I - G diag(phi)) S_f | G diag(sqrt q) | G S_s'])

(``P_f = S_f S_f'``), and ``(m_s, S_s) = (m_f, S_f)`` at ``T - 1``.  A
step whose ``S_p`` has a diagonal that is not positive, or an entry that
is not finite, is degraded to its filtered moments, carry included, as
the JAX function does.  With ``want_cov=False`` (the mean-only
smoothings of the path draws) the ``tria`` is skipped — the mean
recursion never reads ``S_s`` — and ``chol_s`` is ``None``.

On CUDA tensors it launches the hand-written kernel
(``csrc/sqrt_smoother.cu``) and raises if that cannot build or launch;
on CPU tensors it runs :func:`sqrt_smooth_plain`, the same recursion in
batched PyTorch ops (``torch.cholesky_solve`` against the predicted
factor, ``torch.linalg.qr``).

Layouts, lane-major: ``phi``, ``q`` (L, n) (``q`` the diagonal of Q);
``mean_f``, ``mean_p`` (L, T, n); ``chol_f``, ``chol_p`` (L, T, n, n);
outputs ``mean_s`` (L, T, n) and ``chol_s`` (L, T, n, n).

Replaces ``metran_tpu/ops/kalman.py::sqrt_rts_smoother`` (B6).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from .joint_filter import MAX_SMEM
from .sqrt_filter import _odd, tria


def smem_bytes(n_state: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one block of K10 needs: five n x n
    matrices, the 3n x n stack and six n-vectors."""
    item = torch.finfo(dtype).bits // 8
    n = n_state
    return (5 * n * n + _odd(3 * n) * n + 6 * n) * item


def _check(phi, q, mean_f, chol_f, mean_p, chol_p):
    """Validate the inputs; returns ``(L, T, n)``."""
    dtype = phi.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"the factored smoother takes float32/float64, got {dtype}")
    if phi.dim() != 2:
        raise ValueError(f"phi must be (L, n), got {tuple(phi.shape)}")
    lanes, n = phi.shape
    if mean_f.dim() != 3 or mean_f.shape[0] != lanes or mean_f.shape[2] != n:
        raise ValueError(
            f"mean_f must be ({lanes}, T, {n}), got {tuple(mean_f.shape)}")
    t_steps = mean_f.shape[1]
    for name, t, shape in (("q", q, (lanes, n)),
                           ("mean_p", mean_p, (lanes, t_steps, n)),
                           ("chol_f", chol_f, (lanes, t_steps, n, n)),
                           ("chol_p", chol_p, (lanes, t_steps, n, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("q", q), ("mean_f", mean_f), ("chol_f", chol_f),
                    ("mean_p", mean_p), ("chol_p", chol_p)):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, phi is {dtype}")
    devices = {t.device for t in (phi, q, mean_f, chol_f, mean_p, chol_p)}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    return lanes, t_steps, n


def sqrt_smooth(phi, q, mean_f, chol_f, mean_p, chol_p,
                want_cov: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(mean_s (L, T, n), chol_s (L, T, n, n) or None)`` of every lane
    (see the module doc)."""
    args = (phi, q, mean_f, chol_f, mean_p, chol_p)
    _check(*args)
    if phi.device.type == "cpu":
        return sqrt_smooth_plain(*args, want_cov=want_cov)
    return sqrt_smooth_kernel(*args, want_cov=want_cov)


def sqrt_smooth_kernel(phi, q, mean_f, chol_f, mean_p, chol_p,
                       want_cov: bool = True):
    """Launch K10 (CUDA tensors only; raises otherwise, and when the
    kernel cannot build, take the shape or launch)."""
    lanes, t_steps, n = _check(phi, q, mean_f, chol_f, mean_p, chol_p)
    if phi.device.type != "cuda":
        raise ValueError(
            f"the factored smoother kernel runs on CUDA tensors, got "
            f"{phi.device}")
    smem = smem_bytes(n, phi.dtype)
    if smem > MAX_SMEM:
        raise ValueError(
            f"n={n} at {phi.dtype} needs {smem} bytes of shared memory per "
            f"block; the kernel takes at most {MAX_SMEM}")
    args = [t.contiguous() for t in (phi, q, mean_f, chol_f, mean_p, chol_p)]
    new = dict(dtype=phi.dtype, device=phi.device)
    mean_s = torch.empty((lanes, t_steps, n), **new)
    chol_s = (torch.empty((lanes, t_steps, n, n), **new) if want_cov
              else None)
    lib = build.load_library("sqrt_smoother")
    fn = (lib.metran_sqrt_smoother_f64 if phi.dtype == torch.float64
          else lib.metran_sqrt_smoother_f32)
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], mean_s.data_ptr(),
                 None if chol_s is None else chol_s.data_ptr(), lanes,
                 t_steps, n, torch.cuda.current_stream(phi.device).cuda_stream)
    build.check(lib, err, "sqrt_smooth")
    if lanes and t_steps:
        build.count_launch("sqrt_smooth")
    return mean_s, chol_s


def sqrt_smooth_plain(phi, q, mean_f, chol_f, mean_p, chol_p,
                      want_cov: bool = True):
    """The same recursion in PyTorch ops (``sqrt_rts_smoother``'s
    reverse scan): a Python loop over steps, each step batched over the
    lanes."""
    lanes, t_steps, n = _check(phi, q, mean_f, chol_f, mean_p, chol_p)
    new = dict(dtype=phi.dtype, device=phi.device)
    means = [None] * t_steps
    chols = [None] * t_steps
    if t_steps:
        eye = torch.eye(n, **new)
        qs = torch.sqrt(torch.clamp(q, min=0.0))
        m_s, c_s = mean_f[:, -1], chol_f[:, -1]
        means[-1], chols[-1] = m_s, c_s
        for t in range(t_steps - 2, -1, -1):
            mf, cf = mean_f[:, t], chol_f[:, t]
            mp, sp = mean_p[:, t + 1], chol_p[:, t + 1]
            d = torch.diagonal(sp, 0, -2, -1)
            ok = (d > 0).all(dim=-1) & torch.isfinite(sp).all(dim=(-2, -1))
            sp_safe = torch.where(ok[:, None, None], sp, eye)
            a = phi[:, :, None] * (cf @ cf.transpose(-1, -2))
            g = torch.cholesky_solve(a, sp_safe, upper=False).transpose(-1,
                                                                        -2)
            m_new = mf + (g @ (m_s - mp)[:, :, None])[..., 0]
            m_s = torch.where(ok[:, None], m_new, mf)
            if want_cov:
                c_new = tria(torch.cat([
                    (eye - g * phi[:, None, :]) @ cf,
                    g * qs[:, None, :],
                    g @ c_s,
                ], dim=2))
                c_s = torch.where(ok[:, None, None], c_new, cf)
            means[t], chols[t] = m_s, c_s
    mean_s = (torch.stack(means, dim=1) if t_steps
              else torch.zeros((lanes, 0, n), **new))
    if not want_cov:
        return mean_s, None
    chol_s = (torch.stack(chols, dim=1) if t_steps
              else torch.zeros((lanes, 0, n, n), **new))
    return mean_s, chol_s


__all__ = ["smem_bytes", "sqrt_smooth", "sqrt_smooth_kernel",
           "sqrt_smooth_plain"]
