"""K8 wrapper: the RTS smoother's backward pass over stored filter moments.

:func:`rts_smooth` runs the Rauch-Tung-Striebel recursion of ``L``
independent lanes (one model, or one path draw, each) backward over the
moments a stored sequential filter kept (K6 in its ``store`` mode):
per step ``t < T - 1``, with ``(m_s', C_s')`` the smoothed moments at
``t + 1``,

    G   = P_f diag(phi) P_p,t+1^-1       (Cholesky of P_p,t+1)
    m_s = m_f + G (m_s' - m_p,t+1)
    C_s = P_f + G (C_s' - P_p,t+1) G'

and ``(m_s, C_s) = (m_f, P_f)`` at ``T - 1``.  A step whose ``P_p,t+1``
has no Cholesky factor (a pivot that is not positive, or anything not
finite) is degraded to its filtered moments, carry included, as the JAX
function does on the NaN of ``jnp.linalg.cholesky``.

On CUDA tensors it launches the hand-written kernel
(``csrc/rts_smoother.cu``) and raises if that cannot build or launch; on
CPU tensors it runs :func:`rts_smooth_plain`, the same recursion in
batched PyTorch ops (``torch.linalg.cholesky_ex``, which reports the
failure the kernel detects instead of raising).

Layouts, lane-major: ``phi`` (L, n); ``mean_f``, ``mean_p`` (L, T, n);
``cov_f``, ``cov_p`` (L, T, n, n); outputs ``mean_s`` (L, T, n) and
``cov_s`` (L, T, n, n), or ``None`` with ``want_cov=False`` (the
mean-only smoothings of the path draws; the recursion is the same).

Replaces ``metran_tpu/ops/kalman.py::rts_smoother`` (B5).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from .joint_filter import MAX_SMEM


def smem_bytes(n_state: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one block of K8 needs: five n x n matrices
    and four n-vectors."""
    item = torch.finfo(dtype).bits // 8
    n = n_state
    return (5 * n * n + 4 * n) * item


def _check(phi, mean_f, cov_f, mean_p, cov_p):
    """Validate the inputs; returns ``(L, T, n)``."""
    dtype = phi.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the RTS smoother takes float32/float64, got {dtype}")
    if phi.dim() != 2:
        raise ValueError(f"phi must be (L, n), got {tuple(phi.shape)}")
    lanes, n = phi.shape
    if mean_f.dim() != 3 or mean_f.shape[0] != lanes or mean_f.shape[2] != n:
        raise ValueError(
            f"mean_f must be ({lanes}, T, {n}), got {tuple(mean_f.shape)}")
    t_steps = mean_f.shape[1]
    for name, t, shape in (("mean_p", mean_p, (lanes, t_steps, n)),
                           ("cov_f", cov_f, (lanes, t_steps, n, n)),
                           ("cov_p", cov_p, (lanes, t_steps, n, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("mean_f", mean_f), ("cov_f", cov_f),
                    ("mean_p", mean_p), ("cov_p", cov_p)):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, phi is {dtype}")
    devices = {t.device for t in (phi, mean_f, cov_f, mean_p, cov_p)}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    return lanes, t_steps, n


def rts_smooth(phi, mean_f, cov_f, mean_p, cov_p, want_cov: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(mean_s (L, T, n), cov_s (L, T, n, n) or None)`` of every lane
    (see the module doc)."""
    args = (phi, mean_f, cov_f, mean_p, cov_p)
    _check(*args)
    if phi.device.type == "cpu":
        return rts_smooth_plain(*args, want_cov=want_cov)
    return rts_smooth_kernel(*args, want_cov=want_cov)


def rts_smooth_kernel(phi, mean_f, cov_f, mean_p, cov_p,
                      want_cov: bool = True):
    """Launch K8 (CUDA tensors only; raises otherwise, and when the
    kernel cannot build, take the shape or launch)."""
    lanes, t_steps, n = _check(phi, mean_f, cov_f, mean_p, cov_p)
    if phi.device.type != "cuda":
        raise ValueError(
            f"the RTS smoother kernel runs on CUDA tensors, got {phi.device}")
    smem = smem_bytes(n, phi.dtype)
    if smem > MAX_SMEM:
        raise ValueError(
            f"n={n} at {phi.dtype} needs {smem} bytes of shared memory per "
            f"block; the kernel takes at most {MAX_SMEM}")
    args = [t.contiguous() for t in (phi, mean_f, cov_f, mean_p, cov_p)]
    new = dict(dtype=phi.dtype, device=phi.device)
    mean_s = torch.empty((lanes, t_steps, n), **new)
    cov_s = (torch.empty((lanes, t_steps, n, n), **new) if want_cov
             else None)
    lib = build.load_library("rts_smoother")
    fn = (lib.metran_rts_smoother_f64 if phi.dtype == torch.float64
          else lib.metran_rts_smoother_f32)
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], mean_s.data_ptr(),
                 None if cov_s is None else cov_s.data_ptr(), lanes,
                 t_steps, n, torch.cuda.current_stream(phi.device).cuda_stream)
    build.check(lib, err, "rts_smooth")
    if lanes and t_steps:
        build.count_launch("rts_smooth")
    return mean_s, cov_s


def rts_smooth_plain(phi, mean_f, cov_f, mean_p, cov_p,
                     want_cov: bool = True):
    """The same recursion in PyTorch ops (``rts_smoother``'s reverse
    scan): a Python loop over steps, each step batched over the lanes."""
    lanes, t_steps, n = _check(phi, mean_f, cov_f, mean_p, cov_p)
    means = [None] * t_steps
    covs = [None] * t_steps
    if t_steps:
        eye = torch.eye(n, dtype=phi.dtype, device=phi.device)
        m_s, c_s = mean_f[:, -1], cov_f[:, -1]
        means[-1], covs[-1] = m_s, c_s
        for t in range(t_steps - 2, -1, -1):
            mf, pf = mean_f[:, t], cov_f[:, t]
            mp, pp = mean_p[:, t + 1], cov_p[:, t + 1]
            a = pf * phi[:, None, :]
            chol, info = torch.linalg.cholesky_ex(pp)
            ok = (info == 0) & torch.isfinite(chol).all(dim=(-2, -1))
            chol = torch.where(ok[:, None, None], chol, eye)
            g = torch.cholesky_solve(a.transpose(-1, -2), chol).transpose(
                -1, -2)
            m_new = mf + (g @ (m_s - mp)[..., None])[..., 0]
            c_new = pf + g @ (c_s - pp) @ g.transpose(-1, -2)
            m_s = torch.where(ok[:, None], m_new, mf)
            c_s = torch.where(ok[:, None, None], c_new, pf)
            means[t], covs[t] = m_s, c_s
    new = dict(dtype=phi.dtype, device=phi.device)
    mean_s = (torch.stack(means, dim=1) if t_steps
              else torch.zeros((lanes, 0, n), **new))
    if not want_cov:
        return mean_s, None
    cov_s = (torch.stack(covs, dim=1) if t_steps
             else torch.zeros((lanes, 0, n, n), **new))
    return mean_s, cov_s


__all__ = ["rts_smooth", "rts_smooth_kernel", "rts_smooth_plain",
           "smem_bytes"]
