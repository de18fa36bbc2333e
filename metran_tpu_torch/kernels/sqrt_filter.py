"""K9 wrapper: the square-root (QR array) Kalman filter.

:func:`sqrt_filter` runs the square-root filter of ``L`` independent
lanes, carrying the mean and a factor ``S`` of the state covariance
(``P = S S'``): per step the predict ``m_p = phi o m``, ``S_p =
tria([phi o S | diag(sqrt q)])`` and the array update, one QR of

    [[ diag(sqrt r)    0   ]
     [ (Z_m S_p)'     S_p' ]]

(``Z_m`` the masked observation matrix, unit pseudo-noise on masked
slots), whose sign-normalised triangular result holds ``F^1/2``, the
scaled gain ``Kbar`` and the filtered factor ``S_f``; then ``w =
F^-1/2' \\ v``, ``m_f = m_p + Kbar w``, ``sigma = w.w`` and ``detf = 2
sum log diag F^1/2``.  A step whose ``F^1/2`` has a diagonal that is not
positive, or whose triangular result has an entry that is not finite,
passes the state through (``m_f = m_p``, ``S_f = S_p``) with ``sigma =
0`` and ``detf = +inf``.  No Cholesky of a computed matrix is taken:
every factor comes from orthogonal transformations, PSD by construction.

With ``store=True`` it returns every step's ``(mean_p, chol_p, mean_f,
chol_f, sigma, detf)``: (L, T, n), (L, T, n, n), (L, T, n), (L, T, n, n),
(L, T), (L, T) — what the factored smoother K10 reads.  Without, it
returns the final carry and the per-step terms, ``(mean (L, n), chol
(L, n, n), sigma (L, T), detf (L, T))``, starting from ``(0, I)`` or,
when given, from ``(mean0 (L, n), chol0 (L, n, n))`` per lane (a factor
that need not be triangular).  Without ``store`` but with
``bounds_seg`` it also returns the carry at the start of every segment
of ``bounds_seg`` steps, ``(bounds_mean (L, n_seg, n), bounds_chol
(L, n_seg, n, n))`` — the forward of the batch-layout adjoint
(``metran_tpu_torch.ops.adjoint``); the other outputs are those of the
call without it, bit for bit.

On CUDA tensors it launches the hand-written kernel
(``csrc/sqrt_filter.cu``) and raises if that cannot build or launch; on
CPU tensors it runs :func:`sqrt_filter_plain`, the JAX algorithm step by
step in PyTorch ops (``torch.linalg.qr`` of the full pre-array, sign
normalisation, ``solve_triangular``), differentiable by autograd.

Layouts as :func:`metran_tpu_torch.kernels.lanes_products.lanes_forward`:
``phi``, ``q`` (n, L) (``q`` the diagonal of Q), ``z`` (N, n, L), ``r``
(N, L); ``y``, ``mask`` (D, T, N) read through ``lane_map`` (L,) int32.

Replaces ``metran_tpu/ops/kalman.py``: ``_sqrt_kalman_filter``
(``_make_sqrt_core_step``, ``_sqrt_qr_update``, ``_tria``; B6) and the
square-root half of B9b, ``sqrt_filter_append``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from .joint_filter import MAX_SMEM
from .lanes import _check, _ptr, _stream


def _odd(rows: int) -> int:
    return rows | 1


def smem_bytes(n_obs: int, n_state: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one block of K9 needs (mirrors ``carve`` in
    the source): Z, the carry, the predicted factor, both work arrays
    and a few vectors, plus the observed-slot list."""
    item = torch.finfo(dtype).bits // 8
    big_n, n = n_obs, n_state
    elems = (big_n * n + big_n + 3 * n + n * n + n + n * n
             + _odd(2 * n) * n + _odd(big_n + n) * (big_n + n)
             + (big_n + n) + 2 * big_n)
    return elems * item + 4 * big_n


# ----------------------------------------------------------------------
# the plain step (shared with the factored smoother's plain version)
# ----------------------------------------------------------------------
def sign_normalize_rows(r: torch.Tensor) -> torch.Tensor:
    """Flip rows of upper-triangular QR factors (leading batch axes) so
    each diagonal is non-negative; a NaN diagonal NaNs its row, as the
    JAX package's ``jnp.sign`` does."""
    d = torch.diagonal(r, 0, -2, -1)
    sign = torch.where(torch.isnan(d), d,
                       torch.where(d < 0, -torch.ones_like(d),
                                   torch.ones_like(d)))
    return sign[..., :, None] * r


def tria(blocks: torch.Tensor) -> torch.Tensor:
    """Lower-triangular ``L`` with ``L L' = B B'`` for ``B`` (..., n, k),
    k >= n, via the QR of ``B'`` (``mode="reduced"``, which has a
    backward); the diagonal is sign-normalised to be non-negative."""
    r = torch.linalg.qr(blocks.transpose(-1, -2), mode="reduced").R
    return sign_normalize_rows(r).transpose(-1, -2)


def sqrt_step_plain(ph, qs, zl, rl, mean, chol, y_t, mask_t):
    """One square-root filter step of a batch of lanes (the JAX
    ``_make_sqrt_core_step`` + ``_sqrt_qr_update``): ``ph``/``qs`` (L, n)
    (``qs`` = ``sqrt(max(q, 0))``), ``zl`` (L, N, n), ``rl`` (L, N),
    ``mean`` (L, n), ``chol`` (L, n, n), ``y_t`` (L, N), ``mask_t``
    (L, N) bool.  Returns ``(mean_p, chol_p, mean_f, chol_f, sigma,
    detf)``."""
    dtype = mean.dtype
    lanes, big_n, n = zl.shape
    mean_p = ph * mean
    chol_p = tria(torch.cat([ph[:, :, None] * chol, torch.diag_embed(qs)],
                            dim=2))
    maskf = mask_t.to(dtype)
    z_m = zl * maskf[:, :, None]
    r_t = torch.where(mask_t, rl, torch.zeros_like(rl)) + (1.0 - maskf)
    v = torch.where(mask_t, y_t - (zl @ mean_p[:, :, None])[..., 0],
                    torch.zeros_like(y_t))
    top = torch.cat([torch.diag_embed(torch.sqrt(r_t)),
                     zl.new_zeros((lanes, big_n, n))], dim=2)
    bottom = torch.cat([(z_m @ chol_p).transpose(-1, -2),
                        chol_p.transpose(-1, -2)], dim=2)
    pre = torch.cat([top, bottom], dim=1)
    rfull = sign_normalize_rows(torch.linalg.qr(pre, mode="reduced").R)
    fu = rfull[:, :big_n, :big_n]
    kbar = rfull[:, :big_n, big_n:].transpose(-1, -2)
    chol_u = rfull[:, big_n:, big_n:].transpose(-1, -2)
    d = torch.diagonal(fu, 0, -2, -1)
    ok = (d > 0).all(dim=-1) & torch.isfinite(rfull).all(dim=(-2, -1))
    eye_m = torch.eye(big_n, dtype=dtype, device=mean.device)
    fu_safe = torch.where(ok[:, None, None], fu, eye_m)
    w = torch.linalg.solve_triangular(fu_safe.transpose(-1, -2),
                                      v[:, :, None], upper=False)[..., 0]
    mean_f = torch.where(ok[:, None], mean_p + (kbar @ w[:, :, None])[..., 0],
                         mean_p)
    chol_f = torch.where(ok[:, None, None], chol_u, chol_p)
    zero = torch.zeros((), dtype=dtype, device=mean.device)
    sigma = torch.where(ok, torch.sum(w * w, dim=-1), zero)
    logd = torch.log(torch.where(ok[:, None], d, torch.ones_like(d)))
    detf = torch.where(ok, 2.0 * torch.sum(logd, dim=-1),
                       torch.full_like(sigma, float("inf")))
    return mean_p, chol_p, mean_f, chol_f, sigma, detf


# ----------------------------------------------------------------------
def _check_sqrt(phi, q, z, r, y, mask, lane_map, mean0, chol0):
    out = _check(phi, q, z, r, y, mask, lane_map, None)
    lanes, n = out[0], out[4]
    if (mean0 is None) != (chol0 is None):
        raise ValueError("mean0 and chol0 come together (or neither)")
    if mean0 is not None:
        for name, t, shape in (("mean0", mean0, (lanes, n)),
                               ("chol0", chol0, (lanes, n, n))):
            if tuple(t.shape) != shape:
                raise ValueError(
                    f"{name} must be {shape}, got {tuple(t.shape)}")
            if t.dtype != phi.dtype:
                raise TypeError(f"{name} is {t.dtype}, phi is {phi.dtype}")
            if t.device != phi.device:
                raise ValueError(f"{name} is on {t.device}, phi on "
                                 f"{phi.device}")
    return out


def _n_seg(store, bounds_seg, t_steps):
    """``n_seg`` of a call with boundaries (None without them)."""
    if bounds_seg is None:
        return None
    if store:
        raise ValueError("store=True and bounds_seg exclude each other")
    if int(bounds_seg) < 1:
        raise ValueError(f"bounds_seg must be >= 1, got {bounds_seg}")
    return -(-t_steps // int(bounds_seg))


def sqrt_filter(phi, q, z, r, y, mask, lane_map=None, store: bool = False,
                mean0=None, chol0=None, bounds_seg: Optional[int] = None
                ) -> Tuple[torch.Tensor, ...]:
    """The square-root filter of every lane (see the module doc)."""
    _check_sqrt(phi, q, z, r, y, mask, lane_map, mean0, chol0)
    if phi.device.type == "cpu":
        return sqrt_filter_plain(phi, q, z, r, y, mask, lane_map, store,
                                 mean0, chol0, bounds_seg)
    return sqrt_filter_kernel(phi, q, z, r, y, mask, lane_map, store, mean0,
                              chol0, bounds_seg)


def sqrt_filter_kernel(phi, q, z, r, y, mask, lane_map=None,
                       store: bool = False, mean0=None, chol0=None,
                       bounds_seg: Optional[int] = None):
    """Launch K9 (CUDA tensors only; raises otherwise, and when the
    kernel cannot build, take the shape or launch)."""
    lanes, _, t_steps, big_n, n, _, _, lane_map = _check_sqrt(
        phi, q, z, r, y, mask, lane_map, mean0, chol0)
    n_seg = _n_seg(store, bounds_seg, t_steps)
    if phi.device.type != "cuda":
        raise ValueError(
            f"the square-root filter kernel runs on CUDA tensors, got "
            f"{phi.device}")
    smem = smem_bytes(big_n, n, phi.dtype)
    if smem > MAX_SMEM:
        raise ValueError(
            f"(N={big_n}, n={n}) at {phi.dtype} needs {smem} bytes of "
            f"shared memory per block; the kernel takes at most {MAX_SMEM}")
    args = [t.contiguous() for t in (phi, q, z, r, y, mask, lane_map)]
    init = [None if t is None else t.contiguous() for t in (mean0, chol0)]
    new = dict(dtype=phi.dtype, device=phi.device)
    terms = (torch.empty((lanes, t_steps), **new),
             torch.empty((lanes, t_steps), **new))
    if store:
        moments = ((lanes, t_steps, n), (lanes, t_steps, n, n))
        outs = tuple(torch.empty(shape, **new) for shape in (*moments,
                                                             *moments))
        ptrs = [o.data_ptr() for o in outs]
    else:
        outs = (torch.empty((lanes, n), **new),
                torch.empty((lanes, n, n), **new))
        ptrs = [None, None] + [o.data_ptr() for o in outs]
    bounds = () if n_seg is None else (
        torch.empty((lanes, n_seg, n), **new),
        torch.empty((lanes, n_seg, n, n), **new))
    bounds_ptr = [t.data_ptr() for t in bounds] or [None, None]
    lib = build.load_library("sqrt_filter")
    fn = (lib.metran_sqrt_filter_f64 if phi.dtype == torch.float64
          else lib.metran_sqrt_filter_f32)
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], _ptr(init[0]), _ptr(init[1]),
                 *ptrs, *[t.data_ptr() for t in terms], *bounds_ptr, lanes,
                 t_steps, big_n, n, int(bool(store)), int(bounds_seg or 1),
                 _stream(phi))
    build.check(lib, err, "sqrt_filter")
    if lanes:
        build.count_launch("sqrt_filter")
    return (*outs, *terms, *bounds)


def sqrt_filter_plain(phi, q, z, r, y, mask, lane_map=None,
                      store: bool = False, mean0=None, chol0=None,
                      bounds_seg: Optional[int] = None):
    """The same filter in PyTorch ops: a Python loop over steps, each
    step :func:`sqrt_step_plain` batched over the lanes (autograd runs
    through it)."""
    lanes, _, t_steps, big_n, n, _, _, lane_map = _check_sqrt(
        phi, q, z, r, y, mask, lane_map, mean0, chol0)
    n_seg = _n_seg(store, bounds_seg, t_steps)
    new = dict(dtype=phi.dtype, device=phi.device)
    ph = phi.T
    qs = torch.sqrt(torch.clamp(q.T, min=0.0))
    zl = z.permute(2, 0, 1)
    rl = r.T
    idx = lane_map.long()
    yl, ml = y[idx], mask[idx]
    if mean0 is None:
        mean = torch.zeros((lanes, n), **new)
        chol = torch.eye(n, **new).expand(lanes, n, n)
    else:
        mean, chol = mean0, chol0
    steps, b_mean, b_chol = [], [], []
    for t in range(t_steps):
        if n_seg is not None and t % int(bounds_seg) == 0:
            b_mean.append(mean)
            b_chol.append(chol)
        out = sqrt_step_plain(ph, qs, zl, rl, mean, chol, yl[:, t], ml[:, t])
        mean, chol = out[2], out[3]
        steps.append(out if store else out[4:])
    bounds = ()
    if n_seg is not None:
        bounds = ((torch.stack(b_mean, 1), torch.stack(b_chol, 1)) if b_mean
                  else (torch.zeros((lanes, 0, n), **new),
                        torch.zeros((lanes, 0, n, n), **new)))
    if store:
        if not t_steps:
            moments = ((lanes, 0, n), (lanes, 0, n, n))
            return tuple(torch.zeros(s, **new) for s in
                         (*moments, *moments, (lanes, 0), (lanes, 0)))
        return tuple(torch.stack(parts, dim=1) for parts in zip(*steps))
    if not t_steps:
        empty = torch.zeros((lanes, 0), **new)
        return (mean, chol.contiguous(), empty, empty.clone(), *bounds)
    sigma, detf = (torch.stack(parts, dim=1) for parts in zip(*steps))
    return (mean, chol, sigma, detf, *bounds)


__all__ = [
    "sign_normalize_rows",
    "smem_bytes",
    "sqrt_filter",
    "sqrt_filter_kernel",
    "sqrt_filter_plain",
    "sqrt_step_plain",
    "tria",
]
