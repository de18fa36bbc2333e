"""K15 wrapper: the steady-state (DARE) solve and the frozen gains.

:func:`dare_gains` solves, for each of ``B`` models that share their
dimensions, the steady predicted covariance of the fully-observed
masked filter

    P = Phi (P - P Z' F^-1 Z P) Phi' + Q,   F = Z P Z' + R

by Newton-Kleinman iteration (``newton_iters`` steps from the stable
gain ``K = 0``), each Lyapunov solve by ``doubling_iters`` doubling steps
(``S <- S + M S M'``, ``M <- M M``), every iterate symmetrised as the
JAX program does; ``R^-1`` is never formed, so exact observations
(``r = 0``) are fine.  Zero-``Z``-row (padded) slots carry unit
pseudo-noise, an innovation variance of 1 and a zero gain column.  With
``p_pred`` given it skips the solve.  It returns ``(p_pred, p_filt,
kgain, fdiag, kgain_seq, fdiag_seq)``: the steady predicted and
filtered covariances (B, S, S), the joint gain ``P Z' F^-1`` (B, S, N)
and ``diag F`` (B, N), and the per-slot sequential gains (B, S, N) and
conditional variances (B, N) of the slot-ordered rank-1 recursion at
``P``.

On CUDA tensors it launches the hand-written kernel (``csrc/dare.cu``,
one thread block per model, every product, factorisation and solve
inside the launch) and raises if that cannot build or launch — or when
the model's iterates do not fit in a block's shared memory; on CPU
tensors it runs :func:`dare_gains_plain`, the JAX program in batched
PyTorch ops.

Replaces ``metran_tpu/ops/kalman.py::dare_solve`` and ``steady_gains``
(B9b steady).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from .joint_filter import MAX_SMEM
from .lanes import _ptr, _stream


def smem_bytes(n_obs: int, n_state: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one block needs (mirrors ``dare_smem`` in
    the source): about ``9 S^2 + 2 N^2`` words."""
    item = torch.finfo(dtype).bits // 8
    n, s = n_obs, n_state
    w = max(n, s)
    return item * (3 * n * s + 2 * s + n + 7 * s * s + 2 * w * w
                   + 2 * n * n + 1)


def _check(phi, q, z, r, p_pred):
    dtype = phi.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the DARE solve takes float32/float64, got {dtype}")
    if phi.dim() != 2:
        raise ValueError(f"phi must be (B, S), got {tuple(phi.shape)}")
    b, s = phi.shape
    if z.dim() != 3 or z.shape[0] != b or z.shape[2] != s:
        raise ValueError(f"z must be (B, N, S), got {tuple(z.shape)}")
    n = z.shape[1]
    shapes = {"q": (q, (b, s, s)), "r": (r, (b, n))}
    if p_pred is not None:
        shapes["p_pred"] = (p_pred, (b, s, s))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for t in (q, z, r) + (() if p_pred is None else (p_pred,)):
        if t.dtype != dtype:
            raise TypeError(f"inputs mix {t.dtype} and {dtype}")
    devices = {t.device for t in (phi, q, z, r)}
    if p_pred is not None:
        devices.add(p_pred.device)
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    return b, n, s


def dare_gains(phi, q, z, r, p_pred: Optional[torch.Tensor] = None,
               newton_iters: int = 24, doubling_iters: int = 32
               ) -> Tuple[torch.Tensor, ...]:
    """``(p_pred, p_filt, kgain, fdiag, kgain_seq, fdiag_seq)`` of every
    model (see the module doc)."""
    _check(phi, q, z, r, p_pred)
    fn = dare_gains_plain if phi.device.type == "cpu" else dare_gains_kernel
    return fn(phi, q, z, r, p_pred, newton_iters, doubling_iters)


def dare_gains_kernel(phi, q, z, r, p_pred=None, newton_iters: int = 24,
                      doubling_iters: int = 32):
    """Launch K15 (CUDA tensors only; raises otherwise, and when the
    kernel cannot build, take the shape or launch)."""
    b, n, s = _check(phi, q, z, r, p_pred)
    if phi.device.type != "cuda":
        raise ValueError(
            f"the DARE kernel runs on CUDA tensors, got {phi.device}")
    smem = smem_bytes(n, s, phi.dtype)
    if smem > MAX_SMEM:
        raise ValueError(
            f"(N={n}, S={s}) at {phi.dtype} needs {smem} bytes of shared "
            f"memory per block (about 9 S^2 + 2 N^2 words); the kernel "
            f"takes at most {MAX_SMEM} (the 227 KB opt-in)")
    args = [t.contiguous() for t in (phi, q, z, r)]
    given = None if p_pred is None else p_pred.contiguous()
    new = dict(dtype=phi.dtype, device=phi.device)
    outs = (torch.empty((b, s, s), **new), torch.empty((b, s, s), **new),
            torch.empty((b, s, n), **new), torch.empty((b, n), **new),
            torch.empty((b, s, n), **new), torch.empty((b, n), **new))
    lib = build.load_library("dare")
    fn = lib.metran_dare_f64 if phi.dtype == torch.float64 else \
        lib.metran_dare_f32
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], _ptr(given),
                 *[o.data_ptr() for o in outs], b, n, s, int(newton_iters),
                 int(doubling_iters), _stream(phi))
    build.check(lib, err, "dare")
    if b:
        build.count_launch("dare")
    return outs


def dare_gains_plain(phi, q, z, r, p_pred=None, newton_iters: int = 24,
                     doubling_iters: int = 32):
    """The same program in PyTorch ops, batched over the models (the JAX
    ``dare_solve`` and ``steady_gains`` step for step)."""
    b, n, s = _check(phi, q, z, r, p_pred)
    dtype, dev = phi.dtype, phi.device
    eye = torch.eye(s, dtype=dtype, device=dev)
    real = (z != 0).any(-1)
    realf = real.to(dtype)
    z_m = z * realf[..., None]
    r_eff = torch.where(real, r, torch.zeros_like(r)) + (1.0 - realf)

    def sym(x):
        return 0.5 * (x + x.transpose(-1, -2))

    def lyap(a, rhs):
        m, x = a, rhs
        for _ in range(int(doubling_iters)):
            x = sym(x + m @ x @ m.transpose(-1, -2))
            m = m @ m
        return x

    def gain(p):
        f = z_m @ p @ z_m.transpose(-1, -2) + torch.diag_embed(r_eff)
        chol, info = torch.linalg.cholesky_ex(sym(f))
        # a factorisation that fails is NaN, as the JAX function's is
        chol = torch.where((info != 0)[:, None, None],
                           torch.full_like(chol, float("nan")), chol)
        return f, torch.cholesky_solve(z_m @ p, chol)

    if p_pred is None:
        p = lyap(torch.diag_embed(phi), q)
        for _ in range(int(newton_iters)):
            _, kt = gain(p)
            a = phi[:, :, None] * (eye - kt.transpose(-1, -2) @ z_m)
            rhs = (phi[:, :, None]
                   * ((kt.transpose(-1, -2) * r_eff[:, None, :]) @ kt)
                   * phi[:, None, :] + q)
            p = sym(lyap(a, rhs))
    else:
        p = p_pred
    f, kt = gain(p)
    kgain = kt.transpose(-1, -2)
    p_filt = sym(p - kgain @ f @ kt)
    pp, ks, fs = p, [], []
    for i in range(n):
        z_i = z_m[:, i]
        d = (pp @ z_i[:, :, None])[..., 0]
        f_i = (z_i * d).sum(-1) + r_eff[:, i]
        k_i = d / f_i[:, None]
        pp = pp - (k_i[:, :, None] * k_i[:, None, :]) * f_i[:, None, None]
        ks.append(k_i)
        fs.append(f_i)
    return (p, p_filt, kgain, torch.diagonal(f, 0, -2, -1).contiguous(),
            torch.stack(ks, -1), torch.stack(fs, -1))


__all__ = [
    "dare_gains",
    "dare_gains_kernel",
    "dare_gains_plain",
    "smem_bytes",
]
