"""The scalar implicit-MAP solve of the robust serving update, in batched
PyTorch ops: the plain twin of ``csrc/implicit_map.cuh``.

A flagged observation slot of K12's and K9's ``robust`` modes replaces
the Gaussian conditioning with a scalar problem on the slot's predicted
observation ``s = z_i' x``: prior ``s ~ N(mu, c)`` and a non-Gaussian
negative log-likelihood ``nll(s)``, solved by damped Newton on

    phi(s) = (s - mu)^2 / (2 c) + nll(s)

(curvature ``1/c + max(nll'', 0)``, step clamped to ``+-8 sqrt(c)``, at
most :data:`NEWTON_ITERS` steps, a lane stopping once ``|phi'| sqrt(c)
<= 8 sqrt(eps)`` at its current iterate) and summarised by its MAP
point ``s_hat`` and the floored Laplace curvature ``w = max(nll''(s_hat),
0)``.

The three likelihoods (``sigma`` the slot scale, ``max(sqrt(r),
scale)``):

- ``"censored"``: a reading at or beyond a rail carries the one-sided
  tail mass, ``-log Phi((s - hi) / sigma)`` (high rail) or ``-log
  Phi((lo - s) / sigma)``;
- ``"quantized"``: the mass of the reading's cell, ``-log [Phi(b) -
  Phi(a)]``, ``b, a = (y +- q/2 - s) / sigma``, reflected into the lower
  tail when ``a + b > 0`` and evaluated as ``lb + log1p(-exp(min(la -
  lb, log1p(-eps))))``;
- ``"huber_t"``: ``0.5 (nu + 1) log1p(((y - s) / sigma)^2 / nu)``.

``log Phi`` is the JAX package's own ``log_ndtr`` (its segments -20/8
in f64 and -10/5 in f32, the order-3 asymptotic series below the lower
one), not :func:`torch.special.log_ndtr`, whose deep tail differs from
that series.  The derivatives are closed forms of what JAX's autodiff
evaluates (``jax.grad``, then ``jax.jvp`` of it), written in the order
of its reverse pass and of the forward pass over it, so the rounding
follows JAX's as far as the elementary functions allow:
``log_ndtr``'s custom JVP ``r(x) = exp(norm_logpdf(x) - log_ndtr(x))``
in every branch, its derivative ``r (-x - r)``, a zero derivative
where the quantized ``min`` clips, and only the branch each ``where``
selects.

Replaces ``metran_tpu/ops/implicit_map.py``: ``_nll_factory`` :135,
``_flag_fn`` :187, ``_scalar_map_solve`` :196 and ``_solver_tols``
:126 (the scalar half of B12).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

#: observation likelihoods of the robust update (``"gaussian"`` is the
#: exact update itself)
ROBUST_LIKELIHOODS = ("gaussian", "censored", "quantized", "huber_t")
#: the likelihoods that solve a MAP problem, in the kernels' codes
MAP_LIKELIHOODS = ("censored", "quantized", "huber_t")
#: per-slot verdicts of the robust update (disjoint from the gate's
#: 0/1/2): a flagged slot that took the MAP path, and one whose solve
#: missed the residual bar
ROBUST_MAP = 3
ROBUST_NONCONV = 4
#: the inner solve's budget of damped Newton steps per flagged slot
NEWTON_ITERS = 12

# JAX's log_ndtr segments (jax/_src/scipy/special.py)
_SEGMENTS = {torch.float64: (-20.0, 8.0), torch.float32: (-10.0, 5.0)}


class RobustParams(NamedTuple):
    """What a robust update needs beyond the gated one: the likelihood,
    the Student-t ``nu`` and the per-slot parameters ``rail_lo``,
    ``rail_hi``, ``quantum`` and ``scale`` (each (B, N), standardized
    observation units)."""

    likelihood: str
    nu: float
    rail_lo: torch.Tensor
    rail_hi: torch.Tensor
    quantum: torch.Tensor
    scale: torch.Tensor


def likelihood_code(likelihood: str) -> int:
    """The kernels' code of a MAP likelihood (0 censored, 1 quantized,
    2 huber_t)."""
    if likelihood not in MAP_LIKELIHOODS:
        raise ValueError(
            f"unknown robust likelihood {likelihood!r}; the robust "
            f"kernels take one of {MAP_LIKELIHOODS}")
    return MAP_LIKELIHOODS.index(likelihood)


def check_likelihood(likelihood: str) -> None:
    if likelihood not in ROBUST_LIKELIHOODS:
        raise ValueError(
            f"unknown robust likelihood {likelihood!r}; expected one of "
            f"{ROBUST_LIKELIHOODS}")


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def solver_tols(dtype: torch.dtype) -> Tuple[float, float]:
    """``(done_tol, nonconv_tol)`` on the dimensionless residual
    ``|phi'(s)| sqrt(c)``: ``8 sqrt(eps)`` and 125 times that."""
    eps = float(np.finfo(_np_dtype(dtype)).eps)
    tol = 8.0 * eps ** 0.5
    return tol, 125.0 * tol


def c_floor(dtype: torch.dtype) -> float:
    """The floor of the prior variance ``c``, ``sqrt(tiny)`` rounded to
    ``dtype``."""
    return float(_np_dtype(dtype)(np.finfo(_np_dtype(dtype)).tiny ** 0.5))


def _const(x: torch.Tensor, value) -> torch.Tensor:
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def _ndtr(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``_ndtr``: ``Phi`` through ``erf`` near 0 and ``erfc`` in
    the tails."""
    npd = _np_dtype(x.dtype)
    half_sqrt_2 = _const(x, npd(0.5) * np.sqrt(2.0, dtype=npd))
    w = x * half_sqrt_2
    z = w.abs()
    y = torch.where(z < half_sqrt_2, 1.0 + torch.erf(w),
                    torch.where(w > 0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def _log_ndtr_lower(x: torch.Tensor) -> torch.Tensor:
    """The order-3 asymptotic series of ``log Phi`` below the lower
    segment."""
    npd = _np_dtype(x.dtype)
    x_2 = x * x
    log_scale = (-0.5 * x_2 - torch.log(-x)
                 - _const(x, npd(0.5 * np.log(2.0 * np.pi))))
    odd = 1.0 / x_2
    x_4 = x_2 * x_2
    even = 3.0 / x_4
    odd = odd + 15.0 / (x_4 * x_2)
    return log_scale + torch.log(1.0 + even - odd)


def log_ndtr(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``log_ndtr`` (``jax.scipy.special``), piecewise
    as it is written there."""
    lower, upper = (_const(x, v) for v in _SEGMENTS[x.dtype])
    return torch.where(
        x > upper, -_ndtr(-x),
        torch.where(x > lower, torch.log(_ndtr(torch.maximum(x, lower))),
                    _log_ndtr_lower(torch.minimum(x, lower))))


def norm_logpdf(x: torch.Tensor) -> torch.Tensor:
    npd = _np_dtype(x.dtype)
    return -0.5 * (x * x) - _const(x, npd(np.log(np.sqrt(2 * np.pi))))


def mills(x: torch.Tensor, lx: torch.Tensor) -> torch.Tensor:
    """``r(x) = d log Phi / dx``, JAX's custom JVP of ``log_ndtr``:
    ``exp(norm_logpdf(x) - log_ndtr(x))`` (``lx`` = ``log_ndtr(x)``)."""
    return torch.exp(norm_logpdf(x) - lx)


def nll_derivs(likelihood: str, nu: float, s, y, sig, quantum, lo, hi
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(nll, nll', nll'')`` of one reading per lane, elementwise over
    matching-shape tensors (the closed forms of JAX's ``jax.grad`` and
    ``jax.jvp`` of the likelihood)."""
    if likelihood == "censored":
        hi_side = y >= hi
        arg = torch.where(hi_side, (s - hi) / sig, (lo - s) / sig)
        t = torch.where(hi_side, 1.0 / sig, -1.0 / sig)  # d arg / ds
        la = log_ndtr(arg)
        r = mills(arg, la)
        dr = (-(t * arg) - t * r) * r
        d1 = torch.where(hi_side, -(r / sig), r / sig)
        d2 = torch.where(hi_side, -(dr / sig), dr / sig)
        return -la, d1, d2
    if likelihood == "quantized":
        half = 0.5 * quantum
        b = (y + half - s) / sig
        a = (y - half - s) / sig
        flip = (a + b) > 0
        aa = torch.where(flip, -b, a)
        bb = torch.where(flip, -a, b)
        la, lb = log_ndtr(aa), log_ndtr(bb)
        ra, rb = mills(aa, la), mills(bb, lb)
        eps = _const(s, float(np.finfo(_np_dtype(s.dtype)).eps))
        raw = la - lb
        clip = torch.log1p(-eps)
        e = torch.exp(torch.minimum(raw, clip))
        one = torch.ones_like(s)
        # the min passes its first argument's derivative (JAX's
        # balanced rule: half of it on a tie)
        be = torch.where(raw < clip, one,
                         torch.where(raw == clip, 0.5 * one, 0.0 * one))
        # the gradient, in the order of JAX's reverse pass
        v1 = -e + 1.0
        ct_e = -(-one / v1)
        ct_raw = (ct_e * e) * be
        ct_lb = -one + (-ct_raw)
        ct_aa, ct_bb = ct_raw * ra, ct_lb * rb
        ct_a = torch.where(flip, -ct_bb, ct_aa)
        ct_b = torch.where(flip, -ct_aa, ct_bb)
        d1 = -(ct_a / sig) + -(ct_b / sig)
        # its derivative (forward over reverse), ds = 1
        da = -one / sig
        daa = torch.where(flip, -da, da)
        dra = (-0.5 * (daa * (2.0 * aa)) - daa * ra) * ra
        drb = (-0.5 * (daa * (2.0 * bb)) - daa * rb) * rb
        draw = daa * ra - daa * rb
        de = (draw * be) * e
        dct_e = -((de * -one) * (1.0 / (v1 * v1)))  # ct_e = -(-1 / v1)
        dct_raw = (dct_e * e + ct_e * de) * be
        dct_aa = dct_raw * ra + ct_raw * dra
        dct_bb = -dct_raw * rb + ct_lb * drb
        dct_a = torch.where(flip, -dct_bb, dct_aa)
        dct_b = torch.where(flip, -dct_aa, dct_bb)
        d2 = -(dct_a / sig) + -(dct_b / sig)
        return -(lb + torch.log1p(-e)), d1, d2
    if likelihood == "huber_t":
        k = _const(s, 0.5 * (float(nu) + 1.0))
        nu_t = _const(s, float(nu))
        u = (y - s) / sig
        q = u * u / nu_t
        q1 = q + 1.0
        # the gradient, in the order of JAX's reverse pass
        ct_q = k / q1
        ct_r2 = ct_q / nu_t
        d1 = -((ct_r2 * (2.0 * u)) / sig)
        # its derivative, ds = 1
        du = -1.0 / sig
        dq = (du * (2.0 * u)) / nu_t
        dct_q = (-dq * k) * (1.0 / (q1 * q1))
        dct_u = (dct_q / nu_t) * (2.0 * u) + ct_r2 * (2.0 * du)
        return k * torch.log1p(q), d1, -(dct_u / sig)
    raise ValueError(f"unknown robust likelihood {likelihood!r}; expected "
                     f"one of {MAP_LIKELIHOODS}")


def flag(likelihood: str, y, lo, hi) -> torch.Tensor:
    """Which readings take the MAP path (before the armed and observed
    tests): censored flags railed readings only, the others every
    reading."""
    if likelihood == "censored":
        return (y >= hi) | (y <= lo)
    return torch.ones_like(y, dtype=torch.bool)


def scalar_map_solve_plain(likelihood: str, nu: float, mu, c_safe, y, sig,
                           quantum, lo, hi, active):
    """The damped Newton solve of every lane at once (module doc): a
    capped loop that stops when every ``active`` lane is done (a done
    lane never moves, so the results are per lane).  Returns ``(s_hat,
    w, nll(s_hat), iters (int32), nonconv)``."""
    tol, nonconv_tol = solver_tols(mu.dtype)
    inv_c = 1.0 / c_safe
    sqrt_c = torch.sqrt(c_safe)
    max_step = 8.0 * sqrt_c
    s = mu
    iters = torch.zeros(mu.shape, dtype=torch.int32, device=mu.device)
    done = ~active
    for _ in range(NEWTON_ITERS):
        if bool(done.all()):
            break
        _, d1, d2 = nll_derivs(likelihood, nu, s, y, sig, quantum, lo, hi)
        gtot = (s - mu) * inv_c + d1
        h = inv_c + torch.clamp(d2, min=0.0)
        step = torch.minimum(torch.maximum(-gtot / h, -max_step), max_step)
        done = done | (gtot.abs() * sqrt_c <= tol)
        s = torch.where(done, s, s + step)
        iters = iters + (~done).to(torch.int32)
    f, d1, d2 = nll_derivs(likelihood, nu, s, y, sig, quantum, lo, hi)
    g = (s - mu) * inv_c + d1
    return (s, torch.clamp(d2, min=0.0), f, iters,
            g.abs() * sqrt_c > nonconv_tol)


def slot_scale(r, scale):
    """The slot's likelihood scale ``max(sqrt(max(r, 0)), scale)``."""
    return torch.maximum(torch.sqrt(torch.clamp(r, min=0.0)), scale)


__all__ = [
    "MAP_LIKELIHOODS",
    "NEWTON_ITERS",
    "ROBUST_LIKELIHOODS",
    "ROBUST_MAP",
    "ROBUST_NONCONV",
    "RobustParams",
    "c_floor",
    "check_likelihood",
    "flag",
    "likelihood_code",
    "log_ndtr",
    "mills",
    "nll_derivs",
    "scalar_map_solve_plain",
    "slot_scale",
    "solver_tols",
]
