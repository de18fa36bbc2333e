"""Implicit-MAP updates for non-Gaussian observation models: the robust
serving update.

Port of ``metran_tpu/ops/implicit_map.py``.  Every supported likelihood
depends on the state only through a slot's predicted observation ``s =
z_i' x``, so conditioning ``N(m, P)`` on one slot reduces exactly to a
scalar problem with prior ``s ~ N(mu, c)``; a *flagged* slot (armed,
observed and, for ``"censored"``, at or beyond a rail) solves it by
damped Newton and commits its Laplace summary, while every other slot
takes the closed-form Gaussian update bit for bit
(:mod:`metran_tpu_torch.kernels.implicit_map` has the scalar solve and
the likelihoods).

- :func:`implicit_map_filter_append`: the sequential engine, one launch
  of K12's robust instantiation (``csrc/gated_filter.cu``): per flagged
  slot ``m += d (s_hat - mu) / c``, ``P -= (d d') w / (1 + c w)`` with
  ``d = P z_i`` and ``mu = y - v``;
- :func:`implicit_map_sqrt_filter_append`: the square-root engine, one
  launch of K9's robust instantiation (``csrc/sqrt_filter.cu``): the
  solves run off the predicted factor's marginals and each flagged slot
  enters the same QR update as the pseudo-observation ``r_eff = 1/w``,
  ``v_eff = (c + r_eff)(s_hat - mu)/c`` — PSD by construction.

Both take one model or a batch (leaves and carry leading with B, rows
(B, k, N)), ``armed`` as a bool or one per model, and the per-slot
parameters ``rail_lo``, ``rail_hi``, ``quantum``, ``scale`` as scalars,
(N,) or (B, N) in standardized units (defaults: no rails, ``quantum``
1, ``scale`` 0.05).  ``likelihood="gaussian"`` is the plain update from
the given carry (K12 ``off`` or K9), with NaN z-scores and zero
verdicts and iterations, as the JAX functions return it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import as_tensor
from ..kernels.gated_filter import (
    gated_filter_append as _gated_kernel,
    robust_filter_append,
)
from ..kernels.implicit_map import (
    NEWTON_ITERS,
    ROBUST_LIKELIHOODS,
    ROBUST_MAP,
    ROBUST_NONCONV,
    check_likelihood,
)
from ..kernels.sqrt_filter import sqrt_filter, sqrt_filter_robust
from .kalman import _append_args, _armed, _lanes_ss
from .statespace import StateSpace

#: the defaults of the per-slot parameters (the JAX ``_default_params``)
_DEFAULTS = (float("-inf"), float("inf"), 1.0, 0.05)


def _params(rail_lo, rail_hi, quantum, scale, like: torch.Tensor):
    """The four per-slot parameters as (B, N) tensors of ``like``'s
    (the rows') dtype and device; None takes the default."""
    b, _, n = like.shape
    out = []
    for value, default in zip((rail_lo, rail_hi, quantum, scale), _DEFAULTS):
        t = as_tensor(default if value is None else value, like.device,
                      like.dtype)
        out.append(torch.broadcast_to(t, (b, n)).contiguous())
    return out


def _plain_extras(y_new: torch.Tensor):
    """NaN z-scores, zero verdicts and zero iterations of the rows."""
    return (torch.full(y_new.shape, float("nan"), dtype=y_new.dtype,
                       device=y_new.device),
            torch.zeros(y_new.shape, dtype=torch.int8, device=y_new.device),
            torch.zeros(y_new.shape, dtype=torch.int32, device=y_new.device))


def implicit_map_filter_append(ss: StateSpace, mean, cov, y_new, mask_new,
                               armed=True, rail_lo=None, rail_hi=None,
                               quantum=None, scale=None,
                               likelihood: str = "censored", nu: float = 4.0,
                               device=None) -> Tuple[torch.Tensor, ...]:
    """:func:`~metran_tpu_torch.ops.filter_append` (sequential engine)
    with per-slot implicit-MAP conditioning under a non-Gaussian
    observation likelihood: one launch of K12's robust instantiation.

    Returns ``(mean_T, cov_T, sigma, detf, zscore, verdict, iters)``:
    the first four as :func:`~metran_tpu_torch.ops.filter_append`, then
    the per-step (k, N) (or (B, k, N)) signed z-scores (NaN where
    unobserved), int8 verdicts (0, :data:`ROBUST_MAP`,
    :data:`ROBUST_NONCONV`) and int32 Newton iterations (0 where nothing
    flagged).

    Contract: with ``likelihood="gaussian"``, ``armed=False`` or no
    flagged slot (censored, no railed reading), the posterior and the
    likelihood terms are bit-identical to ``filter_append(...,
    engine="sequential")``.
    """
    check_likelihood(likelihood)
    ss_b, mean, cov, y_new, mask_new, single = _append_args(
        ss, mean, cov, y_new, mask_new, device)
    if likelihood == "gaussian":
        out = _gated_kernel(ss_b.phi, ss_b.q, ss_b.z, ss_b.r, mean, cov,
                            y_new, mask_new,
                            _armed(False, mean.shape[0], mean.device),
                            "off")[:4] + _plain_extras(y_new)
    else:
        out = robust_filter_append(
            ss_b.phi, ss_b.q, ss_b.z, ss_b.r, mean, cov, y_new, mask_new,
            _armed(armed, mean.shape[0], mean.device),
            *_params(rail_lo, rail_hi, quantum, scale, y_new),
            likelihood, float(nu))
    if single:
        out = tuple(o[0] for o in out)
    return out


def implicit_map_sqrt_filter_append(ss: StateSpace, mean, chol, y_new,
                                    mask_new, armed=True, rail_lo=None,
                                    rail_hi=None, quantum=None, scale=None,
                                    likelihood: str = "censored",
                                    nu: float = 4.0, device=None
                                    ) -> Tuple[torch.Tensor, ...]:
    """:func:`~metran_tpu_torch.ops.sqrt_filter_append` with per-slot
    implicit-MAP conditioning: one launch of K9's robust instantiation
    from the given carry (``chol`` any factor of the covariance).

    Decisions come off the predicted factor's marginals, each flagged
    slot's Laplace summary becomes a Gaussian pseudo-observation, and
    the same QR update runs, so the returned factor is PSD by
    construction.  Same outputs and the same bit-exact fallback as
    :func:`implicit_map_filter_append`, against
    :func:`~metran_tpu_torch.ops.sqrt_filter_append`.
    """
    check_likelihood(likelihood)
    ss_b, mean, chol, y_new, mask_new, single = _append_args(
        ss, mean, chol, y_new, mask_new, device)
    phi, q, z, r = _lanes_ss(ss_b, "sqrt")
    y_new, mask_new = y_new.contiguous(), mask_new.contiguous()
    if likelihood == "gaussian":
        out = sqrt_filter(phi, q, z, r, y_new, mask_new,
                          mean0=mean.contiguous(), chol0=chol.contiguous()
                          ) + _plain_extras(y_new)
    else:
        out = sqrt_filter_robust(
            phi, q, z, r, y_new, mask_new, mean.contiguous(),
            chol.contiguous(), _armed(armed, mean.shape[0], mean.device),
            *_params(rail_lo, rail_hi, quantum, scale, y_new), likelihood,
            float(nu))
    if single:
        out = tuple(o[0] for o in out)
    return out


__all__ = [
    "NEWTON_ITERS",
    "ROBUST_LIKELIHOODS",
    "ROBUST_MAP",
    "ROBUST_NONCONV",
    "implicit_map_filter_append",
    "implicit_map_sqrt_filter_append",
]
