"""Closed-form out-of-sample forecasting for diagonal-transition models.

Port of ``metran_tpu/ops/forecast.py``.  With ``x_{T+h} | y_{1:T} ~
N(m_h, P_h)`` and diagonal ``Phi``:

    m_h      = phi^h * m_T
    P_h[i,j] = (phi_i phi_j)^h P_T[i,j]
               + q[i,j] (1 - (phi_i phi_j)^h) / (1 - phi_i phi_j)

(the geometric term in its expm1 form, with the ``phi_i phi_j -> 1``
limit ``h q[i,j]`` guarded explicitly).  Observation forecasts are
``Z m_h`` with variances ``diag(Z P_h Z') + r``.

Every function takes one model (``phi`` (S,)) or a stacked bucket
(``phi`` (B, S)).  :func:`forecast_observation_moments` — the serving
path — is one call of the K2 wrapper
(:func:`metran_tpu_torch.kernels.forecast.forecast_moments`): the
hand-written kernel on CUDA tensors, its plain version on CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import as_tensor, float_dtype, resolve_device
from ..kernels.forecast import forecast_moments, forecast_state_moments_plain
from .statespace import StateSpace


def _prepare(ss: StateSpace, mean_last, cov_last, horizons, device):
    device = resolve_device(device, ss.phi)
    dtype = float_dtype(ss.q)
    leaves = [as_tensor(leaf, device, dtype) for leaf in ss]
    mean = as_tensor(mean_last, device, dtype)
    cov = as_tensor(cov_last, device, dtype)
    h = as_tensor(horizons, device, dtype).reshape(-1)
    single = leaves[0].dim() == 1
    if single:
        leaves = [leaf[None] for leaf in leaves]
        mean, cov = mean[None], cov[None]
    return StateSpace(*leaves), mean, cov, h, single


def forecast_state_moments(ss: StateSpace, mean_last, cov_last, horizons,
                           device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """h-step-ahead state means (..., H, S) and covariances
    (..., H, S, S) from the filtered moments at the last timestep."""
    ssb, mean, cov, h, single = _prepare(ss, mean_last, cov_last,
                                         horizons, device)
    mean_h, cov_h = forecast_state_moments_plain(ssb.phi, ssb.q, mean, cov, h)
    if single:
        return mean_h[0], cov_h[0]
    return mean_h, cov_h


def forecast_observation_moments(ss: StateSpace, mean_last, cov_last,
                                 horizons, device=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h-step-ahead observation means and variances, (..., H, N) each."""
    ssb, mean, cov, h, single = _prepare(ss, mean_last, cov_last,
                                         horizons, device)
    means, variances = forecast_moments(
        ssb.phi, ssb.q, ssb.z, ssb.r, mean, cov, h
    )
    if single:
        return means[0], variances[0]
    return means, variances


def _forecast_from_filtered(ss: StateSpace, mean_f_last, cov_f_last,
                            steps: int, device=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Observation forecasts 1..``steps`` ahead from the filtered moments
    at the last step (K2)."""
    horizons = torch.arange(1, int(steps) + 1)
    return forecast_observation_moments(ss, mean_f_last, cov_f_last,
                                        horizons, device=device)


def forecast_horizons(ss: StateSpace, mean_last, fac_last, horizons,
                      sqrt: bool = False, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predictive observation moments at an arbitrary horizon set from
    either posterior carry form (the commit-time pass of the
    materialized read path): ``fac_last`` is the filtered covariance
    (``sqrt=False``) or its Cholesky factor (``sqrt=True``, reconstituted
    here by one ``fac fac'`` — a plain matmul — ahead of K2)."""
    if sqrt:
        fac = as_tensor(fac_last, None)
        fac_last = fac @ fac.transpose(-1, -2)
    return forecast_observation_moments(ss, mean_last, fac_last, horizons,
                                        device=device)
