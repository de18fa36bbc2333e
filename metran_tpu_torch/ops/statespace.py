"""State-space construction for the Metran dynamic factor model (DFM).

The DFM decomposes ``n`` standardized observed series into ``n``
specific AR(1) factors and ``k`` common AR(1) factors:

    x_t = Phi x_{t-1} + w_t,   w_t ~ N(0, Q)
    y_t = Z x_t + v_t,         v_t ~ N(0, diag(r))

with diagonal ``Phi`` (``phi_i = exp(-dt / alpha_i)``), diagonal ``Q``
(``q_sdf = (1 - phi^2) (1 - communality)``, ``q_cdf = 1 - phi^2``),
``Z = [I_n | Gamma]`` and ``r = 0``.

Port of ``metran_tpu/ops/statespace.py``.  :func:`dfm_statespace` is
batched over any leading axes (a whole shape bucket in one call), which
replaces the JAX serving engine's ``vmap`` over the single-model build.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import as_tensor, float_dtype, resolve_device


class StateSpace(NamedTuple):
    """Matrices of a (diagonal-transition) linear-Gaussian model.

    Leaves may carry leading batch axes (a stacked bucket).

    Attributes
    ----------
    phi : (..., n_state) diagonal of the transition matrix.
    q : (..., n_state, n_state) transition covariance.
    z : (..., n_obs, n_state) observation matrix.
    r : (..., n_obs) diagonal observation noise variance.
    """

    phi: torch.Tensor
    q: torch.Tensor
    z: torch.Tensor
    r: torch.Tensor

    @property
    def n_state(self) -> int:
        return self.phi.shape[-1]

    @property
    def n_obs(self) -> int:
        return self.z.shape[-2]


def ar1_decay(alpha: torch.Tensor, dt) -> torch.Tensor:
    """AR(1) decay ``phi = exp(-dt / alpha)`` for time step ``dt`` (days)."""
    return torch.exp(-dt / alpha)


def dfm_statespace(alpha_sdf, alpha_cdf, loadings, dt=1.0, device=None,
                   dtype=None) -> StateSpace:
    """Build the DFM state-space matrices from parameters.

    Parameters
    ----------
    alpha_sdf : (..., n_series) AR decay parameter per specific factor.
    alpha_cdf : (..., n_factors) AR decay parameter per common factor.
    loadings : (..., n_series, n_factors) factor loadings.
    dt : time step in days, a scalar or one per leading index.
    device : where the matrices live (default: the device of a tensor
        argument, else :func:`~metran_tpu_torch.config.default_device`).
    dtype : working precision (default: float32 when every floating
        input is float32, float64 otherwise).

    Returns
    -------
    StateSpace with state ordering ``[sdf_0..sdf_{n-1}, cdf_0..cdf_{k-1}]``.
    """
    like = next(
        (a for a in (alpha_sdf, alpha_cdf, loadings)
         if isinstance(a, torch.Tensor)),
        None,
    )
    device = resolve_device(device, like)
    dtype = float_dtype(alpha_sdf, alpha_cdf, loadings, dtype=dtype)
    alpha_sdf = as_tensor(alpha_sdf, device, dtype)
    alpha_cdf = as_tensor(alpha_cdf, device, dtype)
    loadings = as_tensor(loadings, device, dtype)
    if loadings.dim() == 1:
        loadings = loadings[:, None]
    dt = as_tensor(dt, device, dtype)
    if dt.dim() > 0:
        dt = dt[..., None]  # one step per leading index
    n_series = loadings.shape[-2]

    phi = torch.cat(
        [ar1_decay(alpha_sdf, dt), ar1_decay(alpha_cdf, dt)], dim=-1
    )
    communality = torch.sum(loadings * loadings, dim=-1)
    # 1 - phi^2 = -expm1(-2 dt / alpha): the expm1 form avoids the
    # cancellation of literal ``1 - phi**2`` as phi -> 1 (near-unit-root
    # alpha ~ 3e4 loses ~4 digits in float32 otherwise)
    q_sdf = -torch.expm1(-2.0 * dt / alpha_sdf) * (1.0 - communality)
    q_cdf = -torch.expm1(-2.0 * dt / alpha_cdf)
    q = torch.diag_embed(torch.cat([q_sdf, q_cdf], dim=-1))

    batch = loadings.shape[:-2]
    eye = torch.eye(n_series, dtype=dtype, device=device).expand(
        *batch, n_series, n_series
    )
    z = torch.cat([eye, loadings], dim=-1)
    r = torch.zeros(*batch, n_series, dtype=dtype, device=device)
    return StateSpace(phi=phi, q=q, z=z, r=r)


def scale_observation_matrix(z: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    """Scale the observation matrix by per-series standard deviations,
    so projected states land in the unstandardized data units."""
    return z * scale[..., :, None]
