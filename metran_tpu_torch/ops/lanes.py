"""Lane-layout Kalman deviance: the fleet fit's objective and gradient.

Port of ``metran_tpu/ops/lanes.py``.  Parameters keep the JAX layout,
fleet axis LAST (``alpha`` (N+K, B), ``loadings`` (N, K, B), ``dt`` (B,),
``y``/``mask`` (T, N, B) at the public functions).  The filter itself is
kernel K3 and the closed-form gradient kernel K4
(:mod:`metran_tpu_torch.kernels.lanes`), which read the observations in
their own layout, (B, T, N): :class:`LanesData` holds them so, prepared
once per fit (:func:`prepare_data`), not once per launch.

The score paths:

- ``score="adjoint"`` (default): the value is one K3 launch; under
  differentiation the forward keeps the segment boundaries and the
  backward is one K4 launch giving ``(phibar, qbar)``.  Loadings and
  observations are fixed data (their cotangents are exactly zero); the
  ``alpha -> (phi, q)`` chain is plain torch autograd.
- ``score="autodiff"``: torch autograd through the plain filter, on CPU
  tensors only (no plain version runs on the card's path).

The lanes path has no ``_finite_or_inf``: a non-finite value reaches
the optimizer, which keeps the lane's previous iterate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import as_tensor, float_dtype, resolve_device
from ..kernels.lanes import (
    lanes_adjoint,
    lanes_filter,
    lanes_filter_plain,
    segment,
)

LOG2PI = 1.8378770664093453  # log(2*pi)

#: the JAX package's padding of time into segments (the plain version's)
_segment = segment


def lanes_statespace(alpha, loadings, dt):
    """DFM state-space matrices in lane layout: ``(phi (n, B), q (n, B),
    z (N, n, B), r (N, B))``.

    Same math as :func:`metran_tpu_torch.ops.dfm_statespace` (diagonal
    transition ``phi = exp(-dt/alpha)``, diagonal process noise with the
    ``expm1`` form and the communality scaling on the specific states,
    ``Z = [I | loadings]``, ``r = 0``), fleet axis last.
    """
    n, _, b = loadings.shape
    dtype = loadings.dtype
    phi = torch.exp(-dt[None, :] / alpha)
    comm = torch.sum(loadings**2, dim=1)  # (N, B)
    decay2 = -torch.expm1(-2.0 * dt[None, :] / alpha)  # 1 - phi^2, stable
    q = torch.cat([decay2[:n] * (1.0 - comm), decay2[n:]], dim=0)
    eye = torch.eye(n, dtype=dtype, device=loadings.device)[:, :, None]
    z = torch.cat([eye.expand(n, n, b), loadings], dim=1)
    r = torch.zeros((n, b), dtype=dtype, device=loadings.device)
    return phi, q, z, r


class LanesData(NamedTuple):
    """Observations in the kernels' layout, prepared once per fit."""

    y: torch.Tensor  # (D, T, N)
    mask: torch.Tensor  # (D, T, N) bool
    count: torch.Tensor  # (T, D) observed slots per step


def prepare_data(y, mask) -> LanesData:
    """:class:`LanesData` from batch-leading ``y``/``mask`` (B, T, N) —
    a fleet's own layout."""
    y = y.contiguous()
    mask = mask.to(torch.bool).contiguous()
    return LanesData(y, mask, mask.sum(dim=2).T)


def lanes_deviance_terms(sigma, detf, mask, warmup: int = 1):
    """Combine (T, B) filter terms into per-lane deviances.

    Same semantics as :func:`metran_tpu_torch.ops.kalman.deviance_terms`
    (reference ``SPKalmanFilter.get_mle``): sigma/detf sums skip the
    first ``warmup`` *observed* timesteps; nobs skips the first
    ``warmup`` *grid* timesteps.  ``mask`` is (T, N, B).
    """
    return _deviance_from_counts(sigma, detf, mask.sum(dim=1), warmup)


def _deviance_from_counts(sigma, detf, count, warmup: int):
    dtype = sigma.dtype
    has_obs = count > 0
    obs_rank = torch.cumsum(has_obs, dim=0) - 1
    keep = has_obs & (obs_rank >= warmup)
    steps = torch.arange(count.shape[0], device=count.device)[:, None]
    nobs = torch.sum(torch.where(steps >= warmup, count, 0), dim=0)
    log2pi = torch.tensor(LOG2PI, dtype=dtype, device=sigma.device)
    return (nobs.to(dtype) * log2pi
            + torch.sum(torch.where(keep, detf, 0.0), dim=0)
            + torch.sum(torch.where(keep, sigma, 0.0), dim=0))


class _TermsAdjoint(torch.autograd.Function):
    """(sigma, detf) of K3 with K4 as the backward: cotangents for
    ``(phi, q)`` only; z, r and the data are fixed."""

    @staticmethod
    def forward(ctx, phi, q, z, r, y, mask, lane_map, seg):
        res = lanes_filter(phi, q, z, r, y, mask, lane_map, seg,
                           keep_bounds=True)
        ctx.seg = seg
        ctx.save_for_backward(phi, q, z, r, y, mask, lane_map,
                              res.bounds_mean, res.bounds_cov)
        return res.sigma, res.detf

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, sb, db):
        phi, q, z, r, y, mask, lane_map, bm, bc = ctx.saved_tensors
        phibar, qbar = lanes_adjoint(phi, q, z, r, y, mask, lane_map,
                                     ctx.seg, bm, bc, sb, db)
        return phibar, qbar, None, None, None, None, None, None


def lanes_terms(phi, q, z, r, data: LanesData, lane_map, seg: int,
                score: str = "adjoint"):
    """Per-step ``(sigma, detf)``, each (T, L), of lanes reading
    ``data`` through ``lane_map`` (None: lane l reads data lane l)."""
    if score == "adjoint":
        needs_grad = torch.is_grad_enabled() and (
            phi.requires_grad or q.requires_grad)
        if needs_grad:
            return _TermsAdjoint.apply(phi, q, z.detach(), r.detach(),
                                       data.y.detach(), data.mask, lane_map,
                                       seg)
        res = lanes_filter(phi, q, z, r, data.y, data.mask, lane_map, seg)
        return res.sigma, res.detf
    if score == "autodiff":
        if phi.device.type != "cpu":
            raise RuntimeError(
                "score='autodiff' differentiates the plain PyTorch filter, "
                "which runs on CPU tensors only; on the card use "
                "score='adjoint' (kernels K3/K4)")
        res = lanes_filter_plain(phi, q, z, r, data.y, data.mask, lane_map,
                                 seg)
        return res.sigma, res.detf
    raise ValueError(
        f"unknown score {score!r}; expected 'adjoint' or 'autodiff'")


def lanes_deviance(alpha, loadings, dt, data: LanesData, lane_map=None,
                   warmup: int = 1, remat_seg: Optional[int] = 100,
                   score: str = "adjoint"):
    """(L,) deviance of lanes at ``alpha`` over prepared ``data``; lane l
    reads data lane ``lane_map[l]`` (default l).  The fleet fit's
    objective: K trial points are one call over K*B lanes."""
    if score == "adjoint":
        loadings = loadings.detach()
    phi, q, z, r = lanes_statespace(alpha, loadings, dt)
    seg = remat_seg or data.y.shape[1]
    sigma, detf = lanes_terms(phi, q, z, r, data, lane_map, seg, score)
    count = data.count if lane_map is None else data.count[:, lane_map.long()]
    return _deviance_from_counts(sigma, detf, count, warmup)


def lanes_dfm_deviance(alpha, loadings, dt, y, mask, warmup: int = 1,
                       remat_seg: Optional[int] = 100,
                       score: str = "adjoint", device=None):
    """(B,) deviance of a fleet at ``alpha``: the lanes hot path.

    Step for step the sequential-processing engine
    (``engine="sequential"`` of :func:`metran_tpu_torch.ops.deviance`),
    in the JAX layout: ``alpha`` (N+K, B), ``loadings`` (N, K, B),
    ``dt`` (B,), ``y``/``mask`` (T, N, B).  ``score`` picks the gradient
    path (module doc).  Inputs that are not tensors go to ``device``
    (default: the CUDA card; without one this raises).
    """
    device = resolve_device(device, alpha)
    dtype = float_dtype(alpha, loadings, dtype=None)
    alpha = as_tensor(alpha, device, dtype)
    loadings = as_tensor(loadings, device, dtype)
    dt = as_tensor(dt, device, dtype)
    y = as_tensor(y, device, dtype)
    mask = as_tensor(mask, device, torch.bool)
    data = prepare_data(y.permute(2, 0, 1), mask.permute(2, 0, 1))
    return lanes_deviance(alpha, loadings, dt, data, None, warmup,
                          remat_seg, score)


__all__ = [
    "LanesData",
    "lanes_deviance",
    "lanes_deviance_terms",
    "lanes_dfm_deviance",
    "lanes_statespace",
    "lanes_terms",
    "prepare_data",
]
