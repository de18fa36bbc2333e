"""Lane-layout post-fit products: smoother, projections, innovations,
forecasts and path draws.

Port of ``metran_tpu/ops/lanes_products.py``.  The public functions keep
the JAX signatures and layouts, fleet axis LAST:

    phi, q   (n, B)     diagonal transition / process noise
    z        (N, n, B)  observation rows
    r        (N, B)     measurement noise
    y, mask  (T, N, B)  observations / observed flags

and return (T, ., B) arrays.  Inside, the kernels read the data in their
own layout, (B, T, N), and emit lane-major outputs; the ``_*_lanes``
helpers take and return that layout, which is the fleet's own, so the
fleet wrappers (:mod:`metran_tpu_torch.parallel.fleet`) move nothing of
size T.

- **Smoother** (:func:`lanes_smooth`): the Durbin-Koopman univariate
  backward recursion on the adjoints ``(r_t, N_t)``: K3 with its segment
  boundaries, then K5 replaying one segment at a time (memory
  O(seg * N * n * B) instead of O(T * n^2 * B)).
- **Filtered projections and innovations**: K6 in its ``project`` and
  ``innovations`` modes; the innovations are the joint (vector)
  definition from the predicted moments, standardized and NaN-masked
  here.
- **Forecasts**: K6 latches each lane's filtered moments at its own
  ``t_last``; the closed-form horizon moments are K2
  (:func:`metran_tpu_torch.kernels.forecast.forecast_moments`), the
  same ``expm1``-guarded geometric form with the lanes' diagonal ``q``.
- **Path draws** (:func:`lanes_sample`): one mean-only smoothing of the
  data, the AR path draw and its pseudo-observations over one lane per
  (draw, model) (K7), one mean-only smoothing of the pseudo-observations,
  then ``draws = E[x|y] + x - E[x|y*]``.

Inputs that are not tensors go to ``device`` (default: the CUDA card;
without one this raises); tensors stay where they are, and CPU tensors
run the kernels' plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import as_tensor, float_dtype, resolve_device
from ..kernels import lanes_products as kp
from ..kernels.forecast import forecast_moments
from ..kernels.lanes import lanes_filter


def _inputs(phi, q, z, r, y, mask, device):
    """The lane constants and the data in the kernels' layout: ``(phi,
    q, z, r, y (B, T, N), mask (B, T, N) bool)`` on one device."""
    device = resolve_device(device, phi)
    dtype = float_dtype(phi, q, z, dtype=None)
    phi, q, z, r = (as_tensor(a, device, dtype) for a in (phi, q, z, r))
    y = as_tensor(y, device, dtype).permute(2, 0, 1).contiguous()
    mask = as_tensor(mask, device, torch.bool).permute(2, 0, 1).contiguous()
    return phi, q, z, r, y, mask


def _to_jax_layout(a):
    """(B, T, x) -> (T, x, B)."""
    return a.permute(1, 2, 0)


# ----------------------------------------------------------------------
# the kernels' layout: data and outputs (B, T, .)
# ----------------------------------------------------------------------
def _smooth_lanes(phi, q, z, r, y, mask, seg: int, want_cov: bool,
                  lane_map=None):
    """``(mean_s (L, T, n), proj_mean (L, T, N), proj_var (L, T, N))``:
    K3 with segment boundaries, then K5."""
    fwd = lanes_filter(phi, q, z, r, y, mask, lane_map, seg,
                       keep_bounds=True)
    return kp.lanes_smooth_bwd(phi, q, z, r, y, mask, lane_map, seg,
                               fwd.bounds_mean, fwd.bounds_cov, want_cov)


def _innovations_lanes(phi, q, z, r, y, mask, standardized: bool,
                       warmup: int):
    """``(v, f)``, each (B, T, N): K6's joint innovations, standardized
    by ``sqrt(max(f, tiny))`` when asked, NaN where unobserved or before
    ``warmup``."""
    v, f = kp.lanes_forward(phi, q, z, r, y, mask, "innovations")
    if standardized:
        tiny = torch.finfo(v.dtype).tiny
        v = v / torch.sqrt(torch.clamp(f, min=tiny))
    steps = torch.arange(y.shape[1], device=y.device)[None, :, None]
    keep = mask & (steps >= int(warmup))
    return torch.where(keep, v, torch.nan), torch.where(keep, f, torch.nan)


def _forecast_lanes(phi, q, z, r, y, mask, t_last, steps: int):
    """``(means, variances)``, each (B, steps, N): K6's latch at each
    lane's ``t_last``, then K2's closed-form horizon moments."""
    t_last = torch.as_tensor(t_last, device=phi.device).to(torch.int32)
    mean, cov = kp.lanes_forward(phi, q, z, r, y, mask, "latch",
                                 t_last=t_last)
    horizons = torch.arange(1, int(steps) + 1, device=phi.device).to(
        phi.dtype)
    return forecast_moments(phi.T.contiguous(), torch.diag_embed(q.T),
                            z.permute(2, 0, 1).contiguous(),
                            r.T.contiguous(), mean, cov, horizons)


def _sample_lanes(phi, q, z, r, y, mask, x0, w, e, seg: int,
                  project: bool):
    """Path draws ``(D, B, T, .)`` from the normals of ``D * B`` lanes,
    lane ``d * B + model``: ``x0`` (D*B, n), ``w`` (D*B, T, n), ``e``
    (D*B, T, N), each standard normal."""
    b = phi.shape[1]
    n_draws = x0.shape[0] // b
    sm_data, _, _ = _smooth_lanes(phi, q, z, r, y, mask, seg, False)

    def rep(a):  # lane-last constants, lane = d * B + model
        return a.repeat(*([1] * (a.dim() - 1)), n_draws)

    phi_l, q_l, z_l, r_l = rep(phi), rep(q), rep(z), rep(r)
    xs, y_star = kp.lanes_sample(phi_l, q_l, z_l, r_l, x0, w, e)
    sm_star, _, _ = _smooth_lanes(phi_l, q_l, z_l, r_l, y_star,
                                  mask.repeat(n_draws, 1, 1), seg, False)
    draws = sm_data.repeat(n_draws, 1, 1) + xs - sm_star  # (D*B, T, n)
    if project:
        draws = torch.einsum("iaL,LTa->LTi", z_l, draws)
    return draws.reshape(n_draws, b, *draws.shape[1:])


def sample_normals(n_draws: int, batch: int, t_steps: int, n_state: int,
                   n_obs: int, generator: torch.Generator, dtype,
                   device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The standard normals of ``n_draws`` path draws for each of
    ``batch`` models, model-major: ``x0`` (B, D, n), ``w`` (B, D, T, n),
    ``e`` (B, D, T, N), drawn in that order from ``generator``.  Model
    ``b``'s numbers depend on the generator's seed, ``b`` and the
    shapes only."""
    new = dict(generator=generator, dtype=dtype, device=device)
    x0 = torch.randn((batch, n_draws, n_state), **new)
    w = torch.randn((batch, n_draws, t_steps, n_state), **new)
    e = torch.randn((batch, n_draws, t_steps, n_obs), **new)
    return x0, w, e


def draw_major(a):
    """Model-major normals (B, D, ...) -> lanes (D*B, ...), lane
    ``d * B + model``."""
    return a.transpose(0, 1).reshape(-1, *a.shape[2:]).contiguous()


# ----------------------------------------------------------------------
# the JAX package's functions
# ----------------------------------------------------------------------
def lanes_smooth(phi, q, z, r, y, mask, seg: int = 100,
                 want_cov: bool = True, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Smoothed states and observation-space projections, lane layout:
    ``(mean_s, proj_mean, proj_var)`` of shapes (T, n, B), (T, N, B),
    (T, N, B).  With ``want_cov=False`` the N recursion is skipped and
    ``proj_var`` is zeros (decompose, the simulation smoother)."""
    args = _inputs(phi, q, z, r, y, mask, device)
    return tuple(_to_jax_layout(a)
                 for a in _smooth_lanes(*args, seg, want_cov))


def lanes_filter_project(phi, q, z, r, y, mask, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Filtered states and observation-space projections, lane layout:
    ``(mean_f, proj_mean, proj_var)``, the ``smooth=False`` analog of
    :func:`lanes_smooth` (K6, forward only)."""
    args = _inputs(phi, q, z, r, y, mask, device)
    return tuple(_to_jax_layout(a)
                 for a in kp.lanes_forward(*args, "project"))


def lanes_innovations(phi, q, z, r, y, mask, standardized: bool = True,
                      warmup: int = 0, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-step-ahead joint innovations ``(v, f)`` in lane layout,
    (T, N, B) each: ``v = y - Z m_p``, ``f = max(diag(Z P_p Z'), 0) +
    r`` from the predicted moments, NaN where unobserved or before
    ``warmup``."""
    args = _inputs(phi, q, z, r, y, mask, device)
    return tuple(_to_jax_layout(a) for a in _innovations_lanes(
        *args, bool(standardized), warmup))


def lanes_forecast(phi, q, z, r, y, mask, t_last, steps: int, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Out-of-sample observation forecasts ``(means, variances)`` of
    shape (steps, N, B), each lane from its filtered moments at its own
    ``t_last`` (B,)."""
    args = _inputs(phi, q, z, r, y, mask, device)
    means, variances = _forecast_lanes(*args, t_last, steps)
    return means.permute(1, 2, 0), variances.permute(1, 2, 0)


def _lanes_sample_given(phi, q, z, r, y, mask, x0, w, e, seg: int = 100,
                        project: bool = True, device=None) -> torch.Tensor:
    """:func:`lanes_sample` from given standard normals in the JAX
    package's layout, lane ``d * B + model`` last: ``x0`` (n, D*B),
    ``w`` (T, n, D*B), ``e`` (T, N, D*B).  Returns (D, T, N or n, B)."""
    phi, q, z, r, y, mask = _inputs(phi, q, z, r, y, mask, device)
    x0, w, e = (as_tensor(a, phi.device, phi.dtype) for a in (x0, w, e))
    draws = _sample_lanes(phi, q, z, r, y, mask, x0.T.contiguous(),
                          w.permute(2, 0, 1).contiguous(),
                          e.permute(2, 0, 1).contiguous(), seg, project)
    return draws.permute(0, 2, 3, 1)


def lanes_sample(phi, q, z, r, y, mask,
                 generator: Optional[torch.Generator] = None,
                 n_draws: int = 16, seg: int = 100, project: bool = True,
                 device=None) -> torch.Tensor:
    """Durbin-Koopman simulation smoother with one lane per (model,
    draw): (n_draws, T, N, B) observation-space draws when ``project``
    (passing exactly through each model's observed entries when r = 0)
    or (n_draws, T, n, B) state draws.  The normals come from
    ``generator`` (default: a fresh one seeded 0 on the inputs' device),
    model-major (:func:`sample_normals`); draw-for-draw equality with the
    JAX package's ``keys`` is not a contract, the distribution is."""
    phi, q, z, r, y, mask = _inputs(phi, q, z, r, y, mask, device)
    if generator is None:
        generator = torch.Generator(phi.device).manual_seed(0)
    x0, w, e = sample_normals(int(n_draws), phi.shape[1], y.shape[1],
                              phi.shape[0], z.shape[0], generator,
                              phi.dtype, phi.device)
    draws = _sample_lanes(phi, q, z, r, y, mask, draw_major(x0),
                          draw_major(w), draw_major(e), seg, project)
    return draws.permute(0, 2, 3, 1)


__all__ = [
    "lanes_filter_project",
    "lanes_forecast",
    "lanes_innovations",
    "lanes_sample",
    "lanes_smooth",
    "sample_normals",
]
