"""K2 wrapper: batched closed-form forecast moments, kernel or plain.

:func:`forecast_moments` gives each of ``B`` models' h-step-ahead
observation means and variances at ``H`` horizons.  On CUDA tensors it
launches the hand-written kernel (``csrc/forecast.cu``) and raises if
that cannot build or launch; on CPU tensors it runs
:func:`forecast_moments_plain`, the same computation in batched PyTorch
ops — the oracle the kernel is held against on the card.

Replaces ``metran_tpu/ops/forecast.py::forecast_observation_moments``
(with ``forecast_state_moments`` and ``ops/kalman.py::project``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build


def _check(phi, q, z, r, mean, cov, horizons):
    dtype = phi.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"forecast takes float32/float64, got {dtype}")
    if phi.dim() != 2:
        raise ValueError(f"phi must be (B, S), got {tuple(phi.shape)}")
    b, s = phi.shape
    if z.dim() != 3 or z.shape[0] != b or z.shape[2] != s:
        raise ValueError(f"z must be (B, N, S), got {tuple(z.shape)}")
    n = z.shape[1]
    if horizons.dim() != 1:
        raise ValueError(
            f"horizons must be (H,), got {tuple(horizons.shape)}"
        )
    want = {
        "q": (q, (b, s, s)), "r": (r, (b, n)), "mean": (mean, (b, s)),
        "cov": (cov, (b, s, s)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {shape}, got {tuple(t.shape)}"
            )
    for name, t in (("phi", phi), ("q", q), ("z", z), ("r", r),
                    ("mean", mean), ("cov", cov), ("horizons", horizons)):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, phi is {dtype}")
    devices = {t.device for t in (phi, q, z, r, mean, cov, horizons)}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    return b, horizons.shape[0], n, s


def forecast_moments(phi, q, z, r, mean, cov, horizons
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Observation means and variances ``(B, H, N)`` each.

    Shapes: phi (B, S), q (B, S, S), z (B, N, S), r (B, N), mean (B, S),
    cov (B, S, S), horizons (H,) in the working dtype.
    """
    _check(phi, q, z, r, mean, cov, horizons)
    if phi.device.type == "cpu":
        return forecast_moments_plain(phi, q, z, r, mean, cov, horizons)
    return forecast_moments_kernel(phi, q, z, r, mean, cov, horizons)


def forecast_moments_kernel(phi, q, z, r, mean, cov, horizons
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (CUDA tensors only; raises otherwise, and
    when the kernel cannot build or launch)."""
    b, h, n, s = _check(phi, q, z, r, mean, cov, horizons)
    if phi.device.type != "cuda":
        raise ValueError(
            f"the forecast kernel runs on CUDA tensors, got {phi.device}"
        )
    args = [t.contiguous() for t in (phi, q, z, r, mean, cov, horizons)]
    # the two halves of one buffer: a caller brings both to the host in
    # one copy (the read path's commit-time pass)
    means, variances = torch.empty((2, b, h, n), dtype=phi.dtype,
                                   device=phi.device)
    lib = build.load_library("forecast")
    fn = (lib.metran_forecast_moments_f64 if phi.dtype == torch.float64
          else lib.metran_forecast_moments_f32)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = fn(*[t.data_ptr() for t in args], means.data_ptr(),
                 variances.data_ptr(), b, h, n, s, stream)
    build.check(lib, err, "forecast_moments")
    if b and h:
        build.count_launch("forecast_moments")
    return means, variances


def forecast_state_moments_plain(phi, q, mean, cov, horizons
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h-step state means (B, H, S) and covariances (B, H, S, S).

    The expm1 form of ``(1 - pp^h) / (1 - pp)`` with the ``pp == 1``
    limit ``h``, exactly as ``metran_tpu/ops/forecast.py`` writes it.
    """
    h = horizons[:, None]  # (H, 1)
    mean_h = phi[:, None, :] ** h[None] * mean[:, None, :]
    pp = phi[:, :, None] * phi[:, None, :]  # (B, S, S)
    hb = h[None, :, :, None]  # (1, H, 1, 1)
    log_pp = torch.log(pp)[:, None]  # (B, 1, S, S)
    pp_h = torch.exp(hb * log_pp)
    denom = torch.expm1(log_pp)
    at_one = denom == 0
    geom = torch.where(
        at_one,
        hb * torch.ones_like(log_pp),
        torch.expm1(hb * log_pp)
        / torch.where(at_one, torch.ones_like(denom), denom),
    )
    cov_h = pp_h * cov[:, None] + geom * q[:, None]
    return mean_h, cov_h


def horizon_set(horizons, like) -> Optional[torch.Tensor]:
    """A horizon set as a non-empty (H,) tensor of ``like``'s dtype and
    device (``None`` stays ``None``: a horizons mode off).  Horizons are
    values: any set, not only ``1..H``."""
    if horizons is None:
        return None
    h = torch.as_tensor(horizons, dtype=like.dtype, device=like.device)
    if h.dim() != 1 or h.shape[0] == 0:
        raise ValueError(f"horizons must be a non-empty (H,) set, got "
                         f"{tuple(h.shape)}")
    return h.contiguous()


def _project_means(mean_h, z) -> torch.Tensor:
    """``Z m_h`` (B, H, N) of state means (B, H, S) as an elementwise
    product summed over the states: a reduction of each (horizon, slot)
    on its own, so a horizon's row does not depend on how many horizons
    ride along (a matmul's blocking does), and the read path's
    commit-time rows equal a compute-path call's bit for bit."""
    return torch.sum(mean_h[:, :, None, :] * z[:, None], dim=-1)


def forecast_means_plain(phi, z, mean, horizons) -> torch.Tensor:
    """The mean half alone, ``Z (phi^h o m)`` (B, H, N): the same
    operations as :func:`forecast_moments_plain`'s means (the frozen
    rows' commit-time pass, whose variances are cached at freeze)."""
    mean_h = phi[:, None, :] ** horizons[None, :, None] * mean[:, None, :]
    return _project_means(mean_h, z)


def forecast_moments_plain(phi, q, z, r, mean, cov, horizons
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as :func:`forecast_moments` in PyTorch ops."""
    mean_h, cov_h = forecast_state_moments_plain(phi, q, mean, cov, horizons)
    means = _project_means(mean_h, z)  # (B, H, N)
    zp = z[:, None] @ cov_h  # (B, H, N, S)
    variances = torch.sum(zp * z[:, None], dim=-1)
    return means, torch.clamp(variances, min=0.0) + r[:, None, :]
