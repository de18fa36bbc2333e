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

from typing import Tuple

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
    means = torch.empty((b, h, n), dtype=phi.dtype, device=phi.device)
    variances = torch.empty_like(means)
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


def forecast_moments_plain(phi, q, z, r, mean, cov, horizons
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as :func:`forecast_moments` in PyTorch ops."""
    mean_h, cov_h = forecast_state_moments_plain(phi, q, mean, cov, horizons)
    means = mean_h @ z.transpose(-1, -2)  # (B, H, N)
    zp = z[:, None] @ cov_h  # (B, H, N, S)
    variances = torch.sum(zp * z[:, None], dim=-1)
    return means, torch.clamp(variances, min=0.0) + r[:, None, :]
