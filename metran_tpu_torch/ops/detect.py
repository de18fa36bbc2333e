"""Streaming anomaly and changepoint detection over normalized
innovations (port of ``metran_tpu/ops/detect.py``).

The gated serving updates (:func:`~metran_tpu_torch.ops.
gated_filter_append`, :func:`~metran_tpu_torch.ops.
gated_sqrt_filter_append`) emit each observed slot's signed z-score
``z = v / sqrt(f)``.  :func:`detect_append` turns that stream into three
O(1)-state statistics per slot: the ``z^2 > nsigma^2`` **anomaly**
flag, a two-sided **CUSUM** changepoint test that resets on alarm, and
an exponentially-windowed lag-1 portmanteau **autocorrelation-drift**
statistic ``Q = n_eff (S_zz / S_z2)^2`` whose alarms are rising edges
once the window is half full.  State layout (:data:`DETECT_STATE_ROWS`
= 6 rows, one column per slot): ``[C+, C-, z_prev, S_zz, S_z2,
n_eff]``; unobserved slots, disarmed models and NaN z-scores carry it
unchanged.

On CUDA tensors :func:`detect_append` is one launch of kernel K13
(:func:`metran_tpu_torch.kernels.detect.detect_scan`), after the update
kernel (the JAX package fuses it into the update executable); on CPU
tensors its plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import as_tensor, default_dtype, resolve_device
from ..kernels.detect import DETECT_STATE_ROWS, detect_scan

__all__ = [
    "DETECT_STATE_ROWS",
    "detect_append",
    "detect_init",
    "detect_stats",
]


def detect_init(n_obs: int, dtype=None, device=None) -> torch.Tensor:
    """A fresh (:data:`DETECT_STATE_ROWS`, ``n_obs``) detector state:
    all zeros (no evidence, no window).  ``dtype`` defaults to the
    precision policy of ``device`` (:func:`metran_tpu_torch.config.
    default_dtype`: float64 on the CPU, float32 on the card unless
    ``METRAN_TPU_X64``)."""
    device = resolve_device(device)
    if dtype is None:
        dtype = default_dtype(device)
    return torch.zeros((DETECT_STATE_ROWS, int(n_obs)), dtype=dtype,
                       device=device)


def detect_stats(state) -> torch.Tensor:
    """``[cusum_pos, cusum_neg, lb_q]`` of a detector state, (3, N)
    (batched over any leading axes): the CUSUM accumulators verbatim and
    ``Q = n_eff (S_zz / max(S_z2, tiny))^2``."""
    state = torch.as_tensor(state)
    szz, sz2, nef = state[..., 3, :], state[..., 4, :], state[..., 5, :]
    tiny = torch.tensor(torch.finfo(state.dtype).tiny, dtype=state.dtype,
                        device=state.device)
    rho = szz / torch.maximum(sz2, tiny)
    return torch.stack([state[..., 0, :], state[..., 1, :], nef * rho * rho],
                       dim=-2)


def detect_append(state, zs, mask, armed=True, *, cusum_k: float = 0.5,
                  cusum_h: float = 12.0, lb_window: int = 64,
                  lb_thresh: float = 25.0, nsigma: float = 5.0,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance detector states over ``k`` appended steps.

    One model: ``state`` (6, N), ``zs``/``mask`` (k, N) (or (N,)),
    ``armed`` a bool.  A batch: ``state`` (B, 6, N), ``zs``/``mask``
    (B, k, N), ``armed`` a bool or (B,).  ``zs`` are the gated updates'
    z-scores (NaN where unobserved).  Thresholds as the JAX function's
    (``cusum_k``/``cusum_h`` in innovation sigmas, ``lb_window`` the
    forgetting window, which must exceed the lag 1, ``lb_thresh`` on
    ``Q``, ``nsigma`` the anomaly bar).  Returns ``(state', counts)``:
    the advanced state and the (3, N) (or (B, 3, N)) int32 counts
    ``[anomalies, cusum_alarms, lb_alarms]`` booked over the ``k``
    steps.
    """
    if int(lb_window) <= 1:
        raise ValueError(
            f"lb_window must exceed the autocorrelation lag (1), got "
            f"{lb_window}")
    device = resolve_device(device, state)
    state = as_tensor(state, device)
    dtype = state.dtype
    zs = as_tensor(zs, device, dtype)
    mask = as_tensor(mask, device, torch.bool)
    single = state.dim() == 2
    if single:
        if zs.dim() == 1:
            zs, mask = zs[None], mask[None]
        state, zs, mask = state[None], zs[None], mask[None]
    armed = torch.as_tensor(armed, dtype=torch.bool, device=device)
    if armed.dim() == 0:
        armed = armed.expand(state.shape[0])
    new, counts = detect_scan(
        state.contiguous(), zs.contiguous(), mask.contiguous(),
        armed.contiguous(), cusum_k=cusum_k, cusum_h=cusum_h,
        lb_window=lb_window, lb_thresh=lb_thresh, nsigma=nsigma)
    if single:
        return new[0], counts[0]
    return new, counts
