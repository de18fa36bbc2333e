"""K13 wrapper: the streaming detector over normalized innovations.

:func:`detect_scan` advances ``B`` models' per-slot detector states
``[C+, C-, z_prev, S_zz, S_z2, n_eff]`` ((B, 6, N)) over ``k`` appended
steps of z-scores ((B, k, N), NaN where unobserved) and returns the new
states and the per-slot alarm counts ``[anomalies, CUSUM alarms, LB
alarms]`` ((B, 3, N) int32): the two-sided CUSUM with reset on alarm,
the forgetting-factor lag-1 portmanteau ``Q`` with its warm-window
rising edge, and the ``z^2 > nsigma^2`` anomaly flag.  Unobserved
slots, disarmed models and NaN z-scores carry the state unchanged.

On CUDA tensors it launches the hand-written kernel
(``csrc/detect.cu``, one thread per (model, slot)) and raises if that
cannot build or launch; on CPU tensors it runs
:func:`detect_scan_plain`, the JAX recursion step by step in PyTorch
ops.  Both round every operation alike (the kernel avoids fused
multiply-adds), so on one device they agree bit for bit.

Replaces ``metran_tpu/ops/detect.py::_detect_scan`` (B11).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

#: rows of the carried per-slot detector state
DETECT_STATE_ROWS = 6


def detect_constants(cusum_k: float, cusum_h: float, lb_window: int,
                     lb_thresh: float, nsigma: float, dtype) -> tuple:
    """The recursion's constants, as the JAX function forms them (in
    Python floats, then rounded once to ``dtype``): ``(k, h, lam, warm,
    q_bar, a_bar, tiny)``."""
    return (float(cusum_k), float(cusum_h), 1.0 - 1.0 / float(lb_window),
            0.5 * float(lb_window), float(lb_thresh), float(nsigma) ** 2,
            float(torch.finfo(dtype).tiny))


def _check(state, zs, mask, armed):
    dtype = state.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"detector takes float32/float64, got {dtype}")
    if state.dim() != 3 or state.shape[1] != DETECT_STATE_ROWS:
        raise ValueError(
            f"state must be (B, {DETECT_STATE_ROWS}, N), got "
            f"{tuple(state.shape)}")
    b, _, n = state.shape
    if zs.dim() != 3 or zs.shape[0] != b or zs.shape[2] != n:
        raise ValueError(f"zs must be (B, k, N), got {tuple(zs.shape)}")
    if zs.dtype != dtype:
        raise TypeError(f"zs is {zs.dtype}, state is {dtype}")
    if tuple(mask.shape) != tuple(zs.shape) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be a bool {tuple(zs.shape)} tensor")
    if tuple(armed.shape) != (b,) or armed.dtype != torch.bool:
        raise ValueError(f"armed must be a bool ({b},) tensor")
    devices = {t.device for t in (state, zs, mask, armed)}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    return b, zs.shape[1], n


def detect_scan(state, zs, mask, armed, cusum_k: float = 0.5,
                cusum_h: float = 12.0, lb_window: int = 64,
                lb_thresh: float = 25.0, nsigma: float = 5.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(state' (B, 6, N), counts (B, 3, N) int32)`` (module doc)."""
    _check(state, zs, mask, armed)
    fn = detect_scan_plain if state.device.type == "cpu" else \
        detect_scan_kernel
    return fn(state, zs, mask, armed, cusum_k, cusum_h, lb_window,
              lb_thresh, nsigma)


def detect_scan_kernel(state, zs, mask, armed, cusum_k: float = 0.5,
                       cusum_h: float = 12.0, lb_window: int = 64,
                       lb_thresh: float = 25.0, nsigma: float = 5.0):
    """Launch K13 (CUDA tensors only; raises otherwise, and when the
    kernel cannot build or launch)."""
    b, k, n = _check(state, zs, mask, armed)
    if state.device.type != "cuda":
        raise ValueError(
            f"the detector kernel runs on CUDA tensors, got {state.device}")
    args = [t.contiguous() for t in (state, zs, mask, armed)]
    state_out = torch.empty_like(args[0])
    counts = torch.empty((b, 3, n), dtype=torch.int32, device=state.device)
    consts = detect_constants(cusum_k, cusum_h, lb_window, lb_thresh,
                              nsigma, state.dtype)
    lib = build.load_library("detect")
    fn = (lib.metran_detect_f64 if state.dtype == torch.float64
          else lib.metran_detect_f32)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = fn(*[t.data_ptr() for t in args], state_out.data_ptr(),
                 counts.data_ptr(), b, k, n, *consts, stream)
    build.check(lib, err, "detect_scan")
    if b * n:
        build.count_launch("detect")
    return state_out, counts


def detect_scan_plain(state, zs, mask, armed, cusum_k: float = 0.5,
                      cusum_h: float = 12.0, lb_window: int = 64,
                      lb_thresh: float = 25.0, nsigma: float = 5.0):
    """The same recursion in PyTorch ops, a Python loop over ``k``
    (the JAX ``_detect_scan`` step for step, batched over B)."""
    b, k, n = _check(state, zs, mask, armed)
    dtype, dev = state.dtype, state.device
    ck, ch, lam, warm, q_bar, a_bar, tiny = (
        torch.tensor(c, dtype=dtype, device=dev) for c in detect_constants(
            cusum_k, cusum_h, lb_window, lb_thresh, nsigma, dtype))
    zero = torch.zeros((), dtype=dtype, device=dev)

    def lb_q(szz, sz2, nef):
        rho = szz / torch.maximum(sz2, tiny)
        return nef * rho * rho

    cpos, cneg, prev, szz, sz2, nef = state.unbind(1)
    counts = torch.zeros((b, 3, n), dtype=torch.int32, device=dev)
    for t in range(k):
        z_raw = zs[:, t]
        obs = mask[:, t] & armed[:, None] & torch.isfinite(z_raw)
        z = torch.where(obs, z_raw, zero)
        anom = obs & (z * z > a_bar)
        cpos_n = torch.where(obs, torch.maximum(cpos + z - ck, zero), cpos)
        cneg_n = torch.where(obs, torch.maximum(cneg - z - ck, zero), cneg)
        cp_hit = obs & ((cpos_n > ch) | (cneg_n > ch))
        cpos = torch.where(cp_hit, zero, cpos_n)
        cneg = torch.where(cp_hit, zero, cneg_n)
        was = (nef >= warm) & (lb_q(szz, sz2, nef) > q_bar)
        szz = torch.where(obs, lam * szz + z * prev, szz)
        sz2 = torch.where(obs, lam * sz2 + z * z, sz2)
        nef = torch.where(obs, lam * nef + 1.0, nef)
        prev = torch.where(obs, z, prev)
        now = (nef >= warm) & (lb_q(szz, sz2, nef) > q_bar)
        lb_hit = obs & now & ~was
        counts += torch.stack([anom, cp_hit, lb_hit], 1).to(torch.int32)
    return torch.stack([cpos, cneg, prev, szz, sz2, nef], 1), counts


__all__ = [
    "DETECT_STATE_ROWS",
    "detect_constants",
    "detect_scan",
    "detect_scan_kernel",
    "detect_scan_plain",
]
