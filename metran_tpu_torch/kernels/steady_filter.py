"""K14 wrapper: the frozen-gain (steady-state) filter append.

:func:`steady_filter` assimilates ``k`` appended rows for each of ``B``
models through a FROZEN steady gain: per step the predict ``m_p = phi o
m`` and the mean-only update ``m = m_p + K (w o v)``, with no covariance
at all.  The vector form (``sequential=False``) runs one fused update
per step through the joint gain ``K`` (S, N) and the marginal
innovation variances ``f`` (N,); the per-slot form (``sequential=True``,
gated policies only) runs the slot-ordered rank-1 recursion through the
per-slot sequential gains and conditional variances, so its gate tests
what the exact sequential gated update would.  An armed gate (``z^2 >
thresh`` on an observed slot) applies ``"huber"`` (``v`` scaled by
``sqrt(thresh) / |z|``, absorbed by the frozen gain) or, under
``"reject"``/``"inflate"``, breaks time-invariance.

Returns ``(mean_T (B, S), sigma (B,), detf (B,), broke (B,) bool,
zscore (B, k, N), verdict (B, k, N) int8)``: ``sigma``/``detf`` summed
over the steps from the frozen variances, ``broke`` sticky — a step
whose mask differs from the ``real`` slot pattern, a reject/inflate
hit, or a non-finite mean — telling the caller to discard the row and
replay it through the exact kernel; z-scores NaN where unobserved.
With ``horizons`` (an (H,) set of horizons, any values) a seventh
output follows: the mean half of the read path's commit-time forecast
pass, ``Z (phi^h o m_T)`` (B, H, N) — the kernel's ``horizons`` mode
(``csrc/horizon_step.cuh``, shared with the arena's K17), the plain
version's :func:`~.forecast.forecast_means_plain`.

On CUDA tensors it launches the hand-written kernel
(``csrc/steady_filter.cu``, one warp per model) and raises if that
cannot build or launch; on CPU tensors it runs
:func:`steady_filter_plain`, the JAX recursion step by step in batched
PyTorch ops — the oracle the kernel is held against on the card.

Replaces ``metran_tpu/ops/kalman.py::_steady_filter_append`` (B9b
steady) and, in the horizons mode, ``metran_tpu/serve/engine.py::
_steady_horizon_means`` (:856, B13's frozen half).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .forecast import forecast_means_plain, horizon_set
from .gated_filter import (
    GATE_DOWNWEIGHTED,
    GATE_PASS,
    GATE_REJECTED,
    policy_code,
)
from .joint_filter import MAX_SMEM
from .lanes import _stream


def smem_bytes(n_obs: int, n_state: int, dtype: torch.dtype,
               horizons: bool = False) -> int:
    """Dynamic shared memory one warp (block) needs: Z, the gain, the
    mean and three slot vectors (mirrors ``steady_smem`` in the source),
    and in the horizons mode one state vector more (``phi^h o m``)."""
    item = torch.finfo(dtype).bits // 8
    return item * (2 * n_obs * n_state + n_state + 3 * n_obs
                   + (n_state if horizons else 0))



def _check(phi, z, kgain, fdiag, real, mean, y, mask, armed, policy,
           sequential):
    dtype = phi.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the steady filter takes float32/float64, got "
                        f"{dtype}")
    if phi.dim() != 2:
        raise ValueError(f"phi must be (B, S), got {tuple(phi.shape)}")
    b, s = phi.shape
    if z.dim() != 3 or z.shape[0] != b or z.shape[2] != s:
        raise ValueError(f"z must be (B, N, S), got {tuple(z.shape)}")
    n = z.shape[1]
    if y.dim() != 3 or y.shape[0] != b or y.shape[2] != n:
        raise ValueError(f"y must be (B, k, N), got {tuple(y.shape)}")
    shapes = {"kgain": (kgain, (b, s, n)), "fdiag": (fdiag, (b, n)),
              "mean": (mean, (b, s)), "y": (y, tuple(y.shape))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, phi is {dtype}")
    for name, t, shape in (("real", real, (b, n)),
                           ("mask", mask, tuple(y.shape)),
                           ("armed", armed, (b,))):
        if tuple(t.shape) != shape or t.dtype != torch.bool:
            raise ValueError(f"{name} must be a bool {shape} tensor")
    devices = {t.device for t in (phi, z, kgain, fdiag, real, mean, y, mask,
                                  armed)}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    policy_code(policy)
    if sequential and policy == "off":
        raise ValueError("the per-slot form runs a gated policy (with the "
                         "gate off the two forms are one affine map)")
    return b, y.shape[1], n, s


def steady_filter(phi, z, kgain, fdiag, real, mean, y, mask, armed,
                  policy: str = "off", thresh: float = 16.0,
                  sequential: bool = False,
                  horizons=None) -> Tuple[torch.Tensor, ...]:
    """The frozen-gain append of every model (see the module doc)."""
    _check(phi, z, kgain, fdiag, real, mean, y, mask, armed, policy,
           sequential)
    fn = steady_filter_plain if phi.device.type == "cpu" else \
        steady_filter_kernel
    return fn(phi, z, kgain, fdiag, real, mean, y, mask, armed, policy,
              thresh, sequential, horizons)


def steady_filter_kernel(phi, z, kgain, fdiag, real, mean, y, mask, armed,
                         policy: str = "off", thresh: float = 16.0,
                         sequential: bool = False, horizons=None):
    """Launch K14 (CUDA tensors only; raises otherwise, and when the
    kernel cannot build, take the shape or launch)."""
    b, k, n, s = _check(phi, z, kgain, fdiag, real, mean, y, mask, armed,
                        policy, sequential)
    if phi.device.type != "cuda":
        raise ValueError(
            f"the steady filter kernel runs on CUDA tensors, got "
            f"{phi.device}")
    h = horizon_set(horizons, phi)
    smem = smem_bytes(n, s, phi.dtype, h is not None)
    if smem > MAX_SMEM:
        raise ValueError(
            f"bucket (N={n}, S={s}) at {phi.dtype} needs {smem} bytes of "
            f"shared memory per block; the kernel takes at most {MAX_SMEM}")
    args = [t.contiguous() for t in (phi, z, kgain, fdiag, real, mean, y,
                                     mask, armed)]
    new = dict(dtype=phi.dtype, device=phi.device)
    mean_out = torch.empty((b, s), **new)
    sigma = torch.empty((b,), **new)
    detf = torch.empty((b,), **new)
    broke = torch.empty((b,), dtype=torch.bool, device=phi.device)
    zscore = torch.empty((b, k, n), **new)
    verdict = torch.empty((b, k, n), dtype=torch.int8, device=phi.device)
    fmeans = (None if h is None
              else torch.empty((b, h.shape[0], n), **new))
    lib = build.load_library("steady_filter")
    fn = (lib.metran_steady_filter_f64 if phi.dtype == torch.float64
          else lib.metran_steady_filter_f32)
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], float(thresh),
                 mean_out.data_ptr(), sigma.data_ptr(), detf.data_ptr(),
                 broke.data_ptr(), zscore.data_ptr(), verdict.data_ptr(),
                 None if h is None else h.data_ptr(),
                 None if fmeans is None else fmeans.data_ptr(),
                 0 if h is None else h.shape[0], b, k, n, s,
                 policy_code(policy), int(bool(sequential)), _stream(phi))
    build.check(lib, err, "steady_filter")
    if b:
        build.count_launch("steady_filter")
    out = (mean_out, sigma, detf, broke, zscore, verdict)
    return out if fmeans is None else out + (fmeans,)


def steady_filter_plain(phi, z, kgain, fdiag, real, mean, y, mask, armed,
                        policy: str = "off", thresh: float = 16.0,
                        sequential: bool = False, horizons=None):
    """The same recursion in PyTorch ops: the JAX scan step by step (and,
    in the per-slot form, slot by slot), batched over the models; in the
    horizons mode :func:`~.forecast.forecast_means_plain` of the final
    mean."""
    b, k, n, s = _check(phi, z, kgain, fdiag, real, mean, y, mask, armed,
                        policy, sequential)
    dtype, dev = phi.dtype, phi.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    nan = torch.full((), float("nan"), dtype=dtype, device=dev)
    t = torch.tensor(float(thresh), dtype=dtype, device=dev)
    f_safe = torch.where(fdiag > 0, fdiag, one)
    sqrt_f = torch.sqrt(f_safe)
    log_f = torch.where(real, torch.log(f_safe), zero)
    hit_code = GATE_REJECTED if policy == "reject" else GATE_DOWNWEIGHTED

    def weight(hit, score):
        return torch.where(hit, torch.sqrt(t / torch.where(hit, score, one)),
                           one)

    m = mean
    sigma = torch.zeros((b,), dtype=dtype, device=dev)
    detf = torch.zeros((b,), dtype=dtype, device=dev)
    broke = torch.zeros((b,), dtype=torch.bool, device=dev)
    zs_steps, verdict_steps = [], []
    for step in range(k):
        y_t, mask_t = y[:, step], mask[:, step]
        m_p = phi * m
        full = (mask_t == real).all(-1)
        gate_break = torch.zeros((b,), dtype=torch.bool, device=dev)
        if sequential:
            m_s, zs_t, hits = m_p, [], []
            for i in range(n):
                mask_i = mask_t[:, i]
                v = y_t[:, i] - (z[:, i] * m_s).sum(-1)
                zsc = v / torch.sqrt(f_safe[:, i])
                score = zsc * zsc
                hit = armed & mask_i & (score > t)
                if policy == "huber":
                    w = weight(hit, score)
                else:
                    w = one
                    gate_break = gate_break | hit
                wv = w * v
                m_s = torch.where(mask_i[:, None],
                                  m_s + kgain[:, :, i] * wv[:, None], m_s)
                sigma = sigma + torch.where(mask_i, wv * wv / f_safe[:, i],
                                            zero)
                detf = detf + torch.where(mask_i, log_f[:, i], zero)
                zs_t.append(torch.where(mask_i, zsc, nan))
                hits.append(hit)
            m = m_s
            zs_t, hit = torch.stack(zs_t, -1), torch.stack(hits, -1)
        else:
            v = torch.where(mask_t, y_t - (z @ m_p[..., None])[..., 0], zero)
            zs = v / sqrt_f
            score = zs * zs
            if policy == "off":
                hit = torch.zeros_like(mask_t)
                w = one
            else:
                hit = armed[:, None] & mask_t & (score > t)
                if policy == "huber":
                    w = weight(hit, score)
                else:
                    w = one
                    gate_break = hit.any(-1)
            wv = w * v
            m = m_p + (kgain @ wv[..., None])[..., 0]
            sigma = sigma + torch.where(mask_t, wv * wv / f_safe, zero).sum(-1)
            detf = detf + torch.where(mask_t, log_f, zero).sum(-1)
            zs_t = torch.where(mask_t, zs, nan)
        broke = broke | ~full | gate_break
        zs_steps.append(zs_t)
        verdict_steps.append(torch.where(
            hit, torch.tensor(hit_code, dtype=torch.int8, device=dev),
            torch.tensor(GATE_PASS, dtype=torch.int8, device=dev)))
    broke = broke | ~torch.isfinite(m).all(-1)
    if k:
        zscore = torch.stack(zs_steps, 1)
        verdict = torch.stack(verdict_steps, 1)
    else:
        zscore = torch.zeros((b, 0, n), dtype=dtype, device=dev)
        verdict = torch.zeros((b, 0, n), dtype=torch.int8, device=dev)
    out = (m, sigma, detf, broke, zscore, verdict)
    h = horizon_set(horizons, phi)
    return out if h is None else out + (forecast_means_plain(phi, z, m, h),)


__all__ = [
    "smem_bytes",
    "steady_filter",
    "steady_filter_kernel",
    "steady_filter_plain",
]
