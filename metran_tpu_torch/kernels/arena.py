"""K16, K17, K18 wrappers: the state arena's in-place serving kernels.

A :class:`~metran_tpu_torch.serve.state.StateArena` keeps one shape
bucket's models resident as stacked leaves — ``mean (B, S)``, ``fac (B,
S, S)`` (covariances, or Cholesky factors on the square-root engine),
``t_seen``/``version (B,)`` int32, the built state space ``phi (B, S)``,
``q (B, S, S)``, ``z (B, N, S)``, ``r (B, N)``, the steady leaves
``steady (B,)``, ``kgain (B, S, N)``, ``fdiag (B, N)`` and the detector
leaf ``det (B, 6, N)``.  A dispatch names ``G`` distinct rows and hands
up their ``(G, k, N)`` observations; the kernels update the rows IN
PLACE:

- :func:`arena_update` (K16): per row, gather, the engine's exact step
  body (``body="joint"``: K1's; ``"gated"``: K12's — the sequential
  engine, the gate, detection on an ungated registry and the robust
  likelihoods; ``"sqrt"``: K9's), the on-device integrity gate
  (:func:`posterior_ok_plain`), an optional convergence flag and
  detection tail (K13's recursion), and the masked scatter: a row is
  written back, with ``t_seen += k`` and ``version += 1``, only when it
  passed the gate.  Returns ``ok``, ``sigma``/``detf`` (G, k) and, as the
  mode produces them, z-scores, verdicts, Newton iterations, detector
  counts and stats and ``conv``; in the ``horizons`` mode also the
  commit-time forecast pass of the read path: the (G, H, N) observation
  means and variances of each row AS WRITTEN (a rejected row's prior) at
  the given horizon set, K18's operations on K18's inputs;
- :func:`arena_steady_update` (K17): per row, K14's mean-only frozen-gain
  body; a row is ``applied`` when its steady flag is set and nothing
  broke time-invariance, and only applied rows write their mean and bump
  their counters (the factor leaf is never touched); in the ``horizons``
  mode also the mean half of the forecast pass, ``Z (phi^h o m)`` (G, H,
  N) of the written mean (the variance half is frozen with the gain);
- :func:`arena_forecast` (K18): per row, read-only, K2's closed-form
  horizon moments from the row (``F F'`` first on a square-root arena).

Armed flags come from the RESIDENT ``t_seen`` against ``min_seen`` /
``det_min_seen`` (an ungated registry's detection runs the gate's
``"reject"`` mode with ``min_seen`` :data:`NEVER_ARMED`).  Rows must be
distinct: two blocks writing one row would race, so every wrapper raises
``ValueError`` on a repeated row (the service's per-model rounds already
guarantee distinct rows).

On CUDA leaves the wrappers launch the hand-written kernels
(``csrc/arena_joint.cu``, ``arena_gated.cu``, ``arena_sqrt.cu``,
``arena_steady.cu``, ``arena_forecast.cu``) and raise if they cannot
build or launch; on CPU leaves they run the ``*_plain`` versions: an
index gather, the port's plain step functions, the gate in torch ops
(:func:`torch.linalg.cholesky_ex`) and a ``torch.where`` scatter — the
oracle the kernels are held against on the card.  Launch counters:
``arena_update`` (joint and sequential families), ``arena_update_sqrt``,
``arena_steady_update``, ``arena_forecast``.

Replaces ``metran_tpu/serve/engine.py::make_arena_update_fn`` (:1042,
with ``_arena_posterior_ok`` :996), ``make_arena_steady_update_fn``
(:1337) and ``make_arena_forecast_fn`` (:1473) — B13, with its fused
horizon pass (``_horizon_pass`` :673, ``_steady_horizon_means`` :856)
as the ``horizons`` modes of K16 and K17.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.detect import detect_stats
from ..ops.kalman import steady_converged
from . import build
from . import implicit_map as im
from .detect import DETECT_STATE_ROWS, detect_constants, detect_scan_plain
from .forecast import (
    forecast_means_plain,
    forecast_moments_plain,
    horizon_set,
)
from .gated_filter import (
    gated_filter_append_plain,
    policy_code,
    robust_filter_append_plain,
)
from .gated_filter import smem_bytes as gated_smem_bytes
from .joint_filter import MAX_SMEM, joint_filter_append_plain
from .joint_filter import block_smem_bytes as joint_smem_bytes
from .lanes import _stream
from .sqrt_filter import block_smem_bytes as sqrt_smem_bytes
from .sqrt_filter import (
    sqrt_filter_gated_plain,
    sqrt_filter_plain,
    sqrt_filter_robust_plain,
)
from .steady_filter import smem_bytes as steady_smem_bytes
from .steady_filter import steady_filter_plain

#: the exact update's step bodies (K16's engine families)
ARENA_BODIES = ("joint", "gated", "sqrt")
#: a min_seen no resident t_seen reaches: the gate is never armed
NEVER_ARMED = 2**31 - 1
#: the integrity gate's tolerances (``posterior_fault``'s)
SYM_RTOL = 1e-4
PSD_TOL = 1e-4
#: threads per block of each K16 family (the commit's reduction scratch)
_THREADS = {"joint": 256, "gated": 128, "sqrt": 64}


class ArenaUpdateOut(NamedTuple):
    """What :func:`arena_update` returns (``None`` where the mode has no
    such output)."""

    ok: torch.Tensor            # (G,) bool
    sigma: torch.Tensor         # (G, k)
    detf: torch.Tensor          # (G, k)
    zscore: Optional[torch.Tensor]      # (G, k, N)
    verdict: Optional[torch.Tensor]     # (G, k, N) int8
    iters: Optional[torch.Tensor]       # (G, k, N) int32
    det_counts: Optional[torch.Tensor]  # (G, 3, N) int32
    det_stats: Optional[torch.Tensor]   # (G, 3, N)
    conv: Optional[torch.Tensor]        # (G,) bool
    fmeans: Optional[torch.Tensor] = None  # (G, H, N), horizons mode
    fvars: Optional[torch.Tensor] = None   # (G, H, N), horizons mode


class ArenaSteadyOut(NamedTuple):
    """What :func:`arena_steady_update` returns."""

    applied: torch.Tensor       # (G,) bool
    sigma: torch.Tensor         # (G,)
    detf: torch.Tensor          # (G,)
    zscore: torch.Tensor        # (G, k, N)
    verdict: torch.Tensor       # (G, k, N) int8
    det_counts: Optional[torch.Tensor]  # (G, 3, N) int32
    det_stats: Optional[torch.Tensor]   # (G, 3, N)
    fmeans: Optional[torch.Tensor] = None  # (G, H, N), horizons mode


class ArenaRobust(NamedTuple):
    """A robust dispatch's likelihood and its (G, N) per-slot parameters
    (standardized units)."""

    likelihood: str
    nu: float
    rail_lo: torch.Tensor
    rail_hi: torch.Tensor
    quantum: torch.Tensor
    scale: torch.Tensor


# ----------------------------------------------------------------------
# argument checks
# ----------------------------------------------------------------------
def rows_tensor(rows, capacity: int, device) -> torch.Tensor:
    """``rows`` as a (G,) int32 tensor on ``device``, checked on the host:
    in range and DISTINCT (the in-place kernels give each row one block,
    and two blocks writing one row would race)."""
    host = (rows.detach().cpu().numpy() if isinstance(rows, torch.Tensor)
            else np.asarray(rows))
    host = host.astype(np.int64).reshape(-1)
    if host.size and (host.min() < 0 or host.max() >= capacity):
        raise ValueError(f"arena rows must lie in [0, {capacity}), got "
                         f"{host.min()}..{host.max()}")
    if np.unique(host).size != host.size:
        raise ValueError("arena rows of one dispatch must be distinct (a "
                         "repeated row would be written by two blocks)")
    return torch.as_tensor(host.astype(np.int32), device=device)


def _leaf(name, t, shape, dtype):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"arena leaf {name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"arena leaf {name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"arena leaf {name} must be contiguous (it is "
                         "updated in place)")


def _check_leaves(mean, fac, t_seen, version, phi, q, z, r, det=None):
    dtype = mean.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the arena takes float32/float64, got {dtype}")
    b, s = mean.shape
    n = z.shape[1]
    for name, t, shape, dt in (
            ("mean", mean, (b, s), dtype), ("fac", fac, (b, s, s), dtype),
            ("t_seen", t_seen, (b,), torch.int32),
            ("version", version, (b,), torch.int32),
            ("phi", phi, (b, s), dtype), ("q", q, (b, s, s), dtype),
            ("z", z, (b, n, s), dtype), ("r", r, (b, n), dtype)):
        _leaf(name, t, shape, dt)
    if det is not None:
        _leaf("det", det, (b, DETECT_STATE_ROWS, n), dtype)
    devices = {t.device for t in (mean, fac, t_seen, version, phi, q, z, r)}
    if len(devices) != 1:
        raise ValueError(f"arena leaves span devices "
                         f"{sorted(map(str, devices))}")
    return b, n, s


def _dispatch_data(y, mask, g, n, like):
    """``y``/``mask`` as (G, k, N) tensors of the leaves' dtype/device."""
    y = torch.as_tensor(y, dtype=like.dtype, device=like.device)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=like.device)
    if y.dim() != 3 or y.shape[0] != g or y.shape[2] != n:
        raise ValueError(f"y must be (G={g}, k, N={n}), got "
                         f"{tuple(y.shape)}")
    if tuple(mask.shape) != tuple(y.shape):
        raise ValueError(f"mask must be {tuple(y.shape)}, got "
                         f"{tuple(mask.shape)}")
    return y.contiguous(), mask.contiguous()


def _slot_mask(real, g, n, like):
    real = torch.as_tensor(real, dtype=torch.bool, device=like.device)
    if tuple(real.shape) != (g, n):
        raise ValueError(f"real must be ({g}, {n}), got {tuple(real.shape)}")
    return real.contiguous()


def scored(body: str, mode: str, robust: Optional[ArenaRobust]) -> bool:
    """Whether a K16 launch of this body and mode writes per-slot
    z-scores and verdicts (every sequential mode does; the square-root
    body only gated or robust)."""
    return body == "gated" or (body == "sqrt" and (
        mode != "off" or robust is not None))


def _mode_code(body: str, mode: str, robust: Optional[ArenaRobust]) -> int:
    if body not in ARENA_BODIES:
        raise ValueError(f"unknown arena body {body!r}; expected one of "
                         f"{ARENA_BODIES}")
    if robust is not None:
        if body == "joint":
            raise ValueError("the robust update runs the sequential or the "
                             "square-root body")
        return 4 + im.likelihood_code(robust.likelihood)
    code = policy_code(mode)
    if body == "joint" and code:
        raise ValueError("the joint body takes no gate (an armed gate runs "
                         "the sequential body)")
    return code


# ----------------------------------------------------------------------
# plain versions (every device)
# ----------------------------------------------------------------------
def posterior_ok_plain(mean, fac, sigma, detf, sqrt: bool) -> torch.Tensor:
    """The arena's per-row integrity gate in torch ops (the JAX
    ``_arena_posterior_ok``): finite mean, factor, sigma and detf; a
    factor row also a finite ``F F'``; a covariance row also symmetric to
    ``1e-4 scale`` and a finite jittered Cholesky of ``sym(F) + 1e-4
    scale I`` (``scale = max(1, max |F|)``), i.e. no eigenvalue below
    ``-1e-4 scale``."""
    ok = (torch.isfinite(mean).all(-1) & torch.isfinite(sigma).all(-1)
          & torch.isfinite(detf).all(-1)
          & torch.isfinite(fac).all(-1).all(-1))
    if sqrt:
        cov = fac @ fac.transpose(-1, -2)
        return ok & torch.isfinite(cov).all(-1).all(-1)
    one = torch.ones((), dtype=fac.dtype, device=fac.device)
    scale = torch.maximum(fac.abs().amax(dim=(-2, -1)), one) if fac.numel() \
        else torch.ones(fac.shape[:-2], dtype=fac.dtype, device=fac.device)
    asym = ((fac - fac.transpose(-1, -2)).abs().amax(dim=(-2, -1))
            if fac.numel() else torch.zeros_like(scale))
    sym_ok = asym <= SYM_RTOL * scale
    sym = (fac + fac.transpose(-1, -2)) * 0.5
    eye = torch.eye(fac.shape[-1], dtype=fac.dtype, device=fac.device)
    jittered = sym + (PSD_TOL * scale)[..., None, None] * eye
    chol, info = torch.linalg.cholesky_ex(jittered)
    psd_ok = (info == 0) & torch.isfinite(chol).all(-1).all(-1)
    return ok & sym_ok & psd_ok


def _detect_tail_plain(det, idx, zs, mask, darm, keep, det_params):
    """Advance the gathered detector rows over ``zs``; rows where ``keep``
    is False carry their state and book zero counts."""
    det_g = det[idx]
    det_n, counts = detect_scan_plain(det_g, zs, mask, darm, **det_params)
    det_w = torch.where(keep[:, None, None], det_n, det_g)
    counts = torch.where(keep[:, None, None], counts,
                         torch.zeros_like(counts))
    det[idx] = det_w
    return counts, detect_stats(det_w)


def arena_update_plain(mean, fac, t_seen, version, phi, q, z, r, rows, y,
                       mask, *, body: str = "joint", mode: str = "off",
                       thresh: float = 16.0, min_seen: int = 0,
                       robust: Optional[ArenaRobust] = None,
                       validate: bool = True, steady_tol: float = 0.0,
                       real=None, det=None, det_min_seen: int = 0,
                       det_params: Optional[dict] = None,
                       horizons=None) -> ArenaUpdateOut:
    """K16's function in torch ops: gather, the engine's plain step
    function, :func:`posterior_ok_plain`, ``torch.where`` scatter and, in
    the horizons mode, :func:`arena_forecast_plain`'s operations on the
    written rows."""
    b, n, s = _check_leaves(mean, fac, t_seen, version, phi, q, z, r, det)
    _mode_code(body, mode, robust)
    rows = rows_tensor(rows, b, mean.device)
    g = rows.shape[0]
    y, mask = _dispatch_data(y, mask, g, n, mean)
    k = y.shape[1]
    idx = rows.long()
    phi_g, q_g, z_g, r_g = phi[idx], q[idx], z[idx], r[idx]
    mean_g, fac_g, t_g = mean[idx], fac[idx], t_seen[idx]
    armed = t_g >= int(min_seen)
    zs = verdict = iters = None
    if body == "joint":
        mean_n, fac_n, sigma, detf = joint_filter_append_plain(
            phi_g, q_g, z_g, r_g, mean_g, fac_g, y, mask)[:4]
    elif body == "gated":
        if robust is not None:
            mean_n, fac_n, sigma, detf, zs, verdict, iters = \
                robust_filter_append_plain(
                    phi_g, q_g, z_g, r_g, mean_g, fac_g, y, mask, armed,
                    robust.rail_lo, robust.rail_hi, robust.quantum,
                    robust.scale, robust.likelihood, robust.nu)
        else:
            mean_n, fac_n, sigma, detf, zs, verdict = \
                gated_filter_append_plain(phi_g, q_g, z_g, r_g, mean_g,
                                          fac_g, y, mask, armed, mode,
                                          thresh)
    else:
        lanes = (phi_g.T, torch.diagonal(q_g, 0, -2, -1).T,
                 z_g.permute(1, 2, 0), r_g.T)
        if robust is not None:
            mean_n, fac_n, sigma, detf, zs, verdict, iters = \
                sqrt_filter_robust_plain(
                    *lanes, y, mask, mean_g, fac_g, armed, robust.rail_lo,
                    robust.rail_hi, robust.quantum, robust.scale,
                    robust.likelihood, robust.nu)
        elif mode == "off":
            mean_n, fac_n, sigma, detf = sqrt_filter_plain(
                *lanes, y, mask, mean0=mean_g, chol0=fac_g)[:4]
        else:
            mean_n, fac_n, sigma, detf, zs, verdict = \
                sqrt_filter_gated_plain(*lanes, y, mask, mean_g, fac_g,
                                        armed, mode, thresh)
    if validate:
        ok = posterior_ok_plain(mean_n, fac_n, sigma, detf, body == "sqrt")
    else:
        ok = torch.ones((g,), dtype=torch.bool, device=mean.device)
    # per-row failure isolation IS the mask on the scatter
    mean_w = torch.where(ok[:, None], mean_n, mean_g)
    fac_w = torch.where(ok[:, None, None], fac_n, fac_g)
    conv = None
    if steady_tol > 0.0:
        tol = torch.tensor(float(steady_tol), dtype=mean.dtype,
                           device=mean.device)
        conv = steady_converged(fac_g, fac_w, mask,
                                _slot_mask(real, g, n, mean), tol)
    det_counts = det_stats = None
    if det is not None:
        det_counts, det_stats = _detect_tail_plain(
            det, idx, zs, mask, t_g >= int(det_min_seen), ok, det_params)
    fm = fv = None
    h = horizon_set(horizons, mean)
    if h is not None:
        cov_w = fac_w @ fac_w.transpose(-1, -2) if body == "sqrt" else fac_w
        fm, fv = forecast_moments_plain(phi_g, q_g, z_g, r_g, mean_w, cov_w,
                                        h)
    bump = ok.to(torch.int32)
    mean[idx] = mean_w
    fac[idx] = fac_w
    t_seen[idx] = t_g + bump * k
    version[idx] = version[idx] + bump
    return ArenaUpdateOut(ok, sigma, detf, zs, verdict, iters, det_counts,
                          det_stats, conv, fm, fv)


def arena_steady_update_plain(mean, t_seen, version, phi, z, steady, kgain,
                              fdiag, rows, real, y, mask, *,
                              mode: str = "off", thresh: float = 16.0,
                              sequential: bool = False, min_seen: int = 0,
                              det=None, det_min_seen: int = 0,
                              det_params: Optional[dict] = None,
                              horizons=None) -> ArenaSteadyOut:
    """K17's function in torch ops: gather, :func:`~.steady_filter.
    steady_filter_plain`, the applied selection, ``torch.where`` scatter
    and, in the horizons mode, :func:`~.forecast.forecast_means_plain` of
    the written means."""
    b, n, s = _check_steady(mean, t_seen, version, phi, z, steady, kgain,
                            fdiag, det)
    policy_code(mode)
    rows = rows_tensor(rows, b, mean.device)
    g = rows.shape[0]
    y, mask = _dispatch_data(y, mask, g, n, mean)
    real = _slot_mask(real, g, n, mean)
    k = y.shape[1]
    idx = rows.long()
    mean_g, t_g = mean[idx], t_seen[idx]
    armed = t_g >= int(min_seen)
    mean_n, sigma, detf, broke, zs, verdict = steady_filter_plain(
        phi[idx], z[idx], kgain[idx], fdiag[idx], real, mean_g, y, mask,
        armed, mode, thresh, sequential and mode != "off")
    applied = steady[idx] & ~broke
    det_counts = det_stats = None
    if det is not None:
        det_counts, det_stats = _detect_tail_plain(
            det, idx, zs, mask, t_g >= int(det_min_seen), applied,
            det_params)
    bump = applied.to(torch.int32)
    mean_w = torch.where(applied[:, None], mean_n, mean_g)
    fm = None
    h = horizon_set(horizons, mean)
    if h is not None:
        fm = forecast_means_plain(phi[idx], z[idx], mean_w, h)
    mean[idx] = mean_w
    t_seen[idx] = t_g + bump * k
    version[idx] = version[idx] + bump
    return ArenaSteadyOut(applied, sigma, detf, zs, verdict, det_counts,
                          det_stats, fm)


def arena_forecast_plain(mean, fac, phi, q, z, r, rows, horizons,
                         sqrt: bool = False):
    """K18's function in torch ops: gather, ``F F'`` on a square-root
    arena, :func:`~.forecast.forecast_moments_plain`."""
    b, n, s = _check_forecast(mean, fac, phi, q, z, r)
    idx = rows_tensor(rows, b, mean.device).long()
    horizons = torch.as_tensor(horizons, dtype=mean.dtype,
                               device=mean.device)
    fac_g = fac[idx]
    cov = fac_g @ fac_g.transpose(-1, -2) if sqrt else fac_g
    return forecast_moments_plain(phi[idx], q[idx], z[idx], r[idx],
                                  mean[idx], cov, horizons)


def _check_steady(mean, t_seen, version, phi, z, steady, kgain, fdiag,
                  det):
    dtype = mean.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the arena takes float32/float64, got {dtype}")
    b, s = mean.shape
    n = z.shape[1]
    for name, t, shape, dt in (
            ("mean", mean, (b, s), dtype),
            ("t_seen", t_seen, (b,), torch.int32),
            ("version", version, (b,), torch.int32),
            ("phi", phi, (b, s), dtype), ("z", z, (b, n, s), dtype),
            ("steady", steady, (b,), torch.bool),
            ("kgain", kgain, (b, s, n), dtype),
            ("fdiag", fdiag, (b, n), dtype)):
        _leaf(name, t, shape, dt)
    if det is not None:
        _leaf("det", det, (b, DETECT_STATE_ROWS, n), dtype)
    return b, n, s


def _check_forecast(mean, fac, phi, q, z, r):
    dtype = mean.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the arena takes float32/float64, got {dtype}")
    b, s = mean.shape
    n = z.shape[1]
    for name, t, shape in (("mean", mean, (b, s)), ("fac", fac, (b, s, s)),
                           ("phi", phi, (b, s)), ("q", q, (b, s, s)),
                           ("z", z, (b, n, s)), ("r", r, (b, n))):
        _leaf(name, t, shape, dtype)
    return b, n, s


# ----------------------------------------------------------------------
# the kernels
# ----------------------------------------------------------------------
def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _det_consts(det_params, dtype):
    if det_params is None:
        return (0.0,) * 7
    return detect_constants(det_params["cusum_k"], det_params["cusum_h"],
                            det_params["lb_window"], det_params["lb_thresh"],
                            det_params["nsigma"], dtype)


def update_smem_bytes(body: str, n_obs: int, n_state: int,
                      dtype: torch.dtype, horizons: bool = False) -> int:
    """Dynamic shared memory one K16 block needs (mirrors the sources:
    the body's layout, aligned to 16 bytes, then the commit's scratch —
    or, in the horizons mode, the tail's where that is larger: K2's
    scratch and, on a factor row, the reconstituted covariance)."""
    item = torch.finfo(dtype).bits // 8
    base = {"joint": joint_smem_bytes, "gated": gated_smem_bytes,
            "sqrt": sqrt_smem_bytes}[body](n_obs, n_state, dtype)
    base = (base + 15) // 16 * 16
    after = n_state * n_state + 2 * _THREADS[body]
    if horizons:
        tail = forecast_smem_bytes(n_obs, n_state, dtype,
                                   body == "sqrt") // item
        after = max(after, tail)
    return base + item * after


def call_update(fn, out: ArenaUpdateOut, leaves, det, rows, y, mask, real,
                robust: Optional[ArenaRobust], *, mode_code: int,
                thresh: float, min_seen: int, validate: bool,
                steady_tol: float, det_min_seen: int, det_params,
                horizons, stream) -> int:
    """Marshal one K16 launch (``fn`` a library entry point of the
    ``metran_arena_*`` signature); returns the CUDA error code."""
    mean, fac, t_seen, version, phi, q, z, r = leaves
    dtype = mean.dtype
    g, k, n = y.shape
    s = mean.shape[1]
    rob = robust if robust is not None else ArenaRobust("", 4.0, None,
                                                        None, None, None)
    tol, nonconv_tol = im.solver_tols(dtype)
    return fn(*[_ptr(t) for t in (mean, fac, t_seen, version, phi, q, z, r,
                                  det, rows, y, mask, real, rob.rail_lo,
                                  rob.rail_hi, rob.quantum, rob.scale)],
              *[_ptr(t) for t in out[:9]], _ptr(horizons), _ptr(out.fmeans),
              _ptr(out.fvars), float(thresh), float(rob.nu), tol,
              nonconv_tol, im.c_floor(dtype),
              float(torch.finfo(dtype).eps), float(steady_tol),
              *_det_consts(det_params, dtype), int(min_seen),
              int(det_min_seen), int(bool(validate)), int(mode_code), g, k,
              n, s, 0 if horizons is None else horizons.shape[0], stream)


def alloc_update(body: str, g: int, k: int, n: int, like, scored: bool,
                 robust: bool, det: bool, conv: bool,
                 n_horizons: int = 0) -> ArenaUpdateOut:
    """The output buffers of one K16 launch; the horizons mode's means
    and variances are the two halves of one (2, G, H, N) buffer, which
    the service brings to the host in one copy."""
    new = dict(dtype=like.dtype, device=like.device)
    dev = like.device
    hz = (torch.empty((2, g, n_horizons, n), **new) if n_horizons
          else (None, None))
    return ArenaUpdateOut(
        torch.empty((g,), dtype=torch.bool, device=dev),
        torch.empty((g, k), **new), torch.empty((g, k), **new),
        torch.empty((g, k, n), **new) if scored else None,
        torch.empty((g, k, n), dtype=torch.int8, device=dev)
        if scored else None,
        torch.empty((g, k, n), dtype=torch.int32, device=dev)
        if robust else None,
        torch.empty((g, 3, n), dtype=torch.int32, device=dev)
        if det else None,
        torch.empty((g, 3, n), **new) if det else None,
        torch.empty((g,), dtype=torch.bool, device=dev) if conv else None,
        hz[0], hz[1])


def arena_update_kernel(mean, fac, t_seen, version, phi, q, z, r, rows, y,
                        mask, *, body: str = "joint", mode: str = "off",
                        thresh: float = 16.0, min_seen: int = 0,
                        robust: Optional[ArenaRobust] = None,
                        validate: bool = True, steady_tol: float = 0.0,
                        real=None, det=None, det_min_seen: int = 0,
                        det_params: Optional[dict] = None,
                        horizons=None) -> ArenaUpdateOut:
    """Launch K16 (CUDA leaves only; raises otherwise, and when the kernel
    cannot build, take the bucket or launch)."""
    b, n, s = _check_leaves(mean, fac, t_seen, version, phi, q, z, r, det)
    code = _mode_code(body, mode, robust)
    if mean.device.type != "cuda":
        raise ValueError(f"the arena update kernel runs on CUDA leaves, got "
                         f"{mean.device}")
    if det is not None and code == 0:
        raise ValueError("detection reads real z-scores: run mode 'reject' "
                         "with min_seen NEVER_ARMED on an ungated registry")
    h = horizon_set(horizons, mean)
    smem = update_smem_bytes(body, n, s, mean.dtype, h is not None)
    if smem > MAX_SMEM:
        raise ValueError(
            f"bucket (N={n}, S={s}) at {mean.dtype} needs {smem} bytes of "
            f"shared memory per block; the kernel takes at most {MAX_SMEM}")
    rows = rows_tensor(rows, b, mean.device)
    g = rows.shape[0]
    y, mask = _dispatch_data(y, mask, g, n, mean)
    k = y.shape[1]
    real_t = _slot_mask(real, g, n, mean) if steady_tol > 0.0 else None
    if robust is not None:
        for name in ("rail_lo", "rail_hi", "quantum", "scale"):
            t = getattr(robust, name)
            if tuple(t.shape) != (g, n) or t.dtype != mean.dtype:
                raise ValueError(f"robust {name} must be a ({g}, {n}) "
                                 f"{mean.dtype} tensor")
        robust = robust._replace(**{
            name: getattr(robust, name).to(mean.device).contiguous()
            for name in ("rail_lo", "rail_hi", "quantum", "scale")})
    out = alloc_update(body, g, k, n, mean, scored(body, mode, robust),
                       robust is not None, det is not None,
                       steady_tol > 0.0, 0 if h is None else h.shape[0])
    lib = build.load_library(f"arena_{body}")
    fn = getattr(lib, f"metran_arena_{body}_"
                      f"{'f64' if mean.dtype == torch.float64 else 'f32'}")
    with torch.cuda.device(mean.device):
        err = call_update(fn, out, (mean, fac, t_seen, version, phi, q, z,
                                    r), det, rows, y, mask, real_t, robust,
                          mode_code=code, thresh=thresh, min_seen=min_seen,
                          validate=validate, steady_tol=steady_tol,
                          det_min_seen=det_min_seen, det_params=det_params,
                          horizons=h, stream=_stream(mean))
    build.check(lib, err, f"arena_update ({body})")
    if g:
        build.count_launch("arena_update_sqrt" if body == "sqrt"
                           else "arena_update")
    return out


def arena_update(mean, fac, t_seen, version, phi, q, z, r, rows, y, mask,
                 **kw) -> ArenaUpdateOut:
    """The exact in-place arena update (module doc): K16 on CUDA leaves,
    :func:`arena_update_plain` on CPU leaves."""
    fn = (arena_update_plain if mean.device.type == "cpu"
          else arena_update_kernel)
    return fn(mean, fac, t_seen, version, phi, q, z, r, rows, y, mask, **kw)


def call_steady(fn, out: ArenaSteadyOut, leaves, det, rows, real, y, mask,
                *, mode: str, thresh: float, sequential: bool, min_seen: int,
                det_min_seen: int, det_params, horizons, stream) -> int:
    """Marshal one K17 launch; returns the CUDA error code."""
    mean, t_seen, version, phi, z, steady, kgain, fdiag = leaves
    g, k, n = y.shape
    return fn(*[_ptr(t) for t in (mean, t_seen, version, phi, z, steady,
                                  kgain, fdiag, det, rows, real, y, mask)],
              *[_ptr(t) for t in out[:7]], _ptr(horizons), _ptr(out.fmeans),
              float(thresh), *_det_consts(det_params, mean.dtype),
              int(min_seen), int(det_min_seen), policy_code(mode),
              int(bool(sequential) and mode != "off"), g, k, n,
              mean.shape[1], 0 if horizons is None else horizons.shape[0],
              stream)


def alloc_steady(g: int, k: int, n: int, like, det: bool,
                 n_horizons: int = 0) -> ArenaSteadyOut:
    """The output buffers of one K17 launch."""
    new = dict(dtype=like.dtype, device=like.device)
    dev = like.device
    return ArenaSteadyOut(
        torch.empty((g,), dtype=torch.bool, device=dev),
        torch.empty((g,), **new), torch.empty((g,), **new),
        torch.empty((g, k, n), **new),
        torch.empty((g, k, n), dtype=torch.int8, device=dev),
        torch.empty((g, 3, n), dtype=torch.int32, device=dev)
        if det else None,
        torch.empty((g, 3, n), **new) if det else None,
        torch.empty((g, n_horizons, n), **new) if n_horizons else None)


def arena_steady_update_kernel(mean, t_seen, version, phi, z, steady, kgain,
                               fdiag, rows, real, y, mask, *,
                               mode: str = "off", thresh: float = 16.0,
                               sequential: bool = False, min_seen: int = 0,
                               det=None, det_min_seen: int = 0,
                               det_params: Optional[dict] = None,
                               horizons=None) -> ArenaSteadyOut:
    """Launch K17 (CUDA leaves only; raises otherwise)."""
    b, n, s = _check_steady(mean, t_seen, version, phi, z, steady, kgain,
                            fdiag, det)
    policy_code(mode)
    if mean.device.type != "cuda":
        raise ValueError(f"the arena steady kernel runs on CUDA leaves, got "
                         f"{mean.device}")
    h = horizon_set(horizons, mean)
    smem = steady_smem_bytes(n, s, mean.dtype, h is not None)
    if smem > MAX_SMEM:
        raise ValueError(
            f"bucket (N={n}, S={s}) at {mean.dtype} needs {smem} bytes of "
            f"shared memory per block; the kernel takes at most {MAX_SMEM}")
    rows = rows_tensor(rows, b, mean.device)
    g = rows.shape[0]
    y, mask = _dispatch_data(y, mask, g, n, mean)
    real = _slot_mask(real, g, n, mean)
    out = alloc_steady(g, y.shape[1], n, mean, det is not None,
                       0 if h is None else h.shape[0])
    lib = build.load_library("arena_steady")
    fn = (lib.metran_arena_steady_f64 if mean.dtype == torch.float64
          else lib.metran_arena_steady_f32)
    with torch.cuda.device(mean.device):
        err = call_steady(fn, out, (mean, t_seen, version, phi, z, steady,
                                    kgain, fdiag), det, rows, real, y, mask,
                          mode=mode, thresh=thresh, sequential=sequential,
                          min_seen=min_seen, det_min_seen=det_min_seen,
                          det_params=det_params, horizons=h,
                          stream=_stream(mean))
    build.check(lib, err, "arena_steady_update")
    if g:
        build.count_launch("arena_steady_update")
    return out


def arena_steady_update(mean, t_seen, version, phi, z, steady, kgain, fdiag,
                        rows, real, y, mask, **kw) -> ArenaSteadyOut:
    """The in-place frozen-gain arena update (module doc): K17 on CUDA
    leaves, :func:`arena_steady_update_plain` on CPU leaves."""
    fn = (arena_steady_update_plain if mean.device.type == "cpu"
          else arena_steady_update_kernel)
    return fn(mean, t_seen, version, phi, z, steady, kgain, fdiag, rows,
              real, y, mask, **kw)


def forecast_smem_bytes(n_obs: int, n_state: int, dtype: torch.dtype,
                        sqrt: bool) -> int:
    """Dynamic shared memory one K18 block needs (K2's layout, and the
    reconstituted covariance of a factor row)."""
    item = torch.finfo(dtype).bits // 8
    elems = n_state * n_state + 2 * n_obs * n_state + n_state
    return item * (elems + (n_state * n_state if sqrt else 0))


def call_forecast(fn, means, variances, leaves, rows, horizons,
                  sqrt: bool, stream) -> int:
    """Marshal one K18 launch; returns the CUDA error code."""
    mean, fac, phi, q, z, r = leaves
    g, h, n = means.shape
    return fn(*[_ptr(t) for t in (mean, fac, phi, q, z, r, rows, horizons,
                                  means, variances)], g, h, n,
              mean.shape[1], int(bool(sqrt)), stream)


def arena_forecast_kernel(mean, fac, phi, q, z, r, rows, horizons,
                          sqrt: bool = False):
    """Launch K18 (CUDA leaves only; raises otherwise)."""
    b, n, s = _check_forecast(mean, fac, phi, q, z, r)
    if mean.device.type != "cuda":
        raise ValueError(f"the arena forecast kernel runs on CUDA leaves, "
                         f"got {mean.device}")
    smem = forecast_smem_bytes(n, s, mean.dtype, sqrt)
    if smem > MAX_SMEM:
        raise ValueError(
            f"bucket (N={n}, S={s}) at {mean.dtype} needs {smem} bytes of "
            f"shared memory per block; the kernel takes at most {MAX_SMEM}")
    rows = rows_tensor(rows, b, mean.device)
    horizons = torch.as_tensor(horizons, dtype=mean.dtype,
                               device=mean.device).contiguous()
    g, h = rows.shape[0], horizons.shape[0]
    new = dict(dtype=mean.dtype, device=mean.device)
    means = torch.empty((g, h, n), **new)
    variances = torch.empty((g, h, n), **new)
    lib = build.load_library("arena_forecast")
    fn = (lib.metran_arena_forecast_f64 if mean.dtype == torch.float64
          else lib.metran_arena_forecast_f32)
    with torch.cuda.device(mean.device):
        err = call_forecast(fn, means, variances, (mean, fac, phi, q, z, r),
                            rows, horizons, sqrt, _stream(mean))
    build.check(lib, err, "arena_forecast")
    if g and h:
        build.count_launch("arena_forecast")
    return means, variances


def arena_forecast(mean, fac, phi, q, z, r, rows, horizons,
                   sqrt: bool = False):
    """The arena forecast (module doc): K18 on CUDA leaves,
    :func:`arena_forecast_plain` on CPU leaves.  Returns ``(means,
    variances)`` (G, H, N), standardized units."""
    fn = (arena_forecast_plain if mean.device.type == "cpu"
          else arena_forecast_kernel)
    return fn(mean, fac, phi, q, z, r, rows, horizons, sqrt)


__all__ = [
    "ARENA_BODIES",
    "ArenaRobust",
    "ArenaSteadyOut",
    "ArenaUpdateOut",
    "NEVER_ARMED",
    "arena_forecast",
    "arena_forecast_kernel",
    "arena_forecast_plain",
    "arena_steady_update",
    "arena_steady_update_kernel",
    "arena_steady_update_plain",
    "arena_update",
    "arena_update_kernel",
    "arena_update_plain",
    "posterior_ok_plain",
    "rows_tensor",
    "scored",
]
