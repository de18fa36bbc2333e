"""Fleet-scale fitting and post-fit products: many independent Metran
DFMs on one card.

Port of ``metran_tpu/parallel/fleet.py``: a fleet of DFMs padded to
common shapes (:class:`Fleet`, :func:`pack_fleet`) fitted in one of two
layouts.

- ``layout="batch"`` (the default, as in the JAX package): the fleet
  axis leads, and every model runs optax's zoom-line-search L-BFGS
  (:mod:`metran_tpu_torch.models.lbfgs`) on the engine's own deviance
  (:func:`fleet_deviance`; ``engine="joint"`` by default).  One
  line-search round of all the lanes still searching is one batched
  objective call: K1 with segment boundaries forward, the closed-form
  adjoint K11 backward (K9 forward for ``engine="sqrt"``, K3/K4 for
  ``"sequential"``).  The optimizer advances in chunks of ``chunk``
  iterations; between chunks the host freezes lanes whose value stopped
  moving (the stall stop).
- ``layout="lanes"``: the batched L-BFGS of :mod:`.lanes_lbfgs` over
  the lanes deviance (:mod:`metran_tpu_torch.ops.lanes`: kernel K3 for
  values, K4 for gradients), a grid line search of fixed structure;
  between chunks the host reads the frozen flags to stop early and,
  once most lanes are done, compacts the live lanes into a smaller
  working set.

Standard errors (:func:`fleet_stderr`, ``method="lanes-fd"``) are central
differences of the exact K3/K4 gradient with every model's 2P
perturbation points riding the lane axis over one copy of its data.

The products of a fitted fleet (:func:`fleet_simulate`,
:func:`fleet_decompose`, :func:`fleet_forecast`,
:func:`fleet_innovations`, :func:`fleet_sample`) run in lane layout
(:mod:`metran_tpu_torch.ops.lanes_products`: kernels K3, K5, K6, K7 and
K2) on the fleet's own (B, T, N) data, in ``batch_chunk``-model
dispatches.

Padding semantics (as the JAX package's): padded timesteps and series
slots are masked everywhere, padded factors have zero loadings, so none
of them touches the likelihood.

With a device ``mesh`` (:mod:`.mesh`) the fleet axis splits into
``mesh.size`` even shards, each fitted by the same fit loop on its own
device (on the card one host thread and one stream per shard, so shards
run side by side) and gathered into one :class:`FleetFit`; lanes never
interact and batch-layout models only share their line-search rounds, so
each model's fit is its unsharded one up to the rounds' reduction order.

Not ported yet: ``checkpoint`` (ROADMAP A3, ``io.save_fleet_state``) and
``fleet_stderr(method="exact")`` (A3, the exact Hessian); each raises
``NotImplementedError``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from logging import getLogger
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import as_tensor, resolve_device
from ..data import Panel
from ..kernels import lanes_products as kp
from ..ops.adjoint import resolve_grad_engine
from ..ops.kalman import deviance as _deviance
from ..ops.lanes import lanes_deviance, lanes_statespace, prepare_data
from ..ops.lanes_products import (
    _forecast_lanes,
    _innovations_lanes,
    _sample_lanes,
    _smooth_lanes,
    draw_major,
    sample_normals,
)
from . import lanes_lbfgs

logger = getLogger(__name__)

ALPHA_PMIN = 1e-5  # reference lower bound for alpha (metran/metran.py:446-462)
ALPHA_INIT = 10.0  # reference initial value


class Fleet(NamedTuple):
    """A batch of independent DFMs padded to common static shapes.

    Attributes
    ----------
    y : (B, T, N) standardized observations (0 where masked).
    mask : (B, T, N) bool, True where observed.
    loadings : (B, N, K) factor loadings (0 rows/cols for padded slots).
    dt : (B,) grid step in days per model.
    n_series : (B,) true series count per model (before padding).
    t_steps : (B,) true timestep count per model, or ``None``.
    n_factors : (B,) true common-factor count per model, or ``None``.
    """

    y: torch.Tensor
    mask: torch.Tensor
    loadings: torch.Tensor
    dt: torch.Tensor
    n_series: torch.Tensor
    t_steps: Optional[torch.Tensor] = None
    n_factors: Optional[torch.Tensor] = None

    @property
    def batch(self) -> int:
        return self.y.shape[0]

    @property
    def n_params(self) -> int:
        return self.loadings.shape[1] + self.loadings.shape[2]


class FleetFit(NamedTuple):
    """Result of a fleet fit.

    Attributes
    ----------
    params : (B, N+K) optimal ``[alpha_sdf..., alpha_cdf...]`` per model.
    deviance : (B,) -2 log L at the optimum.
    iterations : (B,) L-BFGS iterations used.
    converged : (B,) bool — the gradient-norm test fired or the lane
        froze at the objective's resolution floor (``stalled``).
    stalled : (B,) bool — the subset of ``converged`` that stopped via
        the resolution-floor stall stop.
    nfev : (B,) objective evaluations per lane.
    """

    params: torch.Tensor
    deviance: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    stalled: Optional[torch.Tensor] = None
    nfev: Optional[torch.Tensor] = None


def pack_fleet(
    panels: Sequence[Panel],
    loadings: Sequence[np.ndarray],
    pad_batch_to: Optional[int] = None,
    dtype=None,
    device=None,
) -> Fleet:
    """Pad heterogeneous models into one :class:`Fleet` with static
    shapes, on ``device`` (default: the CUDA card).

    ``pad_batch_to`` pads the fleet axis with all-masked dummy models;
    ``dtype`` (a torch dtype, default float64) is the working precision.
    """
    if len(panels) != len(loadings):
        raise ValueError("panels and loadings must have the same length")
    device = resolve_device(device)
    dtype = dtype or torch.float64
    b = len(panels)
    bp = max(pad_batch_to or b, b)
    t = max(p.n_timesteps for p in panels)
    n = max(p.n_series for p in panels)
    k = max(np.atleast_2d(ld).shape[1] for ld in loadings)

    y = np.zeros((bp, t, n))
    mask = np.zeros((bp, t, n), bool)
    lds = np.zeros((bp, n, k))
    dt = np.ones(bp)
    n_series = np.full(bp, n, np.int32)
    n_factors = np.full(bp, k, np.int32)
    t_steps = np.full(bp, t, np.int32)
    for i, (panel, ld) in enumerate(zip(panels, loadings)):
        ti, ni = panel.n_timesteps, panel.n_series
        ld = np.atleast_2d(np.asarray(ld, np.float64))
        y[i, :ti, :ni] = panel.values
        mask[i, :ti, :ni] = panel.mask
        lds[i, :ni, : ld.shape[1]] = ld
        dt[i] = panel.dt
        n_series[i] = ni
        n_factors[i] = ld.shape[1]
        t_steps[i] = ti
    floats = [torch.as_tensor(a, dtype=dtype, device=device)
              for a in (y, lds, dt)]
    ints = [torch.as_tensor(a, device=device)
            for a in (n_series, t_steps, n_factors)]
    return Fleet(floats[0], torch.as_tensor(mask, device=device), *floats[1:],
                 *ints)


def _on_device(fleet: Fleet, device=None) -> Fleet:
    """``fleet`` with tensor fields on ``device`` (default: the device
    of ``fleet.y`` when it is a tensor, else the CUDA card)."""
    device = resolve_device(device, fleet.y)
    return Fleet(*(None if a is None else as_tensor(a, device)
                   for a in fleet))


def _lanes_args(params, fleet: Fleet, device=None):
    """``(params (P, B), data, loadings (N, K, B), dt (B,))`` for the
    lanes deviance.  The observations keep the fleet's (B, T, N) layout,
    which is the kernels' own, so nothing of size T is transposed; this
    runs once per fit."""
    fleet = _on_device(fleet, device)
    dtype = fleet.y.dtype
    data = prepare_data(fleet.y, fleet.mask)
    return (as_tensor(params, fleet.y.device, dtype).T, data,
            fleet.loadings.to(dtype).permute(1, 2, 0), fleet.dt.to(dtype))


def _lanes_score(grad) -> str:
    """Map a gradient-engine request onto the lanes ``score`` (its
    closed-form (phi, q) adjoint IS the adjoint engine of the lane
    layout; ``auto`` resolves to it)."""
    return ("autodiff" if resolve_grad_engine(grad, "sequential")
            == "autodiff" else "adjoint")


def _not_ported(what: str, where: str):
    return NotImplementedError(
        f"{what} is not ported yet ({where}); the port fits "
        "layout='batch' or layout='lanes' on one card")


def _check_layout(layout: str) -> None:
    if layout not in ("batch", "lanes"):
        raise ValueError(f"unknown layout {layout!r}")


def _model_deviance(p, y, mask, loadings, dt, warmup, engine,
                    remat_seg=None, grad=None):
    """(B,) deviance of a batch of fleet members (every argument leads
    with B); ``p = [alpha_sdf (N), alpha_cdf (K)]`` per row.  One filter
    launch for the batch (and, differentiated, one backward launch)."""
    from ..ops.statespace import dfm_statespace

    n = loadings.shape[-2]
    ss = dfm_statespace(p[:, :n], p[:, n:], loadings, dt)
    return _deviance(ss, y, mask, warmup=warmup, engine=engine,
                     remat_seg=remat_seg, grad=grad)


def _batch_args(params, fleet: Fleet, device=None):
    """``(params, y, mask, loadings, dt)`` batch-leading, on the fleet's
    device, in its dtype."""
    fleet = _on_device(fleet, device)
    dtype = fleet.y.dtype
    return (as_tensor(params, fleet.y.device, dtype), fleet.y, fleet.mask,
            fleet.loadings.to(dtype), fleet.dt.to(dtype))


def fleet_deviance(params, fleet: Fleet, warmup: int = 1,
                   engine: str = "joint", layout: str = "batch",
                   remat_seg: Optional[int] = None, grad=None,
                   device=None) -> torch.Tensor:
    """(B,) deviance of every fleet member at ``params`` (B, N+K).

    ``layout="batch"`` evaluates ``engine``'s deviance of the whole batch
    in one filter launch (K1 for ``"joint"``, K9 for ``"sqrt"``, K3 for
    ``"sequential"``); ``layout="lanes"`` the lanes deviance
    (sequential-processing semantics; ``engine`` is ignored there).
    ``grad`` picks the gradient engine when the value is differentiated.
    """
    _check_layout(layout)
    if layout == "batch":
        return _model_deviance(*_batch_args(params, fleet, device), warmup,
                               engine, remat_seg, grad)
    alpha_t, data, loadings_l, dt_l = _lanes_args(params, fleet, device)
    return lanes_deviance(alpha_t, loadings_l, dt_l, data, None, warmup,
                          remat_seg, _lanes_score(grad))


def fleet_value_and_grad(params, fleet: Fleet, warmup: int = 1,
                         engine: str = "joint", layout: str = "batch",
                         remat_seg: Optional[int] = None, grad=None,
                         device=None):
    """Per-model ``(deviance (B,), gradient (B, N+K))``: one forward and
    one backward pass (deviances are separable across the fleet, so the
    gradient of their sum is every model's).  ``layout="batch"``: the
    engine's filter with segment boundaries and, for ``grad`` resolving
    to ``"adjoint"``, the closed-form adjoint K11 (K4 for
    ``"sequential"``); ``layout="lanes"``: K3 and K4."""
    _check_layout(layout)
    from ..models.lbfgs import value_and_grad_rows

    if layout == "batch":
        p, *rows = _batch_args(params, fleet, device)
        return value_and_grad_rows(_model_deviance, p, *rows, warmup, engine,
                                   remat_seg, grad)
    alpha_t, data, loadings_l, dt_l = _lanes_args(params, fleet, device)
    val, grad_t = value_and_grad_rows(
        lanes_deviance, alpha_t, loadings_l, dt_l, data, None, warmup,
        remat_seg, _lanes_score(grad))
    return val, grad_t.T


def default_init_params(fleet: Fleet) -> torch.Tensor:
    """Reference initial parameter values (alpha = 10) for every model."""
    return torch.full((fleet.batch, fleet.n_params), ALPHA_INIT,
                      dtype=fleet.y.dtype, device=fleet.y.device)


ALPHA_INIT_MIN = 1.0  # clamp range for the data-driven init: keeps the
ALPHA_INIT_MAX = 200.0  # start point well inside the interior regime


def autocorr_init_params(fleet: Fleet) -> torch.Tensor:
    """Data-driven initial parameters from lag-1 autocorrelations.

    An AR(1) state with decay ``phi = exp(-dt/alpha)`` has lag-1
    autocorrelation ``phi``; per model:

    - specific states: ``phi_i^hat = r1`` of series ``i`` over its
      consecutive-observed pairs;
    - common factors: ``r1`` of the loading-weighted factor proxy
      ``f_kt = sum_i L_ik y_it / sum_i L_ik^2``, de-attenuated for the
      specific noise it carries.

    Estimates are clamped to ``alpha in (ALPHA_INIT_MIN,
    ALPHA_INIT_MAX)``; non-estimable slots (padded series, zero
    loadings, fewer than 8 consecutive pairs) get ``ALPHA_INIT``.
    """
    return _autocorr_init(fleet.y, fleet.mask, fleet.loadings, fleet.dt)


def _autocorr_init(y, mask, loadings, dt):
    dtype = y.dtype

    def lag1(x, valid):
        """Per-(B, column) lag-1 autocorrelation over consecutive valid
        pairs; returns (r1, n_pairs).  x is (B, T, C), valid bool."""
        x = torch.where(valid, x, 0.0)
        pair = valid[:, 1:] & valid[:, :-1]  # (B, T-1, C)
        num = torch.sum(torch.where(pair, x[:, 1:] * x[:, :-1], 0.0), dim=1)
        den = torch.sqrt(
            torch.sum(torch.where(pair, x[:, 1:] ** 2, 0.0), dim=1)
            * torch.sum(torch.where(pair, x[:, :-1] ** 2, 0.0), dim=1)
        )
        n_pairs = pair.sum(dim=1)
        return (torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                            0.0), n_pairs)

    r1_s, pairs_s = lag1(y, mask)  # (B, N)
    maskf = mask.to(dtype)
    norm = torch.einsum("btn,bnk->btk", maskf, loadings**2)  # (B, T, K)
    proxy = torch.einsum("btn,bnk->btk", torch.where(mask, y, 0.0), loadings)
    proxy = torch.where(norm > 0, proxy / torch.where(norm > 0, norm, 1.0),
                        0.0)
    r1_c, pairs_c = lag1(proxy, norm > 0)  # (B, K)
    comm = torch.sum(loadings**2, dim=2)  # (B, N)
    noise_w = loadings**2 * torch.clamp(1.0 - comm, 0.0, 1.0)[:, :, None]
    v_num = torch.einsum("btn,bnk->btk", maskf, noise_w)
    v_t = torch.where(norm > 0,
                      v_num / torch.where(norm > 0, norm, 1.0) ** 2, 0.0)
    v = v_t.sum(dim=1) / torch.clamp((norm > 0).sum(dim=1), min=1)
    w = torch.sum(noise_w, dim=1)  # (B, K)
    phi_w = torch.where(
        w > 0,
        torch.einsum("bn,bnk->bk", r1_s, noise_w) / torch.where(w > 0, w, 1.0),
        0.0,
    )
    # observation rate over REAL series only; a float64 ratio of counts,
    # as the JAX package computes it
    active = torch.any(mask, dim=1)  # (B, N)
    n_active = torch.clamp(active.sum(dim=1), min=1)  # (B,)
    obs_rate = (mask.sum(dim=(1, 2)).to(torch.float64)
                / (mask.shape[1] * n_active).to(torch.float64))[:, None]
    r1_c = r1_c * (1.0 + v) - v * obs_rate * phi_w

    # r1_c is float64 here (the count ratio promotes it), as in the JAX
    # package; the result is cast back to the fleet dtype at the end
    r1 = torch.cat([r1_s.to(r1_c.dtype), r1_c], dim=1)
    pairs = torch.cat([pairs_s, pairs_c], dim=1)
    dtc = dt[:, None].to(dtype)
    phi_lo = torch.exp(-dtc / ALPHA_INIT_MIN).to(r1.dtype)
    phi_hi = torch.exp(-dtc / ALPHA_INIT_MAX).to(r1.dtype)
    alpha = -dtc / torch.log(torch.clamp(r1, phi_lo, phi_hi))
    k = loadings.shape[2]
    estimable = pairs >= 8
    estimable[:, -k:] &= torch.any(loadings != 0, dim=1)
    return torch.where(estimable, alpha, ALPHA_INIT).to(dtype)


ALPHA_MAX = 3e4  # soft upper cap on alpha during fleet optimization


def _soft_cap(theta, cap):
    """Smooth monotone map R -> (-inf, cap): near-identity far below
    the cap (``cap - softplus(cap - theta)``; softplus as
    ``logaddexp(x, 0)``, which has no identity cut-over)."""
    x = cap - theta
    return cap - torch.logaddexp(x, torch.zeros_like(x))


def _theta_to_alpha(theta, cap):
    return ALPHA_PMIN + torch.exp(_soft_cap(theta, cap))


def _alpha_to_theta(p, cap):
    """Exact inverse of :func:`_theta_to_alpha` (clamped just below cap)."""
    t = torch.log(torch.clamp(p - ALPHA_PMIN, min=1e-12))
    t = torch.clamp(t, max=cap - 1e-6)
    # invert t = cap - softplus(cap - theta):  theta = cap - log(expm1(cap-t))
    return cap - torch.log(torch.expm1(cap - t))


def _make_lanes_runner(warmup, tol, chunk, maxiter, ls_steps, history,
                       theta_cap, remat_seg, stall_tol=None, stall_rtol=0.0,
                       score="adjoint"):
    """``(init, run_chunk)`` of the lane-layout batched L-BFGS.

    Both take ``(theta or state, data, loadings, dt, lane_map)``: the
    objective is the lanes deviance of the lanes ``lane_map`` selects in
    ``data``; K trial points are one call over K*B lanes, and the
    gradient is one backward against a ones-vector.
    """
    from ..models.lbfgs import value_and_grad_rows

    def deviance(theta, data, loadings, dt, lane_map):
        alpha = _theta_to_alpha(theta, theta_cap)
        return lanes_deviance(alpha, loadings, dt, data, lane_map, warmup,
                              remat_seg, score)

    def obj_fn(cand, data, loadings, dt, lane_map):
        # trial-major lanes: lane k*B + b is trial k of lane b
        n_trials, p, b = cand.shape
        with torch.no_grad():
            val = deviance(cand.permute(1, 0, 2).reshape(p, n_trials * b),
                           data, loadings.repeat(1, 1, n_trials),
                           dt.repeat(n_trials), lane_map.repeat(n_trials))
        return val.reshape(n_trials, b)

    def vg_fn(theta, data, loadings, dt, lane_map):
        return value_and_grad_rows(deviance, theta, data, loadings, dt,
                                   lane_map)

    def init(theta, *data):
        return lanes_lbfgs.init_state(vg_fn, theta, history, *data)

    run_chunk = lanes_lbfgs.make_chunk_runner(
        vg_fn, obj_fn, ls_steps, maxiter, tol, chunk, stall_tol, stall_rtol)
    return init, run_chunk


def _gather_lanes(tree, idx):
    """Take lanes ``idx`` along the LAST axis of every leaf."""
    return type(tree)(*(a.index_select(-1, idx) for a in tree))


def _scatter_lanes(full, part, idx):
    """Write lanes ``part`` back into ``full`` at ``idx`` (last axis)."""
    out = []
    for f, p in zip(full, part):
        f = f.clone()
        f[..., idx] = p
        out.append(f)
    return type(full)(*out)


COMPACT_MIN = 128  # the JAX package's floor (one TPU lane tile), kept
#                    for parity: compaction never changes results


def _fit_fleet_lanes(fleet, p0, warmup, maxiter, tol, chunk,
                     max_linesearch_steps, alpha_max, stall_tol, remat_seg,
                     history=8, max_chunks=None, compact_min=COMPACT_MIN,
                     stall_rtol=0.0, score="adjoint"):
    """The lane-layout fleet fit loop (see ``fit_fleet(layout="lanes")``)."""
    theta_cap = float(np.log(alpha_max))
    ls_steps = lanes_lbfgs.default_ls_steps(min(max_linesearch_steps, 6))
    init, run_chunk = _make_lanes_runner(
        warmup, tol, chunk, maxiter, ls_steps, history, theta_cap,
        remat_seg, stall_tol, stall_rtol, score)
    # two-phase schedule: after the first full chunk, advance in short
    # tail dispatches so the run ends within ~tail iterations of the last
    # lane's convergence; with the per-iteration stall stop, chunking
    # cannot change results.  Under a dispatch budget (max_chunks) every
    # dispatch advances a full chunk.
    tail = chunk if max_chunks is not None else min(2, chunk)
    run_tail = run_chunk if tail == chunk else _make_lanes_runner(
        warmup, tol, tail, maxiter, ls_steps, history, theta_cap,
        remat_seg, stall_tol, stall_rtol, score)[1]
    device = fleet.y.device
    theta0 = _alpha_to_theta(as_tensor(p0, device, fleet.y.dtype), theta_cap)
    theta_t, data, loadings_l, dt_l = _lanes_args(theta0, fleet)
    lane_map = torch.arange(fleet.batch, dtype=torch.int32, device=device)
    lane_args = (loadings_l, dt_l, lane_map)
    state = init(theta_t, data, *lane_args)

    iters_left = maxiter
    dispatches = 0
    sel = sel_dev = None  # original lane indices of the compacted set
    work_state, work_args = state, lane_args

    def full_state():
        """The working set scattered over the last full snapshot (lanes
        dropped at earlier compactions kept their final values)."""
        if sel is None:
            return work_state
        return _scatter_lanes(state, work_state, sel_dev)

    while iters_left > 0:
        if max_chunks is not None and dispatches >= max_chunks:
            break
        if dispatches == 0 and iters_left >= chunk:
            work_state = run_chunk(work_state, data, *work_args)
            iters_left -= chunk
        else:
            work_state = run_tail(work_state, data, *work_args)
            iters_left -= tail
        dispatches += 1
        frozen_host = work_state.frozen.cpu().numpy()
        if frozen_host.all():
            break
        # tail compaction: once most of the working set is frozen, gather
        # the live lanes into a power-of-two sub-batch (>= compact_min) so
        # tail dispatches stop paying for finished lanes; lanes never
        # interact, so results equal the uncompacted schedule.  The data
        # is not copied: the working lanes read it through lane_map.
        live = np.flatnonzero(~frozen_host)
        bw = frozen_host.size
        target = max(compact_min,
                     1 << int(np.ceil(np.log2(max(live.size, 1)))))
        if target < bw:
            state = full_state()
            frozen_idx = np.flatnonzero(frozen_host)
            local = np.concatenate([live, frozen_idx[: target - live.size]])
            sel_prev = np.arange(bw) if sel is None else sel
            sel = sel_prev[local]
            sel_dev = torch.as_tensor(sel, device=device)
            work_state = _gather_lanes(state, sel_dev)
            work_args = (loadings_l.index_select(-1, sel_dev),
                         dt_l.index_select(0, sel_dev),
                         lane_map.index_select(0, sel_dev))
    state = full_state()
    params = _theta_to_alpha(state.theta, theta_cap).T  # (B, N+K)
    grad_ok = torch.linalg.vector_norm(state.grad, dim=0) < tol
    # the device-side stall counter is part of the carry, so "frozen at
    # the resolution floor" is recorded exactly
    stalled = (state.stall >= lanes_lbfgs.STALL_ITERS) & ~grad_ok
    return FleetFit(params, state.value, state.count, grad_ok | stalled,
                    stalled, state.nfev)


def default_gtol(dtype) -> float:
    """Default gradient-norm tolerance resolvable in ``dtype``:
    ``sqrt(machine eps)``, 1.5e-8 in float64 and 3.5e-4 in float32."""
    return float(np.sqrt(torch.finfo(dtype).eps))


def fit_fleet(
    fleet: Fleet,
    p0=None,
    warmup: int = 1,
    engine: str = "joint",
    maxiter: int = 100,
    tol: Optional[float] = None,
    mesh=None,
    use_shard_map: bool = False,
    chunk: Optional[int] = None,
    max_linesearch_steps: int = 16,
    alpha_max: float = ALPHA_MAX,
    stall_tol: Optional[float] = None,
    stall_rtol: float = 0.0,
    checkpoint: Optional[str] = None,
    layout: str = "batch",
    remat_seg: Optional[int] = None,
    max_chunks: Optional[int] = None,
    compact_min: int = COMPACT_MIN,
    lane_min_batch: Optional[int] = None,
    grad_engine: Optional[str] = None,
) -> FleetFit:
    """Fit every model in the fleet by batched L-BFGS on its device.

    The JAX package's signature and defaults.  The fleet's tensors
    decide the device: a fleet packed for the card fits there, a CPU
    fleet runs the kernels' plain versions.  The optimizer advances in
    chunks of ``chunk`` iterations; the host checks convergence between
    chunks and stops when every model is done.

    Parameters
    ----------
    fleet : packed fleet (see :func:`pack_fleet`).
    p0 : (B, N+K) initial parameters (default: reference init, alpha=10).
    engine : ``layout="batch"``: "joint" (the default; K1 forward, K11
        backward), "sequential" (K3/K4) or "sqrt" (K9 forward, K11
        backward).  ``layout="lanes"``: "sequential" or "joint", both the
        lanes sequential-processing deviance.
    tol : gradient-norm convergence tolerance (default ``sqrt(eps)`` of
        the fleet dtype).
    chunk : L-BFGS iterations per dispatch (default: maxiter; with the
        batch layout's stall stop on, ``min(20, maxiter - 1)``, since
        the stop is evaluated between chunks).
    max_linesearch_steps : the batch layout's cap on zoom line-search
        evaluations per iteration; the trial points of the lanes
        layout's grid line search (at most 6 are used).
    alpha_max : soft upper cap on alpha during optimization.
    stall_tol, stall_rtol : freeze a lane whose objective changes by at
        most ``stall_tol + stall_rtol * max(|value|, 1)`` — across a
        whole chunk, two-sided, for ``layout="batch"``; per iteration
        for ``"lanes"`` — counting it converged (``FleetFit.stalled``).
        ``stall_tol=None``: off in float64, ``0.0`` in float32.
    layout : "batch" (fleet axis leading, optax's zoom-line-search
        L-BFGS) or "lanes" (the lane-layout kernels and the grid
        line-search L-BFGS).  Both converge to the same optima; their
        line searches differ.
    remat_seg : segment length of the adjoint's boundaries (memory
        O(T/seg) boundaries plus one segment's replay per model).
    max_chunks : bound the number of chunk dispatches of this call.
    compact_min : (``layout="lanes"``) smallest power-of-two working set
        tail compaction may shrink to; results are identical for any
        value.
    grad_engine : ``"auto"``/``"adjoint"``/``"autodiff"`` (default
        ``METRAN_TPU_GRAD_ENGINE``), resolved for ``engine`` and the
        fleet dtype as in the JAX package; ``"autodiff"`` runs on CPU
        fleets only (a float32 ``engine="sqrt"`` fit on the card needs
        ``grad_engine="adjoint"``).

    mesh : a :class:`~metran_tpu_torch.parallel.mesh.Mesh`; the fleet axis
        splits into ``mesh.size`` shards (``fleet.batch`` must be a
        multiple), each fitted by the layout's fit loop on its device, the
        results gathered on the mesh's first device.
    use_shard_map : accepted for the JAX signature; every mesh fit here is
        per-shard (the ``shard_map`` form), and the lanes layout ignores it
        with a warning.
    lane_min_batch : accepted for the JAX signature and ignored.  The JAX
        package pads a tiny lanes fleet to a TPU lane tile by replicating
        models (duplicate lanes converge identically, so no result
        changes); the port's lanes run at any width and need no pad.

    ``checkpoint`` (ROADMAP A3) raises ``NotImplementedError``.
    """
    _check_layout(layout)
    fleet = _on_device(fleet)
    if checkpoint is not None:
        raise _not_ported("checkpoint",
                          "ROADMAP A3, io.save_fleet_state/load_fleet_state")
    if layout == "lanes" and engine not in ("sequential", "joint"):
        raise ValueError(f"unknown engine {engine!r}")
    if p0 is None:
        p0 = default_init_params(fleet)
    dtype = fleet.y.dtype
    is_f32 = dtype == torch.float32
    if tol is None:
        tol = default_gtol(dtype)
    if stall_tol is None and is_f32:
        # float32 runs terminate at the objective resolution floor: freeze
        # lanes that make zero resolvable progress (counted converged)
        stall_tol = 0.0
    if not np.isfinite(alpha_max) or alpha_max <= ALPHA_PMIN:
        raise ValueError(
            f"alpha_max must be finite and > {ALPHA_PMIN}, got {alpha_max}")
    stall_on = (stall_tol is not None and stall_tol >= 0) or stall_rtol > 0
    if chunk is None and layout == "batch" and stall_on:
        # the batch layout's stall stop runs host-side BETWEEN chunks, so
        # a single maxiter-sized dispatch would never evaluate it
        chunk = max(1, min(20, maxiter - 1))
    if chunk is None or chunk >= maxiter:
        chunk = maxiter
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if mesh is not None and fleet.batch % mesh.size:
        raise ValueError(
            f"mesh size {mesh.size} must divide the fleet batch "
            f"{fleet.batch}; pad with pack_fleet(..., pad_batch_to="
            f"pad_to_multiple({fleet.batch}, {mesh.size}))")
    if layout == "batch":
        grad = resolve_grad_engine(grad_engine, engine, dtype=dtype)

        def fit(part, p):
            return _fit_fleet_batch(
                part, p, warmup, engine, maxiter, tol, chunk,
                max_linesearch_steps, alpha_max, stall_tol, stall_rtol,
                remat_seg, max_chunks, grad)

        return fit(fleet, p0) if mesh is None else _fit_sharded(
            mesh, fleet, p0, fit)
    if use_shard_map:
        logger.warning("layout='lanes' shards the lanes over the mesh "
                       "itself; use_shard_map is ignored")
    grad = resolve_grad_engine(grad_engine, "sequential", dtype=dtype)

    def fit(part, p):
        return _fit_fleet_lanes(
            part, p, warmup, maxiter, tol, chunk, max_linesearch_steps,
            alpha_max, stall_tol, remat_seg, max_chunks=max_chunks,
            compact_min=compact_min, stall_rtol=stall_rtol, score=grad)

    return fit(fleet, p0) if mesh is None else _fit_sharded(mesh, fleet, p0,
                                                            fit)


def _fit_sharded(mesh, fleet: Fleet, p0, fit) -> FleetFit:
    """``fit(shard, p0_shard)`` on each of the mesh's devices over its
    even slice of the fleet axis, gathered in order on the mesh's first
    device.  On the card every shard runs in a host thread of its own on
    a stream of its own (distinct cards side by side; the shards of a
    virtual mesh overlap on one card), so a shard's host syncs wait on its
    own kernels only; on the CPU the shards run in turn."""
    devices = mesh.flat_devices()
    per = fleet.batch // len(devices)
    p0 = as_tensor(p0, fleet.y.device, fleet.y.dtype)
    parts = []
    for k, dev in enumerate(devices):
        rows = slice(k * per, (k + 1) * per)
        parts.append((Fleet(*(None if a is None else a[rows].to(dev)
                              for a in fleet)), p0[rows].to(dev)))
    if devices[0].type != "cuda":
        results = [fit(*part) for part in parts]
    else:
        streams = [torch.cuda.Stream(device=dev) for dev in devices]
        for st, dev in zip(streams, devices):
            st.wait_stream(torch.cuda.current_stream(dev))

        def run(k):
            with torch.cuda.device(devices[k]), torch.cuda.stream(
                    streams[k]):
                return fit(*parts[k])

        with ThreadPoolExecutor(max_workers=len(devices)) as pool:
            results = list(pool.map(run, range(len(devices))))
        for st, dev in zip(streams, devices):
            torch.cuda.current_stream(dev).wait_stream(st)
    first = devices[0]
    return FleetFit(*(
        None if results[0][i] is None
        else torch.cat([r[i].to(first) for r in results], dim=0)
        for i in range(len(FleetFit._fields))))


# ----------------------------------------------------------------------
# the batch-layout fit (layout="batch")
# ----------------------------------------------------------------------
def _make_chunk_runner(fleet: Fleet, warmup, engine, tol, chunk, maxiter,
                       max_linesearch_steps, theta_cap, remat_seg=None,
                       grad=None):
    """``(advance, outputs)`` of the batch-layout fit (the JAX
    package's ``_make_chunk_runner``, ``_solve_chunk`` and
    ``_chunk_outputs``).

    ``advance(theta, state, frozen, nfev)`` runs up to ``chunk`` L-BFGS
    iterations of every lane (a ``frozen`` lane takes none, so its
    result does not depend on what else shares the batch); each
    line-search round evaluates the lanes still searching in ONE
    objective call — their rows of the fleet, one filter launch with
    segment boundaries and one backward launch.
    ``outputs(theta, state)`` gives ``(params, value, count, gnorm <
    tol)``.
    """
    from ..models import lbfgs as _lbfgs

    data = (fleet.y, fleet.mask, fleet.loadings.to(fleet.y.dtype),
            fleet.dt.to(fleet.y.dtype))
    full = torch.arange(fleet.batch, device=fleet.y.device)

    def deviance(theta, *rows):
        return _model_deviance(_theta_to_alpha(theta, theta_cap), *rows,
                               warmup, engine, remat_seg, grad)

    def objective(theta, lanes):
        rows = data if torch.equal(lanes, full) else tuple(
            d.index_select(0, lanes) for d in data)
        return _lbfgs.value_and_grad_rows(deviance, theta, *rows)

    def advance(theta, state, frozen, nfev):
        lane_maxiter = torch.where(frozen, torch.zeros_like(state.count),
                                   torch.full_like(state.count, maxiter))
        return _lbfgs.lbfgs_advance(objective, theta, state, tol,
                                    lane_maxiter, chunk, nfev,
                                    max_linesearch_steps)

    def outputs(theta, state):
        return (_theta_to_alpha(theta, theta_cap), state.value, state.count,
                _lbfgs.grad_norm(state) < tol)

    return advance, outputs


def _fit_fleet_batch(fleet, p0, warmup, engine, maxiter, tol, chunk,
                     max_linesearch_steps, alpha_max, stall_tol, stall_rtol,
                     remat_seg, max_chunks, grad):
    """The batch-layout fit loop (see ``fit_fleet(layout="batch")``)."""
    from ..models import lbfgs as _lbfgs

    theta_cap = float(np.log(alpha_max))
    advance, outputs = _make_chunk_runner(
        fleet, warmup, engine, tol, chunk, maxiter, max_linesearch_steps,
        theta_cap, remat_seg, grad)
    device = fleet.y.device
    theta = _alpha_to_theta(as_tensor(p0, device, fleet.y.dtype), theta_cap)
    state = _lbfgs.init(theta)
    frozen = torch.zeros(fleet.batch, dtype=torch.bool, device=device)
    nfev = torch.zeros(fleet.batch, dtype=torch.int32, device=device)
    prev_value = None
    n_chunks = max(-(-maxiter // chunk), 1)
    if max_chunks is not None:
        n_chunks = min(n_chunks, max_chunks)
    for _ in range(n_chunks):
        theta, state, nfev = advance(theta, state, frozen, nfev)
        if chunk >= maxiter:
            break
        count = state.count.cpu().numpy()
        value = state.value.cpu().numpy()
        err = _lbfgs.grad_norm(state).cpu().numpy()
        done = (err < tol) | (count >= maxiter)
        stall_on = stall_tol is not None or stall_rtol > 0
        if stall_on and prev_value is not None:
            # two-sided: freeze only lanes whose value CHANGED by at most
            # the threshold over the chunk.  A lane that regressed beyond
            # it (a line-search failure excursion) keeps running; a
            # frozen lane takes no further iterations, so its result
            # never depends on what else shares the batch
            thresh = (stall_tol or 0.0) + stall_rtol * np.maximum(
                np.abs(value), 1.0)
            frozen_host = frozen.cpu().numpy() | (
                np.abs(value - prev_value) <= thresh)
            done |= frozen_host
            frozen = torch.as_tensor(frozen_host, device=device)
        prev_value = value
        if done.all():
            break
    params, value, count, conv = outputs(theta, state)
    # frozen is only ever set by the stall bookkeeping above, so the
    # floor-frozen subset is exactly the frozen lanes the gradient test
    # does not explain; a non-finite lane is divergence, never either
    err = _lbfgs.grad_norm(state).cpu().numpy()
    finite = np.isfinite(value.cpu().numpy())
    stalled = frozen.cpu().numpy() & ~(err < tol) & finite
    conv = torch.as_tensor((conv.cpu().numpy() | stalled) & finite,
                           device=device)
    # a lane pinned at the soft cap is a cap-limited optimum, not an
    # interior one (the reference has no upper alpha bound)
    at_cap = (params >= 0.5 * alpha_max).cpu().numpy()
    if at_cap.any():
        capped_rows = np.flatnonzero(at_cap.any(axis=-1))
        logger.warning(
            "fleet lanes %s have parameters at/near the alpha soft cap "
            "(alpha_max=%g); their optima are cap-limited, not interior "
            "(raise alpha_max to compare with an uncapped fit)",
            capped_rows.tolist()[:20], alpha_max,
        )
    return FleetFit(params, value, count, conv,
                    torch.as_tensor(stalled, device=device))



# ----------------------------------------------------------------------
# post-fit products (layout="lanes")
# ----------------------------------------------------------------------
def _check_products_layout(layout: str, engine: str = "joint") -> None:
    if layout not in ("lanes", "batch"):
        raise ValueError(
            f"unknown layout {layout!r}; expected 'lanes' or 'batch'")
    if layout == "batch":
        raise NotImplementedError(
            "layout='batch' for the fleet products is not ported yet "
            "(ROADMAP A2: the joint store and the batch-layout products); "
            "use layout='lanes'")
    if engine != "joint":
        # loud, not silent: the lanes products always use sequential-
        # processing semantics (same numbers, different layout), so an
        # explicitly requested engine would otherwise be a no-op
        logger.warning(
            "engine=%r is ignored with layout='lanes' (lane products "
            "use sequential-processing semantics; the batch layout that "
            "honors the engine is not ported yet)", engine,
        )


def _lanes_ss_chunk(p, loadings, dt):
    """Lane-layout state space of a batch-leading chunk: ``p`` (B, N+K),
    ``loadings`` (B, N, K), ``dt`` (B,)."""
    return lanes_statespace(p.T, loadings.permute(1, 2, 0), dt)


def _run_chunked(run, params, fleet: Fleet, batch_chunk, extras=(),
                 device=None):
    """Host-driven loop of fixed-shape dispatches over the fleet axis;
    outputs are concatenated on the device and trimmed to the true
    batch.  A short tail chunk is padded with edge-replicated models (a
    real model: zero dt/params would put NaNs through the padded lanes).
    ``extras`` are (B, ...) tensors passed to ``run`` after the fleet's
    ``(params, y, mask, loadings, dt)``."""
    fleet = _on_device(fleet, device)
    dtype = fleet.y.dtype
    params = as_tensor(params, fleet.y.device, dtype)
    arrays = (params, fleet.y, fleet.mask.to(torch.bool),
              fleet.loadings.to(dtype), fleet.dt.to(dtype), *extras)
    b = fleet.batch
    chunk = b if batch_chunk is None else min(max(int(batch_chunk), 1), b)

    def sliced(a, i):
        part = a[i:i + chunk]
        pad = chunk - part.shape[0]
        if pad:
            part = torch.cat([part, part[-1:].expand(pad, *part.shape[1:])])
        return part.contiguous()

    outs = [run(*(sliced(a, i) for a in arrays)) for i in range(0, b, chunk)]
    return tuple(torch.cat([o[j] for o in outs])[:b]
                 for j in range(len(outs[0])))


def fleet_simulate(params, fleet: Fleet, engine: str = "joint",
                   smooth: bool = True, batch_chunk: Optional[int] = None,
                   layout: str = "lanes", seg: int = 100, device=None):
    """Observation-space projections for every fleet member: ``(means,
    variances)`` of shape (B, T, N), per-timestep ``Z x_t`` and
    ``diag(Z P_t Z')`` of the smoothed (``smooth``) or filtered states,
    in standardized units (reference ``simulate``,
    ``metran/kalmanfilter.py:569-603``).

    The smoother is the Durbin-Koopman univariate backward recursion (K3
    with ``seg``-step segment boundaries, then K5), the filtered path K6.
    ``engine`` is ignored (sequential-processing semantics, like the
    fit).  The fleet runs in ``batch_chunk``-model dispatches (default:
    one); padded series slots and models give inert zero-mean
    projections.
    """
    _check_products_layout(layout, engine)

    def run(p, y, mask, loadings, dt):
        phi, q, z, r = _lanes_ss_chunk(p, loadings, dt)
        if smooth:
            _, pm, pv = _smooth_lanes(phi, q, z, r, y, mask, seg, True)
        else:
            _, pm, pv = kp.lanes_forward(phi, q, z, r, y, mask, "project")
        return pm, pv

    return _run_chunked(run, params, fleet, batch_chunk, device=device)


def fleet_decompose(params, fleet: Fleet, engine: str = "joint",
                    smooth: bool = True, batch_chunk: Optional[int] = None,
                    layout: str = "lanes", seg: int = 100, device=None):
    """Per-member decomposition into the specific part ``Z[:, :N]
    x[:N]`` (B, T, N) and the per-factor parts (B, K, T, N) of the
    smoothed (or filtered) states (reference ``decompose``,
    ``metran/kalmanfilter.py:605-644``).  Chunking and ``layout`` as in
    :func:`fleet_simulate`; the smoother runs mean-only (K5 without the
    N recursion)."""
    _check_products_layout(layout, engine)

    def run(p, y, mask, loadings, dt):
        phi, q, z, r = _lanes_ss_chunk(p, loadings, dt)
        if smooth:
            ms, _, _ = _smooth_lanes(phi, q, z, r, y, mask, seg, False)
        else:
            ms, _, _ = kp.lanes_forward(phi, q, z, r, y, mask, "project")
        n = y.shape[2]
        # z = [I | loadings]: the specific block of the projection is the
        # first n smoothed states themselves
        cdf = (loadings.permute(0, 2, 1)[:, :, None, :]
               * ms[:, :, n:].permute(0, 2, 1)[:, :, :, None])
        return ms[:, :, :n], cdf

    return _run_chunked(run, params, fleet, batch_chunk, device=device)


def fleet_forecast(params, fleet: Fleet, steps: int, engine: str = "joint",
                   batch_chunk: Optional[int] = None, layout: str = "lanes",
                   device=None):
    """Out-of-sample forecasts ``(means, variances)`` of shape
    (B, steps, N) for every fleet member, each from ITS OWN data end
    (``fleet.t_steps``): K6 latches the filtered moments there, K2 gives
    the closed-form h-step moments.  Chunking and ``layout`` as in
    :func:`fleet_simulate`."""
    _check_products_layout(layout, engine)
    fleet = _on_device(fleet, device)
    t_last = (torch.full((fleet.batch,), fleet.y.shape[1], dtype=torch.int32,
                         device=fleet.y.device)
              if fleet.t_steps is None else fleet.t_steps.to(torch.int32))

    def run(p, y, mask, loadings, dt, tl):
        phi, q, z, r = _lanes_ss_chunk(p, loadings, dt)
        return _forecast_lanes(phi, q, z, r, y, mask, tl, int(steps))

    return _run_chunked(run, params, fleet, batch_chunk, extras=(t_last,))


def fleet_innovations(params, fleet: Fleet, standardized: bool = True,
                      engine: str = "joint",
                      batch_chunk: Optional[int] = None,
                      layout: str = "lanes", warmup: int = 0, device=None):
    """One-step-ahead joint innovations ``(v, f)`` of shape (B, T, N)
    for every fleet member (K6), NaN at masked/padded positions and
    before ``warmup`` (pass e.g. 50 before
    :func:`metran_tpu_torch.diagnostics.fleet_whiteness`).  Chunking
    and ``layout`` as in :func:`fleet_simulate`."""
    _check_products_layout(layout, engine)

    def run(p, y, mask, loadings, dt):
        phi, q, z, r = _lanes_ss_chunk(p, loadings, dt)
        return _innovations_lanes(phi, q, z, r, y, mask, bool(standardized),
                                  int(warmup))

    return _run_chunked(run, params, fleet, batch_chunk, device=device)


def fleet_sample_normals(fleet: Fleet, n_draws: int, seed: int,
                         device=None):
    """The standard normals ``fleet_sample(n_draws, seed)`` draws: ``x0``
    (B, D, n), ``w`` (B, D, T, n), ``e`` (B, D, T, N), every model's from
    one ``torch.Generator`` seeded ``seed`` on the fleet's device, in one
    model-major order over the whole fleet, before any chunking."""
    fleet = _on_device(fleet, device)
    dev = fleet.y.device
    b, t_steps, n_obs = fleet.y.shape
    gen = torch.Generator(dev).manual_seed(int(seed))
    return sample_normals(int(n_draws), b, t_steps, fleet.n_params, n_obs,
                          gen, fleet.y.dtype, dev)


def fleet_sample(params, fleet: Fleet, n_draws: int = 16, seed: int = 0,
                 engine: str = "joint", batch_chunk: Optional[int] = None,
                 draw_chunk: int = 8, project: bool = True,
                 layout: str = "lanes", seg: int = 100, device=None):
    """Joint posterior path draws for every fleet member: (B, n_draws,
    T, N) observation-space draws when ``project`` (each passing exactly
    through its member's observed entries, r = 0) or (B, n_draws, T,
    n_state) state draws.  Durbin-Koopman simulation smoother with one
    lane per (member, draw): a mean-only smoothing of the data, the path
    draw K7, a mean-only smoothing of its pseudo-observations.

    The normals come from :func:`fleet_sample_normals`, so each member's
    draws depend on ``seed`` and its index, not on ``batch_chunk``;
    draw-for-draw equality with the JAX package's RNG is not a contract,
    the distribution is.  ``draw_chunk`` is unused (all draws ride the
    lanes).  Padded members/slots give prior draws."""
    _check_products_layout(layout, engine)
    fleet = _on_device(fleet, device)
    normals = fleet_sample_normals(fleet, n_draws, seed)

    def run(p, y, mask, loadings, dt, x0, w, e):
        phi, q, z, r = _lanes_ss_chunk(p, loadings, dt)
        draws = _sample_lanes(phi, q, z, r, y, mask, draw_major(x0),
                              draw_major(w), draw_major(e), seg,
                              bool(project))  # (D, B, T, .)
        return (draws.transpose(0, 1),)

    (draws,) = _run_chunked(run, params, fleet, batch_chunk, extras=normals)
    return draws


# ----------------------------------------------------------------------
# standard errors (method="lanes-fd")
# ----------------------------------------------------------------------
def _pcov_stderr(hess):
    """``(stderr, pcov)`` from a (B, P, P) Hessian stack: ``pinv`` with
    the JAX package's cutoff (singular values at most ``10 P eps`` of
    the largest are dropped) and NaN stderr wherever the pcov diagonal
    is not positive."""
    rtol = 10.0 * hess.shape[-1] * torch.finfo(hess.dtype).eps
    pcov = torch.linalg.pinv(hess, rtol=rtol)
    diag = torch.diagonal(pcov, dim1=-2, dim2=-1)
    stderr = torch.where(diag > 0, torch.sqrt(torch.where(diag > 0, diag,
                                                          1.0)), torch.nan)
    return stderr, pcov


def _lanes_fd_hessian(p, y, mask, loadings, dt, warmup, remat_seg):
    """(B, P, P) central-difference Hessians of the lanes deviance at
    ``p`` (B, P), from the exact gradient (K3 forward, K4 backward) at
    the 2P points ``p +- h_j e_j`` of every model, model-major: lane
    ``b * 2P + k``, all reading data lane ``b`` through the lane map
    (one copy of the (B, T, N) data)."""
    b, n_p = p.shape
    dtype = p.dtype
    # per-parameter step cbrt(eps) * max(|p|, 1): the optimum for a
    # central difference of a gradient whose own error is rounding
    h = torch.finfo(dtype).eps ** (1.0 / 3.0) * torch.clamp(p.abs(), min=1.0)
    eye = torch.eye(n_p, dtype=dtype, device=p.device)
    pert = torch.cat([p[:, None, :] + h[:, :, None] * eye[None],
                      p[:, None, :] - h[:, :, None] * eye[None]], dim=1)
    reps = 2 * n_p
    data = prepare_data(y, mask)
    lane_map = torch.arange(b, dtype=torch.int32,
                            device=p.device).repeat_interleave(reps)
    loadings_l = loadings.permute(1, 2, 0).repeat_interleave(reps, dim=-1)
    dt_l = dt.repeat_interleave(reps)
    with torch.enable_grad():
        alpha = pert.reshape(b * reps, n_p).T.contiguous().requires_grad_(
            True)
        val = lanes_deviance(alpha, loadings_l, dt_l, data, lane_map,
                             warmup, remat_seg, "adjoint")
        (g,) = torch.autograd.grad(val.sum(), alpha)  # (P, B*2P)
    g = g.reshape(n_p, b, reps)
    gp, gm = g[..., :n_p], g[..., n_p:]  # (P_i, B, P_j)
    hess = (gp - gm).permute(1, 0, 2) / (2.0 * h[:, None, :])
    return 0.5 * (hess + hess.transpose(1, 2))


def fleet_stderr(params, fleet: Fleet, warmup: int = 1,
                 engine: str = "joint", remat_seg: Optional[int] = None,
                 batch_chunk: Optional[int] = None, method: str = "exact",
                 device=None):
    """Per-model parameter standard errors at ``params`` (B, N+K):
    ``(stderr (B, P), pcov (B, P, P))`` with ``pcov = pinv(Hessian of the
    deviance)`` (the reference's convention) and NaN stderr for
    non-positive curvature directions (parameters at the soft cap,
    padded slots).

    ``method="lanes-fd"`` is the ported one: central differences
    ``H[:, j] = (g(p + h_j e_j) - g(p - h_j e_j)) / (2 h_j)`` of the
    exact lanes gradient, symmetrized, with all 2P points of every
    model in one K3 + K4 pass over ``B * 2P`` lanes that read one copy
    of the data through the lane map.  ``method="exact"`` (the
    batch-layout forward-over-reverse Hessian) raises: ROADMAP A3 (the
    exact Hessian).  ``engine`` is ignored (sequential-processing
    semantics, as the fit); ``batch_chunk`` models per dispatch
    (default: all).
    """
    if method == "exact":
        raise NotImplementedError(
            "fleet_stderr(method='exact') is not ported yet (ROADMAP A3, "
            "the exact Hessian); use method='lanes-fd'")
    if method != "lanes-fd":
        raise ValueError(f"unknown method {method!r}")

    def run(p, y, mask, loadings, dt):
        return _pcov_stderr(_lanes_fd_hessian(p, y, mask, loadings, dt,
                                              warmup, remat_seg))

    return _run_chunked(run, params, fleet, batch_chunk, device=device)


__all__ = [
    "ALPHA_MAX",
    "Fleet",
    "FleetFit",
    "autocorr_init_params",
    "default_init_params",
    "fit_fleet",
    "fleet_decompose",
    "fleet_deviance",
    "fleet_forecast",
    "fleet_innovations",
    "fleet_sample",
    "fleet_sample_normals",
    "fleet_simulate",
    "fleet_stderr",
    "fleet_value_and_grad",
    "pack_fleet",
]
