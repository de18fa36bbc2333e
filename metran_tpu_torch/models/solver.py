"""Solvers for maximum-likelihood estimation of Metran models.

Port of ``metran_tpu/models/solver.py``.  Same plugin boundary as the
reference (``metran/solver.py``): a solver class is handed the model,
reads its parameter table, minimizes ``mt.get_mle(p)`` (the deviance,
-2 log L) and returns ``(success, optimal, stderr)``.

- :class:`ScipySolve` drives ``scipy.optimize.minimize`` with the value
  and the exact gradient of the port's sequential deviance (kernel K3
  forward, the closed-form adjoint K4 backward on the card; their plain
  versions on the CPU);
- :class:`LanesSolve` fits the model as a one-model fleet on the lanes
  engine (``fit_fleet(layout="lanes")``: K3/K4 and the grid line-search
  L-BFGS), with standard errors from ``fleet_stderr(method="lanes-fd")``;
- :class:`JaxSolve` keeps the JAX package's name for API parity: the
  on-device L-BFGS of the port (:func:`run_lbfgs`, optax's L-BFGS with
  the zoom line search, copied in :mod:`.lbfgs`) over a box-preserving
  reparameterization (:class:`BoxTransform`), the model's own engine
  and gradient engine — on the card K1/K9 with segment boundaries and
  the closed-form adjoint K11;
- :func:`batched_lbfgs` runs the same optimizer over a batch of
  independent problems, one batched objective call per line-search
  round;
- the parameter covariance of :class:`BaseSolver` (where a solver has
  none of its own) is ``pinv`` of the exact Hessian, torch autograd
  through the plain filter: CPU tensors only.

Not ported yet, raising ``NotImplementedError`` with their ROADMAP item:
``LmfitSolve`` (A3), the exact Hessian on the card (A3; so ``JaxSolve``
fits there but cannot finalize) and ``LanesSolve(n_starts > 1)`` (A3,
``multistart_fit_fleet``).
"""

from __future__ import annotations

import time
from logging import getLogger
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from pandas import DataFrame

from ..parallel.fleet import default_gtol
from . import lbfgs as _lbfgs

logger = getLogger(__name__)


class SolverDivergenceError(RuntimeError):
    """The fit objective became non-finite during optimization.

    Carries the offending parameter point (``params``), the non-finite
    ``value`` and the iteration count.  Typical causes: an ``alpha``
    driven into a degenerate region where the innovation covariance is
    ill-conditioned, or a float32 run whose deviance overflowed —
    tighten the parameter bounds (``pmin``/``pmax``), cap ``alpha``, or
    run under ``METRAN_TPU_X64=1``.
    """

    def __init__(self, message: str, params=None, value=None, n_iters=None):
        super().__init__(message)
        self.params = params
        self.value = value
        self.n_iters = n_iters


def near_psd(a: np.ndarray, epsilon: float = 0.0) -> np.ndarray:
    """Nearest positive semi-definite matrix by eigenvalue clipping.

    Same scaling construction as the reference's ``_nearPSD``
    (``metran/solver.py:167-192``).
    """
    n = a.shape[0]
    eigval, eigvec = np.linalg.eig(a)
    val = np.maximum(eigval, epsilon)
    vec = np.asarray(eigvec)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = 1.0 / (vec**2 @ val.T)
        t = np.sqrt(np.diag(np.asarray(t).reshape(n)))
        b = t @ vec * np.diag(np.sqrt(np.asarray(val).reshape(n)))
    return b @ b.T


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet ({item}); the port solves with "
        "ScipySolve, JaxSolve or LanesSolve")


class BaseSolver:
    """Shared machinery: objective plumbing, covariance, correlations."""

    _name = "BaseSolver"

    def __init__(self, mt, **kwargs):
        self.mt = mt
        self.pcov: Optional[DataFrame] = None
        self.pcor: Optional[DataFrame] = None
        self.nfev: Optional[int] = None
        self.result = None
        self.obj_func: Optional[float] = None
        self.aic: Optional[float] = None
        # True when the parameter covariance had negative variances
        # (clipped to zero in _finalize; surfaced in the fit report)
        self.nonpsd_pcov: bool = False
        # per-fit optimizer trajectory (obs.FitTelemetry): filled by
        # solvers that run through run_lbfgs (JaxSolve); surfaced by
        # Metran.fit_report()
        self.telemetry = None

    # -- objective ------------------------------------------------------
    def objfunction(self, p, callback: Optional[Callable] = None) -> float:
        if callback is not None:
            p = callback(p)
        return float(self.mt.get_mle(p))

    def _full_params(self, x: np.ndarray) -> np.ndarray:
        """Embed varying parameters into the full parameter vector."""
        par = self.initial.copy()
        par[self.vary] = x
        return par

    def _setup(self):
        self.vary = self.mt.parameters.vary.values.astype(bool)
        self.initial = self.mt.parameters.initial.values.astype(float).copy()
        self.names = self.mt.parameters.index[self.vary]
        pmin = self.mt.parameters.pmin.values[self.vary]
        pmax = self.mt.parameters.pmax.values[self.vary]
        self.bounds = [
            (
                None if b is None or (isinstance(b, float) and np.isnan(b)) else b,
                None if u is None or (isinstance(u, float) and np.isnan(u)) else u,
            )
            for b, u in zip(pmin, pmax)
        ]

    # -- covariance / stderr -------------------------------------------
    def _get_covariance(self, x: np.ndarray) -> np.ndarray:
        """Parameter covariance from the exact Hessian of the deviance
        over the varying parameters (torch autograd through the plain
        filter), with nearest-PSD repair.  CPU models only: the exact
        Hessian on the card is ROADMAP A3."""
        if self.mt.device.type != "cpu":
            raise _not_ported(
                "the exact Hessian on the card",
                "ROADMAP A3; LanesSolve gives lanes-fd standard errors "
                "there")
        idx = torch.as_tensor(np.flatnonzero(self.vary))
        initial = torch.as_tensor(self.initial, dtype=self.mt.dtype)

        def dev_vary(xv):
            full = initial.index_put((idx,), xv)
            return self.mt._deviance_torch(full, grad="autodiff")

        x_t = torch.as_tensor(np.asarray(x, float), dtype=self.mt.dtype)
        hessian = torch.autograd.functional.hessian(dev_vary, x_t)
        hessian = hessian.detach().numpy()
        cov = np.linalg.pinv(hessian)
        if np.amin(np.diag(cov)) <= 0:
            try:
                cov = np.linalg.pinv(near_psd(hessian))
            except Exception as e:
                logger.debug("Could not repair covariance: %s", e)
        return cov

    @staticmethod
    def _get_correlations(pcov: DataFrame) -> DataFrame:
        # clip: a non-PSD pcov's negative variances would otherwise emit
        # sqrt RuntimeWarnings; every non-finite entry becomes NaN so a
        # clipped parameter's correlations stay out of fit_report
        d = np.sqrt(np.clip(np.diag(pcov.values), 0.0, None))
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = pcov.values / np.outer(d, d)
        corr[~np.isfinite(corr)] = np.nan
        return DataFrame(corr, index=pcov.index, columns=pcov.columns)

    def _finalize(self, x, fun, nfev, success, pcov=None):
        """Common post-optimization bookkeeping shared by solvers."""
        if pcov is None:
            pcov = self._get_covariance(x)
        diag = np.diag(pcov)
        neg = diag < 0
        self.nonpsd_pcov = bool(np.any(neg))
        if self.nonpsd_pcov:
            logger.warning(
                "parameter covariance is not PSD (%d negative "
                "variance(s) clipped to zero); treat the affected "
                "standard errors as unreliable", int(neg.sum()),
            )
        _stderr = np.sqrt(np.clip(diag, 0.0, None))
        optimal = self._full_params(np.asarray(x, float))
        stderr = np.full(len(optimal), np.nan)
        stderr[self.vary] = _stderr
        self.pcov = DataFrame(pcov, index=self.names, columns=self.names)
        self.pcor = self._get_correlations(self.pcov)
        self.nfev = int(nfev)
        self.obj_func = float(fun)
        self.aic = 2 * int(self.vary.sum()) + self.obj_func
        return bool(success), optimal, stderr


class ScipySolve(BaseSolver):
    """scipy.optimize.minimize driving the port's deviance.

    Drop-in equivalent of the reference's default solver
    (``metran/solver.py:195-305``), with the exact gradient of the
    sequential deviance (kernel K4 on the card; ``use_grad=False``
    recovers the reference's finite differences).
    """

    _name = "ScipySolve"

    def solve(self, method: str = "l-bfgs-b", use_grad: bool = True,
              **kwargs):
        from scipy.optimize import minimize

        self._setup()
        x0 = self.initial[self.vary]

        if use_grad:
            value_and_grad = self.mt._deviance_value_and_grad
            idx = np.flatnonzero(self.vary)

            def fun(x):
                v, g = value_and_grad(self._full_params(x))
                return float(v), np.asarray(g, float)[idx]

            self.result = minimize(
                fun=fun, x0=x0, method=method, jac=True, bounds=self.bounds,
                **kwargs
            )
        else:
            self.result = minimize(
                fun=self.objfunction,
                x0=x0,
                method=method,
                bounds=self.bounds,
                args=(self._full_params,),
                **kwargs,
            )

        # stderr: L-BFGS-B inverse-Hessian approximation when available,
        # the exact Hessian otherwise (reference: solver.py:257-266)
        pcov = None
        if hasattr(self.result, "hess_inv"):
            try:
                pcov = np.asarray(self.result.hess_inv.todense())
            except AttributeError:
                pcov = np.asarray(self.result.hess_inv)
            d = np.diag(pcov)
            if np.isnan(d).any() or (d < 0).any():
                pcov = None
        if pcov is None:
            pcov = self._get_covariance(self.result.x)

        success = getattr(self.result, "success", True)
        return self._finalize(
            self.result.x, self.result.fun, self.result.nfev, success, pcov
        )


class JaxSolve(BaseSolver):
    """On-device L-BFGS of the port, with a bound-preserving reparam.

    The JAX package's name, kept for API parity: the optimization —
    objective, exact gradient, line search, updates — runs on the
    model's device through :func:`run_lbfgs` (optax's L-BFGS with the
    zoom line search, :mod:`.lbfgs`).  The objective is the model's
    deviance on its own engine and gradient engine (on the card's
    default ``engine="sqrt"`` in float64: K9 with segment boundaries and
    the closed-form adjoint K11).  Bounds are enforced through ``alpha =
    pmin + exp(theta)`` (upper bounds, when finite, via a scaled
    sigmoid), matching the reference's L-BFGS-B box constraints.  The
    standard errors come from the exact Hessian (:meth:`BaseSolver.
    _get_covariance`): CPU models only; on the card it raises (ROADMAP
    A3).
    """

    _name = "JaxSolve"

    def solve(self, maxiter: int = 200, tol: Optional[float] = None,
              **kwargs):
        if kwargs.pop("n_starts", 1) > 1:
            logger.warning(
                "n_starts is a LanesSolve feature; JaxSolve runs a "
                "single-start fit (this model fell back because some "
                "parameters are fixed or carry custom bounds)"
            )
        return self._finalize(*self.fit_core(maxiter=maxiter, tol=tol))

    def fit_core(self, maxiter: int = 200, tol: Optional[float] = None):
        """The fit of :meth:`solve` before its standard errors:
        ``run_lbfgs`` over the table-order deviance (``Metran.
        _deviance_torch``) through :class:`BoxTransform`; returns ``(x
        (varying parameters, table order), deviance, nfev,
        converged)``."""
        self._setup()
        mt = self.mt
        idx = torch.as_tensor(np.flatnonzero(self.vary), device=mt.device)
        lower = np.array(
            [b[0] if b[0] is not None else -np.inf for b in self.bounds]
        )
        upper = np.array(
            [b[1] if b[1] is not None else np.inf for b in self.bounds]
        )
        transform = BoxTransform(lower, upper)
        initial = torch.as_tensor(self.initial, dtype=mt.dtype,
                                  device=mt.device)

        def objective(theta):
            full = initial.index_put((idx,), transform.forward(theta))
            return mt._deviance_torch(full)

        theta0 = transform.inverse(torch.as_tensor(
            self.initial[self.vary], dtype=mt.dtype, device=mt.device))
        from ..obs.telemetry import FitTelemetry

        self.telemetry = FitTelemetry()
        try:
            theta, value, _iters, nfev, converged = run_lbfgs(
                objective, theta0, maxiter=maxiter, tol=tol,
                raise_on_divergence=True, telemetry=self.telemetry,
                grad_engine=mt._resolved_grad(),
            )
        except SolverDivergenceError as exc:
            # name the offending parameters (data units, table order)
            x_bad = transform.forward(torch.as_tensor(
                exc.params, dtype=mt.dtype, device=mt.device))
            x_bad = x_bad.double().cpu().numpy()
            at = ", ".join(
                f"{name}={val:.6g}" for name, val in zip(self.names, x_bad)
            )
            raise SolverDivergenceError(
                f"fit objective for model {mt.name!r} became "
                f"non-finite (value={exc.value!r}) after {exc.n_iters} "
                f"iterations at parameters [{at}] — likely an "
                "ill-conditioned innovation covariance in a degenerate "
                "alpha region; tighten pmin/pmax for those parameters, "
                "cap alpha, or rerun with METRAN_TPU_X64=1",
                params=x_bad, value=exc.value, n_iters=exc.n_iters,
            ) from exc
        x = transform.forward(theta).double().cpu().numpy()
        return x, float(value), int(nfev), bool(converged)


class LmfitSolve(BaseSolver):
    """The JAX package's lmfit-backed solver: not ported yet."""

    _name = "LmfitSolve"

    def solve(self, **kwargs):
        raise _not_ported("LmfitSolve", "ROADMAP A3, the remaining solvers")


class BoxTransform:
    """Smooth bijection from unconstrained theta to box [lower, upper]
    (``lower``/``upper`` numpy arrays, infinite where unbounded; theta a
    tensor)."""

    def __init__(self, lower: np.ndarray, upper: np.ndarray):
        self.lower = np.asarray(lower, float)
        self.upper = np.asarray(upper, float)

    def _consts(self, like):
        lo, up = self.lower, self.upper
        new = dict(dtype=like.dtype, device=like.device)
        masks = [torch.as_tensor(m, device=like.device) for m in (
            np.isfinite(lo) & np.isfinite(up),
            np.isfinite(lo) & ~np.isfinite(up),
            ~np.isfinite(lo) & np.isfinite(up))]
        return masks, new

    def forward(self, theta):
        (both, only_lo, only_up), new = self._consts(theta)
        lo, up = self.lower, self.upper
        # NaN-safe branch arithmetic: every branch is computed under
        # autograd even when unselected, so no infinity enters a branch
        lo_s = torch.as_tensor(np.where(np.isfinite(lo), lo, 0.0), **new)
        up_s = torch.as_tensor(np.where(np.isfinite(up), up, 1.0), **new)
        x = theta
        x = torch.where(only_lo, lo_s + torch.exp(theta), x)
        x = torch.where(only_up, up_s - torch.exp(-theta), x)
        x = torch.where(both, lo_s + (up_s - lo_s) * torch_sigmoid(theta), x)
        return x

    def inverse(self, x):
        (both, only_lo, only_up), new = self._consts(x)
        lo = torch.as_tensor(self.lower, **new)
        up = torch.as_tensor(self.upper, **new)
        tiny = torch.full_like(x, 1e-12)
        theta = x
        theta = torch.where(only_lo, torch.log(torch.maximum(x - lo, tiny)),
                            theta)
        theta = torch.where(only_up, -torch.log(torch.maximum(up - x, tiny)),
                            theta)
        frac = torch.clamp((x - lo) / torch.where(both, up - lo,
                                                  torch.ones_like(x)),
                           1e-9, 1 - 1e-9)
        theta = torch.where(both, torch.log(frac) - torch.log1p(-frac),
                            theta)
        return theta


def torch_sigmoid(x):
    """The logistic sigmoid (the JAX package's ``jax_sigmoid``)."""
    return torch.sigmoid(x)


def tree_norm(x) -> torch.Tensor:
    """Global l2 norm of a tensor (the JAX package's pytree norm)."""
    return torch.linalg.vector_norm(x)


def zoom_linesearch(max_linesearch_steps: int) -> _lbfgs.Lbfgs:
    """The optimizer with a zoom line search of at most
    ``max_linesearch_steps`` evaluations per iteration, restarting each
    search at step length 1 (``optax.lbfgs(linesearch=
    scale_by_zoom_linesearch(max_linesearch_steps,
    initial_guess_strategy="one"))``)."""
    return _lbfgs.Lbfgs(max_linesearch_steps=int(max_linesearch_steps))


# The JAX package's ``lbfgs_trace_ctx`` works around optax seeding its
# line-search state with default-dtype (float64) scalars under x64; the
# port runs every optimizer tensor in the iterate's dtype, so it has no
# counterpart.


def lbfgs_advance(objective, opt: _lbfgs.Lbfgs, theta, state, tol, maxiter,
                  max_new_iters, nfev=0):
    """Advance a batch of L-BFGS runs by up to ``max_new_iters``
    iterations: the JAX package's ``lbfgs_advance`` over a batch.

    ``objective(theta (B', P), lanes (B',)) -> (values (B',), grads
    (B', P))`` is the batched value-and-gradient of the lanes ``lanes``
    (see :mod:`.lbfgs` for the contract: a row may depend only on its own
    lane); ``opt`` is the configuration (:func:`zoom_linesearch`);
    ``theta`` (B, P), ``state`` from ``opt.init(theta)``; ``maxiter`` an
    int or (B,) (0 freezes a lane).  Stops a lane at convergence
    (gradient norm below ``tol``), at ``maxiter`` total iterations, or
    after ``max_new_iters`` iterations of this call.  Returns ``(theta,
    state, nfev)`` to carry across chunked calls; ``nfev`` (B,) counts
    true objective evaluations.
    """
    return _lbfgs.lbfgs_advance(objective, theta, state, tol, maxiter,
                                max_new_iters, nfev,
                                opt.max_linesearch_steps)


def _scalar_value_and_grad(objective):
    """The batched value-and-gradient of a scalar ``objective(theta
    (P,))``, for one lane."""

    def value_and_grad(theta, lanes):
        return _lbfgs.value_and_grad_rows(lambda th: objective(th[0])[None],
                                          theta)

    return value_and_grad


def run_lbfgs(objective, theta0, maxiter: int = 200,
              tol: Optional[float] = None, ftol: Optional[float] = None,
              raise_on_divergence: bool = False, telemetry=None,
              grad_engine: Optional[str] = None):
    """Chunked L-BFGS loop with dtype-aware stopping (the JAX package's
    ``run_lbfgs``).

    ``objective(theta (P,))`` returns a scalar tensor that torch
    autograd differentiates (on the card through the kernels' own
    backward, K11 or K4); ``theta0`` (P,) tensor.  The optimizer is
    optax's L-BFGS with its default zoom line search (:mod:`.lbfgs`),
    advanced in chunks of up to 20 iterations; between chunks the host
    checks the stopping tests.  ``telemetry`` (an
    :class:`~metran_tpu_torch.obs.FitTelemetry`) records one checkpoint
    per chunk (deviance, gradient norm, nfev, the chunk's wall time), the
    stop reason, line-search stalls and any divergence.  ``grad_engine``
    is the resolved gradient engine the objective differentiates with,
    recorded into the telemetry (validated: unknown values raise).

    Returns ``(theta, value, n_iters, nfev, converged)``.  ``converged``
    is True when the gradient-norm test (``tol``, default
    :func:`default_gtol`) or the scipy-style relative-improvement test
    across a chunk (``ftol``, default :func:`default_ftol`) fired, never
    at a non-finite value or at a value worse than the start.  With
    ``raise_on_divergence=True`` a non-finite objective raises
    :class:`SolverDivergenceError` carrying the offending ``theta``.
    """
    if grad_engine is not None:
        from ..config import grad_engine as _validate_grad

        grad_engine = _validate_grad(grad_engine)
    theta0 = torch.as_tensor(theta0)
    if tol is None:
        tol = default_gtol(theta0.dtype)
    if ftol is None:
        ftol = default_ftol(theta0.dtype)
    chunk = min(20, maxiter)
    value_and_grad = _scalar_value_and_grad(objective)
    # one extra objective evaluation, for two guards: a start that is
    # already non-finite diagnoses immediately, and no stopping test may
    # report success at a value worse than this
    with torch.no_grad():
        value0 = float(objective(theta0))
    if telemetry is not None:
        telemetry.record_start(value0)
        telemetry.record_grad_engine(grad_engine)
    if not np.isfinite(value0):
        if telemetry is not None:
            telemetry.record_stop(
                "init_nonfinite", False,
                divergence=("non-finite at the initial parameters "
                            f"(value={value0!r})"))
        if raise_on_divergence:
            raise SolverDivergenceError(
                "fit objective is non-finite at the initial parameters "
                f"(value={value0!r})",
                params=theta0.double().cpu().numpy(), value=value0,
                n_iters=0)
        return theta0, torch.as_tensor(value0), 0, 1, False
    # nfev starts at 1: the value0 guard above is a true evaluation
    theta = theta0[None]
    state = _lbfgs.init(theta)
    nfev = torch.ones(1, dtype=torch.int32, device=theta.device)
    prev_value = None
    converged = False
    reason = "maxiter"
    while True:
        t0 = time.perf_counter()
        theta, state, nfev = _lbfgs.lbfgs_advance(
            value_and_grad, theta, state, tol, maxiter, chunk, nfev)
        value = float(state.value[0])
        count = int(state.count[0])
        gnorm = float(_lbfgs.grad_norm(state)[0])
        # host reads of the finished chunk: the wall covers its work
        wall = time.perf_counter() - t0
        if telemetry is not None:
            telemetry.record_checkpoint(count, value, gnorm, int(nfev[0]),
                                        wall_s=wall)
        if not np.isfinite(value):
            reason = "diverged"
            if telemetry is not None:
                telemetry.record_stop(
                    "diverged", False,
                    divergence=(f"value={value!r} after {count} L-BFGS "
                                "iterations"))
            if raise_on_divergence:
                raise SolverDivergenceError(
                    f"fit objective became non-finite (value={value!r}) "
                    f"after {count} L-BFGS iterations",
                    params=theta[0].double().cpu().numpy(), value=value,
                    n_iters=count)
            break  # diverged — never report success
        if gnorm < tol:
            converged, reason = True, "gradient"
            break
        # floor stop: the value CHANGED by less than the resolution
        # tolerance across a whole chunk (two-sided: a chunk that made
        # the value meaningfully worse keeps running)
        if prev_value is not None and (
                abs(prev_value - value)
                <= ftol * max(abs(prev_value), abs(value), 1.0)):
            converged, reason = True, "floor"
            break
        if count >= maxiter:
            break
        prev_value = value
    if converged and not (
            value <= value0 + ftol * max(abs(value0), abs(value), 1.0)):
        # stationary at a point worse than the start: the iterates went
        # uphill through line-search fallbacks — a failed run
        converged, reason = False, "worse_than_start"
    if telemetry is not None and reason != "diverged":
        telemetry.record_stop(reason, converged)
    return theta[0], state.value[0], int(state.count[0]), int(nfev[0]), \
        converged


class BatchedLbfgsFit(NamedTuple):
    """Result of :func:`batched_lbfgs` (host arrays, leading B).

    ``converged`` is the gradient-norm verdict only (finite value AND
    ``gnorm < tol``).  ``value0`` is the objective at the start point,
    so a run that worsened is diagnosable without re-evaluating.
    """

    theta: np.ndarray
    value: np.ndarray
    value0: np.ndarray
    iterations: np.ndarray
    gnorm: np.ndarray
    converged: np.ndarray


def batched_lbfgs(objective, theta0, data=(), maxiter: int = 60,
                  tol: Optional[float] = None,
                  max_linesearch_steps: int = 16,
                  grad_engine: Optional[str] = None) -> BatchedLbfgsFit:
    """Solve B independent problems with one batched L-BFGS run.

    ``objective(theta (B', P), *data_rows) -> (B',)``: the values of the
    rows ``theta`` given the same rows of every leaf of ``data`` (each
    leading with B), differentiable by torch autograd; row ``i`` may
    depend only on ``theta[i]`` and row ``i`` of the data (the JAX
    package maps a per-lane scalar objective with ``vmap``; here one
    call per line-search round serves every lane still searching).  Each
    lane runs optax's zoom-line-search L-BFGS (:mod:`.lbfgs`) to
    convergence or ``maxiter``.  A lane whose objective diverges reports
    a non-finite ``value`` (and ``converged=False``) without touching
    its batch mates.  ``grad_engine`` is validated (unknown values
    raise) but does not rewrite the objective.
    """
    if grad_engine is not None:
        from ..config import grad_engine as _validate_grad

        _validate_grad(grad_engine)
    theta0 = torch.as_tensor(theta0)
    if tol is None:
        tol = default_gtol(theta0.dtype)
    data = tuple(data)

    def value_and_grad(theta, lanes):
        return _lbfgs.value_and_grad_rows(
            objective, theta, *(d.index_select(0, lanes) for d in data))

    with torch.no_grad():
        value0 = objective(theta0, *data)
    theta, state, _ = _lbfgs.lbfgs_advance(
        value_and_grad, theta0, _lbfgs.init(theta0), tol, maxiter, maxiter,
        max_linesearch_steps=max_linesearch_steps)
    value = state.value.double().cpu().numpy()
    gnorm = _lbfgs.grad_norm(state).double().cpu().numpy()
    return BatchedLbfgsFit(
        theta=theta.cpu().numpy(), value=value,
        value0=value0.double().cpu().numpy(),
        iterations=state.count.cpu().numpy().astype(np.int64), gnorm=gnorm,
        converged=np.isfinite(value) & (gnorm < float(tol)))


def default_ftol(dtype) -> float:
    """Default relative-improvement stopping tolerance for ``dtype`` (a
    torch dtype): the scipy L-BFGS-B ``factr`` criterion with ``factr *
    eps``, ``1e7 * eps`` in float64 (scipy's default, the stop the
    reference inherits) and ``1e2 * eps`` in float32 (just above the
    float32 objective's resolution floor)."""
    factr = 1e7 if dtype == torch.float64 else 1e2
    return float(factr * torch.finfo(dtype).eps)


class LanesSolve(BaseSolver):
    """Single-model solve on the fleet lanes engine — the card's default.

    Routes ``Metran.solve()`` through ``fit_fleet(layout="lanes")`` at
    batch 1: the lane-layout filter K3 with its closed-form adjoint K4
    and the fixed-structure grid-line-search L-BFGS
    (:mod:`metran_tpu_torch.parallel.lanes_lbfgs`).  Standard errors
    come from ``fleet_stderr(method="lanes-fd")``.

    Scope: optimizes every parameter over the fleet box (``alpha`` in
    ``[ALPHA_PMIN, alpha_max soft cap]``).  Fixed parameters
    (``vary=False``) or custom ``pmin/pmax`` are not supported;
    ``Metran.solve`` falls back to :class:`JaxSolve` then.
    """

    _name = "LanesSolve"

    @classmethod
    def supports(cls, mt) -> bool:
        """True when the fit is expressible on the lanes engine: every
        parameter varying, with the fleet's standard box (the
        reference-default ``pmin`` and no upper bound)."""
        from ..parallel.fleet import ALPHA_PMIN

        pt = mt.parameters
        if not pt.vary.values.astype(bool).all():
            return False
        pmin = pt.pmin.values.astype(float)
        pmax = pt.pmax.values.astype(float)
        return bool(np.allclose(pmin, ALPHA_PMIN) and np.isnan(pmax).all())

    def solve(self, maxiter: int = 100, tol: Optional[float] = None,
              stall_tol: Optional[float] = None,
              stall_rtol: Optional[float] = None, chunk: int = 8,
              remat_seg: Optional[int] = 100, n_starts: int = 1,
              **kwargs):
        """Minimize the deviance on the lanes engine (``n_starts > 1``,
        the multi-start basin search, is not ported yet)."""
        from ..parallel import fleet as _fleet

        if n_starts > 1:
            raise _not_ported("LanesSolve(n_starts > 1)",
                              "ROADMAP A3, multistart_fit_fleet")
        self._setup()
        if not self.supports(self.mt):
            raise ValueError(
                "LanesSolve optimizes all parameters over the fleet's "
                "standard box (pmin=1e-5, no pmax); use ScipySolve for "
                "fits with fixed (vary=False) parameters or custom bounds"
            )
        mt = self.mt
        panel = mt._active_panel()
        flt = _fleet.pack_fleet([panel], [mt.factors], dtype=mt.dtype,
                                device=mt.device)
        idx = mt._canonical_idx  # canonical[i] = table[idx[i]]
        p0 = torch.as_tensor(mt._param_array(self.initial)[None],
                             dtype=mt.dtype, device=mt.device)
        if stall_rtol is None and stall_tol is None:
            # scipy-factr default: stop once the per-iteration
            # improvement falls below ftol * |f| (evaluated per iteration
            # on the device), the reference's own relative stop
            stall_rtol = default_ftol(mt.dtype)
        fit = _fleet.fit_fleet(
            flt, p0=p0, maxiter=maxiter, tol=tol, stall_tol=stall_tol,
            stall_rtol=stall_rtol or 0.0, chunk=chunk, layout="lanes",
            remat_seg=remat_seg, **kwargs)
        self.fleet_fit = fit
        params = fit.params[0].double().cpu().numpy()  # canonical order
        # stderr re-derives from the covariance diagonal in _finalize
        _, pcov_c = _fleet.fleet_stderr(fit.params, flt, remat_seg=remat_seg,
                                        method="lanes-fd")
        pcov_c = pcov_c[0].double().cpu().numpy()

        n = len(params)
        x = np.empty(n)
        x[idx] = params  # back to table row order
        pcov = np.empty((n, n))
        pcov[np.ix_(idx, idx)] = pcov_c
        return self._finalize(
            x, float(fit.deviance[0]), int(fit.nfev[0]),
            bool(fit.converged[0]), pcov,
        )


__all__ = [
    "BaseSolver",
    "BatchedLbfgsFit",
    "BoxTransform",
    "JaxSolve",
    "LanesSolve",
    "LmfitSolve",
    "ScipySolve",
    "SolverDivergenceError",
    "batched_lbfgs",
    "default_ftol",
    "default_gtol",
    "lbfgs_advance",
    "near_psd",
    "run_lbfgs",
    "torch_sigmoid",
    "tree_norm",
    "zoom_linesearch",
]
