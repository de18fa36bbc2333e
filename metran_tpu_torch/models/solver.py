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
- the parameter covariance of :class:`BaseSolver` (where a solver has
  none of its own) is ``pinv`` of the exact Hessian, torch autograd
  through the plain filter: CPU tensors only.

Not ported yet, raising ``NotImplementedError`` with their ROADMAP item:
``JaxSolve`` and ``batched_lbfgs`` (A7), ``LmfitSolve`` (A7), the exact
Hessian on the card (A7, kernel B7) and ``LanesSolve(n_starts > 1)``
(A7, ``multistart_fit_fleet``).
"""

from __future__ import annotations

from logging import getLogger
from typing import Callable, Optional

import numpy as np
import torch
from pandas import DataFrame

from ..parallel.fleet import default_gtol  # noqa: F401 - the JAX API's name

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
        "ScipySolve or LanesSolve")


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
        Hessian on the card comes with the batch-layout adjoint."""
        if self.mt.device.type != "cpu":
            raise _not_ported(
                "the exact Hessian on the card",
                "ROADMAP A7, the batch-layout adjoint B7; LanesSolve "
                "gives lanes-fd standard errors there")
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
    """The JAX package's on-device optax L-BFGS: not ported yet."""

    _name = "JaxSolve"

    def solve(self, **kwargs):
        raise _not_ported("JaxSolve",
                          "ROADMAP A7, with the batch-layout engines")


class LmfitSolve(BaseSolver):
    """The JAX package's lmfit-backed solver: not ported yet."""

    _name = "LmfitSolve"

    def solve(self, **kwargs):
        raise _not_ported("LmfitSolve", "ROADMAP A7, the remaining solvers")


def batched_lbfgs(*args, **kwargs):
    """The JAX package's vmapped single-round L-BFGS: not ported yet."""
    raise _not_ported("batched_lbfgs",
                      "ROADMAP A7, with refit_fleet and the batch layout")


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
    ``Metran.solve`` falls back to :class:`ScipySolve` then.
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
                              "ROADMAP A7, multistart_fit_fleet")
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
    "JaxSolve",
    "LanesSolve",
    "LmfitSolve",
    "ScipySolve",
    "SolverDivergenceError",
    "batched_lbfgs",
    "default_ftol",
    "default_gtol",
    "near_psd",
]
