"""The Metran model class: user-facing shell over the port's kernels.

Port of ``metran_tpu/models/metran.py``, API-compatible with the
reference ``Metran`` (``metran/metran.py:31-1314``): same constructor,
parameter table, accessors, masking workflow and reports.  The model
lives on a device (``device=``, default the CUDA card; ``"cpu"`` runs the
kernels' plain versions) in the JAX package's precision: float64 on the
CPU, float32 on the card unless ``METRAN_TPU_X64=1``.

The engine follows the JAX package's rule: ``"sqrt"`` on the card (an
accelerator), ``"sequential"`` on the CPU (:func:`default_engine`).  On
``"sqrt"`` the filter is the stored square-root filter (kernel K9), the
smoother the factored smoother K10, the path draws K7 with K9 and K10;
on ``"sequential"`` the stored sequential filter (K6 ``store``), the
smoother K8 and the draws K7 with K6 and K8; the forecasts are K2 either
way.  The fit's likelihood is the sequential deviance (kernel K3, its
exact gradient the closed-form adjoint K4) on the card's LanesSolve
whatever the engine, as in the JAX package; ``JaxSolve`` and
``ScipySolve`` fit the model's own engine (on ``"sqrt"``: K9 with
segment boundaries, its gradient the batch-layout adjoint K11).  The
associative-scan engines run only when named, as in the JAX package:
``"parallel"`` filters and smooths on K19/K20, ``"sqrt_parallel"`` on
K21/K22, their path draws on the sequential twins (``"joint"``: K1
``store`` + K8; ``"sqrt"``: K9 + K10); a ``JaxSolve``/``ScipySolve`` fit
on them differentiates the plain version by autodiff (CPU only).  The
joint engine (ROADMAP A2) raises, as do ``plots``, ``to_file`` and
``from_file`` (ROADMAP A5).
"""

from __future__ import annotations

from logging import getLogger
from os import getlogin
from typing import Optional

import numpy as np
import torch
from pandas import DataFrame, Series, Timestamp, concat, date_range
from scipy.stats import norm

from .. import data as _data
from ..config import as_tensor, default_dtype, resolve_device
from ..ops import deviance, dfm_statespace
from ..utils import freq_to_days, frequency_is_supported, validate_name
from .factoranalysis import FactorAnalysis
from .kalman_runner import KalmanRunner, check_engine
from .solver import JaxSolve, LanesSolve, ScipySolve

logger = getLogger(__name__)

_ENGINE_ALIASES = {
    "numba": "sequential",  # reference names accepted for drop-in use
    "numpy": "sequential",
    "sequential": "sequential",
    "joint": "joint",
    "parallel": "parallel",  # associative-scan parallel-in-time engine
    "sqrt": "sqrt",  # QR square-root engine (robust f32 default)
    "sqrt_parallel": "sqrt_parallel",  # square-root associative scan
}

#: where each model feature that is not ported yet will come from
_NOT_PORTED = {
    "plots": "ROADMAP A5, models/plots.py (needs matplotlib)",
    "to_file": "ROADMAP A5, the JSON half of io.py",
    "from_file": "ROADMAP A5, the JSON half of io.py",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"Metran.{what} is not ported yet ({_NOT_PORTED[what]})")


def default_engine(device) -> str:
    """The engine a model on ``device`` runs when none is named: the
    square-root engine on the CUDA card (the JAX package's accelerator
    default — PSD-by-construction covariances in float32), the
    sequential engine on the CPU (float64 parity with the reference)."""
    return "sqrt" if torch.device(device).type == "cuda" else "sequential"


def _engine(name: str) -> str:
    """The canonical engine of ``name``; the joint engine, which the
    port's model does not have yet, raises ``NotImplementedError``
    naming its ROADMAP item."""
    if name not in _ENGINE_ALIASES:
        raise ValueError(f"unknown engine {name!r}")
    return check_engine(_ENGINE_ALIASES[name])


class Metran:
    """Multivariate time-series analysis using a dynamic factor model.

    Parameters
    ----------
    oseries : pandas.DataFrame or list/tuple of pandas.Series/DataFrame
        Series to be analyzed; index must be a DatetimeIndex.
    name : str, optional
        Model name (default "Cluster").
    freq : str, optional
        Simulation frequency (fixed-length pandas offsets like "D", "7D").
    tmin, tmax : str, optional
        Start/end of the analysis period.
    engine : str, optional
        Kalman engine: "sequential" (the reference's sequential
        processing; "numba"/"numpy" are aliases), "sqrt" (QR
        square-root filtering and smoothing, covariances PSD by
        construction — the robust float32 engine), "parallel"
        (associative-scan filtering and smoothing, the time axis split
        over the card's blocks) or "sqrt_parallel" (the associative scan
        over triangular factors).
        Default "sqrt" on the CUDA card and "sequential" on the CPU, as
        the JAX package chooses by accelerator.  "joint" raises
        ``NotImplementedError`` (ROADMAP A2).
    device : str or torch.device, optional
        Where the model runs: the CUDA card by default (raises without
        one); ``"cpu"`` runs the kernels' plain versions in float64.
    """

    def __init__(
        self,
        oseries,
        name: str = "Cluster",
        freq: Optional[str] = None,
        tmin=None,
        tmax=None,
        engine: Optional[str] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device)
        self._engine = _engine(default_engine(self.device) if engine is None
                               else engine)
        self.settings = {
            "tmin": None,
            "tmax": None,
            "freq": "D",
            "min_pairs": 20,
            "solver": None,
            "warmup": 1,
        }
        if tmin is not None:
            self.settings["tmin"] = tmin
        if tmax is not None:
            self.settings["tmax"] = tmax
        if freq is not None:
            self.settings["freq"] = frequency_is_supported(freq)

        self.nfactors = 0
        self.factors: Optional[np.ndarray] = None
        self.set_observations(oseries)
        self.parameters = DataFrame(
            columns=["initial", "pmin", "pmax", "vary", "name"]
        )
        self.set_init_parameters()

        self.masked_observations = None
        self.fit = None
        self.kf: Optional[KalmanRunner] = None

        self.name = validate_name(name)
        self.file_info = self._get_file_info()

    @property
    def plots(self):
        raise _not_ported("plots")

    # ------------------------------------------------------------------
    # dimensions
    # ------------------------------------------------------------------
    @property
    def nparam(self) -> int:
        return self.parameters.index.size

    @property
    def nstate(self) -> int:
        return self.nseries + self.nfactors

    @property
    def _dt(self) -> float:
        return freq_to_days(self.settings["freq"])

    # ------------------------------------------------------------------
    # data handling
    # ------------------------------------------------------------------
    def set_observations(self, oseries) -> None:
        """Ingest observations (reference: ``metran/metran.py:509-579``)."""
        frame = _data.combine_series(oseries)
        self.snames = [str(c) for c in frame.columns]
        frame = _data.truncate(
            frame, self.settings["tmin"], self.settings["tmax"]
        )
        import pandas as pd

        if not isinstance(frame.index, pd.DatetimeIndex):
            msg = "Index of series must be DatetimeIndex"
            logger.error(msg)
            raise TypeError(msg)
        frame = frame.asfreq(self.settings["freq"])
        self.nseries = frame.shape[1]
        self.oseries_unstd = frame
        self.oseries, self.oseries_std, self.oseries_mean = _data.standardize(frame)
        self.test_cross_section()

    def standardize(self, oseries):
        standardized, self.oseries_std, self.oseries_mean = _data.standardize(oseries)
        return standardized

    def truncate(self, oseries):
        return _data.truncate(oseries, self.settings["tmin"], self.settings["tmax"])

    def test_cross_section(self, oseries=None, min_pairs: Optional[int] = None):
        if oseries is None:
            oseries = self.oseries
        if min_pairs is None:
            min_pairs = self.settings["min_pairs"]
        _data.test_cross_section(oseries, min_pairs=min_pairs)

    def get_observations(self, standardized: bool = False, masked: bool = False):
        oseries = self.masked_observations if masked else self.oseries
        if not standardized:
            oseries = oseries * self.oseries_std + self.oseries_mean
        return oseries

    def _active_panel(self) -> _data.Panel:
        frame = (
            self.masked_observations
            if self.masked_observations is not None
            else self.oseries
        )
        return _data.pack_panel(
            frame,
            std=self.oseries_std,
            mean=self.oseries_mean,
            freq=self.settings["freq"],
        )

    # ------------------------------------------------------------------
    # masking (counterfactual / outlier analysis)
    # ------------------------------------------------------------------
    def mask_observations(self, mask) -> None:
        """Hide selected observations from the filter/smoother without
        altering the stored data (reference: ``metran/metran.py:464-495``)."""
        if mask.shape != self.oseries.shape:
            logger.error(
                "Dimensions of mask %s do not equal dimensions of series %s. "
                "Mask cannot be applied.",
                mask.shape,
                self.oseries.shape,
            )
            return
        self.masked_observations = self.oseries.mask(mask.astype(bool))
        if self.kf is not None:
            self.kf.set_observations(self._active_panel())
            self.kf.mask_active = True

    def unmask_observations(self) -> None:
        self.masked_observations = None
        if self.kf is not None:
            self.kf.set_observations(self._active_panel())
            self.kf.mask_active = False

    # ------------------------------------------------------------------
    # factor analysis
    # ------------------------------------------------------------------
    def get_factors(self, oseries=None) -> Optional[np.ndarray]:
        if oseries is None:
            oseries = self.oseries
        fa = FactorAnalysis()
        self.factors = fa.solve(oseries)
        self.eigval = fa.eigval
        if self.factors is not None:
            self.nfactors = self.factors.shape[1]
            self.fep = fa.fep
        else:
            self.nfactors = 0
        return self.factors

    def get_communality(self) -> np.ndarray:
        return np.sum(np.square(self.factors), axis=1)

    def get_specificity(self) -> np.ndarray:
        return 1 - self.get_communality()

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def set_init_parameters(self, method: str = "reference") -> None:
        """Populate the initial-parameter table.

        ``method="reference"`` (default) uses the reference's constant
        ``alpha = 10`` for every state (metran/metran.py:439-462).
        ``method="autocorr"`` seeds each alpha from the data's lag-1
        autocorrelations instead (see
        :func:`metran_tpu_torch.parallel.autocorr_init_params`) — measured to
        cut L-BFGS iterations ~25 percent with identical optima; it
        needs factor loadings, so call it after ``get_factors`` (done
        automatically by ``solve(init="autocorr")``).
        """
        if method == "autocorr":
            if self.factors is None:
                raise ValueError(
                    "init method 'autocorr' needs factor loadings; call "
                    "get_factors first or use solve(init='autocorr')"
                )
            from ..parallel.fleet import Fleet, autocorr_init_params

            panel = self._active_panel()
            new = dict(dtype=self.dtype, device=self.device)
            fleet = Fleet(
                y=torch.as_tensor(panel.values[None], **new),
                mask=torch.as_tensor(panel.mask[None], device=self.device),
                loadings=torch.as_tensor(np.asarray(self.factors)[None],
                                         **new),
                dt=torch.full((1,), panel.dt, **new),
                n_series=torch.full((1,), self.nseries, dtype=torch.int32),
            )
            alpha = autocorr_init_params(fleet)[0].double().cpu().numpy()
            init_sdf = alpha[: self.nseries]
            init_cdf = alpha[self.nseries :]
        elif method == "reference":
            init_sdf = np.full(self.nseries, 10.0)
            init_cdf = np.full(self.nfactors, 10.0)
        else:
            raise ValueError(
                f"unknown init method {method!r}; expected 'reference' "
                "or 'autocorr'"
            )
        cols = ["initial", "pmin", "pmax", "vary", "name"]
        for n in range(self.nfactors):
            self.parameters.loc[f"cdf{n + 1}_alpha", cols] = (
                init_cdf[n], 1e-5, None, True, "cdf",
            )
        for n in range(self.nseries):
            self.parameters.loc[f"{self.snames[n]}_sdf_alpha", cols] = (
                init_sdf[n], 1e-5, None, True, "sdf",
            )

    def get_parameters(self, initial: bool = False) -> Series:
        if not initial and "optimal" in self.parameters:
            return self.parameters["optimal"]
        return self.parameters["initial"]

    @property
    def _canonical_idx(self) -> np.ndarray:
        """Gather indices mapping the parameter-table row order
        ([cdf..., sdf...]) to the canonical state ordering
        [sdf alphas..., cdf alphas...] used by the state-space builder."""
        kinds = self.parameters["name"].values
        return np.concatenate(
            [np.flatnonzero(kinds == "sdf"), np.flatnonzero(kinds == "cdf")]
        )

    def _table_array(self, p) -> np.ndarray:
        """Coerce parameters (array/Series/dict) to a float array in the
        parameter-table row order — the order solvers optimize in."""
        if isinstance(p, dict):
            p = Series(p)
        if isinstance(p, Series):
            p = p.reindex(self.parameters.index).values
        return np.asarray(p, float)

    def _param_array(self, p) -> np.ndarray:
        """Coerce parameters to the canonical order
        [sdf alphas..., cdf alphas...] used by the state-space builder."""
        return self._table_array(p)[self._canonical_idx]

    # ------------------------------------------------------------------
    # state-space matrices (host-side views for reports/parity)
    # ------------------------------------------------------------------
    def _phi(self, alpha):
        return np.exp(-self._dt / alpha)

    def get_transition_matrix(self, p=None, initial=False) -> np.ndarray:
        if p is None:
            p = self.get_parameters(initial)
        a = self._param_array(p)
        return np.diag(self._phi(a))

    def get_transition_covariance(self, p=None, initial=False) -> np.ndarray:
        if p is None:
            p = self.get_parameters(initial)
        a = self._param_array(p)
        phi = self._phi(a)
        communality = np.sum(np.square(self.factors), axis=1)
        q = 1 - phi**2
        q[: self.nseries] *= 1 - communality
        return np.diag(q)

    def get_transition_variance(self, p=None, initial=False) -> np.ndarray:
        return np.diag(self.get_transition_covariance(p, initial))

    def get_observation_matrix(self, p=None, initial=False) -> np.ndarray:
        return np.concatenate(
            [np.eye(self.nseries), np.atleast_2d(self.factors)], axis=1
        )

    def get_observation_variance(self) -> np.ndarray:
        return np.zeros(self.nseries)

    def get_scaled_observation_matrix(self, p=None) -> np.ndarray:
        """The observation matrix scaled by the series' standard
        deviations (projections in data units)."""
        return self.get_observation_matrix(p) * self.oseries_std[:, None]

    def _get_matrices(self, p, initial=False):
        return (
            self.get_transition_matrix(p, initial),
            self.get_transition_covariance(p, initial),
            self.get_observation_matrix(p, initial),
            self.get_observation_variance(),
        )

    def _statespace(self, p):
        a = self._param_array(p)
        return dfm_statespace(
            a[: self.nseries], a[self.nseries:], np.asarray(self.factors),
            self._dt, device=self.device, dtype=self.dtype,
        )

    # ------------------------------------------------------------------
    # likelihood
    # ------------------------------------------------------------------
    def _init_kalmanfilter(self, oseries=None, engine: Optional[str] = None) -> None:
        if engine is not None:
            self._engine = _engine(engine)
        self.kf = KalmanRunner(self._active_panel(), engine=self._engine,
                               device=self.device, dtype=self.dtype)

    def _resolved_grad(self, grad=None) -> str:
        """The gradient engine this model's fits differentiate with
        (``METRAN_TPU_GRAD_ENGINE`` unless overridden; see
        :func:`metran_tpu_torch.ops.resolve_grad_engine`)."""
        from ..ops import resolve_grad_engine

        return resolve_grad_engine(grad, self._engine, self.dtype)

    def _deviance_torch(self, p_table, grad=None):
        """Deviance of the *table-order* parameter vector (the order the
        solvers optimize in) as a torch scalar.  The reorder to the
        canonical [sdf..., cdf...] layout is a differentiable gather, so
        gradients and Hessians come back in table order.  ``grad``
        selects the gradient engine (``None`` = configured default);
        the Hessian passes ``"autodiff"`` (the closed-form adjoint is
        reverse-mode only)."""
        p = as_tensor(p_table, self.device, self.dtype)
        idx = torch.as_tensor(self._canonical_idx, device=self.device)
        a = p.index_select(0, idx)
        ss = dfm_statespace(a[: self.nseries], a[self.nseries:],
                            np.asarray(self.factors), self._dt,
                            device=self.device, dtype=self.dtype)
        return deviance(ss, self.kf.y, self.kf.mask,
                        warmup=self.settings["warmup"], engine=self._engine,
                        grad=self._resolved_grad(grad))

    def _deviance_value_and_grad(self, p_table):
        """(deviance, gradient) at the table-order parameter vector, as
        a float and a float64 numpy array in table order."""
        p = torch.tensor(np.asarray(p_table, float), dtype=self.dtype,
                         device=self.device, requires_grad=True)
        with torch.enable_grad():
            value = self._deviance_torch(p)
            (grad,) = torch.autograd.grad(value, p)
        return float(value.detach()), grad.double().cpu().numpy()

    def get_mle(self, p) -> float:
        """Deviance (-2 log L) at parameters ``p`` — the solver objective.

        Note: like the reference (``metran/metran.py:605-622``), this leaves
        the filter set to ``p``, and is the per-iteration hot path.
        """
        p_tab = self._table_array(p)
        if self.kf is None:
            self._init_kalmanfilter()
        self.kf.set_matrices(self._statespace(p_tab))
        return float(self._deviance_torch(p_tab))

    # ------------------------------------------------------------------
    # inference products
    # ------------------------------------------------------------------
    def _run_kalman(self, method: str = "smoother", p=None) -> None:
        if self.kf is None:
            self._init_kalmanfilter()
        if p is not None:
            self.kf.set_matrices(self._statespace(p))
        elif self.kf.ss is None:
            self.kf.set_matrices(self._statespace(self.get_parameters()))
        if method == "filter":
            self.kf.run_filter()
        else:
            self.kf.run_smoother()

    def _state_columns(self):
        return [f"{name}_sdf" for name in self.snames] + [
            f"cdf{i + 1}" for i in range(self.nfactors)
        ]

    def get_state_means(self, p=None, method: str = "smoother") -> DataFrame:
        self._run_kalman(method, p=p)
        means = self.kf.state_means(method)
        return DataFrame(means, index=self.oseries.index, columns=self._state_columns())

    def get_state_variances(self, p=None, method: str = "smoother") -> DataFrame:
        self._run_kalman(method, p=p)
        variances = self.kf.state_variances(method)
        return DataFrame(
            variances, index=self.oseries.index, columns=self._state_columns()
        )

    def get_state(self, i: int, p=None, alpha: float = 0.05, method="smoother"):
        if i < 0 or i >= self.nstate:
            logger.error("Value of i must be >=0 and <%s", self.nstate)
            return None
        state = self.get_state_means(p=p, method=method).iloc[:, i]
        if alpha is None:
            return state
        if not 0 < alpha < 1:
            msg = "The value of alpha must be between 0 and 1."
            logger.error(msg)
            raise Exception(msg)
        z = norm.ppf(1 - alpha / 2.0)
        variances = self.get_state_variances(p=p, method=method).iloc[:, i]
        iv = z * np.sqrt(variances)
        state = concat([state, state - iv, state + iv], axis=1)
        state.columns = ["mean", "lower", "upper"]
        return state

    def get_simulated_means(
        self, p=None, standardized: bool = False, method: str = "smoother"
    ) -> DataFrame:
        self._run_kalman(method, p=p)
        if standardized:
            observation_matrix = self.get_observation_matrix(p=p)
            observation_means = np.zeros(self.nseries)
        else:
            observation_matrix = self.get_scaled_observation_matrix(p=p)
            observation_means = self.oseries_mean
        means, _ = self.kf.simulate(observation_matrix, method=method)
        return (
            DataFrame(means, index=self.oseries.index, columns=self.oseries.columns)
            + observation_means
        )

    def get_simulated_variances(
        self, p=None, standardized: bool = False, method: str = "smoother"
    ) -> DataFrame:
        self._run_kalman(method, p=p)
        if standardized:
            observation_matrix = self.get_observation_matrix(p=p)
        else:
            observation_matrix = self.get_scaled_observation_matrix(p=p)
        _, variances = self.kf.simulate(observation_matrix, method=method)
        return DataFrame(
            variances, index=self.oseries.index, columns=self.oseries.columns
        )

    def get_simulation(
        self, name, p=None, alpha=0.05, standardized=False, method="smoother"
    ):
        means = self.get_simulated_means(p=p, standardized=standardized, method=method)
        if name not in means.columns:
            logger.error("Unknown name: %s", name)
            return None
        sim = means.loc[:, name]
        if alpha is None:
            return sim
        if not 0 < alpha < 1:
            msg = "The value of alpha must be between 0 and 1."
            logger.error(msg)
            raise Exception(msg)
        z = norm.ppf(1 - alpha / 2.0)
        variances = self.get_simulated_variances(
            p=p, standardized=standardized, method=method
        ).loc[:, name]
        iv = z * np.sqrt(variances)
        sim = concat([sim, sim - iv, sim + iv], axis=1)
        sim.columns = ["mean", "lower", "upper"]
        return sim

    def get_innovations(
        self, p=None, standardized: bool = True, warmup: int = 0
    ) -> DataFrame:
        """One-step-ahead prediction residuals per series.

        The whiteness diagnostic for the fitted model (no reference
        equivalent): standardized innovations of a well-specified model
        are ~N(0, 1) and serially uncorrelated, so structure left in
        them (drift, autocorrelation, fat tails, a single outlying
        date) localizes what the model misses.  Masked/missing dates
        are NaN.

        Parameters
        ----------
        p : optional parameter array; defaults to the fitted (or
            initial) parameters, like the other accessors.
        standardized : divide each residual by its predicted standard
            deviation (scale-free, the diagnostic default).  With
            ``False``, residuals are in standardized-observation units
            (the units the filter runs in; multiply by
            ``oseries_std`` for the original units).
        warmup : NaN out the first ``warmup`` timesteps.  The filter
            starts from mean 0 / covariance I rather than the
            stationary prior, so the earliest dates can sit outside
            the N(0, 1) band purely from the initialization transient
            (a stretch of the order of the longest ``alpha`` time
            scale); pass e.g. ``warmup=50`` when that matters.
        """
        self._run_kalman("filter", p=p)
        v, _ = self.kf.innovations(standardized=standardized, warmup=warmup)
        return DataFrame(v, index=self.oseries.index, columns=self.oseries.columns)

    def sample_simulation(
        self, name, n_draws: int = 100, seed: int = 0, p=None,
        standardized: bool = False,
    ) -> DataFrame:
        """Joint posterior sample paths of one series' latent signal.

        Durbin-Koopman simulation smoother draws
        (:func:`metran_tpu_torch.ops.kalman.sample_states`, projected
        through the observation matrix; the normals come from a
        ``torch.Generator`` seeded ``seed``, so the draws are not the JAX
        package's): each column is one complete path from the
        joint posterior, honoring the current masking.  Unlike
        :meth:`get_simulation`'s marginal confidence band, paths carry
        the cross-time dependence, so a functional of a whole path
        (an annual minimum over a gap, a crossing time) can be
        evaluated per draw and summarized — the stochastic gap-filling
        workflow.  With the DFM's zero observation noise, every path
        passes exactly through the observed values and spreads only
        where data is missing.

        Returns a (T, n_draws) DataFrame on the observation grid, in
        data units unless ``standardized``.
        """
        if name not in self.oseries.columns:
            logger.error("Unknown name: %s", name)
            return None
        self._run_kalman("smoother", p=p)
        idx = int(list(self.oseries.columns).index(name))
        draws = self.kf.sample_states(int(seed), n_draws=int(n_draws))
        z = np.asarray(
            self.get_observation_matrix(p=p)
            if standardized else self.get_scaled_observation_matrix(p=p)
        )
        paths = np.asarray(draws) @ z[idx]
        if not standardized:
            paths = paths + float(np.asarray(self.oseries_mean)[idx])
        return DataFrame(
            paths.T, index=self.oseries.index,
            columns=[f"draw{j}" for j in range(int(n_draws))],
        )

    def test_whiteness(
        self, p=None, lags: int = 20, warmup: int = 50,
        alpha: float = 0.05, n_params: int = 0,
    ) -> DataFrame:
        """Ljung-Box whiteness test on the standardized innovations.

        The quantitative companion of :meth:`get_innovations` /
        ``plots.innovations`` (no reference equivalent): one row per
        series with the portmanteau Q statistic over ``lags`` lags, its
        p-value, and the boolean verdict at ``alpha``.  A False
        ``white`` flags serial structure the fitted model does not
        capture in that series.  ``warmup`` (default 50) excludes the
        filter's initialization transient; ``n_params`` optionally
        corrects the degrees of freedom for fitted parameters (see
        :func:`metran_tpu_torch.diagnostics.ljung_box`).
        """
        from ..diagnostics import whiteness_table

        innov = self.get_innovations(p=p, warmup=warmup)
        table = whiteness_table(
            innov, lags=lags, n_params=n_params, alpha=alpha
        )
        # nullable boolean: <NA> means "not testable", which is
        # neither passing nor failing
        failing = [str(s) for s in table.index[table["white"].eq(False).fillna(False)]]
        if failing:
            logger.info(
                "Ljung-Box rejects whiteness at alpha=%g for: %s",
                alpha, ", ".join(failing),
            )
        return table

    def _forecast_moments(self, steps, p=None, standardized=False):
        self._run_kalman("filter", p=p)
        if standardized:
            observation_matrix = self.get_observation_matrix(p=p)
            observation_means = np.zeros(self.nseries)
        else:
            observation_matrix = self.get_scaled_observation_matrix(p=p)
            observation_means = self.oseries_mean
        means, variances = self.kf.forecast(observation_matrix, steps)
        index = date_range(
            self.oseries.index[-1], periods=steps + 1,
            freq=self.settings["freq"],
        )[1:]
        return means, variances, observation_means, index

    def get_forecast_means(
        self, steps: int, p=None, standardized: bool = False
    ) -> DataFrame:
        """Out-of-sample forecast means for every series, ``steps``
        grid periods beyond the last observation.

        A capability the reference does not have (its products end at
        the data, `metran/kalmanfilter.py:569-644`):
        closed-form h-step-ahead predictive moments from the filtered
        state at ``T`` (:mod:`metran_tpu_torch.ops.forecast`, K2).  Forecasts
        decay toward each series' unconditional mean with variances
        growing to the stationary variance.
        """
        means, _, observation_means, index = self._forecast_moments(
            steps, p=p, standardized=standardized
        )
        return (
            DataFrame(means, index=index, columns=self.oseries.columns)
            + observation_means
        )

    def get_forecast_variances(
        self, steps: int, p=None, standardized: bool = False
    ) -> DataFrame:
        """Out-of-sample forecast variances (see :meth:`get_forecast_means`)."""
        _, variances, _, index = self._forecast_moments(
            steps, p=p, standardized=standardized
        )
        return DataFrame(variances, index=index, columns=self.oseries.columns)

    def forecast(
        self, name, steps: int = 30, p=None, alpha=0.05,
        standardized: bool = False,
    ):
        """Forecast one series ``steps`` periods ahead, with a
        ``(1 - alpha)`` prediction interval (same contract as
        :meth:`get_simulation`; ``alpha=None`` returns the mean only).
        """
        if name not in self.oseries.columns:
            logger.error("Unknown name: %s", name)
            return None
        if alpha is not None and not 0 < alpha < 1:
            msg = "The value of alpha must be between 0 and 1."
            logger.error(msg)
            raise Exception(msg)
        # one moments pass covers both the mean and the interval
        means, variances, observation_means, index = self._forecast_moments(
            steps, p=p, standardized=standardized
        )
        col = list(self.oseries.columns).index(name)
        fc = Series(
            means[:, col] + observation_means[col], index=index, name=name
        )
        if alpha is None:
            return fc
        z = norm.ppf(1 - alpha / 2.0)
        iv = z * np.sqrt(variances[:, col])
        fc = concat([fc, fc - iv, fc + iv], axis=1)
        fc.columns = ["mean", "lower", "upper"]
        return fc

    def decompose_simulation(
        self, name, p=None, standardized: bool = False, method: str = "smoother"
    ):
        if name not in self.oseries.columns:
            logger.error("Unknown name: %s", name)
            return None
        self._run_kalman(method, p=p)
        if standardized:
            observation_matrix = self.get_observation_matrix(p=p)
            observation_means = np.zeros(self.nseries)
        else:
            observation_matrix = self.get_scaled_observation_matrix(p=p)
            observation_means = self.oseries_mean
        sdf, cdf = self.kf.decompose(observation_matrix, method=method)
        col = list(self.oseries.columns).index(name)
        parts = [
            Series(sdf[:, col] + observation_means[col], index=self.oseries.index)
        ]
        cols = ["sdf"]
        for k in range(self.nfactors):
            parts.append(Series(cdf[k][:, col], index=self.oseries.index))
            cols.append(f"cdf{k + 1}")
        df = concat(parts, axis=1)
        df.columns = cols
        return df

    # ------------------------------------------------------------------
    # solve
    # ------------------------------------------------------------------
    def solve(
        self,
        solver=None,
        report: bool = True,
        engine: Optional[str] = None,
        init: str = "reference",
        **kwargs,
    ) -> None:
        """Estimate parameters by maximum likelihood.

        Parameters
        ----------
        solver : solver class (not instance), optional
            ``ScipySolve``, ``JaxSolve`` or ``LanesSolve``.  Default:
            device-aware — ``ScipySolve`` on the CPU (reference parity);
            on the card ``LanesSolve`` (the fleet lanes engine at batch
            1, lanes-fd standard errors), falling back to ``JaxSolve``
            when some parameters are fixed or bounded otherwise (its
            exact-Hessian standard errors on the card are ROADMAP A3).
        report : bool, optional
            Print fit and metran reports when done.
        engine : str, optional
            Kalman engine override (see the class doc).
        init : str or None, optional
            Initial-parameter strategy: "reference" (constant alpha=10,
            reference parity), "autocorr" (data-driven lag-1
            autocorrelation seed — same optimum, fewer iterations; see
            :meth:`set_init_parameters`), or ``None`` to keep a
            hand-edited ``parameters["initial"]`` table (warm starts;
            built with the default method first if the table is empty).
        **kwargs
            Passed through to the solver's minimize call.
        """
        factors = self.get_factors(self.oseries)
        if factors is None:
            return
        self._init_kalmanfilter(engine=engine)
        if init is not None:
            self.set_init_parameters(method=init)
        elif self.parameters is None or len(self.parameters) != (
            self.nseries + self.nfactors
        ):
            # init=None promises "keep my hand-edited table", but the
            # table is absent or inconsistent with the factor structure
            # (__init__ seeds sdf rows before factors exist, so "non-
            # empty" alone is not "usable") — build the default one
            self.set_init_parameters()

        if solver is None:
            if self.device.type != "cpu":
                # the lanes engine optimizes every parameter over the
                # standard box; other fits take JaxSolve, as in the JAX
                # package
                desired = (
                    LanesSolve if LanesSolve.supports(self) else JaxSolve
                )
            else:
                desired = ScipySolve
            # the auto-choice is parameter-table-dependent, so a cached
            # AUTO-selected solver is re-validated each solve (in both
            # directions); an explicitly requested solver stays sticky
            if self.fit is None or (
                getattr(self, "_fit_auto", False)
                and not isinstance(self.fit, desired)
            ):
                self.fit = desired(mt=self)
                self._fit_auto = True
        else:
            if self.fit is None or not isinstance(self.fit, solver):
                self.fit = solver(mt=self)
            # an explicit request always pins the choice, even when the
            # cached instance already matches (it may have been cached
            # by auto-selection)
            self._fit_auto = False
        self.settings["solver"] = self.fit._name

        success, optimal, stderr = self.fit.solve(**kwargs)

        # solver works in the parameter-table row order
        self.parameters["optimal"] = optimal
        self.parameters["stderr"] = stderr

        if not success:
            logger.warning("Model parameters could not be estimated well.")

        # basin-failure guard: from some starting points (notably the
        # constant init on panels whose specific parts are near-white)
        # L-BFGS slides EVERY alpha to the lower bound, a local optimum
        # where the model explains nothing — innovations then inherit
        # the data's full autocorrelation (tests/test_diagnostics.py
        # reproduces this).  Detectable, so say it.
        # "collapsed" = the AR decay is effectively white at this grid:
        # phi = exp(-dt/alpha) < e^-10 ~ 5e-5, i.e. alpha < dt/10 — tied
        # to the actual grid step rather than a fixed constant so the
        # guard tracks pmin/dt if either changes
        opt = np.asarray(optimal, float)
        collapse_thresh = float(self._dt) / 10.0
        if np.isfinite(opt).all() and (opt < collapse_thresh).all():
            remedy = (
                "Retry with solve(init='autocorr') (data-driven "
                "starting point)"
                if init != "autocorr" else
                "The data-driven init also landed here — try explicit "
                "initial values (parameters['initial']) or a different "
                "solver"
            )
            logger.warning(
                "All AR time scales collapsed to the lower bound — this "
                "is typically a local optimum where the model explains "
                "nothing.  %s, and check test_whiteness().", remedy,
            )

        if report:
            output = report if isinstance(report, str) else "full"
            print("\n" + self.fit_report(output=output))
            print("\n" + self.metran_report())

    # ------------------------------------------------------------------
    # persistence (new capability; the reference has none, SURVEY.md §5)
    # ------------------------------------------------------------------
    def to_file(self, path):
        """Serialize the model to a JSON file: not ported yet."""
        raise _not_ported("to_file")

    @classmethod
    def from_file(cls, path) -> "Metran":
        """Load a model saved with :meth:`to_file`: not ported yet."""
        raise _not_ported("from_file")

    def to_posterior_state(self, model_id=None, p=None):
        """Freeze this model into a serving :class:`~metran_tpu_torch.
        serve.PosteriorState` (filtered posterior at the last timestep
        plus matrices and scaler stats) for the online-assimilation
        service; see :mod:`metran_tpu_torch.serve`."""
        from ..serve.state import posterior_state_from_metran

        return posterior_state_from_metran(self, model_id=model_id, p=p)

    # ------------------------------------------------------------------
    # reports
    # ------------------------------------------------------------------
    def _get_file_info(self) -> dict:
        file_info = getattr(self, "file_info", None) or {
            "date_created": Timestamp.now()
        }
        file_info["date_modified"] = Timestamp.now()
        from .. import __version__

        file_info["metran_tpu_torch_version"] = __version__
        try:
            file_info["owner"] = getlogin()
        except Exception:
            file_info["owner"] = "Unknown"
        return file_info

    def fit_report(self, output: str = "full") -> str:
        """Fit statistics + parameter table (+|rho|>0.5 correlations).

        Same sections and layout as the reference (``metran/metran.py:
        1079-1183``).
        """
        model = {
            "tmin": str(self.settings["tmin"]),
            "tmax": str(self.settings["tmax"]),
            "freq": self.settings["freq"],
            "solver": self.settings["solver"],
        }
        fit = {
            "obj": f"{self.fit.obj_func:.2f}",
            "nfev": self.fit.nfev,
            "AIC": f"{self.fit.aic:.2f}",
            "": "",
        }
        parameters = self.parameters.loc[
            :, ["optimal", "stderr", "initial", "vary"]
        ].copy()
        stderr_pct = parameters["stderr"] / parameters["optimal"]
        parameters["stderr"] = "-"
        parameters.loc[parameters["vary"].astype(bool), "stderr"] = (
            stderr_pct.abs().apply("±{:.2%}".format)
        )
        parameters["initial"] = parameters["initial"].astype(str)
        parameters.loc[~parameters["vary"].astype(bool), "initial"] = "-"

        width = len(str(parameters).split("\n")[1])
        w = max(width - 45, 0)
        header = (
            f"Fit report {self.name[:14]:<16}{'':>{w}}Fit Statistics\n"
            + "=" * width
            + "\n"
        )
        basic = ""
        for (k1, v1), (k2, v2) in zip(model.items(), fit.items()):
            basic += f"{k1:<8} {str(v1):<16} {'':>{w}} {k2:<7} {v2:>{max(w, 1)}}\n"

        block = (
            f"\nParameters ({int(parameters.vary.sum())} were optimized)\n"
            + "=" * width
            + f"\n{parameters}"
        )

        correlations = ""
        if output == "full" and self.fit.pcor is not None:
            cor = {}
            pcor = self.fit.pcor
            for idx in pcor.index:
                for col in pcor.columns:
                    if (
                        abs(pcor.loc[idx, col]) > 0.5
                        and idx != col
                        and (col, idx) not in cor
                    ):
                        cor[(idx, col)] = round(pcor.loc[idx, col], 2)
            body = (
                DataFrame(cor.values(), index=cor.keys(), columns=["rho"]).to_string(
                    header=False
                )
                if cor
                else "None"
            )
            correlations = (
                "\n\nParameter correlations |rho| > 0.5\n" + "=" * width + "\n" + body
            )
        note = ""
        if getattr(self.fit, "nonpsd_pcov", False):
            note = (
                "\n\nWarning: parameter covariance was not positive "
                "semi-definite;\nnegative variances were clipped to "
                "zero — treat the affected\nstderr values as "
                "unreliable (flat or degenerate optimum)."
            )
        tele = ""
        telemetry = getattr(self.fit, "telemetry", None)
        if telemetry is not None and telemetry.stop_reason is not None:
            # why the optimizer stopped (obs.FitTelemetry, filled by
            # JaxSolve's run_lbfgs): stop reason, checkpointed deviance
            # drop, gradient norm, line-search stalls, divergence
            tele = ("\n\nFit telemetry\n" + "=" * width + "\n"
                    + telemetry.summary())
        return header + basic + block + correlations + note + tele

    def metran_report(self, output: str = "full") -> str:
        """Factor analysis, communality, state/observation parameters
        (+|rho|>0.5 state correlations); reference ``metran/metran.py:
        1185-1314``."""
        model = {
            "tmin": str(self.settings["tmin"]),
            "tmax": str(self.settings["tmax"]),
            "freq": self.settings["freq"],
        }
        fit = {"nfct": str(self.nfactors), "fep": f"{self.fep:.2f}%", "": ""}

        phi = np.diag(self.get_transition_matrix())
        q = self.get_transition_variance()
        names = self._state_columns()
        transition = DataFrame(np.array([phi, q]).T, index=names, columns=["phi", "q"])
        idx_width = max(len(n) for n in transition.index)

        communality = Series(
            self.get_communality(), index=self.oseries.columns, name=""
        )
        communality.index = [str(i).ljust(idx_width) for i in communality.index]
        communality = communality.apply("{:.2%}".format).to_frame()

        observation = DataFrame(
            self.factors,
            index=self.oseries.columns,
            columns=[f"gamma{i + 1}" for i in range(self.nfactors)],
        )
        observation.index = [str(i).ljust(idx_width) for i in observation.index]
        observation["scale"] = self.oseries_std
        observation["mean"] = self.oseries_mean

        width = max(
            len(str(transition).split("\n")[1]),
            len(str(observation).split("\n")[1]),
            44,
        )
        w = max(width - 43, 0)
        header = (
            f"Metran report {self.name[:14]:<14}{'':>{w}}Factor Analysis\n"
            + "=" * width
            + "\n"
        )
        factors = ""
        for (k1, v1), (k2, v2) in zip(model.items(), fit.items()):
            factors += f"{k1:<8} {str(v1):<19} {k2:<7} {str(v2):>{max(w, 1)}}\n"

        blocks = (
            "\nCommunality\n" + "=" * width + f"\n{communality}\n"
            "\nState parameters\n" + "=" * width + f"\n{transition}\n"
            "\nObservation parameters\n" + "=" * width + f"\n{observation}\n"
        )

        correlations = ""
        if output == "full":
            cor = {}
            pcor = self.get_state_means().corr()
            for idx in pcor.index:
                for col in pcor.columns:
                    if (
                        abs(pcor.loc[idx, col]) > 0.5
                        and idx != col
                        and (col, idx) not in cor
                    ):
                        cor[(idx, col)] = round(pcor.loc[idx, col], 2)
            body = (
                DataFrame(cor.values(), index=cor.keys(), columns=["rho"]).to_string(
                    header=False
                )
                if cor
                else "None"
            )
            correlations = (
                "\nState correlations |rho| > 0.5\n" + "=" * width + "\n" + body + "\n"
            )
        return header + factors + blocks + correlations
