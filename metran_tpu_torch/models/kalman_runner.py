"""Stateful shell around the port's Kalman ops.

Port of ``metran_tpu/models/kalman_runner.py``.  Plays the role of the
reference's ``SPKalmanFilter`` object (``metran/kalmanfilter.py:479-778``):
holds the packed observations on the model's device, the currently-set
state-space matrices and lazily-cached filter/smoother results, so model
accessors re-use a single filter pass.  On ``engine="sequential"`` the
filter is the stored sequential filter (kernel K6 in its ``store``
mode), the smoother kernel K8 and the path draws K7 + K6 + K8; on
``engine="sqrt"`` the filter is the stored square-root filter (K9),
whose factors are cached and smoothed in factored form (K10), and the
path draws are K7 + K9 + K10; on the associative-scan engines the filter
and smoother are K19 and K20 (``"parallel"``) or K21 and K22
(``"sqrt_parallel"``, factors cached as on ``"sqrt"``), and the path
draws run their sequential twins, as in the JAX package (``"joint"``:
K7 + K1 ``store`` + K8; ``"sqrt"``: K7 + K9 + K10); the forecasts are K2
on every engine.  Accessors return numpy arrays.

The joint engine (its single-model products, ROADMAP A2) raises with
its ROADMAP item.
"""

from __future__ import annotations

from logging import getLogger
from typing import Optional

import numpy as np
import torch

from ..config import as_tensor
from ..data import Panel
from ..ops.kalman import (
    FilterResult,
    SmootherResult,
    _require,
    chol_outer,
    decompose_states,
    deviance_terms,
    innovations,
    kalman_filter,
    project,
    rts_smoother,
    sample_states,
    sqrt_kalman_filter,
)
from ..ops.pkalman import sqrt_parallel_filter
from ..ops.statespace import StateSpace

logger = getLogger(__name__)


#: the sequential twin that runs the per-draw passes of an
#: associative-scan engine (the JAX runner's mapping)
_DRAW_ENGINE = {"parallel": "joint", "sqrt_parallel": "sqrt"}


def check_engine(engine: str) -> str:
    """``engine`` when the runner has it (the sequential, square-root and
    associative-scan ones); the joint engine raises
    ``NotImplementedError`` naming its ROADMAP item."""
    _require(engine, ("sequential", "sqrt", "parallel", "sqrt_parallel"))
    return engine


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class KalmanRunner:
    """Caches filter/smoother products for the currently-set matrices.

    ``device``/``dtype``: where and in what precision the observations
    and matrices live (the model's).
    """

    def __init__(self, panel: Panel, engine: str = "sequential",
                 device=None, dtype=torch.float64):
        self.engine = check_engine(engine)
        self.device = torch.device(device)
        self.dtype = dtype
        self.mask_active = False  # True while masked observations are set
        self.set_observations(panel)
        self.ss: Optional[StateSpace] = None
        self.init_states()

    # mirror of the reference's cache-invalidation entry point
    def init_states(self) -> None:
        self.filtered: Optional[FilterResult] = None
        self.smoothed: Optional[SmootherResult] = None
        # the square-root engines: the factored filter pass is cached so
        # the smoother consumes factors, not reconstituted covariances
        self._sqrt_filtered = None

    def set_observations(self, panel: Panel) -> None:
        self.panel = panel
        self.y = as_tensor(panel.values, self.device, self.dtype)
        self.mask = as_tensor(panel.mask, self.device, torch.bool)
        self.init_states()

    def set_matrices(self, ss: StateSpace) -> None:
        self.ss = StateSpace(*(as_tensor(leaf, self.device, self.dtype)
                               for leaf in ss))
        self.init_states()

    def run_filter(self) -> FilterResult:
        if self.filtered is None:
            if self.mask_active:
                logger.info("Running Kalman filter with masked observations.")
            if self.engine in ("sqrt", "sqrt_parallel"):
                # one factored pass (K9 store, or K21), cached for the
                # smoother; the accessors read the reconstituted moments
                sq = (sqrt_parallel_filter(self.ss, self.y, self.mask)
                      if self.engine == "sqrt_parallel"
                      else sqrt_kalman_filter(self.ss, self.y, self.mask,
                                              store=True))
                self._sqrt_filtered = sq
                self.filtered = FilterResult(
                    sq.mean_p, chol_outer(sq.chol_p), sq.mean_f,
                    chol_outer(sq.chol_f), sq.sigma, sq.detf,
                )
            else:
                self.filtered = kalman_filter(self.ss, self.y, self.mask,
                                              engine=self.engine,
                                              store=True)
        return self.filtered

    def run_smoother(self) -> SmootherResult:
        if self.smoothed is None:
            filtered = self.run_filter()
            if self._sqrt_filtered is not None:
                # rts_smoother dispatches on the factored result (K10,
                # or K22 under sqrt_parallel)
                filtered = self._sqrt_filtered
            self.smoothed = rts_smoother(self.ss, filtered,
                                         engine=self.engine)
        return self.smoothed

    def get_mle(self, warmup: int = 1) -> float:
        res = self.run_filter()
        return float(deviance_terms(res.sigma, res.detf, self.mask,
                                    warmup=warmup))

    def _states(self, method: str):
        if method == "filter":
            res = self.run_filter()
            return res.mean_f, res.cov_f
        res = self.run_smoother()
        return res.mean_s, res.cov_s

    def state_means(self, method: str = "smoother") -> np.ndarray:
        return _host(self._states(method)[0])

    def state_variances(self, method: str = "smoother") -> np.ndarray:
        covs = self._states(method)[1]
        return _host(torch.diagonal(covs, dim1=-2, dim2=-1))

    def _z(self, observation_matrix):
        return as_tensor(np.asarray(observation_matrix, float), self.device,
                         self.dtype)

    def simulate(self, observation_matrix, method: str = "smoother"):
        means, covs = self._states(method)
        sim_means, sim_vars = project(self._z(observation_matrix), means,
                                      covs)
        return _host(sim_means), _host(sim_vars)

    def forecast(self, observation_matrix, steps: int):
        """h-step-ahead observation means/variances beyond the data end,
        from the filtered state at the last step (closed form, K2);
        ``observation_matrix`` chooses the units."""
        from ..ops.forecast import _forecast_from_filtered

        filt = self.run_filter()
        ss = self.ss._replace(z=self._z(observation_matrix))
        means, variances = _forecast_from_filtered(
            ss, filt.mean_f[-1], filt.cov_f[-1], int(steps))
        return _host(means), _host(variances)

    def innovations(self, standardized: bool = True, warmup: int = 0):
        """One-step-ahead prediction residuals from the cached filter
        pass; NaN where no observation is present or within the first
        ``warmup`` steps."""
        v, f = innovations(self.ss, self.y, self.mask,
                           filt=self.run_filter(), standardized=standardized,
                           warmup=int(warmup))
        return _host(v), _host(f)

    def sample_states(self, seed: int = 0, n_draws: int = 1,
                      draw_chunk: int = 8):
        """Joint posterior state-path draws (n_draws, T, n), reusing the
        cached smoother pass for the data side; the normals come from a
        ``torch.Generator`` on the model's device seeded ``seed``.  The
        associative-scan engines run the per-draw passes on their
        sequential twins (the same posterior, without a scan per
        draw)."""
        gen = torch.Generator(self.device).manual_seed(int(seed))
        return _host(sample_states(
            self.ss, self.y, self.mask, gen, n_draws=int(n_draws),
            engine=self.draw_engine, sm_data=self.run_smoother().mean_s,
            draw_chunk=draw_chunk))

    @property
    def draw_engine(self) -> str:
        """The engine of the per-draw passes of :meth:`sample_states`."""
        return _DRAW_ENGINE.get(self.engine, self.engine)

    def decompose(self, observation_matrix, method: str = "smoother"):
        means, _ = self._states(method)
        sdf, cdf = decompose_states(self._z(observation_matrix), means,
                                    self.panel.n_series)
        return _host(sdf), _host(cdf)
