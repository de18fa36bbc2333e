"""FactorAnalysis model class (API-compatible with the reference).

Port of ``metran_tpu/models/factoranalysis.py`` (a copy). Thin stateful
wrapper around :mod:`metran_tpu_torch.ops.fa` exposing the same
surface as the reference class (``metran/factoranalysis.py:13-118``):
``solve(oseries) -> loadings`` plus ``eigval``/``fep``/``factors``
attributes and ``get_eigval_weight``.  Underscored helpers are provided as
aliases so code written against the reference keeps working.
"""

from __future__ import annotations

from logging import getLogger
from typing import Optional

import numpy as np

from ..ops import fa as _fa

logger = getLogger(__name__)


class FactorAnalysis:
    """Estimate factor loadings of multivariate series by minres.

    Parameters
    ----------
    maxfactors : int, optional
        Maximum number of factors to keep.
    mode : str, optional
        "reference" (default) reproduces the reference implementation's
        numerical behavior exactly; "textbook" uses the corrected MAP test
        and descending eigen-ordering (see ops/fa.py docstring).

    Examples
    --------
    >>> fa = FactorAnalysis()
    >>> factors = fa.solve(oseries)
    """

    def __init__(self, maxfactors: Optional[int] = None, mode: str = "reference"):
        self.maxfactors = maxfactors
        self.mode = mode
        self.eigval: Optional[np.ndarray] = None
        self.factors: Optional[np.ndarray] = None
        self.fep: Optional[float] = None

    def get_eigval_weight(self) -> np.ndarray:
        """Each eigenvalue as a fraction of the eigenvalue sum."""
        return self.eigval / np.sum(self.eigval)

    def solve(self, oseries) -> Optional[np.ndarray]:
        """Run the full factor-analysis pipeline on a series DataFrame.

        Returns the (n_series, n_factors) loading matrix, or None when no
        proper common factors can be derived (callers treat that as a
        failed model, matching the reference).
        """
        corr = _fa.correlation_matrix(oseries)
        result = _fa.factor_analysis(corr, maxfactors=self.maxfactors, mode=self.mode)
        self.eigval = result.eigval
        self.factors = result.factors
        self.fep = result.fep
        return self.factors

    # ------------------------------------------------------------------
    # drop-in aliases for the reference's underscored API
    # ------------------------------------------------------------------
    @staticmethod
    def _get_correlations(oseries):
        return _fa.correlation_matrix(oseries)

    @staticmethod
    def _get_eigval(correlation):
        return _fa.sorted_scaled_eig(correlation)

    def _maptest(self, cov, eigvec, eigval=None):
        return _fa.map_test(cov, eigvec, mode=self.mode)

    def _minres(self, s, nf, covar=False):
        return _fa.minres(s, nf, mode=self.mode)

    @staticmethod
    def _rotate(phi, gamma=1, maxiter=20, tol=1e-6):
        return _fa.varimax(phi, gamma=gamma, maxiter=maxiter, tol=tol)
