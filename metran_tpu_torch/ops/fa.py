"""Factor analysis: eigendecomposition, Velicer MAP test, minres, varimax.

Port of ``metran_tpu/ops/fa.py``, a copy (the port imports nothing of
the JAX package; the code is the same, so the factors agree to rounding).
Host-side (numpy/scipy) implementation of the classical factor-analysis
pipeline the reference runs once per model fit (``metran/factoranalysis.py``):
correlation -> eigendecomposition -> MAP test (Kaiser fallback) -> minres
loadings -> varimax rotation -> sign convention.  These matrices are tiny
(n_series x n_series); the payoff on the card comes from batching fits, not from
accelerating a 5x5 eigendecomposition, so this stays numpy with scipy's
L-BFGS-B for minres — mirroring the reference's optimizer so fitted loadings
agree to near machine precision.

Two behavioral quirks of the reference are preserved under
``mode="reference"`` (the default, needed for golden-value parity) and
corrected under ``mode="textbook"``:

1. ``_minresfun`` (``factoranalysis.py:314-347``) builds the candidate
   loading matrix from ``np.linalg.eigh`` output sliced ``[:nf]`` — eigh
   returns eigenvalues in *ascending* order, so the objective uses the
   smallest eigenpairs.  (The analytic jacobian uses ``np.linalg.eig``
   whose LAPACK ordering is effectively descending, which is what steers
   L-BFGS-B to the classical solution anyway.)
2. ``_maptest`` (``factoranalysis.py:219-312``) writes its criterion table
   with ``np.put`` flat indices, so entry ``[m+1, 1]`` actually lands at
   flat positions ``m+1`` and ``1``.  In practice the negative-partial-
   variance early exit (returning 1 factor) fires for strongly correlated
   data, which is why the reference still behaves sensibly.
"""

from __future__ import annotations

from dataclasses import dataclass
from logging import getLogger
from typing import Optional, Tuple

import numpy as np
import scipy.optimize as scopt

logger = getLogger(__name__)


def correlation_matrix(oseries) -> np.ndarray:
    """Pairwise-complete correlation matrix of a DataFrame (or 2-D array)."""
    import pandas as pd

    if not isinstance(oseries, pd.DataFrame):
        oseries = pd.DataFrame(np.asarray(oseries))
    return np.asarray(oseries.corr())


def sorted_scaled_eig(corr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Eigenvalues (descending, negatives clipped to 0) and eigenvectors
    scaled by sqrt(eigenvalue) — i.e. principal-component loadings.

    Raises if the decomposition is complex (reference guard,
    ``factoranalysis.py:446-453``); on a symmetric correlation matrix this
    cannot trigger, but the guard is kept for non-symmetric input.
    """
    eigval, eigvec = np.linalg.eig(corr)
    if np.iscomplexobj(eigval):
        msg = (
            "Serial correlation matrix has complex eigenvalues and "
            "eigenvectors. Factors cannot be estimated for these series."
        )
        logger.error(msg)
        raise Exception(msg)
    order = np.argsort(-eigval)
    eigval = eigval[order]
    eigval[eigval < 0] = 0.0
    eigvec = eigvec[:, order] @ np.sqrt(np.diag(eigval))
    return eigval, np.atleast_2d(eigvec)


def _map_criteria(cov: np.ndarray, eigvec: np.ndarray):
    """Average squared (and 4th-power) partial correlations after removing
    the first m+1 principal components, for m = 0..nvars-2.

    Returns (vals, vals4, early_exit) where early_exit=True means a partial
    covariance had a negative diagonal (reference returns 1 factor then).
    """
    nvars = cov.shape[0]
    denom = nvars * (nvars - 1)
    vals, vals4 = [], []
    for m in range(nvars - 1):
        a = np.atleast_2d(eigvec[:, : m + 1])
        partcov = cov - a @ a.T
        diag = np.diag(partcov)
        if diag.min() < 0:
            return vals, vals4, True
        # a zero partial variance yields inf/nan entries, matching the
        # reference's arithmetic (it early-exits only on NEGATIVE
        # diagonals); silence the numpy warnings, keep the values
        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.diag(1.0 / np.sqrt(diag))
            pr = d @ partcov @ d
        vals.append((np.sum(pr**2) - nvars) / denom)
        vals4.append((np.sum(pr**4) - nvars) / denom)
    return vals, vals4, False


def map_test(
    cov: np.ndarray, eigvec: np.ndarray, mode: str = "reference"
) -> Tuple[int, int]:
    """Velicer's MAP test (original and revised 4th-power variants).

    mode="reference" reproduces the reference's np.put flat-indexing table
    layout; mode="textbook" implements the published test.
    """
    nvars = cov.shape[0]
    denom = nvars * (nvars - 1)
    base = (np.sum(cov**2) - nvars) / denom
    base4 = (np.sum(cov**4) - nvars) / denom
    vals, vals4, early = _map_criteria(cov, eigvec)
    if early:
        return 1, 1

    if mode == "textbook":
        crit = np.array([base] + vals)
        crit4 = np.array([base4] + vals4)
        return int(np.argmin(crit)), int(np.argmin(crit4))

    # --- reference-compatible table construction -------------------------
    def scrambled(b, v):
        # Emulate: fm = [[0..nvars-1], [0..nvars-1]].T; np.put(fm,[0,1],b);
        # then per m: np.put(fm,[m+1,1],v[m]).  Selection scans column 1
        # keeping the first strict minimum.
        fm = np.array(
            [np.arange(nvars, dtype=float), np.arange(nvars, dtype=float)]
        ).T
        np.put(fm, [0, 1], b)
        for m, vm in enumerate(v):
            np.put(fm, [m + 1, 1], vm)
        running = fm[0, 1]
        nfacts = 0
        for s in range(nvars):
            if fm[s, 1] < running:
                running = fm[s, 1]
                nfacts = s
        return nfacts

    return scrambled(base, vals), scrambled(base4, vals4)


def _minres_objective(psi: np.ndarray, s: np.ndarray, nf: int, mode: str):
    """Off-diagonal squared residual of ``s_psi - L L'``.

    Candidate loadings come from the eigendecomposition of the reduced
    correlation matrix (diag replaced by ``1 - psi``); see module docstring
    for the mode="reference" ordering quirk.
    """
    s2 = s.copy()
    np.fill_diagonal(s2, 1.0 - psi)
    eigval, eigvec = np.linalg.eigh(s2)  # ascending
    eps = np.finfo(float).eps
    eigval = np.where(eigval < eps, 100 * eps, eigval)
    if mode == "textbook":
        eigval = eigval[::-1]
        eigvec = eigvec[:, ::-1]
    if nf > 1:
        loadings = eigvec[:, :nf] @ np.diag(np.sqrt(eigval[:nf]))
    else:
        loadings = eigvec[:, :1] * np.sqrt(eigval[0])
    residual = (s2 - loadings @ loadings.T) ** 2
    np.fill_diagonal(residual, 0.0)
    return np.sum(residual)


def psi_to_loadings(
    psi: np.ndarray, s: np.ndarray, nf: int, mode: str = "reference"
) -> np.ndarray:
    """Loadings implied by a uniqueness vector ``psi`` (minres extraction).

    ``sstar = diag(psi)^-1/2 s diag(psi)^-1/2``; the top ``nf`` eigenpairs
    give ``L = diag(sqrt(psi)) V sqrt(max(lambda - 1, 0))``.  In
    mode="reference" the LAPACK ``eig`` ordering is used unsorted, exactly
    as ``_get_loadings`` (``factoranalysis.py:375-401``) does.
    """
    sc = np.diag(1.0 / np.sqrt(psi))
    sstar = sc @ s @ sc
    if mode == "textbook":
        eigval, eigvec = np.linalg.eigh(sstar)
        eigval, eigvec = eigval[::-1], eigvec[:, ::-1]
    else:
        eigval, eigvec = np.linalg.eig(sstar)
    load = eigvec[:, :nf] @ np.diag(np.sqrt(np.maximum(eigval[:nf] - 1.0, 0.0)))
    return np.diag(np.sqrt(psi)) @ load


def _minres_jac(psi, s, nf, mode):
    load = psi_to_loadings(psi, s, nf, mode)
    g = load @ load.T + np.diag(psi) - s
    return np.diag(g) / psi**2


def minres(
    s: np.ndarray, nf: int, mode: str = "reference"
) -> Optional[np.ndarray]:
    """Minimum-residual factor loadings via bounded L-BFGS-B over psi.

    Returns None when the correlation matrix cannot be inverted for the
    SMC-based start (reference bare-except path, ``factoranalysis.py:
    199-200``).
    """
    try:
        ssmc = 1.0 - 1.0 / np.diag(np.linalg.inv(s))
        if np.sum(ssmc) == nf and nf > 1:
            start = 0.5 * np.ones(nf)
        else:
            start = np.diag(s) - ssmc
    except Exception:
        return None

    res = scopt.minimize(
        _minres_objective,
        start,
        method="L-BFGS-B",
        jac=_minres_jac,
        bounds=[(0.005, 1.0)] * len(start),
        args=(s, nf, mode),
    )
    return psi_to_loadings(res.x, s, nf, mode)


def varimax(
    phi: np.ndarray, gamma: float = 1.0, maxiter: int = 20, tol: float = 1e-6
) -> np.ndarray:
    """Orthogonal (varimax for gamma=1) rotation by SVD iteration.

    Kaiser (1958); same iteration and stopping rule as the reference's
    ``_rotate`` (``factoranalysis.py:120-171``).
    """
    p, k = phi.shape
    rot = np.eye(k)
    d = 0.0
    for _ in range(maxiter):
        d_old = d
        lam = phi @ rot
        u, s, vh = np.linalg.svd(
            phi.T @ (lam**3 - (gamma / p) * lam @ np.diag(np.diag(lam.T @ lam)))
        )
        rot = u @ vh
        d = np.sum(s)
        if d_old != 0 and d / d_old < 1 + tol:
            break
    return phi @ rot


def fix_signs(factors: np.ndarray) -> np.ndarray:
    """Flip any factor column whose entry sum is negative (nonzero entries
    only, matching the reference's sign convention loop)."""
    factors = factors.copy()
    for j in range(factors.shape[1]):
        if factors[:, j].sum() < 0:
            nz = np.sign(factors[:, j]) != 0
            factors[nz, j] *= -1.0
    return factors


@dataclass
class FAResult:
    eigval: np.ndarray
    nfactors: int
    factors: Optional[np.ndarray]  # (n_series, nfactors) or None
    fep: Optional[float]  # percentage explained by kept factors


def factor_analysis(
    corr: np.ndarray, maxfactors: Optional[int] = None, mode: str = "reference"
) -> FAResult:
    """Full pipeline: eig -> MAP (Kaiser fallback) -> minres -> varimax.

    Behavior parity with ``FactorAnalysis.solve`` (``factoranalysis.py:
    42-118``) including the nfactors==0 / all-zero-loadings "no proper
    factors" path (factors=None).
    """
    eigval, eigvec = sorted_scaled_eig(corr)
    try:
        nfactors, _ = map_test(corr, eigvec, mode=mode)
        logger.info("Number of factors according to Velicer's MAP test: %d", nfactors)
        if nfactors == 0:
            nfactors = int(np.sum(eigval > 1))
            logger.info("Number of factors according to Kaiser criterion: %d", nfactors)
        if maxfactors is not None:
            nfactors = min(nfactors, maxfactors)
    except Exception:
        nfactors = 0

    factors = minres(corr, nfactors, mode=mode) if nfactors >= 0 else None

    if nfactors > 0 and factors is not None and np.count_nonzero(factors) > 0:
        if nfactors > 1:
            comm = np.sum(factors[:, :nfactors] ** 2, axis=1)
            normalized = factors[:, :nfactors] / np.sqrt(comm)[:, None]
            factors = varimax(normalized) * np.sqrt(comm)[:, None]
        factors = fix_signs(np.atleast_2d(factors[:, :nfactors]))
        fep = 100.0 * np.sum(eigval[:nfactors] / np.sum(eigval))
        return FAResult(eigval=eigval, nfactors=nfactors, factors=factors, fep=fep)

    logger.warning("No proper common factors could be derived from series.")
    return FAResult(eigval=eigval, nfactors=0, factors=None, fep=None)
