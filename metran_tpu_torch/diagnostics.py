"""Quantitative residual diagnostics for fitted models.

Port of ``metran_tpu/diagnostics.py`` (a copy: the port imports nothing
of the JAX package).  The reference ships no residual diagnostics at all
(its products end at simulation/decomposition,
``metran/kalmanfilter.py:569-644``); this module turns innovations
(:func:`metran_tpu_torch.parallel.fleet_innovations`) into test
statistics, so "is this fit adequate" is a number rather than a visual
judgement.

Host-side numpy by design: the statistics are O(T * lags) on data that
already lives on host as DataFrames, far below any dispatch-worthy
size.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.stats import chi2


class LjungBoxResult(NamedTuple):
    """Per-series Ljung-Box portmanteau test results (arrays of shape
    (n_series,))."""

    q: np.ndarray  # Q statistic
    pvalue: np.ndarray  # chi-squared survival value at dof
    dof: np.ndarray  # degrees of freedom used
    nobs: np.ndarray  # finite observations entering the statistic


def ljung_box(
    v: np.ndarray, lags: int = 20, n_params: int = 0
) -> LjungBoxResult:
    """Ljung-Box whiteness test per residual series.

    Portmanteau statistic over lags ``1..lags`` on the standardized
    one-step-ahead innovations; under the null of a well-specified
    model Q is approximately chi-squared with ``lags - n_params``
    degrees of freedom, so a small p-value means serial structure the
    model missed.

    Missing values (NaN) are handled pairwise: lag ``k``'s
    autocorrelation ``rho_k`` uses the ``n_k`` pairs where both
    endpoints are observed, normalized by the series' overall second
    moment (innovations have mean 0 and unit variance under the null),
    and each lag contributes ``n_k * rho_k^2`` to Q — the
    exact-variance weighting (``var(rho_k) ~ 1/n_k``), which for
    complete data reduces to the textbook ``(n-k) rho_k^2`` per-lag
    term.  The classic ``n(n+2)/(n-k)`` factor would over-reject under
    missingness, where ``n_k`` is systematically smaller than ``n``.

    Parameters
    ----------
    v : (T,) or (T, n_series) standardized innovations, NaN where
        missing (one model's ``fleet_innovations`` output; pass a
        ``warmup`` there so the filter's initialization transient does
        not register as model failure).
    lags : highest lag in the statistic; series shorter than
        ``lags + 1`` finite points get NaN results.
    n_params : degrees-of-freedom correction for fitted parameters
        (the classic ARMA correction).  For a DFM there is no single
        right value (each series carries one specific ``alpha`` and a
        share of the common ones); the default 0 is conservative
        toward flagging.
    """
    v = _host(v)
    if v.ndim == 1:
        v = v[:, None]
    if v.ndim != 2:
        raise ValueError(f"expected (T,) or (T, n) residuals, got {v.shape}")
    if not 0 < lags < v.shape[0]:
        raise ValueError(f"lags must be in [1, T); got {lags}, T={v.shape[0]}")
    n_series = v.shape[1]
    q = np.full(n_series, np.nan)
    pv = np.full(n_series, np.nan)
    dof = np.full(n_series, max(int(lags) - int(n_params), 1))
    nobs = np.zeros(n_series, dtype=int)
    for i in range(n_series):
        x = v[:, i]
        finite = np.isfinite(x)
        n = int(finite.sum())
        nobs[i] = n
        if n < lags + 1:
            continue
        m2 = float(np.mean(x[finite] ** 2))
        if m2 <= 0.0:
            continue
        acc = 0.0
        for k in range(1, int(lags) + 1):
            a, b = x[:-k], x[k:]
            ok = finite[:-k] & finite[k:]
            n_k = int(ok.sum())
            if n_k == 0:
                continue
            rho = float(np.mean(a[ok] * b[ok])) / m2
            acc += n_k * rho * rho
        q[i] = acc
        pv[i] = float(chi2.sf(q[i], dof[i]))
    return LjungBoxResult(q, pv, dof, nobs)


def _host(v):
    """``v`` as a float64 numpy array (a tensor comes off its device)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, float)


def fleet_whiteness(
    v, lags: int = 20, n_params: int = 0
) -> LjungBoxResult:
    """Ljung-Box over a fleet of innovation panels.

    ``v`` is the (B, T, N) residual array or tensor — the FIRST element
    of the ``(v, f)`` pair :func:`metran_tpu_torch.parallel.
    fleet_innovations` returns (standardized, NaN at missing/padded
    positions).  Returns
    a :class:`LjungBoxResult` whose arrays have shape (B, N) — one
    verdict per model and series.
    Padded series slots are all-NaN and come back NaN (untestable),
    matching the fleet padding convention.
    """
    v = _host(v)
    if v.ndim != 3:
        raise ValueError(f"expected (B, T, N) innovations, got {v.shape}")
    b, t, n = v.shape
    flat = np.moveaxis(v, 1, 0).reshape(t, b * n)
    res = ljung_box(flat, lags=lags, n_params=n_params)
    return LjungBoxResult(*(a.reshape(b, n) for a in res))


def whiteness_table(
    innovations_frame, lags: int = 20, n_params: int = 0,
    alpha: float = 0.05,
):
    """Ljung-Box results as a DataFrame indexed like the input columns.

    Columns: ``nobs``, ``Q``, ``dof``, ``pvalue`` and the nullable
    boolean ``white`` (``pvalue >= alpha`` — True means no evidence
    against whiteness at that level; ``<NA>`` means the test could not
    run, e.g. too few finite points for ``lags``).
    """
    from pandas import DataFrame, Series, isna

    res = ljung_box(innovations_frame.to_numpy(), lags=lags,
                    n_params=n_params)
    white = Series(
        res.pvalue >= alpha, dtype="boolean",
        index=list(innovations_frame.columns),
    ).mask(isna(res.pvalue))
    return DataFrame(
        {
            "nobs": res.nobs,
            "Q": res.q,
            "dof": res.dof,
            "pvalue": res.pvalue,
            "white": white,
        },
        index=list(innovations_frame.columns),
    )
