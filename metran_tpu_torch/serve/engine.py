"""Serving kernels: batched incremental update and forecast per bucket.

Port of the joint- and square-root-engine halves of
``metran_tpu/serve/engine.py``.  The models of one shape bucket are
padded to the bucket's ``(N, S)`` and stacked along a leading batch
axis, and the per-model computation —
:func:`~metran_tpu_torch.ops.filter_append` (K1) or, on the square-root
engine, :func:`~metran_tpu_torch.ops.sqrt_filter_append` (K9 from the
stacked factors) for assimilation,
:func:`~metran_tpu_torch.ops.forecast_observation_moments` (K2) for
forecasts — runs as ONE kernel-wrapper call per dispatch.

Padding semantics (as in the JAX package): a padded observation slot is
masked False at every appended step and carries zero loadings, so it
never touches the gain, the likelihood terms or the real slots; a
padded state slot starts at the filter's ``N(0, 1)`` init with zero
cross-covariance and stays decoupled.

Gate, detect, robust and fused horizons come in later slices; asking
for them raises with the ROADMAP item.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..ops import (
    dfm_statespace,
    filter_append,
    forecast_observation_moments,
    sqrt_filter_append,
)
from ..ops.statespace import StateSpace

_LATER = {
    "gate": "ROADMAP A4.2 (serving features: observation gate, kernel B9b)",
    "detect": "ROADMAP A4.4 (serving features: detection, kernel B11)",
    "robust": "ROADMAP A4.3 (serving features: implicit MAP, kernel B12)",
    "horizons": "ROADMAP A4.5 (serving features: read path)",
    "sqrt_parallel": "ROADMAP A6 (associative-scan engine, kernel B8)",
}


def _not_ported(what: str):
    return ValueError(f"{what} is not ported yet: {_LATER[what]}")


class BucketBatch(NamedTuple):
    """A shape bucket's models stacked for one device dispatch; every
    leaf leads with the batch axis B.  ``chol`` is the stacked
    covariance factors when the bucket serves the square-root engine
    (``stack_bucket(..., sqrt=True)``; ``cov`` is then None)."""

    ss: StateSpace
    mean: torch.Tensor  # (B, S)
    cov: "torch.Tensor | None"  # (B, S, S)
    chol: "torch.Tensor | None" = None  # (B, S, S)


def posterior_fault(mean, cov, sym_rtol: float = 1e-4, psd_tol: float = 1e-4,
                    chol=None) -> "str | None":
    """Why a filtered posterior is numerically unserviceable, or ``None``.

    The per-slot integrity gate (host-side numpy, as in the JAX
    package): finite mean and covariance, a covariance symmetric to
    ``sym_rtol`` of its magnitude, and no eigenvalue below ``-psd_tol``
    of its magnitude.  With ``chol`` (a factor, ``cov = chol chol'``)
    the checks collapse to finiteness.  The tolerances catch blowups,
    not the few-ULP drift of a long covariance recursion.
    """
    mean = np.asarray(mean)
    if not np.all(np.isfinite(mean)):
        return "non-finite posterior mean"
    if chol is not None:
        if not np.all(np.isfinite(np.asarray(chol))):
            return "non-finite posterior covariance factor"
        if not np.all(np.isfinite(np.asarray(cov))):
            return "non-finite posterior covariance"
        return None
    cov = np.asarray(cov)
    if not np.all(np.isfinite(cov)):
        return "non-finite posterior covariance"
    scale = max(1.0, float(np.abs(cov).max()))
    asym = float(np.abs(cov - cov.T).max())
    if asym > sym_rtol * scale:
        return f"asymmetric posterior covariance (|C - C^T| = {asym:.3e})"
    w_min = float(np.linalg.eigvalsh((cov + cov.T) * 0.5).min())
    if w_min < -psd_tol * scale:
        return f"non-PSD posterior covariance (min eigenvalue {w_min:.3e})"
    return None


def state_slot_index(n_series: int, n_factors: int,
                     n_obs_pad: int) -> np.ndarray:
    """Indices of a model's true state slots inside the padded layout
    ``[sdf_0..sdf_{N-1}, cdf_0..]`` with N = ``n_obs_pad``."""
    return np.concatenate(
        [np.arange(n_series), n_obs_pad + np.arange(n_factors)]
    )


def psd_factor(cov: np.ndarray) -> np.ndarray:
    """A (host-side) factor ``F`` with ``F F' = cov`` for a PSD matrix:
    the migration shim for covariance-form states entering the
    square-root serving path.  ``np.linalg.cholesky`` would refuse the
    structurally singular filtered covariances of the DFM (``r = 0``),
    so the factor comes from an eigendecomposition with negative
    roundoff eigenvalues clipped at zero; the square-root update
    re-triangularizes it on the first step."""
    cov = np.asarray(cov)
    w, v = np.linalg.eigh((cov + cov.T) * 0.5)
    return (v * np.sqrt(np.clip(w, 0.0, None))).astype(cov.dtype)


def pad_state_arrays(state, bucket: Tuple[int, int], dtype=None,
                     sqrt: bool = False):
    """Pad one state's arrays into bucket shape ``(N, S)``:
    ``(alpha_sdf (N,), alpha_cdf (S-N,), loadings (N, S-N), mean (S,),
    cov (S, S) | None, chol (S, S) | None)``, exactly one of ``cov``/
    ``chol`` filled.  Padded alphas are 1.0, padded loadings zero,
    padded mean/cov slots the ``N(0, I)`` init.  ``sqrt=True`` pads a
    covariance factor instead: the state's own ``chol`` scattered into
    an identity (the true slots decouple exactly from the padding) when
    it has one, else :func:`psd_factor` of its ``cov``."""
    n_pad, s_pad = bucket
    n, k = state.n_series, state.n_factors
    if n > n_pad or k > s_pad - n_pad:
        raise ValueError(
            f"model {state.model_id!r} shape ({n}, {n + k}) does not fit "
            f"bucket {bucket} (padded layout [sdf*{n_pad} | "
            f"cdf*{s_pad - n_pad}])"
        )
    if dtype is None:
        dtype = state.dtype
    k_pad = s_pad - n_pad
    alpha = np.ones(s_pad, dtype)
    alpha[:n] = state.params[:n]
    alpha[n_pad:n_pad + k] = state.params[n:]
    loadings = np.zeros((n_pad, k_pad), dtype)
    loadings[:n, :k] = state.loadings
    idx = state_slot_index(n, k, n_pad)
    mean = np.zeros(s_pad, dtype)
    mean[idx] = state.mean
    cov = chol = None
    if sqrt:
        factor = (state.chol if getattr(state, "chol", None) is not None
                  else psd_factor(state.cov))
        chol = np.eye(s_pad, dtype=dtype)
        chol[np.ix_(idx, idx)] = factor
    else:
        cov = np.eye(s_pad, dtype=dtype)
        cov[np.ix_(idx, idx)] = state.cov
    return alpha[:n_pad], alpha[n_pad:], loadings, mean, cov, chol


def stack_bucket(states: List, bucket: Tuple[int, int], dtype=None,
                 device=None, sqrt: bool = False) -> BucketBatch:
    """Stack same-bucket models into one :class:`BucketBatch` on
    ``device`` (default: the CUDA card).  The host stacks the small
    parameter arrays; the state-space build runs batched on the device.
    ``sqrt=True`` stacks covariance factors instead of covariances (see
    :func:`pad_state_arrays`), for the square-root update.
    """
    device = resolve_device(device)
    if dtype is None:
        dtype = states[0].dtype
    padded = [pad_state_arrays(st, bucket, dtype, sqrt=sqrt)
              for st in states]
    a_sdf, a_cdf, lds, means = (
        torch.from_numpy(np.stack(part)).to(device)
        for part in list(zip(*padded))[:4]
    )
    fac = torch.from_numpy(
        np.stack([p[5] if sqrt else p[4] for p in padded])).to(device)
    dts = torch.from_numpy(
        np.array([st.dt for st in states], dtype)
    ).to(device)
    ss = dfm_statespace(a_sdf, a_cdf, lds, dts, device=device)
    if sqrt:
        return BucketBatch(ss=ss, mean=means, cov=None, chol=fac)
    return BucketBatch(ss=ss, mean=means, cov=fac)


def make_update_fn(engine: str = "joint", gate=None, horizons=None,
                   detect=None, robust=None):
    """The batched incremental-update function of a bucket.

    ``fn(ss, mean, fac, y_new, mask_new) -> (mean_T, fac_T, sigma,
    detf)`` with every argument batch-leading (``y_new``/``mask_new``
    (B, k, N)): on ``engine="joint"`` ``fac`` is the covariance and the
    call one K1 launch; on ``engine="sqrt"`` it is a covariance factor,
    carried by :func:`~metran_tpu_torch.ops.sqrt_filter_append` (one K9
    launch from the given carry), and the returned factor is
    lower-triangular, PSD by construction.
    """
    if engine == "sqrt_parallel":
        raise _not_ported("sqrt_parallel")
    if engine not in ("joint", "sqrt"):
        raise ValueError(f"unknown serve engine {engine!r}")
    for name, spec in (("gate", gate), ("detect", detect),
                       ("robust", robust)):
        if spec is not None and getattr(spec, "enabled", True):
            raise _not_ported(name)
    if horizons:
        raise _not_ported("horizons")

    if engine == "sqrt":
        def fn(ss, mean, chol, y_new, mask_new):
            return sqrt_filter_append(ss, mean, chol, y_new, mask_new)

        return fn

    def fn(ss, mean, cov, y_new, mask_new):
        return filter_append(ss, mean, cov, y_new, mask_new, engine=engine)

    return fn


def make_forecast_fn(steps: int):
    """The batched forecast function of a bucket: ``fn(ss, mean, cov)
    -> (means, variances)`` of shape (B, steps, N), standardized units
    — one K2 launch on CUDA tensors."""
    steps = int(steps)

    def fn(ss, mean, cov):
        horizons = torch.arange(
            1, steps + 1, device=mean.device
        ).to(mean.dtype)
        return forecast_observation_moments(ss, mean, cov, horizons)

    return fn
