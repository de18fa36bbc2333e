"""Kalman filtering and smoothing for the Metran DFM: the joint and
sequential engines, the RTS smoother and the single-model products.

Port of the joint and sequential halves of ``metran_tpu/ops/kalman.py``.
The JAX package runs each recursion as a ``lax.scan`` per model and
``vmap``\\ s it over a bucket; here every function takes a leading batch
axis (or none, for one model) and the whole recursion — all steps of all
``B`` models — is ONE kernel-wrapper call: K1
(:func:`metran_tpu_torch.kernels.joint_filter.joint_filter_append`) for
``engine="joint"``, K3 (:func:`metran_tpu_torch.kernels.lanes.lanes_filter`,
the lane-layout sequential filter with one lane per model) for
``engine="sequential"``.  Each runs its hand-written kernel on CUDA
tensors and its plain PyTorch version on CPU tensors.

``kalman_filter(store=True)`` keeps every step's predicted and filtered
moments: kernel K6 in its ``store`` mode on the sequential engine
(:func:`metran_tpu_torch.kernels.lanes_products.lanes_forward`, one lane
per model), K1 in its ``store`` mode on the joint engine
(:func:`metran_tpu_torch.kernels.joint_filter.joint_filter_store`).
:func:`filter_append` on the sequential engine (the JAX default) is
kernel K12 with the gate off, and the observation gate of the serving
path is K12 armed (:func:`gated_filter_append`) or, in factored form,
K9's gated instantiation (:func:`gated_sqrt_filter_append`).
:func:`rts_smoother` is kernel K8
(:func:`metran_tpu_torch.kernels.smoother.rts_smooth`) over them.  The
products of one model (:func:`innovations`, :func:`decompose_states`,
:func:`project`) are plain tensor code on those moments;
:func:`sample_states` draws its prior paths on K7 and smooths each chunk
of draws with K6 ``store`` + K8, one launch each.

``deviance``/``log_likelihood`` are the MLE objective on the
sequential, joint and square-root engines: the per-step terms of K3, K1
or K9 summed by :func:`deviance_terms`.  Under differentiation with the
closed-form adjoint the sequential engine's backward is kernel K4 (the
lane layout's own adjoint), the joint and square-root engines' the
batch-layout adjoint (:mod:`metran_tpu_torch.ops.adjoint`: K1 or K9 with
segment boundaries, then kernel K11).

The square-root engine (``engine="sqrt"``) carries the mean and a
Cholesky factor of the covariance and updates them by QR array
transformations — PSD by construction, no Cholesky of a computed
matrix: :func:`sqrt_kalman_filter` is kernel K9
(:func:`metran_tpu_torch.kernels.sqrt_filter.sqrt_filter`) with or
without its per-step store, :func:`sqrt_filter_update`/
:func:`sqrt_filter_append` K9 from a given carry, and
:func:`sqrt_rts_smoother` the factored smoother K10
(:func:`metran_tpu_torch.kernels.sqrt_smoother.sqrt_smooth`).
``kalman_filter``/``deviance``/``rts_smoother``/``sample_states`` take
``engine="sqrt"`` as in the JAX package.

``_predict``/``_joint_update``/``_make_core_step`` are the joint
engine's per-step building blocks, batched, for callers that step one
row at a time; the first two are the plain version's own steps.

Steady-state serving: :func:`dare_solve`/:func:`steady_gains` solve the
DARE and the frozen gains (kernel K15,
:func:`metran_tpu_torch.kernels.dare.dare_gains`) and
:func:`steady_filter_append` is the frozen-gain mean-only append (K14,
:func:`metran_tpu_torch.kernels.steady_filter.steady_filter`);
:func:`steady_converged` is the host-side freeze test.
:func:`fixed_lag_smooth` is K9 ``store`` from a given carry followed by
K10 over the window.

The associative-scan engines (``engine="parallel"``/``"sqrt_parallel"``)
are :mod:`metran_tpu_torch.ops.pkalman`: kernels K19/K20 (covariance
form) and K21/K22 (square-root form), reached through
:func:`kalman_filter`, :func:`deviance`, :func:`rts_smoother` and
:func:`sample_states` as in the JAX package.  Every function keeps its
JAX twin's defaults.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import as_tensor, float_dtype, resolve_device
from ..kernels import lanes_products as kp
from ..kernels import pkalman as kpk
from ..kernels.gated_filter import (
    GATE_DOWNWEIGHTED,
    GATE_PASS,
    GATE_POLICIES,
    GATE_REJECTED,
    gated_filter_append as _gated_kernel,
    gated_update_plain,
)
from ..kernels.joint_filter import (
    joint_filter_append,
    joint_filter_store,
    joint_update_plain,
    predict_plain,
)
from ..kernels.lanes import lanes_filter
from ..kernels.dare import dare_gains
from ..kernels.smoother import rts_smooth
from ..kernels.sqrt_filter import sqrt_filter, sqrt_filter_gated
from ..kernels.sqrt_smoother import sqrt_smooth
from ..kernels.steady_filter import steady_filter
from .adjoint import DEFAULT_SEG, adjoint_deviance_terms, resolve_grad_engine
from .lanes import lanes_terms, prepare_data
from .statespace import StateSpace

LOG2PI = 1.8378770664093453  # log(2*pi)

#: where each engine that a function lacks will come from
_NOT_PORTED = {
    "joint": "ROADMAP A2 (Metran(engine='joint') and the batch-layout "
             "products)",
}


class NotPortedError(NotImplementedError, ValueError):
    """A JAX-package option the port does not have yet; the message
    names the ROADMAP item that brings it."""


#: every engine name of the JAX package
ENGINES = ("joint", "sequential", "sqrt", "parallel", "sqrt_parallel")


def _require(engine: str, ported=("joint",)) -> None:
    """Raise unless ``engine`` is one of ``ported`` (what the calling
    function has in the port)."""
    if engine in ported:
        return
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine not in _NOT_PORTED:
        raise ValueError(
            f"engine {engine!r} has no path through this function; it has "
            + " or ".join(repr(e) for e in ported))
    raise NotPortedError(
        f"engine {engine!r} is not ported yet here "
        f"({_NOT_PORTED[engine]}); this function has engine "
        + " or ".join(repr(e) for e in ported)
    )


class FilterResult(NamedTuple):
    """Filter result.  With ``store=True`` every field is per step:
    (T, n) / (T, n, n) / (T,), or (B, T, ...) for a batch; with
    ``store=False`` the moments hold the final carry."""

    mean_p: torch.Tensor
    cov_p: torch.Tensor
    mean_f: torch.Tensor
    cov_f: torch.Tensor
    sigma: torch.Tensor
    detf: torch.Tensor


#: the per-step building blocks are the plain version's own steps
_predict = predict_plain
_joint_update = joint_update_plain


def _init_state(ss: StateSpace, dtype):
    """Reference initialization: zero mean, identity covariance."""
    n = ss.phi.shape[-1]
    batch = ss.phi.shape[:-1]
    dev = ss.phi.device
    mean = torch.zeros(*batch, n, dtype=dtype, device=dev)
    cov = torch.eye(n, dtype=dtype, device=dev).expand(*batch, n, n).clone()
    return mean, cov


def _make_core_step(ss: StateSpace, engine: str):
    """Shared predict+update body of one filter timestep (batched), on
    the joint or the sequential engine.  Returns ``core(mean, cov, y_t,
    mask_t) -> (mean_p, cov_p, mean_f, cov_f, sigma, detf)``."""
    _require(engine, ("joint", "sequential"))

    def update(mean_p, cov_p, y_t, mask_t):
        if engine == "joint":
            return _joint_update(mean_p, cov_p, y_t, mask_t, ss.z, ss.r)
        armed = torch.zeros(mean_p.shape[0], dtype=torch.bool,
                            device=mean_p.device)
        return gated_update_plain(mean_p, cov_p, y_t, mask_t, ss.z, ss.r,
                                  armed, "off", 0.0)[:4]

    def core(mean, cov, y_t, mask_t):
        mean_p, cov_p = _predict(mean, cov, ss.phi, ss.q)
        has_obs = mask_t.any(dim=-1)
        mean_f, cov_f, sigma, detf = update(mean_p, cov_p, y_t, mask_t)
        mean_f = torch.where(has_obs[..., None], mean_f, mean_p)
        cov_f = torch.where(has_obs[..., None, None], cov_f, cov_p)
        return mean_p, cov_p, mean_f, cov_f, sigma, detf

    return core


def _prepare(ss: StateSpace, device):
    """``(ss on its device with a leading batch axis, device, dtype,
    was_unbatched)``; the device defaults to the leaves' own."""
    device = resolve_device(device, ss.phi)
    dtype = float_dtype(ss.q)
    ss = StateSpace(*(as_tensor(leaf, device, dtype) for leaf in ss))
    if ss.phi.dim() == 1:
        return StateSpace(*(leaf[None] for leaf in ss)), device, dtype, True
    return ss, device, dtype, False


def kalman_filter(ss: StateSpace, y, mask, engine: str = "sequential",
                  store: bool = True, device=None) -> FilterResult:
    """Filter over a whole panel from the ``N(0, I)`` init.

    ``y``/``mask``: (T, N) for one model or (B, T, N) for a batch whose
    ``ss`` leaves lead with B.  The defaults are the JAX function's:
    ``engine="sequential", store=True`` returns every step's predicted
    and filtered moments (K6 in its ``store`` mode; the sequential engine
    needs a diagonal ``q``).  With ``store=False``, ``mean``/``cov`` hold
    the final carry and ``sigma``/``detf`` the per-step terms ((T,) or
    (B, T)): ``engine="sequential"`` runs K3 with one lane per model,
    ``engine="joint"`` K1 (its store: K1's ``store`` mode).
    ``engine="sqrt"`` runs K9
    (:func:`sqrt_kalman_filter`) and reconstitutes the covariances from
    its factors (``chol_outer``), with or without ``store``.
    ``engine="parallel"`` is the associative-scan filter (K19,
    :func:`metran_tpu_torch.ops.pkalman.parallel_filter`),
    ``"sqrt_parallel"`` its square-root form (K21, covariances
    reconstituted); with ``store=False`` they keep the JAX return shapes
    (the final moments and the per-step terms).
    """
    _require(engine, ENGINES)
    if engine in ("parallel", "sqrt_parallel"):
        return _parallel_filter(ss, y, mask, engine, store, device)
    if engine == "sqrt":
        res = sqrt_kalman_filter(ss, y, mask, store=store, device=device)
        if not store:
            cov_t = chol_outer(res.chol_f)
            return FilterResult(res.mean_f, cov_t, res.mean_f, cov_t,
                                res.sigma, res.detf)
        return FilterResult(res.mean_p, chol_outer(res.chol_p), res.mean_f,
                            chol_outer(res.chol_f), res.sigma, res.detf)
    ss_b, device, dtype, single = _prepare(ss, device)
    y = as_tensor(y, device, dtype)
    mask = as_tensor(mask, device, torch.bool)
    if single:
        y, mask = y[None], mask[None]
    if store and engine == "joint":
        mean0, cov0 = _init_state(ss_b, dtype)
        out = joint_filter_store(ss_b.phi, ss_b.q, ss_b.z, ss_b.r, mean0,
                                 cov0, y.contiguous(), mask.contiguous())
        if single:
            out = tuple(o[0] for o in out)
        return FilterResult(*out)
    if store:
        phi, q, z, r = _lanes_ss(ss_b)
        out = kp.lanes_forward(phi, q, z, r, y.contiguous(),
                               mask.contiguous(), "store")
        if single:
            out = tuple(o[0] for o in out)
        return FilterResult(*out)
    if engine == "sequential":
        phi, q, z, r = _lanes_ss(ss_b)
        res = lanes_filter(phi, q, z, r, y, mask)
        mean_t, cov_t = res.mean.T, res.cov.permute(2, 0, 1)
        sigma, detf = res.sigma.T, res.detf.T
    else:
        mean0, cov0 = _init_state(ss_b, dtype)
        mean_t, cov_t, sigma, detf = joint_filter_append(
            ss_b.phi, ss_b.q, ss_b.z, ss_b.r, mean0, cov0, y, mask
        )
    if single:
        mean_t, cov_t, sigma, detf = mean_t[0], cov_t[0], sigma[0], detf[0]
    return FilterResult(mean_t, cov_t, mean_t, cov_t, sigma, detf)


def _parallel_filter(ss: StateSpace, y, mask, engine: str, store: bool,
                     device) -> FilterResult:
    """``kalman_filter`` on an associative-scan engine (the JAX
    function's shapes: with ``store=False`` the moments hold the last
    step's, the terms every step's)."""
    from . import pkalman

    if engine == "parallel":
        res = pkalman.parallel_filter(ss, y, mask, device=device)
        cov_p, cov_f = res.cov_p, res.cov_f
    else:
        res = pkalman.sqrt_parallel_filter(ss, y, mask, device=device)
        cov_p, cov_f = chol_outer(res.chol_p), chol_outer(res.chol_f)
    if store:
        return FilterResult(res.mean_p, cov_p, res.mean_f, cov_f, res.sigma,
                            res.detf)
    mean_t, cov_t = res.mean_f[..., -1, :], cov_f[..., -1, :, :]
    return FilterResult(mean_t, cov_t, mean_t, cov_t, res.sigma, res.detf)


def _check_diagonal_q(q, engine: str = "sequential") -> None:
    """Reject non-diagonal transition covariances: the sequential and
    square-root engines of the port (kernels K3 and K9) read the process
    noise off the diagonal, so off-diagonal entries would be dropped
    silently."""
    off = q - torch.diag_embed(torch.diagonal(q, 0, -2, -1))
    if bool((off.abs() > 0).any()):
        name = "square-root" if engine == "sqrt" else engine
        raise ValueError(
            f"the {name} engine requires a diagonal transition "
            "covariance Q (the form dfm_statespace builds); got off-diagonal "
            "entries"
        )


def _lanes_ss(ss_b: StateSpace, engine: str = "sequential"):
    """A batch of models (leaves lead with B) as K3's (and K9's) lanes:
    ``(phi (S, B), q (S, B), z (N, S, B), r (N, B))``."""
    _check_diagonal_q(ss_b.q, engine)
    q = torch.diagonal(ss_b.q, 0, -2, -1)
    return ss_b.phi.T, q.T, ss_b.z.permute(1, 2, 0), ss_b.r.T


def _append_args(ss: StateSpace, mean, fac, y_new, mask_new, device):
    """``(ss_b, mean, fac, y_new, mask_new, single)`` of an append: the
    leaves and the carry with a leading batch axis, the rows (B, k, N)."""
    ss_b, device, dtype, single = _prepare(ss, device)
    y_new = as_tensor(y_new, device, dtype)
    mask_new = as_tensor(mask_new, device, torch.bool)
    mean = as_tensor(mean, device, dtype)
    fac = as_tensor(fac, device, dtype)
    if single:
        if y_new.dim() == 1:
            y_new, mask_new = y_new[None], mask_new[None]
        y_new, mask_new = y_new[None], mask_new[None]
        mean, fac = mean[None], fac[None]
    return ss_b, mean, fac, y_new, mask_new, single


def _armed(armed, batch: int, device) -> torch.Tensor:
    """``armed`` (a bool, or one per model) as a (B,) bool tensor."""
    armed = torch.as_tensor(armed, dtype=torch.bool, device=device)
    return armed.expand(batch).contiguous() if armed.dim() == 0 else armed


def filter_append(ss: StateSpace, mean, cov, y_new, mask_new,
                  engine: str = "sequential", device=None
                  ) -> Tuple[torch.Tensor, ...]:
    """Assimilate ``k`` appended rows from a carried posterior.

    One model: mean (S,), cov (S, S), y_new/mask_new (k, N) (or (N,)).
    A batch: leaves and moments lead with B, y_new/mask_new (B, k, N).
    Returns ``(mean_T, cov_T, sigma, detf)`` with per-step terms (k,)
    or (B, k).  ``engine="sequential"`` (the JAX default) conditions on
    the observed slots one at a time: kernel K12 with the gate off;
    ``engine="joint"`` updates jointly through a Cholesky of the
    innovation covariance: kernel K1.  The square-root engine carries a
    factor instead: use :func:`sqrt_filter_append`.
    """
    if engine in ("sqrt", "sqrt_parallel"):
        raise ValueError(
            "filter_append carries a covariance; the square-root engine "
            "carries a Cholesky factor — use sqrt_filter_append"
        )
    _require(engine, ("sequential", "joint"))
    ss_b, mean, cov, y_new, mask_new, single = _append_args(
        ss, mean, cov, y_new, mask_new, device)
    if engine == "sequential":
        out = _gated_kernel(ss_b.phi, ss_b.q, ss_b.z, ss_b.r, mean, cov,
                            y_new, mask_new,
                            _armed(False, mean.shape[0], mean.device),
                            "off")[:4]
    else:
        out = joint_filter_append(
            ss_b.phi, ss_b.q, ss_b.z, ss_b.r, mean, cov, y_new, mask_new
        )
    if single:
        out = tuple(o[0] for o in out)
    return out


def gated_filter_append(ss: StateSpace, mean, cov, y_new, mask_new,
                        armed=True, policy: str = "reject",
                        nsigma: float = 4.0, device=None
                        ) -> Tuple[torch.Tensor, ...]:
    """:func:`filter_append` (sequential engine) with per-slot online
    innovation gating: one K12 launch.

    Each observed slot's normalized innovation ``z = v / sqrt(f)`` is
    tested against ``z^2 > nsigma^2`` on armed models and the policy
    applied: ``"reject"`` (the slot is treated as missing), ``"huber"``
    (``v`` scaled by ``nsigma / |z|``) or ``"inflate"`` (``f`` raised to
    ``v^2 / nsigma^2``); ``"off"`` is :func:`filter_append`.  ``armed``
    is a bool or one per model.  Returns ``(mean_T, cov_T, sigma, detf,
    zscore, verdict)``: the first four as :func:`filter_append`, then
    the per-step (k, N) (or (B, k, N)) signed z-scores (NaN where
    unobserved, and everywhere with the gate off) and int8 verdicts
    (:data:`GATE_PASS`/:data:`GATE_DOWNWEIGHTED`/:data:`GATE_REJECTED`).

    Contract: with ``policy="off"``, or an armed gate that never trips,
    the posterior and likelihood outputs are bit-identical to
    :func:`filter_append` with ``engine="sequential"``.
    """
    if policy not in GATE_POLICIES:
        raise ValueError(
            f"unknown gate policy {policy!r}; expected one of "
            f"{GATE_POLICIES}")
    ss_b, mean, cov, y_new, mask_new, single = _append_args(
        ss, mean, cov, y_new, mask_new, device)
    out = _gated_kernel(ss_b.phi, ss_b.q, ss_b.z, ss_b.r, mean, cov, y_new,
                        mask_new, _armed(armed, mean.shape[0], mean.device),
                        policy, float(nsigma) * float(nsigma))
    if single:
        out = tuple(o[0] for o in out)
    return out


# ----------------------------------------------------------------------
# the square-root (Cholesky-factor) engine
# ----------------------------------------------------------------------
class SqrtFilterResult(NamedTuple):
    """Filter moments in square-root form: ``chol_p``/``chol_f`` are
    lower-triangular factors of the predicted/filtered covariances
    (``P = S S'``).  With ``store=True`` every field is per step
    ((T, ...), or (B, T, ...) for a batch); otherwise the moments hold
    the final carry and only ``sigma``/``detf`` are per step."""

    mean_p: torch.Tensor
    chol_p: torch.Tensor
    mean_f: torch.Tensor
    chol_f: torch.Tensor
    sigma: torch.Tensor
    detf: torch.Tensor


class SqrtSmootherResult(NamedTuple):
    mean_s: torch.Tensor  # (T, n), or (B, T, n)
    chol_s: torch.Tensor  # (T, n, n) lower factor of the smoothed cov


def chol_outer(chol: torch.Tensor) -> torch.Tensor:
    """Reconstitute ``S S'`` from stacked factors (leading batch axes):
    exactly symmetric and PSD up to one matmul's roundoff — for consumer
    boundaries only; the engine itself carries the factors."""
    return chol @ chol.transpose(-1, -2)


def sqrt_kalman_filter(ss: StateSpace, y, mask, store: bool = True,
                       device=None) -> SqrtFilterResult:
    """Masked Kalman filter propagating Cholesky factors by QR updates:
    one K9 launch, one lane per model (``ss`` leaves lead with B for a
    batch, ``y``/``mask`` (B, T, N); one model: (T, N)).

    Same recursion, masking and likelihood terms as
    :func:`kalman_filter`, but every covariance is carried as its lower
    factor and updated by orthogonal transformations (PSD by
    construction, no Cholesky of a computed matrix).  ``store=False``
    keeps the final carry only.  Requires the DFM's diagonal ``Q``.
    """
    ss_b, device, dtype, single = _prepare(ss, device)
    y = as_tensor(y, device, dtype)
    mask = as_tensor(mask, device, torch.bool)
    if single:
        y, mask = y[None], mask[None]
    phi, q, z, r = _lanes_ss(ss_b, "sqrt")
    out = sqrt_filter(phi, q, z, r, y.contiguous(), mask.contiguous(),
                      store=store)
    if store:
        res = SqrtFilterResult(*out)
    else:
        mean, chol, sigma, detf = out
        res = SqrtFilterResult(mean, chol, mean, chol, sigma, detf)
    if single:
        res = SqrtFilterResult(*(o[0] for o in res))
    return res


def sqrt_filter_append(ss: StateSpace, mean, chol, y_new, mask_new,
                       device=None) -> Tuple[torch.Tensor, ...]:
    """Assimilate ``k`` appended rows carrying a Cholesky factor (the
    square-root counterpart of :func:`filter_append`, the serving
    path's factored update): K9 from the given carry.

    One model: mean (S,), chol (S, S) (any factor of the covariance, it
    need not be triangular), y_new/mask_new (k, N) (or (N,)).  A batch:
    leaves and carry lead with B, y_new/mask_new (B, k, N).  Returns
    ``(mean_T, chol_T, sigma, detf)`` with per-step terms (k,) or
    (B, k); ``chol_T`` is lower-triangular, PSD by construction.
    """
    ss_b, mean, chol, y_new, mask_new, single = _append_args(
        ss, mean, chol, y_new, mask_new, device)
    phi, q, z, r = _lanes_ss(ss_b, "sqrt")
    out = sqrt_filter(phi, q, z, r, y_new.contiguous(),
                      mask_new.contiguous(), mean0=mean.contiguous(),
                      chol0=chol.contiguous())
    if single:
        out = tuple(o[0] for o in out)
    return out


def gated_sqrt_filter_append(ss: StateSpace, mean, chol, y_new, mask_new,
                             armed=True, policy: str = "reject",
                             nsigma: float = 4.0, device=None
                             ) -> Tuple[torch.Tensor, ...]:
    """:func:`sqrt_filter_append` with per-slot online innovation
    gating: one launch of K9's gated instantiation from the given
    carry (``policy="off"``: :func:`sqrt_filter_append`, with NaN
    z-scores and PASS verdicts).

    The gate tests each observed slot's marginal z-score off the
    predicted factor, ``f_i = |(Z S_p)_i|^2 + r_i``; the policy then
    pre-transforms the slot's row of the pre-array and the same QR
    update runs, so every posterior stays PSD by construction.  Returns
    ``(mean_T, chol_T, sigma, detf, zscore, verdict)``; same
    bit-exactness contract as :func:`gated_filter_append`, against
    :func:`sqrt_filter_append`.
    """
    if policy not in GATE_POLICIES:
        raise ValueError(
            f"unknown gate policy {policy!r}; expected one of "
            f"{GATE_POLICIES}")
    ss_b, mean, chol, y_new, mask_new, single = _append_args(
        ss, mean, chol, y_new, mask_new, device)
    phi, q, z, r = _lanes_ss(ss_b, "sqrt")
    y_new, mask_new = y_new.contiguous(), mask_new.contiguous()
    if policy == "off":
        out = sqrt_filter(phi, q, z, r, y_new, mask_new,
                          mean0=mean.contiguous(), chol0=chol.contiguous())
        out = (*out, torch.full(y_new.shape, float("nan"), dtype=y_new.dtype,
                                device=y_new.device),
               torch.zeros(y_new.shape, dtype=torch.int8,
                           device=y_new.device))
    else:
        out = sqrt_filter_gated(
            phi, q, z, r, y_new, mask_new, mean.contiguous(),
            chol.contiguous(), _armed(armed, mean.shape[0], mean.device),
            policy, float(nsigma) * float(nsigma))
    if single:
        out = tuple(o[0] for o in out)
    return out


def sqrt_filter_update(ss: StateSpace, mean, chol, y_t, mask_t,
                       device=None) -> Tuple[torch.Tensor, ...]:
    """One online-assimilation step carrying a Cholesky factor: ``(mean_f,
    chol_f, sigma, detf)`` with scalar (or (B,)) terms — the step
    :func:`sqrt_filter_append` takes per row."""
    y_t = torch.as_tensor(y_t)
    mask_t = torch.as_tensor(mask_t)
    mean_f, chol_f, sigma, detf = sqrt_filter_append(
        ss, mean, chol, y_t[..., None, :], mask_t[..., None, :],
        device=device)
    return mean_f, chol_f, sigma[..., 0], detf[..., 0]


def sqrt_rts_smoother(ss: StateSpace, filtered: SqrtFilterResult
                      ) -> SqrtSmootherResult:
    """RTS smoother propagating Cholesky factors over a ``store=True``
    :func:`sqrt_kalman_filter` result: one K10 launch with one lane per
    model.  The gain solves against the stored predicted factor
    (triangular solves only) and the smoothed factor is one ``tria`` of
    ``[(I - G Phi) S_f | G Q^1/2 | G S_s']`` — PSD by construction."""
    return SqrtSmootherResult(*_sqrt_smooth(ss, filtered, want_cov=True))


def _sqrt_smooth(ss: StateSpace, filtered: SqrtFilterResult,
                 want_cov: bool):
    """K10 over stored factors (one model, or a batch whose ``ss``
    leaves and ``filtered`` lead with B): ``(mean_s, chol_s or None)``;
    ``want_cov=False`` skips the smoothed factor (the mean recursion
    never reads it)."""
    dev, dtype = filtered.mean_f.device, filtered.mean_f.dtype
    phi = as_tensor(ss.phi, dev, dtype)
    q = as_tensor(ss.q, dev, dtype)
    _check_diagonal_q(q, "sqrt")
    q = torch.diagonal(q, 0, -2, -1)
    single = filtered.mean_f.dim() == 2
    args = [filtered.mean_f, filtered.chol_f, filtered.mean_p,
            filtered.chol_p]
    if single:
        phi, q, args = phi[None], q[None], [a[None] for a in args]
    mean_s, chol_s = sqrt_smooth(phi.contiguous(), q.contiguous(), *args,
                                 want_cov=want_cov)
    if single:
        return mean_s[0], None if chol_s is None else chol_s[0]
    return mean_s, chol_s


def project(z, means, covs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project states onto the observation space: means ``Z x`` and
    variances ``diag(Z P Z')`` clipped at zero (any leading axes on
    ``means``/``covs``; ``z`` is (N, S))."""
    sim_means = means @ z.transpose(-1, -2)
    sim_vars = torch.sum((z @ covs) * z, dim=-1)
    return sim_means, torch.clamp(sim_vars, min=0.0)


def deviance_terms(sigma, detf, mask, warmup: int = 1):
    """Combine per-timestep filter terms into the reference's MLE
    objective (``SPKalmanFilter.get_mle``): ``sigma``/``detf`` sums skip
    the first ``warmup`` *observed* timesteps, ``nobs`` skips the first
    ``warmup`` *grid* timesteps.  ``sigma``/``detf`` (..., T), ``mask``
    (..., T, N)."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=sigma.device)
    count = torch.sum(mask, dim=-1)
    has_obs = count > 0
    obs_rank = torch.cumsum(has_obs, dim=-1) - 1
    keep = has_obs & (obs_rank >= warmup)
    steps = torch.arange(count.shape[-1], device=count.device)
    nobs = torch.sum(torch.where(steps >= warmup, count, 0), dim=-1)
    dtype = sigma.dtype
    log2pi = torch.tensor(LOG2PI, dtype=dtype, device=sigma.device)
    return (nobs.to(dtype) * log2pi
            + torch.sum(torch.where(keep, detf, 0.0), dim=-1)
            + torch.sum(torch.where(keep, sigma, 0.0), dim=-1))


def _finite_or_inf(total):
    """A non-finite deviance as ``+inf``: a rejectable line-search value
    rather than a NaN that poisons an optimizer's state."""
    return torch.where(torch.isfinite(total), total,
                       torch.full_like(total, float("inf")))


def deviance(ss: StateSpace, y, mask, warmup: int = 1,
             engine: str = "sequential", remat_seg=None, grad=None,
             device=None):
    """-2 log-likelihood (the quantity the reference minimizes) of one
    model, or of the batch whose ``ss`` leaves lead with B (then a (B,)
    result): the per-step terms of one filter launch summed by
    :func:`deviance_terms` — K3 for ``engine="sequential"``, K1 (carry
    only) for ``"joint"``, K9 (carry only) for ``"sqrt"``.

    ``grad`` selects how the value differentiates (w.r.t. ``ss.phi`` and
    the diagonal of ``ss.q``; ``None`` reads ``METRAN_TPU_GRAD_ENGINE``):
    ``"adjoint"`` is the closed-form adjoint with ``remat_seg`` (default
    128) as its segment length — kernel K4 for the sequential engine,
    K11 after K1/K9 with segment boundaries for the joint and
    square-root engines (:func:`metran_tpu_torch.ops.adjoint.
    adjoint_deviance_terms`); ``"autodiff"`` is torch autograd through
    the plain filter, CPU tensors only; ``"auto"`` resolves as in the
    JAX package (the adjoint, except autodiff for a float32 square-root
    deviance).  The value is the same either way; a non-finite one is
    ``+inf``.  The associative-scan engines (``"parallel"``: K19,
    ``"sqrt_parallel"``: K21, terms only) differentiate by autodiff, on
    CPU tensors; with ``remat_seg`` they raise ``ValueError`` as in the
    JAX package.
    """
    _require(engine, ENGINES)
    mode = resolve_grad_engine(grad, engine, dtype=float_dtype(ss.q))
    if engine in ("parallel", "sqrt_parallel"):
        if remat_seg:
            raise ValueError(
                f"remat_seg is not supported by the {engine!r} "
                "(associative-scan) engine: it materializes O(T n^2) "
                "moments regardless, so the O(seg) memory promise "
                "cannot hold — use engine='sequential'/'joint'/'sqrt'")
        from . import pkalman

        fn = (pkalman.sqrt_parallel_deviance if engine == "sqrt_parallel"
              else pkalman.parallel_deviance)
        return fn(ss, y, mask, warmup=warmup, device=device)
    ss_b, device, dtype, single = _prepare(ss, device)
    y = as_tensor(y, device, dtype)
    mask = as_tensor(mask, device, torch.bool)
    if single:
        y, mask = y[None], mask[None]
    if engine == "sequential":
        phi, q, z, r = _lanes_ss(ss_b)
        data = prepare_data(y, mask)
        sigma, detf = lanes_terms(phi, q, z, r, data, None,
                                  remat_seg or DEFAULT_SEG, mode)
        sigma, detf = sigma.T, detf.T
    else:
        sigma, detf = _batch_terms(ss_b, y, mask, engine, mode, remat_seg)
    total = _finite_or_inf(deviance_terms(sigma, detf, mask, warmup=warmup))
    return total[0] if single else total


def _batch_terms(ss_b: StateSpace, y, mask, engine: str, mode: str,
                 remat_seg):
    """(B, T) terms of the joint or square-root engine: the kernel's
    carry-only pass for a value, the closed-form adjoint (or, on CPU
    tensors, autodiff through the plain filter) under differentiation."""
    needs_grad = torch.is_grad_enabled() and any(
        leaf.requires_grad for leaf in ss_b)
    if needs_grad and mode == "adjoint":
        return adjoint_deviance_terms(ss_b, y, mask, engine=engine,
                                      seg=remat_seg or DEFAULT_SEG)
    if needs_grad and y.device.type != "cpu":
        raise RuntimeError(
            f"grad='autodiff' differentiates the plain PyTorch filter, "
            f"which runs on CPU tensors only (the {engine} engine resolves "
            f"to it in {ss_b.q.dtype}); on the card differentiate with "
            f"grad='adjoint' (kernel K11) or fit with LanesSolve (kernels "
            f"K3/K4)")
    y, mask = y.contiguous(), mask.contiguous()
    if engine == "sqrt":
        phi, q, z, r = _lanes_ss(ss_b, "sqrt")
        return sqrt_filter(phi, q, z, r, y, mask)[2:4]
    mean0, cov0 = _init_state(ss_b, ss_b.q.dtype)
    return joint_filter_append(ss_b.phi, ss_b.q, ss_b.z, ss_b.r, mean0, cov0,
                               y, mask)[2:4]


def log_likelihood(ss: StateSpace, y, mask, warmup: int = 1,
                   engine: str = "sequential", grad=None, device=None):
    """Actual log-likelihood ``-deviance / 2`` (``-inf`` when the filter
    path is non-finite)."""
    return -0.5 * deviance(ss, y, mask, warmup=warmup, engine=engine,
                           grad=grad, device=device)


# ----------------------------------------------------------------------
# the RTS smoother and the single-model products
# ----------------------------------------------------------------------
class SmootherResult(NamedTuple):
    mean_s: torch.Tensor  # (T, n), or (B, T, n)
    cov_s: torch.Tensor  # (T, n, n), or (B, T, n, n)


def rts_smoother(ss: StateSpace, filtered, engine: str = "sequential"
                 ) -> SmootherResult:
    """RTS smoother over a ``store=True`` filter result: one K8 launch
    with one lane per model (``ss`` leaves and ``filtered`` lead with B
    for a batch).

    The JAX function's covariance-form reverse scan: a Cholesky of each
    predicted covariance, ``G = P_f Phi' P_p^-1``, a step whose
    Cholesky fails degraded to its filtered moments.  A
    :class:`SqrtFilterResult` is smoothed in factored form instead
    (:func:`sqrt_rts_smoother`, K10) and its covariances reconstituted
    only at return.  ``engine`` names the filter engine that produced
    ``filtered``: ``"parallel"`` smooths by the reverse associative scan
    (K20), and a factored result under either associative-scan engine by
    its square-root form (K22); other names run the sequential reverse
    scan, as in the JAX function.
    """
    _require(engine, ENGINES)
    if isinstance(filtered, SqrtFilterResult):
        if engine in ("parallel", "sqrt_parallel"):
            from .pkalman import sqrt_parallel_smoother

            sm = sqrt_parallel_smoother(ss, filtered)
        else:
            sm = sqrt_rts_smoother(ss, filtered)
        return SmootherResult(sm.mean_s, chol_outer(sm.chol_s))
    if engine == "parallel":
        from .pkalman import parallel_smoother

        return parallel_smoother(ss, filtered)
    phi = as_tensor(ss.phi, filtered.mean_f.device, filtered.mean_f.dtype)
    single = filtered.mean_f.dim() == 2
    args = [filtered.mean_f, filtered.cov_f, filtered.mean_p,
            filtered.cov_p]
    if single:
        phi, args = phi[None], [a[None] for a in args]
    mean_s, cov_s = rts_smooth(phi, *args)
    if single:
        return SmootherResult(mean_s[0], cov_s[0])
    return SmootherResult(mean_s, cov_s)


def _smoothed_means(ss: StateSpace, y, mask, engine: str = "sequential",
                    device=None):
    """Smoothed state means: the stored filter and its smoother — K6 and
    K8, or on ``engine="sqrt"`` (and ``"sqrt_parallel"``, as the JAX
    function routes it) K9 and K10 in its mean-only mode (the mean
    recursion never reads the smoothed factor); K19 and K20 on
    ``"parallel"``."""
    if engine in ("sqrt", "sqrt_parallel"):
        filt = sqrt_kalman_filter(ss, y, mask, store=True, device=device)
        return _sqrt_smooth(ss, filt, want_cov=False)[0]
    filt = kalman_filter(ss, y, mask, engine=engine, store=True,
                         device=device)
    return rts_smoother(ss, filt, engine=engine).mean_s


def innovations(ss: StateSpace, y, mask, filt: Optional[FilterResult] = None,
                standardized: bool = True, engine: str = "joint",
                warmup: int = 0, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-step-ahead prediction residuals ``v = y - Z m_p`` and their
    variances ``f = diag(Z P_p Z') + r`` from the predicted moments of
    a ``store=True`` filter (``filt``, or one run here), the joint
    (vector) definition; standardized by ``sqrt(max(f, tiny))`` when
    asked, NaN where unobserved or before ``warmup``.  One model: (T, N)
    each; a batch: (B, T, N).  The default engine is the JAX function's,
    ``"joint"`` (K1's ``store`` mode)."""
    if filt is None:
        filt = kalman_filter(ss, y, mask, engine=engine, store=True,
                             device=device)
    dev, dtype = filt.mean_p.device, filt.mean_p.dtype
    z = as_tensor(ss.z, dev, dtype)
    r = as_tensor(ss.r, dev, dtype)
    y = as_tensor(y, dev, dtype)
    mask = as_tensor(mask, dev, torch.bool)
    pred_means = filt.mean_p @ z.transpose(-1, -2)
    pred_vars = torch.clamp(torch.einsum("...ij,...tjk,...ik->...ti", z,
                                         filt.cov_p, z), min=0.0)
    f = pred_vars + r[..., None, :]
    v = y - pred_means
    if standardized:
        v = v / torch.sqrt(torch.clamp(f, min=torch.finfo(dtype).tiny))
    steps = torch.arange(y.shape[-2], device=dev)[:, None]
    keep = mask & (steps >= int(warmup))
    return torch.where(keep, v, torch.nan), torch.where(keep, f, torch.nan)


def decompose_states(z, means, n_series: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split projected means into the specific part ``(T, n_series)``
    and each common factor's part ``(n_factors, T, n_series)``
    (reference ``SPKalmanFilter.decompose``)."""
    sdf = means[:, :n_series] @ z[:, :n_series].T
    cdf = torch.einsum("ik,tk->kti", z[:, n_series:], means[:, n_series:])
    return sdf, cdf


def _draw_normals(n_draws: int, t_steps: int, n_state: int, n_obs: int,
                  generator: torch.Generator, dtype, device):
    """The standard normals of ``n_draws`` path draws, draw-major:
    ``x0`` (D, n), ``w`` (D, T, n), ``e`` (D, T, N), in that order."""
    new = dict(generator=generator, dtype=dtype, device=device)
    return (torch.randn((n_draws, n_state), **new),
            torch.randn((n_draws, t_steps, n_state), **new),
            torch.randn((n_draws, t_steps, n_obs), **new))


def sample_states(ss: StateSpace, y, mask, generator=None, n_draws: int = 1,
                  engine: str = "joint", sm_data=None,
                  draw_chunk: int = 8, device=None) -> torch.Tensor:
    """Joint posterior draws of one model's state paths, (n_draws, T, n):
    the Durbin-Koopman mean-correction simulation smoother
    ``m_s(y) + x* - m_s(y*)`` (see :func:`_sample_states_given`).

    ``generator`` is a ``torch.Generator`` on the model's device or an
    int seed (default 0); draw-for-draw equality with the JAX package's
    PRNG keys is not a contract, the distribution is.  ``sm_data``
    optionally supplies the smoothed means of the data.  Non-diagonal
    ``q`` raises: the process noise is drawn elementwise."""
    ss_b, device, dtype, single = _prepare(ss, device)
    if not single:
        raise ValueError("sample_states takes one model (unbatched ss)")
    _check_diagonal_q(ss_b.q)
    if generator is None or isinstance(generator, int):
        generator = torch.Generator(device).manual_seed(int(generator or 0))
    y = as_tensor(y, device, dtype)
    normals = _draw_normals(int(n_draws), y.shape[0], ss_b.phi.shape[-1],
                            ss_b.z.shape[-2], generator, dtype, device)
    return _sample_states_given(ss, y, mask, *normals, sm_data=sm_data,
                                engine=engine, draw_chunk=draw_chunk,
                                device=device)


def _sample_states_given(ss: StateSpace, y, mask, x0, w, e, sm_data=None,
                         engine: str = "sequential", draw_chunk: int = 8,
                         device=None) -> torch.Tensor:
    """:func:`sample_states` from given standard normals ``x0`` (D, n),
    ``w`` (D, T, n) and ``e`` (D, T, N) (the JAX function's per-draw
    normals, before the ``sqrt(q)``/``sqrt(r)`` scaling).

    Per chunk of ``draw_chunk`` draws, one lane per draw: K7 draws the
    prior paths ``x_t = phi o x_{t-1} + sqrt(q) o w_t`` from ``x_0 =
    x0`` and their pseudo-observations ``y* = Z x + sqrt(r) o e``; K6
    ``store`` (K1 ``store`` on ``engine="joint"``) filters ``y*`` on the
    data's missing pattern and K8 smooths it (means only) — on
    ``engine="sqrt"`` (and ``"sqrt_parallel"``, as the JAX function
    routes it) K9 ``store`` and K10 in its mean-only mode, on
    ``"parallel"`` K19 and K20 over the chunk's draws."""
    _require(engine, ENGINES)
    ss_b, device, dtype, single = _prepare(ss, device)
    if not single:
        raise ValueError("sample_states takes one model (unbatched ss)")
    y = as_tensor(y, device, dtype)
    mask = as_tensor(mask, device, torch.bool)
    x0, w, e = (as_tensor(a, device, dtype) for a in (x0, w, e))
    if sm_data is None:
        sm_data = _smoothed_means(ss_b, y[None], mask[None], engine)[0]
    sm_data = as_tensor(sm_data, device, dtype)
    phi, q, z, r = _lanes_ss(ss_b)  # (n, 1), (n, 1), (N, n, 1), (N, 1)
    n_draws = x0.shape[0]
    chunk = max(1, min(int(draw_chunk), n_draws))
    out = []
    for i in range(0, n_draws, chunk):
        c = min(chunk, n_draws - i)

        def lanes(a):
            return a.expand(*a.shape[:-1], c).contiguous()

        phi_l, q_l, z_l, r_l = lanes(phi), lanes(q), lanes(z), lanes(r)
        xs, y_star = kp.lanes_sample(phi_l, q_l, z_l, r_l,
                                     x0[i:i + c].contiguous(),
                                     w[i:i + c].contiguous(),
                                     e[i:i + c].contiguous())
        mask_l = mask[None].expand(c, *mask.shape).contiguous()
        if engine == "joint":
            leaves = [leaf.expand(c, *leaf.shape[1:]).contiguous()
                      for leaf in ss_b]
            mean0, cov0 = _init_state(StateSpace(*leaves), dtype)
            stored = joint_filter_store(*leaves, mean0, cov0, y_star, mask_l)
            sm_star, _ = rts_smooth(leaves[0], stored[2], stored[3],
                                    stored[0], stored[1], want_cov=False)
        elif engine == "parallel":
            leaves = [leaf.expand(c, *leaf.shape[1:]).contiguous()
                      for leaf in ss_b]
            blk = kpk.auto_chunk(y_star.shape[1], c)
            stored = kpk.parallel_filter(leaves[0], leaves[1], leaves[2],
                                         leaves[3], y_star, mask_l, blk)
            sm_star, _ = kpk.parallel_smooth(leaves[0], stored[2], stored[3],
                                             stored[0], stored[1], blk)
        elif engine in ("sqrt", "sqrt_parallel"):
            stored = sqrt_filter(phi_l, q_l, z_l, r_l, y_star, mask_l,
                                 store=True)
            sm_star, _ = sqrt_smooth(phi_l.T.contiguous(),
                                     q_l.T.contiguous(), stored[2],
                                     stored[3], stored[0], stored[1],
                                     want_cov=False)
        else:
            stored = kp.lanes_forward(phi_l, q_l, z_l, r_l, y_star, mask_l,
                                      "store")
            sm_star, _ = rts_smooth(phi_l.T.contiguous(), stored[2],
                                    stored[3], stored[0], stored[1],
                                    want_cov=False)
        out.append(sm_data + xs - sm_star)
    if not out:
        return sm_data.new_zeros((0, *sm_data.shape))
    return torch.cat(out)


# ----------------------------------------------------------------------
# steady-state (frozen-gain) serving and fixed-lag smoothing
# ----------------------------------------------------------------------
class SteadyGains(NamedTuple):
    """The frozen serving summary of a converged filter.

    ``kgain`` is the steady Kalman gain ``K = P Z' F^-1`` (S, N) of the
    fully-observed pattern, ``fdiag`` the (N,) marginal innovation
    variances ``diag(F)`` (1.0 on zero-``Z``-row slots), ``p_pred``/
    ``p_filt`` the steady predicted and filtered covariances.
    ``kgain_seq``/``fdiag_seq`` are the per-slot sequential gains and
    conditional innovation variances of the slot-ordered rank-1
    recursion at the fixed point: what a frozen gate on a covariance
    engine's (sequential) serving path must test against, since the
    conditional variances are smaller than the marginal ones.  Leaves
    lead with B for a batch."""

    kgain: torch.Tensor  # (S, N)
    fdiag: torch.Tensor  # (N,)
    p_pred: torch.Tensor  # (S, S)
    p_filt: torch.Tensor  # (S, S)
    kgain_seq: torch.Tensor  # (S, N)
    fdiag_seq: torch.Tensor  # (N,)


def _real_slots(z: torch.Tensor) -> torch.Tensor:
    """(..., N) True where an observation slot is real (a nonzero ``Z``
    row).  Right for true-dimension state spaces (``Z = [I | Gamma]``);
    NOT for bucket-padded ones, whose identity block covers the padded
    slots too: padded callers pass their ``real`` mask from the series
    counts instead."""
    return (z != 0).any(-1)


def _steady_solve(ss: StateSpace, p_pred, newton_iters: int,
                  doubling_iters: int, device) -> SteadyGains:
    """One K15 launch over the model (or batch): the gains at
    ``p_pred``, or at the DARE solution when it is None."""
    ss_b, device, dtype, single = _prepare(ss, device)
    if p_pred is not None:
        p_pred = as_tensor(p_pred, device, dtype)
        if single:
            p_pred = p_pred[None]
    p, p_filt, kgain, fdiag, kgain_seq, fdiag_seq = dare_gains(
        ss_b.phi, ss_b.q, ss_b.z, ss_b.r, p_pred, newton_iters,
        doubling_iters)
    out = SteadyGains(kgain, fdiag, p, p_filt, kgain_seq, fdiag_seq)
    if single:
        out = SteadyGains(*(leaf[0] for leaf in out))
    return out


def dare_solve(ss: StateSpace, newton_iters: int = 24,
               doubling_iters: int = 32, device=None) -> torch.Tensor:
    """Steady-state *predicted* covariance of the masked filter (DARE):
    ``P = Phi (P - P Z'(Z P Z' + R)^-1 Z P) Phi' + Q`` for the
    fully-observed pattern (zero-``Z``-row slots carry unit
    pseudo-noise and contribute nothing), by Newton-Kleinman iteration
    from ``K = 0`` with each Lyapunov solve by doubling (``2^32``
    effective steps: the near-unit-root regime converges too).  Never
    forms ``R^-1``.  One K15 launch (a batch of models that share their
    dimensions: leaves leading with B)."""
    return _steady_solve(ss, None, newton_iters, doubling_iters,
                         device).p_pred


def steady_gains(ss: StateSpace, p_pred=None, device=None) -> SteadyGains:
    """The frozen serving summary from a steady predicted covariance
    (default: :func:`dare_solve`'s fixed point), one K15 launch.
    Zero-``Z``-row slots get unit innovation variance and an exactly
    zero gain column, so the arrays are safe at any bucket padding."""
    return _steady_solve(ss, p_pred, 24, 32, device)


def steady_filter_append(ss: StateSpace, mean, kgain, fdiag, y_new,
                         mask_new, armed=True, policy: str = "off",
                         nsigma: float = 4.0, real=None,
                         sequential_gate: bool = False, device=None
                         ) -> Tuple[torch.Tensor, ...]:
    """Assimilate ``k`` appended rows through the FROZEN steady gain:
    the mean-only recursion ``m <- Phi m + K (y - Z Phi m)``, O(S N) a
    step, one K14 launch.

    Every condition that breaks the premise of a frozen gain trips the
    sticky ``broke`` flag instead of being branched on: a step whose
    mask differs from the ``real`` slot pattern (default: the nonzero-
    ``Z``-row slots; bucket-padded callers pass theirs), an armed gate
    firing under ``"reject"``/``"inflate"`` (``"huber"`` only reweights
    the innovation, which the frozen gain absorbs), or a non-finite
    mean; the caller discards such a row and replays it through the
    exact update.  ``sequential_gate=False`` is the vector form
    (``kgain``/``fdiag`` the joint gain and marginal variances: the
    square-root and ungated paths); ``True`` the per-slot form through
    the sequential gains and conditional variances (gated covariance
    engines).

    One model: mean (S,), kgain (S, N), fdiag (N,), y_new/mask_new
    (k, N) (or (N,)); a batch leads each with B.  Returns ``(mean_T,
    sigma, detf, broke, zscore, verdict)``: ``sigma``/``detf`` summed
    over the steps, ``zscore``/``verdict`` (k, N) as the gated
    updates'."""
    if policy not in GATE_POLICIES:
        raise ValueError(
            f"unknown gate policy {policy!r}; expected one of "
            f"{GATE_POLICIES}")
    ss_b, device, dtype, single = _prepare(ss, device)
    mean = as_tensor(mean, device, dtype)
    kgain = as_tensor(kgain, device, dtype)
    fdiag = as_tensor(fdiag, device, dtype)
    y_new = as_tensor(y_new, device, dtype)
    mask_new = as_tensor(mask_new, device, torch.bool)
    if real is None:
        real = _real_slots(ss_b.z)
    else:
        real = as_tensor(real, device, torch.bool)
    if single:
        if y_new.dim() == 1:
            y_new, mask_new = y_new[None], mask_new[None]
        y_new, mask_new = y_new[None], mask_new[None]
        mean, kgain, fdiag = mean[None], kgain[None], fdiag[None]
        if real.dim() == 1:
            real = real[None]
    seq = bool(sequential_gate) and policy != "off"
    out = steady_filter(
        ss_b.phi, ss_b.z, kgain, fdiag, real.contiguous(), mean,
        y_new.contiguous(), mask_new.contiguous(),
        _armed(armed, mean.shape[0], mean.device), policy,
        float(nsigma) * float(nsigma), seq)
    if single:
        out = tuple(o[0] for o in out)
    return out


def steady_converged(fac_before, fac_after, mask, real, tol
                     ) -> torch.Tensor:
    """Per-row convergence verdict of one batched exact update: True
    where every appended step carried the full ``real`` slot pattern and
    the posterior factor (or covariance) moved by at most ``tol``
    (max-abs over the (S, S) block).  ``fac`` (..., S, S), ``mask``
    (..., k, N), ``real`` (..., N); the serving layer ANDs in its host
    conditions (``t_seen`` floor, no gate verdicts) before freezing."""
    fac_before = torch.as_tensor(fac_before)
    fac_after = torch.as_tensor(fac_after)
    mask = torch.as_tensor(mask, dtype=torch.bool)
    real = torch.as_tensor(real, dtype=torch.bool)
    full = (mask == real[..., None, :]).all(-1).all(-1)
    delta = (fac_after - fac_before).abs().amax(dim=(-2, -1))
    return full & (delta <= tol) & torch.isfinite(delta)


def fixed_lag_smooth(ss: StateSpace, mean, chol, y_win, mask_win,
                     device=None) -> SqrtSmootherResult:
    """Smoothed state moments of the trailing ``L``-step window: the
    square-root filter over ONLY the window's rows from the carried
    filtered posterior ``N(mean, chol chol')`` at the step before it
    (K9 ``store`` from the given carry), then the factored RTS smoother
    across the window (K10) — O(L) however long the history.  The
    filter is Markov and the smoother at step t reads only moments from
    t on, so the result is bit for bit the full filter + smoother's
    last ``L`` steps.  Returns the smoothed means (L, S) and factors
    (L, S, S).  Requires the DFM's diagonal ``Q``."""
    ss_b, device, dtype, single = _prepare(ss, device)
    _check_diagonal_q(ss_b.q, "sqrt")
    mean = as_tensor(mean, device, dtype)
    chol = as_tensor(chol, device, dtype)
    y_win = as_tensor(y_win, device, dtype)
    mask_win = as_tensor(mask_win, device, torch.bool)
    if single:
        if y_win.dim() == 1:
            y_win, mask_win = y_win[None], mask_win[None]
        y_win, mask_win = y_win[None], mask_win[None]
        mean, chol = mean[None], chol[None]
    phi, q, z, r = _lanes_ss(ss_b, "sqrt")
    filt = SqrtFilterResult(*sqrt_filter(
        phi, q, z, r, y_win.contiguous(), mask_win.contiguous(), store=True,
        mean0=mean.contiguous(), chol0=chol.contiguous()))
    mean_s, chol_s = _sqrt_smooth(ss_b, filt, want_cov=True)
    if single:
        return SqrtSmootherResult(mean_s[0], chol_s[0])
    return SqrtSmootherResult(mean_s, chol_s)
