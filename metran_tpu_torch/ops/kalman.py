"""Kalman filtering for the Metran DFM: the joint and sequential engines.

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

``deviance``/``log_likelihood`` are the sequential engine's MLE
objective; under differentiation with the closed-form adjoint their
backward is kernel K4.

``_predict``/``_joint_update``/``_make_core_step`` are the joint
engine's per-step building blocks, batched, for callers that step one
row at a time; the first two are the plain version's own steps.

The other engines and ``store=True`` raise with the ROADMAP item that
will port them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import as_tensor, float_dtype, resolve_device
from ..kernels.joint_filter import (
    joint_filter_append,
    joint_update_plain,
    predict_plain,
)
from ..kernels.lanes import lanes_filter
from .adjoint import DEFAULT_SEG, resolve_grad_engine
from .lanes import lanes_terms, prepare_data
from .statespace import StateSpace

LOG2PI = 1.8378770664093453  # log(2*pi)

#: where each engine that a function lacks will come from
_NOT_PORTED = {
    "joint": "ROADMAP A7 (batch-layout adjoint, kernel B7)",
    "sequential": "ROADMAP A8 (sequential serving updates, kernel B9b)",
    "sqrt": "ROADMAP A7 (square-root engine, kernel B6)",
    "parallel": "ROADMAP A7 (associative-scan engine, kernel B8)",
    "sqrt_parallel": "ROADMAP A7 (associative-scan engine, kernel B8)",
}


def _require(engine: str, ported=("joint",)) -> None:
    """Raise unless ``engine`` is one of ``ported`` (what the calling
    function has in the port)."""
    if engine in ported:
        return
    if engine not in _NOT_PORTED:
        raise ValueError(f"unknown engine {engine!r}")
    raise ValueError(
        f"engine {engine!r} is not ported yet here "
        f"({_NOT_PORTED[engine]}); this function has engine "
        + " or ".join(repr(e) for e in ported)
    )


class FilterResult(NamedTuple):
    """``store=False`` filter result: final carry plus per-step terms."""

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
    """Shared predict+update body of one filter timestep (batched).
    Returns ``core(mean, cov, y_t, mask_t) -> (mean_p, cov_p, mean_f,
    cov_f, sigma, detf)``."""
    _require(engine)

    def core(mean, cov, y_t, mask_t):
        mean_p, cov_p = _predict(mean, cov, ss.phi, ss.q)
        has_obs = mask_t.any(dim=-1)
        mean_f, cov_f, sigma, detf = _joint_update(
            mean_p, cov_p, y_t, mask_t, ss.z, ss.r
        )
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


def kalman_filter(ss: StateSpace, y, mask, engine: str = "joint",
                  store: bool = False, device=None) -> FilterResult:
    """Filter over a whole panel from the ``N(0, I)`` init.

    ``y``/``mask``: (T, N) for one model or (B, T, N) for a batch whose
    ``ss`` leaves lead with B.  ``engine="joint"`` runs K1,
    ``engine="sequential"`` (which needs a diagonal ``q``) runs K3 with
    one lane per model.  Returns the ``store=False`` contract of the JAX
    function: ``mean``/``cov`` hold the final carry, ``sigma``/``detf``
    the per-step terms ((T,) or (B, T)).
    """
    _require(engine, ("joint", "sequential"))
    if store:
        raise ValueError(
            "store=True (per-step moments) is not ported yet: ROADMAP A6 "
            "(post-fit products); the port filters with store=False"
        )
    ss_b, device, dtype, single = _prepare(ss, device)
    y = as_tensor(y, device, dtype)
    mask = as_tensor(mask, device, torch.bool)
    if single:
        y, mask = y[None], mask[None]
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


def _check_diagonal_q(q) -> None:
    """Reject non-diagonal transition covariances: the sequential engine
    of the port (kernel K3) reads the process noise off the diagonal,
    so off-diagonal entries would be dropped silently."""
    off = q - torch.diag_embed(torch.diagonal(q, 0, -2, -1))
    if bool((off.abs() > 0).any()):
        raise ValueError(
            "the sequential engine requires a diagonal transition "
            "covariance Q (the form dfm_statespace builds); got off-diagonal "
            "entries"
        )


def _lanes_ss(ss_b: StateSpace):
    """A batch of models (leaves lead with B) as K3's lanes: ``(phi
    (S, B), q (S, B), z (N, S, B), r (N, B))``."""
    _check_diagonal_q(ss_b.q)
    q = torch.diagonal(ss_b.q, 0, -2, -1)
    return ss_b.phi.T, q.T, ss_b.z.permute(1, 2, 0), ss_b.r.T


def filter_append(ss: StateSpace, mean, cov, y_new, mask_new,
                  engine: str = "joint", device=None
                  ) -> Tuple[torch.Tensor, ...]:
    """Assimilate ``k`` appended rows from a carried posterior.

    One model: mean (S,), cov (S, S), y_new/mask_new (k, N) (or (N,)).
    A batch: leaves and moments lead with B, y_new/mask_new (B, k, N).
    Returns ``(mean_T, cov_T, sigma, detf)`` with per-step terms (k,)
    or (B, k).
    """
    _require(engine)
    ss_b, device, dtype, single = _prepare(ss, device)
    y_new = as_tensor(y_new, device, dtype)
    mask_new = as_tensor(mask_new, device, torch.bool)
    mean = as_tensor(mean, device, dtype)
    cov = as_tensor(cov, device, dtype)
    if single:
        if y_new.dim() == 1:
            y_new, mask_new = y_new[None], mask_new[None]
        y_new, mask_new = y_new[None], mask_new[None]
        mean, cov = mean[None], cov[None]
    out = joint_filter_append(
        ss_b.phi, ss_b.q, ss_b.z, ss_b.r, mean, cov, y_new, mask_new
    )
    if single:
        out = tuple(o[0] for o in out)
    return out


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
    """-2 log-likelihood (the quantity the reference minimizes) of the
    sequential engine: one K3 launch over the model (or the batch whose
    ``ss`` leaves lead with B; then a (B,) result).

    ``grad`` selects how the value differentiates (w.r.t. ``ss.phi`` and
    the diagonal of ``ss.q``): ``"adjoint"`` (``"auto"`` resolves to
    it) is kernel K4, with ``remat_seg`` (default 128) as its segment
    length; ``"autodiff"`` is torch autograd through the plain filter,
    CPU tensors only.  ``None`` reads ``METRAN_TPU_GRAD_ENGINE``.  The
    value is the same either way; a non-finite one is ``+inf``.
    """
    _require(engine, ("sequential",))
    mode = resolve_grad_engine(grad, engine, dtype=float_dtype(ss.q))
    ss_b, device, dtype, single = _prepare(ss, device)
    y = as_tensor(y, device, dtype)
    mask = as_tensor(mask, device, torch.bool)
    if single:
        y, mask = y[None], mask[None]
    phi, q, z, r = _lanes_ss(ss_b)
    data = prepare_data(y, mask)
    sigma, detf = lanes_terms(phi, q, z, r, data, None,
                              remat_seg or DEFAULT_SEG, mode)
    total = _finite_or_inf(deviance_terms(sigma.T, detf.T, mask,
                                          warmup=warmup))
    return total[0] if single else total


def log_likelihood(ss: StateSpace, y, mask, warmup: int = 1,
                   engine: str = "sequential", grad=None, device=None):
    """Actual log-likelihood ``-deviance / 2`` (``-inf`` when the filter
    path is non-finite)."""
    return -0.5 * deviance(ss, y, mask, warmup=warmup, engine=engine,
                           grad=grad, device=device)
