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

``kalman_filter(engine="sequential", store=True)`` keeps every step's
predicted and filtered moments: kernel K6 in its ``store`` mode
(:func:`metran_tpu_torch.kernels.lanes_products.lanes_forward`, one lane
per model).  :func:`rts_smoother` is kernel K8
(:func:`metran_tpu_torch.kernels.smoother.rts_smooth`) over them.  The
products of one model (:func:`innovations`, :func:`decompose_states`,
:func:`project`) are plain tensor code on those moments;
:func:`sample_states` draws its prior paths on K7 and smooths each chunk
of draws with K6 ``store`` + K8, one launch each.

``deviance``/``log_likelihood`` are the sequential engine's MLE
objective; under differentiation with the closed-form adjoint their
backward is kernel K4.

``_predict``/``_joint_update``/``_make_core_step`` are the joint
engine's per-step building blocks, batched, for callers that step one
row at a time; the first two are the plain version's own steps.

The other engines, and ``store=True`` with the joint engine, raise with
the ROADMAP item that will port them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import as_tensor, float_dtype, resolve_device
from ..kernels import lanes_products as kp
from ..kernels.joint_filter import (
    joint_filter_append,
    joint_update_plain,
    predict_plain,
)
from ..kernels.lanes import lanes_filter
from ..kernels.smoother import rts_smooth
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


class NotPortedError(NotImplementedError, ValueError):
    """A JAX-package option the port does not have yet; the message
    names the ROADMAP item that brings it."""


def _require(engine: str, ported=("joint",)) -> None:
    """Raise unless ``engine`` is one of ``ported`` (what the calling
    function has in the port)."""
    if engine in ported:
        return
    if engine not in _NOT_PORTED:
        raise ValueError(f"unknown engine {engine!r}")
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
    one lane per model.  With ``store=False``, ``mean``/``cov`` hold the
    final carry and ``sigma``/``detf`` the per-step terms ((T,) or
    (B, T)).  ``store=True`` (sequential engine: K6 in its ``store``
    mode) returns every step's predicted and filtered moments, the JAX
    function's default contract.
    """
    _require(engine, ("joint", "sequential"))
    if store and engine != "sequential":
        raise NotPortedError(
            "store=True with the joint engine is not ported yet: ROADMAP "
            "A7 (batch-layout products); use engine='sequential'"
        )
    ss_b, device, dtype, single = _prepare(ss, device)
    y = as_tensor(y, device, dtype)
    mask = as_tensor(mask, device, torch.bool)
    if single:
        y, mask = y[None], mask[None]
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


# ----------------------------------------------------------------------
# the RTS smoother and the single-model products
# ----------------------------------------------------------------------
class SmootherResult(NamedTuple):
    mean_s: torch.Tensor  # (T, n), or (B, T, n)
    cov_s: torch.Tensor  # (T, n, n), or (B, T, n, n)


def rts_smoother(ss: StateSpace, filtered: FilterResult,
                 engine: str = "sequential") -> SmootherResult:
    """RTS smoother over a ``store=True`` filter result: one K8 launch
    with one lane per model (``ss`` leaves and ``filtered`` lead with B
    for a batch).

    The JAX function's covariance-form reverse scan: a Cholesky of each
    predicted covariance, ``G = P_f Phi' P_p^-1``, a step whose
    Cholesky fails degraded to its filtered moments.  ``engine`` names
    the filter engine that produced ``filtered``; the square-root and
    associative-scan smoothers raise (ROADMAP A7).
    """
    _require(engine, ("sequential", "joint"))
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
    """Smoothed state means: the stored filter (K6) and K8."""
    filt = kalman_filter(ss, y, mask, engine=engine, store=True,
                         device=device)
    return rts_smoother(ss, filt, engine=engine).mean_s


def innovations(ss: StateSpace, y, mask, filt: Optional[FilterResult] = None,
                standardized: bool = True, engine: str = "sequential",
                warmup: int = 0, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-step-ahead prediction residuals ``v = y - Z m_p`` and their
    variances ``f = diag(Z P_p Z') + r`` from the predicted moments of
    a ``store=True`` filter (``filt``, or one run here), the joint
    (vector) definition; standardized by ``sqrt(max(f, tiny))`` when
    asked, NaN where unobserved or before ``warmup``.  One model: (T, N)
    each; a batch: (B, T, N).  The port's default engine is the
    sequential one, whose stored filter is ported (the predicted
    moments are the same)."""
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
                  engine: str = "sequential", sm_data=None,
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
    ``store`` filters ``y*`` on the data's missing pattern and K8
    smooths it (means only)."""
    _require(engine, ("sequential",))
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
        stored = kp.lanes_forward(phi_l, q_l, z_l, r_l, y_star, mask_l,
                                  "store")
        sm_star, _ = rts_smooth(phi_l.T.contiguous(), stored[2], stored[3],
                                stored[0], stored[1], want_cov=False)
        out.append(sm_data + xs - sm_star)
    if not out:
        return sm_data.new_zeros((0, *sm_data.shape))
    return torch.cat(out)
