"""Kalman filtering for the Metran DFM: the joint engine.

Port of the joint-update half of ``metran_tpu/ops/kalman.py``.  The
JAX package runs the recursion as a ``lax.scan`` per model and
``vmap``\\ s it over a bucket; here every function takes a leading batch
axis (or none, for one model) and the whole recursion — all ``k``
steps of all ``B`` models — is ONE call of the K1 wrapper
(:func:`metran_tpu_torch.kernels.joint_filter.joint_filter_append`):
the hand-written kernel on CUDA tensors, its plain PyTorch version on
CPU tensors.

``_predict``/``_joint_update``/``_make_core_step`` are the per-step
building blocks, batched, for callers that step one row at a time; the
first two are the plain version's own steps.

Only ``engine="joint"`` exists in the port yet; the other engines and
``store=True`` raise with the ROADMAP item that will port them.
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
from .statespace import StateSpace

LOG2PI = 1.8378770664093453  # log(2*pi)

_OTHER_ENGINES = {
    "sequential": "ROADMAP A2 (sequential engine, kernel B1)",
    "sqrt": "ROADMAP A7 (square-root engine, kernel B6)",
    "parallel": "ROADMAP A7 (associative-scan engine, kernel B8)",
    "sqrt_parallel": "ROADMAP A7 (associative-scan engine, kernel B8)",
}


def _require_joint(engine: str) -> None:
    if engine == "joint":
        return
    where = _OTHER_ENGINES.get(engine)
    if where is None:
        raise ValueError(f"unknown engine {engine!r}")
    raise ValueError(
        f"engine {engine!r} is not ported yet ({where}); the port serves "
        "engine='joint'"
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
    _require_joint(engine)

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
    """Joint-engine filter over a whole panel from the ``N(0, I)`` init.

    ``y``/``mask``: (T, N) for one model or (B, T, N) for a batch whose
    ``ss`` leaves lead with B.  Returns the ``store=False`` contract of
    the JAX function: ``mean``/``cov`` hold the final carry, ``sigma``/
    ``detf`` the per-step terms ((T,) or (B, T)).
    """
    _require_joint(engine)
    if store:
        raise ValueError(
            "store=True (per-step moments) is not ported yet: ROADMAP A6 "
            "(post-fit products); the serving slice uses store=False"
        )
    ss_b, device, dtype, single = _prepare(ss, device)
    y = as_tensor(y, device, dtype)
    mask = as_tensor(mask, device, torch.bool)
    if single:
        y, mask = y[None], mask[None]
    mean0, cov0 = _init_state(ss_b, dtype)
    mean_t, cov_t, sigma, detf = joint_filter_append(
        ss_b.phi, ss_b.q, ss_b.z, ss_b.r, mean0, cov0, y, mask
    )
    if single:
        mean_t, cov_t, sigma, detf = mean_t[0], cov_t[0], sigma[0], detf[0]
    return FilterResult(mean_t, cov_t, mean_t, cov_t, sigma, detf)


def filter_append(ss: StateSpace, mean, cov, y_new, mask_new,
                  engine: str = "joint", device=None
                  ) -> Tuple[torch.Tensor, ...]:
    """Assimilate ``k`` appended rows from a carried posterior.

    One model: mean (S,), cov (S, S), y_new/mask_new (k, N) (or (N,)).
    A batch: leaves and moments lead with B, y_new/mask_new (B, k, N).
    Returns ``(mean_T, cov_T, sigma, detf)`` with per-step terms (k,)
    or (B, k).
    """
    _require_joint(engine)
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
