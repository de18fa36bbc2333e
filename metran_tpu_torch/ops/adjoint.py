"""Closed-form adjoint gradients of the batch-layout filter deviance.

Port of ``metran_tpu/ops/adjoint.py``.  The score of a linear-Gaussian
state-space model has a compact closed form: with incoming adjoints
``(u, S)`` of the filtered moments, ``A = I - K Z``, ``e = F^-1 v`` and
``w = Z' e``, a joint update propagates them as

    m_p-bar = A'u - 2 sb w
    P_p-bar = A'S A + db Z'F^-1 Z - sb w w' + (A'u) w'

and the diagonal-transition predict ``m_p = phi m``, ``P_p = (phi phi')
P + diag(q)`` as

    phibar += u m + (S o P) phi + (S o P)' phi ;  qbar += diag(S)
    mbar = u phi ;  Pbar = S (phi phi')

— cotangents for ``(phi, q)`` only, the quantities the MLE parameters
reach.  ``z``/``r``/``y``/``mask`` and the initial carry are fixed data:
their cotangents are **exactly zero** (never silently partial).

:func:`adjoint_deviance_terms` is a ``torch.autograd.Function`` over a
batch of models (leaves lead with B):

- **forward**: the engine's own kernel, keeping the carry at the start of
  every segment of ``seg`` steps — K1 ``bounds`` for ``"joint"``, K9
  ``bounds`` for ``"sqrt"`` and K3 with ``keep_bounds`` for
  ``"sequential"``; the plain versions of the same on CPU tensors.  The
  values are bit-identical to the engine's un-differentiated deviance.
- **backward**: one K11 launch (:mod:`metran_tpu_torch.kernels.
  joint_adjoint`), the reverse sweep in joint form for all three
  engines (their updates compute the same posterior in exact
  arithmetic, so their derivatives coincide): each segment is replayed
  from its boundary in covariance form (a square-root boundary enters as
  ``S S'`` once per segment) and swept back.

A whole fleet is one forward launch and one K11 launch.
:func:`anchored_adjoint_deviance` is the same sweep over one segment
from a given anchor ``(mean0, chol0)``: the refit objective, whose
forward is K9 from that carry.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import as_tensor
from ..config import grad_engine as _grad_engine
from ..kernels.joint_adjoint import joint_adjoint
from ..kernels.joint_filter import joint_filter_append
from ..kernels.lanes import lanes_filter
from ..kernels.sqrt_filter import sqrt_filter

#: engines the closed-form adjoint covers (the sequential-scan engines;
#: the associative-scan ``parallel`` engines keep autodiff)
ADJOINT_ENGINES = ("sequential", "joint", "sqrt")

#: default backward segment length: boundary-carry memory is O(T/seg)
#: and replay scratch O(seg) per model; any value gives identical
#: gradients
DEFAULT_SEG = 128


def resolve_grad_engine(grad: Optional[str], engine: str,
                        dtype=None) -> str:
    """Resolve a gradient-engine request to ``"adjoint"``/``"autodiff"``.

    ``grad`` is an explicit mode or ``None`` for the configured default
    (:func:`metran_tpu_torch.config.grad_engine`, env
    ``METRAN_TPU_GRAD_ENGINE``; unknown values raise).  ``"auto"`` picks
    the closed-form adjoint for the sequential-scan engines and autodiff
    for everything else, except a float32 (``dtype``, a torch dtype)
    square-root deviance, which
    keeps autodiff (its QR backward avoids the covariance-form roundoff
    near ``phi -> 1``).  An explicit ``"adjoint"`` with an uncovered
    engine raises.
    """
    mode = _grad_engine(grad)
    if mode == "auto":
        if engine not in ADJOINT_ENGINES:
            return "autodiff"
        if engine == "sqrt" and dtype == torch.float32:
            return "autodiff"
        return "adjoint"
    if mode == "adjoint" and engine not in ADJOINT_ENGINES:
        raise ValueError(
            f"grad='adjoint' requires an engine in {ADJOINT_ENGINES}; "
            f"got {engine!r} — use grad='auto' (falls back to autodiff "
            "for the associative-scan engines) or grad='autodiff'"
        )
    return mode


def _run_segments(engine, seg, phi, qdiag, z, r, mean0, fac0, y, mask,
                  keep_bounds):
    """The engine's forward over a batch: per-step ``(sigma, detf)``
    (B, T) and, with ``keep_bounds``, the carry at the start of every
    segment, ``(B, n_seg, n)`` and ``(B, n_seg, n, n)`` (a factor for
    ``"sqrt"``).  ``mean0``/``fac0`` None: the ``(0, I)`` start."""
    t_steps = y.shape[1]
    n_seg = -(-t_steps // seg)
    if keep_bounds and n_seg == 1 and mean0 is not None:
        # one segment: its boundary is the given carry itself
        keep_bounds, bounds = False, (mean0[:, None], fac0[:, None])
    else:
        bounds = None
    bounds_seg = seg if keep_bounds else None
    if engine == "joint":
        b, n = phi.shape
        if mean0 is None:
            mean0 = phi.new_zeros((b, n))
            fac0 = torch.eye(n, dtype=phi.dtype,
                             device=phi.device).expand(b, n, n)
        out = joint_filter_append(phi, torch.diag_embed(qdiag), z, r, mean0,
                                  fac0, y, mask, bounds_seg)
        sigma, detf, kept = out[2], out[3], out[4:]
    elif engine == "sqrt":
        out = sqrt_filter(phi.T, qdiag.T, z.permute(1, 2, 0), r.T, y, mask,
                          mean0=mean0, chol0=fac0, bounds_seg=bounds_seg)
        sigma, detf, kept = out[2], out[3], out[4:]
    else:  # sequential: K3 in lane layout, one lane per model
        if mean0 is not None:
            raise ValueError("the sequential engine starts from (0, I)")
        res = lanes_filter(phi.T, qdiag.T, z.permute(1, 2, 0), r.T, y, mask,
                           seg=seg, keep_bounds=keep_bounds)
        sigma, detf = res.sigma.T, res.detf.T
        kept = ((res.bounds_mean.permute(2, 0, 1),
                 res.bounds_cov.permute(3, 0, 1, 2)) if keep_bounds else ())
    if keep_bounds:
        bounds = tuple(t.contiguous() for t in kept)
    return sigma, detf, bounds


class _TermsCore(torch.autograd.Function):
    """Per-step ``(sigma, detf)`` with the closed-form ``(phi, q)``
    adjoint (K11); every other input's cotangent is exactly zero."""

    @staticmethod
    def forward(ctx, engine, seg, phi, qdiag, z, r, mean0, fac0, y, maskf):
        mask = maskf > 0
        given = mean0 if mean0.numel() else None
        sigma, detf, (bm, bf) = _run_segments(
            engine, seg, phi, qdiag, z, r, given,
            fac0 if given is not None else None, y, mask, True)
        ctx.engine, ctx.seg = engine, seg
        ctx.save_for_backward(phi, qdiag, z, r, mean0, fac0, y, maskf, bm,
                              bf)
        return sigma, detf

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, sb, db):
        phi, qdiag, z, r, mean0, fac0, y, maskf, bm, bf = ctx.saved_tensors
        phibar, qbar = joint_adjoint(
            phi, qdiag, z, r, y, maskf > 0, bm, bf, sb.contiguous(),
            db.contiguous(), ctx.seg, factored=ctx.engine == "sqrt")
        return (None, None, phibar, qbar, torch.zeros_like(z),
                torch.zeros_like(r), torch.zeros_like(mean0),
                torch.zeros_like(fac0), torch.zeros_like(y),
                torch.zeros_like(maskf))


def _qdiag(q, engine):
    """The (B, n) diagonal of a diagonal ``Q`` (anything else raises)."""
    from .kalman import _check_diagonal_q

    _check_diagonal_q(q, engine)
    return torch.diagonal(q, 0, -2, -1)


def _terms(engine, seg, ss_b, y, mask, mean0=None, fac0=None):
    """``(sigma, detf)`` (B, T) of a batch: through :class:`_TermsCore`
    when a gradient is wanted, else the engine's plain forward (the same
    values)."""
    qdiag = _qdiag(ss_b.q, engine)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (ss_b.phi, qdiag, ss_b.z, ss_b.r, y)
        + (() if mean0 is None else (mean0, fac0)))
    if not needs_grad:
        sigma, detf, _ = _run_segments(engine, seg, ss_b.phi, qdiag, ss_b.z,
                                       ss_b.r, mean0, fac0, y, mask, False)
        return sigma, detf
    if mean0 is None:
        mean0 = fac0 = ss_b.phi.new_zeros((0,))
    return _TermsCore.apply(engine, seg, ss_b.phi, qdiag, ss_b.z, ss_b.r,
                            mean0, fac0, y, mask.to(y.dtype))


def adjoint_deviance_terms(ss, y, mask, engine: str = "sequential",
                           seg: Optional[int] = None, device=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-timestep ``(sigma, detf)`` with the closed-form ``(phi, q)``
    VJP.

    One model (leaves unbatched, ``y``/``mask`` (T, N): results (T,)) or
    a batch (leaves lead with B, ``y``/``mask`` (B, T, N): results
    (B, T)).  Values are bit-identical to ``engine``'s own filter terms;
    only differentiation changes.  ``seg`` is the backward segment
    length (default :data:`DEFAULT_SEG`, clipped to ``[1, T]``).
    Requires the DFM's diagonal ``Q`` (a non-diagonal one raises).

    Gradient contract: exact w.r.t. ``phi``/``q`` — and hence the AR
    decay parameters and ``dt`` through the state-space builder — while
    ``z``/``r``/``y``/``mask`` get exactly-zero cotangents.  Use
    ``grad="autodiff"`` (the plain filter, CPU tensors) for loading or
    observation gradients.
    """
    if engine not in ADJOINT_ENGINES:
        raise ValueError(
            f"the closed-form adjoint covers engines {ADJOINT_ENGINES}; "
            f"got {engine!r} (the associative-scan engines keep autodiff)")
    from .kalman import _prepare

    ss_b, device, dtype, single = _prepare(ss, device)
    y = as_tensor(y, device, dtype)
    mask = as_tensor(mask, device, torch.bool)
    if single:
        y, mask = y[None], mask[None]
    t_steps = y.shape[1]
    seg = max(1, min(int(seg) if seg else DEFAULT_SEG, max(t_steps, 1)))
    sigma, detf = _terms(engine, seg, ss_b, y.contiguous(),
                         mask.contiguous())
    return (sigma[0], detf[0]) if single else (sigma, detf)


def anchored_adjoint_deviance(ss, mean0, chol0, y, mask, device=None):
    """Anchored tail deviance with the closed-form ``(phi, q)`` VJP.

    The adjoint twin of the refit objective: the square-root filter
    seeded from the anchor posterior ``N(mean0, chol0 chol0')`` (a
    factor that need not be triangular), summed ``sigma + detf`` over
    the tail — the values of ``sqrt_filter_append``'s K9 call.  The
    backward replays the tail from the anchor in covariance form (one
    segment) and sweeps it back (K11); the anchor is fixed data
    (exactly-zero cotangents).  One model: ``mean0`` (n,), ``chol0``
    (n, n), ``y``/``mask`` (T, N) or (N,), a scalar result; a batch
    leads every argument with B and returns (B,).
    """
    from .kalman import _prepare

    ss_b, device, dtype, single = _prepare(ss, device)
    y = as_tensor(y, device, dtype)
    mask = as_tensor(mask, device, torch.bool)
    mean0 = as_tensor(mean0, device, dtype)
    chol0 = as_tensor(chol0, device, dtype)
    if single:
        if y.dim() == 1:
            y, mask = y[None], mask[None]
        y, mask, mean0, chol0 = y[None], mask[None], mean0[None], chol0[None]
    seg = max(1, y.shape[1])
    sigma, detf = _terms("sqrt", seg, ss_b, y.contiguous(),
                         mask.contiguous(), mean0.contiguous(),
                         chol0.contiguous())
    total = torch.sum(sigma, dim=-1) + torch.sum(detf, dim=-1)
    return total[0] if single else total


__all__ = [
    "ADJOINT_ENGINES",
    "DEFAULT_SEG",
    "adjoint_deviance_terms",
    "anchored_adjoint_deviance",
    "resolve_grad_engine",
]
