"""Parallel-in-time Kalman filtering and smoothing by associative scans.

Port of the single-card half of ``metran_tpu/ops/pkalman.py`` (B8).  The
JAX package reformulates the filter and the RTS smoother as associative
operators over per-step elements and combines them with
``jax.lax.associative_scan`` — O(log T) depth — in covariance form
(``parallel_filter``/``parallel_smoother``) and with the covariances
carried as triangular factors (``sqrt_parallel_filter``/
``sqrt_parallel_smoother``, arXiv:2502.11686).

Here each engine is one kernel-wrapper call over one model or a batch
(``ss`` leaves leading with B, ``y``/``mask`` (B, T, N)): K19-K22 of
:mod:`metran_tpu_torch.kernels.pkalman` on CUDA tensors, their plain
versions on CPU tensors.  The kernels run the same operator over a
chunked decomposition of the time axis (an up-sweep of chunk totals, a
carry across chunks, a down-sweep from each chunk's prefix — the
cross-block steps of the JAX ``blocked_associative_scan``), so values
agree with the JAX functions' to reassociation rounding.

``block`` keeps the JAX meaning of the combine tree's blocking: ``None``
is the unblocked scan — one chunk, the whole series folded in the
down-sweep — an int the chunk length, and ``"auto"`` (the default) picks
the chunk length from T and the batch so the card's multiprocessors stay
busy (:func:`metran_tpu_torch.kernels.pkalman.auto_chunk`): ~sqrt(3T)
chunks for one long model, one chunk per model for a large fleet.  The
JAX package's own thresholds, :data:`AUTO_BLOCK` above
:data:`AUTO_BLOCK_MIN_T` steps, bound XLA's compile size, which the
kernels do not have.

Memory: the stored moments are O(T n^2) per model (the JAX functions
materialize them too); the deviances keep only the per-step terms and
the final moment, and the kernels' scratch is O(chunks n^2) per model.

:func:`sequence_sharded_filter` shards the time axis over a device mesh
(the JAX ``_sharded_associative_scan``): each shard's steps fold into one
element on its device (K19/K20 ``total``), the S totals are gathered on
the mesh's first device and carried into each shard's incoming moment
(``carry``), and each shard scans its steps from it (``prefix``).

Gradients: as in the JAX package the associative-scan engines
differentiate by autodiff (``ops.adjoint.resolve_grad_engine``): torch
autograd through the plain version, on CPU tensors only.  The card
backward of K19/K21 is not ported (ROADMAP A6).
"""

from __future__ import annotations

import torch

from ..config import as_tensor
from ..kernels import pkalman as kpk
from .kalman import (
    FilterResult,
    NotPortedError,
    SmootherResult,
    SqrtFilterResult,
    SqrtSmootherResult,
    _check_diagonal_q,
    _finite_or_inf,
    _prepare,
    deviance_terms,
)
from .statespace import StateSpace

# The JAX module's blocking of its combine tree, kept under its names for
# callers that read them; the chunk length here comes from auto_chunk.
AUTO_BLOCK = 512
AUTO_BLOCK_MIN_T = 2048


def _resolve_block(block, t_steps: int, batch: int) -> int:
    """The chunk length of ``block`` at T steps and B models: ``"auto"``
    -> :func:`~metran_tpu_torch.kernels.pkalman.auto_chunk`, ``None`` ->
    one chunk, an int itself."""
    if block == "auto":
        return kpk.auto_chunk(t_steps, batch)
    if block is None:
        return max(int(t_steps), 1)
    if isinstance(block, str) or int(block) < 1:
        raise ValueError(f"block must be 'auto', None or a positive int, "
                         f"got {block!r}")
    return int(block)


def _inputs(ss: StateSpace, y, mask, device):
    """``(ss_b, y (B, T, N), mask, single)`` on the leaves' device."""
    ss_b, device, dtype, single = _prepare(ss, device)
    y = as_tensor(y, device, dtype)
    mask = as_tensor(mask, device, torch.bool)
    if single:
        y, mask = y[None], mask[None]
    return ss_b, y.contiguous(), mask.contiguous(), single


def _refuse_card_grad(ss_b: StateSpace, y, engine: str) -> None:
    """Autodiff runs through the plain version: a CUDA tensor that needs
    a gradient has no backward yet."""
    if (y.device.type != "cpu" and torch.is_grad_enabled()
            and any(leaf.requires_grad for leaf in ss_b)):
        raise NotPortedError(
            f"the {engine!r} engine differentiates by autodiff through its "
            "plain PyTorch version, on CPU tensors only; a backward of "
            "kernels K19/K21 on the card is not ported yet (ROADMAP A6) — "
            "differentiate engine='joint' or 'sqrt' there (kernel K11)")


def _unbatch(res, single: bool):
    return type(res)(*(o[0] for o in res)) if single else res


def parallel_filter(ss: StateSpace, y, mask, block="auto",
                    device=None) -> FilterResult:
    """The covariance-form Kalman filter as an associative scan: kernel
    K19.  Returns the :class:`FilterResult` of ``kalman_filter(store=
    True)`` — every step's predicted and filtered moments and the
    likelihood terms, with the same masked-data semantics; one model
    ((T, ...)) or a batch ((B, T, ...))."""
    ss_b, y, mask, single = _inputs(ss, y, mask, device)
    _refuse_card_grad(ss_b, y, "parallel")
    chunk = _resolve_block(block, y.shape[1], y.shape[0])
    out = kpk.parallel_filter(ss_b.phi, ss_b.q, ss_b.z, ss_b.r, y, mask,
                              chunk)
    return _unbatch(FilterResult(*out), single)


def parallel_smoother(ss: StateSpace, filtered: FilterResult,
                      block="auto") -> SmootherResult:
    """The RTS smoother as a reverse associative scan over a stored
    covariance filter (K20); ``block`` as in :func:`parallel_filter`."""
    mean_f = filtered.mean_f
    phi = as_tensor(ss.phi, mean_f.device, mean_f.dtype)
    single = mean_f.dim() == 2
    args = [filtered.mean_f, filtered.cov_f, filtered.mean_p,
            filtered.cov_p]
    if single:
        phi, args = phi[None], [a[None] for a in args]
    chunk = _resolve_block(block, args[0].shape[1], args[0].shape[0])
    out = kpk.parallel_smooth(phi.contiguous(),
                              *[a.contiguous() for a in args], chunk)
    return _unbatch(SmootherResult(*out), single)


def _terms(ss: StateSpace, y, mask, block, engine: str, device):
    """``(sigma, detf, mask, single)`` of one filter launch without the
    per-step moments."""
    ss_b, y, mask, single = _inputs(ss, y, mask, device)
    _refuse_card_grad(ss_b, y, engine)
    chunk = _resolve_block(block, y.shape[1], y.shape[0])
    if engine == "sqrt_parallel":
        _check_diagonal_q(ss_b.q, "sqrt")
        q = torch.diagonal(ss_b.q, 0, -2, -1).contiguous()
        out = kpk.sqrt_parallel_filter(ss_b.phi, q, ss_b.z, ss_b.r, y, mask,
                                       chunk, store=False)
    else:
        out = kpk.parallel_filter(ss_b.phi, ss_b.q, ss_b.z, ss_b.r, y, mask,
                                  chunk, store=False)
    return out[2], out[3], mask, single


def _deviance(ss, y, mask, warmup, block, engine, device):
    sigma, detf, mask, single = _terms(ss, y, mask, block, engine, device)
    total = _finite_or_inf(deviance_terms(sigma, detf, mask, warmup=warmup))
    return total[0] if single else total


def parallel_deviance(ss: StateSpace, y, mask, warmup: int = 1,
                      block="auto", device=None):
    """-2 log L through K19 (the per-step terms only), non-finite mapped
    to ``+inf``; a (B,) result for a batch."""
    return _deviance(ss, y, mask, warmup, block, "parallel", device)


def sqrt_parallel_filter(ss: StateSpace, y, mask, block="auto",
                         device=None) -> SqrtFilterResult:
    """The square-root Kalman filter as an associative scan: kernel K21.
    Returns a :class:`SqrtFilterResult` (lower factors of every step's
    predicted and filtered covariances, PSD by construction) with the
    masked-data and likelihood semantics of :func:`parallel_filter`.
    Requires the DFM's diagonal ``Q``."""
    ss_b, y, mask, single = _inputs(ss, y, mask, device)
    _refuse_card_grad(ss_b, y, "sqrt_parallel")
    _check_diagonal_q(ss_b.q, "sqrt")
    q = torch.diagonal(ss_b.q, 0, -2, -1).contiguous()
    chunk = _resolve_block(block, y.shape[1], y.shape[0])
    out = kpk.sqrt_parallel_filter(ss_b.phi, q, ss_b.z, ss_b.r, y, mask,
                                   chunk)
    return _unbatch(SqrtFilterResult(*out), single)


def sqrt_parallel_deviance(ss: StateSpace, y, mask, warmup: int = 1,
                           block="auto", device=None):
    """-2 log L through K21 (the per-step terms only), non-finite mapped
    to ``+inf``."""
    return _deviance(ss, y, mask, warmup, block, "sqrt_parallel", device)


def sqrt_parallel_smoother(ss: StateSpace, filtered: SqrtFilterResult,
                           block="auto") -> SqrtSmootherResult:
    """The factored RTS smoother as a reverse associative scan (K22) over
    a :class:`SqrtFilterResult` of :func:`sqrt_parallel_filter` or of the
    sequential ``sqrt_kalman_filter``; smoothed factors PSD by
    construction."""
    mean_f = filtered.mean_f
    dev, dtype = mean_f.device, mean_f.dtype
    phi = as_tensor(ss.phi, dev, dtype)
    q = as_tensor(ss.q, dev, dtype)
    _check_diagonal_q(q, "sqrt")
    q = torch.diagonal(q, 0, -2, -1)
    single = mean_f.dim() == 2
    args = [filtered.mean_f, filtered.chol_f, filtered.mean_p,
            filtered.chol_p]
    if single:
        phi, q, args = phi[None], q[None], [a[None] for a in args]
    chunk = _resolve_block(block, args[0].shape[1], args[0].shape[0])
    out = kpk.sqrt_parallel_smooth(phi.contiguous(), q.contiguous(),
                                   *[a.contiguous() for a in args], chunk)
    return _unbatch(SqrtSmootherResult(*out), single)


def sequence_sharded_filter(ss: StateSpace, y, mask, mesh, axis: str = "seq",
                            block="auto"):
    """Filter + smoother with the time axis sharded over mesh axis
    ``axis`` (the JAX function's signature and defaults).

    Shard k of the S devices along ``axis`` (index 0 on a 2-D mesh's other
    axes: each shard is computed once) holds steps ``[k T/S, (k+1) T/S)``
    and runs its kernels there: the filter's K19 ``total`` on every shard,
    K19 ``carry`` over the gathered totals on the first device, K19
    ``prefix`` on every shard from its incoming moment; then the smoother
    the same way in reverse (K20), each shard's last step reading the next
    shard's first predicted moment.  Every shard's launches of a stage are
    queued before anything crosses devices, and the only cross-device
    traffic is one element per shard (and the one-step halo), so shards on
    distinct cards run side by side; on a virtual mesh the copies are
    no-ops.  Values equal :func:`parallel_filter`/
    :func:`parallel_smoother`'s up to reassociation rounding.

    Returns ``(FilterResult, SmootherResult)``, each leaf gathered in time
    order on the mesh's first device; one model ((T, ...)) or a batch.
    Requires T divisible by the mesh axis size — pad with all-masked
    timesteps (the filter treats them as ordinary missing rows).
    ``block`` as in :func:`parallel_filter`; ``"auto"`` resolves against
    the per-shard length.
    """
    devices = mesh.axis_devices(axis)
    shards = len(devices)
    first = devices[0]
    ss_b, y, mask, single = _inputs(ss, y, mask, first)
    _refuse_card_grad(ss_b, y, "parallel")
    batch, t_steps = y.shape[:2]
    if t_steps % shards:
        raise ValueError(
            f"time axis ({t_steps}) must be divisible by mesh axis "
            f"{axis!r} ({shards}); pad with all-masked timesteps")
    from ..parallel.mesh import batch_sharding

    chunk = _resolve_block(block, t_steps // shards, batch)
    n = ss_b.phi.shape[-1]
    model = [tuple(leaf.to(d) for leaf in (ss_b.phi, ss_b.q, ss_b.z,
                                           ss_b.r)) for d in devices]
    time_axis = batch_sharding(mesh, 3, axis, dim=1)
    data = list(zip(time_axis.split(y), time_axis.split(mask)))

    # the filter: totals on every shard, the carry, each shard's scan
    tot = [kpk.parallel_filter_total(*model[k], *data[k], chunk,
                                     origin=k == 0) for k in range(shards)]
    pre = kpk.parallel_filter_carry(
        torch.stack([t[0].to(first) for t in tot], dim=1), n)
    filt = [kpk.parallel_filter_prefix(
        *model[k], *data[k], chunk, tot[k][1],
        None if k == 0 else pre[:, k - 1].to(devices[k]))
        for k in range(shards)]
    del tot
    # the smoother: the reverse scan, the latest shard first
    fout = [(f[2], f[3], f[0], f[1]) for f in filt]
    halo = [None if k == shards - 1 else
            (filt[k + 1][0][:, 0].to(devices[k]),
             filt[k + 1][1][:, 0].to(devices[k])) for k in range(shards)]
    stot = [kpk.parallel_smooth_total(model[k][0], *fout[k], chunk, halo[k])
            for k in range(shards)]
    spre = kpk.parallel_smooth_carry(torch.stack(
        [stot[k][0].to(first) for k in reversed(range(shards))], dim=1), n)
    smooth = [kpk.parallel_smooth_prefix(
        model[k][0], *fout[k], chunk, stot[k][1],
        None if k == shards - 1 else spre[:, shards - 2 - k].to(devices[k]),
        halo[k]) for k in range(shards)]

    def gather(parts):
        return tuple(time_axis.gather([p[i] for p in parts])
                     for i in range(len(parts[0])))

    return (_unbatch(FilterResult(*gather(filt)), single),
            _unbatch(SmootherResult(*gather(smooth)), single))


__all__ = [
    "AUTO_BLOCK",
    "AUTO_BLOCK_MIN_T",
    "parallel_deviance",
    "parallel_filter",
    "parallel_smoother",
    "sequence_sharded_filter",
    "sqrt_parallel_deviance",
    "sqrt_parallel_filter",
    "sqrt_parallel_smoother",
]
