"""K19-K22 wrappers: the associative-scan (parallel-in-time) Kalman
filters and smoothers, in covariance and in square-root form.

The JAX package (``metran_tpu/ops/pkalman.py``) writes each engine as
per-step elements combined by an associative operator under
``lax.associative_scan``.  The kernels run the same operator over a
chunked decomposition of the time axis, one thread block per (model,
chunk) of ``chunk`` steps: an up-sweep folds each chunk's elements into
its total, a carry folds the totals into every chunk's exclusive prefix,
and a down-sweep folds each chunk's elements again from its prefix and
writes the per-step outputs.  A prefix from the first step (a suffix to
the last, in the smoother) is a filtered (smoothed) moment, and its part
of the combine that the outputs read does not depend on the prefix's
other parts, so the carry and the down-sweep run that reduced combine.
Values agree with the JAX functions' to reassociation rounding for any
chunk length; the plain versions here run the same decomposition, so the
card holds each kernel against its plain version on the same chunks.

- :func:`parallel_filter` (K19, ``csrc/pkalman_filter.cu``): elements
  ``(A, b, C, J, eta)``, combine with two LU solves
  (``_filter_element``, ``_filter_combine``, ``_filter_from_scan``);
- :func:`parallel_smooth` (K20, ``csrc/pkalman_smoother.cu``): elements
  ``(E, g, L)`` in reverse (``_smoother_element``, ``_smoother_combine``);
- :func:`sqrt_parallel_filter` (K21, ``csrc/sqrt_pkalman_filter.cu``):
  the filter with ``C = U U'`` carried as a triangular factor, combined
  through the Cholesky of ``I + U1' J2 U1`` and one QR
  (``_sqrt_filter_element``, ``_sqrt_filter_combine``,
  ``_sqrt_filter_from_scan``);
- :func:`sqrt_parallel_smooth` (K22, ``csrc/sqrt_pkalman_smoother.cu``):
  elements ``(E, g, D)`` with ``L = D D'`` (``_sqrt_smoother_element``,
  ``_sqrt_smoother_combine``).

K19 and K20 also run the time axis sharded over a device mesh (the JAX
``_sharded_associative_scan`` behind ``sequence_sharded_filter``), one
shard of the series per launch, in three modes: ``*_total`` folds every
chunk of the shard, the last included, into the shard's full element and
leaves the chunk totals for the shard's ``*_prefix`` launch; ``*_carry``
runs the chunk carry once over the S gathered shard totals (the latest
shard's first, in the smoother) into each shard's incoming moment;
``*_prefix`` carries the shard's chunk totals from its incoming moment and
runs the down-sweep.  A shard without the series' first step (the
smoother: its last) has no origin: step 0 is an ordinary step, the
filter's tails predict it from the incoming moment and the smoother's last
step reads the next shard's first predicted moment (``halo``).  Totals
and moments travel packed, (B, ..., parts): the filter's ``(A, b, C, J,
eta)`` and ``(b, C)``, the smoother's ``(E, g, L)`` and ``(g, L)``,
matrices row-major.

Each dispatches on the device: CUDA tensors launch the kernel (raising
if it cannot build or launch), CPU tensors run the plain version, the
JAX algorithm in batched PyTorch ops (``torch.linalg.solve_ex``,
``cholesky_ex``, ``qr``), differentiable by autograd.

Layouts, batch-major: ``phi`` (B, n); ``q`` (B, n, n) for the covariance
filter, its diagonal (B, n) for the square-root kernels; ``z`` (B, N, n),
``r`` (B, N); ``y``, ``mask`` (B, T, N); per-step outputs (B, T, n),
(B, T, n, n) and (B, T).  The filters' ``store=False`` keeps the final
(mean, covariance or factor) and the per-step terms only.

Replaces ``metran_tpu/ops/pkalman.py`` (B8): ``parallel_filter`` :317,
``parallel_smoother`` :401, ``sqrt_parallel_filter`` :613 and
``sqrt_parallel_smoother`` :704, with ``blocked_associative_scan`` :80;
the sharded modes ``_sharded_associative_scan`` :737 (``sequence_sharded_
filter`` :842).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from . import build
from .lanes import _ptr
from .sqrt_filter import sign_normalize_rows, tria

#: the card's streaming multiprocessors, and resident blocks of these
#: kernels per multiprocessor the automatic chunk length aims to fill
SMS = 132
BLOCKS_PER_SM = 4


def auto_chunk(t_steps: int, batch: int) -> int:
    """The chunk length the scan runs at when none is given: about
    ``sqrt(3 T)`` chunks (the latency of an up-sweep of full combines,
    the carry and a down-sweep is ~``3 T / c + c`` combines), but no more
    chunks than the card's resident blocks need to be busy for ``batch``
    models — a large fleet runs one chunk per model, the least work."""
    t_steps, batch = int(t_steps), max(1, int(batch))
    if t_steps <= 1:
        return 1
    latency = max(1, round(math.sqrt(3 * t_steps)))
    fill = max(1, SMS * BLOCKS_PER_SM // batch)
    chunks = min(latency, fill, t_steps)
    return -(-t_steps // chunks)


def n_chunks(t_steps: int, chunk: int) -> int:
    return -(-int(t_steps) // int(chunk)) if t_steps else 0


# ----------------------------------------------------------------------
# input checks
# ----------------------------------------------------------------------
def _same(dtype, device, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, phi is {dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, phi on {device}")


def _check_filter(phi, q, z, r, y, mask, chunk, sqrt: bool):
    """Validate a filter's inputs; returns ``(B, T, N, n)``."""
    dtype = phi.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the parallel filters take float32/float64, got "
                        f"{dtype}")
    if phi.dim() != 2:
        raise ValueError(f"phi must be (B, n), got {tuple(phi.shape)}")
    batch, n = phi.shape
    if y.dim() != 3 or y.shape[0] != batch:
        raise ValueError(f"y must be ({batch}, T, N), got {tuple(y.shape)}")
    t_steps, big_n = y.shape[1], y.shape[2]
    q_shape = (batch, n) if sqrt else (batch, n, n)
    for name, t, shape in (("q", q, q_shape), ("z", z, (batch, big_n, n)),
                           ("r", r, (batch, big_n)),
                           ("mask", mask, (batch, t_steps, big_n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    _same(dtype, phi.device, q=q, z=z, r=r, y=y)
    if mask.device != phi.device:
        raise ValueError(f"mask is on {mask.device}, phi on {phi.device}")
    if int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return batch, t_steps, big_n, n


def _check_smooth(phi, q, mean_f, cov_f, mean_p, cov_p, chunk):
    """Validate a smoother's inputs; returns ``(B, T, n)``."""
    dtype = phi.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the parallel smoothers take float32/float64, got "
                        f"{dtype}")
    if phi.dim() != 2:
        raise ValueError(f"phi must be (B, n), got {tuple(phi.shape)}")
    batch, n = phi.shape
    if mean_f.dim() != 3 or mean_f.shape[0] != batch or mean_f.shape[2] != n:
        raise ValueError(
            f"mean_f must be ({batch}, T, {n}), got {tuple(mean_f.shape)}")
    t_steps = mean_f.shape[1]
    shapes = [("mean_p", mean_p, (batch, t_steps, n)),
              ("cov_f", cov_f, (batch, t_steps, n, n)),
              ("cov_p", cov_p, (batch, t_steps, n, n))]
    if q is not None:
        shapes.append(("q", q, (batch, n)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    _same(dtype, phi.device, mean_f=mean_f, cov_f=cov_f, mean_p=mean_p,
          cov_p=cov_p, **({} if q is None else {"q": q}))
    if int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return batch, t_steps, n


def _cuda_only(t, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA tensors, got "
                         f"{t.device}")


def _launch(stem: str, name: str, dtype, args, ints, device, entry=None):
    lib = build.load_library(stem)
    fn = getattr(lib, f"metran_{entry or stem}_"
                      f"{'f64' if dtype == torch.float64 else 'f32'}")
    with torch.cuda.device(device):
        err = fn(*[_ptr(a) for a in args], *ints,
                 torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, err, name)


# ----------------------------------------------------------------------
# the chunked scan (plain versions)
# ----------------------------------------------------------------------
def _take(el, idx):
    return tuple(x[idx] for x in el)


def _fold_chunks(el, full: Callable, chunk: int, count: int):
    """The totals (B, ``count``, ...) of the first ``count`` chunks of
    ``chunk`` steps, each folded left to right by ``full`` (a short last
    chunk over its own steps)."""
    batch, t_steps = el[0].shape[:2]
    L = int(chunk)
    whole = min(count, t_steps // L)
    parts = []
    if whole:
        body = tuple(x[:, :whole * L].reshape(batch, whole, L, *x.shape[2:])
                     for x in el)
        tot = _take(body, (slice(None), slice(None), 0))
        for l in range(1, L):
            tot = full(tot, _take(body, (slice(None), slice(None), l)))
        parts.append(tot)
    if count > whole:
        rest = tuple(x[:, whole * L:] for x in el)
        tot = _take(rest, (slice(None), slice(0, 1)))
        for l in range(1, rest[0].shape[1]):
            tot = full(tot, _take(rest, (slice(None), slice(l, l + 1))))
        parts.append(tot)
    return tuple(torch.cat([p[i] for p in parts], dim=1)
                 for i in range(len(el)))


def _carry(tot, reduced: Callable, c: int, incoming=None):
    """The reduced parts of chunks 1 .. c - 1's exclusive prefixes, (B,
    c - 1, ...) each, from the chunk totals ``tot``: chunk k's is
    ``incoming (x) tot[0] (x) ... (x) tot[k - 1]``, or without
    ``incoming`` (a scan from the first step) starts at ``tot[0]``'s own
    reduced parts; ``None`` for one chunk."""
    if c <= 1:
        return None
    if incoming is None:
        prefixes = [(tot[1][:, 0], tot[2][:, 0])]
    else:
        prefixes = [reduced(incoming, _take(tot, (slice(None), 0)))]
    for k in range(1, c - 1):
        prefixes.append(reduced(prefixes[-1], _take(tot, (slice(None), k))))
    return tuple(torch.stack([p[i] for p in prefixes], dim=1)
                 for i in range(2))


def _down_sweep(el, reduced: Callable, chunk: int, pre, incoming=None):
    """Every step's reduced parts, folded in chunks from each chunk's
    prefix: ``pre`` for chunks 1 .. c - 1, ``incoming`` for chunk 0 (its
    first step takes its element's own parts without one)."""
    batch, t_steps = el[0].shape[:2]
    c = n_chunks(t_steps, chunk)
    L = int(chunk)
    pad = c * L - t_steps
    if pad:
        el = tuple(torch.cat([x, x[:, -1:].expand(-1, pad, *x.shape[2:])],
                             dim=1) for x in el)
    body = tuple(x.reshape(batch, c, L, *x.shape[2:]) for x in el)
    first = _take(body, (slice(None), slice(None), 0))
    # without incoming, chunk 0's prefix is a placeholder its first step
    # never reads
    heads = (tuple(torch.zeros_like(first[i][:, :1]) for i in (1, 2))
             if incoming is None else tuple(x[:, None] for x in incoming))
    if pre is not None:
        run = tuple(torch.cat([h, p], dim=1) for h, p in zip(heads, pre))
    elif incoming is not None:
        run = heads
    else:
        run = tuple(torch.zeros_like(first[i]) for i in (1, 2))
    outs = []
    for l in range(L):
        e = _take(body, (slice(None), slice(None), l))
        new = reduced(run, e)
        if l == 0 and incoming is None:
            new = tuple(torch.cat([e[i][:, :1], new[i - 1][:, 1:]], dim=1)
                        for i in (1, 2))
        run = new
        outs.append(new)
    return tuple(torch.stack([o[i] for o in outs], dim=2).reshape(
        batch, c * L, *outs[0][i].shape[2:])[:, :t_steps] for i in range(2))


def _fold_all(tot, full: Callable):
    """One full element: the chunk totals (B, c, ...) folded in order."""
    acc = _take(tot, (slice(None), 0))
    for k in range(1, tot[0].shape[1]):
        acc = full(acc, _take(tot, (slice(None), k)))
    return acc


def chunked_scan(el, full: Callable, reduced: Callable, chunk: int):
    """Every step's ``reduced`` part of the inclusive prefix combine of the
    elements ``el`` (a tuple of (B, T, ...) tensors) over the time axis,
    run as the kernels run it: chunks of ``chunk`` steps, an up-sweep of
    ``full`` combines over every chunk but the last, a carry of
    ``reduced`` combines over the chunk totals, a down-sweep of
    ``reduced`` combines from each chunk's prefix (the first step's value
    is its element's own).  ``full(p, e)`` combines two full tuples,
    ``reduced(p, e)`` the reduced part of a prefix (parts 1 and 2 of a
    tuple) with a full element.  Returns the two reduced parts,
    (B, T, ...) each."""
    c = n_chunks(el[0].shape[1], chunk)
    pre = None
    if c > 1:
        pre = _carry(_fold_chunks(el, full, chunk, c - 1), reduced, c)
    return _down_sweep(el, reduced, chunk, pre)


# packed totals and moments of the sharded modes: the parts' shapes, in
# the order the kernels pack them (row-major)
def filter_parts(n: int):
    """``(A, b, C, J, eta)``."""
    return ((n, n), (n,), (n, n), (n, n), (n,))


def smoother_parts(n: int):
    """``(E, g, L)``."""
    return ((n, n), (n,), (n, n))


def _numel(shapes) -> int:
    return sum(math.prod(sh) for sh in shapes)


def pack_parts(parts, shapes) -> torch.Tensor:
    """``parts`` (each (..., *shape)) packed along a last axis."""
    return torch.cat([p.reshape(*p.shape[:p.dim() - len(sh)], -1)
                      for p, sh in zip(parts, shapes)], dim=-1)


def unpack_parts(flat: torch.Tensor, shapes):
    """The inverse of :func:`pack_parts`."""
    sizes = [math.prod(sh) for sh in shapes]
    return tuple(x.reshape(*flat.shape[:-1], *sh) for x, sh in
                 zip(torch.split(flat, sizes, dim=-1), shapes))


def _flip(el):
    return tuple(torch.flip(x, dims=[1]) for x in el)


def _mv(a, x):
    return (a @ x[..., None])[..., 0]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _masked_obs(z, r, mask):
    """The masked observation model of every step: ``Z_t`` (B, T, N, n)
    with zero rows and ``r_t`` (B, T, N) with unit noise where masked."""
    maskf = mask.to(z.dtype)
    z_t = z[:, None] * maskf[..., None]
    r_t = torch.where(mask, r[:, None], torch.zeros_like(maskf)) + (1.0 - maskf)
    return z_t, r_t


def _chol(s):
    """``(L, ok)``: the lower Cholesky factor and whether it succeeded with
    finite entries (the JAX package's NaN-on-failure test)."""
    chol, info = torch.linalg.cholesky_ex(s)
    ok = (info == 0) & torch.isfinite(chol).all(dim=(-2, -1))
    return chol, ok


def _first_flags(t_steps, like, origin: bool = True):
    """Step 0 is the series' first only in the shard that holds it."""
    return (torch.arange(t_steps, device=like.device) == 0)[None, :] & origin


# ----------------------------------------------------------------------
# K19: the covariance filter
# ----------------------------------------------------------------------
def _filter_elements(phi, q, z_t, r_t, y, origin: bool = True):
    """The JAX ``_filter_element`` of every step, (B, T, ...) each."""
    t_steps = y.shape[1]
    n = phi.shape[-1]
    eye = _eye(n, phi)
    first = _first_flags(t_steps, phi, origin)
    p1p = torch.diag_embed(phi * phi) + q
    cov_pred = torch.where(first[..., None, None], p1p[:, None], q[:, None])
    phi_eff = torch.where(first[..., None], torch.zeros_like(phi[:, None]),
                          phi[:, None])
    zp = z_t @ cov_pred
    s = zp @ z_t.transpose(-1, -2) + torch.diag_embed(r_t)
    chol, ok = _chol(s)
    chol = torch.where(ok[..., None, None], chol, _eye(s.shape[-1], s))
    rhs = torch.cat([zp, z_t, y[..., None]], dim=-1)
    sol = torch.cholesky_solve(rhs, chol)
    k = sol[..., :n].transpose(-1, -2)
    ikh = eye - k @ z_t
    a = ikh * phi_eff[..., None, :]
    b = _mv(k, y)
    c = ikh @ cov_pred
    eta = phi_eff * _mv(z_t.transpose(-1, -2), sol[..., -1])
    j = (z_t.transpose(-1, -2) @ sol[..., n:2 * n]) * (
        phi_eff[..., :, None] * phi_eff[..., None, :])
    ok4, ok3 = ok[..., None, None], ok[..., None]
    return (torch.where(ok4, a, torch.diag_embed(phi_eff)),
            torch.where(ok3, b, torch.zeros_like(b)),
            torch.where(ok4, c, cov_pred),
            torch.where(ok4, j, torch.zeros_like(j)),
            torch.where(ok3, eta, torch.zeros_like(eta)))


def _filter_combine(e1, e2):
    """The JAX ``_filter_combine`` (e1 earlier, e2 later)."""
    a1, b1, c1, j1, eta1 = e1
    a2, b2, c2, j2, eta2 = e2
    n = a1.shape[-1]
    eye = _eye(n, a1)
    m, _ = torch.linalg.solve_ex(eye + c1 @ j2, torch.cat(
        [a1, (b1 + _mv(c1, eta2))[..., None], c1], dim=-1))
    a = a2 @ m[..., :n]
    b = _mv(a2, m[..., n]) + b2
    c = a2 @ m[..., n + 1:] @ a2.transpose(-1, -2) + c2
    w, _ = torch.linalg.solve_ex(eye + j2 @ c1, torch.cat(
        [(eta2 - _mv(j2, b1))[..., None], j2], dim=-1))
    eta = _mv(a1.transpose(-1, -2), w[..., 0]) + eta1
    j = a1.transpose(-1, -2) @ w[..., 1:] @ a1 + j1
    return a, b, c, j, eta


def _filter_reduced(p, e2):
    """``(b, C)`` of the combine of a prefix from the first step."""
    b1, c1 = p
    a2, b2, c2, j2, eta2 = e2
    n = c1.shape[-1]
    m, _ = torch.linalg.solve_ex(_eye(n, c1) + c1 @ j2, torch.cat(
        [(b1 + _mv(c1, eta2))[..., None], c1], dim=-1))
    return (_mv(a2, m[..., 0]) + b2,
            a2 @ m[..., 1:] @ a2.transpose(-1, -2) + c2)


def _filter_tails(phi, q, z_t, r_t, y, mask, mean_f, cov_f, incoming=None):
    """Predicted moments and likelihood terms (the JAX
    ``_filter_from_scan`` after its scan); step 0 predicts from the prior,
    or in a shard after the first from ``incoming`` (b, C), the previous
    shard's last filtered moment."""
    if incoming is None:
        mp0 = torch.zeros_like(mean_f[:, :1])
        cp0 = (torch.diag_embed(phi * phi) + q)[:, None]
    else:
        mp0 = (incoming[0] * phi)[:, None]
        cp0 = (phi[:, :, None] * incoming[1] * phi[:, None, :] + q)[:, None]
    mean_p = torch.cat([mp0, mean_f[:, :-1] * phi[:, None]], dim=1)
    cov_p = torch.cat([cp0,
                       phi[:, None, :, None] * cov_f[:, :-1]
                       * phi[:, None, None, :] + q[:, None]], dim=1)
    v = torch.where(mask, y - _mv(z_t, mean_p), torch.zeros_like(y))
    f = z_t @ cov_p @ z_t.transpose(-1, -2) + torch.diag_embed(r_t)
    chol, ok = _chol(f)
    chol = torch.where(ok[..., None, None], chol, _eye(f.shape[-1], f))
    w = torch.linalg.solve_triangular(chol, v[..., None], upper=False)[..., 0]
    zero = torch.zeros_like(w[..., 0])
    sigma = torch.where(ok, torch.sum(w * w, dim=-1), zero)
    logd = torch.log(torch.diagonal(chol, 0, -2, -1))
    detf = torch.where(ok, 2.0 * torch.sum(logd, dim=-1),
                       torch.full_like(zero, float("inf")))
    return mean_p, cov_p, sigma, detf


def parallel_filter(phi, q, z, r, y, mask, chunk: int, store: bool = True):
    """K19 (see the module doc): ``(mean_p, cov_p, mean_f, cov_f, sigma,
    detf)`` per step, or with ``store=False`` ``(mean_f (B, n), cov_f
    (B, n, n), sigma, detf)`` — the final filtered moments."""
    _check_filter(phi, q, z, r, y, mask, chunk, sqrt=False)
    fn = parallel_filter_plain if phi.device.type == "cpu" else \
        parallel_filter_kernel
    return fn(phi, q, z, r, y, mask, chunk, store)


def parallel_filter_plain(phi, q, z, r, y, mask, chunk: int,
                          store: bool = True):
    """The same scan in PyTorch ops, chunked as the kernel runs it."""
    _check_filter(phi, q, z, r, y, mask, chunk, sqrt=False)
    y = torch.where(mask, y, torch.zeros_like(y))
    z_t, r_t = _masked_obs(z, r, mask)
    el = _filter_elements(phi, q, z_t, r_t, y)
    mean_f, cov_f = chunked_scan(el, _filter_combine, _filter_reduced, chunk)
    mean_p, cov_p, sigma, detf = _filter_tails(phi, q, z_t, r_t, y, mask,
                                               mean_f, cov_f)
    if store:
        return mean_p, cov_p, mean_f, cov_f, sigma, detf
    return mean_f[:, -1], cov_f[:, -1], sigma, detf


def _filter_outputs(batch, t_steps, n, store, new):
    if store:
        return (torch.empty((batch, t_steps, n), **new),
                torch.empty((batch, t_steps, n, n), **new),
                torch.empty((batch, t_steps, n), **new),
                torch.empty((batch, t_steps, n, n), **new))
    return (None, None, torch.empty((batch, n), **new),
            torch.empty((batch, n, n), **new))


def parallel_filter_kernel(phi, q, z, r, y, mask, chunk: int,
                           store: bool = True):
    """Launch K19 (CUDA tensors only; raises otherwise, and when the
    kernel cannot build, take the shape or launch)."""
    batch, t_steps, big_n, n = _check_filter(phi, q, z, r, y, mask, chunk,
                                             sqrt=False)
    _cuda_only(phi, "parallel filter")
    new = dict(dtype=phi.dtype, device=phi.device)
    c = n_chunks(t_steps, chunk)
    scratch = torch.empty(batch * max(c - 1, 0) * (4 * n * n + 3 * n) or 1,
                          **new)
    outs = _filter_outputs(batch, t_steps, n, store, new)
    sigma = torch.empty((batch, t_steps), **new)
    detf = torch.empty((batch, t_steps), **new)
    args = [t.contiguous() for t in (phi, q, z, r, y)] + [
        mask.contiguous().view(torch.uint8)]
    _launch("pkalman_filter", "parallel_filter", phi.dtype,
            [*args, *outs, sigma, detf, scratch],
            [batch, t_steps, big_n, n, int(chunk), int(bool(store))],
            phi.device)
    if batch and t_steps:
        build.count_launch("parallel_filter")
    if store:
        return (*outs, sigma, detf)
    return outs[2], outs[3], sigma, detf


# ----------------------------------------------------------------------
# K19's sharded modes: one shard of the time axis per launch
# ----------------------------------------------------------------------
def _check_totals(tot, batch, count, size, what):
    if tuple(tot.shape) != (batch, count, size):
        raise ValueError(f"{what} must be {(batch, count, size)}, got "
                         f"{tuple(tot.shape)}")


def _check_moment(x, batch, n, what):
    if x is not None and tuple(x.shape) != (batch, n * n + n):
        raise ValueError(f"{what} must be {(batch, n * n + n)}, got "
                         f"{tuple(x.shape)}")


def _filter_shard(phi, q, z, r, y, mask, origin):
    """``(elements, (z_t, r_t, y))`` of a shard's steps."""
    y = torch.where(mask, y, torch.zeros_like(y))
    z_t, r_t = _masked_obs(z, r, mask)
    return _filter_elements(phi, q, z_t, r_t, y, origin), (z_t, r_t, y)


def parallel_filter_total(phi, q, z, r, y, mask, chunk: int,
                          origin: bool = True):
    """K19 ``total``: one shard's steps folded into its full element.
    ``origin``: the shard holds the series' first step.  Returns
    ``(total (B, F), chunk_totals (B, chunks, F))`` packed as
    :func:`filter_parts`; ``chunk_totals`` is the shard's
    :func:`parallel_filter_prefix` input."""
    _check_filter(phi, q, z, r, y, mask, chunk, sqrt=False)
    fn = parallel_filter_total_plain if phi.device.type == "cpu" else \
        parallel_filter_total_kernel
    return fn(phi, q, z, r, y, mask, chunk, origin)


def parallel_filter_total_plain(phi, q, z, r, y, mask, chunk: int,
                                origin: bool = True):
    """The same fold in PyTorch ops, chunked as the kernel runs it."""
    _check_filter(phi, q, z, r, y, mask, chunk, sqrt=False)
    n = phi.shape[-1]
    el, _ = _filter_shard(phi, q, z, r, y, mask, origin)
    tot = _fold_chunks(el, _filter_combine, chunk,
                       n_chunks(y.shape[1], chunk))
    shapes = filter_parts(n)
    return (pack_parts(_fold_all(tot, _filter_combine), shapes),
            pack_parts(tot, shapes))


def parallel_filter_total_kernel(phi, q, z, r, y, mask, chunk: int,
                                 origin: bool = True):
    """Launch K19 ``total`` (CUDA tensors only; raises otherwise)."""
    batch, t_steps, big_n, n = _check_filter(phi, q, z, r, y, mask, chunk,
                                             sqrt=False)
    _cuda_only(phi, "parallel filter")
    new = dict(dtype=phi.dtype, device=phi.device)
    size = _numel(filter_parts(n))
    tot = torch.empty((batch, n_chunks(t_steps, chunk), size), **new)
    total = torch.empty((batch, size), **new)
    args = [t.contiguous() for t in (phi, q, z, r, y)] + [
        mask.contiguous().view(torch.uint8)]
    _launch("pkalman_filter", "parallel_filter_total", phi.dtype,
            [*args, tot, total],
            [batch, t_steps, big_n, n, int(chunk), int(bool(origin))],
            phi.device, entry="pkalman_filter_total")
    if batch and t_steps:
        build.count_launch("parallel_filter_total")
    return total, tot


def parallel_filter_carry(totals, n: int):
    """K19 ``carry``: over the S shard totals ``totals`` (B, S, F) in time
    order, the incoming (b, C) of shards 1 .. S - 1, packed (B, S - 1,
    n^2 + n) — the chunk carry run once at length S."""
    fn = parallel_filter_carry_plain if totals.device.type == "cpu" else \
        parallel_filter_carry_kernel
    return fn(totals, n)


def parallel_filter_carry_plain(totals, n: int):
    """The same carry in PyTorch ops."""
    _check_totals(totals, totals.shape[0], totals.shape[1],
                  _numel(filter_parts(n)), "totals")
    shapes = filter_parts(n)
    pre = _carry(unpack_parts(totals, shapes), _filter_reduced,
                 totals.shape[1])
    if pre is None:
        return totals.new_empty((totals.shape[0], 0, n * n + n))
    return pack_parts(pre, shapes[1:3])


def parallel_filter_carry_kernel(totals, n: int):
    """Launch K19 ``carry`` (CUDA tensors only; raises otherwise)."""
    batch, shards = totals.shape[:2]
    _check_totals(totals, batch, shards, _numel(filter_parts(n)), "totals")
    if totals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"totals must be float32/float64, got "
                        f"{totals.dtype}")
    _cuda_only(totals, "parallel filter")
    pre = torch.empty((batch, max(shards - 1, 0), n * n + n),
                      dtype=totals.dtype, device=totals.device)
    _launch("pkalman_filter", "parallel_filter_carry", totals.dtype,
            [totals.contiguous(), pre], [batch, shards, n], totals.device,
            entry="pkalman_filter_carry")
    if batch and shards > 1:
        build.count_launch("parallel_filter_carry")
    return pre


def parallel_filter_prefix(phi, q, z, r, y, mask, chunk: int, chunk_totals,
                           incoming=None, store: bool = True):
    """K19 ``prefix``: one shard's outputs (those of
    :func:`parallel_filter`) from its incoming (b, C) ``incoming`` (B,
    n^2 + n; ``None`` for the shard that holds the series' first step),
    carried over the ``chunk_totals`` of its :func:`parallel_filter_total`
    launch."""
    _check_filter(phi, q, z, r, y, mask, chunk, sqrt=False)
    fn = parallel_filter_prefix_plain if phi.device.type == "cpu" else \
        parallel_filter_prefix_kernel
    return fn(phi, q, z, r, y, mask, chunk, chunk_totals, incoming, store)


def parallel_filter_prefix_plain(phi, q, z, r, y, mask, chunk: int,
                                 chunk_totals, incoming=None,
                                 store: bool = True):
    """The same carry and down-sweep in PyTorch ops."""
    batch, t_steps, _, n = _check_filter(phi, q, z, r, y, mask, chunk,
                                         sqrt=False)
    shapes = filter_parts(n)
    c = n_chunks(t_steps, chunk)
    _check_totals(chunk_totals, batch, c, _numel(shapes), "chunk_totals")
    _check_moment(incoming, batch, n, "incoming")
    inc = None if incoming is None else unpack_parts(incoming, shapes[1:3])
    el, (z_t, r_t, y0) = _filter_shard(phi, q, z, r, y, mask, inc is None)
    pre = _carry(unpack_parts(chunk_totals, shapes), _filter_reduced, c,
                 inc)
    mean_f, cov_f = _down_sweep(el, _filter_reduced, chunk, pre, inc)
    mean_p, cov_p, sigma, detf = _filter_tails(phi, q, z_t, r_t, y0, mask,
                                               mean_f, cov_f, inc)
    if store:
        return mean_p, cov_p, mean_f, cov_f, sigma, detf
    return mean_f[:, -1], cov_f[:, -1], sigma, detf


def parallel_filter_prefix_kernel(phi, q, z, r, y, mask, chunk: int,
                                  chunk_totals, incoming=None,
                                  store: bool = True):
    """Launch K19 ``prefix`` (CUDA tensors only; raises otherwise)."""
    batch, t_steps, big_n, n = _check_filter(phi, q, z, r, y, mask, chunk,
                                             sqrt=False)
    _cuda_only(phi, "parallel filter")
    c = n_chunks(t_steps, chunk)
    _check_totals(chunk_totals, batch, c, _numel(filter_parts(n)),
                  "chunk_totals")
    _check_moment(incoming, batch, n, "incoming")
    _same(phi.dtype, phi.device, chunk_totals=chunk_totals,
          **({} if incoming is None else {"incoming": incoming}))
    new = dict(dtype=phi.dtype, device=phi.device)
    pre = torch.empty(batch * max(c - 1, 0) * (n * n + n) or 1, **new)
    outs = _filter_outputs(batch, t_steps, n, store, new)
    sigma = torch.empty((batch, t_steps), **new)
    detf = torch.empty((batch, t_steps), **new)
    args = [t.contiguous() for t in (phi, q, z, r, y)] + [
        mask.contiguous().view(torch.uint8)]
    _launch("pkalman_filter", "parallel_filter_prefix", phi.dtype,
            [*args, *outs, sigma, detf, chunk_totals.contiguous(), pre,
             None if incoming is None else incoming.contiguous()],
            [batch, t_steps, big_n, n, int(chunk), int(bool(store)),
             int(incoming is None)], phi.device,
            entry="pkalman_filter_prefix")
    if batch and t_steps:
        build.count_launch("parallel_filter_prefix")
    if store:
        return (*outs, sigma, detf)
    return outs[2], outs[3], sigma, detf


# ----------------------------------------------------------------------
# K20: the covariance smoother
# ----------------------------------------------------------------------
def _next_step(x):
    """Each step's successor (the last step's own value: a placeholder
    the cut element never reads)."""
    return torch.cat([x[:, 1:], x[:, -1:]], dim=1)


def _last_flags(t_steps, like):
    return (torch.arange(t_steps, device=like.device) == t_steps - 1)[None, :]


def _smoother_elements(phi, mean_f, cov_f, mean_p, cov_p, halo=None):
    """The JAX ``_smoother_element`` of every step; in a shard before the
    last, the last step's successor is ``halo`` (the next shard's first
    predicted (mean, covariance)) and only the series' last step is
    cut."""
    t_steps, n = mean_f.shape[1], mean_f.shape[2]
    if halo is None:
        mp_next, pp_next = _next_step(mean_p), _next_step(cov_p)
        cut = _last_flags(t_steps, phi)
    else:
        mp_next = torch.cat([mean_p[:, 1:], halo[0][:, None]], dim=1)
        pp_next = torch.cat([cov_p[:, 1:], halo[1][:, None]], dim=1)
        cut = torch.zeros((1, t_steps), dtype=torch.bool, device=phi.device)
    chol, ok = _chol(pp_next)
    chol = torch.where(ok[..., None, None], chol, _eye(n, chol))
    e = torch.cholesky_solve(phi[:, None, :, None]
                             * cov_f.transpose(-1, -2), chol
                             ).transpose(-1, -2)
    cut = cut | ~ok
    cut4, cut3 = cut[..., None, None], cut[..., None]
    e = torch.where(cut4, torch.zeros_like(e), e)
    g = torch.where(cut3, mean_f, mean_f - _mv(e, mp_next))
    l = torch.where(cut4, cov_f,  # noqa: E741
                    cov_f - e @ pp_next @ e.transpose(-1, -2))
    return e, g, l


def _smoother_combine(later, earlier):
    """The JAX ``_smoother_combine``: earlier (x) later."""
    e_l, g_l, l_l = later
    e_e, g_e, l_e = earlier
    return (e_e @ e_l, _mv(e_e, g_l) + g_e,
            e_e @ l_l @ e_e.transpose(-1, -2) + l_e)


def _smoother_reduced(later, earlier):
    g_l, l_l = later
    e_e, g_e, l_e = earlier
    return _mv(e_e, g_l) + g_e, e_e @ l_l @ e_e.transpose(-1, -2) + l_e


def _reverse_scan(el, full, reduced, chunk):
    """The reverse scan as the forward one on reversed time: chunks are
    counted from the last step, and the accumulated suffix is the later
    argument of each combine."""
    g, l = chunked_scan(_flip(el), full, reduced, chunk)  # noqa: E741
    return torch.flip(g, dims=[1]), torch.flip(l, dims=[1])


def parallel_smooth(phi, mean_f, cov_f, mean_p, cov_p, chunk: int):
    """K20 (see the module doc): ``(mean_s (B, T, n), cov_s (B, T, n,
    n))`` over a stored covariance filter."""
    _check_smooth(phi, None, mean_f, cov_f, mean_p, cov_p, chunk)
    fn = parallel_smooth_plain if phi.device.type == "cpu" else \
        parallel_smooth_kernel
    return fn(phi, mean_f, cov_f, mean_p, cov_p, chunk)


def parallel_smooth_plain(phi, mean_f, cov_f, mean_p, cov_p, chunk: int):
    """The same reverse scan in PyTorch ops, chunked as the kernel."""
    _check_smooth(phi, None, mean_f, cov_f, mean_p, cov_p, chunk)
    el = _smoother_elements(phi, mean_f, cov_f, mean_p, cov_p)
    return _reverse_scan(el, _smoother_combine, _smoother_reduced, chunk)


def parallel_smooth_kernel(phi, mean_f, cov_f, mean_p, cov_p, chunk: int):
    """Launch K20 (CUDA tensors only; raises otherwise)."""
    batch, t_steps, n = _check_smooth(phi, None, mean_f, cov_f, mean_p,
                                      cov_p, chunk)
    _cuda_only(phi, "parallel smoother")
    new = dict(dtype=phi.dtype, device=phi.device)
    c = n_chunks(t_steps, chunk)
    scratch = torch.empty(batch * max(c - 1, 0) * (3 * n * n + 2 * n) or 1,
                          **new)
    mean_s = torch.empty((batch, t_steps, n), **new)
    cov_s = torch.empty((batch, t_steps, n, n), **new)
    args = [t.contiguous() for t in (phi, mean_f, cov_f, mean_p, cov_p)]
    _launch("pkalman_smoother", "parallel_smooth", phi.dtype,
            [*args, mean_s, cov_s, scratch], [batch, t_steps, n, int(chunk)],
            phi.device)
    if batch and t_steps:
        build.count_launch("parallel_smooth")
    return mean_s, cov_s


# ----------------------------------------------------------------------
# K20's sharded modes: one shard of the time axis per launch
# ----------------------------------------------------------------------
def _check_halo(halo, batch, n):
    if halo is None:
        return
    if (tuple(halo[0].shape) != (batch, n)
            or tuple(halo[1].shape) != (batch, n, n)):
        raise ValueError(f"halo must be ((B, n), (B, n, n)) = "
                         f"(({batch}, {n}), ({batch}, {n}, {n})), got "
                         f"{tuple(halo[0].shape)}, {tuple(halo[1].shape)}")


def parallel_smooth_total(phi, mean_f, cov_f, mean_p, cov_p, chunk: int,
                          halo=None):
    """K20 ``total``: one shard's reverse-scan elements folded (from its
    last step back) into its full element.  ``halo``: the next shard's
    first predicted ``(mean (B, n), cov (B, n, n))``, ``None`` for the
    shard that holds the series' last step.  Returns ``(total (B, F),
    chunk_totals (B, chunks, F))`` packed as :func:`smoother_parts`."""
    _check_smooth(phi, None, mean_f, cov_f, mean_p, cov_p, chunk)
    fn = parallel_smooth_total_plain if phi.device.type == "cpu" else \
        parallel_smooth_total_kernel
    return fn(phi, mean_f, cov_f, mean_p, cov_p, chunk, halo)


def parallel_smooth_total_plain(phi, mean_f, cov_f, mean_p, cov_p,
                                chunk: int, halo=None):
    """The same fold in PyTorch ops, chunked as the kernel runs it."""
    batch, t_steps, n = _check_smooth(phi, None, mean_f, cov_f, mean_p,
                                      cov_p, chunk)
    _check_halo(halo, batch, n)
    el = _flip(_smoother_elements(phi, mean_f, cov_f, mean_p, cov_p, halo))
    tot = _fold_chunks(el, _smoother_combine, chunk,
                       n_chunks(t_steps, chunk))
    shapes = smoother_parts(n)
    return (pack_parts(_fold_all(tot, _smoother_combine), shapes),
            pack_parts(tot, shapes))


def parallel_smooth_total_kernel(phi, mean_f, cov_f, mean_p, cov_p,
                                 chunk: int, halo=None):
    """Launch K20 ``total`` (CUDA tensors only; raises otherwise)."""
    batch, t_steps, n = _check_smooth(phi, None, mean_f, cov_f, mean_p,
                                      cov_p, chunk)
    _check_halo(halo, batch, n)
    _cuda_only(phi, "parallel smoother")
    new = dict(dtype=phi.dtype, device=phi.device)
    size = _numel(smoother_parts(n))
    tot = torch.empty((batch, n_chunks(t_steps, chunk), size), **new)
    total = torch.empty((batch, size), **new)
    hal = [None, None] if halo is None else [h.contiguous() for h in halo]
    args = [t.contiguous() for t in (phi, mean_f, cov_f, mean_p, cov_p)]
    _launch("pkalman_smoother", "parallel_smooth_total", phi.dtype,
            [*args, *hal, tot, total],
            [batch, t_steps, n, int(chunk), int(halo is None)], phi.device,
            entry="pkalman_smoother_total")
    if batch and t_steps:
        build.count_launch("parallel_smooth_total")
    return total, tot


def parallel_smooth_carry(totals, n: int):
    """K20 ``carry``: over the S shard totals ``totals`` (B, S, F) in scan
    order — the latest shard first — the incoming (g, L) of the next S - 1
    shards in that order, packed (B, S - 1, n^2 + n)."""
    fn = parallel_smooth_carry_plain if totals.device.type == "cpu" else \
        parallel_smooth_carry_kernel
    return fn(totals, n)


def parallel_smooth_carry_plain(totals, n: int):
    """The same carry in PyTorch ops."""
    _check_totals(totals, totals.shape[0], totals.shape[1],
                  _numel(smoother_parts(n)), "totals")
    shapes = smoother_parts(n)
    pre = _carry(unpack_parts(totals, shapes), _smoother_reduced,
                 totals.shape[1])
    if pre is None:
        return totals.new_empty((totals.shape[0], 0, n * n + n))
    return pack_parts(pre, shapes[1:3])


def parallel_smooth_carry_kernel(totals, n: int):
    """Launch K20 ``carry`` (CUDA tensors only; raises otherwise)."""
    batch, shards = totals.shape[:2]
    _check_totals(totals, batch, shards, _numel(smoother_parts(n)),
                  "totals")
    if totals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"totals must be float32/float64, got "
                        f"{totals.dtype}")
    _cuda_only(totals, "parallel smoother")
    pre = torch.empty((batch, max(shards - 1, 0), n * n + n),
                      dtype=totals.dtype, device=totals.device)
    _launch("pkalman_smoother", "parallel_smooth_carry", totals.dtype,
            [totals.contiguous(), pre], [batch, shards, n], totals.device,
            entry="pkalman_smoother_carry")
    if batch and shards > 1:
        build.count_launch("parallel_smooth_carry")
    return pre


def parallel_smooth_prefix(phi, mean_f, cov_f, mean_p, cov_p, chunk: int,
                           chunk_totals, incoming=None, halo=None):
    """K20 ``prefix``: one shard's smoothed ``(mean_s, cov_s)`` from its
    incoming (g, L) ``incoming`` (B, n^2 + n; ``None`` for the shard that
    holds the series' last step, which takes no ``halo`` either), carried
    over the ``chunk_totals`` of its :func:`parallel_smooth_total`
    launch."""
    _check_smooth(phi, None, mean_f, cov_f, mean_p, cov_p, chunk)
    if (incoming is None) != (halo is None):
        raise ValueError("a shard without the series' last step takes both "
                         "an incoming suffix and a halo; the last one "
                         "neither")
    fn = parallel_smooth_prefix_plain if phi.device.type == "cpu" else \
        parallel_smooth_prefix_kernel
    return fn(phi, mean_f, cov_f, mean_p, cov_p, chunk, chunk_totals,
              incoming, halo)


def parallel_smooth_prefix_plain(phi, mean_f, cov_f, mean_p, cov_p,
                                 chunk: int, chunk_totals, incoming=None,
                                 halo=None):
    """The same carry and down-sweep in PyTorch ops."""
    batch, t_steps, n = _check_smooth(phi, None, mean_f, cov_f, mean_p,
                                      cov_p, chunk)
    _check_halo(halo, batch, n)
    shapes = smoother_parts(n)
    c = n_chunks(t_steps, chunk)
    _check_totals(chunk_totals, batch, c, _numel(shapes), "chunk_totals")
    _check_moment(incoming, batch, n, "incoming")
    inc = None if incoming is None else unpack_parts(incoming, shapes[1:3])
    el = _flip(_smoother_elements(phi, mean_f, cov_f, mean_p, cov_p, halo))
    pre = _carry(unpack_parts(chunk_totals, shapes), _smoother_reduced, c,
                 inc)
    g, l = _down_sweep(el, _smoother_reduced, chunk, pre, inc)  # noqa: E741
    return torch.flip(g, dims=[1]), torch.flip(l, dims=[1])


def parallel_smooth_prefix_kernel(phi, mean_f, cov_f, mean_p, cov_p,
                                  chunk: int, chunk_totals, incoming=None,
                                  halo=None):
    """Launch K20 ``prefix`` (CUDA tensors only; raises otherwise)."""
    batch, t_steps, n = _check_smooth(phi, None, mean_f, cov_f, mean_p,
                                      cov_p, chunk)
    _check_halo(halo, batch, n)
    _cuda_only(phi, "parallel smoother")
    c = n_chunks(t_steps, chunk)
    _check_totals(chunk_totals, batch, c, _numel(smoother_parts(n)),
                  "chunk_totals")
    _check_moment(incoming, batch, n, "incoming")
    _same(phi.dtype, phi.device, chunk_totals=chunk_totals,
          **({} if incoming is None else {"incoming": incoming}))
    new = dict(dtype=phi.dtype, device=phi.device)
    pre = torch.empty(batch * max(c - 1, 0) * (n * n + n) or 1, **new)
    mean_s = torch.empty((batch, t_steps, n), **new)
    cov_s = torch.empty((batch, t_steps, n, n), **new)
    hal = [None, None] if halo is None else [h.contiguous() for h in halo]
    args = [t.contiguous() for t in (phi, mean_f, cov_f, mean_p, cov_p)]
    _launch("pkalman_smoother", "parallel_smooth_prefix", phi.dtype,
            [*args, *hal, mean_s, cov_s, chunk_totals.contiguous(), pre,
             None if incoming is None else incoming.contiguous()],
            [batch, t_steps, n, int(chunk), int(incoming is None)],
            phi.device, entry="pkalman_smoother_prefix")
    if batch and t_steps:
        build.count_launch("parallel_smooth_prefix")
    return mean_s, cov_s


# ----------------------------------------------------------------------
# K21: the square-root filter
# ----------------------------------------------------------------------
def _q_sqrt(q):
    return torch.sqrt(torch.clamp(q, min=0.0))


def _sqrt_filter_elements(phi, qs, z_t, r_t, y):
    """The JAX ``_sqrt_filter_element`` of every step."""
    batch, t_steps, big_n = y.shape
    n = phi.shape[-1]
    first = _first_flags(t_steps, phi)
    n_pred = torch.sqrt(torch.where(first[..., None], (phi * phi + qs * qs)[:, None],
                                    (qs * qs)[:, None]))
    phi_eff = torch.where(first[..., None], torch.zeros_like(phi[:, None]),
                          phi[:, None])
    zeros = z_t.new_zeros((batch, t_steps, big_n, n))
    pre = torch.cat([
        torch.cat([torch.diag_embed(torch.sqrt(r_t)), zeros], dim=-1),
        torch.cat([(z_t * n_pred[..., None, :]).transpose(-1, -2),
                   torch.diag_embed(n_pred)], dim=-1),
    ], dim=-2)
    rfull = sign_normalize_rows(torch.linalg.qr(pre, mode="reduced").R)
    sf = rfull[..., :big_n, :big_n].transpose(-1, -2)
    kbar = rfull[..., :big_n, big_n:].transpose(-1, -2)
    u = rfull[..., big_n:, big_n:].transpose(-1, -2)
    d = torch.diagonal(sf, 0, -2, -1)
    ok = (d > 0).all(dim=-1) & torch.isfinite(rfull).all(dim=(-2, -1))
    sf = torch.where(ok[..., None, None], sf, _eye(big_n, sf))
    sol = torch.linalg.solve_triangular(
        sf, torch.cat([z_t, y[..., None]], dim=-1), upper=False)
    z_hat, w_y = sol[..., :n], sol[..., n]
    a = (_eye(n, phi) - kbar @ z_hat) * phi_eff[..., None, :]
    b = _mv(kbar, w_y)
    eta = phi_eff * _mv(z_hat.transpose(-1, -2), w_y)
    bmat = z_hat * phi_eff[..., None, :]
    j = bmat.transpose(-1, -2) @ bmat
    ok4, ok3 = ok[..., None, None], ok[..., None]
    return (torch.where(ok4, a, torch.diag_embed(phi_eff)),
            torch.where(ok3, b, torch.zeros_like(b)),
            torch.where(ok4, u, torch.diag_embed(n_pred)),
            torch.where(ok4, j, torch.zeros_like(j)),
            torch.where(ok3, eta, torch.zeros_like(eta)))


def _sqrt_head(u1, b1, a2, j2, eta2):
    """The combine's common start: ``(ju, ls, au, g, um)``."""
    n = u1.shape[-1]
    ju = j2 @ u1
    ls = torch.linalg.cholesky_ex(_eye(n, u1)
                                  + u1.transpose(-1, -2) @ ju)[0]
    au = a2 @ u1
    g = torch.linalg.solve_triangular(ls, au.transpose(-1, -2),
                                      upper=False).transpose(-1, -2)
    um = b1 + _mv(u1, _mv(u1.transpose(-1, -2), eta2))
    return ju, ls, au, g, um


def _sqrt_filter_combine(e1, e2):
    """The JAX ``_sqrt_filter_combine`` (e1 earlier, e2 later)."""
    a1, b1, u1, j1, eta1 = e1
    a2, b2, u2, j2, eta2 = e2
    ju, ls, au, g, um = _sqrt_head(u1, b1, a2, j2, eta2)

    def sinv(x):
        return torch.cholesky_solve(x, ls)

    jut = ju.transpose(-1, -2)
    a = a2 @ a1 - au @ sinv(jut @ a1)
    b = _mv(a2, um) - _mv(au, sinv(_mv(jut, um)[..., None])[..., 0]) + b2
    u = tria(torch.cat([g, u2], dim=-1))
    v = eta2 - _mv(j2, b1)
    vs = sinv(_mv(u1.transpose(-1, -2), v)[..., None])[..., 0]
    eta = _mv(a1.transpose(-1, -2), v - _mv(ju, vs)) + eta1
    j = a1.transpose(-1, -2) @ (j2 - ju @ sinv(jut)) @ a1 + j1
    j = 0.5 * (j + j.transpose(-1, -2))
    return a, b, u, j, eta


def _sqrt_filter_reduced(p, e2):
    """``(b, U)`` of the combine of a prefix from the first step."""
    b1, u1 = p
    a2, b2, u2, j2, eta2 = e2
    ju, ls, au, g, um = _sqrt_head(u1, b1, a2, j2, eta2)
    hb = torch.cholesky_solve(_mv(ju.transpose(-1, -2), um)[..., None],
                              ls)[..., 0]
    return (_mv(a2, um) - _mv(au, hb) + b2,
            tria(torch.cat([g, u2], dim=-1)))


def _sqrt_filter_tails(phi, qs, z_t, r_t, y, mask, mean_f, chol_f):
    """Predicted (mean, factor) and likelihood terms (the JAX
    ``_sqrt_filter_from_scan`` after its scan)."""
    big_n = y.shape[-1]
    mean_p = torch.cat([torch.zeros_like(mean_f[:, :1]),
                        mean_f[:, :-1] * phi[:, None]], dim=1)
    chol_p1 = torch.diag_embed(torch.sqrt(phi * phi + qs * qs))
    qd = torch.diag_embed(qs)[:, None].expand(-1, chol_f.shape[1] - 1, -1, -1)
    chol_rest = tria(torch.cat([phi[:, None, :, None] * chol_f[:, :-1], qd],
                               dim=-1))
    chol_p = torch.cat([chol_p1[:, None], chol_rest], dim=1)
    sf = tria(torch.cat([z_t @ chol_p, torch.diag_embed(torch.sqrt(r_t))],
                        dim=-1))
    d = torch.diagonal(sf, 0, -2, -1)
    ok = (d > 0).all(dim=-1) & torch.isfinite(sf).all(dim=(-2, -1))
    sf = torch.where(ok[..., None, None], sf, _eye(big_n, sf))
    v = torch.where(mask, y - _mv(z_t, mean_p), torch.zeros_like(y))
    w = torch.linalg.solve_triangular(sf, v[..., None], upper=False)[..., 0]
    zero = torch.zeros_like(w[..., 0])
    sigma = torch.where(ok, torch.sum(w * w, dim=-1), zero)
    logd = torch.log(torch.where(ok[..., None], d, torch.ones_like(d)))
    detf = torch.where(ok, 2.0 * torch.sum(logd, dim=-1),
                       torch.full_like(zero, float("inf")))
    return mean_p, chol_p, sigma, detf


def sqrt_parallel_filter(phi, q, z, r, y, mask, chunk: int,
                         store: bool = True):
    """K21 (see the module doc; ``q`` the (B, n) diagonal of Q):
    ``(mean_p, chol_p, mean_f, chol_f, sigma, detf)`` per step, or with
    ``store=False`` ``(mean_f (B, n), chol_f (B, n, n), sigma, detf)``."""
    _check_filter(phi, q, z, r, y, mask, chunk, sqrt=True)
    fn = sqrt_parallel_filter_plain if phi.device.type == "cpu" else \
        sqrt_parallel_filter_kernel
    return fn(phi, q, z, r, y, mask, chunk, store)


def sqrt_parallel_filter_plain(phi, q, z, r, y, mask, chunk: int,
                               store: bool = True):
    """The same scan in PyTorch ops, chunked as the kernel runs it."""
    _check_filter(phi, q, z, r, y, mask, chunk, sqrt=True)
    qs = _q_sqrt(q)
    y = torch.where(mask, y, torch.zeros_like(y))
    z_t, r_t = _masked_obs(z, r, mask)
    el = _sqrt_filter_elements(phi, qs, z_t, r_t, y)
    mean_f, chol_f = chunked_scan(el, _sqrt_filter_combine,
                                  _sqrt_filter_reduced, chunk)
    mean_p, chol_p, sigma, detf = _sqrt_filter_tails(phi, qs, z_t, r_t, y,
                                                     mask, mean_f, chol_f)
    if store:
        return mean_p, chol_p, mean_f, chol_f, sigma, detf
    return mean_f[:, -1], chol_f[:, -1], sigma, detf


def sqrt_parallel_filter_kernel(phi, q, z, r, y, mask, chunk: int,
                                store: bool = True):
    """Launch K21 (CUDA tensors only; raises otherwise)."""
    batch, t_steps, big_n, n = _check_filter(phi, q, z, r, y, mask, chunk,
                                             sqrt=True)
    _cuda_only(phi, "square-root parallel filter")
    new = dict(dtype=phi.dtype, device=phi.device)
    c = n_chunks(t_steps, chunk)
    scratch = torch.empty(batch * max(c - 1, 0) * (4 * n * n + 3 * n) or 1,
                          **new)
    outs = _filter_outputs(batch, t_steps, n, store, new)
    sigma = torch.empty((batch, t_steps), **new)
    detf = torch.empty((batch, t_steps), **new)
    args = [t.contiguous() for t in (phi, q, z, r, y)] + [
        mask.contiguous().view(torch.uint8)]
    _launch("sqrt_pkalman_filter", "sqrt_parallel_filter", phi.dtype,
            [*args, *outs, sigma, detf, scratch],
            [batch, t_steps, big_n, n, int(chunk), int(bool(store))],
            phi.device)
    if batch and t_steps:
        build.count_launch("sqrt_parallel_filter")
    if store:
        return (*outs, sigma, detf)
    return outs[2], outs[3], sigma, detf


# ----------------------------------------------------------------------
# K22: the square-root smoother
# ----------------------------------------------------------------------
def _sqrt_smoother_elements(phi, qs, mean_f, chol_f, mean_p, chol_p):
    """The JAX ``_sqrt_smoother_element`` of every step."""
    t_steps, n = mean_f.shape[1], mean_f.shape[2]
    eye = _eye(n, phi)
    mp_next, sp_next = _next_step(mean_p), _next_step(chol_p)
    d = torch.diagonal(sp_next, 0, -2, -1)
    ok = (d > 0).all(dim=-1) & torch.isfinite(sp_next).all(dim=(-2, -1))
    sp_safe = torch.where(ok[..., None, None], sp_next, eye)
    a = phi[:, None, :, None] * (chol_f @ chol_f.transpose(-1, -2))
    e = torch.cholesky_solve(a, sp_safe).transpose(-1, -2)
    cut = _last_flags(t_steps, phi) | ~ok
    cut4, cut3 = cut[..., None, None], cut[..., None]
    e = torch.where(cut4, torch.zeros_like(e), e)
    g = torch.where(cut3, mean_f, mean_f - _mv(e, mp_next))
    dfac = tria(torch.cat([(eye - e * phi[:, None, None, :]) @ chol_f,
                           e * qs[:, None, None, :]], dim=-1))
    return e, g, torch.where(cut4, chol_f, dfac)


def _sqrt_smoother_combine(later, earlier):
    """The JAX ``_sqrt_smoother_combine``: earlier (x) later."""
    e_l, g_l, d_l = later
    e_e, g_e, d_e = earlier
    return (e_e @ e_l, _mv(e_e, g_l) + g_e,
            tria(torch.cat([e_e @ d_l, d_e], dim=-1)))


def _sqrt_smoother_reduced(later, earlier):
    g_l, d_l = later
    e_e, g_e, d_e = earlier
    return (_mv(e_e, g_l) + g_e, tria(torch.cat([e_e @ d_l, d_e], dim=-1)))


def sqrt_parallel_smooth(phi, q, mean_f, chol_f, mean_p, chol_p,
                         chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K22 (see the module doc; ``q`` the (B, n) diagonal of Q):
    ``(mean_s (B, T, n), chol_s (B, T, n, n))`` over stored factors."""
    _check_smooth(phi, q, mean_f, chol_f, mean_p, chol_p, chunk)
    fn = sqrt_parallel_smooth_plain if phi.device.type == "cpu" else \
        sqrt_parallel_smooth_kernel
    return fn(phi, q, mean_f, chol_f, mean_p, chol_p, chunk)


def sqrt_parallel_smooth_plain(phi, q, mean_f, chol_f, mean_p, chol_p,
                               chunk: int):
    """The same reverse scan in PyTorch ops, chunked as the kernel."""
    _check_smooth(phi, q, mean_f, chol_f, mean_p, chol_p, chunk)
    el = _sqrt_smoother_elements(phi, _q_sqrt(q), mean_f, chol_f, mean_p,
                                 chol_p)
    return _reverse_scan(el, _sqrt_smoother_combine, _sqrt_smoother_reduced,
                         chunk)


def sqrt_parallel_smooth_kernel(phi, q, mean_f, chol_f, mean_p, chol_p,
                                chunk: int):
    """Launch K22 (CUDA tensors only; raises otherwise)."""
    batch, t_steps, n = _check_smooth(phi, q, mean_f, chol_f, mean_p,
                                      chol_p, chunk)
    _cuda_only(phi, "square-root parallel smoother")
    new = dict(dtype=phi.dtype, device=phi.device)
    c = n_chunks(t_steps, chunk)
    scratch = torch.empty(batch * max(c - 1, 0) * (3 * n * n + 2 * n) or 1,
                          **new)
    mean_s = torch.empty((batch, t_steps, n), **new)
    chol_s = torch.empty((batch, t_steps, n, n), **new)
    args = [t.contiguous() for t in (phi, q, mean_f, chol_f, mean_p, chol_p)]
    _launch("sqrt_pkalman_smoother", "sqrt_parallel_smooth", phi.dtype,
            [*args, mean_s, chol_s, scratch], [batch, t_steps, n, int(chunk)],
            phi.device)
    if batch and t_steps:
        build.count_launch("sqrt_parallel_smooth")
    return mean_s, chol_s


__all__ = [
    "auto_chunk",
    "filter_parts",
    "pack_parts",
    "parallel_filter",
    "parallel_filter_carry",
    "parallel_filter_carry_kernel",
    "parallel_filter_carry_plain",
    "parallel_filter_kernel",
    "parallel_filter_plain",
    "parallel_filter_prefix",
    "parallel_filter_prefix_kernel",
    "parallel_filter_prefix_plain",
    "parallel_filter_total",
    "parallel_filter_total_kernel",
    "parallel_filter_total_plain",
    "parallel_smooth",
    "parallel_smooth_carry",
    "parallel_smooth_carry_kernel",
    "parallel_smooth_carry_plain",
    "parallel_smooth_kernel",
    "parallel_smooth_plain",
    "parallel_smooth_prefix",
    "parallel_smooth_prefix_kernel",
    "parallel_smooth_prefix_plain",
    "parallel_smooth_total",
    "parallel_smooth_total_kernel",
    "parallel_smooth_total_plain",
    "smoother_parts",
    "sqrt_parallel_filter",
    "sqrt_parallel_filter_kernel",
    "sqrt_parallel_filter_plain",
    "sqrt_parallel_smooth",
    "sqrt_parallel_smooth_kernel",
    "sqrt_parallel_smooth_plain",
    "unpack_parts",
]
