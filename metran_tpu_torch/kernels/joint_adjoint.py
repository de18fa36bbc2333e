"""K11 wrapper: the closed-form reverse sweep of the batch-layout deviance.

:func:`joint_adjoint` is the backward pass of
:func:`metran_tpu_torch.ops.adjoint.adjoint_deviance_terms` for ``B``
models, in joint (matrix) form whatever the forward engine was.  Given
the carry at the start of every segment of ``seg`` steps (the forward's
boundaries: covariances, or square-root factors with ``factored=True``,
entered as ``S S'`` once per segment) and the cotangents ``sb``, ``db``
of the per-step ``(sigma, detf)``, it walks the segments in reverse.
Each segment is replayed forward from its boundary in covariance form,

    m_p = phi o m,  P_p = (phi phi') o P + diag(q)
    F   = Z_m P_p Z_m' + diag(r o mask + 1 - mask),  F = L L'
    K'  = F^-1 Z_m P_p,  e = F^-1 v,  L^-1 Z_m,  ok = all(finite(L))
    m_f = m_p + K v,  P_f = P_p - K (Z_m P_p)

keeping per step the pre-predict ``(m, P)``, ``K'``, ``e``, ``L^-1 Z_m``
and ``ok``; then the sweep runs back over the segment with the incoming
adjoints ``(u, S)`` of the filtered moments, ``w = Z_m' e``:

    A'u  = u - Z_m'(K' u),   S A = S - (S K) Z_m,   A'SA = SA - Z_m'(K' SA)
    u_p  = A'u - 2 sb w
    S_p  = A'SA + db (L^-1 Z_m)'(L^-1 Z_m) - sb w w' + (A'u) w'
    phibar += u_p o m + (S_p o P) phi + (S_p o P)' phi,  qbar += diag(S_p)
    u <- u_p o phi,  S <- S_p o (phi phi')

(a step that is not ``ok`` passes ``(u, S)`` through).  Returns
``(phibar (B, n), qbar (B, n))``.

Shapes: ``phi``, ``qdiag`` (B, n); ``z`` (B, N, n); ``r`` (B, N);
``y``, ``mask`` (B, T, N); ``bounds_mean`` (B, n_seg, n);
``bounds_cov`` (B, n_seg, n, n) with ``n_seg = ceil(T / seg)``; ``sb``,
``db`` (B, T).  The last segment may be shorter than ``seg``: the JAX
package pads it with all-masked steps whose adjoint is exactly zero.

On CUDA tensors it launches the hand-written kernel
(``csrc/joint_adjoint.cu``: a block per model, whose replay groups fill a
ring of :func:`ring_depth` segment records while its sweep warps run back
over them; :func:`block_shape` picks the block) and raises if that cannot
build or launch;
on CPU tensors it runs :func:`joint_adjoint_plain`, the JAX function
step by step in batched PyTorch ops — the oracle the kernel is held
against on the card.

Replaces ``metran_tpu/ops/adjoint.py::_terms_bwd`` (B7; its
``replay_step`` and ``step_bwd``), which the JAX package runs per model
under ``vmap``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .joint_filter import MAX_SMEM


#: replay groups (and ring slots) at most; the ring then holds four times
#: the one-segment scratch of a kernel that replays and sweeps in turn
RING_MAX = 4
#: (warps a replay group, sweep warps): the compact block, for fleets that
#: fill the card, and the wide one, which spends more warps on each model
#: when the card has SMs to spare
COMPACT = (1, 4)
WIDE = (2, 8)
#: static shared memory of a block: the full and empty mbarriers of
#: RING_MAX slots, 8 bytes each, beside the dynamic layout
STATIC_SMEM = 2 * RING_MAX * 8


def scratch_stride(n_obs: int, n_state: int) -> int:
    """Values K11 keeps per replayed step and model: ``m`` (n), ``P``
    (n*n), ``K'`` (N*n), ``L^-1 Z_m`` (N*n), ``e`` (N) and ``ok`` (1)."""
    n, big_n = n_state, n_obs
    return n + n * n + 2 * big_n * n + big_n + 1


def _layout(n_obs: int, n_state: int, ring: int) -> int:
    """Values of one block's work matrices (mirrors ``carve`` and
    ``replay_values`` in the source, buffer by buffer)."""
    n, big_n = n_state, n_obs
    nn, nbig = n * n, n * big_n
    common = nbig + big_n + 2 * n  # Z, r, phi, q
    sweep = (5 * nn  # S, S A, S_p o P, A of two steps
             + 5 * n  # u, A'u, w, phibar, qbar
             + nbig  # K' of the next step's A
             + 2 * (nbig + nn + n + 2 * big_n + 1 + 2))  # per staged step:
    # L^-1 Z_m, P, m, e, mask, ok, (sb, db)
    replay = (nn + big_n * (big_n + 1) + 2 * nbig  # P, L, K', L^-1 Z_m
              + n + 3 * big_n)  # m, e, mask, reciprocal pivots
    return common + sweep + ring * replay


def smem_bytes(n_obs: int, n_state: int, dtype: torch.dtype,
               ring: int = 1) -> int:
    """Dynamic shared memory one block of K11 needs with ``ring``
    replay groups (mirrors ``carve`` in the source)."""
    return _layout(n_obs, n_state, ring) * (torch.finfo(dtype).bits // 8)


def ring_depth(n_obs: int, n_state: int, dtype: torch.dtype,
               n_seg: int) -> Tuple[int, bool]:
    """``(R, spill)``: the ring depth K11 launches with — the most replay
    groups, up to :data:`RING_MAX` and the number of segments, whose
    layout fits :data:`MAX_SMEM` beside the block's
    :data:`STATIC_SMEM` — and whether the layout spills to a
    device-memory workspace instead (no depth fits; every shape runs)."""
    most = max(1, min(RING_MAX, n_seg))
    for ring in range(most, 0, -1):
        if smem_bytes(n_obs, n_state, dtype, ring) <= MAX_SMEM - STATIC_SMEM:
            return ring, False
    return most, True


def block_shape(b: int, n_obs: int, n_state: int, dtype: torch.dtype,
                ring: int, spill: bool, device) -> Tuple[int, int]:
    """``(G, S)`` K11 launches ``b`` models with: :data:`WIDE` when every
    block of it is resident at once on the card, else (and for a spilled
    layout) :data:`COMPACT` (builds the kernels, for the occupancy
    query)."""
    if spill:
        return COMPACT
    props = torch.cuda.get_device_properties(device)
    with torch.cuda.device(device):
        resident = props.multi_processor_count * occupancy(
            n_obs, n_state, dtype, ring, spill, *WIDE)
    return WIDE if b <= resident else COMPACT


def scratch_shape(b: int, t_steps: int, seg: int, n_obs: int,
                  n_state: int, ring: int) -> Tuple[int, int, int, int]:
    """The ring of replayed records: ``(B, R, min(seg, T), stride)``."""
    return (b, ring, min(seg, t_steps), scratch_stride(n_obs, n_state))


def _check(phi, qdiag, z, r, y, mask, bounds_mean, bounds_cov, sb, db,
           seg):
    dtype = phi.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"the joint adjoint takes float32/float64, got {dtype}")
    if phi.dim() != 2:
        raise ValueError(f"phi must be (B, n), got {tuple(phi.shape)}")
    b, n = phi.shape
    if z.dim() != 3 or z.shape[0] != b or z.shape[2] != n:
        raise ValueError(f"z must be (B, N, {n}), got {tuple(z.shape)}")
    big_n = z.shape[1]
    if y.dim() != 3 or y.shape[0] != b or y.shape[2] != big_n:
        raise ValueError(f"y must be (B, T, {big_n}), got {tuple(y.shape)}")
    t_steps = y.shape[1]
    seg = int(seg)
    if seg < 1:
        raise ValueError(f"seg must be >= 1, got {seg}")
    n_seg = -(-t_steps // seg)
    want = {"qdiag": (qdiag, (b, n)), "r": (r, (b, big_n)),
            "mask": (mask, (b, t_steps, big_n)),
            "bounds_mean": (bounds_mean, (b, n_seg, n)),
            "bounds_cov": (bounds_cov, (b, n_seg, n, n)),
            "sb": (sb, (b, t_steps)), "db": (db, (b, t_steps))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("qdiag", qdiag), ("z", z), ("r", r), ("y", y),
                    ("bounds_mean", bounds_mean),
                    ("bounds_cov", bounds_cov), ("sb", sb), ("db", db)):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, phi is {dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    devices = {t.device for t in (phi, qdiag, z, r, y, mask, bounds_mean,
                                  bounds_cov, sb, db)}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    return b, t_steps, big_n, n, seg, n_seg


def joint_adjoint(phi, qdiag, z, r, y, mask, bounds_mean, bounds_cov, sb,
                  db, seg: int, factored: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(phibar, qbar)`` of every model (see the module doc)."""
    _check(phi, qdiag, z, r, y, mask, bounds_mean, bounds_cov, sb, db, seg)
    if phi.device.type == "cpu":
        return joint_adjoint_plain(phi, qdiag, z, r, y, mask, bounds_mean,
                                   bounds_cov, sb, db, seg, factored)
    return joint_adjoint_kernel(phi, qdiag, z, r, y, mask, bounds_mean,
                                bounds_cov, sb, db, seg, factored)


def joint_adjoint_kernel(phi, qdiag, z, r, y, mask, bounds_mean, bounds_cov,
                         sb, db, seg: int, factored: bool = False):
    """Launch K11 (CUDA tensors only; raises otherwise, and when the
    kernel cannot build or launch)."""
    b, t_steps, big_n, n, seg, _ = _check(
        phi, qdiag, z, r, y, mask, bounds_mean, bounds_cov, sb, db, seg)
    if phi.device.type != "cuda":
        raise ValueError(
            f"the joint-adjoint kernel runs on CUDA tensors, got {phi.device}")
    args = [t.contiguous() for t in (phi, qdiag, z, r, y, mask, bounds_mean,
                                     bounds_cov, sb, db)]
    new = dict(dtype=phi.dtype, device=phi.device)
    ring, spill = ring_depth(big_n, n, phi.dtype, -(-t_steps // seg))
    # R segments of replayed records per model; a layout that does not fit
    # shared memory lives in a device-memory workspace per block
    scratch = torch.empty(scratch_shape(b, t_steps, seg, big_n, n, ring),
                          **new)
    work = (torch.empty((b, _layout(big_n, n, ring)), **new) if spill
            else None)
    group, sweep = (block_shape(b, big_n, n, phi.dtype, ring, spill,
                                phi.device) if b else COMPACT)
    phibar = torch.empty((b, n), **new)
    qbar = torch.empty((b, n), **new)
    lib = build.load_library("joint_adjoint")
    fn = (lib.metran_joint_adjoint_f64 if phi.dtype == torch.float64
          else lib.metran_joint_adjoint_f32)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = fn(*[t.data_ptr() for t in args], scratch.data_ptr(),
                 None if work is None else work.data_ptr(),
                 phibar.data_ptr(), qbar.data_ptr(), b, t_steps, big_n, n,
                 seg, int(bool(factored)), ring, group, sweep, stream)
    build.check(lib, err, "joint_adjoint")
    if b:
        build.count_launch("joint_adjoint")
    return phibar, qbar


_OCCUPANCY: dict = {}


def occupancy(n_obs: int, n_state: int, dtype: torch.dtype, ring: int,
              spill: bool = False, group: int = COMPACT[0],
              sweep: int = COMPACT[1]) -> int:
    """Blocks of K11 the current card keeps resident per SM at this
    shape, ring depth and block (CUDA's occupancy calculator; builds the
    kernels)."""
    import ctypes

    key = (torch.cuda.current_device(), n_obs, n_state, dtype, ring,
           bool(spill), group, sweep)
    if key not in _OCCUPANCY:
        lib = build.load_library("joint_adjoint")
        fn = (lib.metran_joint_adjoint_occupancy_f64
              if dtype == torch.float64
              else lib.metran_joint_adjoint_occupancy_f32)
        blocks = ctypes.c_int(0)
        err = fn(n_obs, n_state, ring, group, sweep, int(bool(spill)),
                 ctypes.byref(blocks))
        build.check(lib, err, "joint_adjoint occupancy")
        _OCCUPANCY[key] = blocks.value
    return _OCCUPANCY[key]


def _replay_step(phi, qd, z, r, m, p, y_t, mask_t, eye_m):
    """One covariance-form joint predict + update of the replay (JAX
    ``replay_step``): returns the filtered ``(m_f, P_f)`` and what the
    sweep reads, ``(K', e, L^-1 Z_m, ok)``."""
    dtype = m.dtype
    maskf = mask_t.to(dtype)
    m_p = phi * m
    p_p = phi[:, :, None] * p * phi[:, None, :] + qd
    z_m = z * maskf[:, :, None]
    v = torch.where(mask_t, y_t - (z @ m_p[:, :, None])[..., 0],
                    torch.zeros_like(y_t))
    pz = p_p @ z_m.transpose(-1, -2)  # (B, n, N)
    f = z_m @ pz + torch.diag_embed(
        torch.where(mask_t, r, torch.zeros_like(r)) + (1.0 - maskf))
    chol, info = torch.linalg.cholesky_ex(f)
    ok = (info == 0) & torch.isfinite(chol).all(dim=(-1, -2))
    chol_safe = torch.where(ok[:, None, None], chol, eye_m)
    kt = torch.cholesky_solve(pz.transpose(-1, -2), chol_safe)  # (B, N, n)
    e = torch.cholesky_solve(v[:, :, None], chol_safe)[..., 0]
    li_z = torch.linalg.solve_triangular(chol_safe, z_m, upper=False)
    m_f = torch.where(ok[:, None],
                      m_p + (kt.transpose(-1, -2) @ v[:, :, None])[..., 0],
                      m_p)
    p_f = torch.where(ok[:, None, None],
                      p_p - kt.transpose(-1, -2) @ pz.transpose(-1, -2), p_p)
    return m_f, p_f, (kt, e, li_z, ok, z_m)


def joint_adjoint_plain(phi, qdiag, z, r, y, mask, bounds_mean, bounds_cov,
                        sb, db, seg: int, factored: bool = False):
    """The same function in batched PyTorch ops: the JAX ``_terms_bwd``
    step by step, a Python loop over segments and steps."""
    b, t_steps, big_n, n, seg, n_seg = _check(
        phi, qdiag, z, r, y, mask, bounds_mean, bounds_cov, sb, db, seg)
    new = dict(dtype=phi.dtype, device=phi.device)
    eye_m = torch.eye(big_n, **new)
    qd = torch.diag_embed(qdiag)
    phi_a, phi_b = phi[:, :, None], phi[:, None, :]
    u = torch.zeros((b, n), **new)
    s = torch.zeros((b, n, n), **new)
    phibar = torch.zeros((b, n), **new)
    qbar = torch.zeros((b, n), **new)
    for k in range(n_seg - 1, -1, -1):
        t0, t1 = k * seg, min(t_steps, (k + 1) * seg)
        m = bounds_mean[:, k]
        p = bounds_cov[:, k]
        if factored:  # a square-root boundary enters as S S', once
            p = p @ p.transpose(-1, -2)
        stored = []
        for t in range(t0, t1):
            m_f, p_f, res = _replay_step(phi, qd, z, r, m, p, y[:, t],
                                         mask[:, t], eye_m)
            stored.append((m, p) + res)
            m, p = m_f, p_f
        for t in range(t1 - 1, t0 - 1, -1):
            m0, p0, kt, e, li_z, ok, z_m = stored[t - t0]
            sb_t, db_t = sb[:, t, None], db[:, t, None]
            z_mt = z_m.transpose(-1, -2)
            w = (z_mt @ e[:, :, None])[..., 0]
            au = u - (z_mt @ (kt @ u[:, :, None]))[..., 0]  # A'u
            sa = s - (s @ kt.transpose(-1, -2)) @ z_m  # S A
            asa = sa - z_mt @ (kt @ sa)  # A'S A
            u_p = torch.where(ok[:, None], au - 2.0 * sb_t * w, u)
            s_p = torch.where(
                ok[:, None, None],
                asa + db_t[:, :, None] * (li_z.transpose(-1, -2) @ li_z)
                - sb_t[:, :, None] * (w[:, :, None] * w[:, None, :])
                + au[:, :, None] * w[:, None, :],
                s)
            sc = s_p * p0
            phibar = (phibar + u_p * m0 + (sc @ phi[:, :, None])[..., 0]
                      + (sc.transpose(-1, -2) @ phi[:, :, None])[..., 0])
            qbar = qbar + torch.diagonal(s_p, 0, -2, -1)
            u = u_p * phi
            s = s_p * phi_a * phi_b
    return phibar, qbar


__all__ = [
    "joint_adjoint",
    "joint_adjoint_kernel",
    "joint_adjoint_plain",
    "COMPACT",
    "RING_MAX",
    "STATIC_SMEM",
    "WIDE",
    "block_shape",
    "occupancy",
    "ring_depth",
    "scratch_shape",
    "scratch_stride",
    "smem_bytes",
]
