"""K1 wrapper: batched joint-update filter append, kernel or plain.

:func:`joint_filter_append` runs ``k`` filter steps for each of ``B``
models from a carried posterior ``N(mean, cov)``.  On CUDA tensors it
launches the hand-written kernel (``csrc/joint_filter.cu``) and raises
if that cannot build or launch; on CPU tensors it runs
:func:`joint_filter_append_plain`, the same computation in batched
PyTorch ops — the oracle the kernel is held against on the card.

With ``bounds_seg`` it also returns the carry at the start of every
segment of ``bounds_seg`` steps, ``(bounds_mean (B, n_seg, S),
bounds_cov (B, n_seg, S, S))``: the forward of the batch-layout
adjoint (``metran_tpu_torch.ops.adjoint``), whose backward replays each
segment from its boundary.  The per-step terms and the final carry are
those of the call without it, bit for bit (the kernel's ``bounds``
instantiation only adds the stores).

:func:`joint_filter_store` is the kernel's ``store`` instantiation: every
step's predicted and filtered moments ``(mean_p, cov_p, mean_f, cov_f,
sigma, detf)``, (B, k, S), (B, k, S, S), (B, k, S), (B, k, S, S), (B,
k), (B, k) — the joint engine's ``kalman_filter(store=True)``.  Each
stored step is the carry instantiation's, bit for bit.

Replaces ``metran_tpu/ops/kalman.py::filter_append(engine="joint")``
(``_predict``/``_joint_update``, vmapped by ``serve/engine.py``), with
its store ``kalman_filter(engine="joint", store=True)`` and, with
boundaries, the joint engine of ``metran_tpu/ops/adjoint.py::
_run_segments``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

#: the largest dynamic shared memory one H100 block may use (bytes)
MAX_SMEM = 232_448


def smem_bytes(n_obs: int, n_state: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory the kernel needs for an (N, S) bucket."""
    item = torch.finfo(dtype).bits // 8
    n, s = n_obs, n_state
    return item * (s * s + 2 * n * s + 2 * n * n + s * n + 2 * s + 3 * n)


def _check(phi, q, z, r, mean, cov, y, mask):
    dtype = phi.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"joint filter takes float32/float64, got {dtype}")
    if phi.dim() != 2:
        raise ValueError(f"phi must be (B, S), got {tuple(phi.shape)}")
    b, s = phi.shape
    if z.dim() != 3 or z.shape[0] != b or z.shape[2] != s:
        raise ValueError(f"z must be (B, N, S), got {tuple(z.shape)}")
    n = z.shape[1]
    if y.dim() != 3 or y.shape[0] != b or y.shape[2] != n:
        raise ValueError(f"y must be (B, k, N), got {tuple(y.shape)}")
    k = y.shape[1]
    want = {
        "q": (q, (b, s, s)), "r": (r, (b, n)), "mean": (mean, (b, s)),
        "cov": (cov, (b, s, s)), "mask": (mask, (b, k, n)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {shape}, got {tuple(t.shape)}"
            )
    for name, t in (("phi", phi), ("q", q), ("z", z), ("r", r),
                    ("mean", mean), ("cov", cov), ("y", y)):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, phi is {dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    devices = {t.device for t in (phi, q, z, r, mean, cov, y, mask)}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    return b, k, n, s


def _n_seg(k: int, bounds_seg) -> int:
    if int(bounds_seg) < 1:
        raise ValueError(f"bounds_seg must be >= 1, got {bounds_seg}")
    return -(-k // int(bounds_seg))


def joint_filter_append(phi, q, z, r, mean, cov, y, mask,
                        bounds_seg: Optional[int] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """``k`` joint-update filter steps per model.

    Shapes: phi (B, S), q (B, S, S), z (B, N, S), r (B, N), mean (B, S),
    cov (B, S, S), y (B, k, N), mask (B, k, N) bool.  Returns
    ``(mean (B, S), cov (B, S, S), sigma (B, k), detf (B, k))``, and with
    ``bounds_seg`` the segment boundaries after them (module doc).
    """
    _check(phi, q, z, r, mean, cov, y, mask)
    if phi.device.type == "cpu":
        return joint_filter_append_plain(phi, q, z, r, mean, cov, y, mask,
                                         bounds_seg)
    return joint_filter_append_kernel(phi, q, z, r, mean, cov, y, mask,
                                      bounds_seg)


def joint_filter_append_kernel(phi, q, z, r, mean, cov, y, mask,
                               bounds_seg: Optional[int] = None
                               ) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel (CUDA tensors only; raises otherwise, and
    when the kernel cannot build, take the bucket or launch)."""
    b, k, n, s = _check(phi, q, z, r, mean, cov, y, mask)
    if phi.device.type != "cuda":
        raise ValueError(
            f"the joint-filter kernel runs on CUDA tensors, got {phi.device}"
        )
    smem = smem_bytes(n, s, phi.dtype)
    if smem > MAX_SMEM:
        raise ValueError(
            f"bucket (N={n}, S={s}) at {phi.dtype} needs {smem} bytes of "
            f"shared memory per block; the kernel takes at most {MAX_SMEM}"
        )
    args = [t.contiguous() for t in (phi, q, z, r, mean, cov, y, mask)]
    mean_out = torch.empty_like(args[4])
    cov_out = torch.empty_like(args[5])
    sigma = torch.empty((b, k), dtype=phi.dtype, device=phi.device)
    detf = torch.empty((b, k), dtype=phi.dtype, device=phi.device)
    bounds, seg = (), 0
    if bounds_seg is not None:
        seg = int(bounds_seg)
        n_seg = _n_seg(k, seg)
        bounds = (torch.empty((b, n_seg, s), dtype=phi.dtype,
                              device=phi.device),
                  torch.empty((b, n_seg, s, s), dtype=phi.dtype,
                              device=phi.device))
    bounds_ptr = [t.data_ptr() for t in bounds] or [None, None]
    lib = build.load_library("joint_filter")
    fn = (lib.metran_joint_filter_f64 if phi.dtype == torch.float64
          else lib.metran_joint_filter_f32)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = fn(*[t.data_ptr() for t in args],
                 mean_out.data_ptr(), cov_out.data_ptr(), sigma.data_ptr(),
                 detf.data_ptr(), *bounds_ptr, b, k, n, s, seg, stream)
    build.check(lib, err, "joint_filter_append")
    if b:
        build.count_launch("joint_filter_append")
    return (mean_out, cov_out, sigma, detf, *bounds)


def joint_filter_store(phi, q, z, r, mean, cov, y, mask
                       ) -> Tuple[torch.Tensor, ...]:
    """``k`` joint-update filter steps per model with every step's
    moments stored: ``(mean_p, cov_p, mean_f, cov_f, sigma, detf)``
    (module doc).  Shapes as :func:`joint_filter_append`."""
    _check(phi, q, z, r, mean, cov, y, mask)
    if phi.device.type == "cpu":
        return joint_filter_store_plain(phi, q, z, r, mean, cov, y, mask)
    return joint_filter_store_kernel(phi, q, z, r, mean, cov, y, mask)


def joint_filter_store_kernel(phi, q, z, r, mean, cov, y, mask
                              ) -> Tuple[torch.Tensor, ...]:
    """Launch K1's ``store`` instantiation (CUDA tensors only; raises
    otherwise, and when the kernel cannot build, take the bucket or
    launch)."""
    b, k, n, s = _check(phi, q, z, r, mean, cov, y, mask)
    if phi.device.type != "cuda":
        raise ValueError(
            f"the joint-filter kernel runs on CUDA tensors, got {phi.device}"
        )
    smem = smem_bytes(n, s, phi.dtype)
    if smem > MAX_SMEM:
        raise ValueError(
            f"bucket (N={n}, S={s}) at {phi.dtype} needs {smem} bytes of "
            f"shared memory per block; the kernel takes at most {MAX_SMEM}"
        )
    args = [t.contiguous() for t in (phi, q, z, r, mean, cov, y, mask)]
    new = dict(dtype=phi.dtype, device=phi.device)
    moments = ((b, k, s), (b, k, s, s))
    outs = tuple(torch.empty(shape, **new)
                 for shape in (*moments, *moments, (b, k), (b, k)))
    lib = build.load_library("joint_filter")
    fn = (lib.metran_joint_filter_store_f64 if phi.dtype == torch.float64
          else lib.metran_joint_filter_store_f32)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = fn(*[t.data_ptr() for t in args],
                 *[o.data_ptr() for o in outs], b, k, n, s, stream)
    build.check(lib, err, "joint_filter_store")
    if b:
        build.count_launch("joint_filter_store")
    return outs


def predict_plain(mean, cov, phi, q):
    """Diagonal-transition predict step (batched): Phi = diag(phi)."""
    return phi * mean, phi[..., :, None] * cov * phi[..., None, :] + q


def joint_update_plain(mean, cov, y, mask, z, r):
    """One masked joint update via Cholesky of the innovation covariance
    (batched over the leading axes), as
    ``metran_tpu/ops/kalman.py::_joint_update``.

    Unobserved slots get a unit innovation variance and zero innovation;
    an innovation covariance whose Cholesky fails (``info != 0`` or a
    non-finite factor) makes the step a no-op with ``sigma = 0`` and
    ``detf = +inf``.  Returns ``(mean, cov, sigma, detf)``.
    """
    dtype = mean.dtype
    maskf = mask.to(dtype)
    z_m = z * maskf[..., :, None]
    v = torch.where(mask, y - (z @ mean[..., None])[..., 0],
                    torch.zeros_like(y))
    pz = cov @ z_m.transpose(-1, -2)  # (..., S, N)
    f = z_m @ pz + torch.diag_embed(
        torch.where(mask, r, torch.zeros_like(r)) + (1.0 - maskf)
    )
    chol, info = torch.linalg.cholesky_ex(f)
    ok = (info == 0) & torch.isfinite(chol).all(dim=(-1, -2))
    eye = torch.eye(f.shape[-1], dtype=dtype, device=f.device).expand_as(f)
    chol_safe = torch.where(ok[..., None, None], chol, eye)
    kt = torch.cholesky_solve(pz.transpose(-1, -2), chol_safe)  # (..., N, S)
    mean_u = mean + (kt.transpose(-1, -2) @ v[..., None])[..., 0]
    cov_u = cov - kt.transpose(-1, -2) @ f @ kt
    w = torch.linalg.solve_triangular(chol_safe, v[..., None],
                                      upper=False)[..., 0]
    mean = torch.where(ok[..., None], mean_u, mean)
    cov = torch.where(ok[..., None, None], cov_u, cov)
    sigma = torch.where(ok, torch.sum(w * w, -1),
                        torch.zeros_like(ok, dtype=dtype))
    detf = torch.where(
        ok,
        2.0 * torch.sum(torch.log(torch.diagonal(chol_safe, 0, -2, -1)), -1),
        torch.full_like(ok, float("inf"), dtype=dtype),
    )
    return mean, cov, sigma, detf


def joint_filter_append_plain(phi, q, z, r, mean, cov, y, mask,
                              bounds_seg: Optional[int] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """The same function in batched PyTorch ops, a Python loop over k:
    :func:`predict_plain`, :func:`joint_update_plain`, and a step with no
    observation carries the predicted moments."""
    dtype = phi.dtype
    b, k = y.shape[:2]
    sigmas, detfs, b_mean, b_cov = [], [], [], []
    if bounds_seg is not None:
        _n_seg(k, bounds_seg)
    for t in range(k):
        if bounds_seg is not None and t % int(bounds_seg) == 0:
            b_mean.append(mean)
            b_cov.append(cov)
        mean_p, cov_p = predict_plain(mean, cov, phi, q)
        mean_u, cov_u, sigma_t, detf_t = joint_update_plain(
            mean_p, cov_p, y[:, t], mask[:, t], z, r
        )
        has_obs = mask[:, t].any(dim=-1)
        mean = torch.where(has_obs[:, None], mean_u, mean_p)
        cov = torch.where(has_obs[:, None, None], cov_u, cov_p)
        sigmas.append(sigma_t)
        detfs.append(detf_t)
    sigma = (torch.stack(sigmas, 1) if sigmas
             else torch.zeros((b, 0), dtype=dtype, device=phi.device))
    detf = (torch.stack(detfs, 1) if detfs
            else torch.zeros((b, 0), dtype=dtype, device=phi.device))
    if bounds_seg is None:
        return mean, cov, sigma, detf
    s = phi.shape[1]
    if not b_mean:
        return (mean, cov, sigma, detf, phi.new_zeros((b, 0, s)),
                phi.new_zeros((b, 0, s, s)))
    return (mean, cov, sigma, detf, torch.stack(b_mean, 1),
            torch.stack(b_cov, 1))


def joint_filter_store_plain(phi, q, z, r, mean, cov, y, mask
                             ) -> Tuple[torch.Tensor, ...]:
    """The store in batched PyTorch ops: the steps of
    :func:`joint_filter_append_plain`, each step's predicted and filtered
    moments kept."""
    b, k, _, s = _check(phi, q, z, r, mean, cov, y, mask)
    steps = []
    for t in range(k):
        mean_p, cov_p = predict_plain(mean, cov, phi, q)
        mean_u, cov_u, sigma_t, detf_t = joint_update_plain(
            mean_p, cov_p, y[:, t], mask[:, t], z, r
        )
        has_obs = mask[:, t].any(dim=-1)
        mean = torch.where(has_obs[:, None], mean_u, mean_p)
        cov = torch.where(has_obs[:, None, None], cov_u, cov_p)
        steps.append((mean_p, cov_p, mean, cov, sigma_t, detf_t))
    if not k:
        new = dict(dtype=phi.dtype, device=phi.device)
        moments = ((b, 0, s), (b, 0, s, s))
        return tuple(torch.zeros(shape, **new) for shape in
                     (*moments, *moments, (b, 0), (b, 0)))
    return tuple(torch.stack(parts, 1) for parts in zip(*steps))
