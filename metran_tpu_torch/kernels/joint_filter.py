"""K1 wrapper: batched joint-update filter append, kernel or plain.

:func:`joint_filter_append` runs ``k`` filter steps for each of ``B``
models from a carried posterior ``N(mean, cov)``.  On CUDA tensors it
launches the hand-written kernel (``csrc/joint_filter.cu``: one or four
warps per model, ``csrc/joint_warp_step.cuh``; :func:`block_shape` picks
the warps a model and the models a block) and raises if that cannot build
or launch; on CPU
tensors it runs :func:`joint_filter_append_plain`, the same computation
in batched PyTorch ops — the oracle the kernel is held against on the
card.

With ``bounds_seg`` it also returns the carry at the start of every
segment of ``bounds_seg`` steps, ``(bounds_mean (B, n_seg, S),
bounds_cov (B, n_seg, S, S))``: the forward of the batch-layout
adjoint (``metran_tpu_torch.ops.adjoint``), whose backward replays each
segment from its boundary.  The per-step terms and the final carry are
those of the call without it, bit for bit (the kernel's ``bounds``
mode only adds the stores).

:func:`joint_filter_store` is the kernel's ``store`` mode: every step's
predicted and filtered moments ``(mean_p, cov_p, mean_f, cov_f, sigma,
detf)``, (B, k, S), (B, k, S, S), (B, k, S), (B, k, S, S), (B, k), (B,
k) — the joint engine's ``kalman_filter(store=True)``.  Each stored step
is the carry mode's, bit for bit.

:func:`joint_filter_append_block` and :func:`joint_filter_store_block`
launch the earlier kernel of the same source, one 256-thread block per
model (``csrc/joint_step.cuh``, the body the joint arena update shares).
The warp kernel computes its bits exactly: they are its oracle on the
card and the baseline it is timed against, and nothing in the port calls
them.  They take CUDA tensors only and count their launches apart.

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
#: models one block of the warp kernel holds at most, and warps a model
#: at most (``jointw::kMaxModels``, ``jointw::kMaxGroup``)
MAX_MODELS = 8
MAX_GROUP = 4
#: the kernel's modes, as the C entries number them (``jointk::Mode``)
MODES = {"carry": 0, "bounds": 1, "store": 2}


def block_smem_bytes(n_obs: int, n_state: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the block kernel (and of the joint arena
    update's body) for an (N, S) bucket (``jointk::carve``)."""
    item = torch.finfo(dtype).bits // 8
    n, s = n_obs, n_state
    return item * (s * s + 2 * n * s + 2 * n * n + s * n + 2 * s + 3 * n)


def _carve_bytes(n: int, s: int, item: int, sp: int, lp: int) -> int:
    values = (s * sp + n * s + n * sp + n * n + max(n * lp, s * n) + 2 * s
              + 5 * n)
    used = item * values + 4 * (n * -(-s // 32) + MAX_GROUP)
    return -(-used // 16) * 16


def model_bytes(n_obs: int, n_state: int, dtype: torch.dtype) -> int:
    """Shared memory of one model in the warp kernel (mirrors
    ``jointw::carve`` buffer by buffer, rounded up to 16 bytes): P and
    Z_m P with the row stride ``sp``, Z, F, one piece for its factor
    (row stride ``lp``) and then K F, two vectors of S and five of N, and
    as 32-bit words Z's nonzeros (a bit a column) and a verdict a warp.
    ``sp, lp = S | 1, N | 1`` (odd, so a lane a row hits distinct banks)
    while that fits :data:`MAX_SMEM`, else ``S, N``
    (``jointw::layout``)."""
    item = torch.finfo(dtype).bits // 8
    n, s = n_obs, n_state
    odd = _carve_bytes(n, s, item, s | 1, n | 1)
    return odd if odd <= MAX_SMEM else _carve_bytes(n, s, item, s, n)


def smem_bytes(n_obs: int, n_state: int, dtype: torch.dtype,
               models: int = 1) -> int:
    """Dynamic shared memory of one block of the warp kernel holding
    ``models`` models."""
    return models * model_bytes(n_obs, n_state, dtype)


_OCCUPANCY: dict = {}


def occupancy(n_obs: int, n_state: int, dtype: torch.dtype, mode: str,
              models: int, group: int) -> int:
    """Blocks of the warp kernel the current card keeps resident per SM
    at this shape and mode, with ``models`` models a block and ``group``
    warps a model (CUDA's occupancy calculator, which counts registers
    and shared memory as well as warps; builds the kernels)."""
    import ctypes

    key = (torch.cuda.current_device(), n_obs, n_state, dtype, mode,
           models, group)
    if key not in _OCCUPANCY:
        lib = build.load_library("joint_filter")
        fn = (lib.metran_joint_filter_occupancy_f64
              if dtype == torch.float64
              else lib.metran_joint_filter_occupancy_f32)
        blocks = ctypes.c_int(0)
        err = fn(n_obs, n_state, MODES[mode], models, group,
                 ctypes.byref(blocks))
        build.check(lib, err, "joint_filter occupancy")
        _OCCUPANCY[key] = blocks.value
    return _OCCUPANCY[key]


def block_shape(b: int, n_obs: int, n_state: int, dtype: torch.dtype,
                device, mode: str = "carry") -> Tuple[int, int]:
    """``(W, G)``: the warp kernel's launch for ``b`` models, ``W`` models
    a block and ``G`` warps a model.  Four warps a model, a model a block,
    while every such block is resident at once (SMs times
    :func:`occupancy`): a model's phases split over them.  Past that a
    warp a model, and the ``W`` (up to :data:`MAX_MODELS`, within
    :data:`MAX_SMEM`) that runs the ``b`` models in the fewest waves,
    then with the fewest models on the busiest SM, then the widest: with
    the card full, a wave's latency chain and the warps that share an SM
    are the time.  Every shape computes the same bits."""
    props = torch.cuda.get_device_properties(device)
    sms = props.multi_processor_count
    with torch.cuda.device(device):
        if b <= sms * occupancy(n_obs, n_state, dtype, mode, 1, MAX_GROUP):
            return 1, MAX_GROUP
        fit = max(1, min(MAX_MODELS,
                         MAX_SMEM // model_bytes(n_obs, n_state, dtype)))
        cost = {}
        for w in range(1, fit + 1):
            per_sm = -(-(-(-b // w)) // sms)  # blocks on the busiest SM
            held = occupancy(n_obs, n_state, dtype, mode, w, 1)
            cost[w] = (-(-per_sm // max(1, held)), w * per_sm, -w)
    return min(cost, key=cost.get), 1


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


def _shape(b: int, n: int, s: int, phi, block: bool, mode: str) -> tuple:
    """The launch geometry the C entry takes after ``(B, k, N, S[, seg])``:
    ``(W, G)`` for the warp kernel, nothing for the block kernel.  Raises
    when a block of one model does not fit :data:`MAX_SMEM`, or on tensors
    that are not on a CUDA device."""
    what = "the block kernel" if block else "the joint-filter kernel"
    smem = (block_smem_bytes if block else smem_bytes)(n, s, phi.dtype)
    if smem > MAX_SMEM:
        raise ValueError(
            f"bucket (N={n}, S={s}) at {phi.dtype} needs {smem} bytes of "
            f"shared memory per block in {what}; a block takes at most "
            f"{MAX_SMEM}"
        )
    if phi.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {phi.device}")
    return () if block else tuple(block_shape(b, n, s, phi.dtype,
                                              phi.device, mode))


def _launch(args, block: bool, store: bool = False, bounds_seg=None):
    """One launch of the warp kernel, or with ``block`` the block kernel:
    its carry or ``bounds`` mode, or with ``store`` its store mode."""
    phi = args[0]
    b, k, n, s = _check(*args)
    mode = ("store" if store else "carry" if bounds_seg is None
            else "bounds")
    shape = _shape(b, n, s, phi, block, mode)
    args = [t.contiguous() for t in args]
    new = dict(dtype=phi.dtype, device=phi.device)
    if store:
        moments = ((b, k, s), (b, k, s, s))
        outs = tuple(torch.empty(size, **new)
                     for size in (*moments, *moments, (b, k), (b, k)))
        ptrs, ints = [o.data_ptr() for o in outs], (b, k, n, s)
    else:
        outs = (torch.empty_like(args[4]), torch.empty_like(args[5]),
                torch.empty((b, k), **new), torch.empty((b, k), **new))
        seg, ptrs = 0, [None, None]
        if bounds_seg is not None:
            seg = int(bounds_seg)
            n_seg = _n_seg(k, seg)
            outs += (torch.empty((b, n_seg, s), **new),
                     torch.empty((b, n_seg, s, s), **new))
            ptrs = []
        ptrs = [o.data_ptr() for o in outs] + ptrs
        ints = (b, k, n, s, seg)
    name = (("joint_filter_store" if store else "joint_filter_append")
            + ("_block" if block else ""))
    lib = build.load_library("joint_filter")
    base = "metran_" + name.replace("joint_filter_append", "joint_filter")
    fn = getattr(lib, base + ("_f64" if phi.dtype == torch.float64
                              else "_f32"))
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = fn(*[t.data_ptr() for t in args], *ptrs, *ints, *shape, stream)
    build.check(lib, err, name)
    if b:
        build.count_launch(name)
    return outs


def joint_filter_append_kernel(phi, q, z, r, mean, cov, y, mask,
                               bounds_seg: Optional[int] = None
                               ) -> Tuple[torch.Tensor, ...]:
    """Launch the warp kernel (CUDA tensors only; raises otherwise, and
    when the kernel cannot build, take the bucket or launch)."""
    return _launch((phi, q, z, r, mean, cov, y, mask), block=False,
                   bounds_seg=bounds_seg)


def joint_filter_append_block(phi, q, z, r, mean, cov, y, mask,
                              bounds_seg: Optional[int] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """Launch the block kernel, the warp kernel's bit-for-bit oracle
    (CUDA tensors only; raises otherwise).  Counted as
    ``joint_filter_append_block``."""
    return _launch((phi, q, z, r, mean, cov, y, mask), block=True,
                   bounds_seg=bounds_seg)


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
    """Launch the warp kernel's ``store`` mode (CUDA tensors only; raises
    otherwise, and when the kernel cannot build, take the bucket or
    launch)."""
    return _launch((phi, q, z, r, mean, cov, y, mask), block=False,
                   store=True)


def joint_filter_store_block(phi, q, z, r, mean, cov, y, mask
                             ) -> Tuple[torch.Tensor, ...]:
    """Launch the block kernel's ``store`` mode, the warp kernel's
    bit-for-bit oracle (CUDA tensors only; raises otherwise).  Counted
    as ``joint_filter_store_block``."""
    return _launch((phi, q, z, r, mean, cov, y, mask), block=True,
                   store=True)


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
