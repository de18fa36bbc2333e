"""K9 wrapper: the square-root (QR array) Kalman filter.

:func:`sqrt_filter` runs the square-root filter of ``L`` independent
lanes, carrying the mean and a factor ``S`` of the state covariance
(``P = S S'``): per step the predict ``m_p = phi o m``, ``S_p =
tria([phi o S | diag(sqrt q)])`` and the array update, one QR of

    [[ diag(sqrt r)    0   ]
     [ (Z_m S_p)'     S_p' ]]

(``Z_m`` the masked observation matrix, unit pseudo-noise on masked
slots), whose sign-normalised triangular result holds ``F^1/2``, the
scaled gain ``Kbar`` and the filtered factor ``S_f``; then ``w =
F^-1/2' \\ v``, ``m_f = m_p + Kbar w``, ``sigma = w.w`` and ``detf = 2
sum log diag F^1/2``.  A step whose ``F^1/2`` has a diagonal that is not
positive, or whose triangular result has an entry that is not finite,
passes the state through (``m_f = m_p``, ``S_f = S_p``) with ``sigma =
0`` and ``detf = +inf``.  No Cholesky of a computed matrix is taken:
every factor comes from orthogonal transformations, PSD by construction.

With ``store=True`` it returns every step's ``(mean_p, chol_p, mean_f,
chol_f, sigma, detf)``: (L, T, n), (L, T, n, n), (L, T, n), (L, T, n, n),
(L, T), (L, T) — what the factored smoother K10 reads.  Without, it
returns the final carry and the per-step terms, ``(mean (L, n), chol
(L, n, n), sigma (L, T), detf (L, T))``, starting from ``(0, I)`` or,
when given, from ``(mean0 (L, n), chol0 (L, n, n))`` per lane (a factor
that need not be triangular).  Without ``store`` but with
``bounds_seg`` it also returns the carry at the start of every segment
of ``bounds_seg`` steps, ``(bounds_mean (L, n_seg, n), bounds_chol
(L, n_seg, n, n))`` — the forward of the batch-layout adjoint
(``metran_tpu_torch.ops.adjoint``); the other outputs are those of the
call without it, bit for bit.

:func:`sqrt_filter_gated` is the kernel's gated instantiation, from a
given carry: each observed slot's marginal innovation ``z_i = v_i /
sqrt(f_i)``, ``f_i = |(Z_m S_p)_i|^2 + r_i``, is tested against ``z_i^2 >
thresh`` on armed lanes and the policy pre-transforms the slot's row of
the pre-array — ``"reject"`` masks it, ``"huber"`` scales ``v_i`` by
``sqrt(thresh) / |z_i|``, ``"inflate"`` adds ``v_i^2 / thresh - f_i`` to
``r_i`` — before the same QR update runs.  It returns the carry outputs
and the per-step ``zscore`` (L, T, N) (NaN where unobserved) and int8
``verdict``.  A step where no slot trips is the ungated given-carry
call's, bit for bit (kernel and plain version alike).

:func:`sqrt_filter_robust` is its robust (implicit-MAP) instantiation,
one per likelihood: each armed, observed slot that flags solves its
scalar MAP problem off the predicted marginal (``mu = Z_i m_p``, ``c_i
= |(Z S_p)_i|^2``; :mod:`.implicit_map`) and feeds the same QR the
pseudo-observation ``r_eff = 1 / max(w, 0.01 eps / c_i)``, ``v_eff =
(c_i + r_eff)(s_hat - mu) / c_i``; it returns the gated outputs and the
Newton iterations (int32).  A step where nothing flags is the
given-carry call's bit for bit; its launches count as
``sqrt_filter_robust``.

On CUDA tensors it launches the hand-written kernel
(``csrc/sqrt_filter.cu``: two or four warps per lane,
``csrc/sqrt_warp_step.cuh``; :func:`launch_shape` picks the warps a lane
and the lanes a block) and raises if that cannot build or launch; on
CPU tensors it runs :func:`sqrt_filter_plain`, the JAX algorithm step by
step in PyTorch ops (``torch.linalg.qr`` of the full pre-array, sign
normalisation, ``solve_triangular``), differentiable by autograd.

:func:`sqrt_filter_block`, :func:`sqrt_filter_gated_block` and
:func:`sqrt_filter_robust_block` launch the earlier kernel, one
64-thread block per lane (``csrc/sqrt_filter_block.cu`` over
``csrc/sqrt_step.cuh``, the body the square-root arena update shares).  The group kernel computes its
bits exactly: they are its oracle on the card and the baseline it is
timed against, and nothing in the port calls them.  They take CUDA
tensors only and count their launches apart.

Layouts as :func:`metran_tpu_torch.kernels.lanes_products.lanes_forward`:
``phi``, ``q`` (n, L) (``q`` the diagonal of Q), ``z`` (N, n, L), ``r``
(N, L); ``y``, ``mask`` (D, T, N) read through ``lane_map`` (L,) int32.

Replaces ``metran_tpu/ops/kalman.py``: ``_sqrt_kalman_filter``
(``_make_sqrt_core_step``, ``_sqrt_qr_update``, ``_tria``; B6) and the
square-root half of B9b, ``sqrt_filter_append`` and, gated,
``_make_gated_sqrt_core_step`` behind ``gated_sqrt_filter_append``; in
its robust modes ``metran_tpu/ops/implicit_map.py::
_make_robust_sqrt_core_step`` (B12).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from . import implicit_map as im
from .gated_filter import (
    GATE_DOWNWEIGHTED,
    GATE_PASS,
    GATE_REJECTED,
    check_robust_params,
    policy_code,
)
from .implicit_map import RobustParams
from .joint_filter import MAX_SMEM
from .lanes import _check, _ptr, _stream

#: warps one block of the group kernel holds at most (lanes times warps a
#: lane), and warps a lane at least and at most (``sqrtw::kMaxWarps``,
#: ``sqrtw::kMinGroup``, ``sqrtw::kMaxGroup``)
MAX_WARPS = 8
MIN_GROUP = 2
MAX_GROUP = 4
#: the group kernel's instantiations, as its occupancy entry numbers them
VARIANTS = {"carry": 0, "bounds": 1, "store": 2, "reject": 3, "huber": 4,
            "inflate": 5, "censored": 6, "quantized": 7, "huber_t": 8}
#: words of a lane's flags (``sqrtw::kFlags``)
_FLAGS = 6
#: the block kernel's static shared memory (``sqrtk::run_steps``'s four
#: shared scalars), beside its dynamic ``block_smem_bytes``
BLOCK_STATIC_SMEM = 32


def _odd(rows: int) -> int:
    return rows | 1


def block_smem_bytes(n_obs: int, n_state: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one block of the block kernel (and of the
    square-root arena update's body) needs (mirrors ``sqrtk::carve``):
    Z, the carry, the predicted factor, both work arrays and a few
    vectors, plus the observed-slot list and the gate's per-slot
    flags."""
    item = torch.finfo(dtype).bits // 8
    big_n, n = n_obs, n_state
    elems = (big_n * n + big_n + 3 * n + n * n + n + n * n
             + _odd(2 * n) * n + _odd(big_n + n) * (big_n + n)
             + (big_n + n) + 4 * big_n)
    return elems * item + 8 * big_n


def _carve_bytes(big_n: int, n: int, item: int, odd: bool,
                 bits: bool) -> int:
    r = big_n + n
    ldp = _odd(2 * n) if odd else 2 * n
    ldu = _odd(r) if odd else r
    values = (big_n * n + big_n + 3 * n + n * n + n + n * n
              + max(ldp * n, big_n * n + 2 * r) + ldu * r + r + 4 * big_n)
    words = 2 * big_n + _FLAGS + (big_n * -(-n // 32) if bits else 0)
    return -(-(item * values + 4 * words) // 16) * 16


def model_bytes(n_obs: int, n_state: int, dtype: torch.dtype) -> int:
    """Shared memory of one lane in the group kernel (mirrors
    ``sqrtw::carve`` buffer by buffer, rounded up to 16 bytes): the block
    kernel's pieces, the predict array grown to hold the gated rows of
    ``Z S_p`` and the update's reflectors where it is smaller, as 32-bit
    words the observed slots, the mask row (then the gate's hits), a
    lane's flags and Z's nonzeros (a bit a column).  Odd leading
    dimensions and the bits while that fits :data:`MAX_SMEM`, else
    neither (``sqrtw::layout``)."""
    item = torch.finfo(dtype).bits // 8
    full = _carve_bytes(n_obs, n_state, item, True, True)
    return full if full <= MAX_SMEM else _carve_bytes(n_obs, n_state, item,
                                                      False, False)


def smem_bytes(n_obs: int, n_state: int, dtype: torch.dtype,
               models: int = 1) -> int:
    """Dynamic shared memory of one block of the group kernel holding
    ``models`` lanes."""
    return models * model_bytes(n_obs, n_state, dtype)


_OCCUPANCY: dict = {}


def occupancy(n_obs: int, n_state: int, dtype: torch.dtype, variant: str,
              models: int, group: int) -> int:
    """Blocks of the group kernel the current card keeps resident per SM
    at this shape and instantiation (:data:`VARIANTS`), with ``models``
    lanes a block and ``group`` warps a lane (CUDA's occupancy
    calculator, which counts registers and shared memory as well as
    warps; builds the kernels)."""
    import ctypes

    key = (torch.cuda.current_device(), n_obs, n_state, dtype, variant,
           models, group)
    if key not in _OCCUPANCY:
        lib = build.load_library("sqrt_filter")
        fn = (lib.metran_sqrt_filter_occupancy_f64
              if dtype == torch.float64
              else lib.metran_sqrt_filter_occupancy_f32)
        blocks = ctypes.c_int(0)
        err = fn(n_obs, n_state, VARIANTS[variant], models, group,
                 ctypes.byref(blocks))
        build.check(lib, err, "sqrt_filter occupancy")
        _OCCUPANCY[key] = blocks.value
    return _OCCUPANCY[key]


def launch_shape(b: int, n_obs: int, n_state: int, dtype: torch.dtype,
                 device, variant: str = "carry") -> Tuple[int, int]:
    """``(W, G)``: the group kernel's launch for ``b`` lanes, ``W`` lanes
    a block and ``G`` warps a lane.  Four warps a lane, a lane a block,
    while every such block is resident at once (SMs times
    :func:`occupancy`): a stage's columns and the riders spread over
    them.  Past that two warps a lane (the owner's warp and one of
    workers), and the ``W`` (up to :data:`MAX_WARPS` / 2 lanes, within
    :data:`MAX_SMEM`) that runs the ``b`` lanes in the fewest waves, then
    with the fewest lanes on the busiest SM, then the widest.  Every shape
    computes the same bits."""
    props = torch.cuda.get_device_properties(device)
    sms = props.multi_processor_count
    with torch.cuda.device(device):
        if b <= sms * occupancy(n_obs, n_state, dtype, variant, 1,
                                MAX_GROUP):
            return 1, MAX_GROUP
        fit = max(1, min(MAX_WARPS // MIN_GROUP,
                         MAX_SMEM // model_bytes(n_obs, n_state, dtype)))
        cost = {}
        for w in range(1, fit + 1):
            per_sm = -(-(-(-b // w)) // sms)  # blocks on the busiest SM
            held = occupancy(n_obs, n_state, dtype, variant, w, MIN_GROUP)
            cost[w] = (-(-per_sm // max(1, held)), w * per_sm, -w)
    return min(cost, key=cost.get), MIN_GROUP


def _geometry(lanes: int, big_n: int, n: int, phi, block: bool,
              variant: str) -> tuple:
    """The launch geometry the C entry takes before the stream: ``(W,
    G)`` for the group kernel, nothing for the block kernel.  Raises when
    a block of one lane does not fit :data:`MAX_SMEM` (the block kernel's
    with its :data:`BLOCK_STATIC_SMEM`), or on tensors that are not on a
    CUDA device."""
    what = ("the block kernel" if block
            else "the square-root filter kernel")
    smem = (block_smem_bytes(big_n, n, phi.dtype) + BLOCK_STATIC_SMEM
            if block else smem_bytes(big_n, n, phi.dtype))
    if smem > MAX_SMEM:
        raise ValueError(
            f"(N={big_n}, n={n}) at {phi.dtype} needs {smem} bytes of "
            f"shared memory per block in {what}; a block takes at most "
            f"{MAX_SMEM}")
    if phi.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {phi.device}")
    return () if block else tuple(launch_shape(lanes, big_n, n, phi.dtype,
                                               phi.device, variant))


def _entry(base: str, block: bool, dtype: torch.dtype):
    """The loaded C entry ``base`` (``_block`` for the block kernel, in
    ``csrc/sqrt_filter_block.cu``) of ``dtype``, and its library."""
    lib = build.load_library("sqrt_filter_block" if block
                             else "sqrt_filter")
    name = (f"{base}{'_block' if block else ''}_"
            f"{'f64' if dtype == torch.float64 else 'f32'}")
    return lib, getattr(lib, name)


# ----------------------------------------------------------------------
# the plain step (shared with the factored smoother's plain version)
# ----------------------------------------------------------------------
def sign_normalize_rows(r: torch.Tensor) -> torch.Tensor:
    """Flip rows of upper-triangular QR factors (leading batch axes) so
    each diagonal is non-negative; a NaN diagonal NaNs its row, as the
    JAX package's ``jnp.sign`` does."""
    d = torch.diagonal(r, 0, -2, -1)
    sign = torch.where(torch.isnan(d), d,
                       torch.where(d < 0, -torch.ones_like(d),
                                   torch.ones_like(d)))
    return sign[..., :, None] * r


def tria(blocks: torch.Tensor) -> torch.Tensor:
    """Lower-triangular ``L`` with ``L L' = B B'`` for ``B`` (..., n, k),
    k >= n, via the QR of ``B'`` (``mode="reduced"``, which has a
    backward); the diagonal is sign-normalised to be non-negative."""
    r = torch.linalg.qr(blocks.transpose(-1, -2), mode="reduced").R
    return sign_normalize_rows(r).transpose(-1, -2)


def sqrt_predict_plain(ph, qs, mean, chol):
    """The square-root predict of a batch of lanes: ``(m_p, S_p)`` with
    ``S_p = tria([phi o S | diag(qs)])``."""
    mean_p = ph * mean
    chol_p = tria(torch.cat([ph[:, :, None] * chol, torch.diag_embed(qs)],
                            dim=2))
    return mean_p, chol_p


def sqrt_masked_row(zl, rl, mean_p, y_t, mask_t):
    """The masked observation row of a step: ``(Z_m, r_t, v)`` with unit
    pseudo-noise and zero innovation on masked slots."""
    maskf = mask_t.to(mean_p.dtype)
    z_m = zl * maskf[:, :, None]
    r_t = torch.where(mask_t, rl, torch.zeros_like(rl)) + (1.0 - maskf)
    v = torch.where(mask_t, y_t - (zl @ mean_p[:, :, None])[..., 0],
                    torch.zeros_like(y_t))
    return z_m, r_t, v


def sqrt_qr_update_plain(z_m, r_t, v, mean_p, chol_p):
    """The QR array update of one step (the JAX ``_sqrt_qr_update``),
    shared verbatim by the plain and the gated step so a gated step
    where nothing trips is the plain one bit for bit.  Returns
    ``(mean_f, chol_f, sigma, detf)``."""
    dtype = mean_p.dtype
    lanes, big_n, n = z_m.shape
    top = torch.cat([torch.diag_embed(torch.sqrt(r_t)),
                     z_m.new_zeros((lanes, big_n, n))], dim=2)
    bottom = torch.cat([(z_m @ chol_p).transpose(-1, -2),
                        chol_p.transpose(-1, -2)], dim=2)
    pre = torch.cat([top, bottom], dim=1)
    rfull = sign_normalize_rows(torch.linalg.qr(pre, mode="reduced").R)
    fu = rfull[:, :big_n, :big_n]
    kbar = rfull[:, :big_n, big_n:].transpose(-1, -2)
    chol_u = rfull[:, big_n:, big_n:].transpose(-1, -2)
    d = torch.diagonal(fu, 0, -2, -1)
    ok = (d > 0).all(dim=-1) & torch.isfinite(rfull).all(dim=(-2, -1))
    eye_m = torch.eye(big_n, dtype=dtype, device=mean_p.device)
    fu_safe = torch.where(ok[:, None, None], fu, eye_m)
    w = torch.linalg.solve_triangular(fu_safe.transpose(-1, -2),
                                      v[:, :, None], upper=False)[..., 0]
    mean_f = torch.where(ok[:, None], mean_p + (kbar @ w[:, :, None])[..., 0],
                         mean_p)
    chol_f = torch.where(ok[:, None, None], chol_u, chol_p)
    zero = torch.zeros((), dtype=dtype, device=mean_p.device)
    sigma = torch.where(ok, torch.sum(w * w, dim=-1), zero)
    logd = torch.log(torch.where(ok[:, None], d, torch.ones_like(d)))
    detf = torch.where(ok, 2.0 * torch.sum(logd, dim=-1),
                       torch.full_like(sigma, float("inf")))
    return mean_f, chol_f, sigma, detf


def sqrt_step_plain(ph, qs, zl, rl, mean, chol, y_t, mask_t):
    """One square-root filter step of a batch of lanes (the JAX
    ``_make_sqrt_core_step`` + ``_sqrt_qr_update``): ``ph``/``qs`` (L, n)
    (``qs`` = ``sqrt(max(q, 0))``), ``zl`` (L, N, n), ``rl`` (L, N),
    ``mean`` (L, n), ``chol`` (L, n, n), ``y_t`` (L, N), ``mask_t``
    (L, N) bool.  Returns ``(mean_p, chol_p, mean_f, chol_f, sigma,
    detf)``."""
    mean_p, chol_p = sqrt_predict_plain(ph, qs, mean, chol)
    z_m, r_t, v = sqrt_masked_row(zl, rl, mean_p, y_t, mask_t)
    return (mean_p, chol_p,
            *sqrt_qr_update_plain(z_m, r_t, v, mean_p, chol_p))


def gated_sqrt_step_plain(ph, qs, zl, rl, mean, chol, y_t, mask_t, armed,
                          policy: str, thresh: float,
                          robust: Optional[RobustParams] = None):
    """One gated square-root step (the JAX ``_make_gated_sqrt_core_step``):
    the marginal z-scores off ``S_p``, the policy's transform of the
    masked row, then :func:`sqrt_qr_update_plain`.  Returns ``(mean_f,
    chol_f, sigma, detf, zscore, verdict)``.

    With ``robust`` (``policy="robust"``) it is the JAX
    ``_make_robust_sqrt_core_step``: each armed, observed slot that
    flags solves its scalar MAP problem off the predicted marginal
    (``mu = Z m_p``, ``c_i = |(Z S_p)_i|^2``) and enters the same QR as
    the pseudo-observation ``r_eff = 1 / max(w, 0.01 eps / c)``, ``v_eff
    = (c + r_eff)(s_hat - mu) / c``; an unflagged slot keeps its row.
    The verdicts are :data:`ROBUST_MAP`/:data:`ROBUST_NONCONV` and a
    seventh output holds the Newton iterations (int32)."""
    dtype = mean.dtype
    one = torch.ones((), dtype=dtype, device=mean.device)
    t = torch.tensor(float(thresh), dtype=dtype, device=mean.device)
    mean_p, chol_p = sqrt_predict_plain(ph, qs, mean, chol)
    z_m, r_t, v = sqrt_masked_row(zl, rl, mean_p, y_t, mask_t)
    c_diag = torch.sum((z_m @ chol_p) ** 2, dim=-1)
    f_diag = c_diag + r_t
    zscore = v / torch.sqrt(f_diag)
    score = zscore * zscore
    hit = armed[:, None] & mask_t & (score > t)
    if robust is not None:
        hit = armed[:, None] & mask_t & im.flag(
            robust.likelihood, y_t, robust.rail_lo, robust.rail_hi)
        iters = torch.zeros(hit.shape, dtype=torch.int32,
                            device=mean.device)
        verdict = torch.zeros(hit.shape, dtype=torch.int8,
                              device=mean.device)
        if bool(hit.any()):
            mu = (zl @ mean_p[:, :, None])[..., 0]
            c_safe = torch.clamp(c_diag, min=im.c_floor(dtype))
            s_hat, w, _, it, nonconv = im.scalar_map_solve_plain(
                robust.likelihood, robust.nu, mu, c_safe, y_t,
                im.slot_scale(rl, robust.scale), robust.quantum,
                robust.rail_lo, robust.rail_hi, hit)
            eps = torch.tensor(float(torch.finfo(dtype).eps), dtype=dtype,
                               device=mean.device)
            r_eff = one / torch.maximum(w, eps * 1e-2 / c_safe)
            v_eff = (c_safe + r_eff) * (s_hat - mu) / c_safe
            r_t = torch.where(hit, r_eff, r_t)
            v = torch.where(hit, v_eff, v)
            verdict = torch.where(
                hit, torch.where(nonconv, im.ROBUST_NONCONV, im.ROBUST_MAP),
                0).to(torch.int8)
            iters = torch.where(hit, it, 0)
    elif policy == "reject":
        z_m, r_t, v = sqrt_masked_row(zl, rl, mean_p, y_t, mask_t & ~hit)
    elif policy == "huber":
        v = torch.where(hit, torch.sqrt(t / score), one) * v
    else:  # "inflate": v^2/t > f_i exactly when hit
        r_t = torch.where(hit, r_t + (v * v / t - f_diag), r_t)
    upd = sqrt_qr_update_plain(z_m, r_t, v, mean_p, chol_p)
    nan = torch.full((), float("nan"), dtype=dtype, device=mean.device)
    if robust is not None:
        return (*upd, torch.where(mask_t, zscore, nan), verdict, iters)
    code = GATE_REJECTED if policy == "reject" else GATE_DOWNWEIGHTED
    verdict = torch.where(hit, code, GATE_PASS).to(torch.int8)
    return (*upd, torch.where(mask_t, zscore, nan), verdict)


# ----------------------------------------------------------------------
def _check_sqrt(phi, q, z, r, y, mask, lane_map, mean0, chol0):
    out = _check(phi, q, z, r, y, mask, lane_map, None)
    lanes, n = out[0], out[4]
    if (mean0 is None) != (chol0 is None):
        raise ValueError("mean0 and chol0 come together (or neither)")
    if mean0 is not None:
        for name, t, shape in (("mean0", mean0, (lanes, n)),
                               ("chol0", chol0, (lanes, n, n))):
            if tuple(t.shape) != shape:
                raise ValueError(
                    f"{name} must be {shape}, got {tuple(t.shape)}")
            if t.dtype != phi.dtype:
                raise TypeError(f"{name} is {t.dtype}, phi is {phi.dtype}")
            if t.device != phi.device:
                raise ValueError(f"{name} is on {t.device}, phi on "
                                 f"{phi.device}")
    return out


def _n_seg(store, bounds_seg, t_steps):
    """``n_seg`` of a call with boundaries (None without them)."""
    if bounds_seg is None:
        return None
    if store:
        raise ValueError("store=True and bounds_seg exclude each other")
    if int(bounds_seg) < 1:
        raise ValueError(f"bounds_seg must be >= 1, got {bounds_seg}")
    return -(-t_steps // int(bounds_seg))


def sqrt_filter(phi, q, z, r, y, mask, lane_map=None, store: bool = False,
                mean0=None, chol0=None, bounds_seg: Optional[int] = None
                ) -> Tuple[torch.Tensor, ...]:
    """The square-root filter of every lane (see the module doc)."""
    _check_sqrt(phi, q, z, r, y, mask, lane_map, mean0, chol0)
    if phi.device.type == "cpu":
        return sqrt_filter_plain(phi, q, z, r, y, mask, lane_map, store,
                                 mean0, chol0, bounds_seg)
    return sqrt_filter_kernel(phi, q, z, r, y, mask, lane_map, store, mean0,
                              chol0, bounds_seg)


def sqrt_filter_kernel(phi, q, z, r, y, mask, lane_map=None,
                       store: bool = False, mean0=None, chol0=None,
                       bounds_seg: Optional[int] = None):
    """Launch K9, the group kernel (CUDA tensors only; raises otherwise,
    and when the kernel cannot build, take the shape or launch)."""
    return _filter_launch(phi, q, z, r, y, mask, lane_map, store, mean0,
                          chol0, bounds_seg, block=False)


def sqrt_filter_block(phi, q, z, r, y, mask, lane_map=None,
                      store: bool = False, mean0=None, chol0=None,
                      bounds_seg: Optional[int] = None):
    """Launch the block kernel, the group kernel's bit-for-bit oracle
    (CUDA tensors only; raises otherwise).  Counted as
    ``sqrt_filter_block``."""
    return _filter_launch(phi, q, z, r, y, mask, lane_map, store, mean0,
                          chol0, bounds_seg, block=True)


def _filter_launch(phi, q, z, r, y, mask, lane_map, store, mean0, chol0,
                   bounds_seg, block: bool):
    lanes, _, t_steps, big_n, n, _, _, lane_map = _check_sqrt(
        phi, q, z, r, y, mask, lane_map, mean0, chol0)
    n_seg = _n_seg(store, bounds_seg, t_steps)
    variant = ("store" if store else "carry" if n_seg is None
               else "bounds")
    shape = _geometry(lanes, big_n, n, phi, block, variant)
    args = [t.contiguous() for t in (phi, q, z, r, y, mask, lane_map)]
    init = [None if t is None else t.contiguous() for t in (mean0, chol0)]
    new = dict(dtype=phi.dtype, device=phi.device)
    terms = (torch.empty((lanes, t_steps), **new),
             torch.empty((lanes, t_steps), **new))
    if store:
        moments = ((lanes, t_steps, n), (lanes, t_steps, n, n))
        outs = tuple(torch.empty(shape_, **new) for shape_ in (*moments,
                                                               *moments))
        ptrs = [o.data_ptr() for o in outs]
    else:
        outs = (torch.empty((lanes, n), **new),
                torch.empty((lanes, n, n), **new))
        ptrs = [None, None] + [o.data_ptr() for o in outs]
    bounds = () if n_seg is None else (
        torch.empty((lanes, n_seg, n), **new),
        torch.empty((lanes, n_seg, n, n), **new))
    bounds_ptr = [t.data_ptr() for t in bounds] or [None, None]
    lib, fn = _entry("metran_sqrt_filter", block, phi.dtype)
    name = "sqrt_filter" + ("_block" if block else "")
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], _ptr(init[0]), _ptr(init[1]),
                 *ptrs, *[t.data_ptr() for t in terms], *bounds_ptr, lanes,
                 t_steps, big_n, n, int(bool(store)), int(bounds_seg or 1),
                 *shape, _stream(phi))
    build.check(lib, err, name)
    if lanes:
        build.count_launch(name)
    return (*outs, *terms, *bounds)


def sqrt_filter_plain(phi, q, z, r, y, mask, lane_map=None,
                      store: bool = False, mean0=None, chol0=None,
                      bounds_seg: Optional[int] = None):
    """The same filter in PyTorch ops: a Python loop over steps, each
    step :func:`sqrt_step_plain` batched over the lanes (autograd runs
    through it)."""
    lanes, _, t_steps, big_n, n, _, _, lane_map = _check_sqrt(
        phi, q, z, r, y, mask, lane_map, mean0, chol0)
    n_seg = _n_seg(store, bounds_seg, t_steps)
    new = dict(dtype=phi.dtype, device=phi.device)
    ph = phi.T
    qs = torch.sqrt(torch.clamp(q.T, min=0.0))
    zl = z.permute(2, 0, 1)
    rl = r.T
    idx = lane_map.long()
    yl, ml = y[idx], mask[idx]
    if mean0 is None:
        mean = torch.zeros((lanes, n), **new)
        chol = torch.eye(n, **new).expand(lanes, n, n)
    else:
        mean, chol = mean0, chol0
    steps, b_mean, b_chol = [], [], []
    for t in range(t_steps):
        if n_seg is not None and t % int(bounds_seg) == 0:
            b_mean.append(mean)
            b_chol.append(chol)
        out = sqrt_step_plain(ph, qs, zl, rl, mean, chol, yl[:, t], ml[:, t])
        mean, chol = out[2], out[3]
        steps.append(out if store else out[4:])
    bounds = ()
    if n_seg is not None:
        bounds = ((torch.stack(b_mean, 1), torch.stack(b_chol, 1)) if b_mean
                  else (torch.zeros((lanes, 0, n), **new),
                        torch.zeros((lanes, 0, n, n), **new)))
    if store:
        if not t_steps:
            moments = ((lanes, 0, n), (lanes, 0, n, n))
            return tuple(torch.zeros(s, **new) for s in
                         (*moments, *moments, (lanes, 0), (lanes, 0)))
        return tuple(torch.stack(parts, dim=1) for parts in zip(*steps))
    if not t_steps:
        empty = torch.zeros((lanes, 0), **new)
        return (mean, chol.contiguous(), empty, empty.clone(), *bounds)
    sigma, detf = (torch.stack(parts, dim=1) for parts in zip(*steps))
    return (mean, chol, sigma, detf, *bounds)


GATED_POLICIES = ("reject", "huber", "inflate")
#: the plain body's policy name for the robust instantiation
_ROBUST = "robust"


def _check_gated(phi, q, z, r, y, mask, lane_map, mean0, chol0, armed,
                 policy, robust: bool = False):
    out = _check_sqrt(phi, q, z, r, y, mask, lane_map, mean0, chol0)
    if robust and policy != _ROBUST:
        raise ValueError(f"the robust filter runs policy {_ROBUST!r}, got "
                         f"{policy!r}")
    if not robust and policy not in GATED_POLICIES:
        raise ValueError(
            f"the gated square-root filter takes policy "
            f"{' / '.join(GATED_POLICIES)}, got {policy!r} (with the gate "
            f"off, call sqrt_filter)")
    if mean0 is None:
        raise ValueError("the gated square-root filter runs from a given "
                         "carry (mean0, chol0)")
    lanes = out[0]
    if tuple(armed.shape) != (lanes,) or armed.dtype != torch.bool:
        raise ValueError(f"armed must be a bool ({lanes},) tensor, got "
                         f"{tuple(armed.shape)} {armed.dtype}")
    if armed.device != phi.device:
        raise ValueError(f"armed is on {armed.device}, phi on {phi.device}")
    return out


def sqrt_filter_gated(phi, q, z, r, y, mask, mean0, chol0, armed,
                      policy: str = "reject", thresh: float = 16.0,
                      lane_map=None) -> Tuple[torch.Tensor, ...]:
    """The gated square-root filter of every lane from a given carry:
    ``(mean (L, n), chol (L, n, n), sigma (L, T), detf (L, T), zscore
    (L, T, N), verdict (L, T, N) int8)`` (module doc)."""
    _check_gated(phi, q, z, r, y, mask, lane_map, mean0, chol0, armed,
                 policy)
    fn = (sqrt_filter_gated_plain if phi.device.type == "cpu"
          else sqrt_filter_gated_kernel)
    return fn(phi, q, z, r, y, mask, mean0, chol0, armed, policy, thresh,
              lane_map)


def sqrt_filter_gated_kernel(phi, q, z, r, y, mask, mean0, chol0, armed,
                             policy: str = "reject", thresh: float = 16.0,
                             lane_map=None):
    """Launch K9's gated instantiation, the group kernel (CUDA tensors
    only; raises otherwise, and when the kernel cannot build, take the
    shape or launch)."""
    return _gated_launch(phi, q, z, r, y, mask, mean0, chol0, armed, policy,
                         thresh, lane_map, block=False)


def sqrt_filter_gated_block(phi, q, z, r, y, mask, mean0, chol0, armed,
                            policy: str = "reject", thresh: float = 16.0,
                            lane_map=None):
    """Launch the block kernel's gated instantiation, the group kernel's
    bit-for-bit oracle (CUDA tensors only; raises otherwise).  Counted as
    ``sqrt_filter_gated_block``."""
    return _gated_launch(phi, q, z, r, y, mask, mean0, chol0, armed, policy,
                         thresh, lane_map, block=True)


def _gated_launch(phi, q, z, r, y, mask, mean0, chol0, armed, policy,
                  thresh, lane_map, block: bool):
    lanes, _, t_steps, big_n, n, _, _, lane_map = _check_gated(
        phi, q, z, r, y, mask, lane_map, mean0, chol0, armed, policy)
    shape = _geometry(lanes, big_n, n, phi, block, policy)
    args = [t.contiguous() for t in (phi, q, z, r, y, mask, lane_map,
                                     mean0, chol0, armed)]
    new = dict(dtype=phi.dtype, device=phi.device)
    outs = (torch.empty((lanes, n), **new), torch.empty((lanes, n, n), **new),
            torch.empty((lanes, t_steps), **new),
            torch.empty((lanes, t_steps), **new),
            torch.empty((lanes, t_steps, big_n), **new),
            torch.empty((lanes, t_steps, big_n), dtype=torch.int8,
                        device=phi.device))
    lib, fn = _entry("metran_sqrt_filter_gated", block, phi.dtype)
    name = "sqrt_filter_gated" + ("_block" if block else "")
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], float(thresh),
                 *[o.data_ptr() for o in outs], lanes, t_steps, big_n, n,
                 policy_code(policy), *shape, _stream(phi))
    build.check(lib, err, name)
    if lanes:
        build.count_launch(name)
    return outs


def sqrt_filter_gated_plain(phi, q, z, r, y, mask, mean0, chol0, armed,
                            policy: str = "reject", thresh: float = 16.0,
                            lane_map=None,
                            robust: Optional[RobustParams] = None):
    """The gated filter in PyTorch ops: a Python loop over steps, each
    :func:`gated_sqrt_step_plain` batched over the lanes (with
    ``robust``, :func:`sqrt_filter_robust_plain`'s body)."""
    lanes, _, t_steps, big_n, n, _, _, lane_map = _check_gated(
        phi, q, z, r, y, mask, lane_map, mean0, chol0, armed, policy,
        robust is not None)
    ph = phi.T
    qs = torch.sqrt(torch.clamp(q.T, min=0.0))
    zl = z.permute(2, 0, 1)
    rl = r.T
    idx = lane_map.long()
    yl, ml = y[idx], mask[idx]
    mean, chol = mean0, chol0
    steps = []
    for t in range(t_steps):
        mean, chol, *rest = gated_sqrt_step_plain(
            ph, qs, zl, rl, mean, chol, yl[:, t], ml[:, t], armed, policy,
            thresh, robust)
        steps.append(rest)
    if not t_steps:
        new = dict(dtype=phi.dtype, device=phi.device)
        out = (mean, chol.contiguous(), torch.zeros((lanes, 0), **new),
               torch.zeros((lanes, 0), **new),
               torch.zeros((lanes, 0, big_n), **new),
               torch.zeros((lanes, 0, big_n), dtype=torch.int8,
                           device=phi.device))
        return out + ((torch.zeros((lanes, 0, big_n), dtype=torch.int32,
                                   device=phi.device),)
                      if robust is not None else ())
    return (mean, chol, *(torch.stack(p, dim=1) for p in zip(*steps)))


def sqrt_filter_robust(phi, q, z, r, y, mask, mean0, chol0, armed, rail_lo,
                       rail_hi, quantum, scale, likelihood: str = "censored",
                       nu: float = 4.0, lane_map=None
                       ) -> Tuple[torch.Tensor, ...]:
    """The robust (implicit-MAP) square-root filter of every lane from a
    given carry: the per-lane parameters ``rail_lo``, ``rail_hi``,
    ``quantum``, ``scale`` are (L, N) in standardized units; returns
    ``(mean (L, n), chol (L, n, n), sigma (L, T), detf (L, T), zscore
    (L, T, N), verdict (L, T, N) int8, iters (L, T, N) int32)`` (module
    doc).  A step where nothing flags is the given-carry call's bit for
    bit."""
    out = _check_gated(phi, q, z, r, y, mask, lane_map, mean0, chol0, armed,
                       _ROBUST, True)
    im.likelihood_code(likelihood)
    check_robust_params((rail_lo, rail_hi, quantum, scale), out[0], out[3],
                        phi)
    fn = (sqrt_filter_robust_plain if phi.device.type == "cpu"
          else sqrt_filter_robust_kernel)
    return fn(phi, q, z, r, y, mask, mean0, chol0, armed, rail_lo, rail_hi,
              quantum, scale, likelihood, nu, lane_map)


def sqrt_filter_robust_kernel(phi, q, z, r, y, mask, mean0, chol0, armed,
                              rail_lo, rail_hi, quantum, scale,
                              likelihood: str = "censored", nu: float = 4.0,
                              lane_map=None):
    """Launch K9's robust instantiation, the group kernel (CUDA tensors
    only; raises otherwise, and when the kernel cannot build, take the
    shape or launch)."""
    return _robust_launch(phi, q, z, r, y, mask, mean0, chol0, armed,
                          rail_lo, rail_hi, quantum, scale, likelihood, nu,
                          lane_map, block=False)


def sqrt_filter_robust_block(phi, q, z, r, y, mask, mean0, chol0, armed,
                             rail_lo, rail_hi, quantum, scale,
                             likelihood: str = "censored", nu: float = 4.0,
                             lane_map=None):
    """Launch the block kernel's robust instantiation, the group kernel's
    bit-for-bit oracle (CUDA tensors only; raises otherwise).  Counted as
    ``sqrt_filter_robust_block``."""
    return _robust_launch(phi, q, z, r, y, mask, mean0, chol0, armed,
                          rail_lo, rail_hi, quantum, scale, likelihood, nu,
                          lane_map, block=True)


def _robust_launch(phi, q, z, r, y, mask, mean0, chol0, armed, rail_lo,
                   rail_hi, quantum, scale, likelihood, nu, lane_map,
                   block: bool):
    lanes, _, t_steps, big_n, n, _, _, lane_map = _check_gated(
        phi, q, z, r, y, mask, lane_map, mean0, chol0, armed, _ROBUST, True)
    code = im.likelihood_code(likelihood)
    check_robust_params((rail_lo, rail_hi, quantum, scale), lanes, big_n,
                        phi)
    shape = _geometry(lanes, big_n, n, phi, block, likelihood)
    args = [t.contiguous() for t in (phi, q, z, r, y, mask, lane_map,
                                     mean0, chol0, armed, rail_lo, rail_hi,
                                     quantum, scale)]
    new = dict(dtype=phi.dtype, device=phi.device)
    outs = (torch.empty((lanes, n), **new), torch.empty((lanes, n, n), **new),
            torch.empty((lanes, t_steps), **new),
            torch.empty((lanes, t_steps), **new),
            torch.empty((lanes, t_steps, big_n), **new),
            torch.empty((lanes, t_steps, big_n), dtype=torch.int8,
                        device=phi.device),
            torch.empty((lanes, t_steps, big_n), dtype=torch.int32,
                        device=phi.device))
    tol, nonconv_tol = im.solver_tols(phi.dtype)
    lib, fn = _entry("metran_sqrt_filter_robust", block, phi.dtype)
    name = "sqrt_filter_robust" + ("_block" if block else "")
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], float(nu), tol, nonconv_tol,
                 im.c_floor(phi.dtype), float(torch.finfo(phi.dtype).eps),
                 *[o.data_ptr() for o in outs], lanes, t_steps, big_n, n,
                 code, *shape, _stream(phi))
    build.check(lib, err, name)
    if lanes:
        build.count_launch(name)
    return outs


def sqrt_filter_robust_plain(phi, q, z, r, y, mask, mean0, chol0, armed,
                             rail_lo, rail_hi, quantum, scale,
                             likelihood: str = "censored", nu: float = 4.0,
                             lane_map=None):
    """The robust filter in PyTorch ops: the gated plain body
    (:func:`sqrt_filter_gated_plain`) with the robust branch on."""
    out = _check_gated(phi, q, z, r, y, mask, lane_map, mean0, chol0, armed,
                       _ROBUST, True)
    im.likelihood_code(likelihood)
    check_robust_params((rail_lo, rail_hi, quantum, scale), out[0], out[3],
                        phi)
    return sqrt_filter_gated_plain(
        phi, q, z, r, y, mask, mean0, chol0, armed, _ROBUST, 0.0, lane_map,
        RobustParams(likelihood, float(nu), rail_lo, rail_hi, quantum,
                     scale))


__all__ = [
    "GATED_POLICIES",
    "block_smem_bytes",
    "gated_sqrt_step_plain",
    "launch_shape",
    "model_bytes",
    "sign_normalize_rows",
    "smem_bytes",
    "sqrt_filter",
    "sqrt_filter_block",
    "sqrt_filter_gated",
    "sqrt_filter_gated_block",
    "sqrt_filter_gated_kernel",
    "sqrt_filter_gated_plain",
    "sqrt_filter_kernel",
    "sqrt_filter_plain",
    "sqrt_filter_robust",
    "sqrt_filter_robust_block",
    "sqrt_filter_robust_kernel",
    "sqrt_filter_robust_plain",
    "sqrt_qr_update_plain",
    "sqrt_step_plain",
    "tria",
]
