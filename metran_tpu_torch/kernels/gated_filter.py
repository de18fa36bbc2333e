"""K12 wrapper: batched gated sequential-processing filter append.

:func:`gated_filter_append` runs ``k`` filter steps for each of ``B``
models from a carried posterior ``N(mean, cov)``: the predict, then one
rank-1 update per observed slot in slot order, each slot's normalized
innovation ``z = v / sqrt(f)`` tested against the gate ``z^2 > thresh``
(``thresh = nsigma^2``) on armed models and the policy applied —
``"reject"`` (treat the slot as missing), ``"huber"`` (scale ``v`` by
``sqrt(thresh) / |z|``) or ``"inflate"`` (``f <- v^2 / thresh``).
``"off"`` is the plain sequential update, whose z-scores come back NaN
and verdicts PASS, as the JAX function returns them.

Contract: a slot that does not trip executes the same floating-point
operations as the ``"off"`` update, so an armed gate that never trips
gives the posterior and the likelihood terms of ``"off"`` bit for bit —
in the kernel and in the plain version alike.

:func:`robust_filter_append` is the kernel's robust (implicit-MAP)
instantiation, one per likelihood (``"censored"``, ``"quantized"``,
``"huber_t"``): an armed, observed slot that flags solves its scalar
MAP problem (:mod:`.implicit_map`, prior ``N(mu, c)`` with ``mu = y -
v``) and the same rank-1 update runs with ``d`` for the gain, ``(s_hat
- mu) / c`` for ``v`` and ``w / (1 + c w)`` for ``f``; it returns the
real z-scores, verdicts :data:`~.implicit_map.ROBUST_MAP` /
:data:`~.implicit_map.ROBUST_NONCONV` and the Newton iterations.  A
slot that does not flag runs the ``"off"`` update's operations, so with
nothing flagged the result is ``"off"``'s bit for bit.  Its launches
count as ``gated_filter_robust``.

On CUDA tensors it launches the hand-written kernel
(``csrc/gated_filter.cu``) and raises if that cannot build or launch; on
CPU tensors it runs :func:`gated_filter_append_plain`, the JAX recursion
step by step in batched PyTorch ops — the oracle the kernel is held
against on the card.

Replaces ``metran_tpu/ops/kalman.py::_gated_sequential_update`` (with
``_make_gated_core_step``; B9b gated) and, with the gate off,
``_sequential_update`` behind ``filter_append(engine="sequential")``; in
its robust modes ``metran_tpu/ops/implicit_map.py::
_robust_sequential_update`` (B12).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from . import implicit_map as im
from .implicit_map import RobustParams
from .joint_filter import MAX_SMEM, _check, predict_plain

#: the policies of the JAX package's gated kernels, in the kernel's codes
GATE_POLICIES = ("off", "reject", "huber", "inflate")
#: per-slot verdict codes
GATE_PASS = 0
GATE_DOWNWEIGHTED = 1
GATE_REJECTED = 2


def policy_code(policy: str) -> int:
    if policy not in GATE_POLICIES:
        raise ValueError(
            f"unknown gate policy {policy!r}; expected one of "
            f"{GATE_POLICIES}")
    return GATE_POLICIES.index(policy)


def smem_bytes(n_obs: int, n_state: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one block needs for an (N, S) bucket."""
    item = torch.finfo(dtype).bits // 8
    return item * (n_state * n_state + n_obs * n_state + 4 * n_state)


def _check_gated(phi, q, z, r, mean, cov, y, mask, armed, policy):
    b, k, n, s = _check(phi, q, z, r, mean, cov, y, mask)
    policy_code(policy)
    if tuple(armed.shape) != (b,) or armed.dtype != torch.bool:
        raise ValueError(
            f"armed must be a (B,) = ({b},) bool tensor, got "
            f"{tuple(armed.shape)} {armed.dtype}")
    if armed.device != phi.device:
        raise ValueError(f"armed is on {armed.device}, phi on {phi.device}")
    return b, k, n, s


def gated_filter_append(phi, q, z, r, mean, cov, y, mask, armed,
                        policy: str = "reject", thresh: float = 16.0
                        ) -> Tuple[torch.Tensor, ...]:
    """``k`` gated sequential filter steps per model.

    Shapes as :func:`~metran_tpu_torch.kernels.joint_filter.
    joint_filter_append`, plus ``armed`` (B,) bool.  Returns ``(mean
    (B, S), cov (B, S, S), sigma (B, k), detf (B, k), zscore (B, k, N),
    verdict (B, k, N) int8)``.
    """
    _check_gated(phi, q, z, r, mean, cov, y, mask, armed, policy)
    if phi.device.type == "cpu":
        return gated_filter_append_plain(phi, q, z, r, mean, cov, y, mask,
                                         armed, policy, thresh)
    return gated_filter_append_kernel(phi, q, z, r, mean, cov, y, mask,
                                      armed, policy, thresh)


def gated_filter_append_kernel(phi, q, z, r, mean, cov, y, mask, armed,
                               policy: str = "reject", thresh: float = 16.0
                               ) -> Tuple[torch.Tensor, ...]:
    """Launch K12 (CUDA tensors only; raises otherwise, and when the
    kernel cannot build, take the bucket or launch)."""
    b, k, n, s = _check_gated(phi, q, z, r, mean, cov, y, mask, armed,
                              policy)
    if phi.device.type != "cuda":
        raise ValueError(
            f"the gated filter kernel runs on CUDA tensors, got {phi.device}")
    smem = smem_bytes(n, s, phi.dtype)
    if smem > MAX_SMEM:
        raise ValueError(
            f"bucket (N={n}, S={s}) at {phi.dtype} needs {smem} bytes of "
            f"shared memory per block; the kernel takes at most {MAX_SMEM}")
    args = [t.contiguous() for t in (phi, q, z, r, mean, cov, y, mask,
                                     armed)]
    new = dict(dtype=phi.dtype, device=phi.device)
    outs = (torch.empty((b, s), **new), torch.empty((b, s, s), **new),
            torch.empty((b, k), **new), torch.empty((b, k), **new),
            torch.empty((b, k, n), **new),
            torch.empty((b, k, n), dtype=torch.int8, device=phi.device))
    lib = build.load_library("gated_filter")
    fn = (lib.metran_gated_filter_f64 if phi.dtype == torch.float64
          else lib.metran_gated_filter_f32)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = fn(*[t.data_ptr() for t in args[:9]], float(thresh),
                 *[o.data_ptr() for o in outs], b, k, n, s,
                 policy_code(policy), stream)
    build.check(lib, err, "gated_filter_append")
    if b:
        build.count_launch("gated_filter")
    return outs


def gated_update_plain(mean, cov, y_t, mask_t, z, r, armed, policy: str,
                       thresh: float, robust: Optional[RobustParams] = None):
    """One gated sequential update over every slot, batched over the
    leading axis (the JAX ``_gated_sequential_update``; with ``policy=
    "off"`` its ``_sequential_update``).  ``mean`` (B, S), ``cov`` (B, S,
    S), ``y_t``/``mask_t`` (B, N), ``z`` (B, N, S), ``r`` (B, N),
    ``armed`` (B,).  Returns ``(mean, cov, sigma, detf, zscore,
    verdict)``; a slot that does not trip runs the ``"off"`` arithmetic
    exactly (the selects and ``w = 1`` are identities).

    With ``robust`` (and ``policy="off"``) it is the JAX
    ``_robust_sequential_update``: an armed, observed slot that flags
    under the likelihood is conditioned on its scalar MAP summary
    (``m += d (s_hat - mu) / c``, ``P -= (d d') w / (1 + c w)``, ``mu =
    y - v``, ``d = P z_i``) instead, booking ``(s_hat - mu)^2 / c + 2
    nll(s_hat)`` and ``log1p(c w)``; the z-scores are real, the verdicts
    :data:`ROBUST_MAP`/:data:`ROBUST_NONCONV`, and a seventh output holds
    the Newton iterations (int32, 0 where nothing flagged).  An
    unflagged slot runs the ``"off"`` arithmetic, selected exactly."""
    dtype = mean.dtype
    zero = torch.zeros((), dtype=dtype, device=mean.device)
    one = torch.ones((), dtype=dtype, device=mean.device)
    nan = torch.full((), float("nan"), dtype=dtype, device=mean.device)
    t = torch.tensor(float(thresh), dtype=dtype, device=mean.device)
    b = mean.shape[0]
    sigma = torch.zeros(b, dtype=dtype, device=mean.device)
    detf = torch.zeros_like(sigma)
    gated = policy != "off" or robust is not None
    zs, verdicts, iters = [], [], []
    for i in range(y_t.shape[-1]):
        mask_i, z_i, r_i = mask_t[:, i], z[:, i], r[:, i]
        v = y_t[:, i] - (z_i[:, None, :] @ mean[:, :, None])[:, 0, 0]
        d = (cov @ z_i[:, :, None])[..., 0]
        c = (z_i[:, None, :] @ d[:, :, None])[:, 0, 0]
        f = c + r_i
        f_safe = torch.where(mask_i, f, one)
        zscore = v / torch.sqrt(f_safe)
        score = zscore * zscore
        hit = (armed & mask_i & (score > t) if policy != "off"
               else torch.zeros_like(mask_i))
        use = mask_i & ~hit if policy == "reject" else mask_i
        vv = v
        if policy == "huber":
            vv = torch.where(hit, torch.sqrt(t / score), one) * v
        f_eff = f_safe
        if policy == "inflate":
            f_eff = torch.where(hit, v * v / t, f_safe)
        k = d / f_eff[:, None]
        m_new = mean + k * vv[:, None]
        p_new = cov - (k[:, :, None] * k[:, None, :]) * f_eff[:, None, None]
        sig_g = torch.where(use, vv * vv / f_eff, zero)
        det_g = torch.where(use, torch.log(f_eff), zero)
        code = GATE_REJECTED if policy == "reject" else GATE_DOWNWEIGHTED
        verdict = torch.where(hit, code, GATE_PASS).to(torch.int8)
        if robust is not None:
            flagged = armed & mask_i & im.flag(
                robust.likelihood, y_t[:, i], robust.rail_lo[:, i],
                robust.rail_hi[:, i])
            it = torch.zeros(b, dtype=torch.int32, device=mean.device)
            if bool(flagged.any()):
                mu = y_t[:, i] - v  # z_i' m, as the JAX update forms it
                c_safe = torch.clamp(c, min=im.c_floor(dtype))
                s_hat, w, nll_hat, it, nonconv = im.scalar_map_solve_plain(
                    robust.likelihood, robust.nu, mu, c_safe, y_t[:, i],
                    im.slot_scale(r_i, robust.scale[:, i]),
                    robust.quantum[:, i], robust.rail_lo[:, i],
                    robust.rail_hi[:, i], flagged)
                gain = (s_hat - mu) / c_safe
                shrink = w / (one + c_safe * w)
                m_r = mean + d * gain[:, None]
                p_r = cov - (d[:, :, None] * d[:, None, :]) \
                    * shrink[:, None, None]
                dev = s_hat - mu
                sig_r = dev * dev / c_safe + 2.0 * nll_hat
                det_r = torch.log1p(c_safe * w)
                m_new = torch.where(flagged[:, None], m_r, m_new)
                p_new = torch.where(flagged[:, None, None], p_r, p_new)
                use = use | flagged
                sig_g = torch.where(flagged, sig_r, sig_g)
                det_g = torch.where(flagged, det_r, det_g)
                verdict = torch.where(
                    flagged, torch.where(nonconv, im.ROBUST_NONCONV,
                                         im.ROBUST_MAP), 0).to(torch.int8)
                it = torch.where(flagged, it, 0)
            iters.append(it)
        mean = torch.where(use[:, None], m_new, mean)
        cov = torch.where(use[:, None, None], p_new, cov)
        sigma = sigma + sig_g
        detf = detf + det_g
        zs.append(torch.where(mask_i, zscore, nan) if gated
                  else nan.expand_as(zscore))
        verdicts.append(verdict)
    n = y_t.shape[-1]
    if not n:
        out = (mean, cov, sigma, detf, y_t.new_zeros((b, 0)),
               torch.zeros((b, 0), dtype=torch.int8, device=mean.device))
        return out + ((torch.zeros((b, 0), dtype=torch.int32,
                                   device=mean.device),)
                      if robust is not None else ())
    out = (mean, cov, sigma, detf, torch.stack(zs, 1),
           torch.stack(verdicts, 1))
    return out + ((torch.stack(iters, 1),) if robust is not None else ())


def gated_filter_append_plain(phi, q, z, r, mean, cov, y, mask, armed,
                              policy: str = "reject", thresh: float = 16.0,
                              robust: Optional[RobustParams] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """The same function in batched PyTorch ops, a Python loop over the
    ``k`` steps: :func:`~metran_tpu_torch.kernels.joint_filter.
    predict_plain`, then :func:`gated_update_plain` (a step with no
    observed slot leaves the predicted moments as they are).  With
    ``robust`` it is :func:`robust_filter_append_plain`'s body."""
    _check_gated(phi, q, z, r, mean, cov, y, mask, armed, policy)
    b, k, n = y.shape
    terms, per_slot = [], []
    for t in range(k):
        mean, cov = predict_plain(mean, cov, phi, q)
        mean, cov, sigma_t, detf_t, *slots = gated_update_plain(
            mean, cov, y[:, t], mask[:, t], z, r, armed, policy, thresh,
            robust)
        terms.append((sigma_t, detf_t))
        per_slot.append(slots)
    if not k:
        empty = torch.zeros((b, 0), dtype=phi.dtype, device=phi.device)
        out = (mean, cov, empty, empty.clone(),
               torch.zeros((b, 0, n), dtype=phi.dtype, device=phi.device),
               torch.zeros((b, 0, n), dtype=torch.int8, device=phi.device))
        return out + ((torch.zeros((b, 0, n), dtype=torch.int32,
                                   device=phi.device),)
                      if robust is not None else ())
    sigma, detf = (torch.stack(p, 1) for p in zip(*terms))
    return (mean, cov, sigma, detf,
            *(torch.stack(p, 1) for p in zip(*per_slot)))


# ----------------------------------------------------------------------
# the robust (implicit-MAP) instantiations
# ----------------------------------------------------------------------
def check_robust_params(params, b: int, n: int, like: torch.Tensor):
    """``rail_lo``, ``rail_hi``, ``quantum``, ``scale`` as checked (B, N)
    tensors of ``like``'s dtype and device."""
    for name, t in zip(("rail_lo", "rail_hi", "quantum", "scale"), params):
        if tuple(t.shape) != (b, n):
            raise ValueError(f"{name} must be ({b}, {n}), got "
                             f"{tuple(t.shape)}")
        if t.dtype != like.dtype:
            raise TypeError(f"{name} is {t.dtype}, phi is {like.dtype}")
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, phi on "
                             f"{like.device}")


def robust_filter_append(phi, q, z, r, mean, cov, y, mask, armed, rail_lo,
                         rail_hi, quantum, scale, likelihood: str =
                         "censored", nu: float = 4.0
                         ) -> Tuple[torch.Tensor, ...]:
    """``k`` robust (implicit-MAP) sequential filter steps per model.

    Shapes as :func:`gated_filter_append`, plus the per-slot parameters
    ``rail_lo``, ``rail_hi``, ``quantum``, ``scale`` (B, N) in
    standardized units.  ``likelihood`` is ``"censored"``,
    ``"quantized"`` or ``"huber_t"`` (``nu`` its degrees of freedom).
    Returns ``(mean, cov, sigma, detf, zscore (B, k, N), verdict (B, k,
    N) int8, iters (B, k, N) int32)``; a slot that does not flag runs
    the ``"off"`` update's operations, so with nothing flagged the
    first four are ``"off"``'s bit for bit."""
    b, k, n, _ = _check_gated(phi, q, z, r, mean, cov, y, mask, armed,
                              "off")
    im.likelihood_code(likelihood)
    check_robust_params((rail_lo, rail_hi, quantum, scale), b, n, phi)
    fn = (robust_filter_append_plain if phi.device.type == "cpu"
          else robust_filter_append_kernel)
    return fn(phi, q, z, r, mean, cov, y, mask, armed, rail_lo, rail_hi,
              quantum, scale, likelihood, nu)


def robust_filter_append_kernel(phi, q, z, r, mean, cov, y, mask, armed,
                                rail_lo, rail_hi, quantum, scale,
                                likelihood: str = "censored",
                                nu: float = 4.0
                                ) -> Tuple[torch.Tensor, ...]:
    """Launch K12's robust instantiation (CUDA tensors only; raises
    otherwise, and when the kernel cannot build, take the bucket or
    launch)."""
    b, k, n, s = _check_gated(phi, q, z, r, mean, cov, y, mask, armed,
                              "off")
    code = im.likelihood_code(likelihood)
    check_robust_params((rail_lo, rail_hi, quantum, scale), b, n, phi)
    if phi.device.type != "cuda":
        raise ValueError(
            f"the gated filter kernel runs on CUDA tensors, got {phi.device}")
    smem = smem_bytes(n, s, phi.dtype)
    if smem > MAX_SMEM:
        raise ValueError(
            f"bucket (N={n}, S={s}) at {phi.dtype} needs {smem} bytes of "
            f"shared memory per block; the kernel takes at most {MAX_SMEM}")
    args = [t.contiguous() for t in (phi, q, z, r, mean, cov, y, mask,
                                     armed, rail_lo, rail_hi, quantum,
                                     scale)]
    new = dict(dtype=phi.dtype, device=phi.device)
    outs = (torch.empty((b, s), **new), torch.empty((b, s, s), **new),
            torch.empty((b, k), **new), torch.empty((b, k), **new),
            torch.empty((b, k, n), **new),
            torch.empty((b, k, n), dtype=torch.int8, device=phi.device),
            torch.empty((b, k, n), dtype=torch.int32, device=phi.device))
    tol, nonconv_tol = im.solver_tols(phi.dtype)
    lib = build.load_library("gated_filter")
    fn = (lib.metran_gated_filter_robust_f64 if phi.dtype == torch.float64
          else lib.metran_gated_filter_robust_f32)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = fn(*[t.data_ptr() for t in args], float(nu), tol, nonconv_tol,
                 im.c_floor(phi.dtype), *[o.data_ptr() for o in outs], b,
                 k, n, s, code, stream)
    build.check(lib, err, "robust_filter_append")
    if b:
        build.count_launch("gated_filter_robust")
    return outs


def robust_filter_append_plain(phi, q, z, r, mean, cov, y, mask, armed,
                               rail_lo, rail_hi, quantum, scale,
                               likelihood: str = "censored", nu: float = 4.0
                               ) -> Tuple[torch.Tensor, ...]:
    """The robust filter in batched PyTorch ops: the gated plain body
    (:func:`gated_filter_append_plain`) with the gate off and the
    robust branch on."""
    b, _, n, _ = _check_gated(phi, q, z, r, mean, cov, y, mask, armed,
                              "off")
    im.likelihood_code(likelihood)
    check_robust_params((rail_lo, rail_hi, quantum, scale), b, n, phi)
    return gated_filter_append_plain(
        phi, q, z, r, mean, cov, y, mask, armed, "off", 0.0,
        RobustParams(likelihood, float(nu), rail_lo, rail_hi, quantum,
                     scale))


__all__ = [
    "GATE_DOWNWEIGHTED",
    "GATE_PASS",
    "GATE_POLICIES",
    "GATE_REJECTED",
    "gated_filter_append",
    "gated_filter_append_kernel",
    "gated_filter_append_plain",
    "gated_update_plain",
    "policy_code",
    "robust_filter_append",
    "robust_filter_append_kernel",
    "robust_filter_append_plain",
    "smem_bytes",
]
