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

On CUDA tensors it launches the hand-written kernel
(``csrc/gated_filter.cu``) and raises if that cannot build or launch; on
CPU tensors it runs :func:`gated_filter_append_plain`, the JAX recursion
step by step in batched PyTorch ops — the oracle the kernel is held
against on the card.

Replaces ``metran_tpu/ops/kalman.py::_gated_sequential_update`` (with
``_make_gated_core_step``; B9b gated) and, with the gate off,
``_sequential_update`` behind ``filter_append(engine="sequential")``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
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
                       thresh: float):
    """One gated sequential update over every slot, batched over the
    leading axis (the JAX ``_gated_sequential_update``; with ``policy=
    "off"`` its ``_sequential_update``).  ``mean`` (B, S), ``cov`` (B, S,
    S), ``y_t``/``mask_t`` (B, N), ``z`` (B, N, S), ``r`` (B, N),
    ``armed`` (B,).  Returns ``(mean, cov, sigma, detf, zscore,
    verdict)``; a slot that does not trip runs the ``"off"`` arithmetic
    exactly (the selects and ``w = 1`` are identities)."""
    dtype = mean.dtype
    zero = torch.zeros((), dtype=dtype, device=mean.device)
    one = torch.ones((), dtype=dtype, device=mean.device)
    nan = torch.full((), float("nan"), dtype=dtype, device=mean.device)
    t = torch.tensor(float(thresh), dtype=dtype, device=mean.device)
    b = mean.shape[0]
    sigma = torch.zeros(b, dtype=dtype, device=mean.device)
    detf = torch.zeros_like(sigma)
    gated = policy != "off"
    zs, verdicts = [], []
    for i in range(y_t.shape[-1]):
        mask_i, z_i, r_i = mask_t[:, i], z[:, i], r[:, i]
        v = y_t[:, i] - (z_i[:, None, :] @ mean[:, :, None])[:, 0, 0]
        d = (cov @ z_i[:, :, None])[..., 0]
        f = (z_i[:, None, :] @ d[:, :, None])[:, 0, 0] + r_i
        f_safe = torch.where(mask_i, f, one)
        zscore = v / torch.sqrt(f_safe)
        score = zscore * zscore
        hit = armed & mask_i & (score > t) if gated else torch.zeros_like(
            mask_i)
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
        mean = torch.where(use[:, None], m_new, mean)
        cov = torch.where(use[:, None, None], p_new, cov)
        sigma = sigma + torch.where(use, vv * vv / f_eff, zero)
        detf = detf + torch.where(use, torch.log(f_eff), zero)
        zs.append(torch.where(mask_i, zscore, nan) if gated
                  else nan.expand_as(zscore))
        code = GATE_REJECTED if policy == "reject" else GATE_DOWNWEIGHTED
        verdicts.append(torch.where(hit, code, GATE_PASS).to(torch.int8))
    n = y_t.shape[-1]
    if not n:
        return (mean, cov, sigma, detf, y_t.new_zeros((b, 0)),
                torch.zeros((b, 0), dtype=torch.int8, device=mean.device))
    return (mean, cov, sigma, detf, torch.stack(zs, 1),
            torch.stack(verdicts, 1))


def gated_filter_append_plain(phi, q, z, r, mean, cov, y, mask, armed,
                              policy: str = "reject", thresh: float = 16.0
                              ) -> Tuple[torch.Tensor, ...]:
    """The same function in batched PyTorch ops, a Python loop over the
    ``k`` steps: :func:`~metran_tpu_torch.kernels.joint_filter.
    predict_plain`, then :func:`gated_update_plain` (a step with no
    observed slot leaves the predicted moments as they are)."""
    _check_gated(phi, q, z, r, mean, cov, y, mask, armed, policy)
    b, k, n = y.shape
    terms, zs, verdicts = [], [], []
    for t in range(k):
        mean, cov = predict_plain(mean, cov, phi, q)
        mean, cov, sigma_t, detf_t, z_t, v_t = gated_update_plain(
            mean, cov, y[:, t], mask[:, t], z, r, armed, policy, thresh)
        terms.append((sigma_t, detf_t))
        zs.append(z_t)
        verdicts.append(v_t)
    if not k:
        empty = torch.zeros((b, 0), dtype=phi.dtype, device=phi.device)
        return (mean, cov, empty, empty.clone(),
                torch.zeros((b, 0, n), dtype=phi.dtype, device=phi.device),
                torch.zeros((b, 0, n), dtype=torch.int8, device=phi.device))
    sigma, detf = (torch.stack(p, 1) for p in zip(*terms))
    return (mean, cov, sigma, detf, torch.stack(zs, 1),
            torch.stack(verdicts, 1))


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
    "smem_bytes",
]
