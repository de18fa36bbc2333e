"""Serving defaults, the gradient engine and the device policy of the
PyTorch port.

The serving knobs the port reads (batching, buckets, the engine, the
state arena, the reliability layer, the observation gate, robust updates
and streaming detection) and the gradient-engine knob mirror the JAX package's
``config.py`` (same names, same defaults, same ``METRAN_TPU_SERVE_*``
and ``METRAN_TPU_GRAD_ENGINE`` environment overrides), so one
deployment's settings drive either package.

Device policy: entry points run on the CUDA card unless the caller asks
for another device.  :func:`default_device` never picks the CPU
quietly — without a card it raises, and callers that want the CPU
(the tests) pass ``device="cpu"``.
"""

from __future__ import annotations

import os
from logging import getLogger

import numpy as np
import torch

logger = getLogger(__name__)

SERVE_FLUSH_DEADLINE_S = 0.005  # micro-batch coalescing window
SERVE_MAX_BATCH = 256  # a batch this full dispatches immediately
SERVE_BUCKET_MULTIPLE = 8  # shape-bucket rounding for (n_series, n_state)
SERVE_ENGINE = "joint"  # assimilation kernel: "joint", "sequential" or
#                         "sqrt" (factored posteriors, PSD by construction)
# device-resident state arena: OFF by default, the arena changes the
# durability contract (updates persist on spill, not per request) and
# the update() return type (an ack instead of a PosteriorState)
SERVE_ARENA = 0  # 1 = serve from device-resident state arenas
SERVE_ARENA_ROWS = 1024  # per-bucket arena capacity (rows preallocated)
SERVE_ARENA_MESH = 0  # devices to shard each arena across (0 = single
#                       device; -1 = every visible device)
# materialized forecast read path: OFF by default, the cache trades one
# fused horizon pass per commit for reads that dispatch nothing
SERVE_READPATH = 0  # 1 = serve forecasts from commit-time snapshots
SERVE_HORIZONS = "1-30"  # horizon set precomputed at commit time
#                          ("1-30", "1,7,30", "1-14,30" all parse)
# reliability (reliability.policy wired into MetranService)
SERVE_REQUEST_DEADLINE_S = 30.0  # hard cap on any sync service call
SERVE_RETRY_ATTEMPTS = 2  # total attempts for transient failures
SERVE_RETRY_BACKOFF_S = 0.02  # first-retry backoff (doubles per retry)
SERVE_BREAKER_FAILURES = 5  # consecutive failures that open a breaker
SERVE_BREAKER_COOLDOWN_S = 30.0  # open -> half-open probe window
SERVE_VALIDATE_UPDATES = 1  # per-slot posterior finiteness/PSD checks
# the observation gate ships OFF: arming it is a per-deployment
# calibration (nsigma trades false rejections of real level shifts
# against spike protection)
SERVE_GATE_POLICY = "off"  # "reject" | "huber" | "inflate" | "off"
SERVE_GATE_NSIGMA = 4.0  # gate at z^2 > nsigma^2 (chi-square(1) null)
SERVE_GATE_MIN_SEEN = 32  # disarm models with t_seen below this
# non-Gaussian observation robustness: the implicit-MAP update for
# censored / quantized / heavy-tailed sensors.  Ships OFF: arming it is
# a per-deployment sensor-model decision (rails and quanta describe the
# physical logger), and the robust spec is mutually exclusive with an
# enabled observation gate (the likelihood IS the outlier treatment).
SERVE_ROBUST = 0  # 1 = arm the implicit-MAP robust update path
SERVE_ROBUST_LIKELIHOOD = "censored"  # "censored" | "quantized" |
#                                       "huber_t" (| "gaussian": the
#                                       exact update, for pinning)
SERVE_ROBUST_RAIL_LO = float("-inf")  # low saturation rail, data units
SERVE_ROBUST_RAIL_HI = float("inf")  # high saturation rail, data units
SERVE_ROBUST_QUANTUM = 0.0  # quantization cell width, data units
SERVE_ROBUST_NU = 4.0  # Student-t degrees of freedom (huber_t; > 2)
SERVE_ROBUST_SCALE = 0.05  # sensor-noise scale in STANDARDIZED units
#                            (smooths the censored/quantized
#                            likelihoods; the DFM's r = 0 channel is a
#                            hard indicator without it)
SERVE_ROBUST_MIN_SEEN = 32  # disarm models below this t_seen
# streaming detection ships OFF (a per-deployment calibration of the
# false-alarm rate against detection delay)
SERVE_DETECT = 0  # 1 = arm streaming detection + alerting
SERVE_DETECT_CUSUM_K = 0.5  # CUSUM reference value (innovation sigmas)
SERVE_DETECT_CUSUM_H = 12.0  # CUSUM alarm threshold
SERVE_DETECT_LB_WINDOW = 64  # autocorrelation-drift window (> lag 1)
SERVE_DETECT_LB_THRESH = 25.0  # autocorrelation-drift alarm bar
SERVE_DETECT_NSIGMA = 5.0  # per-observation anomaly bar
SERVE_DETECT_MIN_SEEN = 64  # disarm models below this t_seen
SERVE_DETECT_ALERT_COOLDOWN_S = 60.0  # alert raise/clear hysteresis (s)
# steady-state (frozen-gain) serving ships OFF (tol = 0.0): freezing
# trades a bounded posterior deviation (within the freeze tolerance) for
# update throughput, a deployment decision
SERVE_STEADY_TOL = 0.0  # freeze when the posterior factor moves <= tol
#                         across a fully-observed append (0 disables)
SERVE_STEADY_MIN_SEEN = 256  # assimilated-steps floor before freezing
# fixed-lag smoothed products (MetranService.smoothed): window length in
# grid steps; 0 disables tracking
SERVE_FIXED_LAG = 0


def _env(name, cast, default):
    """One env-var override: ``cast(value)`` when set and parsable,
    ``default`` otherwise (unparsable values warn and fall back)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return cast(raw)
    except ValueError:
        logger.warning("ignoring unparsable %s=%r", name, raw)
        return default


def serve_defaults() -> dict:
    """Serving-layer knobs, each overridable via ``METRAN_TPU_SERVE_*``."""
    return {
        "flush_deadline_s": _env(
            "METRAN_TPU_SERVE_FLUSH_DEADLINE_S", float,
            SERVE_FLUSH_DEADLINE_S,
        ),
        "max_batch": _env(
            "METRAN_TPU_SERVE_MAX_BATCH", int, SERVE_MAX_BATCH
        ),
        "bucket_multiple": _env(
            "METRAN_TPU_SERVE_BUCKET_MULTIPLE", int, SERVE_BUCKET_MULTIPLE
        ),
        "engine": _env("METRAN_TPU_SERVE_ENGINE", str, SERVE_ENGINE),
        "arena": _env("METRAN_TPU_SERVE_ARENA", int, SERVE_ARENA),
        "arena_rows": _env(
            "METRAN_TPU_SERVE_ARENA_ROWS", int, SERVE_ARENA_ROWS
        ),
        "arena_mesh": _env(
            "METRAN_TPU_SERVE_ARENA_MESH", int, SERVE_ARENA_MESH
        ),
        "readpath": _env(
            "METRAN_TPU_SERVE_READPATH", int, SERVE_READPATH
        ),
        "horizons": _env(
            "METRAN_TPU_SERVE_HORIZONS", str, SERVE_HORIZONS
        ),
        "request_deadline_s": _env(
            "METRAN_TPU_SERVE_DEADLINE_S", float, SERVE_REQUEST_DEADLINE_S
        ),
        "retry_attempts": _env(
            "METRAN_TPU_SERVE_RETRY_ATTEMPTS", int, SERVE_RETRY_ATTEMPTS
        ),
        "retry_backoff_s": _env(
            "METRAN_TPU_SERVE_RETRY_BACKOFF_S", float, SERVE_RETRY_BACKOFF_S
        ),
        "breaker_failures": _env(
            "METRAN_TPU_SERVE_BREAKER_FAILURES", int, SERVE_BREAKER_FAILURES
        ),
        "breaker_cooldown_s": _env(
            "METRAN_TPU_SERVE_BREAKER_COOLDOWN_S", float,
            SERVE_BREAKER_COOLDOWN_S,
        ),
        "validate_updates": _env(
            "METRAN_TPU_SERVE_VALIDATE_UPDATES", int, SERVE_VALIDATE_UPDATES
        ),
        "gate_policy": _env(
            "METRAN_TPU_SERVE_GATE_POLICY", str, SERVE_GATE_POLICY
        ),
        "gate_nsigma": _env(
            "METRAN_TPU_SERVE_GATE_NSIGMA", float, SERVE_GATE_NSIGMA
        ),
        "gate_min_seen": _env(
            "METRAN_TPU_SERVE_GATE_MIN_SEEN", int, SERVE_GATE_MIN_SEEN
        ),
        "robust": _env("METRAN_TPU_SERVE_ROBUST", int, SERVE_ROBUST),
        "robust_likelihood": _env(
            "METRAN_TPU_SERVE_ROBUST_LIKELIHOOD", str,
            SERVE_ROBUST_LIKELIHOOD,
        ),
        "robust_rail_lo": _env(
            "METRAN_TPU_SERVE_ROBUST_RAIL_LO", float, SERVE_ROBUST_RAIL_LO
        ),
        "robust_rail_hi": _env(
            "METRAN_TPU_SERVE_ROBUST_RAIL_HI", float, SERVE_ROBUST_RAIL_HI
        ),
        "robust_quantum": _env(
            "METRAN_TPU_SERVE_ROBUST_QUANTUM", float, SERVE_ROBUST_QUANTUM
        ),
        "robust_nu": _env("METRAN_TPU_SERVE_ROBUST_NU", float,
                          SERVE_ROBUST_NU),
        "robust_scale": _env(
            "METRAN_TPU_SERVE_ROBUST_SCALE", float, SERVE_ROBUST_SCALE
        ),
        "robust_min_seen": _env(
            "METRAN_TPU_SERVE_ROBUST_MIN_SEEN", int, SERVE_ROBUST_MIN_SEEN
        ),
        "detect": _env("METRAN_TPU_SERVE_DETECT", int, SERVE_DETECT),
        "detect_cusum_k": _env(
            "METRAN_TPU_SERVE_DETECT_CUSUM_K", float, SERVE_DETECT_CUSUM_K
        ),
        "detect_cusum_h": _env(
            "METRAN_TPU_SERVE_DETECT_CUSUM_H", float, SERVE_DETECT_CUSUM_H
        ),
        "detect_lb_window": _env(
            "METRAN_TPU_SERVE_DETECT_LB_WINDOW", int, SERVE_DETECT_LB_WINDOW
        ),
        "detect_lb_thresh": _env(
            "METRAN_TPU_SERVE_DETECT_LB_THRESH", float,
            SERVE_DETECT_LB_THRESH,
        ),
        "detect_nsigma": _env(
            "METRAN_TPU_SERVE_DETECT_NSIGMA", float, SERVE_DETECT_NSIGMA
        ),
        "detect_min_seen": _env(
            "METRAN_TPU_SERVE_DETECT_MIN_SEEN", int, SERVE_DETECT_MIN_SEEN
        ),
        "detect_alert_cooldown_s": _env(
            "METRAN_TPU_SERVE_DETECT_ALERT_COOLDOWN_S", float,
            SERVE_DETECT_ALERT_COOLDOWN_S,
        ),
        "steady_tol": _env(
            "METRAN_TPU_SERVE_STEADY_TOL", float, SERVE_STEADY_TOL
        ),
        "steady_min_seen": _env(
            "METRAN_TPU_SERVE_STEADY_MIN_SEEN", int, SERVE_STEADY_MIN_SEEN
        ),
        "fixed_lag": _env(
            "METRAN_TPU_SERVE_FIXED_LAG", int, SERVE_FIXED_LAG
        ),
    }


# how fits differentiate the deviance (``METRAN_TPU_GRAD_ENGINE``):
# - "adjoint": the closed-form Kalman-score VJP (kernel K4 for the lane
#   layout, also behind the batch-layout sequential ``ops.deviance``);
# - "autodiff": torch autograd through the plain filter (CPU tensors
#   only in the port; the only mode with gradients w.r.t. loadings and
#   observations);
# - "auto" (default): the adjoint wherever it is defined.
GRAD_ENGINE = "auto"
GRAD_ENGINES = ("auto", "adjoint", "autodiff")


def grad_engine(value=None) -> str:
    """Validated gradient-engine mode (``METRAN_TPU_GRAD_ENGINE``).

    ``value`` overrides the environment when given.  Unknown values
    raise: a misspelt engine must not fall back to another gradient
    path (the two differ in cost, memory and differentiable inputs).
    """
    if value is None:
        value = os.environ.get("METRAN_TPU_GRAD_ENGINE") or GRAD_ENGINE
    v = str(value).strip().lower()
    if v not in GRAD_ENGINES:
        raise ValueError(
            f"unknown gradient engine {value!r} (from "
            "METRAN_TPU_GRAD_ENGINE or an explicit grad_engine "
            f"argument); expected one of {GRAD_ENGINES}"
        )
    return v


def default_device() -> torch.device:
    """The device entry points use when the caller names none: the
    CUDA card, or a ``RuntimeError`` when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device required; pass device='cpu' explicitly"
        )
    return torch.device("cuda")


def mesh_devices(device=None) -> list:
    """The devices a mesh draws from (the port's ``jax.devices()``):
    every CUDA card for a CUDA ``device`` (default: the card, raising
    without one), ``[cpu]`` for the CPU.  Each entry is repeated
    ``METRAN_TPU_VIRTUAL_DEVICES`` times (default 1), the counterpart of
    XLA's host device count: a virtual mesh whose devices are one device,
    as the JAX package tests its mesh on 8 virtual CPU devices."""
    device = default_device() if device is None else torch.device(device)
    if device.type == "cuda":
        found = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        found = [torch.device(device.type)]
    virtual = _env("METRAN_TPU_VIRTUAL_DEVICES", int, 1)
    if virtual < 1:
        raise ValueError(
            f"METRAN_TPU_VIRTUAL_DEVICES must be >= 1, got {virtual}")
    return [d for d in found for _ in range(virtual)]


def default_dtype(device) -> torch.dtype:
    """The working precision of the single-model API on ``device`` (the
    JAX package's rule): float64 on the CPU (reference parity), float32
    on the card unless ``METRAN_TPU_X64`` is set (``1``/``true``/
    ``yes``), the JAX package's own switch to float64."""
    if torch.device(device).type == "cpu":
        return torch.float64
    x64 = os.environ.get("METRAN_TPU_X64", "").lower() in ("1", "true", "yes")
    return torch.float64 if x64 else torch.float32


def resolve_device(device=None, like=None) -> torch.device:
    """``device`` when given; else the device of the tensor ``like``;
    else :func:`default_device`."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return default_device()


def float_dtype(*values, dtype=None) -> torch.dtype:
    """The working precision: ``dtype`` (a torch dtype) when given,
    float32 when every floating input is float32, float64 otherwise (the
    JAX package's result-type rule with x64 enabled)."""
    if dtype is not None:
        return dtype
    kinds = []
    for v in values:
        dt = getattr(v, "dtype", None)
        if dt is None:
            continue
        name = str(dt).replace("torch.", "")
        if name in ("float32", "float64"):
            kinds.append(name)
    if kinds and all(k == "float32" for k in kinds):
        return torch.float32
    return torch.float64


def as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``x`` (tensor, numpy array or scalar) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = np.array(x)  # torch cannot wrap a read-only buffer
    return torch.as_tensor(x, dtype=dtype, device=device)
