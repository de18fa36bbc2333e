"""Serving kernels: batched incremental update and forecast per bucket.

Port of the dict-registry half of ``metran_tpu/serve/engine.py``.  The
models of one shape bucket are padded to the bucket's ``(N, S)`` and
stacked along a leading batch axis, and the per-model computation —
:func:`~metran_tpu_torch.ops.filter_append` (K1 on the joint engine,
K12 with the gate off on the sequential one) or, on the square-root
engine, :func:`~metran_tpu_torch.ops.sqrt_filter_append` (K9 from the
stacked factors) for assimilation,
:func:`~metran_tpu_torch.ops.forecast_observation_moments` (K2) for
forecasts — runs as ONE kernel-wrapper call per dispatch.  An armed
observation gate (:class:`GateSpec`) runs the gated update instead (K12,
or K9's gated instantiation on the square-root engine), an armed robust
policy (:class:`RobustSpec`) the implicit-MAP update (K12's or K9's
robust instantiation), and streaming detection (:class:`DetectSpec`)
adds one detector launch (K13) after it.  Frozen models
(:class:`SteadySpec`) run the frozen-gain mean-only update instead
(:func:`make_steady_update_fn`: K14, and K13 after it with detection).

Padding semantics (as in the JAX package): a padded observation slot is
masked False at every appended step and carries zero loadings, so it
never touches the gain, the likelihood terms or the real slots; a
padded state slot starts at the filter's ``N(0, 1)`` init with zero
cross-covariance and stays decoupled.

The arena half (:func:`make_arena_update_fn`,
:func:`make_arena_steady_update_fn`, :func:`make_arena_forecast_fn`)
serves a :class:`~metran_tpu_torch.serve.state.StateArena`'s resident
leaves in place: one launch of K16 (the exact update fused with the
integrity gate, the detection tail and the masked scatter), K17 (the
frozen-gain update) or K18 (the forecast) per dispatch, through
:mod:`metran_tpu_torch.kernels.arena` (its plain versions on CPU
leaves).

With a ``horizons`` set (the materialized read path,
:mod:`metran_tpu_torch.serve.readpath`) every update function also
returns the commit-time forecast pass of the committed posteriors,
standardized (B, H, N) means and variances in the JAX functions' output
order: the ``horizons`` modes of K16 (exact arena), K17 and K14 (frozen
rows: means only, the variances are cached at freeze), and on the dict
path's exact update one K2 launch on the committed moments, on the same
stream (:func:`_horizon_pass`).  The parallel-in-time engine comes in a
later slice; asking for it raises with the ROADMAP item.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device, serve_defaults
from ..kernels.arena import (
    NEVER_ARMED,
    ArenaRobust,
    arena_forecast,
    arena_steady_update,
    arena_update,
)
from ..kernels.forecast import horizon_set
from ..kernels.steady_filter import steady_filter
from ..ops import (
    GATE_POLICIES,
    detect_append,
    detect_stats,
    dfm_statespace,
    filter_append,
    forecast_horizons,
    forecast_observation_moments,
    gated_filter_append,
    gated_sqrt_filter_append,
    implicit_map_filter_append,
    implicit_map_sqrt_filter_append,
    sqrt_filter_append,
)
from ..ops.implicit_map import ROBUST_LIKELIHOODS
from ..ops.statespace import StateSpace

#: the registry engines with a serving update; "sqrt_parallel" updates
#: exactly as "sqrt" (the JAX package's square-root engines), and
#: "parallel" has none there either
SERVE_ENGINES = ("joint", "sequential", "sqrt", "sqrt_parallel")
SQRT_ENGINES = ("sqrt", "sqrt_parallel")


class GateSpec(NamedTuple):
    """Observation-gate policy for the serving update path.

    ``policy`` is one of :data:`metran_tpu_torch.ops.GATE_POLICIES`
    (``"off"``/``"reject"``/``"huber"``/``"inflate"``): what happens to
    an observed slot whose squared normalized innovation exceeds
    ``nsigma**2`` (chi-square(1) under the model).  ``min_seen`` disarms
    the gate for models with fewer assimilated grid steps (a cold
    filter's innovations are over-dispersed); it is evaluated per model
    per dispatch, the kernel's ``armed`` flag.

    Defaults come from :func:`metran_tpu_torch.config.serve_defaults`
    (``METRAN_TPU_SERVE_GATE_{POLICY,NSIGMA,MIN_SEEN}``); the shipped
    default is ``policy="off"`` — gating is opt-in.
    """

    policy: str = "off"
    nsigma: float = 4.0
    min_seen: int = 32

    @property
    def enabled(self) -> bool:
        return self.policy != "off"

    @classmethod
    def from_defaults(cls) -> "GateSpec":
        d = serve_defaults()
        spec = cls(
            policy=str(d["gate_policy"]),
            nsigma=float(d["gate_nsigma"]),
            min_seen=int(d["gate_min_seen"]),
        )
        spec.validate()
        return spec

    def validate(self) -> "GateSpec":
        if self.policy not in GATE_POLICIES:
            raise ValueError(
                f"unknown gate policy {self.policy!r}; expected one of "
                f"{GATE_POLICIES}"
            )
        if self.enabled and not self.nsigma > 0:
            raise ValueError(
                f"gate nsigma must be > 0, got {self.nsigma!r}"
            )
        return self


class SteadySpec(NamedTuple):
    """Steady-state gain-freeze policy for the serving update path.

    Once a model's covariance recursion has converged — successive
    posterior factors move by at most ``tol`` across a fully-observed
    append, with at least ``min_seen`` grid steps assimilated — the
    service **freezes** its Kalman gain (:func:`metran_tpu_torch.ops.
    steady_gains`: the DARE solve, K15) and serves its updates through
    the O(S N) mean-only steady update (K14) instead of the full
    covariance propagation.  Any step that breaks time-invariance
    (missing/NaN-masked slots, an observation gate firing under
    ``reject``/``inflate``, a registry ``put`` replacing the posterior,
    an armed robust likelihood) **thaws** the model back to the exact
    update, so results stay within a bounded deviation of the exact
    filter.

    ``tol`` is the freeze threshold on the max-abs posterior-factor
    delta in standardized units (0.0 disables the whole path — the
    shipped default); ``min_seen`` the assimilated-steps floor.
    Defaults from :func:`metran_tpu_torch.config.serve_defaults`
    (``METRAN_TPU_SERVE_STEADY_{TOL,MIN_SEEN}``).
    """

    tol: float = 0.0
    min_seen: int = 256

    @property
    def enabled(self) -> bool:
        return self.tol > 0.0

    @classmethod
    def from_defaults(cls) -> "SteadySpec":
        d = serve_defaults()
        return cls(
            tol=float(d["steady_tol"]),
            min_seen=int(d["steady_min_seen"]),
        ).validate()

    def validate(self) -> "SteadySpec":
        if self.tol < 0.0:
            raise ValueError(
                f"steady tol must be >= 0 (0 disables), got {self.tol!r}"
            )
        return self


class DetectSpec(NamedTuple):
    """Streaming-detection policy for the serving update path.

    Armed (``enabled=True``), every update dispatch also advances the
    :mod:`metran_tpu_torch.ops.detect` recursions over the update's
    normalized innovations — per-slot **anomaly** flags (``z^2 >
    nsigma^2``), two-sided **CUSUM** changepoint accumulators
    (``cusum_k``/``cusum_h``) and the exponentially-windowed
    **autocorrelation-drift** statistic (``lb_window``/``lb_thresh``) —
    one detector launch (K13) after the update kernel.  The service
    books the outcomes, raises alerts with ``alert_cooldown_s``
    raise/clear hysteresis, and feeds changepoints to the health
    monitor's refit candidates.  ``min_seen`` disarms detection for cold
    models like the gate's floor.  With detection enabled an ungated
    registry serves through the gated update with the gate permanently
    disarmed: real z-scores, posteriors bit-identical to the plain
    update on the sequential and square-root engines (a joint registry
    moves to the sequential update, as in the JAX package).

    Defaults from :func:`metran_tpu_torch.config.serve_defaults`
    (``METRAN_TPU_SERVE_DETECT{,_CUSUM_K,_CUSUM_H,_LB_WINDOW,
    _LB_THRESH,_NSIGMA,_MIN_SEEN,_ALERT_COOLDOWN_S}``); shipped off.
    """

    enabled: bool = False
    cusum_k: float = 0.5
    cusum_h: float = 12.0
    lb_window: int = 64
    lb_thresh: float = 25.0
    nsigma: float = 5.0
    min_seen: int = 64
    alert_cooldown_s: float = 60.0

    @classmethod
    def from_defaults(cls) -> "DetectSpec":
        d = serve_defaults()
        return cls(
            enabled=bool(d["detect"]),
            cusum_k=float(d["detect_cusum_k"]),
            cusum_h=float(d["detect_cusum_h"]),
            lb_window=int(d["detect_lb_window"]),
            lb_thresh=float(d["detect_lb_thresh"]),
            nsigma=float(d["detect_nsigma"]),
            min_seen=int(d["detect_min_seen"]),
            alert_cooldown_s=float(d["detect_alert_cooldown_s"]),
        ).validate()

    def validate(self) -> "DetectSpec":
        """Reject inert or broken combinations — an armed detector
        that could never alarm (or that would alarm on everything) is
        paid for and silently useless."""
        if not self.enabled:
            return self
        if self.min_seen < 0:
            raise ValueError(
                f"detect min_seen must be >= 0, got {self.min_seen}"
            )
        if self.lb_window <= 1:
            raise ValueError(
                "detect lb_window must exceed the autocorrelation "
                f"lag (1), got {self.lb_window}"
            )
        if self.alert_cooldown_s < 0.0:
            raise ValueError(
                "detect alert_cooldown_s must be >= 0, got "
                f"{self.alert_cooldown_s}"
            )
        if self.cusum_k < 0.0 or not self.cusum_h > 0.0:
            raise ValueError(
                "detect cusum_k must be >= 0 and cusum_h > 0, got "
                f"k={self.cusum_k} h={self.cusum_h}"
            )
        if not self.lb_thresh > 0.0 or not self.nsigma > 0.0:
            raise ValueError(
                "detect lb_thresh and nsigma must be > 0, got "
                f"lb_thresh={self.lb_thresh} nsigma={self.nsigma}"
            )
        return self

    @property
    def kernel_params(self) -> dict:
        """The threshold half, as :func:`metran_tpu_torch.ops.
        detect_append` keyword arguments."""
        return dict(
            cusum_k=float(self.cusum_k), cusum_h=float(self.cusum_h),
            lb_window=int(self.lb_window),
            lb_thresh=float(self.lb_thresh), nsigma=float(self.nsigma),
        )


class RobustSpec(NamedTuple):
    """Non-Gaussian observation policy for the serving update path.

    Armed (``likelihood != "off"``), each update's observed slots are
    conditioned through the **implicit-MAP** update
    (:mod:`metran_tpu_torch.ops.implicit_map`): flagged slots solve the
    per-step MAP problem under the configured likelihood and commit its
    Laplace summary, while clean Gaussian slots fall back
    **bit-identically** to the closed-form update.

    - ``likelihood="censored"``: readings at/beyond ``rail_lo``/
      ``rail_hi`` (data units — standardized per model at dispatch)
      contribute the one-sided Tobit tail mass; un-railed readings stay
      exact Gaussian.
    - ``likelihood="quantized"``: every reading contributes the interval
      likelihood over its ``quantum``-wide cell (data units).
    - ``likelihood="huber_t"``: every reading is scored under the
      heavy-tailed Student-t(``nu``) loss — bounded outlier influence
      without the gate's hard reject.

    ``scale`` is the sensor-noise scale in **standardized** units
    (fraction of the series' fitted std) that smooths the censored /
    quantized likelihoods and scales the Student-t residuals — the DFM's
    exact ``r = 0`` observation channel would otherwise make them hard
    indicators.  ``min_seen`` disarms the robust path for cold models
    exactly like the gate's floor (per model, per dispatch).  Mutually
    exclusive with an enabled :class:`GateSpec`: the robust likelihood
    IS the outlier treatment (``huber_t`` subsumes the gate's ``huber``
    policy), and one slot cannot serve two masters.  Any armed robust
    slot is a time-invariance break (``time_varying``), the contract the
    steady-state layer will read.

    Defaults from :func:`metran_tpu_torch.config.serve_defaults`
    (``METRAN_TPU_SERVE_ROBUST{,_LIKELIHOOD,_RAIL_LO,_RAIL_HI,_QUANTUM,
    _NU,_SCALE,_MIN_SEEN}``); shipped off.
    """

    likelihood: str = "off"
    rail_lo: float = float("-inf")
    rail_hi: float = float("inf")
    quantum: float = 0.0
    nu: float = 4.0
    scale: float = 0.05
    min_seen: int = 32

    @property
    def enabled(self) -> bool:
        return self.likelihood != "off"

    @property
    def time_varying(self) -> bool:
        """Whether an armed model breaks time-invariance: every real
        likelihood can flag a slot and change the gain, but
        ``"gaussian"`` — the pinning configuration — never flags."""
        return self.enabled and self.likelihood != "gaussian"

    @property
    def flags_selectively(self) -> bool:
        """Whether flagged slots are the EXCEPTION (censored: railed
        readings only).  The always-flagging likelihoods (quantized,
        huber_t) book counters but log no per-update ``robust_update``
        line — one per model per commit carries no information."""
        return self.likelihood == "censored"

    @classmethod
    def from_defaults(cls) -> "RobustSpec":
        d = serve_defaults()
        return cls(
            likelihood=str(d["robust_likelihood"])
            if d["robust"] else "off",
            rail_lo=float(d["robust_rail_lo"]),
            rail_hi=float(d["robust_rail_hi"]),
            quantum=float(d["robust_quantum"]),
            nu=float(d["robust_nu"]),
            scale=float(d["robust_scale"]),
            min_seen=int(d["robust_min_seen"]),
        ).validate()

    def validate(self) -> "RobustSpec":
        """Reject inert or broken combinations — an armed robust path
        that could never flag a slot (or that would blow up the inner
        solve) is paid for and silently useless."""
        if not self.enabled:
            return self
        if self.likelihood not in ROBUST_LIKELIHOODS:
            raise ValueError(
                f"unknown robust likelihood {self.likelihood!r}; "
                f"expected one of {('off',) + ROBUST_LIKELIHOODS}"
            )
        if self.min_seen < 0:
            raise ValueError(
                f"robust min_seen must be >= 0, got {self.min_seen}"
            )
        if not self.scale > 0.0:
            raise ValueError(
                "robust scale must be > 0 (it smooths the censored/"
                f"quantized likelihoods), got {self.scale!r}"
            )
        if self.likelihood == "censored":
            if not self.rail_lo < self.rail_hi:
                raise ValueError(
                    "censored rails are inverted: rail_lo "
                    f"{self.rail_lo!r} must be < rail_hi "
                    f"{self.rail_hi!r}"
                )
            if not (np.isfinite(self.rail_lo)
                    or np.isfinite(self.rail_hi)):
                raise ValueError(
                    "censored likelihood needs at least one finite "
                    "rail; both are infinite — no reading could ever "
                    "flag"
                )
        if self.likelihood == "quantized" and not self.quantum > 0.0:
            raise ValueError(
                "quantized likelihood needs quantum > 0 (the cell "
                f"width), got {self.quantum!r}"
            )
        if self.likelihood == "huber_t" and not self.nu > 2.0:
            raise ValueError(
                "huber_t needs nu > 2 (finite observation variance), "
                f"got {self.nu!r}"
            )
        return self

    def compile_key(self) -> tuple:
        """Every field that selects the update's behaviour (the JAX
        package's compile-key suffix; the port keys nothing on it yet)."""
        return (
            "rob", self.likelihood, float(self.rail_lo),
            float(self.rail_hi), float(self.quantum), float(self.nu),
            float(self.scale),
        )


class BucketBatch(NamedTuple):
    """A shape bucket's models stacked for one device dispatch; every
    leaf leads with the batch axis B.  ``chol`` is the stacked
    covariance factors when the bucket serves the square-root engine
    (``stack_bucket(..., sqrt=True)``; ``cov`` is then None)."""

    ss: StateSpace
    mean: torch.Tensor  # (B, S)
    cov: "torch.Tensor | None"  # (B, S, S)
    chol: "torch.Tensor | None" = None  # (B, S, S)


def posterior_fault(mean, cov, sym_rtol: float = 1e-4, psd_tol: float = 1e-4,
                    chol=None) -> "str | None":
    """Why a filtered posterior is numerically unserviceable, or ``None``.

    The per-slot integrity gate (host-side numpy, as in the JAX
    package): finite mean and covariance, a covariance symmetric to
    ``sym_rtol`` of its magnitude, and no eigenvalue below ``-psd_tol``
    of its magnitude.  With ``chol`` (a factor, ``cov = chol chol'``)
    the checks collapse to finiteness.  The tolerances catch blowups,
    not the few-ULP drift of a long covariance recursion.
    """
    mean = np.asarray(mean)
    if not np.all(np.isfinite(mean)):
        return "non-finite posterior mean"
    if chol is not None:
        if not np.all(np.isfinite(np.asarray(chol))):
            return "non-finite posterior covariance factor"
        if not np.all(np.isfinite(np.asarray(cov))):
            return "non-finite posterior covariance"
        return None
    cov = np.asarray(cov)
    if not np.all(np.isfinite(cov)):
        return "non-finite posterior covariance"
    scale = max(1.0, float(np.abs(cov).max()))
    asym = float(np.abs(cov - cov.T).max())
    if asym > sym_rtol * scale:
        return f"asymmetric posterior covariance (|C - C^T| = {asym:.3e})"
    w_min = float(np.linalg.eigvalsh((cov + cov.T) * 0.5).min())
    if w_min < -psd_tol * scale:
        return f"non-PSD posterior covariance (min eigenvalue {w_min:.3e})"
    return None


def state_slot_index(n_series: int, n_factors: int,
                     n_obs_pad: int) -> np.ndarray:
    """Indices of a model's true state slots inside the padded layout
    ``[sdf_0..sdf_{N-1}, cdf_0..]`` with N = ``n_obs_pad``."""
    return np.concatenate(
        [np.arange(n_series), n_obs_pad + np.arange(n_factors)]
    )


def psd_factor(cov: np.ndarray) -> np.ndarray:
    """A (host-side) factor ``F`` with ``F F' = cov`` for a PSD matrix:
    the migration shim for covariance-form states entering the
    square-root serving path.  ``np.linalg.cholesky`` would refuse the
    structurally singular filtered covariances of the DFM (``r = 0``),
    so the factor comes from an eigendecomposition with negative
    roundoff eigenvalues clipped at zero; the square-root update
    re-triangularizes it on the first step."""
    cov = np.asarray(cov)
    w, v = np.linalg.eigh((cov + cov.T) * 0.5)
    return (v * np.sqrt(np.clip(w, 0.0, None))).astype(cov.dtype)


def pad_state_arrays(state, bucket: Tuple[int, int], dtype=None,
                     sqrt: bool = False, factors: bool = True):
    """Pad one state's arrays into bucket shape ``(N, S)``:
    ``(alpha_sdf (N,), alpha_cdf (S-N,), loadings (N, S-N), mean (S,),
    cov (S, S) | None, chol (S, S) | None)``, exactly one of ``cov``/
    ``chol`` filled.  Padded alphas are 1.0, padded loadings zero,
    padded mean/cov slots the ``N(0, I)`` init.  ``sqrt=True`` pads a
    covariance factor instead: the state's own ``chol`` scattered into
    an identity (the true slots decouple exactly from the padding) when
    it has one, else :func:`psd_factor` of its ``cov``.  ``factors=False``
    leaves both ``None``."""
    n_pad, s_pad = bucket
    n, k = state.n_series, state.n_factors
    if n > n_pad or k > s_pad - n_pad:
        raise ValueError(
            f"model {state.model_id!r} shape ({n}, {n + k}) does not fit "
            f"bucket {bucket} (padded layout [sdf*{n_pad} | "
            f"cdf*{s_pad - n_pad}])"
        )
    if dtype is None:
        dtype = state.dtype
    k_pad = s_pad - n_pad
    alpha = np.ones(s_pad, dtype)
    alpha[:n] = state.params[:n]
    alpha[n_pad:n_pad + k] = state.params[n:]
    loadings = np.zeros((n_pad, k_pad), dtype)
    loadings[:n, :k] = state.loadings
    idx = state_slot_index(n, k, n_pad)
    mean = np.zeros(s_pad, dtype)
    mean[idx] = state.mean
    cov = chol = None
    if factors and sqrt:
        factor = (state.chol if getattr(state, "chol", None) is not None
                  else psd_factor(state.cov))
        chol = np.eye(s_pad, dtype=dtype)
        chol[np.ix_(idx, idx)] = factor
    elif factors:
        cov = np.eye(s_pad, dtype=dtype)
        cov[np.ix_(idx, idx)] = state.cov
    return alpha[:n_pad], alpha[n_pad:], loadings, mean, cov, chol


def stack_bucket(states: List, bucket: Tuple[int, int], dtype=None,
                 device=None, sqrt: bool = False,
                 factors: bool = True) -> BucketBatch:
    """Stack same-bucket models into one :class:`BucketBatch` on
    ``device`` (default: the CUDA card).  The host stacks the small
    parameter arrays; the state-space build runs batched on the device.
    ``sqrt=True`` stacks covariance factors instead of covariances (see
    :func:`pad_state_arrays`), for the square-root update;
    ``factors=False`` stacks neither (the steady update reads only the
    state space and the means).
    """
    device = resolve_device(device)
    if dtype is None:
        dtype = states[0].dtype
    padded = [pad_state_arrays(st, bucket, dtype, sqrt=sqrt,
                               factors=factors) for st in states]
    a_sdf, a_cdf, lds, means = (
        torch.from_numpy(np.stack(part)).to(device)
        for part in list(zip(*padded))[:4]
    )
    dts = torch.from_numpy(
        np.array([st.dt for st in states], dtype)
    ).to(device)
    ss = dfm_statespace(a_sdf, a_cdf, lds, dts, device=device)
    if not factors:
        return BucketBatch(ss=ss, mean=means, cov=None)
    fac = torch.from_numpy(
        np.stack([p[5] if sqrt else p[4] for p in padded])).to(device)
    if sqrt:
        return BucketBatch(ss=ss, mean=means, cov=None, chol=fac)
    return BucketBatch(ss=ss, mean=means, cov=fac)


def _robust_core(sqrt_engine: bool, robust: RobustSpec):
    """The robust update of a bucket: ``core(ss, mean, fac, y, mask,
    armed, rail_lo, rail_hi, quantum, scale) -> (mean', fac', sigma,
    detf, zscore, verdict, iters)``, batch-leading — one launch of K9's
    robust instantiation on the square-root engine, of K12's on the
    covariance engines.  ``likelihood="gaussian"`` (the pinning
    configuration) is the gated update with the gate permanently
    disarmed: posteriors bit-identical to the plain update, real
    z-scores, zero verdicts and iterations, as in the JAX package."""
    lik, nu = robust.likelihood, float(robust.nu)
    if lik == "gaussian":
        gated_append = (gated_sqrt_filter_append if sqrt_engine
                        else gated_filter_append)

        def fallback_core(ss, mean, fac, y, mask, armed, rl, rh, q, sc):
            out = gated_append(ss, mean, fac, y, mask, armed=False,
                               policy="reject", nsigma=4.0)
            return tuple(out) + (torch.zeros(y.shape, dtype=torch.int32,
                                             device=y.device),)

        return fallback_core
    append = (implicit_map_sqrt_filter_append if sqrt_engine
              else implicit_map_filter_append)

    def core(ss, mean, fac, y, mask, armed, rl, rh, q, sc):
        return append(ss, mean, fac, y, mask, armed=armed, rail_lo=rl,
                      rail_hi=rh, quantum=q, scale=sc, likelihood=lik,
                      nu=nu)

    return core


def _horizon_pass(ss, mean_t, fac_t, horizons, sqrt_engine: bool):
    """The fused commit-time forecast pass of the dict path's exact
    update: :func:`~metran_tpu_torch.ops.forecast_horizons` of the
    just-committed posteriors, batched — (B, H, N) standardized means and
    variances.  One K2 launch on CUDA tensors, on the update's stream
    with no host sync between (a factor bucket forms ``fac fac'`` by
    ``torch.matmul`` first, as the JAX function's own matmul); the plain
    version on CPU tensors.  The means-only pass of frozen rows (JAX's
    ``_steady_horizon_means``) is K14's and K17's horizons mode, whose
    plain version is :func:`~metran_tpu_torch.kernels.forecast.
    forecast_means_plain`."""
    hz = horizon_set(horizons, mean_t)
    return forecast_horizons(ss, mean_t, fac_t, hz, sqrt=sqrt_engine)


def make_update_fn(engine: str = "joint", gate: Optional[GateSpec] = None,
                   horizons=None, detect: Optional[DetectSpec] = None,
                   robust: Optional[RobustSpec] = None):
    """The batched incremental-update function of a bucket.

    ``fn(ss, mean, fac, y_new, mask_new) -> (mean_T, fac_T, sigma,
    detf)`` with every argument batch-leading (``y_new``/``mask_new``
    (B, k, N)): on ``engine="joint"`` ``fac`` is the covariance and the
    call one K1 launch; on ``engine="sequential"`` one K12 launch with
    the gate off; on ``engine="sqrt"`` it is a covariance factor,
    carried by :func:`~metran_tpu_torch.ops.sqrt_filter_append` (one K9
    launch from the given carry), and the returned factor is
    lower-triangular, PSD by construction.

    With an **enabled** ``gate`` the function takes one more
    batch-leading argument ``armed`` ((B,) bool, the host's per-model
    ``t_seen >= min_seen``) and returns the per-slot z-scores and int8
    verdicts ((B, k, N) each) after the four: square-root buckets run
    :func:`~metran_tpu_torch.ops.gated_sqrt_filter_append` (K9 gated),
    covariance buckets :func:`~metran_tpu_torch.ops.gated_filter_append`
    (K12) — a joint registry arming the gate serves through the gated
    *sequential* update, as in the JAX package.

    With an **enabled** ``robust`` (:class:`RobustSpec`, mutually
    exclusive with an enabled gate) the function takes ``armed`` and
    the four (B, N) per-slot parameters ``rail_lo, rail_hi, quantum,
    scale`` (standardized per model from the physical spec) and returns
    ``(zscore, verdict, iters)`` after the four: one launch of K9's
    robust instantiation on square-root buckets
    (:func:`~metran_tpu_torch.ops.implicit_map_sqrt_filter_append`), of
    K12's on covariance buckets
    (:func:`~metran_tpu_torch.ops.implicit_map_filter_append`; a joint
    registry serves through the sequential update, as in the JAX
    package).  Clean Gaussian slots are bit-identical to the plain
    update.

    With an **enabled** ``detect`` it takes two more trailing arguments,
    ``det_state`` ((B, 6, N)) and ``det_armed`` ((B,) bool), runs the
    detector (K13) over the update's z-scores and appends ``(det_state',
    det_counts, det_stats)`` ((B, 6, N), (B, 3, N) int32, (B, 3, N)).
    An ungated registry arming detection serves through the gated
    update with the gate disarmed (real z-scores; the service then
    books no gate verdicts).

    With a non-empty ``horizons`` set (the read path) it appends ``(fm,
    fv)``, the (B, H, N) standardized forecast moments of the NEW
    posteriors at those horizons (:func:`_horizon_pass`: one K2 launch
    after the update), after every other output and before the
    detector's, as the JAX function orders them.
    """
    if engine not in SERVE_ENGINES:
        raise ValueError(f"unknown serve engine {engine!r}")
    sqrt_engine = engine in SQRT_ENGINES
    gated = gate is not None and gate.enabled
    det_on = detect is not None and detect.enabled
    robust_on = robust is not None and robust.enabled
    if robust_on and gated:
        raise ValueError(
            "gate and robust are mutually exclusive on one update "
            "kernel (the robust likelihood IS the outlier treatment); "
            "arm one of them"
        )
    hz = tuple(int(h) for h in horizons) if horizons else ()
    gated_append = (gated_sqrt_filter_append if sqrt_engine
                    else gated_filter_append)
    if robust_on:
        core = _robust_core(sqrt_engine, robust.validate())
    elif gated:
        gate.validate()
        policy, nsigma = gate.policy, float(gate.nsigma)

        def core(ss, mean, fac, y_new, mask_new, armed):
            return gated_append(ss, mean, fac, y_new, mask_new, armed=armed,
                                policy=policy, nsigma=nsigma)
    elif det_on:
        # detection needs z-scores: the gated update with the gate
        # permanently disarmed (a slot that cannot trip computes the
        # ungated update's operations exactly)
        def core(ss, mean, fac, y_new, mask_new):
            return gated_append(ss, mean, fac, y_new, mask_new, armed=False,
                                policy="reject", nsigma=4.0)
    elif sqrt_engine:
        def core(ss, mean, chol, y_new, mask_new):
            return sqrt_filter_append(ss, mean, chol, y_new, mask_new)
    else:
        def core(ss, mean, cov, y_new, mask_new):
            return filter_append(ss, mean, cov, y_new, mask_new,
                                 engine=engine)

    if not det_on:
        if not hz:
            return core

        def with_horizons(ss, mean, fac, y_new, mask_new, *extra):
            out = tuple(core(ss, mean, fac, y_new, mask_new, *extra))
            return out + tuple(_horizon_pass(ss, out[0], out[1], hz,
                                             sqrt_engine))

        return with_horizons
    detect.validate()
    dpar = detect.kernel_params

    def fused(ss, mean, fac, y_new, mask_new, *extra):
        *update_extra, det_state, det_armed = extra
        out = core(ss, mean, fac, y_new, mask_new, *update_extra)
        # gated and robust updates keep their per-slot outputs (robust:
        # with the iterations); the detect-only path strips them
        res = tuple(out) if (gated or robust_on) else tuple(out[:4])
        if hz:
            res += tuple(_horizon_pass(ss, out[0], out[1], hz, sqrt_engine))
        det_new, det_counts = detect_append(det_state, out[4], mask_new,
                                            det_armed, **dpar)
        return res + (det_new, det_counts, detect_stats(det_new))

    return fused


def make_forecast_fn(steps: int):
    """The batched forecast function of a bucket: ``fn(ss, mean, cov)
    -> (means, variances)`` of shape (B, steps, N), standardized units
    — one K2 launch on CUDA tensors."""
    steps = int(steps)

    def fn(ss, mean, cov):
        horizons = torch.arange(
            1, steps + 1, device=mean.device
        ).to(mean.dtype)
        return forecast_observation_moments(ss, mean, cov, horizons)

    return fn


def make_steady_update_fn(gate: Optional[GateSpec] = None,
                          horizons=None, sequential_gate: bool = False,
                          detect: Optional[DetectSpec] = None):
    """The batched **steady** (frozen-gain) update function of a bucket.

    ``fn(ss, mean, kgain, fdiag, real, y_new, mask_new[, armed]) ->
    (mean_T, sigma, detf, broke[, zscore, verdict])``, every argument
    batch-leading: one K14 launch of
    :func:`~metran_tpu_torch.ops.steady_filter_append`'s kernel — a
    mean-only recursion through the frozen gain, no covariance in or out.
    Engine-agnostic (the frozen gain IS the engine).  ``broke`` is the
    per-row thaw verdict: a True row's result must be discarded and its
    rows replayed through the exact update.  ``real`` is the (B, N)
    true-observation-slot mask from the host-side series counts.
    ``sequential_gate`` must match the exact update the rows thaw back
    to (True on gated covariance-engine registries, whose frozen leaves
    carry the per-slot sequential gains and conditional variances).
    With an enabled ``gate`` the function takes ``armed`` and returns
    the z-scores and verdicts.

    With an enabled ``detect`` the signature becomes ``fn(ss, mean,
    kgain, fdiag, real, y_new, mask_new, armed, det_state, det_armed)``
    (``armed`` always present — zeros when the gate is off) and
    ``(det_state', det_counts, det_stats)`` ride as the last outputs,
    one K13 launch after K14 armed with ``det_armed & ~broke``: a broken
    row's detector state carries unchanged (its rows replay through the
    exact update, which accumulates them exactly once).

    With a non-empty ``horizons`` set the update is K14's ``horizons``
    mode and appends ``fm``, the (B, H, N) standardized means of the
    commit-time forecast pass (JAX's ``_steady_horizon_means``, in the
    same launch), after the gate's outputs and before the detector's; the
    variance half is the constant the service cached at freeze.
    """
    hz = tuple(int(h) for h in horizons) if horizons else ()
    gated = gate is not None and gate.enabled
    det_on = detect is not None and detect.enabled
    if gated:
        gate.validate()
        policy, nsigma = gate.policy, float(gate.nsigma)
    else:
        policy, nsigma = "off", 4.0
    seq = bool(sequential_gate) and gated

    def core(ss, mean, kgain, fdiag, real, y_new, mask_new, armed):
        # the dispatch's batch-leading tensors straight to the K14 wrapper
        # (steady_filter_append's own call, with the horizons mode)
        if not isinstance(armed, torch.Tensor):
            armed = torch.full((mean.shape[0],), bool(armed),
                               dtype=torch.bool, device=mean.device)
        out = steady_filter(
            ss.phi, ss.z, kgain, fdiag, real.contiguous(), mean,
            y_new.contiguous(), mask_new.contiguous(), armed, policy,
            nsigma * nsigma, seq, horizons=horizon_set(hz, mean) if hz
            else None)
        res = tuple(out[:4]) + (tuple(out[4:6]) if gated else ())
        if hz:
            res += (out[6],)
        return res, out[4], out[3]

    if det_on:
        detect.validate()
        dpar = detect.kernel_params

        def fn(ss, mean, kgain, fdiag, real, y_new, mask_new, armed,
               det_state, det_armed):
            res, zs, broke = core(ss, mean, kgain, fdiag, real, y_new,
                                  mask_new, armed)
            det_new, det_counts = detect_append(
                det_state, zs, mask_new, det_armed & ~broke, **dpar)
            return res + (det_new, det_counts, detect_stats(det_new))

    elif gated:

        def fn(ss, mean, kgain, fdiag, real, y_new, mask_new, armed):
            return core(ss, mean, kgain, fdiag, real, y_new, mask_new,
                        armed)[0]

    else:

        def fn(ss, mean, kgain, fdiag, real, y_new, mask_new):
            return core(ss, mean, kgain, fdiag, real, y_new, mask_new,
                        False)[0]

    return fn


# ----------------------------------------------------------------------
# arena-native kernels: gather -> update -> gate -> scatter, in place
# ----------------------------------------------------------------------
def make_arena_update_fn(engine: str = "joint",
                         gate: Optional[GateSpec] = None,
                         validate: bool = True, horizons=None,
                         steady_tol: float = 0.0,
                         detect: Optional[DetectSpec] = None,
                         robust: Optional[RobustSpec] = None):
    """The **arena** assimilation function (in place, one K16 launch).

    ``fn(dynamic, static, rows, y, mask[, min_seen]) -> (dynamic, ok,
    sigma, detf[, zscore, verdict])`` where ``dynamic``/``static`` are a
    :class:`~metran_tpu_torch.serve.state.StateArena`'s leaf tuples
    (``(mean, fac, t_seen, version)``, ``(phi, q, z, r)``), ``rows`` the
    (G,) row of each request's model (DISTINCT within one call — the
    service's per-model rounds guarantee it; a repeat raises) and
    ``y``/``mask`` (G, k, N).  The dynamic leaves are updated in place:
    the kernel gathers the G rows, runs the engine's step body (K1 on
    the joint engine ungated, K12 on the sequential engine and for every
    gated, detecting or robust covariance registry, K9 on the square-root
    engine), the on-device integrity gate (JAX's ``_arena_posterior_ok``;
    plain form :func:`~metran_tpu_torch.kernels.arena.posterior_ok_plain`,
    skipped when ``validate`` is off) and writes back only the rows that
    passed, advancing their ``t_seen``/``version`` by ``k``/1 — a
    rejected row stays exactly as it was.

    With an enabled ``gate`` the per-row ``armed`` flag comes from the
    resident ``t_seen`` against ``min_seen`` on the device, and the
    z-scores and int8 verdicts (G, k, N) follow ``detf``.  With ``steady_
    tol > 0`` a trailing ``real`` ((G, N) true-slot flags) argument
    joins the signature and a (G,) ``conv`` flag
    (:func:`metran_tpu_torch.ops.steady_converged` on the device) rides
    last.  With an enabled ``detect`` the signature is ``fn(dynamic,
    static, det, rows, y, mask, min_seen, real, det_min_seen)`` with the
    (B, 6, N) detector leaf advanced in place and ``(det_counts,
    det_stats)`` appended last, the detector leaf returned second; a row
    the integrity gate rejects keeps its detector state bit for bit and
    books zero counts.  With an enabled ``robust`` (exclusive with the
    gate) four (G, N) per-slot parameter arrays ``rail_lo, rail_hi,
    quantum, scale`` follow ``min_seen`` and ``(zscore, verdict, iters)``
    follow ``detf``.  With a non-empty ``horizons`` set K16 runs its
    horizons mode and ``(fmeans, fvars)`` ((G, H, N), standardized) of
    each row AS WRITTEN (a rejected row's prior) follow every other
    output of the update, before ``conv`` and the detector's.  Signatures
    and output order are the JAX package's.
    """
    if engine not in SERVE_ENGINES:
        raise ValueError(f"unknown serve engine {engine!r}")
    hz = tuple(int(h) for h in horizons) if horizons else ()
    sqrt_engine = engine in SQRT_ENGINES
    gated = gate is not None and gate.enabled
    det_on = detect is not None and detect.enabled
    robust_on = robust is not None and robust.enabled
    if det_on:
        detect.validate()
    if robust_on:
        robust.validate()
        if gated:
            raise ValueError(
                "gate and robust are mutually exclusive on one arena "
                "update kernel; arm one of them")
    if gated:
        gate.validate()
    steady_tol = float(steady_tol)
    # the step body: K9's on the square-root engine; K1's only for a
    # joint registry with nothing armed (an armed gate, detection or a
    # robust likelihood run the sequential body, as in the JAX package)
    if sqrt_engine:
        body = "sqrt"
    elif engine == "joint" and not (gated or det_on or robust_on):
        body = "joint"
    else:
        body = "gated"
    gaussian = robust_on and robust.likelihood == "gaussian"
    map_robust = robust_on and not gaussian
    thresh = 16.0
    if gated:
        mode, thresh = gate.policy, float(gate.nsigma) ** 2
    elif det_on or gaussian:
        # z-scores from the gated body with the gate never armed: the
        # plain update's posterior, bit for bit
        mode = "reject"
    else:
        mode = "off"
    never_armed = (det_on and not gated and not robust_on) or gaussian
    dpar = detect.kernel_params if det_on else None

    def run(dyn, static, det_a, rows, y, mask, min_seen, rob_args, real,
            det_min_seen):
        mean, fac, t_seen, version = dyn
        phi, q, z, r = static
        rob = None
        if map_robust:
            rob = ArenaRobust(robust.likelihood, float(robust.nu), *(
                torch.as_tensor(a, dtype=mean.dtype, device=mean.device)
                for a in rob_args))
        floor = NEVER_ARMED if never_armed else int(min_seen or 0)
        out = arena_update(
            mean, fac, t_seen, version, phi, q, z, r, rows, y, mask,
            body=body, mode=mode, thresh=thresh, min_seen=floor,
            robust=rob, validate=validate, steady_tol=steady_tol,
            real=real, det=det_a,
            det_min_seen=int(det_min_seen or 0), det_params=dpar,
            horizons=horizon_set(hz, mean) if hz else None)
        rest = (out.ok, out.sigma, out.detf)
        if robust_on:
            iters = (out.iters if map_robust else torch.zeros(
                out.zscore.shape, dtype=torch.int32,
                device=out.zscore.device))
            rest += (out.zscore, out.verdict, iters)
        elif gated:
            rest += (out.zscore, out.verdict)
        if hz:
            rest += (out.fmeans, out.fvars)
        if steady_tol > 0.0:
            rest += (out.conv,)
        if det_on:
            return (dyn, det_a) + rest + (out.det_counts, out.det_stats)
        return (dyn,) + rest

    if det_on and robust_on:
        def fn(dyn, static, det_a, rows, y, mask, min_seen, rail_lo,
               rail_hi, quantum, scale, real, det_min_seen):
            return run(dyn, static, det_a, rows, y, mask, min_seen,
                       (rail_lo, rail_hi, quantum, scale), real,
                       det_min_seen)
    elif det_on:
        def fn(dyn, static, det_a, rows, y, mask, min_seen, real,
               det_min_seen):
            return run(dyn, static, det_a, rows, y, mask, min_seen, None,
                       real, det_min_seen)
    elif robust_on and steady_tol > 0.0:
        def fn(dyn, static, rows, y, mask, min_seen, rail_lo, rail_hi,
               quantum, scale, real):
            return run(dyn, static, None, rows, y, mask, min_seen,
                       (rail_lo, rail_hi, quantum, scale), real, None)
    elif robust_on:
        def fn(dyn, static, rows, y, mask, min_seen, rail_lo, rail_hi,
               quantum, scale):
            return run(dyn, static, None, rows, y, mask, min_seen,
                       (rail_lo, rail_hi, quantum, scale), None, None)
    elif gated and steady_tol > 0.0:
        def fn(dyn, static, rows, y, mask, min_seen, real):
            return run(dyn, static, None, rows, y, mask, min_seen, None,
                       real, None)
    elif gated:
        def fn(dyn, static, rows, y, mask, min_seen):
            return run(dyn, static, None, rows, y, mask, min_seen, None,
                       None, None)
    elif steady_tol > 0.0:
        def fn(dyn, static, rows, y, mask, real):
            return run(dyn, static, None, rows, y, mask, None, None, real,
                       None)
    else:
        def fn(dyn, static, rows, y, mask):
            return run(dyn, static, None, rows, y, mask, None, None, None,
                       None)
    return fn


def make_arena_steady_update_fn(gate: Optional[GateSpec] = None,
                                horizons=None,
                                sequential_gate: bool = False,
                                detect: Optional[DetectSpec] = None):
    """The **arena steady** (frozen-gain) update (in place, one K17
    launch).

    ``fn(dynamic, static, steady_leaves, rows, real, y, mask[, min_seen])
    -> (dynamic, applied, sigma, detf[, zscore, verdict])`` where
    ``steady_leaves`` is the arena's ``(steady, kgain, fdiag)``: per row
    the mean-only append through the resident frozen gain (K14's body);
    a row is ``applied`` only when its resident ``steady`` flag is set
    AND nothing broke time-invariance (a missing slot, a ``reject``/
    ``inflate`` hit, a non-finite mean).  Applied rows write their mean
    and advance ``t_seen``/``version``; the rest stay bit for bit as they
    were and the service replays them through the exact update.  The
    factor leaf is never touched.  With an enabled ``detect`` the
    signature is ``fn(dynamic, static, steady_leaves, det, rows, real,
    y, mask, min_seen, det_min_seen)`` with the detector leaf returned
    second and ``(det_counts, det_stats)`` last (unapplied rows carry
    their state and book zero counts).  With a non-empty ``horizons`` set
    K17 runs its horizons mode and ``fmeans`` ((G, H, N), standardized:
    ``Z (phi^h o m)`` of each row's written mean) follows the gate's
    outputs; the variance half is cached at freeze.
    """
    hz = tuple(int(h) for h in horizons) if horizons else ()
    gated = gate is not None and gate.enabled
    det_on = detect is not None and detect.enabled
    if det_on:
        detect.validate()
    if gated:
        gate.validate()
        mode, thresh = gate.policy, float(gate.nsigma) ** 2
    else:
        mode, thresh = "off", 16.0
    seq = bool(sequential_gate) and gated
    dpar = detect.kernel_params if det_on else None

    def run(dyn, static, steady_leaves, det_a, rows, real, y, mask,
            min_seen, det_min_seen):
        mean, _fac, t_seen, version = dyn
        phi, _q, z, _r = static
        steady, kgain, fdiag = steady_leaves
        out = arena_steady_update(
            mean, t_seen, version, phi, z, steady, kgain, fdiag, rows,
            real, y, mask, mode=mode, thresh=thresh, sequential=seq,
            min_seen=int(min_seen or 0), det=det_a,
            det_min_seen=int(det_min_seen or 0), det_params=dpar,
            horizons=horizon_set(hz, mean) if hz else None)
        rest = (out.applied, out.sigma, out.detf)
        if gated:
            rest += (out.zscore, out.verdict)
        if hz:
            rest += (out.fmeans,)
        if det_on:
            return (dyn, det_a) + rest + (out.det_counts, out.det_stats)
        return (dyn,) + rest

    if det_on:
        def fn(dyn, static, steady_leaves, det_a, rows, real, y, mask,
               min_seen, det_min_seen):
            return run(dyn, static, steady_leaves, det_a, rows, real, y,
                       mask, min_seen, det_min_seen)
    elif gated:
        def fn(dyn, static, steady_leaves, rows, real, y, mask, min_seen):
            return run(dyn, static, steady_leaves, None, rows, real, y,
                       mask, min_seen, None)
    else:
        def fn(dyn, static, steady_leaves, rows, real, y, mask):
            return run(dyn, static, steady_leaves, None, rows, real, y,
                       mask, None, None)
    return fn


def make_arena_forecast_fn(steps: int, sqrt: bool = False):
    """The **arena** forecast (read-only, one K18 launch): ``fn(mean, fac,
    static, rows) -> (means, variances)`` of shape (G, steps, N),
    standardized units — the rows gathered, covariances reconstituted
    from the factors on a square-root arena, and the closed-form horizon
    moments of :func:`make_forecast_fn`."""
    steps = int(steps)

    def fn(mean_a, fac_a, static, rows):
        horizons = torch.arange(1, steps + 1, device=mean_a.device).to(
            mean_a.dtype)
        return arena_forecast(mean_a, fac_a, *static, rows, horizons,
                              sqrt=bool(sqrt))

    return fn
