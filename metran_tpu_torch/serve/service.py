"""`MetranService`: the in-process serving API of the port.

Port of the dict-registry core of the JAX package's
``serve/service.py``::

    update(model_id, new_obs) ─┐                       ┌─> K1 launch
                               ├─> MicroBatcher ──────>┤   (K12 on
    forecast(model_id, steps) ─┘    (group by          │   sequential,
                                     bucket+horizon)   │   gated or
                                                       │   robust, K9 on
                                                       │   sqrt; + K13
                                                       │   with detect)
                                                       └─> K2 launch
                                                            one per group

- Requests take and return **data units**; standardization happens at
  submit with each model's stored scaler constants.
- ``update`` assimilates ``k`` new rows (NaN = missing) through the
  incremental filter and bumps the model's version; ``forecast`` returns
  closed-form predictive moments from the warm posterior.
- Two updates to one model inside one flush apply in order (dispatch
  rounds), and a model's update chains on its unresolved predecessor
  unless both provably share one batcher group.
- A request fails ALONE: payloads are validated at submit, and each
  batch slot's posterior passes the integrity gate before
  ``registry.put`` — a poisoned model fails its own request while the
  other slots of the same launch commit.
- A ``ModelRegistry(engine="sqrt")`` assimilates in factored form:
  the stacked factors go through K9, each slot's factor is committed
  beside its reconstituted covariance, and the gate is a finiteness
  check.
- **Reliability** (:class:`~metran_tpu_torch.reliability.
  ReliabilityPolicy`): a hard deadline on every synchronous call,
  retries of retryable failures with backoff inside it, a circuit
  breaker per model (:class:`~metran_tpu_torch.reliability.
  CircuitOpenError` while open, one half-open probe after the
  cooldown) and a :class:`~metran_tpu_torch.reliability.HealthMonitor`
  behind :meth:`MetranService.health`.
- **The observation gate** (:class:`~metran_tpu_torch.serve.engine.
  GateSpec`): armed per model once ``t_seen >= min_seen``; each
  dispatch runs the gated update and books its verdicts
  (:attr:`MetranService.gate_verdicts`, the monitor's per-model
  rejection window) before the integrity gate.
- **Robust updates** (:class:`~metran_tpu_torch.serve.engine.
  RobustSpec`, exclusive with the gate): armed per model once ``t_seen
  >= min_seen``; censored, quantized or Student-t readings are
  conditioned through the implicit-MAP update (K12's or K9's robust
  instantiation) on per-slot parameters standardized through each
  model's scaler, clean slots falling back bit for bit; each dispatch
  books its outcomes (:attr:`MetranService.robust_total`, the Newton
  iteration tally :attr:`MetranService.robust_iters`, the monitor's
  window of non-converged solves) before the integrity gate.
- **Streaming detection** (:class:`~metran_tpu_torch.serve.engine.
  DetectSpec`): the detector runs after the update over its z-scores;
  its state is parked per model in a host mirror
  (:class:`~metran_tpu_torch.serve.monitoring.DetectorMirror`),
  alarms raise alerts with hysteresis
  (:class:`~metran_tpu_torch.serve.monitoring.AlertBoard`) and
  changepoints make the model a refit candidate; :meth:`MetranService.
  anomalies` and :meth:`MetranService.alerts` read them.
- **Steady-state serving** (:class:`~metran_tpu_torch.serve.engine.
  SteadySpec`): once an exact update leaves a model's posterior factor
  within ``tol`` of the one before, over a fully-observed append with
  no gate verdict, the model **freezes** — its DARE solved and its gains
  frozen (K15, one launch per group of candidates sharing their
  dimensions) — and its updates run the mean-only steady update (K14,
  then K13 with detection).  A frozen row that breaks time-invariance
  (a missing slot, a reject/inflate gate hit, a non-finite mean), whose
  posterior was replaced by an external ``registry.put``, or an armed
  robust model **thaws** and replays through the exact update in the
  same dispatch.  A steady commit replaces only the mean, the version
  and ``t_seen``: the stored covariance stays (forecasts run K2 on it).
- **Fixed-lag smoothing** (``fixed_lag=L``): a
  :class:`~metran_tpu_torch.serve.smoothing.FixedLagTracker` observes
  every commit; :meth:`MetranService.smoothed` answers the trailing
  window (K9 ``store`` from the anchor, then K10).
- **The state arena** (``ModelRegistry(arena=True)``): each bucket's
  posteriors stay resident on the device and a dispatch sends up only
  row indices and the new observations.  An update is one in-place
  launch of K16 (gather, the engine's step, the integrity gate,
  detection, the masked scatter), frozen rows one of K17 first; a
  forecast one of K18.  Updates resolve to :class:`ArenaUpdateAck`\\ s
  (the posterior stays on the device; ``registry.get`` reads it back);
  ``update_batch``/``forecast_batch`` serve whole fleet ticks with
  vectorized host work; durability is the spill on ``close()``.
- **The materialized read path** (``readpath=True``): every committed
  update also computes the forecast moments of the new posterior at the
  service's horizon set in the same dispatch (the ``horizons`` modes of
  K16, K17 and K14; K2 after the dict path's exact update) and publishes
  them, de-standardized, into a :class:`~metran_tpu_torch.serve.readpath.
  SnapshotStore` before the callers' futures resolve.  ``forecast``,
  ``forecast_async`` and ``forecast_batch`` answer a hit from host
  memory — no batcher, no breaker, no launch — and fall through to the
  compute path on a miss or a stale entry; the registry's commit hooks
  make an external ``put`` stale.

The dispatch runs on the service's device (default: the CUDA card; an
arena dispatch on its arena's device).  Refit, durability, the cluster
and the observability layers come in later slices: asking for them
raises :class:`~metran_tpu_torch.ops.kalman.NotPortedError` naming the
ROADMAP item (A4.9, A7).
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from logging import getLogger
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device, serve_defaults
from ..ops import (
    DETECT_STATE_ROWS,
    GATE_DOWNWEIGHTED,
    GATE_REJECTED,
    ROBUST_NONCONV,
    dfm_statespace,
    forecast_observation_moments,
    steady_converged,
    steady_gains,
)
from ..ops.kalman import NotPortedError
from ..reliability import (
    BreakerBoard,
    ChainedRequestError,
    CircuitOpenError,
    DeadlineExceededError,
    HealthMonitor,
    ReliabilityPolicy,
    StateIntegrityError,
    is_retryable,
)
from .batching import MicroBatcher
from .engine import (
    DetectSpec,
    GateSpec,
    RobustSpec,
    SteadySpec,
    posterior_fault,
    stack_bucket,
    state_slot_index,
)
from .monitoring import AlertBoard, DetectorMirror
from .readpath import (
    ForecastSnapshot,
    SnapshotEntry,
    SnapshotStore,
    parse_horizons,
)
from .registry import ModelRegistry
from .smoothing import FixedLagTracker, SmoothedWindow
from .state import PosteriorState

logger = getLogger(__name__)

#: seconds a thawed model waits before it may freeze again, so a gappy
#: feed does not flap between the two paths
STEADY_REFREEZE_COOLDOWN_S = 30.0

#: the JAX service's layers this port does not have yet, by keyword
_LATER = {
    "observability": "ROADMAP A7 (observability)",
    "capacity": "ROADMAP A7 (the capacity plane)",
    "refit": "ROADMAP A4.9 (the refit worker)",
    "durability": "ROADMAP A7 (durability)",
    "cluster": "ROADMAP A7 (the cluster layer)",
    "replication": "ROADMAP A7 (replication)",
}


def _armed_spec(spec) -> bool:
    """Whether a keyword of a layer not ported asks for it: a spec with
    ``enabled``, or any other truthy value (``readpath=True``,
    ``fixed_lag=8``)."""
    if spec is None:
        return False
    return bool(getattr(spec, "enabled", spec))


def _gate_robust_clash() -> ValueError:
    return ValueError(
        "gate and robust are mutually exclusive: the robust likelihood IS "
        "the outlier treatment (huber_t subsumes the gate's huber "
        "policy); arm one of them")


class EventCounters:
    """Thread-safe named counters (``increment``/``snapshot``): the
    service's error, gate-verdict, robust and detection tallies."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Counter = Counter()

    def increment(self, kind: str, n: int = 1) -> None:
        with self._lock:
            self._counts[kind] += int(n)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)


def _host(outputs) -> list:
    """A dispatch's outputs as numpy arrays.  Outputs that are views of
    one buffer (a horizon pass's means and variances, which the kernels
    write into the two halves of one (2, ...) tensor) come to the host in
    one copy."""
    out, copied = [], {}
    for t in outputs:
        base = t._base
        if (base is not None and base.dim() == t.dim() + 1
                and tuple(base.shape[1:]) == tuple(t.shape)
                and base.is_contiguous()):
            key = base.data_ptr()
            if key not in copied:
                copied[key] = base.cpu().numpy()
            half = (t.storage_offset() - base.storage_offset()) \
                // base.stride(0)
            out.append(copied[key][half])
        else:
            out.append(t.cpu().numpy())
    return out


def _transfer(src: Future, dst: Future) -> None:
    """Mirror one future's outcome onto another (chained submissions)."""
    if dst.done():
        return
    if src.cancelled():
        dst.cancel()
    elif src.exception() is not None:
        dst.set_exception(src.exception())
    else:
        dst.set_result(src.result())


class _ChainedFuture(Future):
    """Caller-visible future for an update whose batcher submission may
    happen later than the call that created it (a deferred request
    enqueues only once its same-model predecessor resolves).

    ``cancel()`` is atomic with that hand-off: either it wins while
    nothing was enqueued, or it propagates to the inner batcher request
    and succeeds only if THAT request could still be cancelled.  A
    successful cancel proves the observations were never assimilated.
    """

    def __init__(self):
        super().__init__()
        self._chain_lock = threading.RLock()
        self._inner: Optional[Future] = None
        self._detached = False  # a cancel won before any submission

    def attach_inner(self, submit):
        """Run ``submit()`` (returning ``(inner_future, token)``) unless
        this future is resolved or a cancel won; record the inner future.
        Returns ``submit()``'s result, or ``None`` when nothing was
        enqueued."""
        with self._chain_lock:
            if self._detached or self.done():
                return None
            out = submit()
            if out[0] is not None:
                self._inner = out[0]
            return out

    def cancel(self) -> bool:
        with self._chain_lock:
            inner = self._inner
            if inner is None:
                self._detached = True
        if inner is None:
            return super().cancel() or self.cancelled()
        if inner.cancel() or inner.cancelled():
            super().cancel()
            return True
        return False


class _PendingUpdate:
    """One model's most recent update in flight: its batch key, future,
    batcher group token (``None`` while deferred) and the unresolved
    predecessor it chained on."""

    __slots__ = ("key", "future", "group", "prior")

    def __init__(self, key, future: _ChainedFuture, prior=None):
        self.key = key
        self.future = future
        self.group = None
        self.prior = prior


class _SteadyInfo(NamedTuple):
    """One frozen model's steady serving summary.

    ``version`` plus the ``params_ref``/``loadings_ref`` object
    identities pin the posterior lineage the frozen state expects: the
    service's own commits go through ``st._replace`` (the same parameter
    objects, the version tracked here), while any external
    ``registry.put`` — a refit hot-swap, a restore, even one that reuses
    the frozen version number — carries fresh arrays and thaws the
    model.  ``kgain``/``fdiag`` are bucket-padded (S_pad, N_pad)/
    (N_pad,) arrays ready to stack into a steady dispatch; ``hvars`` the
    (H, n_series) STANDARDIZED horizon variances computed once at freeze
    (``None`` with the read path off): the frozen covariance never
    changes, so the variance half of every later snapshot is this one
    constant.
    """

    version: int
    kgain: np.ndarray
    fdiag: np.ndarray
    hvars: Optional[np.ndarray]
    params_ref: object
    loadings_ref: object


class ArenaUpdateAck(NamedTuple):
    """What an **arena** update resolves to: the commit acknowledgement
    — the bumped ``version`` and ``t_seen``, the tokens a
    :class:`PosteriorState` result carried — instead of a materialized
    state (the posterior stays on the device; ``service.registry.
    get(model_id)`` reads it back when needed)."""

    model_id: str
    version: int
    t_seen: int


class Forecast(NamedTuple):
    """Forecast of one model, data units: ``means``/``variances`` are
    (steps, n_series); ``version`` the posterior version served."""

    means: np.ndarray
    variances: np.ndarray
    names: Tuple[str, ...]
    version: int


class MetranService:
    """Query-able, incrementally-updatable serving front end.

    Parameters
    ----------
    registry : model storage + shape buckets.
    flush_deadline : seconds a request may wait to co-batch (``None``:
        requests dispatch on :meth:`flush`, the deterministic mode).
        Default from :func:`metran_tpu_torch.config.serve_defaults`.
    max_batch : dispatch immediately once a group is this full.
    persist_updates : write updated states through to the registry's
        disk root (ignored for in-memory registries).
    reliability : deadline/retry/breaker/validation policy
        (:class:`~metran_tpu_torch.reliability.ReliabilityPolicy`);
        default from :func:`metran_tpu_torch.config.serve_defaults`.
    gate : observation-gate policy (:class:`~metran_tpu_torch.serve.
        engine.GateSpec`); default from ``serve_defaults()``
        (``METRAN_TPU_SERVE_GATE_*``, shipped ``policy="off"``).
    robust : non-Gaussian observation policy (:class:`~metran_tpu_torch.
        serve.engine.RobustSpec`); default from ``serve_defaults()``
        (``METRAN_TPU_SERVE_ROBUST*``, shipped off).  Enabled, updates
        run through the implicit-MAP update: censored (railed) readings
        contribute their one-sided tail mass, quantized readings their
        cell's interval likelihood, heavy-tailed feeds the Student-t
        loss, each flagged slot solved by a damped Newton inner solve
        and committed as its Laplace summary, while clean slots fall
        back bit-identically to the closed-form update.  Mutually
        exclusive with an enabled ``gate``.
    detect : streaming-detection policy (:class:`~metran_tpu_torch.
        serve.engine.DetectSpec`); default from ``serve_defaults()``
        (``METRAN_TPU_SERVE_DETECT*``, shipped off).
    steady : steady-state gain-freeze policy (:class:`~metran_tpu_torch.
        serve.engine.SteadySpec`); default from ``serve_defaults()``
        (``METRAN_TPU_SERVE_STEADY_{TOL,MIN_SEEN}``, shipped off).
    fixed_lag : arm fixed-lag smoothed products with this window
        (:meth:`smoothed`); default from ``serve_defaults()``
        (``METRAN_TPU_SERVE_FIXED_LAG``, shipped 0 = off).
    readpath : serve forecasts from the materialized read path
        (:mod:`metran_tpu_torch.serve.readpath`); default from
        ``serve_defaults()`` (``METRAN_TPU_SERVE_READPATH``, shipped
        off).  Every committed update then runs the commit-time horizon
        pass in its own dispatch and publishes the de-standardized
        moments; ``forecast``/``forecast_async``/``forecast_batch``
        consult the store first, and a hit dispatches nothing and takes
        no breaker — bit for bit the compute path's answer at f64.
    horizons : the horizon set precomputed at commit time (ints or a
        spec string, :func:`~metran_tpu_torch.serve.readpath.
        parse_horizons`; default ``METRAN_TPU_SERVE_HORIZONS``, "1-30").
        ``forecast(steps=s)`` is cacheable iff the set holds ``1..s``.
    observability, capacity, refit, durability, cluster, replication :
        the JAX service's other layers; not ported yet — asking for one
        raises :class:`~metran_tpu_torch.ops.kalman.NotPortedError`
        naming its ROADMAP item.
    device : where the kernels run (default: the CUDA card; without one
        construction raises — pass ``device="cpu"`` for the CPU).
    """

    def __init__(self, registry: ModelRegistry,
                 flush_deadline: Optional[float] = "default",
                 max_batch: Optional[int] = None,
                 persist_updates: bool = True,
                 reliability: Optional[ReliabilityPolicy] = None,
                 observability=None,
                 gate: Optional[GateSpec] = None,
                 robust: Optional[RobustSpec] = None,
                 readpath="default", horizons=None,
                 steady: Optional[SteadySpec] = None,
                 fixed_lag: Optional[int] = None,
                 refit=None, detect: Optional[DetectSpec] = None,
                 capacity=None, durability=None, cluster=None,
                 replication=None, device=None):
        self.gate = (gate.validate() if gate is not None
                     else GateSpec.from_defaults())
        # the exclusion first: it holds whatever the robust spec is
        if _armed_spec(robust) and self.gate.enabled:
            raise _gate_robust_clash()
        self.robust = (robust.validate() if robust is not None
                       else RobustSpec.from_defaults())
        if self.robust.enabled and self.gate.enabled:  # both from defaults
            raise _gate_robust_clash()
        for name, spec in (("observability", observability),
                           ("capacity", capacity),
                           ("refit", refit), ("durability", durability),
                           ("cluster", cluster),
                           ("replication", replication)):
            if _armed_spec(spec):
                raise NotPortedError(
                    f"MetranService({name}=...) is not ported yet: "
                    f"{_LATER[name]}")
        self.device = resolve_device(device)
        defaults = serve_defaults()
        if flush_deadline == "default":
            flush_deadline = defaults["flush_deadline_s"]
        if max_batch is None:
            max_batch = defaults["max_batch"]
        if readpath == "default":
            readpath = bool(defaults["readpath"])
        if horizons is None:
            horizons = defaults["horizons"]
        self.horizons = parse_horizons(horizons)
        self.registry = registry
        self.persist_updates = persist_updates
        self.reliability = (reliability if reliability is not None
                            else ReliabilityPolicy.from_defaults())
        self.deadline_s = self.reliability.deadline_s
        self.breakers = BreakerBoard(
            failure_threshold=self.reliability.breaker_failures,
            cooldown_s=self.reliability.breaker_cooldown_s,
            clock=self.reliability.clock,
        )
        self.monitor = HealthMonitor(
            window=self.reliability.health_window,
            max_error_rate=self.reliability.max_error_rate,
        )
        #: observations the gate acted on, ``{"rejected": n,
        #: "downweighted": m}``, booked before the integrity gate
        self.gate_verdicts = EventCounters()
        #: robust-update outcomes by kind (``map_updates`` — commits with
        #: at least one MAP-conditioned slot; ``map_slots`` — the
        #: MAP-conditioned observations; ``fallback_updates`` — armed
        #: commits where nothing flagged, the bit-identical Gaussian
        #: update; ``nonconverged`` — flagged slots whose inner solve
        #: missed its residual bar), booked before the integrity gate
        self.robust_total = EventCounters()
        #: the inner solve's Newton steps per MAP-conditioned slot, as
        #: counts by the number of steps (the JAX service's histogram)
        self.robust_iters = EventCounters()
        self.detect = (detect.validate() if detect is not None
                       else DetectSpec.from_defaults())
        #: detection outcomes by kind (``anomaly``, ``changepoint_cusum``,
        #: ``changepoint_lb``, ``alert_raised``, ``alert_cleared``)
        self.detect_total = EventCounters()
        self.detector: Optional[DetectorMirror] = None
        self.alert_board: Optional[AlertBoard] = None
        if self.detect.enabled:
            self.detector = DetectorMirror()
            self.alert_board = AlertBoard(
                cooldown_s=self.detect.alert_cooldown_s,
                counter=self.detect_total,
            )
        self.steady = (steady.validate() if steady is not None
                       else SteadySpec.from_defaults())
        #: freeze/thaw transitions by kind (``freeze``, ``thaw``)
        self.steady_transitions = EventCounters()
        #: frozen models (model_id -> _SteadyInfo)
        self._steady_info: dict = {}
        #: the arena's frozen rows' standardized horizon variances
        #: (model_id -> (H, n_series)), the variance half of their
        #: snapshots (dict mode keeps them in _SteadyInfo)
        self._steady_hvars: dict = {}
        #: model_id -> monotonic time of its last thaw (the refreeze
        #: cooldown)
        self._steady_thawed_at: dict = {}
        if fixed_lag is None:
            fixed_lag = int(defaults["fixed_lag"])
        self.smoother = (FixedLagTracker(fixed_lag, device=self.device)
                         if int(fixed_lag) > 0 else None)
        self._errors = EventCounters()
        # one lock around each assimilation round keeps every model's
        # read -> compute -> put sequential across dispatch threads
        self._update_lock = threading.Lock()
        # guards only the per-model ordering bookkeeping; batcher
        # submissions happen after it is released (a size-triggered
        # flush dispatches inline and its callbacks re-take this lock)
        self._order_lock = threading.Lock()
        self._last_update: dict = {}  # model_id -> _PendingUpdate
        self.batcher = MicroBatcher(
            self._dispatch, flush_deadline=flush_deadline,
            max_batch=max_batch,
        )
        #: the materialized read path's snapshot store (``None``: off)
        self.readpath: Optional[SnapshotStore] = (
            SnapshotStore(self.horizons)
            if readpath and self.horizons else None)
        if self.readpath is not None:
            # invalidation: ANY registry.put (a served dict update, a
            # refit hot-swap, an operator restore) marks the entry stale
            self.registry.on_commit(self.readpath.note_commit)

    # ------------------------------------------------------------------
    def _count(self, kind: str, n: int = 1) -> None:
        self._errors.increment(kind, n)

    @property
    def stats(self) -> dict:
        """Lifetime counters: validation errors, poisoned updates and
        forecasts (integrity-gate rejections), chain failures, masked
        cells, empty updates, retries, breaker rejections, ..."""
        return self._errors.snapshot()

    def _ready(self) -> bool:
        """The orchestrator bit: the batcher can dispatch and the
        windowed error rate is under the policy's threshold."""
        alive = self.batcher.worker_alive() and not self.batcher.closed
        return bool(alive and self.monitor.healthy())

    def health(self) -> dict:
        """Readiness/health snapshot for probes (the JAX service's
        ``health()`` without the observability layer's latency and event
        sections, ROADMAP A7): ``ready``, the windowed error rate and
        the per-model gate window (:meth:`~metran_tpu_torch.reliability.
        HealthMonitor.snapshot`), batcher liveness and depth, open
        breakers, lifetime error counters, the registry's integrity
        events, on an arena registry its occupancy and the spill-mode
        durability lag and, with the gate, robust updates, steady-state
        serving, fixed-lag smoothing or detection armed, their
        tallies."""
        alive = self.batcher.worker_alive() and not self.batcher.closed
        extra = {
            "ready": self._ready(),
            "batcher": {
                "worker_alive": alive,
                "pending": self.batcher.pending(),
                "oldest_wait_s": round(self.batcher.oldest_wait(), 4),
                "flush_deadline_s": self.batcher.flush_deadline,
            },
            "breakers": {
                "open": self.breakers.open_models(),
                "tracked": len(self.breakers),
            },
            "errors": self.stats,
            "integrity": self.registry.integrity_stats,
        }
        if self.readpath is not None:
            extra["readpath"] = self.readpath.stats()
        if self.registry.arena_enabled:
            extra["arena"] = self.registry.arena_stats
            age = self.registry.last_spill_age()
            extra["durability"] = {
                "mode": "spill",
                "last_spill_age_s": None if age is None else round(age, 4),
                "unsynced_commits": None,  # unbounded: no WAL armed
            }
        if self.gate.enabled:
            extra["gate_verdicts"] = self.gate_verdicts.snapshot()
        if self.robust.enabled:
            extra["robust_total"] = self.robust_total.snapshot()
            extra["robust_iterations"] = self.robust_iters.snapshot()
        if self.steady.enabled:
            extra["steady"] = {"frozen": self._steady_count(),
                               "tol": self.steady.tol,
                               **self.steady_transitions.snapshot()}
        if self.smoother is not None:
            extra["fixed_lag"] = {"lag": self.smoother.lag,
                                  "tracked": len(self.smoother)}
        if self.detect.enabled:
            extra["detect"] = {
                "tracked": len(self.detector),
                "alerts": self.alert_board.stats(),
                "changepoints_pending": self.monitor.changepoint_models(),
                **self.detect_total.snapshot(),
            }
        return self.monitor.snapshot(extra)

    def _require_detect(self) -> None:
        if not self.detect.enabled:
            raise ValueError(
                "streaming detection is disabled; construct the service "
                "with detect=DetectSpec(enabled=True) or set "
                "METRAN_TPU_SERVE_DETECT=1"
            )

    def anomalies(self, model_id: Optional[str] = None) -> dict:
        """Per-model streaming-detection snapshot (detection armed):
        ``{model_id: {...}}`` with the per-slot ``cusum_pos``/
        ``cusum_neg``/``lb_q`` statistics read from the host mirror,
        cumulative ``anomalies``/``cusum_alarms``/``lb_alarms`` counts,
        the stream position of the last alarm and the flagged slots."""
        self._require_detect()
        if model_id is not None:
            self.registry.meta(model_id)  # unknown ids raise KeyError
        snap = self.detector.snapshot(model_id)
        if self.registry.arena_enabled:
            # arena rows keep their accumulators on the device: live
            # statistics from one read of each arena's detector leaf
            live = self.registry.arena_detect_stats(model_id)
            for mid, (stats, _n, version, t_seen) in live.items():
                entry = snap.setdefault(mid, {
                    "anomalies": 0, "cusum_alarms": 0, "lb_alarms": 0,
                    "last_alarm_t_seen": None, "slots_flagged": {},
                })
                entry.update(version=version, t_seen=t_seen,
                             cusum_pos=stats[0].tolist(),
                             cusum_neg=stats[1].tolist(),
                             lb_q=stats[2].tolist())
        return snap

    def alerts(self, model_id: Optional[str] = None,
               active_only: bool = True) -> list:
        """Alert records, newest raise first (detection armed): one per
        detection episode, raise/clear hysteresis applied."""
        self._require_detect()
        return self.alert_board.alerts(model_id, active_only=active_only)

    # ------------------------------------------------------------------
    # steady-state (frozen-gain) serving
    # ------------------------------------------------------------------
    def _steady_count(self) -> int:
        """Models currently frozen."""
        if self.registry.arena_enabled:
            return self.registry.steady_rows_count()
        return len(self._steady_info)

    def _book_steady(self, kind: str, model_id: str, **detail) -> None:
        """One freeze/thaw transition: the counter, a log line and, on a
        thaw, the refreeze-cooldown stamp."""
        if kind == "thaw":
            self._steady_thawed_at[model_id] = time.monotonic()
        self.steady_transitions.increment(kind)
        logger.info("steady %s: model %r %s", kind, model_id, detail)

    def _steady_freezable(self, model_id: str) -> bool:
        """Whether a freeze candidate is past its refreeze cooldown (a
        model that never thawed always is)."""
        thawed_at = self._steady_thawed_at.get(model_id)
        return (thawed_at is None or time.monotonic() - thawed_at
                >= STEADY_REFREEZE_COOLDOWN_S)

    def _compute_steady(self, states, bucket) -> dict:
        """The frozen serving summaries of freeze candidates,
        bucket-padded: ``{model_id: (kgain, fdiag, hvars)}``.

        Each group of candidates that share their true dimensions
        ``(n_series, n_factors)`` solves its DARE and gains in ONE K15
        launch, on the true dimensions in float64 (the JAX service
        solves each model in its parameters' f64 precision, one call
        per model: the results are the same).  Gated covariance engines
        freeze the per-slot sequential gains and conditional variances
        (their exact update gates per slot), square-root and ungated
        registries the joint gain and marginal variances
        (:meth:`ModelRegistry.steady_sequential_gate`); the frozen pair
        is scattered into the bucket layout.  With the read path armed
        ``hvars`` are the (H, n_series) STANDARDIZED horizon variances of
        the steady filtered covariance (one K2 launch per group, on the
        service's device; the JAX service's ``forecast_observation_
        moments`` of ``p_filt``), the constant every later snapshot of
        the frozen model reuses; ``None`` otherwise.
        """
        seq = self.registry.steady_sequential_gate(self.gate)
        n_pad, s_pad = bucket
        groups: dict = {}
        for st in states:
            groups.setdefault((st.n_series, st.n_factors), []).append(st)
        out = {}
        for (n, kf), grp in groups.items():
            params = np.stack([np.asarray(st.params, float) for st in grp])
            ss = dfm_statespace(
                params[:, :n], params[:, n:],
                np.stack([np.asarray(st.loadings, float) for st in grp]),
                np.array([float(st.dt) for st in grp]), device=self.device,
                dtype=torch.float64)
            gains = steady_gains(ss)
            kgain = (gains.kgain_seq if seq else gains.kgain).cpu().numpy()
            fdiag = (gains.fdiag_seq if seq else gains.fdiag).cpu().numpy()
            hvars = None
            if self.readpath is not None:
                _, hv = forecast_observation_moments(
                    ss, torch.zeros_like(gains.p_filt[..., 0]),
                    gains.p_filt,
                    torch.tensor(self.horizons, dtype=torch.float64,
                                 device=self.device))
                hvars = hv.cpu().numpy()  # (G, H, n) standardized
            idx = state_slot_index(n, kf, n_pad)
            for i, st in enumerate(grp):
                kg = np.zeros((s_pad, n_pad), st.dtype)
                kg[np.ix_(idx, np.arange(n))] = kgain[i]
                fd = np.ones(n_pad, st.dtype)
                fd[:n] = fdiag[i]
                out[st.model_id] = (kg, fd,
                                    None if hvars is None else hvars[i])
        return out

    def _freeze(self, candidates, bucket) -> None:
        """Freeze the candidates of one exact dispatch (``(state,
        delta)`` pairs, each past every freeze condition).  Its own
        guard: the updates are applied, and a freeze hiccup leaves the
        models exact."""
        try:
            frozen = self._compute_steady([st for st, _ in candidates],
                                          bucket)
        except Exception:
            logger.exception("steady freeze failed for models %s (serving "
                             "stays exact)",
                             [st.model_id for st, _ in candidates])
            return
        for st, delta in candidates:
            kg, fd, hvars = frozen[st.model_id]
            self._steady_info[st.model_id] = _SteadyInfo(
                version=st.version, kgain=kg, fdiag=fd, hvars=hvars,
                params_ref=st.params, loadings_ref=st.loadings)
            self._book_steady("freeze", st.model_id, delta=delta,
                              tol=self.steady.tol, version=st.version)

    def _thaw_dict(self, model_id: str, reason: str) -> None:
        """Drop a model's frozen state (idempotent)."""
        if self._steady_info.pop(model_id, None) is not None:
            self._book_steady("thaw", model_id, reason=reason)

    # ------------------------------------------------------------------
    # fixed-lag smoothed products (serve.smoothing)
    # ------------------------------------------------------------------
    def smoothed(self, model_id: str,
                 lag: Optional[int] = None) -> SmoothedWindow:
        """Smoothed moments for the model's trailing ``lag``-step window
        — the best estimate of the recent past given everything
        assimilated since, at O(L) cost however long the history
        (:mod:`metran_tpu_torch.serve.smoothing`).  Requires fixed-lag
        tracking (``MetranService(fixed_lag=L)`` /
        ``METRAN_TPU_SERVE_FIXED_LAG``) and updates streamed through
        this service since; the window reports its realized length.
        Data units, like :meth:`forecast`."""
        if self.smoother is None:
            raise ValueError(
                "fixed-lag smoothing is disabled; construct the service "
                "with fixed_lag=L or set METRAN_TPU_SERVE_FIXED_LAG"
            )
        self.registry.meta(model_id)  # unknown ids raise KeyError here
        return self.smoother.smooth(model_id, lag)

    def _observe_smoother(self, model_id: str, y_std, mask,
                          t_seen_after: int, post_state_fn,
                          verdicts=None) -> None:
        """Feed one committed update to the fixed-lag tracker (a no-op
        when off; never raises).  ``verdicts`` is the model's gate or
        robust verdict slice when armed: a commit the gate (or the MAP
        update) acted on restarts the window from the served posterior,
        which did not assimilate those rows as given."""
        if self.smoother is None:
            return
        clean = verdicts is None or not np.any(verdicts)
        try:
            self.smoother.observe(model_id, y_std, mask, t_seen_after,
                                  post_state_fn, clean=clean)
        except Exception:  # pragma: no cover - tracking only
            logger.exception("fixed-lag tracking failed for model %r",
                             model_id)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def forecast(self, model_id: str, steps: int,
                 deadline: Optional[float] = "default") -> Forecast:
        """Predictive means/variances ``steps`` grid periods ahead,
        bounded by ``deadline`` seconds.

        With the read path armed a snapshot hit is returned here, before
        the breaker, the batcher or any launch: version-checked (bit for
        bit the compute answer at f64) and booked in the cache counters.
        A hit bypasses the breaker on purpose — a breaker protects
        compute, and a model whose breaker is open still serves its last
        committed forecast."""
        if self.readpath is not None and type(steps) is int:
            entry = self.readpath.read(model_id, steps)
            if entry is not None:
                return self._cached_forecast(entry, steps)
        # the compute half: the cache was consulted once above, and a
        # miss must not be counted twice
        return self._call(
            "forecast", model_id,
            lambda: self._forecast_async_compute(model_id, steps), deadline,
        )

    @staticmethod
    def _cached_forecast(entry: SnapshotEntry, steps: int) -> Forecast:
        """A snapshot hit as a :class:`Forecast`: two read-only views (the
        entry's rows are horizons ``1..steps``, data units) and the
        version the moments were computed from."""
        return Forecast(means=entry.means[:steps],
                        variances=entry.variances[:steps],
                        names=entry.names, version=entry.version)

    def forecast_async(self, model_id: str,
                       steps: int) -> "Future[Forecast]":
        """The asynchronous forecast; a read-path hit resolves at once,
        with no breaker admission and no batcher hop."""
        if self.readpath is not None and type(steps) is int:
            entry = self.readpath.read(model_id, steps)
            if entry is not None:
                fut: "Future[Forecast]" = Future()
                fut.set_result(self._cached_forecast(entry, steps))
                return fut
        return self._forecast_async_compute(model_id, steps)

    def _forecast_async_compute(self, model_id: str,
                                steps: int) -> "Future[Forecast]":
        """The dispatching half of :meth:`forecast_async` (cache misses,
        or the read path off)."""
        steps = int(steps)
        if steps < 1:
            self._count("validation_errors")
            raise ValueError(f"forecast steps must be >= 1, got {steps}")
        state = self._known_state("forecast", model_id)
        breaker, token = self._admit(model_id)
        try:
            fut = self.batcher.submit(
                ("forecast", self.registry.bucket_of(state), steps),
                model_id, None)
        except BaseException:
            breaker.record_abandoned(token)  # no request existed
            raise
        self._observe(fut, "forecast", breaker, token)
        return fut

    def _known_state(self, kind: str, model_id: str):
        """The submit-path view of a known model (``registry.meta``: the
        state on a dict registry, the host-side :class:`~metran_tpu_torch.
        serve.state.ModelMeta` on an arena one, which also makes the
        model resident); a model whose stored state is bad books a
        failure against its breaker (unknown ids earn no breaker
        state)."""
        try:
            return self.registry.meta(model_id)
        except StateIntegrityError:
            self.breakers.get(model_id).record_failure()
            self.monitor.record(False)
            self._count(f"{kind}_errors")
            raise

    def _admit(self, model_id: str):
        """``(breaker, token)`` of an admitted request, or
        :class:`CircuitOpenError` while the model's breaker is open."""
        breaker = self.breakers.get(model_id)
        try:
            return breaker, breaker.allow()
        except CircuitOpenError:
            self._count("breaker_rejections")
            raise

    def _observe(self, fut: Future, kind: str, breaker, token) -> None:
        """Record a request's final outcome in its breaker, the health
        monitor and the error counters.  ``token`` attributes the
        verdict to the admission it came from, so a stale outcome
        cannot move an open or half-open breaker."""

        def _done(f: Future) -> None:
            try:
                if f.cancelled():
                    breaker.record_abandoned(token)
                    return
                exc = f.exception()
                if exc is None:
                    breaker.record_success(token)
                    self.monitor.record(True)
                elif getattr(exc, "_metran_infra_refusal", False):
                    breaker.record_abandoned(token)
                else:
                    breaker.record_failure(token)
                    self.monitor.record(False)
                    self._count(f"{kind}_errors")
            except Exception:  # outcome telemetry must not kill resolvers
                logger.exception("outcome telemetry failed")

        fut.add_done_callback(_done)

    def update(self, model_id: str, new_obs,
               deadline: Optional[float] = "default") -> PosteriorState:
        """Assimilate ``new_obs`` ((k, n_series), data units, NaN =
        missing) and return the bumped :class:`PosteriorState`."""
        return self._call(
            "update", model_id,
            lambda: self.update_async(model_id, new_obs), deadline,
        )

    def update_async(self, model_id: str,
                     new_obs) -> "Future[PosteriorState]":
        state = self._known_state("update", model_id)
        new_obs = np.atleast_2d(np.asarray(new_obs, float))
        if new_obs.shape[1] != state.n_series:
            self._count("validation_errors")
            raise ValueError(
                f"new_obs has {new_obs.shape[1]} series, model "
                f"{model_id!r} has {state.n_series}"
            )
        if np.isinf(new_obs).any():
            # NaN marks a missing observation; an infinity is never data
            self._count("validation_errors")
            raise ValueError(
                f"new_obs for model {model_id!r} contains infinite "
                "values; use NaN to mark missing observations"
            )
        breaker, token = self._admit(model_id)
        mask = np.isfinite(new_obs)
        n_masked = int(mask.size - np.count_nonzero(mask))
        if n_masked:
            self._count("masked_values", n_masked)
        y_std = np.where(
            mask, (new_obs - state.scaler_mean) / state.scaler_std, 0.0
        )
        bucket = self.registry.bucket_of(state)
        key = ("update", bucket, new_obs.shape[0])
        try:
            out = self._enqueue_update(model_id, key, (y_std, mask),
                                       time.monotonic())
        except BaseException:
            breaker.record_abandoned(token)  # the batcher refused it
            raise
        self._observe(out, "update", breaker, token)
        # drop the ordering entry once resolved (registered outside
        # _order_lock: a done future runs the callback inline)
        out.add_done_callback(lambda _f: self._forget_entry(model_id, out))
        return out

    def _call(self, kind: str, model_id: str, submit, deadline):
        """Sync-call engine: a hard deadline and bounded retries.  A
        failed attempt is retried (after the policy's backoff, inside
        the deadline) only when :func:`~metran_tpu_torch.reliability.
        is_retryable` allows it — an exception outcome of a dispatch
        means nothing was applied; a deadline hit is final."""
        pol = self.reliability
        deadline_s = pol.deadline_s if deadline == "default" else deadline
        t_end = None if deadline_s is None else pol.clock() + deadline_s
        attempt = 0
        while True:
            attempt += 1
            failure = None
            try:
                fut = submit()
            except BaseException as exc:
                failure = exc
            if failure is None:
                try:
                    return self._resolve(fut, t_end)
                except _FutureTimeout as exc:
                    if (fut.done() and not fut.cancelled()
                            and fut.exception() is exc):
                        failure = exc  # the dispatch raised a TimeoutError
                    else:
                        in_flight = not fut.cancel()
                        self._count("deadline_exceeded")
                        self.monitor.record(False)
                        raise DeadlineExceededError(
                            kind, model_id, deadline_s, in_flight=in_flight
                        ) from None
                except BaseException as exc:
                    failure = exc
            if is_retryable(failure) and attempt < pol.retry.max_attempts:
                delay = pol.retry.delay(attempt)
                if t_end is None or pol.clock() + delay < t_end:
                    self._count("retries")
                    logger.warning(
                        "retrying %s for model %r (attempt %d) after: %s",
                        kind, model_id, attempt, failure,
                    )
                    pol.sleep(delay)
                    continue
            raise failure

    def _resolve(self, fut: Future, t_end: Optional[float] = None):
        """Wait for a sync call's future; in manual-flush mode nobody
        else dispatches, so drain the batcher first (a pass at a time:
        a deferred update enters it only once its predecessor
        resolved).  ``t_end`` is an instant on the policy's clock."""
        clock = self.reliability.clock
        if self.batcher.flush_deadline is None:
            while not fut.done():
                if t_end is not None and clock() >= t_end:
                    break
                if self.batcher.flush() == 0:
                    break
        if t_end is None:
            return fut.result()
        return fut.result(timeout=max(t_end - clock(), 0.0))

    # ------------------------------------------------------------------
    # per-model ordering
    # ------------------------------------------------------------------
    def _forget_entry(self, model_id, future) -> None:
        """Drop a RESOLVED entry from ``_last_update``, reinstating the
        nearest unresolved ancestor when one is still pending."""
        with self._order_lock:
            cur = self._last_update.get(model_id)
            if cur is None or cur.future is not future:
                return
            anc = cur.prior
            while anc is not None and anc.future.done():
                anc = anc.prior
            if anc is not None:
                self._last_update[model_id] = anc
            else:
                del self._last_update[model_id]

    def _enqueue_update(self, model_id, key, payload, t_submit) -> Future:
        """Enqueue one validated update, preserving per-model order:
        join the predecessor's still-pending batcher group when both
        share a batch key, else chain on the predecessor's future."""
        fut = _ChainedFuture()
        with self._order_lock:
            prior = self._last_update.get(model_id)
            while prior is not None and prior.future.done():
                prior = prior.prior
            join = (
                prior.group
                if prior is not None and prior.key == key else None
            )
            entry = _PendingUpdate(key, fut, prior=prior)
            self._last_update[model_id] = entry
        if prior is None:
            self._attach_and_wire(entry, model_id, payload, t_submit)
            return fut
        if join is not None:
            outcome = self._attach_and_wire(
                entry, model_id, payload, t_submit, join=join
            )
            if outcome != "join_missed":
                return fut

        def _enqueue(prior_done):
            if fut.done():
                return
            if prior_done.cancelled():
                # a cancelled link had no side effect: re-defer on the
                # nearest live ancestor so this update cannot overtake it
                anc = entry.prior
                while anc is not None:
                    if anc.future.cancelled():
                        anc = anc.prior
                        continue
                    if not anc.future.done():
                        anc.future.add_done_callback(_enqueue)
                        return
                    if anc.future.exception() is not None:
                        prior_done = anc.future
                    break
            if (
                not prior_done.cancelled()
                and prior_done.exception() is not None
            ):
                # the predecessor was not applied: applying this one
                # would skip observations mid-stream
                self._count("chain_failures")
                try:
                    fut.set_exception(ChainedRequestError(
                        f"update for model {model_id!r} not applied: its "
                        f"predecessor failed ({prior_done.exception()!r})"
                    ))
                except Exception:  # raced with a cancel
                    pass
                return
            try:
                self._attach_and_wire(entry, model_id, payload, t_submit)
            except BaseException:  # e.g. batcher closed
                return  # fut already resolved with the failure

        prior.future.add_done_callback(_enqueue)
        return fut

    def _attach_and_wire(self, entry, model_id, payload, t_submit,
                         join=None) -> str:
        """Submit the entry's update through its future's cancel-atomic
        ``attach_inner``.  Returns ``"enqueued"``, ``"cancelled"`` or
        ``"join_missed"``; a batcher refusal resolves the entry with the
        failure before re-raising, so successors chain-break."""
        fut = entry.future
        try:
            out = fut.attach_inner(
                lambda: self.batcher.submit_tracked(
                    entry.key, model_id, payload, join=join,
                    enqueued_at=t_submit,
                )
            )
        except BaseException as exc:
            try:
                # an infrastructure refusal, not the model's failure:
                # _observe books no breaker verdict for it
                exc._metran_infra_refusal = True
            except Exception:  # an exception without attribute support
                pass
            try:
                if not fut.done():
                    fut.set_exception(exc)
            except Exception:  # raced with a cancel
                pass
            self._forget_entry(model_id, fut)
            raise
        if out is None:
            return "cancelled"
        inner, group = out
        if inner is None:
            return "join_missed"
        entry.group = group
        inner.add_done_callback(lambda f: _transfer(f, fut))
        return "enqueued"

    def flush(self) -> int:
        """Dispatch everything pending now, draining deferred same-model
        follow-ups too."""
        total = 0
        while True:
            n = self.batcher.flush()
            total += n
            if n == 0:
                return total

    # ------------------------------------------------------------------
    # bulk API (the arena's native path; per-request on a dict registry)
    # ------------------------------------------------------------------
    def update_batch(self, model_ids, new_obs) -> list:
        """One fleet tick: ``k`` rows for G distinct models, ``new_obs``
        (G, k, n) or a sequence of (k, n_i) arrays (data units, NaN =
        missing).  Returns one entry per model, in order: an
        :class:`ArenaUpdateAck` on an arena registry (one dispatch per
        bucket, validation and standardization vectorized against the
        arena's host mirrors), a :class:`PosteriorState` on a dict
        registry (the per-request path), or the exception that failed
        that model alone.  Per-model ordering against concurrently
        in-flight async updates of the same model is not chained here —
        a fleet feed owns its tick ordering."""
        ids = [str(m) for m in model_ids]
        if len(set(ids)) != len(ids):
            raise ValueError(
                "update_batch model_ids must be distinct (duplicate "
                "ticks for one model have no defined order inside one "
                "dispatch)"
            )
        if isinstance(new_obs, np.ndarray) and new_obs.ndim == 3:
            obs_list = list(np.asarray(new_obs, float))
        else:
            obs_list = [np.atleast_2d(np.asarray(o, float)) for o in new_obs]
        if len(obs_list) != len(ids):
            raise ValueError(
                f"got {len(ids)} model_ids but {len(obs_list)} "
                "observation blocks"
            )
        ks = {o.shape[0] for o in obs_list}
        if len(ks) > 1:
            raise ValueError(
                "all observation blocks in one tick must append the "
                f"same k rows; got {sorted(ks)}"
            )
        if self.registry.arena_enabled:
            return self._update_batch_arena(ids, obs_list)
        return self._batch_via_requests(
            ids, [("update", o) for o in obs_list]
        )

    def forecast_batch(self, model_ids, steps: int) -> list:
        """Forecast G models ``steps`` periods ahead; one
        :class:`Forecast` or exception per model, in order (one K18
        launch per bucket on an arena registry).  With the read path
        armed the snapshot pass comes first: hits are answered from host
        memory and only the misses dispatch, so a warm fleet tick
        launches nothing."""
        ids = [str(m) for m in model_ids]
        steps = int(steps)
        if steps < 1:
            self._count("validation_errors")
            raise ValueError(f"forecast steps must be >= 1, got {steps}")
        rp = self.readpath
        if rp is None:
            return self._forecast_batch_compute(ids, steps)
        results: list = [None] * len(ids)
        miss = []
        for i, mid in enumerate(ids):
            entry = rp.read(mid, steps)
            if entry is not None:
                results[i] = self._cached_forecast(entry, steps)
            else:
                miss.append(i)
        if miss:
            computed = self._forecast_batch_compute([ids[i] for i in miss],
                                                    steps)
            for i, res in zip(miss, computed):
                results[i] = res
        return results

    def _forecast_batch_compute(self, ids, steps: int) -> list:
        """The dispatching half of :meth:`forecast_batch` (its misses, or
        the whole batch with the read path off)."""
        if self.registry.arena_enabled:
            return self._forecast_batch_arena(ids, steps)
        return self._batch_via_requests(ids, [("forecast", steps)] * len(ids))

    def _batch_via_requests(self, ids, specs) -> list:
        futs: list = []
        for mid, spec in zip(ids, specs):
            try:
                if spec[0] == "update":
                    futs.append(self.update_async(mid, spec[1]))
                else:
                    futs.append(self._forecast_async_compute(mid, spec[1]))
            except Exception as exc:  # noqa: BLE001 - per-slot channel
                futs.append(exc)
        if self.batcher.flush_deadline is None:
            self.flush()
        out: list = []
        for f in futs:
            if isinstance(f, Exception):
                out.append(f)
                continue
            try:
                out.append(f.result(timeout=self.deadline_s))
            except Exception as exc:  # noqa: BLE001 - per-slot channel
                out.append(exc)
        return out

    def close(self) -> None:
        """Drain everything pending, then refuse new submissions.  On an
        arena registry (with ``persist_updates``) the dirty rows then
        spill to disk, so the next process warm-starts from them."""
        self.batcher.close()
        if self.readpath is not None:
            # detach the store's invalidation hook: a registry that
            # outlives this service must not call into it after close
            self.registry.remove_commit_hook(self.readpath.note_commit)
        if self.registry.arena_enabled and self.persist_updates:
            try:
                self.registry.spill(dirty_only=True)
            except Exception:  # pragma: no cover - disk trouble
                # counted, not swallowed: a failed close-time spill IS
                # lost durability
                self._count("spill_failures")
                logger.exception("arena spill on close failed")

    def __enter__(self) -> "MetranService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # dispatch (runs on the batcher's flushing thread)
    # ------------------------------------------------------------------
    def _dispatch(self, batch_key, requests):
        kind, bucket, horizon = batch_key
        if kind == "forecast":
            return self._run_forecast(bucket, int(horizon), requests)
        if kind != "update":  # pragma: no cover - service-built keys
            raise ValueError(f"unknown dispatch kind {kind!r}")
        # several updates for one model in one batch chain in rounds:
        # round r carries each model's r-th request, one launch each
        rounds: list = []
        seen: dict = {}
        for pos, req in enumerate(requests):
            r = seen.get(req.model_id, 0)
            seen[req.model_id] = r + 1
            while len(rounds) <= r:
                rounds.append([])
            rounds[r].append(pos)
        results = [None] * len(requests)
        with self._update_lock:
            failed = None
            broken: set = set()  # models whose per-slot chain broke
            for positions in rounds:
                if failed is not None:
                    # earlier rounds were applied; fail only the rest
                    for p in positions:
                        self._count("chain_failures")
                        results[p] = ChainedRequestError(
                            f"update for model "
                            f"{requests[p].model_id!r} not applied: an "
                            f"earlier update in this batch failed "
                            f"({failed!r})"
                        )
                    continue
                live = []
                for p in positions:
                    if requests[p].model_id in broken:
                        self._count("chain_failures")
                        results[p] = ChainedRequestError(
                            f"update for model {requests[p].model_id!r} "
                            "not applied: an earlier update in this "
                            "batch failed"
                        )
                    else:
                        live.append(p)
                if not live:
                    continue
                try:
                    round_results = self._run_update(
                        bucket, int(horizon), [requests[p] for p in live]
                    )
                except BaseException as exc:  # noqa: BLE001
                    failed = exc
                    for p in live:
                        results[p] = failed
                    continue
                for p, res in zip(live, round_results):
                    results[p] = res
                    if isinstance(res, BaseException):
                        broken.add(requests[p].model_id)
        return results

    def _lookup_states(self, requests, results):
        """Per-request registry reads; an unreadable model fails its own
        slot and leaves the batch serviceable."""
        states, live = [], []
        for j, req in enumerate(requests):
            try:
                states.append(self.registry.get(req.model_id))
                live.append(j)
            except Exception as exc:  # noqa: BLE001 - per-slot channel
                self._count("lookup_failures")
                results[j] = exc
        return states, live

    def _run_forecast(self, bucket, steps: int, requests):
        """One batched forecast (one K2 launch); a slot whose moments
        come out non-finite fails alone."""
        if self.registry.arena_enabled:
            return self._run_forecast_arena(bucket, steps, requests)
        results: list = [None] * len(requests)
        states, live = self._lookup_states(requests, results)
        if not live:
            return results
        batch = stack_bucket(states, bucket, device=self.device)
        fn = self.registry.forecast_fn(bucket, steps)
        means, variances = fn(batch.ss, batch.mean, batch.cov)
        means, variances = means.cpu().numpy(), variances.cpu().numpy()
        for i, (st, j) in enumerate(zip(states, live)):
            n = st.n_series
            m = means[i, :, :n]
            v = variances[i, :, :n]
            if not (np.all(np.isfinite(m)) and np.all(np.isfinite(v))):
                self._count("poisoned_forecasts")
                results[j] = StateIntegrityError(
                    f"forecast for model {st.model_id!r} produced "
                    "non-finite moments (poisoned posterior state)"
                )
                continue
            results[j] = Forecast(
                means=m * st.scaler_std + st.scaler_mean,
                variances=v * st.scaler_std**2,
                names=st.names,
                version=st.version,
            )
        return results

    def _run_update(self, bucket, k: int, requests):
        """One batched assimilation over distinct-model requests; reads
        each model's current state, writes the bumped one.  Callers hold
        ``_update_lock``.  Returns one result per request (a state, or
        the exception that request failed with).

        With steady-state serving armed, FROZEN models ride the
        mean-only steady update first (:meth:`_run_update_steady`); any
        of them that broke time-invariance, whose posterior was replaced
        under the frozen gain, or that is an armed robust model thaw and
        replay through the exact update in this same dispatch, and the
        exact slots that converged freeze after it
        (:meth:`_run_update_dict`).  An arena registry runs
        :meth:`_run_update_arena`."""
        if self.registry.arena_enabled:
            return self._run_update_arena(bucket, k, requests)
        if not self.steady.enabled:
            return self._run_update_dict(bucket, k, requests)
        results: list = [None] * len(requests)
        steady_idx, exact_idx = [], []
        rob_on = self.robust.time_varying
        for j, req in enumerate(requests):
            if req.model_id not in self._steady_info:
                exact_idx.append(j)
                continue
            if rob_on:
                # an armed robust model is time-varying (a flagged slot's
                # MAP conditioning changes the gain): thaw it before the
                # frozen update can serve it, and replay exact
                try:
                    st = self.registry.get(req.model_id)
                except Exception:  # noqa: BLE001 - the lookup fails below
                    st = None
                if st is not None and st.t_seen >= self.robust.min_seen:
                    self._thaw_dict(req.model_id, reason="robust_armed")
                    exact_idx.append(j)
                    continue
            steady_idx.append(j)
        if steady_idx:
            thawed = self._run_update_steady(bucket, k, requests,
                                             steady_idx, results)
            exact_idx = sorted(exact_idx + thawed)
        if exact_idx:
            sub = [requests[j] for j in exact_idx]
            for j, res in zip(exact_idx,
                              self._run_update_dict(bucket, k, sub)):
                results[j] = res
        return results

    def _run_update_steady(self, bucket, k: int, requests, idxs,
                           results) -> list:
        """Dispatch the FROZEN models of one batch through the steady
        update (one K14 launch, + one K13 with detection); fills
        ``results`` at ``idxs`` and returns the positions that must
        replay through the exact update: rows that broke
        time-invariance, and frozen states that no longer match the
        stored posterior (an external ``registry.put``)."""
        sub = [requests[j] for j in idxs]
        local: list = [None] * len(sub)
        states, live = self._lookup_states(sub, local)
        thawed, keep = [], []
        for i, j in enumerate(live):
            st = states[i]
            info = self._steady_info.get(st.model_id)
            if (info is None or info.version != st.version
                    # identity, not equality: an external put carries
                    # fresh arrays even at the frozen version number;
                    # only the service's own st._replace commits keep
                    # these objects
                    or st.params is not info.params_ref
                    or st.loadings is not info.loadings_ref):
                self._thaw_dict(st.model_id, reason="posterior_replaced")
                thawed.append(idxs[j])
            else:
                keep.append((i, j, info))
        for j, res in zip(idxs, local):
            if res is not None:
                results[j] = res
        if not keep:
            return thawed
        kstates = [states[i] for i, _, _ in keep]
        batch = stack_bucket(kstates, bucket, device=self.device,
                             factors=False)
        n_pad = bucket[0]
        dtype = kstates[0].dtype
        kg = np.stack([info.kgain for _, _, info in keep]).astype(dtype)
        fd = np.stack([info.fdiag for _, _, info in keep]).astype(dtype)
        y = np.zeros((len(kstates), k, n_pad), dtype)
        m = np.zeros((len(kstates), k, n_pad), bool)
        for i, st in enumerate(kstates):
            y_std, mask = sub[keep[i][1]].payload
            y[i, :, : st.n_series] = y_std
            m[i, :, : st.n_series] = mask
        real = (np.arange(n_pad)[None, :]
                < np.array([st.n_series for st in kstates])[:, None])
        gated = self.gate.enabled
        det = self.detect if self.detect.enabled else None
        rp = self.readpath
        fn = self.registry.steady_update_fn(
            bucket, k, gate=self.gate if gated else None,
            horizons=self.horizons if rp is not None else None, detect=det)

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        def flags(floor):
            return dev(np.array([st.t_seen >= floor for st in kstates],
                                bool))

        args = (batch.ss, batch.mean, dev(kg), dev(fd), dev(real), dev(y),
                dev(m))
        if det is not None:
            # the detect signature always carries the gate's armed flags
            # (zeros with the gate off) and the detector state
            det_state = self.detector.stack(
                [st.model_id for st in kstates],
                [st.version for st in kstates], n_pad, DETECT_STATE_ROWS,
                dtype)
            args += (flags(self.gate.min_seen) if gated
                     else dev(np.zeros(len(kstates), bool)),
                     dev(det_state), flags(det.min_seen))
        elif gated:
            args += (flags(self.gate.min_seen),)
        outs = _host(fn(*args))
        if det is not None:
            det_new, det_counts, det_stats = outs[-3:]
            outs = outs[:-3]
        fm_t = None
        if rp is not None:
            fm_t, outs = outs[-1], outs[:-1]
        snap_entries: list = []
        mean_t, broke = outs[0], outs[3]
        for i, (si, j, info) in enumerate(keep):
            st = states[si]
            try:
                if broke[i]:
                    # time-invariance broke (a missing slot, a gate hit, a
                    # non-finite mean): nothing was applied — thaw and
                    # replay through the exact update
                    self._thaw_dict(st.model_id,
                                    reason="time_invariance_broken")
                    thawed.append(idxs[j])
                    continue
                n = st.n_series
                if gated:
                    self._book_gate_verdicts(st, outs[4][i, :, :n],
                                             outs[5][i, :, :n])
                idx = state_slot_index(n, st.n_factors, n_pad)
                # frozen: the covariance (and factor) stays as stored
                new_state = st._replace(
                    version=st.version + 1, t_seen=st.t_seen + k,
                    mean=mean_t[i][idx].astype(st.dtype))
                self._steady_info[st.model_id] = info._replace(
                    version=new_state.version)
                try:
                    self.registry.put(new_state,
                                      persist=self.persist_updates)
                except Exception:
                    self._count("persist_failures")
                    logger.exception(
                        "write-through persist failed for model %r "
                        "(serving from memory)", st.model_id)
            except Exception as exc:
                self._count("finalize_failures")
                logger.exception("steady finalize failed for model %r; its "
                                 "update was not applied", st.model_id)
                results[idxs[j]] = exc
                continue
            results[idxs[j]] = new_state
            self._observe_smoother(
                st.model_id, y[i, :, :n], m[i, :, :n], new_state.t_seen,
                lambda ns=new_state: ns,
                verdicts=outs[5][i, :, :n] if gated else None)
            if det is not None:
                try:
                    self._book_detect(
                        st.model_id, det_counts[i][:, :n],
                        det_stats[i][:, :n], new_state.version,
                        new_state.t_seen, st.names, n,
                        state=det_new[i][:, :n])
                except Exception:
                    logger.exception("detection booking failed for model "
                                     "%r", st.model_id)
            if rp is not None and info.hvars is not None:
                # the means of this commit; the variances frozen at freeze
                snap_entries.append(self._snapshot_entry(
                    new_state, fm_t[i][:, :n], info.hvars))
        self._publish_entries(snap_entries)
        return thawed

    def _run_update_dict(self, bucket, k: int, requests):
        """One batched exact assimilation over distinct-model requests:
        one launch of the registry engine's update (K1 joint, K12
        sequential, gated or robust, K9 square-root, gated or robust),
        plus one detector launch (K13) with detection armed.  Gate and
        robust verdicts are booked per slot before the integrity gate; a
        slot whose posterior fails that gate gets
        :class:`StateIntegrityError` and its stored state stays as it
        was, while the healthy slots commit.  With steady-state serving
        armed, every committed slot that converged (its factor moved by
        at most ``tol`` over a fully-observed append, past ``min_seen``,
        with no verdict and no armed robust likelihood, and past the
        refreeze cooldown) freezes after the commits."""
        results: list = [None] * len(requests)
        states, live = self._lookup_states(requests, results)
        if not live:
            return results
        # square-root registries assimilate in factored form: the kernel
        # carries Cholesky factors, the posterior gate collapses to a
        # finiteness check (PSD by construction), and a covariance-form
        # state is migrated to a factor once (stack_bucket) and stays
        # factored thereafter
        sqrt_engine = self.registry._sqrt_engine
        batch = stack_bucket(states, bucket, device=self.device,
                             sqrt=sqrt_engine)
        n_pad = bucket[0]
        dtype = states[0].dtype
        y = np.zeros((len(states), k, n_pad), dtype)
        m = np.zeros((len(states), k, n_pad), bool)
        for i, st in enumerate(states):
            y_std, mask = requests[live[i]].payload
            y[i, :, : st.n_series] = y_std
            m[i, :, : st.n_series] = mask
        gated = self.gate.enabled
        rob = self.robust if self.robust.enabled else None
        det = self.detect if self.detect.enabled else None
        rp = self.readpath
        # a horizons set selects the commit-time forecast pass: the update
        # appends the (B, H, N) moments of the NEW posteriors (one K2 launch
        # after it on the same stream)
        fn = self.registry.update_fn(
            bucket, k, gate=self.gate if gated else None,
            horizons=self.horizons if rp is not None else None,
            detect=det, robust=rob)

        def flags(floor):
            # per model: armed once it has assimilated `floor` steps (a
            # cold filter's innovations are over-dispersed)
            return torch.tensor([st.t_seen >= floor for st in states],
                                dtype=torch.bool, device=self.device)

        extra = (flags(self.gate.min_seen),) if gated else ()
        if rob is not None:
            # the per-model arming, and the per-slot likelihood
            # parameters standardized through each model's scaler (the
            # spec's physical rails and quantum, the update's
            # standardized units), in one vectorized pass
            armed_rb = [st.t_seen >= rob.min_seen for st in states]
            extra = (flags(rob.min_seen),
                     *self._robust_params(rob, states, n_pad, dtype))
        if det is not None:
            # each model's carried detector state, zeroed for first-touch
            # models and on version discontinuities (an external put)
            det_state = self.detector.stack(
                [st.model_id for st in states],
                [st.version for st in states], n_pad, DETECT_STATE_ROWS,
                dtype)
            extra += (torch.from_numpy(det_state).to(self.device),
                      flags(det.min_seen))
        outs = _host(fn(
            batch.ss, batch.mean, batch.chol if sqrt_engine else batch.cov,
            torch.from_numpy(y).to(self.device),
            torch.from_numpy(m).to(self.device), *extra))
        if det is not None:
            det_new, det_counts, det_stats = outs[-3:]
            outs = outs[:-3]
        fm_t = fv_t = None
        if rp is not None:
            fm_t, fv_t = outs[-2:]
            outs = outs[:-2]
        snap_entries: list = []
        mean_t, fac_t, sigma_t, detf_t = outs[:4]
        verdict_t = outs[5] if (gated or rob is not None) else None
        validate = self.reliability.validate_updates
        steady_on = self.steady.enabled
        if steady_on:
            # host-side convergence detection on the stacked factors
            fac_before = (batch.chol if sqrt_engine
                          else batch.cov).cpu().numpy()
            real = np.zeros((len(states), n_pad), bool)
            for i, st in enumerate(states):
                real[i, : st.n_series] = True
            converged = steady_converged(fac_before, fac_t, m, real,
                                         self.steady.tol).numpy()
        candidates = []
        for i, (st, j) in enumerate(zip(states, live)):
            # per-slot finalize: a failure here stays this slot's alone
            try:
                if gated:
                    # the observations were evaluated either way: a dying
                    # sensor shows in the rejection window even while its
                    # tempered updates keep committing
                    self._book_gate_verdicts(
                        st, outs[4][i, :, : st.n_series],
                        outs[5][i, :, : st.n_series])
                elif rob is not None:
                    # robust outcomes book in the same position, for the
                    # same reason
                    self._book_robust(
                        st, armed_rb[i], outs[4][i, :, : st.n_series],
                        outs[5][i, :, : st.n_series],
                        outs[6][i, :, : st.n_series])
                idx = state_slot_index(st.n_series, st.n_factors, n_pad)
                mean_i = mean_t[i][idx].astype(st.dtype)
                if sqrt_engine:
                    # the slot submatrix of the factor IS the factor of
                    # the slot submatrix (padding decouples exactly); the
                    # covariance is reconstituted for consumers, the
                    # factor persists and carries forward
                    chol_i = fac_t[i][np.ix_(idx, idx)].astype(st.dtype)
                    cov_i = chol_i @ chol_i.T
                else:
                    chol_i = None
                    cov_i = fac_t[i][np.ix_(idx, idx)].astype(st.dtype)
                # a degraded filter step books detf = +inf: the rows
                # were NOT assimilated, so the slot must not commit
                if not validate:
                    fault = None
                elif np.all(np.isfinite(detf_t[i])) and np.all(
                    np.isfinite(sigma_t[i])
                ):
                    fault = posterior_fault(mean_i, cov_i, chol=chol_i)
                else:
                    fault = (
                        "non-finite likelihood step (degraded filter "
                        "update; observation not assimilated)"
                    )
                if fault is not None:
                    self._count("poisoned_updates")
                    logger.error("rejecting update for model %r: %s",
                                 st.model_id, fault)
                    results[j] = StateIntegrityError(
                        f"update for model {st.model_id!r} produced an "
                        f"invalid posterior ({fault}); the request was "
                        "not applied and the stored state is unchanged"
                    )
                    continue
                # chol_i is None on the joint engine, which also drops any
                # stale factor a square-root state carried
                new_state = st._replace(
                    version=st.version + 1, t_seen=st.t_seen + k,
                    mean=mean_i, cov=cov_i, chol=chol_i,
                )
                try:
                    self.registry.put(new_state,
                                      persist=self.persist_updates)
                except Exception:
                    # memory is written before disk: the update IS
                    # applied, only its write-through failed
                    self._count("persist_failures")
                    logger.exception(
                        "write-through persist failed for model %r "
                        "(serving from memory)", st.model_id,
                    )
                if not m[i].any():
                    self._count("empty_updates")
            except Exception as exc:
                self._count("finalize_failures")
                logger.exception("finalize failed for model %r; its update "
                                 "was not applied", st.model_id)
                results[j] = exc
                continue
            results[j] = new_state
            n = st.n_series
            self._observe_smoother(
                st.model_id, y[i, :, :n], m[i, :, :n], new_state.t_seen,
                lambda ns=new_state: ns,
                verdicts=None if verdict_t is None else verdict_t[i, :, :n])
            if det is not None:
                # its own guard: the update is applied, and a monitoring
                # hiccup must never relabel it failed
                try:
                    self._book_detect(
                        st.model_id, det_counts[i][:, :n],
                        det_stats[i][:, :n], new_state.version,
                        new_state.t_seen, st.names, n,
                        state=det_new[i][:, :n])
                except Exception:
                    logger.exception("detection booking failed for model "
                                     "%r", st.model_id)
            if steady_on and st.model_id not in self._steady_info:
                if (converged[i]
                        and new_state.t_seen >= self.steady.min_seen
                        and (not gated or not verdict_t[i].any())
                        and not (rob is not None and rob.time_varying
                                 and new_state.t_seen >= rob.min_seen)
                        and self._steady_freezable(st.model_id)):
                    delta = float(np.max(np.abs(fac_t[i] - fac_before[i])))
                    candidates.append((new_state, delta))
            if rp is not None:
                snap_entries.append(self._snapshot_entry(
                    new_state, fm_t[i][:, :n], fv_t[i][:, :n]))
        if candidates:
            self._freeze(candidates, bucket)
        # published after the commits and before the callers' futures
        # resolve: read-your-writes for acknowledged updates
        self._publish_entries(snap_entries)
        return results

    @staticmethod
    def _snapshot_entry(state, fm, fv) -> SnapshotEntry:
        """One committed dict-path slot's snapshot entry: its (H, n)
        standardized moments de-standardized exactly as the compute path
        does (:meth:`_run_forecast`)."""
        return SnapshotEntry(
            model_id=state.model_id, version=state.version,
            means=fm * state.scaler_std + state.scaler_mean,
            variances=fv * state.scaler_std**2, names=state.names,
            published_at=0.0)  # stamped at publish

    def _publish_entries(self, entries) -> None:
        """Publish a dispatch's entries.  Cache only: the updates are
        applied, so a failure here is logged, never raised."""
        if not entries:
            return
        try:
            self.readpath.publish_entries(entries)
        except Exception:  # pragma: no cover - cache only
            logger.exception("snapshot publish failed (cache only)")

    # ------------------------------------------------------------------
    # the state arena: rows in, acks out — the posterior stays on device
    # ------------------------------------------------------------------
    def _lookup_rows(self, requests, results):
        """Per-request row resolution on an arena registry: make each
        model resident and collect its row and metadata, every resolved
        row PINNED (``registry.rows_for(pin=True)``) so neither a colder
        model later in the batch nor a concurrent load can reassign it.
        A model that cannot be made resident fails its own slot.  Callers
        ``registry.release_rows`` the returned ``pinned`` list in a
        ``finally``."""
        ids = [req.model_id for req in requests]
        hits, errs = self.registry.rows_for(ids, pin=True)
        rows, metas, live, pinned = [], [], [], []
        for j, (hit, err) in enumerate(zip(hits, errs)):
            if err is None:
                rows.append(hit[1])
                metas.append(self.registry.meta(ids[j]))
                live.append(j)
                pinned.append(ids[j])
            else:
                self._count("lookup_failures")
                results[j] = err
        return rows, metas, live, pinned

    def _arena_forecasts(self, metas, means, variances, versions):
        """The de-standardized :class:`Forecast` (or the integrity error)
        of each queried row."""
        validate = self.reliability.validate_updates
        out = []
        for i, meta in enumerate(metas):
            n = meta.n_series
            m = means[i, :, :n]
            v = variances[i, :, :n]
            if validate and not (np.all(np.isfinite(m))
                                 and np.all(np.isfinite(v))):
                self._count("poisoned_forecasts")
                out.append(StateIntegrityError(
                    f"forecast for model {meta.model_id!r} produced "
                    "non-finite moments (poisoned posterior state)"))
                continue
            out.append(Forecast(
                means=m * meta.scaler_std + meta.scaler_mean,
                variances=v * meta.scaler_std**2, names=meta.names,
                version=int(versions[i])))
        return out

    def _arena_query(self, bucket, rows, steps: int):
        """One bucket's forecast query on pinned rows (one K18 launch):
        ``(means, variances, versions)`` on the host, the versions
        snapshotted under the arena lock with the moments."""
        arena = self.registry.arena_of(bucket)
        fn = self.registry.arena_forecast_fn(bucket, steps)
        # concurrent readers of one model share a flush: K18 takes each
        # row once (its launchers refuse a repeat), the answers fan out
        rows_arr, fan = np.unique(np.asarray(rows, np.int32),
                                  return_inverse=True)
        with arena.lock:
            out = arena.query(fn, rows_arr)
            versions = arena.version_host[rows_arr].copy()
        return (out[0].cpu().numpy()[fan], out[1].cpu().numpy()[fan],
                versions[fan])

    def _run_forecast_arena(self, bucket, steps: int, requests):
        """One batched arena forecast: a row gather and the closed-form
        horizon moments on the device (K18) — no stacking, no (B, S, S)
        transfer.  A slot whose moments come out non-finite fails
        alone."""
        results: list = [None] * len(requests)
        rows, metas, live, pinned = self._lookup_rows(requests, results)
        try:
            if not live:
                return results
            means, variances, versions = self._arena_query(bucket, rows,
                                                           steps)
        finally:
            self.registry.release_rows(pinned)
        for j, res in zip(live, self._arena_forecasts(metas, means,
                                                      variances, versions)):
            results[j] = res
        return results

    def _run_update_arena(self, bucket, k: int, requests):
        """One batched arena assimilation, in place: the requests' rows
        through the steady (K17) and exact (K16) kernels
        (:meth:`_arena_dispatch_rows`); a row the on-device integrity
        gate rejects is masked out of the scatter and its caller gets
        :class:`StateIntegrityError` with the row unchanged, while the
        others commit and resolve to :class:`ArenaUpdateAck`\\ s.  Runs
        under ``_update_lock``; a kernel failure marks the arena lost
        (the registry rebuilds it from last-good states on next
        touch)."""
        results: list = [None] * len(requests)
        rows, metas, live, pinned = self._lookup_rows(requests, results)
        try:
            if not live:
                return results
            arena = self.registry.arena_of(bucket)
            n_pad = bucket[0]
            y = np.zeros((len(live), k, n_pad), arena.dtype)
            m = np.zeros((len(live), k, n_pad), bool)
            for i, meta in enumerate(metas):
                y_std, mask = requests[live[i]].payload
                y[i, :, : meta.n_series] = y_std
                m[i, :, : meta.n_series] = mask
            ok, versions, t_seens, _zs, verdicts, _dc = (
                self._arena_dispatch_rows(
                    bucket, arena, np.asarray(rows, np.int32), y, m, k,
                    [mt.model_id for mt in metas], metas))
        finally:
            self.registry.release_rows(pinned)
        for i, (meta, j) in enumerate(zip(metas, live)):
            results[j] = self._arena_result(meta, ok[i], versions[i],
                                            t_seens[i], y[i], m[i],
                                            verdicts, i)
        return results

    def _arena_result(self, meta, ok: bool, version, t_seen, y, m,
                      verdicts, i: int):
        """One dispatched row's outcome: its ack (fixed-lag tracking fed
        from the materialized row), or the integrity error of a row the
        gate rejected."""
        if not ok:
            self._count("poisoned_updates")
            logger.error("rejecting arena update for model %r (row masked "
                         "out of the scatter)", meta.model_id)
            return StateIntegrityError(
                f"update for model {meta.model_id!r} produced an invalid "
                "posterior; the request was not applied and the arena row "
                "is unchanged")
        n = meta.n_series
        self._observe_smoother(
            meta.model_id, y[:, :n], m[:, :n], int(t_seen),
            lambda mid=meta.model_id: self.registry.get(mid),
            verdicts=None if verdicts is None else verdicts[i, :, :n])
        if not m.any():
            self._count("empty_updates")
        return ArenaUpdateAck(meta.model_id, int(version), int(t_seen))

    def _robust_slot_params(self, rob: RobustSpec, arena, rows, real):
        """The (G, N) ``rail_lo, rail_hi, quantum, scale`` of an arena
        dispatch, standardized per row through the arena's scaler
        mirrors (the rows are pinned, so the mirrors cannot move) as
        :meth:`_robust_params` forms them: padded slots (-inf, +inf,
        1)."""
        sm = arena.scaler_mean[rows]
        sd = arena.scaler_std[rows]
        dt = arena.dtype
        return (
            np.where(real, (rob.rail_lo - sm) / sd, -np.inf).astype(dt),
            np.where(real, (rob.rail_hi - sm) / sd, np.inf).astype(dt),
            np.where(real & (rob.quantum > 0.0), np.divide(rob.quantum, sd),
                     1.0).astype(dt),
            np.full(sd.shape, rob.scale, dt),
        )

    def _freeze_arena_rows(self, arena, bucket, rows, metas) -> None:
        """Freeze newly converged arena rows: their DARE solves and frozen
        gains (:meth:`_compute_steady`, K15), written into the steady
        leaves in one batch, their frozen horizon variances cached (read
        path), and the transitions booked.  Runs after the rows' updates
        committed, so a failure is logged, never raised (serving just
        stays exact)."""
        try:
            frozen = self._compute_steady(metas, bucket)
        except Exception:
            logger.exception("steady freeze failed for models %s (serving "
                             "stays exact)", [mt.model_id for mt in metas])
            return
        arena.freeze_rows(
            rows, np.stack([frozen[mt.model_id][0] for mt in metas]),
            np.stack([frozen[mt.model_id][1] for mt in metas]))
        for mt in metas:
            if frozen[mt.model_id][2] is not None:
                self._steady_hvars[mt.model_id] = frozen[mt.model_id][2]
            self._book_steady("freeze", mt.model_id, tol=self.steady.tol)

    def _arena_dispatch_rows(self, bucket, arena, rows_arr, y, m, k, ids,
                             metas):
        """One bucket group's rows through the steady and exact arena
        kernels — the dispatch engine of the per-request and bulk paths.
        Rows whose resident steady flag is set ride K17; any of them that
        broke time-invariance thaw and replay through K16 in this same
        call, and newly converged exact rows freeze afterward.  Each
        kernel's lock region spans the launch and the host-mirror commit;
        gate verdicts, robust outcomes and detection alarms are booked
        here for both paths.

        With the read path armed both kernels run their horizons modes,
        and the dispatch's snapshot is published after the commits and
        before the callers' futures resolve, while the pins still hold
        the rows (:meth:`_publish_arena_snapshot`); a frozen row rides
        K17 only while its frozen horizon variances are cached.

        Returns ``(ok, versions, t_seens, zs, verdicts, det_counts)``
        over the G rows (``zs``/``verdicts`` ``None`` when neither the
        gate nor a robust likelihood is armed, ``det_counts`` ``None``
        without detection)."""
        gate = self.gate
        gated = gate.enabled
        rob = self.robust if self.robust.enabled else None
        scored = gated or rob is not None
        validate = self.reliability.validate_updates
        det = self.detect if self.detect.enabled else None
        steady = self.steady if self.steady.enabled else None
        rp = self.readpath
        hz = self.horizons if rp is not None else None
        g = len(rows_arr)
        n_pad = bucket[0]
        ok = np.zeros(g, bool)
        versions = np.zeros(g, np.int64)
        t_seens = np.zeros(g, np.int64)
        zs = np.full((g, k, n_pad), np.nan) if scored else None
        verdicts = np.zeros((g, k, n_pad), np.int8) if scored else None
        iters = np.zeros((g, k, n_pad), np.int32) if rob is not None \
            else None
        armed_rb = (arena.t_seen_host[rows_arr] >= rob.min_seen
                    if rob is not None else None)
        det_counts = np.zeros((g, 3, n_pad), np.int64) if det else None
        det_stats = np.zeros((g, 3, n_pad)) if det else None
        if rp is not None:
            fm = np.zeros((g, len(self.horizons), n_pad), arena.dtype)
            fv = np.zeros_like(fm)
        n_sl = arena.n_series_host[rows_arr]
        real_all = np.arange(n_pad)[None, :] < n_sl[:, None]
        sel = np.zeros(g, bool)
        if steady is not None:
            sel = arena.steady_host[rows_arr].copy()
            if rob is not None and rob.time_varying and sel.any():
                # an armed robust row is time-varying by contract: thaw it
                # before the frozen kernel can serve it
                pos = np.flatnonzero(sel & armed_rb)
                if pos.size:
                    arena.thaw_rows(rows_arr[pos])
                    for gi in pos:
                        self._steady_hvars.pop(ids[gi], None)
                        self._book_steady("thaw", ids[gi],
                                          reason="robust_armed")
                    sel[pos] = False
            if rp is not None and sel.any():
                # a frozen row rides the frozen-gain path only while the
                # variance half of its snapshot is cached
                sel &= np.array([mid in self._steady_hvars for mid in ids])
        exact_pos = np.flatnonzero(~sel)
        if sel.any():
            s_pos = np.flatnonzero(sel)
            rows_s = rows_arr[s_pos]
            fn = self.registry.arena_steady_update_fn(
                bucket, k, gate=gate if gated else None, horizons=hz,
                detect=det)
            args = (rows_s, real_all[s_pos], y[s_pos], m[s_pos])
            with arena.lock:
                if det is not None:
                    outs = arena.apply_steady_det(
                        fn, *args, np.int32(gate.min_seen if gated else 0),
                        np.int32(det.min_seen))
                    outs, dc, dst = outs[:-2], outs[-2], outs[-1]
                elif gated:
                    outs = arena.apply_steady(fn, *args,
                                              np.int32(gate.min_seen))
                else:
                    outs = arena.apply_steady(fn, *args)
                if rp is not None:
                    outs, fm_s = outs[:-1], outs[-1]
                applied = outs[0].cpu().numpy()
                vers, ts = arena.commit_rows(rows_s, applied, k)
            ok[s_pos] = applied
            versions[s_pos] = vers
            t_seens[s_pos] = ts
            if rp is not None:
                fm[s_pos] = fm_s.cpu().numpy()
                for gi in s_pos:
                    fv[gi, :, :n_sl[gi]] = self._steady_hvars[ids[gi]]
            if det is not None:
                det_counts[s_pos] = dc.cpu().numpy()
                det_stats[s_pos] = dst.cpu().numpy()
            if gated:
                zs[s_pos] = outs[3].cpu().numpy()
                verdicts[s_pos] = outs[4].cpu().numpy()
            broke_pos = s_pos[~applied]
            if broke_pos.size:
                # the steady kernel refused these rows: thaw, and replay
                # them through the exact kernel from their unchanged rows
                arena.thaw_rows(rows_arr[broke_pos])
                for gi in broke_pos:
                    self._steady_hvars.pop(ids[gi], None)
                    self._book_steady("thaw", ids[gi],
                                      reason="time_invariance_broken")
                exact_pos = np.sort(np.concatenate([exact_pos, broke_pos]))
        if exact_pos.size:
            e_pos = exact_pos
            rows_e = rows_arr[e_pos]
            real_e = real_all[e_pos]
            fn = self.registry.arena_update_fn(
                bucket, k, gate=gate if gated else None, validate=validate,
                horizons=hz,
                steady_tol=steady.tol if steady is not None else 0.0,
                detect=det, robust=rob)
            base = (rows_e, y[e_pos], m[e_pos])
            with arena.lock:
                if rob is not None:
                    rob_args = self._robust_slot_params(rob, arena, rows_e,
                                                        real_e)
                    if det is not None:
                        outs = arena.apply_det(
                            fn, *base, np.int32(rob.min_seen), *rob_args,
                            real_e, np.int32(det.min_seen))
                    elif steady is not None:
                        outs = arena.apply(fn, *base, np.int32(rob.min_seen),
                                           *rob_args, real_e)
                    else:
                        outs = arena.apply(fn, *base, np.int32(rob.min_seen),
                                           *rob_args)
                elif det is not None:
                    outs = arena.apply_det(
                        fn, *base, np.int32(gate.min_seen if gated else 0),
                        real_e, np.int32(det.min_seen))
                elif gated and steady is not None:
                    outs = arena.apply(fn, *base, np.int32(gate.min_seen),
                                       real_e)
                elif gated:
                    outs = arena.apply(fn, *base, np.int32(gate.min_seen))
                elif steady is not None:
                    outs = arena.apply(fn, *base, real_e)
                else:
                    outs = arena.apply(fn, *base)
                if det is not None:
                    outs, dc, dst = outs[:-2], outs[-2], outs[-1]
                conv = None
                if steady is not None:
                    outs, conv = outs[:-1], outs[-1].cpu().numpy()
                if rp is not None:
                    outs, hz_e = outs[:-2], outs[-2:]
                ok_e = outs[0].cpu().numpy()
                vers, ts = arena.commit_rows(rows_e, ok_e, k)
            ok[e_pos] = ok_e
            versions[e_pos] = vers
            t_seens[e_pos] = ts
            if rp is not None:
                fm[e_pos], fv[e_pos] = _host(hz_e)
            if det is not None:
                det_counts[e_pos] = dc.cpu().numpy()
                det_stats[e_pos] = dst.cpu().numpy()
            if scored:
                zs[e_pos] = outs[3].cpu().numpy()
                verdicts[e_pos] = outs[4].cpu().numpy()
            if rob is not None:
                iters[e_pos] = outs[5].cpu().numpy()
            if conv is not None:
                # freeze detection: the device's conv flag (a rejected
                # row's delta is 0, hence the AND with ok) and the host
                # conditions
                cand = conv & ok_e & (t_seens[e_pos] >= steady.min_seen)
                if gated:
                    cand &= (verdicts[e_pos] == 0).all(axis=(1, 2))
                if rob is not None and rob.time_varying:
                    cand &= ~(t_seens[e_pos] >= rob.min_seen)
                cand &= ~arena.steady_host[rows_e]
                if cand.any():
                    cand &= np.array([self._steady_freezable(ids[gi])
                                      for gi in e_pos])
                if cand.any():
                    self._freeze_arena_rows(
                        arena, bucket, rows_e[cand],
                        [metas[gi] for gi in e_pos[cand]])
        if rp is not None:
            self._publish_arena_snapshot(bucket, arena, rows_arr, versions,
                                         fm, fv, ids, metas)
        if gated:
            self._book_gate_verdicts_bulk(ids, zs, verdicts, n_sl)
        if rob is not None and g:
            self._book_robust_rows(ids, metas, armed_rb, zs, verdicts,
                                   iters, n_sl)
        if det is not None and det_counts.any():
            self._book_detect_rows(ids, metas, rows_arr, ok, versions,
                                   t_seens, det_counts, det_stats, arena)
        return ok, versions, t_seens, zs, verdicts, det_counts

    def _publish_arena_snapshot(self, bucket, arena, rows_arr, versions,
                                fm, fv, ids, metas) -> None:
        """Publish one arena dispatch's commit-time moments as a
        per-bucket :class:`~metran_tpu_torch.serve.readpath.
        ForecastSnapshot`: ``fm``/``fv`` (G, H, n_pad) standardized, of
        each row as written, de-standardized in one vectorized pass off
        the arena's host scaler mirrors (in the precision the compute
        path's per-row pass promotes to, so a hit equals it bit for bit;
        the rows are pinned, so no re-pack moves the mirrors).  Cache
        only: a failure is logged, never raised — the updates are
        committed."""
        try:
            dt = np.result_type(arena.dtype,
                                *{mt.scaler_std.dtype for mt in metas})
            sm = arena.scaler_mean[rows_arr].astype(dt)[:, None, :]
            sd = arena.scaler_std[rows_arr].astype(dt)[:, None, :]
            self.readpath.publish(ForecastSnapshot(
                bucket=bucket, model_ids=tuple(ids), versions=versions,
                means=fm * sd + sm, variances=fv * sd**2,
                n_series=arena.n_series_host[rows_arr].copy(),
                names=tuple(mt.names for mt in metas)))
        except Exception:  # pragma: no cover - cache only
            logger.exception("snapshot publish failed (cache only)")

    def _book_gate_verdicts_bulk(self, ids, zs, verdicts, n_sl) -> None:
        """Vectorized gate-outcome booking of one arena dispatch (the
        bulk twin of :meth:`_book_gate_verdicts`): the verdict counts,
        the per-model rejection windows in one lock acquisition, and a
        log line per model the gate acted on."""
        n_pad = zs.shape[2]
        real = np.arange(n_pad)[None, None, :] < n_sl[:, None, None]
        obs = np.isfinite(zs) & real
        rej = (verdicts == GATE_REJECTED) & real
        dw = (verdicts == GATE_DOWNWEIGHTED) & real
        n_rej_m = rej.sum(axis=(1, 2))
        n_dw_m = dw.sum(axis=(1, 2))
        n_obs_m = obs.sum(axis=(1, 2))
        self.monitor.record_gate_many(
            (mid, int(n_obs_m[i]), int(n_rej_m[i] + n_dw_m[i]))
            for i, mid in enumerate(ids))
        n_rej, n_dw = int(n_rej_m.sum()), int(n_dw_m.sum())
        if n_rej:
            self.gate_verdicts.increment("rejected", n_rej)
        if n_dw:
            self.gate_verdicts.increment("downweighted", n_dw)
        for i in np.flatnonzero(n_rej_m + n_dw_m):
            logger.info("gate %s: model %r rejected %d, downweighted %d "
                        "observation(s)", self.gate.policy, ids[i],
                        int(n_rej_m[i]), int(n_dw_m[i]))

    def _book_robust_rows(self, ids, metas, armed_rb, zs, verdicts, iters,
                          n_sl) -> None:
        """Vectorized robust booking of one arena dispatch (the bulk twin
        of :meth:`_book_robust`: the same counters, windows, iteration
        tally and log lines)."""
        n_pad = zs.shape[2]
        real = np.arange(n_pad)[None, None, :] < n_sl[:, None, None]
        obs = np.isfinite(zs) & real
        flagged = (verdicts != 0) & real & armed_rb[:, None, None]
        nonconv = (verdicts == ROBUST_NONCONV) & real
        n_obs_m = obs.sum(axis=(1, 2))
        n_map_m = flagged.sum(axis=(1, 2))
        n_nc_m = nonconv.sum(axis=(1, 2))
        self.monitor.record_gate_many(
            (mid, int(n_obs_m[i]), int(n_nc_m[i]))
            for i, mid in enumerate(ids))
        n_fb = int(np.count_nonzero(armed_rb & (n_map_m == 0)))
        if n_fb:
            self.robust_total.increment("fallback_updates", n_fb)
        n_map = int(n_map_m.sum())
        if not n_map:
            return
        self.robust_total.increment("map_updates",
                                    int(np.count_nonzero(n_map_m)))
        self.robust_total.increment("map_slots", n_map)
        steps, counts = np.unique(iters[flagged], return_counts=True)
        for n_steps, count in zip(steps, counts):
            self.robust_iters.increment(int(n_steps), int(count))
        n_nc = int((n_nc_m * armed_rb).sum())
        if n_nc:
            self.robust_total.increment("nonconverged", n_nc)
        lik = self.robust.likelihood
        for i in np.flatnonzero(n_map_m):
            names = metas[i].names
            if self.robust.flags_selectively:
                slots = sorted({names[int(c)]
                                for c in np.nonzero(flagged[i])[1]})
                logger.info("robust %s: model %r conditioned %d "
                            "observation(s) by MAP (slots %s)", lik, ids[i],
                            int(n_map_m[i]), slots)
            if n_nc_m[i]:
                slots = sorted({names[int(c)]
                                for c in np.nonzero(nonconv[i])[1]})
                logger.warning("robust %s: model %r: %d inner solve(s) "
                               "missed the residual bar (slots %s)", lik,
                               ids[i], int(n_nc_m[i]), slots)

    def _book_detect_rows(self, ids, metas, rows_arr, ok, versions,
                          t_seens, counts, stats, arena) -> None:
        """Arena detection booking — reached only when a dispatch
        ALARMED: the alarming rows' stats land in the arena's last-alarm
        host mirror and only those rows pay per-model booking (their
        accumulators stay in the device leaf)."""
        alarming = np.flatnonzero((counts.sum(axis=(1, 2)) > 0) & ok)
        with arena.lock:
            arena.det_stats_host[rows_arr[alarming]] = stats[alarming]
        for gi in alarming:
            n_i = metas[gi].n_series
            try:
                self._book_detect(
                    ids[gi], counts[gi][:, :n_i], stats[gi][:, :n_i],
                    int(versions[gi]), int(t_seens[gi]), metas[gi].names,
                    n_i, state=None, reset_on_gap=False)
            except Exception:  # pragma: no cover - monitoring only
                logger.exception("detection booking failed for model %r",
                                 ids[gi])

    def _update_batch_arena(self, ids, obs_list) -> list:
        """The arena fleet tick: rows resolved and pinned for the whole
        tick, one dispatch per bucket (:meth:`_update_batch_buckets`),
        one health booking for the tick."""
        results: list = [None] * len(ids)
        with self._update_lock:
            hits, errs = self.registry.rows_for(ids, pin=True)
            live, pinned = [], []
            for i, err in enumerate(errs):
                if err is None:
                    live.append(i)
                    pinned.append(ids[i])
                else:
                    self._count("lookup_failures")
                    results[i] = err
            try:
                self._update_batch_buckets(ids, obs_list, hits, live,
                                           results)
            finally:
                self.registry.release_rows(pinned)
        n_err = sum(isinstance(r, BaseException) for r in results)
        self.monitor.record_many(len(ids) - n_err, n_err)
        if n_err:
            self._count("update_errors", n_err)
        return results

    @staticmethod
    def _bucket_groups(hits, live):
        """Live batch indices grouped by shape bucket."""
        groups: dict = {}
        for i in live:
            groups.setdefault(hits[i][0], []).append(i)
        return groups

    def _update_batch_buckets(self, ids, obs_list, hits, live, results):
        """Per-bucket dispatch of :meth:`_update_batch_arena`: vectorized
        validation and standardization against the arena's host mirrors,
        then :meth:`_arena_dispatch_rows`."""
        for bucket, idxs in self._bucket_groups(hits, live).items():
            try:
                arena = self.registry.arena_of(bucket)
            except Exception as exc:  # noqa: BLE001 - per-bucket
                for i in idxs:
                    results[i] = exc
                continue
            n_pad = bucket[0]
            k = obs_list[idxs[0]].shape[0]
            rows_arr = np.asarray([hits[i][1] for i in idxs], np.int32)
            y_raw = np.zeros((len(idxs), k, n_pad))
            n_expect = arena.n_series_host[rows_arr]
            good: list = []
            for gi, i in enumerate(idxs):
                obs = obs_list[i]
                n_i = obs.shape[1]
                if n_i != n_expect[gi]:
                    self._count("validation_errors")
                    results[i] = ValueError(
                        f"new_obs has {n_i} series, model {ids[i]!r} has "
                        f"{int(n_expect[gi])}")
                    continue
                if np.isinf(obs).any():
                    self._count("validation_errors")
                    results[i] = ValueError(
                        f"new_obs for model {ids[i]!r} contains infinite "
                        "values; use NaN to mark missing observations")
                    continue
                y_raw[gi, :, :n_i] = np.where(np.isfinite(obs), obs, np.nan)
                good.append(gi)
            if not good:
                continue
            if len(good) < len(idxs):
                sel = np.asarray(good)
                y_raw, rows_arr = y_raw[sel], rows_arr[sel]
                idxs = [idxs[gi] for gi in good]
            # padded columns (zeros) are masked off through each row's
            # true series count; only real-slot NaNs count as masked
            n_sl = arena.n_series_host[rows_arr]
            real = np.arange(n_pad)[None, None, :] < n_sl[:, None, None]
            mask = np.isfinite(y_raw)
            n_masked = int(np.count_nonzero(real & ~mask))
            if n_masked:
                self._count("masked_values", n_masked)
            sm = arena.scaler_mean[rows_arr][:, None, :]
            sd = arena.scaler_std[rows_arr][:, None, :]
            # standardized in float64 like the per-request path, then
            # cast to the arena's dtype
            y = np.where(mask, (y_raw - sm) / sd, 0.0).astype(arena.dtype)
            m = mask & real
            metas = [self.registry.meta(ids[i]) for i in idxs]
            ok, versions, t_seens, _zs, verdicts, _dc = (
                self._arena_dispatch_rows(bucket, arena, rows_arr, y, m, k,
                                          [ids[i] for i in idxs], metas))
            for gi, i in enumerate(idxs):
                results[i] = self._arena_result(
                    metas[gi], ok[gi], versions[gi], t_seens[gi], y[gi],
                    m[gi], verdicts, gi)

    def _forecast_batch_arena(self, ids, steps: int) -> list:
        """The arena forecast tick: rows resolved and pinned, one K18
        launch per bucket, per-slot failure isolation."""
        results: list = [None] * len(ids)
        hits, errs = self.registry.rows_for(ids, pin=True)
        live, pinned = [], []
        for i, err in enumerate(errs):
            if err is None:
                live.append(i)
                pinned.append(ids[i])
            else:
                self._count("lookup_failures")
                results[i] = err
        groups = []
        try:
            for bucket, idxs in self._bucket_groups(hits, live).items():
                try:
                    queried = self._arena_query(
                        bucket, [hits[i][1] for i in idxs], steps)
                except Exception as exc:  # noqa: BLE001 - per-bucket
                    queried = exc
                groups.append((idxs, queried))
        finally:
            self.registry.release_rows(pinned)
        for idxs, queried in groups:
            if isinstance(queried, BaseException):
                for i in idxs:
                    results[i] = queried
                continue
            metas = [self.registry.meta(ids[i]) for i in idxs]
            for i, res in zip(idxs, self._arena_forecasts(metas, *queried)):
                results[i] = res
        n_err = sum(isinstance(r, BaseException) for r in results)
        self.monitor.record_many(len(ids) - n_err, n_err)
        if n_err:
            self._count("forecast_errors", n_err)
        return results

    def _book_gate_verdicts(self, st, zs, verdicts) -> None:
        """Book one slot's gate outcome (``zs``/``verdicts`` its
        real-series (k, n_series) slices, ``zs`` NaN where unobserved):
        the verdict counts and the monitor's per-model rejection window
        (flagged = rejected or downweighted: the soft policies never
        reject, and a sensor they downweight every step is as dead)."""
        n_obs = int(np.count_nonzero(np.isfinite(zs)))
        n_rej = int(np.count_nonzero(verdicts == GATE_REJECTED))
        n_dw = int(np.count_nonzero(verdicts == GATE_DOWNWEIGHTED))
        if n_obs:
            self.monitor.record_gate(st.model_id, n_obs, n_rej + n_dw)
        if n_rej:
            self.gate_verdicts.increment("rejected", n_rej)
        if n_dw:
            self.gate_verdicts.increment("downweighted", n_dw)
        if n_rej or n_dw:
            logger.info("gate %s: model %r rejected %d, downweighted %d "
                        "observation(s)", self.gate.policy, st.model_id,
                        n_rej, n_dw)

    def _robust_params(self, rob: RobustSpec, states, n_pad: int, dtype):
        """The (B, N) ``rail_lo, rail_hi, quantum, scale`` of a dispatch
        on the service's device: the rails ``(rail - mean) / std`` (padded
        slots at -inf / +inf), the quantum ``quantum / std`` where the
        slot is real and the spec's quantum positive (else 1), the scale
        as given — formed in float64 and rounded once to ``dtype``, as
        the JAX service does."""
        b = len(states)
        sm = np.zeros((b, n_pad))
        sd = np.ones((b, n_pad))
        real = np.zeros((b, n_pad), bool)
        for i, st in enumerate(states):
            n_i = st.n_series
            sm[i, :n_i] = st.scaler_mean
            sd[i, :n_i] = st.scaler_std
            real[i, :n_i] = True
        params = (
            np.where(real, (rob.rail_lo - sm) / sd, -np.inf),
            np.where(real, (rob.rail_hi - sm) / sd, np.inf),
            np.where(real & (rob.quantum > 0.0),
                     np.divide(rob.quantum, sd), 1.0),
            np.full((b, n_pad), rob.scale),
        )
        return tuple(torch.from_numpy(p.astype(dtype)).to(self.device)
                     for p in params)

    def _book_robust(self, st, armed: bool, zs, verdicts, iters) -> None:
        """Book one slot's robust outcome (``zs``/``verdicts``/``iters``
        its real-series (k, n_series) slices, ``zs`` NaN where
        unobserved): the monitor's window counts the observations and
        the non-converged solves (a flagged slot that converged was
        handled, not lost); an armed commit where nothing flagged is the
        bit-identical Gaussian fallback (``fallback_updates``); otherwise
        the MAP counts and the iteration tally."""
        n_obs = int(np.count_nonzero(np.isfinite(zs)))
        flagged = verdicts != 0
        nonconv = verdicts == ROBUST_NONCONV
        n_map = int(np.count_nonzero(flagged))
        n_nonconv = int(np.count_nonzero(nonconv))
        if n_obs:
            self.monitor.record_gate(st.model_id, n_obs, n_nonconv)
        if not armed:
            return
        lik = self.robust.likelihood
        if not n_map:
            self.robust_total.increment("fallback_updates")
            logger.debug("robust %s: model %r fell back to the Gaussian "
                         "update (nothing flagged)", lik, st.model_id)
            return
        self.robust_total.increment("map_updates")
        self.robust_total.increment("map_slots", n_map)
        steps, counts = np.unique(np.asarray(iters)[flagged],
                                  return_counts=True)
        for n_steps, count in zip(steps, counts):
            self.robust_iters.increment(int(n_steps), int(count))
        if self.robust.flags_selectively:
            # one line per MAP-acted commit; the always-flagging
            # likelihoods would log every armed commit, so their
            # counters tell that story instead
            slots = sorted({st.names[int(c)]
                            for c in np.nonzero(flagged)[1]})
            logger.info("robust %s: model %r conditioned %d observation(s) "
                        "by MAP (slots %s)", lik, st.model_id, n_map, slots)
        if n_nonconv:
            self.robust_total.increment("nonconverged", n_nonconv)
            slots = sorted({st.names[int(c)]
                            for c in np.nonzero(nonconv)[1]})
            logger.warning("robust %s: model %r: %d inner solve(s) missed "
                           "the residual bar (slots %s)", lik, st.model_id,
                           n_nonconv, slots)

    def _book_detect(self, model_id: str, counts, stats, version: int,
                     t_seen: int, names, n_series: int, state,
                     reset_on_gap: bool = True) -> None:
        """Book one committed slot's detection outcome: the mirror
        (stats, cumulative counts, the advanced state — ``None`` for an
        arena row, whose state stays in the device leaf), the counters,
        the health monitor's changepoint flag and the alert board."""
        per_kind = np.asarray(counts).sum(axis=1)
        n_an, n_cp, n_lb = (int(x) for x in per_kind)
        flagged = np.flatnonzero(np.asarray(counts).sum(axis=0) > 0)
        slots = tuple(names[int(j)] for j in flagged)
        self.detector.commit(model_id, version, t_seen, n_series, stats,
                             per_kind, state=state, slots=slots,
                             reset_on_gap=reset_on_gap)
        if n_an:
            self.detect_total.increment("anomaly", n_an)
            self.alert_board.note(model_id, "anomaly", n_an, slots)
        if n_cp:
            self.detect_total.increment("changepoint_cusum", n_cp)
        if n_lb:
            self.detect_total.increment("changepoint_lb", n_lb)
        if n_cp or n_lb:
            # a detected structural break makes the model a refit
            # candidate (HealthMonitor.refit_candidates)
            self.monitor.record_changepoint(model_id)
            self.alert_board.note(model_id, "changepoint", n_cp + n_lb,
                                  slots)


__all__ = ["ArenaUpdateAck", "Forecast", "MetranService"]
