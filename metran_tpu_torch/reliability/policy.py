"""Retry, deadline and circuit-breaker policies for the serving stack
(port of the JAX package's ``reliability/policy.py``: same classes,
names, defaults and state machines).

Failure domains:

- a **request** fails alone when its own payload or its own model's
  posterior is bad (per-slot isolation in ``serve/service.py``);
- a **model** that fails repeatedly gets its own :class:`CircuitBreaker`
  opened, so traffic for it is rejected cheaply at submission;
- the **caller** is protected by a hard deadline on every synchronous
  ``MetranService`` call;
- **transient** failures are retried with exponential backoff inside
  the remaining deadline budget, only when the failed attempt provably
  produced no side effect (an exception outcome of a dispatch means the
  update was not applied).

Everything here is host code, free of torch and numpy.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import CancelledError
from dataclasses import dataclass, field
from logging import getLogger
from typing import Callable, Dict, List, Optional

logger = getLogger(__name__)


class StateIntegrityError(RuntimeError):
    """A posterior state is corrupt or numerically invalid.

    Raised when an on-disk state fails its checksum or cannot be parsed,
    and when an assimilation step produces a non-finite or non-PSD
    posterior (the update is then rejected and the stored state left
    unchanged).  Deterministic — never retried.
    """


class ChainedRequestError(RuntimeError):
    """A request was not applied because its predecessor failed.

    Same-model updates form an ordered chain (the Kalman recursion is
    order-dependent); once one link fails, applying its successors would
    silently skip observations, so they fail with this error instead.
    """


class CircuitOpenError(RuntimeError):
    """Request rejected because the model's circuit breaker is open."""

    def __init__(self, model_id: str, retry_after_s: float):
        self.model_id = model_id
        self.retry_after_s = retry_after_s
        super().__init__(
            f"circuit breaker for model {model_id!r} is open "
            f"(retry after ~{retry_after_s:.1f}s)"
        )


class DeadlineExceededError(TimeoutError):
    """A synchronous service call hit its hard deadline.

    ``in_flight`` is True when the request could no longer be cancelled
    (a dispatch already claimed it): the operation MAY still complete,
    so an update must not be blindly retried — check the version first.
    """

    def __init__(self, kind: str, model_id: str, deadline_s: float,
                 in_flight: bool):
        self.kind = kind
        self.model_id = model_id
        self.deadline_s = deadline_s
        self.in_flight = in_flight
        state = (
            "request still in flight" if in_flight
            else "request cancelled, no side effect"
        )
        super().__init__(
            f"{kind} for model {model_id!r} exceeded its "
            f"{deadline_s:.3f}s deadline ({state})"
        )


def is_retryable(exc: BaseException) -> bool:
    """Whether a failed attempt may be retried at all.

    Deterministic failures (bad payload, poisoned state, broken chain,
    unknown model, open breaker) and exhausted deadlines are final;
    everything else (flaky dispatch, transient IO) is fair game.  The
    retry loop additionally requires the failure to be side-effect-free
    — which the dispatch contract guarantees for exception outcomes.

    Non-``Exception`` ``BaseException``\\ s (KeyboardInterrupt,
    SystemExit) are NEVER retryable: they mean "stop", and a retry loop
    that swallows a Ctrl-C into a backoff sleep has stolen the terminal
    from its operator.  (The JAX package also refuses its durability
    layer's ``PrimaryFencedError``; the port has no durability layer
    yet, ROADMAP A4/A7.)
    """
    if not isinstance(exc, Exception):
        return False
    return not isinstance(
        exc,
        (
            StateIntegrityError,
            ChainedRequestError,
            CircuitOpenError,
            DeadlineExceededError,
            CancelledError,  # someone chose to cancel; honor it
            ValueError,
            KeyError,
        ),
    )


# ----------------------------------------------------------------------
# retry
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff schedule for transient failures.

    ``max_attempts`` counts the first try too (1 = no retries).  The
    delay before retry ``i`` (1-based) is
    ``min(backoff_s * multiplier**(i-1), max_backoff_s)``.
    """

    max_attempts: int = 2
    backoff_s: float = 0.02
    multiplier: float = 2.0
    max_backoff_s: float = 1.0

    def delay(self, attempt: int) -> float:
        """Backoff before the retry following failed attempt ``attempt``."""
        return min(
            self.backoff_s * self.multiplier ** max(attempt - 1, 0),
            self.max_backoff_s,
        )


# ----------------------------------------------------------------------
# circuit breaker
# ----------------------------------------------------------------------
class _Unattributed:
    """Sentinel type for ``_UNATTRIBUTED`` (stable repr: the object's
    default ``<object object at 0x..>`` leaks the process's heap
    address into generated API docs, making them non-reproducible)."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "<unattributed>"


#: default for the record_* ``token`` argument: the caller did not
#: thread :meth:`CircuitBreaker.allow`'s admission token back, so the
#: verdict is taken at face value (direct/unit usage).  Token-threading
#: callers (the service) get strict attribution instead: a verdict only
#: acts on the breaker's probe state when it belongs to the LIVE probe.
_UNATTRIBUTED = _Unattributed()


class CircuitBreaker:
    """Per-model breaker: CLOSED -> OPEN -> HALF_OPEN -> CLOSED.

    Opens after ``failure_threshold`` CONSECUTIVE failures; while open,
    :meth:`allow` rejects instantly (no batch slot is wasted on a model
    that keeps poisoning its own updates).  After ``cooldown_s`` the
    breaker half-opens and admits exactly one probe request: a success
    closes it, a failure re-opens it for another cooldown.  A cancelled
    probe releases the slot without a verdict.

    **Verdict attribution.**  :meth:`allow` returns an admission token
    (``None`` when admitted CLOSED, a probe token when admitted as the
    half-open probe); callers pass it back to :meth:`record_success` /
    :meth:`record_failure` / :meth:`record_abandoned`.  A verdict whose
    token is not the LIVE probe is *stale* — a slow request admitted
    before the breaker opened that finished late — and never moves an
    OPEN or HALF_OPEN breaker: a stale success cannot skip the
    cooldown + probe, and a stale failure cannot re-open a half-open
    breaker and steal the real probe's verdict.  Calls that omit the
    token are taken at face value in CLOSED and HALF_OPEN (direct/unit
    usage); a success while OPEN is ignored regardless of attribution
    — recovery always goes through the cooldown + probe.

    ``clock`` is injectable (monotonic seconds) so tests can drive the
    cooldown deterministically.

    ``on_transition(model_id, old_state, new_state)`` is an optional
    observer hook fired on every state change — the serving layer
    routes it into the structured event log
    so a model's outage timeline is reconstructable.  It is invoked OUTSIDE the breaker lock (an
    observer that re-enters breaker state cannot deadlock) and its
    exceptions are swallowed: telemetry must never alter breaker
    semantics.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, model_id: str, failure_threshold: int = 5,
                 cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[
                     Callable[[str, str, str], None]
                 ] = None):
        self.model_id = model_id
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe: Optional[object] = None  # the live probe's token

    def _notify(self, old: str, new: str) -> None:
        """Fire the transition observer (outside the lock; see class
        docstring)."""
        if self._on_transition is None or old == new:
            return
        try:
            self._on_transition(self.model_id, old, new)
        except Exception:  # pragma: no cover - observer must not break
            logger.exception("breaker transition observer failed")

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self):
        """Admit a request or raise :class:`CircuitOpenError`; returns
        the admission token to thread back into the ``record_*``
        verdict calls."""
        transition = None
        with self._lock:
            if self._state == self.CLOSED:
                return None
            now = self._clock()
            if self._state == self.OPEN:
                remaining = self._opened_at + self.cooldown_s - now
                if remaining > 0:
                    raise CircuitOpenError(self.model_id, remaining)
                self._state = self.HALF_OPEN
                self._probe = None
                transition = (self.OPEN, self.HALF_OPEN)
            # HALF_OPEN: exactly one probe at a time
            if self._probe is not None:
                raise CircuitOpenError(self.model_id, self.cooldown_s)
            self._probe = object()
            token = self._probe
        if transition is not None:
            self._notify(*transition)
        return token

    def _is_stale(self, token) -> bool:
        """Attributed verdict that does NOT belong to the live probe.

        ``None`` (admitted while CLOSED) is ALWAYS stale here: comparing
        it against an empty probe slot (``self._probe is None`` after an
        abandoned probe) must not make a pre-open request pass for the
        probe."""
        if token is _UNATTRIBUTED:
            return False
        return token is None or token is not self._probe

    def record_success(self, token=_UNATTRIBUTED) -> None:
        transition = None
        with self._lock:
            if self._state == self.OPEN:
                # even the probe's own success cannot arrive while OPEN
                # (re-opening cleared it): closing here would skip the
                # cooldown + half-open probe the state machine promises
                return
            if self._state == self.HALF_OPEN:
                if self._is_stale(token):
                    return  # not the probe's verdict
                logger.info(
                    "circuit breaker CLOSED for model %r after a "
                    "successful probe", self.model_id,
                )
                transition = (self.HALF_OPEN, self.CLOSED)
            self._state = self.CLOSED
            self._failures = 0
            self._probe = None
        if transition is not None:
            self._notify(*transition)

    def record_failure(self, token=_UNATTRIBUTED) -> None:
        transition = None
        with self._lock:
            if self._state == self.OPEN:
                # already open; a stale failure must not extend the
                # cooldown another full period
                return
            elif self._state == self.HALF_OPEN:
                if self._is_stale(token):
                    return  # must not steal the live probe's verdict
                logger.warning(
                    "circuit breaker re-OPENED for model %r: probe "
                    "failed", self.model_id,
                )
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._probe = None
                transition = (self.HALF_OPEN, self.OPEN)
            else:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    logger.warning(
                        "circuit breaker OPEN for model %r after %d "
                        "consecutive failures", self.model_id,
                        self._failures,
                    )
                    self._state = self.OPEN
                    self._opened_at = self._clock()
                    self._probe = None
                    transition = (self.CLOSED, self.OPEN)
        if transition is not None:
            self._notify(*transition)

    def record_abandoned(self, token=_UNATTRIBUTED) -> None:
        """A request was cancelled / never materialized: free the probe
        slot it held (if it held one), no verdict either way."""
        with self._lock:
            if not self._is_stale(token):
                self._probe = None


class BreakerBoard:
    """Lazily-created per-model breakers sharing one configuration
    (and one optional transition observer — see
    :class:`CircuitBreaker`)."""

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[
                     Callable[[str, str, str], None]
                 ] = None):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, model_id: str) -> CircuitBreaker:
        with self._lock:
            breaker = self._breakers.get(model_id)
            if breaker is None:
                breaker = self._breakers[model_id] = CircuitBreaker(
                    model_id, self.failure_threshold, self.cooldown_s,
                    self._clock, on_transition=self.on_transition,
                )
            return breaker

    def open_models(self) -> List[str]:
        """Model ids whose breaker is not CLOSED (open or probing)."""
        with self._lock:
            breakers = list(self._breakers.values())
        return sorted(
            b.model_id for b in breakers if b.state != CircuitBreaker.CLOSED
        )

    def __len__(self) -> int:
        with self._lock:
            return len(self._breakers)


# ----------------------------------------------------------------------
# the bundle the service consumes
# ----------------------------------------------------------------------
@dataclass
class ReliabilityPolicy:
    """All serving-reliability knobs in one injectable object.

    :meth:`from_defaults` reads :func:`metran_tpu_torch.config.
    serve_defaults` (the ``METRAN_TPU_SERVE_*`` knobs); the service
    builds one that way when it is given none.  ``clock``
    and ``sleep`` are injectable for deterministic tests.
    """

    deadline_s: Optional[float] = 30.0
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    breaker_failures: int = 5
    breaker_cooldown_s: float = 30.0
    validate_updates: bool = True
    health_window: int = 512
    max_error_rate: float = 0.5
    clock: Callable[[], float] = time.monotonic
    sleep: Callable[[float], None] = time.sleep

    @classmethod
    def from_defaults(cls) -> "ReliabilityPolicy":
        """Build from :func:`metran_tpu_torch.config.serve_defaults`
        (env-overridable ``METRAN_TPU_SERVE_*`` knobs)."""
        from ..config import serve_defaults

        d = serve_defaults()
        return cls(
            deadline_s=d["request_deadline_s"],
            retry=RetryPolicy(
                max_attempts=d["retry_attempts"],
                backoff_s=d["retry_backoff_s"],
            ),
            breaker_failures=d["breaker_failures"],
            breaker_cooldown_s=d["breaker_cooldown_s"],
            validate_updates=bool(d["validate_updates"]),
        )


__all__ = [
    "BreakerBoard",
    "ChainedRequestError",
    "CircuitBreaker",
    "CircuitOpenError",
    "DeadlineExceededError",
    "ReliabilityPolicy",
    "RetryPolicy",
    "StateIntegrityError",
    "is_retryable",
]
