"""Error-rate-aware health tracking for readiness probes (port of the
JAX package's ``reliability/health.py``: same classes, windows and
refit-candidate ranking).

A latency histogram says how fast the service is; it says nothing about
whether it is *succeeding*.  :class:`HealthMonitor` keeps a bounded
window of recent request outcomes so a readiness probe can answer "is
this replica currently serving its traffic" — the number an
orchestrator flips a replica out of rotation on — without unbounded
memory and without scanning historical totals that would let one bad
hour poison an otherwise-recovered replica forever.

:meth:`MetranService.health` assembles the full snapshot: this window's
error rate, the lifetime error counters by kind, open circuit breakers,
the registry's integrity events, and batcher liveness.

The port has no metrics registry yet (the observability layer, ROADMAP
A7): :meth:`HealthMonitor.bind_metrics` takes one and publishes
nothing until that layer lands; every signal is read through the
monitor's own methods and :meth:`HealthMonitor.snapshot`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

__all__ = ["HealthMonitor", "RefitCandidate"]


class RefitCandidate(NamedTuple):
    """One entry of :meth:`HealthMonitor.refit_candidates`.

    ``score`` is the ranking key: how far past its threshold the
    model's worst signal sits (1.0 = exactly at threshold), so a
    sensor rejecting 3x the degraded rate outranks a model that just
    crossed its staleness budget.  ``reasons`` names every signal that
    fired (``"gate"``, ``"stale_obs"``, ``"stale_age"``); the raw
    evidence rides alongside so the refit worker can log an
    attributable decision.
    """

    model_id: str
    score: float
    reasons: Tuple[str, ...]
    rejection_rate: float
    obs_since_fit: int
    age_s: float


class HealthMonitor:
    """Sliding-window request-outcome tracker (thread-safe).

    ``window`` bounds memory AND forgives: once a fault clears, the bad
    outcomes age out after ``window`` successful requests and the
    replica reads ready again — recovery needs no restart.

    Besides whole-replica request outcomes, the monitor keeps a
    **per-model observation-gate window** (:meth:`record_gate`): how
    many of a model's recent observations the serving gate rejected.
    A dying sensor produces observations the gate rejects while every
    *request* still succeeds (the tempered update commits), so its
    circuit breaker never sees an error — the rejection-rate window is
    what flips that model to degraded (:meth:`degraded_models`) before
    anything breaks.  ``gate_window`` bounds per-model memory (recent
    update batches kept); ``max_rejection_rate`` is the degraded
    threshold — the default 0.1 sits far above the gate's false-alarm
    rate on clean data (~1e-4 per observation at nsigma=4) yet below
    one fully-dead sensor's share of a typical panel (1/n_series).
    """

    def __init__(self, window: int = 512, max_error_rate: float = 0.5,
                 gate_window: int = 128,
                 max_rejection_rate: float = 0.1,
                 changepoint_ttl_s: float = 900.0,
                 clock=time.monotonic):
        self.window = int(window)
        self.max_error_rate = float(max_error_rate)
        self.gate_window = int(gate_window)
        self.max_rejection_rate = float(max_rejection_rate)
        self.changepoint_ttl_s = float(changepoint_ttl_s)
        self._clock = clock
        self._outcomes: Deque[bool] = deque(maxlen=self.window)
        # model_id -> recent (observed, rejected) pairs, one per update
        self._gate: Dict[str, Deque[Tuple[int, int]]] = {}
        # model_id -> instant of the newest detected changepoint (the
        # streaming detector's structural-break flag — see
        # refit_candidates; consumed when a refit claims the model,
        # expired after changepoint_ttl_s)
        self._changepoints: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._seen = 0
        # -- refit bookkeeping (see refit_candidates) -------------------
        # model_id -> (mark instant, t_seen at mark): the staleness
        # baseline, stamped by note_fit (a promotion) or implicitly by
        # the first note_progress (staleness accrues from first sight)
        self._fit_marks: Dict[str, Tuple[float, int]] = {}
        self._fit_progress: Dict[str, int] = {}  # newest observed t_seen
        self._refitting: set = set()  # models with a refit in flight
        self._refit_cooldown: Dict[str, float] = {}  # until-instant

    def record(self, ok: bool) -> None:
        with self._lock:
            self._outcomes.append(bool(ok))
            self._seen += 1

    def record_many(self, n_ok: int, n_err: int) -> None:
        """Bulk outcome booking (one lock acquisition for a whole
        fleet-tick dispatch).  When the tick exceeds the window, the
        kept sample PRESERVES the tick's success/failure ratio — all
        outcomes in one tick are equally recent, so truncating
        err-first (or ok-first) would let one oversized tick read as
        100% failed (or 100% healthy) and flip readiness spuriously."""
        n_ok, n_err = int(n_ok), int(n_err)
        total = n_ok + n_err
        with self._lock:
            keep_ok, keep_err = n_ok, n_err
            if total > self.window:
                keep_err = round(self.window * n_err / total)
                keep_ok = self.window - keep_err
            self._outcomes.extend(
                [False] * keep_err + [True] * keep_ok
            )
            self._seen += total

    @property
    def seen(self) -> int:
        with self._lock:
            return self._seen

    def error_rate(self) -> float:
        """Failure fraction over the recent window (0.0 when empty)."""
        with self._lock:
            if not self._outcomes:
                return 0.0
            return 1.0 - sum(self._outcomes) / len(self._outcomes)

    def healthy(self) -> bool:
        """Error-rate verdict alone; the service ANDs in liveness."""
        return self.error_rate() <= self.max_error_rate

    # -- per-model observation-gate window ------------------------------
    def record_gate(self, model_id: str, observed: int,
                    flagged: int) -> None:
        """Book one update batch's gate outcome for ``model_id``:
        ``observed`` real observations evaluated, ``flagged`` of them
        acted on by the gate (rejected OR downweighted — under the
        soft policies a dying sensor is downweighted every step, never
        rejected, and must still trip degraded).  No-op when nothing
        was observed."""
        if observed <= 0:
            return
        with self._lock:
            dq = self._gate.get(model_id)
            if dq is None:
                dq = self._gate[model_id] = deque(
                    maxlen=self.gate_window
                )
            dq.append((int(observed), int(flagged)))

    def record_gate_many(self, entries) -> None:
        """Bulk :meth:`record_gate`: ``entries`` is an iterable of
        ``(model_id, observed, flagged)`` triples booked under ONE
        lock acquisition — the fleet-tick path books G models per
        dispatch and G lock round-trips were measurable there."""
        with self._lock:
            gate = self._gate
            for model_id, observed, flagged in entries:
                if observed <= 0:
                    continue
                dq = gate.get(model_id)
                if dq is None:
                    dq = gate[model_id] = deque(
                        maxlen=self.gate_window
                    )
                dq.append((int(observed), int(flagged)))

    def rejection_rate(self, model_id: str) -> float:
        """Fraction of ``model_id``'s recent observations the gate
        acted on — rejected or downweighted (0.0 for an unknown/quiet
        model)."""
        with self._lock:
            dq = self._gate.get(model_id)
            if not dq:
                return 0.0
            obs = sum(o for o, _ in dq)
            rej = sum(r for _, r in dq)
        return rej / obs if obs else 0.0

    def degraded_models(self) -> List[str]:
        """Models whose windowed rejection rate exceeds
        ``max_rejection_rate`` — the sensor-is-dying signal that never
        reaches the circuit breaker (the tempered requests succeed)."""
        with self._lock:
            items = [
                (mid, sum(o for o, _ in dq), sum(r for _, r in dq))
                for mid, dq in self._gate.items()
            ]
        return sorted(
            mid for mid, obs, rej in items
            if obs and rej / obs > self.max_rejection_rate
        )

    def gate_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-model windowed gate stats (observed/rejected/rate)."""
        with self._lock:
            items = [
                (mid, sum(o for o, _ in dq), sum(r for _, r in dq))
                for mid, dq in self._gate.items()
            ]
        return {
            mid: {
                "observed": obs, "rejected": rej,
                "rejection_rate": (rej / obs) if obs else 0.0,
            }
            for mid, obs, rej in items
        }

    # -- changepoint flags (streaming detection -> refit trigger) -------
    def record_changepoint(self, model_id: str) -> None:
        """Flag a detected structural break for ``model_id`` (the
        serving layer's streaming CUSUM / autocorrelation-drift
        detectors, :mod:`metran_tpu_torch.ops.detect`).  The flag makes the
        model a :meth:`refit_candidates` entry with reason
        ``"changepoint"`` — a detected break *schedules a refit*
        instead of merely degrading health — and carries its own
        hysteresis, distinct from gate-rejection degradation: it is
        CONSUMED when a refit claims the model (:meth:`begin_refit`)
        or a promotion lands (:meth:`note_fit`), and expires after
        ``changepoint_ttl_s`` so a stale break cannot trigger a refit
        long after the stream moved on."""
        with self._lock:
            self._changepoints[model_id] = float(self._clock())

    def changepoint_models(self) -> List[str]:
        """Models with an unexpired, unconsumed changepoint flag."""
        now = float(self._clock())
        with self._lock:
            self._prune_changepoints(now)
            return sorted(self._changepoints)

    def _prune_changepoints(self, now: float) -> None:
        """Drop expired flags (callers hold the lock)."""
        if self.changepoint_ttl_s <= 0.0:
            return
        for mid in [
            m for m, ts in self._changepoints.items()
            if now - ts > self.changepoint_ttl_s
        ]:
            del self._changepoints[mid]

    # -- refit candidate queue (degradation + staleness, merged) --------
    def note_fit(self, model_id: str, t_seen: int) -> None:
        """Stamp ``model_id``'s staleness baseline: it was (re)fit now,
        at ``t_seen`` assimilated steps.  The refit worker calls this
        after every promotion; staleness signals in
        :meth:`refit_candidates` measure from the newest stamp."""
        with self._lock:
            self._fit_marks[model_id] = (float(self._clock()), int(t_seen))
            self._fit_progress[model_id] = int(t_seen)
            # a promotion resolves the break the flag reported
            self._changepoints.pop(model_id, None)

    def note_progress(self, model_id: str, t_seen: int) -> None:
        """Record the model's current ``t_seen`` (monotonic max).  A
        model never stamped by :meth:`note_fit` gets an implicit
        baseline at its FIRST observed ``t_seen`` — staleness then
        accrues from first sight, never from the absolute stream
        origin (which would flag every long-lived model instantly)."""
        t_seen = int(t_seen)
        with self._lock:
            if model_id not in self._fit_marks:
                self._fit_marks[model_id] = (float(self._clock()), t_seen)
            prev = self._fit_progress.get(model_id, 0)
            if t_seen > prev:
                self._fit_progress[model_id] = t_seen

    def begin_refit(self, model_id: str) -> bool:
        """Claim ``model_id`` for a refit; False when one is already in
        flight (the hysteresis half that stops double-scheduling).  A
        successful claim CONSUMES the model's changepoint flag — the
        break triggered its refit; only a new detection re-arms it
        (the changepoint trigger's own hysteresis, on top of the
        post-outcome cooldown)."""
        with self._lock:
            if model_id in self._refitting:
                return False
            self._refitting.add(model_id)
            self._changepoints.pop(model_id, None)
            return True

    def end_refit(self, model_id: str, cooldown_s: float = 0.0) -> None:
        """Release a :meth:`begin_refit` claim; ``cooldown_s`` keeps the
        model out of :meth:`refit_candidates` for that long — whatever
        the outcome, so a rejected challenger cannot thrash the fit
        lanes every scan while its degradation signal persists."""
        with self._lock:
            self._refitting.discard(model_id)
            if cooldown_s > 0.0:
                self._refit_cooldown[model_id] = (
                    float(self._clock()) + float(cooldown_s)
                )

    def reset_gate(self, model_id: str) -> None:
        """Drop the model's gate-rejection window (a promotion installs
        new dynamics; verdicts booked against the old parameters must
        not re-flag the fresh model as degraded)."""
        with self._lock:
            self._gate.pop(model_id, None)

    def refitting(self) -> List[str]:
        """Models currently claimed by :meth:`begin_refit` (sorted)."""
        with self._lock:
            return sorted(self._refitting)

    def refit_candidates(
        self,
        staleness_obs: int = 0,
        staleness_age_s: float = 0.0,
        limit: Optional[int] = None,
    ) -> List[RefitCandidate]:
        """One ranked queue merging every refit trigger (module doc).

        Signals, each scored as ``observed / threshold`` (>= 1.0 fires):

        - **gate degradation** — the model's windowed observation-
          rejection rate exceeds ``max_rejection_rate`` (the same test
          as :meth:`degraded_models`, strict >);
        - **changepoint** — the streaming detector flagged a
          structural break (:meth:`record_changepoint`), unexpired and
          unconsumed.  A sequential test that fired already paid its
          false-alarm budget, so the flag scores a flat 2.0 — above a
          barely-crossed threshold, below a sensor rejecting several
          times the degraded rate;
        - **observation staleness** — ``staleness_obs`` or more steps
          assimilated since the last :meth:`note_fit` stamp (0 = off);
        - **age staleness** — ``staleness_age_s`` or more seconds since
          that stamp (0 = off).

        Models mid-refit (:meth:`begin_refit`) or inside a
        post-refit cooldown (:meth:`end_refit`) are excluded —
        the hysteresis that keeps one degraded model from being
        re-enqueued every scan while its (windowed) signal persists.
        Ranked worst-first by the max signal ratio, ties by id.
        """
        now = float(self._clock())
        with self._lock:
            gate_items = {
                mid: (sum(o for o, _ in dq), sum(r for _, r in dq))
                for mid, dq in self._gate.items()
            }
            marks = dict(self._fit_marks)
            progress = dict(self._fit_progress)
            self._prune_changepoints(now)
            breaks = set(self._changepoints)
            skip = set(self._refitting)
            skip.update(
                mid for mid, until in self._refit_cooldown.items()
                if until > now
            )
        out: List[RefitCandidate] = []
        for mid in sorted(set(gate_items) | set(marks) | breaks):
            if mid in skip:
                continue
            obs, rej = gate_items.get(mid, (0, 0))
            rate = rej / obs if obs else 0.0
            mark = marks.get(mid)
            age_s = now - mark[0] if mark is not None else 0.0
            since = (
                progress.get(mid, mark[1]) - mark[1]
                if mark is not None else 0
            )
            reasons, score = [], 0.0
            if obs and rate > self.max_rejection_rate:
                reasons.append("gate")
                score = max(score, rate / self.max_rejection_rate)
            if mid in breaks:
                reasons.append("changepoint")
                score = max(score, 2.0)
            if staleness_obs > 0 and since >= staleness_obs:
                reasons.append("stale_obs")
                score = max(score, since / staleness_obs)
            if staleness_age_s > 0 and age_s >= staleness_age_s:
                reasons.append("stale_age")
                score = max(score, age_s / staleness_age_s)
            if reasons:
                out.append(RefitCandidate(
                    model_id=mid, score=float(score),
                    reasons=tuple(reasons), rejection_rate=float(rate),
                    obs_since_fit=int(since), age_s=float(age_s),
                ))
        out.sort(key=lambda c: (-c.score, c.model_id))
        return out[:limit] if limit is not None else out

    def bind_metrics(self, registry, prefix: str = "metran_serve") -> None:
        """Publish this monitor into a metrics registry: a no-op until
        the port's observability layer lands (ROADMAP A7); the JAX
        package publishes the windowed error rate, the request count,
        the gate-degraded and the changepoint-pending model counts as
        callback gauges."""

    def snapshot(self, extra: Optional[Dict] = None) -> Dict:
        with self._lock:  # ONE acquisition: a consistent instant
            n = len(self._outcomes)
            errors = n - sum(self._outcomes)
            seen = self._seen
            self._prune_changepoints(float(self._clock()))
            changepoints = sorted(self._changepoints)
            gate_items = [
                (mid, sum(o for o, _ in dq), sum(r for _, r in dq))
                for mid, dq in self._gate.items()
            ]
        snap = {
            "window": n,
            "window_errors": int(errors),
            "error_rate": (errors / n) if n else 0.0,
            "requests_seen": seen,
            "max_error_rate": self.max_error_rate,
            "gate": {
                "tracked_models": len(gate_items),
                "degraded_models": sorted(
                    mid for mid, obs, rej in gate_items
                    if obs and rej / obs > self.max_rejection_rate
                ),
                "max_rejection_rate": self.max_rejection_rate,
            },
            "changepoints_pending": changepoints,
        }
        if extra:
            snap.update(extra)
        return snap
