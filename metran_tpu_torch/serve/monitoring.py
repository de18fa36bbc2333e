"""Host-side halves of the online monitoring product: alerting and
per-model detection mirrors (port of the JAX package's
``serve/monitoring.py``, host code only).

The device halves live in :mod:`metran_tpu_torch.ops.detect` (kernel
K13, the CUSUM / autocorrelation-drift recursions) and the serving
update (:mod:`metran_tpu_torch.serve.engine`); what comes back to the
host per dispatch is small — per-slot alarm **counts** and display
**stats**.
This module turns those into the operator-facing product:

- :class:`DetectorMirror` — per-model host mirrors of the detector
  statistics and cumulative alarm counts, version-checked against the
  serving state so an external hot-swap/restore resets the evidence
  (dict registries keep the raw accumulator state here between
  dispatches).
  ``MetranService.anomalies()`` reads it; no query ever touches the
  device.
- :class:`AlertBoard` — the raise/clear lifecycle over raw alarms.
  Raw detector alarms arrive per dispatch and a persistent episode
  (a dying sensor, a structural break the model keeps disagreeing
  with) produces MANY of them; a fleet operator pages on **alerts**:
  one ``alert_raised`` event per episode, refreshed while alarms keep
  arriving, one ``alert_cleared`` once the episode goes quiet for the
  cooldown window, and a raise-side cooldown so a flapping statistic
  cannot page twice in quick succession.  Anomaly alerts additionally
  need ``anomaly_threshold`` anomalies inside one cooldown window —
  a single 5-sigma reading in a clean year is an event in the log,
  not a page.

Both classes are thread-safe and allocation-light; the dispatch paths
touch them once per dispatch per alarming model (zero work on clean
streams beyond one mirror write).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Alert", "AlertBoard", "DetectorMirror"]


@dataclass
class Alert:
    """One alert's lifecycle record (see :class:`AlertBoard`)."""

    model_id: str
    kind: str  # "anomaly" | "changepoint"
    raised_at: float  # board-clock instant of the raise
    last_seen: float  # newest alarm folded into this alert
    count: int = 0  # alarms absorbed (the raise included)
    slots: Tuple[str, ...] = ()  # slot names seen alarming
    active: bool = True
    cleared_at: Optional[float] = None

    def as_dict(self) -> dict:
        return {
            "model_id": self.model_id,
            "kind": self.kind,
            "active": self.active,
            "raised_at": self.raised_at,
            "last_seen": self.last_seen,
            "cleared_at": self.cleared_at,
            "count": self.count,
            "slots": list(self.slots),
        }


class AlertBoard:
    """Raise/clear alert hysteresis over raw detector alarms.

    ``cooldown_s`` is the single hysteresis constant
    (``DetectSpec.alert_cooldown_s``): an active alert CLEARS once no
    alarm has refreshed it for that long, and a cleared alert's
    (model, kind) cannot RE-raise within that long of the previous
    raise — so one slowly-flapping statistic produces one page per
    episode, not one per dispatch.  ``anomaly_threshold`` is the
    anomaly-kind raise bar: that many anomalies must arrive within one
    cooldown window before an anomaly alert raises (changepoint
    alarms raise immediately — a sequential test already paid its
    false-alarm budget inside the kernel).

    ``events`` (an event log with an ``emit(kind, **detail)`` method)
    receives one attributed ``alert_raised`` / ``alert_cleared`` per
    transition; ``counter`` (anything with ``increment(kind)``) books
    the same transitions.  ``clock`` is injectable for tests.
    """

    def __init__(self, cooldown_s: float = 60.0,
                 anomaly_threshold: int = 2, events=None, counter=None,
                 clock=time.monotonic):
        self.cooldown_s = float(cooldown_s)
        self.anomaly_threshold = int(anomaly_threshold)
        self.events = events
        self.counter = counter
        self._clock = clock
        self._lock = threading.Lock()
        self._alerts: Dict[Tuple[str, str], Alert] = {}
        #: (model) -> [instants of recent un-raised anomalies]
        self._pending: Dict[str, List[float]] = {}
        self.raised_total = 0
        self.cleared_total = 0
        self.suppressed_total = 0

    # -- internals (callers hold the lock) ------------------------------
    def _sweep_locked(self, now: float) -> List[Alert]:
        cleared = []
        for alert in self._alerts.values():
            if alert.active and now - alert.last_seen > self.cooldown_s:
                alert.active = False
                alert.cleared_at = now
                cleared.append(alert)
                self.cleared_total += 1
        return cleared

    def _emit(self, kind: str, alert: Alert, **detail) -> None:
        if self.counter is not None:
            self.counter.increment(kind)
        if self.events is not None:
            self.events.emit(
                kind, model_id=alert.model_id,
                fault_point="serve.detect.alerts",
                alert=alert.kind, count=alert.count,
                slots=list(alert.slots), **detail,
            )

    # -- the lifecycle ---------------------------------------------------
    def note(self, model_id: str, kind: str, count: int = 1,
             slots: Tuple[str, ...] = ()) -> Optional[Alert]:
        """Fold ``count`` raw ``kind`` alarms for ``model_id`` into the
        board; returns the alert if one was RAISED by this call, else
        ``None`` (absorbed into an active alert, pending below the
        anomaly bar, or suppressed by the raise cooldown)."""
        if count <= 0:
            return None
        now = float(self._clock())
        raised = cleared = None
        with self._lock:
            cleared = self._sweep_locked(now)
            key = (model_id, kind)
            alert = self._alerts.get(key)
            if alert is not None and alert.active:
                alert.last_seen = now
                alert.count += int(count)
                alert.slots = tuple(
                    dict.fromkeys(alert.slots + tuple(slots))
                )
            elif kind == "anomaly" and self.anomaly_threshold > 1:
                pend = self._pending.setdefault(model_id, [])
                pend.extend([now] * int(count))
                pend[:] = [
                    t for t in pend if now - t <= self.cooldown_s
                ]
                if len(pend) >= self.anomaly_threshold:
                    raised = self._raise_locked(
                        key, now, len(pend), slots, alert
                    )
                    if raised is not None:
                        del self._pending[model_id]
            else:
                raised = self._raise_locked(
                    key, now, int(count), slots, alert
                )
        for al in cleared:
            self._emit("alert_cleared", al,
                       quiet_s=round(now - al.last_seen, 3))
        if raised is not None:
            self._emit("alert_raised", raised)
        return raised

    def _raise_locked(self, key, now, count, slots,
                      prior: Optional[Alert]) -> Optional[Alert]:
        if (
            prior is not None
            and now - prior.last_seen < 2.0 * self.cooldown_s
        ):
            # an episode flapping back within one cooldown of its
            # LOGICAL clear instant (last alarm + cooldown — the lazy
            # sweep's cleared_at depends on when a query happened to
            # run, so it cannot anchor the window): reactivate the
            # alert silently rather than page twice
            prior.active = True
            prior.cleared_at = None
            prior.last_seen = now
            prior.count += count
            prior.slots = tuple(dict.fromkeys(prior.slots + tuple(slots)))
            self.suppressed_total += 1
            return None
        alert = Alert(
            model_id=key[0], kind=key[1], raised_at=now,
            last_seen=now, count=count,
            slots=tuple(dict.fromkeys(slots)),
        )
        self._alerts[key] = alert
        self.raised_total += 1
        return alert

    # -- queries ---------------------------------------------------------
    def sweep(self) -> int:
        """Clear stale active alerts now; returns how many cleared
        (also runs lazily inside :meth:`note`)."""
        now = float(self._clock())
        with self._lock:
            cleared = self._sweep_locked(now)
        for al in cleared:
            self._emit("alert_cleared", al,
                       quiet_s=round(now - al.last_seen, 3))
        return len(cleared)

    def active_count(self) -> int:
        """Currently-active alerts (the alert gauge's callback)."""
        with self._lock:
            self._sweep_locked(float(self._clock()))
            return sum(a.active for a in self._alerts.values())

    def alerts(self, model_id: Optional[str] = None,
               active_only: bool = True) -> List[dict]:
        """Alert records, newest raise first (cleared ones included
        with ``active_only=False`` — the board keeps the latest alert
        per (model, kind))."""
        self.sweep()
        with self._lock:
            out = [
                a.as_dict() for a in self._alerts.values()
                if (model_id is None or a.model_id == model_id)
                and (a.active or not active_only)
            ]
        out.sort(key=lambda a: -a["raised_at"])
        return out

    def forget(self, model_id: str) -> None:
        """Drop a model's alerts and pending anomalies (promotion /
        removal — evidence against the replaced model must not page)."""
        with self._lock:
            for key in [k for k in self._alerts if k[0] == model_id]:
                del self._alerts[key]
            self._pending.pop(model_id, None)

    def stats(self) -> dict:
        with self._lock:
            active = sum(a.active for a in self._alerts.values())
            return {
                "active": active,
                "raised_total": self.raised_total,
                "cleared_total": self.cleared_total,
                "suppressed_total": self.suppressed_total,
            }


@dataclass
class _DetectEntry:
    """One model's mirrored detection view (mirror lock held)."""

    version: int
    t_seen: int
    n_series: int
    stats: np.ndarray  # (3, n): [cusum_pos, cusum_neg, lb_q]
    counts: np.ndarray  # (3,) cumulative [anomalies, cusum, lb]
    state: Optional[np.ndarray] = None  # (6, n) — dict registries only
    alarms_total: int = 0
    last_alarm_t_seen: Optional[int] = None
    slots_flagged: Dict[str, int] = field(default_factory=dict)


class DetectorMirror:
    """Per-model host mirror of the streaming detector (module doc).

    Dict-mode registries also park the raw (6, n) accumulator state
    here between dispatches (:meth:`stack` / :meth:`commit`),
    version-checked so an external ``registry.put`` (hot-swap,
    operator restore) RESETS the evidence.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, _DetectEntry] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def forget(self, model_id: str) -> None:
        with self._lock:
            self._entries.pop(model_id, None)

    # -- dict-registry state parking ------------------------------------
    def stack(self, model_ids, versions, n_pad: int, n_rows: int,
              dtype) -> np.ndarray:
        """The (B, ``n_rows``, ``n_pad``) stacked accumulator states of
        one dict-registry dispatch, zero-initialized for first-touch
        models and for any model whose serving ``version`` no longer
        matches the mirrored one (the external-replacement reset)."""
        out = np.zeros((len(model_ids), int(n_rows), int(n_pad)), dtype)
        with self._lock:
            for i, (mid, ver) in enumerate(zip(model_ids, versions)):
                e = self._entries.get(mid)
                if (
                    e is not None and e.state is not None
                    and e.version == int(ver)
                ):
                    n = e.state.shape[1]
                    out[i, :, :n] = e.state
        return out

    def commit(self, model_id: str, version: int, t_seen: int,
               n_series: int, stats: np.ndarray,
               counts: np.ndarray, state: Optional[np.ndarray] = None,
               slots: Tuple[str, ...] = (),
               reset_on_gap: bool = True) -> None:
        """Record one committed dispatch's outcome for ``model_id``:
        the display stats (3, n), this dispatch's alarm ``counts``
        (3,) folded into the cumulative totals, and (dict mode) the
        advanced accumulator ``state``.  ``reset_on_gap=False`` keeps
        the cumulative tallies across version gaps."""
        counts = np.asarray(counts, np.int64).reshape(3)
        with self._lock:
            e = self._entries.get(model_id)
            if e is None or (
                reset_on_gap and e.version != int(version) - 1
            ):
                # first touch, or a version discontinuity (external
                # hot-swap/restore, missed dispatches): the cumulative
                # view restarts with the evidence
                e = _DetectEntry(
                    version=int(version), t_seen=int(t_seen),
                    n_series=int(n_series),
                    stats=np.asarray(stats, float).copy(),
                    counts=np.zeros(3, np.int64),
                )
                self._entries[model_id] = e
            e.version = int(version)
            e.t_seen = int(t_seen)
            e.n_series = int(n_series)
            e.stats = np.asarray(stats, float).copy()
            e.counts = e.counts + counts
            if state is not None:
                e.state = np.asarray(state).copy()
            n_alarms = int(counts.sum())
            if n_alarms:
                e.alarms_total += n_alarms
                e.last_alarm_t_seen = int(t_seen)
                for s in slots:
                    e.slots_flagged[s] = e.slots_flagged.get(s, 0) + 1

    # -- queries ---------------------------------------------------------
    def snapshot(self, model_id: Optional[str] = None) -> dict:
        """Per-model detection view: per-slot ``cusum_pos`` /
        ``cusum_neg`` / ``lb_q``, cumulative alarm counts, and the
        stream position of the last alarm (what
        ``MetranService.anomalies()`` returns)."""
        with self._lock:
            items = (
                self._entries.items() if model_id is None
                else [(model_id, self._entries[model_id])]
                if model_id in self._entries else []
            )
            out = {}
            for mid, e in items:
                n = e.n_series
                out[mid] = {
                    "version": e.version,
                    "t_seen": e.t_seen,
                    "cusum_pos": e.stats[0, :n].tolist(),
                    "cusum_neg": e.stats[1, :n].tolist(),
                    "lb_q": e.stats[2, :n].tolist(),
                    "anomalies": int(e.counts[0]),
                    "cusum_alarms": int(e.counts[1]),
                    "lb_alarms": int(e.counts[2]),
                    "last_alarm_t_seen": e.last_alarm_t_seen,
                    "slots_flagged": dict(e.slots_flagged),
                }
        return out
