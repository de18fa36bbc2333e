"""Fixed-lag smoothed products for serving: O(L) recent-window smoothing.

Port of ``metran_tpu/serve/smoothing.py``.  Serving answers filtered
(causal) posteriors; monitoring products want *smoothed* ones — the
best estimate of the recent past given everything seen since.  RTS over
the full history is O(T) per query and T grows forever; the fixed-lag
route keeps, per model, a rolling **anchor** posterior at ``t_seen - L``
plus the L observation rows since, and a query is one O(L) windowed
filter + smoother pass (:func:`metran_tpu_torch.ops.fixed_lag_smooth`:
K9 ``store`` from the anchor, then K10) — flat in T, and exactly the
full smoother on those last L steps (the filter is Markov).

:class:`FixedLagTracker` is the host-side bookkeeping: the service feeds
every committed update's standardized rows into
:meth:`FixedLagTracker.observe`, which maintains the anchor by replaying
the rows that fall off the window through the square-root incremental
filter (:func:`metran_tpu_torch.ops.sqrt_filter_append`, K9 from the
anchor: one launch per commit once the window is full).
``MetranService.smoothed(model_id, lag=L)`` is the query API.

Tracking (re)starts from the posterior AFTER a commit whenever the
stream's continuity breaks (first touch, an external ``registry.put``,
a rejected update, a commit the gate acted on) — the window then
refills over the next L commits; :meth:`FixedLagTracker.smooth` reports
how much of it is available.  The tracker works in float64 whatever the
states' precision, as the JAX package's does.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..config import resolve_device
from ..ops import (
    chol_outer,
    dfm_statespace,
    fixed_lag_smooth,
    project,
    sqrt_filter_append,
)
from .engine import psd_factor

__all__ = ["FixedLagTracker", "SmoothedWindow"]


class SmoothedWindow(NamedTuple):
    """One model's smoothed trailing window, data units.

    ``means``/``variances`` are (L, n_series) smoothed observation-space
    moments (de-standardized); ``state_means`` the (L, n_state) smoothed
    state means in standardized units; ``t_end`` the grid index of the
    last smoothed step (the model's ``t_seen`` at query time); ``lag``
    the realized window length (shorter than requested while the window
    refills after a tracking restart).
    """

    means: np.ndarray
    variances: np.ndarray
    state_means: np.ndarray
    names: Tuple[str, ...]
    t_end: int
    lag: int


class _Track:
    """One model's window state (guarded by the tracker lock)."""

    __slots__ = (
        "params", "loadings", "dt", "names", "scaler_mean",
        "scaler_std", "anchor_mean", "anchor_chol", "anchor_t_seen",
        "rows",
    )

    def __init__(self, state, anchor_mean, anchor_chol):
        self.params = np.asarray(state.params, float)
        self.loadings = np.asarray(state.loadings, float)
        self.dt = float(state.dt)
        self.names = tuple(state.names)
        self.scaler_mean = np.asarray(state.scaler_mean, float)
        self.scaler_std = np.asarray(state.scaler_std, float)
        self.anchor_mean = anchor_mean
        self.anchor_chol = anchor_chol
        self.anchor_t_seen = int(state.t_seen)
        #: buffered (y_std (n,), mask (n,)) rows SINCE the anchor
        self.rows: List[Tuple[np.ndarray, np.ndarray]] = []

    def statespace(self, device):
        n = self.loadings.shape[0]
        return dfm_statespace(self.params[:n], self.params[n:],
                              self.loadings, self.dt, device=device)


def _anchor_factor(state) -> np.ndarray:
    """The anchor posterior's covariance factor: the state's own factor
    when it carries one (square-root serving), else the eigh-based
    :func:`~metran_tpu_torch.serve.engine.psd_factor` (``np.linalg.
    cholesky`` would refuse the DFM's structurally singular filtered
    covariances)."""
    chol = getattr(state, "chol", None)
    if chol is not None:
        return np.asarray(chol, float)
    return psd_factor(np.asarray(state.cov, float))


class FixedLagTracker:
    """Per-model rolling anchors + observation windows (see the module
    doc).  Thread-safe; every kernel call happens under the tracker
    lock.  ``device``: where the window kernels run (default: the CUDA
    card)."""

    def __init__(self, lag: int, device=None):
        if int(lag) < 1:
            raise ValueError(f"fixed-lag window must be >= 1, got {lag}")
        self.lag = int(lag)
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._tracks: Dict[str, _Track] = {}

    def __len__(self) -> int:
        return len(self._tracks)

    def tracking(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._tracks

    def forget(self, model_id: str) -> None:
        with self._lock:
            self._tracks.pop(model_id, None)

    def observe(self, model_id: str, y_std: np.ndarray,
                mask: np.ndarray, t_seen_after: int,
                post_state_fn, clean: bool = True) -> None:
        """Feed one committed update's ``k`` standardized rows.

        ``t_seen_after`` is the model's ``t_seen`` after the commit;
        when it does not line up with the tracked window (first touch,
        an external hot-swap, an intervening rejected update), tracking
        restarts from ``post_state_fn()`` — the posterior after this
        commit — and the window refills from the next commit on.
        ``clean=False`` forces the same restart: the service passes it
        when the observation gate acted on this commit (the served
        filter then differs from replaying the raw rows).  Never
        raises: window maintenance must not fail a caller whose update
        already committed.
        """
        y_std = np.atleast_2d(np.asarray(y_std, float))
        mask = np.atleast_2d(np.asarray(mask, bool))
        k = y_std.shape[0]
        with self._lock:
            tr = self._tracks.get(model_id)
            if (
                not clean
                or tr is None
                or tr.anchor_t_seen + len(tr.rows) + k != int(t_seen_after)
            ):
                try:
                    state = post_state_fn()
                    self._tracks[model_id] = _Track(
                        state, np.asarray(state.mean, float),
                        _anchor_factor(state),
                    )
                except Exception:  # pragma: no cover - tracking only
                    self._tracks.pop(model_id, None)
                return
            for i in range(k):
                tr.rows.append((y_std[i], mask[i]))
            self._advance(tr)

    def _advance(self, tr: _Track) -> None:
        """Replay the rows that fell off the window into the anchor (one
        :func:`~metran_tpu_torch.ops.sqrt_filter_append` call, K9 from
        the anchor)."""
        excess = len(tr.rows) - self.lag
        if excess <= 0:
            return
        y = np.stack([r[0] for r in tr.rows[:excess]])
        m = np.stack([r[1] for r in tr.rows[:excess]])
        mean, chol, _, _ = sqrt_filter_append(
            tr.statespace(self.device), tr.anchor_mean, tr.anchor_chol, y,
            m, device=self.device)
        tr.anchor_mean = mean.cpu().numpy()
        tr.anchor_chol = chol.cpu().numpy()
        tr.anchor_t_seen += excess
        del tr.rows[:excess]

    # -- durability (the JAX package's durability sidecar calls these) --
    def dump(self) -> Dict[str, dict]:
        """Snapshot every track: plain arrays + a JSON-able ``meta`` dict
        per model, the shape :meth:`restore` rebuilds from."""
        out: Dict[str, dict] = {}
        with self._lock:
            for mid, tr in self._tracks.items():
                rows_y = (
                    np.stack([r[0] for r in tr.rows])
                    if tr.rows else np.zeros((0, len(tr.names)))
                )
                rows_m = (
                    np.stack([r[1] for r in tr.rows])
                    if tr.rows else np.zeros((0, len(tr.names)), bool)
                )
                out[mid] = {
                    "meta": {
                        "dt": float(tr.dt),
                        "names": list(tr.names),
                        "anchor_t_seen": int(tr.anchor_t_seen),
                    },
                    "params": tr.params,
                    "loadings": tr.loadings,
                    "scaler_mean": tr.scaler_mean,
                    "scaler_std": tr.scaler_std,
                    "anchor_mean": tr.anchor_mean,
                    "anchor_chol": tr.anchor_chol,
                    "rows_y": rows_y,
                    "rows_m": rows_m,
                }
        return out

    def restore(self, dump: Dict[str, dict]) -> None:
        """Install tracks captured by :meth:`dump` (recovery); replacing
        a live track is intended."""
        with self._lock:
            for mid, d in dump.items():
                tr = object.__new__(_Track)
                tr.params = np.asarray(d["params"], float)
                tr.loadings = np.asarray(d["loadings"], float)
                tr.dt = float(d["meta"]["dt"])
                tr.names = tuple(d["meta"]["names"])
                tr.scaler_mean = np.asarray(d["scaler_mean"], float)
                tr.scaler_std = np.asarray(d["scaler_std"], float)
                tr.anchor_mean = np.asarray(d["anchor_mean"], float)
                tr.anchor_chol = np.asarray(d["anchor_chol"], float)
                tr.anchor_t_seen = int(d["meta"]["anchor_t_seen"])
                rows_y = np.asarray(d["rows_y"], float)
                rows_m = np.asarray(d["rows_m"], bool)
                tr.rows = [
                    (rows_y[i], rows_m[i])
                    for i in range(rows_y.shape[0])
                ]
                self._tracks[mid] = tr

    def smooth(self, model_id: str,
               lag: Optional[int] = None) -> SmoothedWindow:
        """Smoothed moments for the model's trailing window.

        ``lag`` caps the returned window (default: the configured lag);
        the realized window is also capped by the rows streamed since
        tracking (re)started (:class:`SmoothedWindow` ``.lag``).  Raises
        ``KeyError`` for an untracked model and ``ValueError`` while the
        window is still empty.
        """
        want = self.lag if lag is None else int(lag)
        if want < 1:
            raise ValueError(f"lag must be >= 1, got {lag}")
        with self._lock:
            tr = self._tracks.get(model_id)
            if tr is None:
                raise KeyError(
                    f"model {model_id!r} is not tracked yet — smoothed "
                    "windows build from updates streamed through the "
                    "service after fixed-lag tracking was armed"
                )
            if not tr.rows:
                raise ValueError(
                    f"model {model_id!r} has an empty smoothing window "
                    "(tracking just (re)started); stream more updates"
                )
            ss = tr.statespace(self.device)
            y = np.stack([r[0] for r in tr.rows])
            m = np.stack([r[1] for r in tr.rows])
            sm = fixed_lag_smooth(ss, tr.anchor_mean, tr.anchor_chol, y,
                                  m, device=self.device)
            take = min(want, len(tr.rows))
            mean_s = sm.mean_s[-take:]
            means, variances = project(ss.z, mean_s,
                                       chol_outer(sm.chol_s[-take:]))
            means = means.cpu().numpy()
            variances = (variances + ss.r[None]).cpu().numpy()
            mean_s = mean_s.cpu().numpy()
            t_end = tr.anchor_t_seen + len(tr.rows)
        return SmoothedWindow(
            means=means * tr.scaler_std + tr.scaler_mean,
            variances=variances * tr.scaler_std**2,
            state_means=mean_s,
            names=tr.names,
            t_end=int(t_end),
            lag=int(take),
        )
