"""Materialized forecast read path: lock-free versioned snapshot serving.

Port of ``metran_tpu/serve/readpath.py`` (numpy only; the port keeps its
own copy).  A forecast is a closed-form function of the posterior, and
the posterior only changes on commit, so the update dispatch computes
the forecast moments at a fixed horizon set in the same launches that
commit the posterior (the ``horizons`` modes of K16, K17 and K14, or K2
after the dict path's exact update; ``serve/engine.py``), the service
de-standardizes them once off the scaler mirrors and publishes them
here as immutable :class:`SnapshotEntry` objects keyed by the model's
``version`` counter.  A read is then two dict lookups, an integer
compare and a slice of the entry's arrays: no lock, no batcher hop, no
device dispatch.  Correctness comes from immutability plus version
checking:

- entries are immutable once published (fresh arrays per publish,
  swapped in by one dict assignment, atomic under the GIL), so a
  concurrent reader sees the old entry or the new one, never a torn
  mix;
- a read is served only when the entry's ``version`` equals the store's
  last-committed version for that model, so anything stale — a commit
  whose snapshot has not landed yet, an external ``registry.put`` —
  falls through to the compute path;
- publication happens after the commit it describes and before the
  update's caller is acknowledged, so read-your-writes holds for
  acknowledged updates and a served entry is never newer than a
  committed posterior.

At matching version the served moments are the compute path's: bit for
bit at f64 (the same device function, or the same plain torch ops),
within float tolerance at f32.  The cache counters are unlocked plain
ints (telemetry; a lock per read would cost more than the read);
:meth:`SnapshotStore.bind_metrics` exposes them as callback gauges on
any registry with the JAX package's ``gauge(name, help, callback=)``.

Enabled via ``MetranService(readpath=True)`` or
``METRAN_TPU_SERVE_READPATH=1``; the horizon set comes from
``METRAN_TPU_SERVE_HORIZONS`` (see :func:`parse_horizons`).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = [
    "ForecastSnapshot",
    "SnapshotEntry",
    "SnapshotStore",
    "parse_horizons",
]


def parse_horizons(spec) -> Tuple[int, ...]:
    """The configured horizon set as a sorted tuple of distinct ints.

    Accepts an iterable of ints or a spec string of comma-separated
    items where each item is a single horizon (``"7"``) or an inclusive
    range (``"1-30"``): ``"1,7,30"``, ``"1-30"`` and ``"1-14,30"`` all
    parse.  Horizons must be >= 1 (a forecast starts one step ahead).
    """
    if spec is None:
        return ()
    if isinstance(spec, str):
        out: List[int] = []
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "-" in item:
                lo, hi = item.split("-", 1)
                out.extend(range(int(lo), int(hi) + 1))
            else:
                out.append(int(item))
        horizons = out
    else:
        horizons = [int(h) for h in spec]
    horizons = sorted(set(horizons))
    if horizons and horizons[0] < 1:
        raise ValueError(
            f"forecast horizons must be >= 1, got {horizons[0]} "
            f"(from {spec!r})"
        )
    return tuple(horizons)


def contiguous_prefix(horizons: Tuple[int, ...]) -> int:
    """Largest ``p`` with ``horizons[:p] == (1, ..., p)``.

    ``forecast(steps=s)`` returns moments for horizons ``1..s``, so a
    snapshot can serve it only when its first ``s`` horizons are
    exactly that contiguous prefix — ``{1, 7, 30}`` serves ``steps=1``
    reads, ``1-30`` serves any ``steps <= 30``.
    """
    p = 0
    for h in horizons:
        if h != p + 1:
            break
        p += 1
    return p


class SnapshotEntry(NamedTuple):
    """One model's published forecast moments at one posterior version.

    ``means``/``variances`` are (H, n_series) **data-unit** arrays
    (de-standardized at publish time so a read does no arithmetic),
    rows ordered by the store's sorted horizon set.  Immutable by
    contract: readers receive slices (views) of these arrays and must
    not write through them — publication always builds fresh arrays.
    """

    model_id: str
    version: int
    means: np.ndarray  # (H, n_series), data units
    variances: np.ndarray  # (H, n_series), data units
    names: Tuple[str, ...]
    published_at: float  # store-clock instant of publication


class ForecastSnapshot(NamedTuple):
    """One dispatch's publication unit: a shape bucket's committed rows.

    The contiguous (G, H, n_pad) moment arrays are the single
    device→host gather per leaf the fused update kernel already paid
    for, de-standardized in one vectorized pass off the scaler
    mirrors; :meth:`SnapshotStore.publish` slices them into per-model
    :class:`SnapshotEntry` views (copy-on-write: the parent arrays are
    never mutated after publish, so entry views stay immutable).
    """

    bucket: Tuple[int, int]
    model_ids: Tuple[str, ...]
    versions: np.ndarray  # (G,) committed posterior versions
    means: np.ndarray  # (G, H, n_pad), data units
    variances: np.ndarray  # (G, H, n_pad), data units
    n_series: np.ndarray  # (G,) true series counts
    names: Tuple[Tuple[str, ...], ...]


class SnapshotStore:
    """Versioned, lock-free-read store of precomputed forecast moments.

    Writers (dispatch threads, already serialized per model by the
    service's update lock) publish under ``_lock``; readers touch only
    two plain dicts whose values are swapped atomically (GIL), never a
    lock.  ``read`` is the entire hot path — see the module docstring
    for the consistency argument.

    The cache counters (``hits``/``misses``/``stale``) are unlocked
    plain ints by design: a read must not pay for its own telemetry.
    Under concurrent readers they are approximate (lost increments are
    possible and harmless); :meth:`bind_metrics` exposes them as
    monotone callback gauges evaluated at scrape time.
    """

    def __init__(self, horizons, clock=time.monotonic, events=None):
        self.horizons: Tuple[int, ...] = parse_horizons(horizons)
        if not self.horizons:
            raise ValueError(
                "SnapshotStore needs a non-empty horizon set "
                "(METRAN_TPU_SERVE_HORIZONS)"
            )
        #: ``forecast(steps=s)`` is cacheable iff ``s <= prefix``
        self.prefix = contiguous_prefix(self.horizons)
        self._clock = clock
        self.events = events
        self._lock = threading.Lock()  # writers only
        self._entries: Dict[str, SnapshotEntry] = {}
        self._latest: Dict[str, int] = {}  # last committed version
        #: second publication sink (the JAX package's cluster snapshot
        #: plane, ROADMAP A7): every publish/forget is forwarded AFTER
        #: the in-process store commits.  ``None`` in the port, which
        #: serves one process.
        self.mirror = None
        # unlocked telemetry (see class docstring)
        self.hits = 0
        self.misses = 0
        self.stale = 0
        self.publishes = 0

    # -- read (the hot path) --------------------------------------------
    def read(self, model_id: str, steps: int) -> Optional[SnapshotEntry]:
        """The model's current entry when it can serve a ``steps``-long
        forecast at the latest committed version, else ``None`` (the
        caller falls through to the compute path).  Lock-free."""
        entry = self._entries.get(model_id)
        if entry is None or steps > self.prefix or steps < 1:
            self.misses += 1
            return None
        if self._latest.get(model_id) != entry.version:
            self.stale += 1
            return None
        self.hits += 1
        return entry

    # -- write ----------------------------------------------------------
    def note_commit(self, model_id: str, version: int) -> None:
        """Record that ``version`` is now the model's committed
        posterior (invalidation: an entry at any OTHER version stops
        serving).  Wired to :meth:`ModelRegistry.on_commit` so external
        ``put``\\ s invalidate exactly like served updates.

        Unconditional, not monotone: a refit hot-swap or operator
        restore may legitimately ``put`` a LOWER version (a fresh
        extraction starts at 0), and the read path's equality check
        must then stop serving the replaced posterior's entry — the
        committed registry state is the truth, whatever its counter
        says."""
        with self._lock:
            self._latest[model_id] = int(version)

    def publish(self, snapshot: ForecastSnapshot) -> int:
        """Publish one dispatch's committed moments (see
        :class:`ForecastSnapshot`); returns how many entries landed.
        Last write wins: per-model commits are serialized upstream
        (the service's update lock and ordering chains), and even an
        out-of-order publish only degrades to a version mismatch on
        read — a fallthrough, never a wrong answer."""
        now = float(self._clock())
        entries = []
        for g, mid in enumerate(snapshot.model_ids):
            n = int(snapshot.n_series[g])
            entries.append(SnapshotEntry(
                model_id=mid,
                version=int(snapshot.versions[g]),
                means=snapshot.means[g, :, :n],
                variances=snapshot.variances[g, :, :n],
                names=snapshot.names[g],
                published_at=now,
            ))
        return self.publish_entries(
            entries, _already_stamped=True, _bucket=str(snapshot.bucket)
        )

    def publish_entries(self, entries: Iterable[SnapshotEntry],
                        _already_stamped: bool = False,
                        _bucket: Optional[str] = None) -> int:
        """Publish prebuilt entries (the dict-registry dispatch path,
        where per-slot finalize produces them one at a time).  Every
        non-empty publication — this path and :meth:`publish` — emits
        one ``snapshot_publish`` event."""
        if not _already_stamped:
            now = float(self._clock())
            entries = [e._replace(published_at=now) for e in entries]
        else:
            entries = list(entries)
        n_pub = 0
        with self._lock:
            for entry in entries:
                # entries are immutable by contract; enforce it — a
                # caller mutating a served Forecast's arrays in place
                # would otherwise corrupt every later read of this
                # version (readers get views of these arrays)
                entry.means.setflags(write=False)
                entry.variances.setflags(write=False)
                # last write wins — see publish(): no version guard,
                # or a hot-swap that restarted a model's counter at a
                # lower version could never publish past the old entry
                self._entries[entry.model_id] = entry
                self._latest[entry.model_id] = entry.version
                n_pub += 1
            if n_pub:
                self.publishes += 1
        if n_pub and self.events is not None:
            self.events.emit(
                "snapshot_publish", fault_point="serve.readpath",
                models=n_pub, horizons=len(self.horizons),
                **({"bucket": _bucket} if _bucket is not None else {}),
            )
        if n_pub and self.mirror is not None:
            # cross-process sink: forwarded after the in-process store
            # committed (mirror-before-store would let a cluster reader
            # see an entry this process's read path does not).  Mirror
            # failures are contained — the plane is an optimization
            # sink, and the in-process publication already succeeded.
            try:
                self.mirror.publish_entries(entries)
            except Exception:  # pragma: no cover - plane degraded
                import logging

                logging.getLogger(__name__).exception(
                    "snapshot plane mirror publish failed (in-process "
                    "store is committed; cluster readers fall through)"
                )
        return n_pub

    def forget(self, model_id: str) -> None:
        """Drop a model's entry and version record (a model removed
        from service; eviction does NOT need this — a spilled row's
        entry stays valid at its version)."""
        with self._lock:
            self._entries.pop(model_id, None)
            self._latest.pop(model_id, None)
        if self.mirror is not None:
            try:
                self.mirror.forget(model_id)
            except Exception:  # pragma: no cover - plane degraded
                pass

    # -- introspection ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def oldest_age_s(self) -> float:
        """Age (seconds) of the oldest live entry, 0.0 when empty —
        the staleness ceiling an operator watches."""
        with self._lock:
            if not self._entries:
                return 0.0
            oldest = min(e.published_at for e in self._entries.values())
        return max(float(self._clock()) - oldest, 0.0)

    def stats(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "stale": self.stale,
            "publishes": self.publishes,
            "entries": len(self._entries),
        }

    def bind_metrics(self, registry) -> None:
        """Expose the cache telemetry in a metrics registry (anything
        with ``gauge(name, help, callback=)``; the port's services bind
        none until the observability layer, ROADMAP A7).

        The three ``*_total`` series are monotone counters exposed as
        **callback gauges**: the read path increments plain ints and a
        scrape reads them back, so full instrumentation adds zero work
        per read (the 5% obs-overhead bar holds trivially on the
        cached path)."""
        registry.gauge(
            "metran_serve_forecast_cache_hits_total",
            "forecast reads served from the snapshot cache (monotone; "
            "callback-read so the lock-free read path pays nothing)",
            callback=lambda: float(self.hits),
        )
        registry.gauge(
            "metran_serve_forecast_cache_misses_total",
            "forecast reads with no usable snapshot entry (fell "
            "through to the compute path)",
            callback=lambda: float(self.misses),
        )
        registry.gauge(
            "metran_serve_forecast_cache_stale_total",
            "forecast reads whose entry predates the committed "
            "version (fell through to the compute path)",
            callback=lambda: float(self.stale),
        )
        registry.gauge(
            "metran_serve_forecast_snapshot_age_seconds",
            "age of the oldest live snapshot entry (staleness ceiling)",
            callback=self.oldest_age_s,
        )
        registry.gauge(
            "metran_serve_forecast_snapshot_entries",
            "models with a live snapshot entry",
            callback=lambda: float(len(self._entries)),
        )
