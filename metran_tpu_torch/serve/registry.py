"""Model registry: posterior states, shape buckets, serving functions.

Port of ``metran_tpu/serve/registry.py``.  Models are bucketed by their
padded ``(n_series, n_state)`` shape (both dims rounded up to
``bucket_multiple``), so one kernel launch serves every model of a
bucket.  In dict mode states live in memory, with optional
write-through to one ``{model_id}.npz`` per model under ``root``; a
corrupt file is moved aside into ``root/.quarantine`` and never served.

With ``arena=True`` each bucket's posteriors live in one preallocated
device-resident :class:`~metran_tpu_torch.serve.state.StateArena`,
updated in place by the arena kernels (K16, K17; forecasts K18): the
host keeps a ``model_id -> (bucket, row)`` indirection, the immutable
:class:`~metran_tpu_torch.serve.state.ModelMeta` per model and an LRU
for row eviction, which spills to the usual per-model ``.npz``;
durability moves from write-through to spills (:meth:`ModelRegistry.
spill`, :meth:`ModelRegistry.evict`, ``MetranService.close``).

PyTorch runs eagerly, so there is nothing to compile per bucket: the
``*_fn`` accessors return the bound serving functions.  Commit hooks
(:meth:`ModelRegistry.on_commit`) observe every :meth:`ModelRegistry.
put`; the read path's snapshot store invalidates through them.  The JAX
registry's compiled-function ledger and metrics (ROADMAP A7) come in a
later slice.
"""

from __future__ import annotations

import os
import threading
import time
from collections import Counter, OrderedDict
from logging import getLogger
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import mesh_devices, resolve_device, serve_defaults
from ..ops.detect import detect_stats
from ..parallel.mesh import make_mesh, pad_to_multiple
from ..reliability.policy import StateIntegrityError
from .engine import (
    SERVE_ENGINES,
    SQRT_ENGINES,
    make_arena_forecast_fn,
    make_arena_steady_update_fn,
    make_arena_update_fn,
    make_forecast_fn,
    make_steady_update_fn,
    make_update_fn,
    posterior_fault,
)
from .state import ModelMeta, PosteriorState, StateArena

logger = getLogger(__name__)

ShapeBucket = Tuple[int, int]  # padded (n_series, n_state)

#: where corrupt state files are moved (never deleted)
QUARANTINE_DIR = ".quarantine"


class ModelRegistry:
    """Loads, caches and buckets :class:`PosteriorState`\\ s for serving.

    Parameters
    ----------
    root : directory of per-model ``{model_id}.npz`` state files; ``None``
        for a purely in-memory registry.
    bucket_multiple : both bucket dims round up to a multiple of this
        (default from :func:`metran_tpu_torch.config.serve_defaults`).
    max_compiled : the JAX registry's compiled-kernel LRU size; accepted
        for the same signature and without effect (eager PyTorch
        compiles nothing per bucket).
    engine : update engine (default ``serve_defaults()["engine"]``):
        ``"joint"`` (covariance form, K1), ``"sequential"`` (covariance
        form, one slot at a time, K12 with the gate off), ``"sqrt"``
        (square-root form: updates carry Cholesky factors through K9;
        posteriors are PSD by construction and the integrity gate is a
        finiteness check — the engine for float32 serving) or
        ``"sqrt_parallel"`` (the associative-scan square-root engine's
        registry: it updates exactly as ``"sqrt"``, as in the JAX
        package).  ``"parallel"`` has no serving update (nor in the JAX
        package) and raises.
    validate : run the numerical posterior gate on every disk load
        (default ``serve_defaults()["validate_updates"]``); file
        integrity checks (parse, checksum) always run.
    arena : serve from device-resident state arenas (default
        ``serve_defaults()["arena"]``, ``METRAN_TPU_SERVE_ARENA``; shipped
        off).  Updates resolve to ``ArenaUpdateAck``\\ s and persist on
        spill, not per request.
    arena_rows : per-bucket arena capacity (rows preallocated; one
        scratch row is added internally, as in the JAX arena).
    arena_mesh : devices to shard each arena's rows across: 0 is one
        arena on ``device``; n > 0 the first n (at most all) of
        :func:`~metran_tpu_torch.config.mesh_devices` for ``device``, -1
        every one of them (``METRAN_TPU_VIRTUAL_DEVICES`` repeats a device
        into a virtual mesh).
    device : where arenas live (default: the CUDA card; without one an
        arena registry raises — pass ``device="cpu"``).
    """

    def __init__(self, root=None, bucket_multiple: Optional[int] = None,
                 max_compiled: Optional[int] = None,
                 engine: Optional[str] = None,
                 validate: Optional[bool] = None,
                 arena: Optional[bool] = None,
                 arena_rows: Optional[int] = None,
                 arena_mesh: Optional[int] = None, device=None):
        defaults = serve_defaults()
        if engine is None:
            engine = defaults["engine"]
        if bucket_multiple is None:
            bucket_multiple = defaults["bucket_multiple"]
        if validate is None:
            validate = bool(defaults["validate_updates"])
        if arena is None:
            arena = bool(defaults["arena"])
        if arena_rows is None:
            arena_rows = int(defaults["arena_rows"])
        if arena_mesh is None:
            arena_mesh = int(defaults["arena_mesh"])
        if engine not in SERVE_ENGINES:
            raise ValueError(
                f"serve engine {engine!r} has no serving update; the "
                f"registry serves engine={' or '.join(map(repr, SERVE_ENGINES))}"
            )
        self.engine = engine
        self.bucket_multiple = int(bucket_multiple)
        self.max_compiled = max_compiled
        self.validate = bool(validate)
        self.root = Path(root) if root is not None else None
        if self.root is not None:
            self.root.mkdir(parents=True, exist_ok=True)
        self._states: Dict[str, PosteriorState] = {}
        self._lock = threading.Lock()
        self._integrity: Counter = Counter()
        self.arena_enabled = bool(arena)
        self.arena_rows = int(arena_rows)
        self.arena_mesh = int(arena_mesh)
        self.device = None
        self._mesh = None
        if self.arena_enabled:
            self.device = resolve_device(device)
            if self.arena_mesh != 0:
                devices = mesh_devices(self.device)
                n = len(devices) if self.arena_mesh < 0 else min(
                    self.arena_mesh, len(devices))
                self._mesh = make_mesh(n, devices=devices)
        self._arenas: Dict[ShapeBucket, StateArena] = {}
        self._arena_meta: Dict[str, ModelMeta] = {}
        self._row_map: Dict[str, Tuple[ShapeBucket, int]] = {}
        self._arena_lru: "OrderedDict[str, None]" = OrderedDict()
        # guards the indirection tables and the LRU (each arena's leaves
        # have their own lock); re-entrant: eviction runs inside
        # ensure_resident
        self._arena_lock = threading.RLock()
        # models whose rows an in-flight dispatch has resolved (pin
        # refcounts): eviction never reassigns a pinned row, so one
        # dispatch never holds duplicate or stale rows
        self._pinned: Dict[str, int] = {}
        self.arena_events: Counter = Counter()
        #: monotonic instant of the last completed spill()
        self._last_spill_at: Optional[float] = None
        #: ``(model_id, version)`` observers fired by every put
        self._commit_hooks: List[Callable[[str, int], None]] = []

    # ------------------------------------------------------------------
    # state storage
    # ------------------------------------------------------------------
    @staticmethod
    def check_model_id(model_id: str) -> str:
        """Reject ids that cannot round-trip through flat file storage."""
        model_id = str(model_id)
        if (
            not model_id
            or model_id.startswith(".")
            or any(c in model_id for c in ("/", "\\", "\0"))
        ):
            raise ValueError(
                f"model_id {model_id!r} is not storable: it must be "
                "non-empty, not start with '.', and contain no path "
                "separators"
            )
        return model_id

    def path_for(self, model_id: str) -> Path:
        if self.root is None:
            raise ValueError("in-memory registry has no storage root")
        return self.root / f"{self.check_model_id(model_id)}.npz"

    def on_commit(self, callback: Callable[[str, int], None]) -> None:
        """Register a ``(model_id, version)`` observer fired on every
        :meth:`put` once the in-memory or arena state is replaced (before
        the disk write-through: memory is the committed state).  A failing
        observer is logged, never raised: cache invalidation must not take
        down the write path."""
        self._commit_hooks.append(callback)

    def remove_commit_hook(self, callback) -> None:
        """Unregister an :meth:`on_commit` observer (idempotent); a
        service detaches its snapshot store here on close."""
        try:
            self._commit_hooks.remove(callback)
        except ValueError:
            pass

    def _notify_commit(self, model_id: str, version: int) -> None:
        for cb in self._commit_hooks:
            try:
                cb(model_id, version)
            except Exception:  # pragma: no cover - observer bug
                logger.exception("commit observer failed for %r", model_id)

    def put(self, state: PosteriorState,
            persist: bool = True) -> PosteriorState:
        """Insert/replace a model's state (write-through when ``persist``
        and the registry has a root; memory is updated first).  When the
        model is arena-resident its row is re-packed in place (same
        bucket) or released (shape changed — it re-packs into the right
        arena on the next touch), so a ``put`` never leaves a stale row
        serving."""
        self.check_model_id(state.model_id)
        with self._lock:
            self._states[state.model_id] = state
        if self.arena_enabled:
            with self._arena_lock:
                hit = self._row_map.get(state.model_id)
                if hit is not None:
                    bucket, row = hit
                    arena = self._arenas.get(bucket)
                    if arena is None or arena.lost:
                        self._drop_lost_arena(bucket)
                    elif self.bucket_of(state) == bucket:
                        arena.write_row(row, state)
                        self._arena_meta[state.model_id] = ModelMeta.of(
                            state)
                    else:
                        arena.clear_row(row)
                        del self._row_map[state.model_id]
                        self._arena_lru.pop(state.model_id, None)
        self._notify_commit(state.model_id, state.version)
        if persist and self.root is not None:
            state.save(self.path_for(state.model_id))
        return state

    def quarantine_dir(self) -> Path:
        if self.root is None:
            raise ValueError("in-memory registry has no storage root")
        return self.root / QUARANTINE_DIR

    def _quarantine(self, path: Path, reason: str) -> Optional[Path]:
        """Move a corrupt state file aside (never delete — operators
        inspect quarantined files) and count the event."""
        qdir = self.quarantine_dir()
        qdir.mkdir(exist_ok=True)
        dest = qdir / path.name
        if dest.exists():  # repeated corruption of one model id
            dest = qdir / f"{path.name}.{os.getpid()}-{os.urandom(4).hex()}"
        try:
            path.replace(dest)
        except FileNotFoundError:  # pragma: no cover - concurrent move
            return None
        self._integrity["quarantined"] += 1
        logger.error("quarantined corrupt state file %s -> %s (%s)",
                     path, dest, reason)
        return dest

    def _load(self, model_id: str, path: Path) -> PosteriorState:
        """Load and validate one on-disk state; quarantine on
        corruption (a well-formed file in a newer format is not corrupt
        and stays where it is)."""
        try:
            state = PosteriorState.load(path)
        except StateIntegrityError as exc:
            self._integrity["load_failures"] += 1
            self._quarantine(path, str(exc))
            raise
        except ValueError:
            self._integrity["load_failures"] += 1
            raise
        if self.validate:
            # the numerical posterior gate on every disk load
            fault = posterior_fault(state.mean, state.cov, chol=state.chol)
            if fault is not None:
                self._integrity["load_failures"] += 1
                self._quarantine(path, fault)
                raise StateIntegrityError(
                    f"stored state for model {model_id!r} is invalid: "
                    f"{fault}"
                )
        return state

    def get(self, model_id: str, refresh: bool = False) -> PosteriorState:
        """The model's current state: its arena row when resident (read
        back from the device — the row IS the newest state, so
        ``refresh`` never rolls it back), else memory, then disk.
        ``refresh`` re-reads disk, never rolling an in-memory version
        back; a corrupt file is quarantined and the last-good in-memory
        state served when there is one."""
        if self.arena_enabled:
            with self._arena_lock:
                hit = self._row_map.get(model_id)
                if hit is not None:
                    bucket, row = hit
                    arena = self._arenas.get(bucket)
                    if arena is not None and not arena.lost:
                        return arena.materialize(
                            row, self._arena_meta[model_id])
                    self._drop_lost_arena(bucket)
        return self._base_get(model_id, refresh)

    def _base_get(self, model_id: str,
                  refresh: bool = False) -> PosteriorState:
        """The dict lookup (memory, then disk) — also the arena's backing
        store for non-resident models."""
        state = self._states.get(model_id)
        if state is not None and not refresh:
            return state
        if self.root is None:
            if state is not None:
                return state
            raise KeyError(f"unknown model {model_id!r}")
        path = self.path_for(model_id)
        if not path.exists():
            if state is not None:
                return state
            raise KeyError(f"unknown model {model_id!r} (no {path})")
        try:
            fresh = self._load(model_id, path)
        except FileNotFoundError:
            if state is not None:
                return state
            raise KeyError(f"unknown model {model_id!r} (no {path})") from None
        except (StateIntegrityError, ValueError):
            if state is not None:
                self._integrity["served_last_good"] += 1
                return state
            raise
        if state is not None and fresh.version < state.version:
            self._integrity["stale_disk_reads"] += 1
            return state
        with self._lock:
            self._states[model_id] = fresh
        return fresh

    def __contains__(self, model_id: str) -> bool:
        try:
            self.get(model_id)
            return True
        except (KeyError, StateIntegrityError, ValueError, OSError,
                MemoryError):
            return False

    def model_ids(self) -> List[str]:
        """Every known model id (memory plus on-disk)."""
        ids = set(self._states)
        if self.root is not None:
            ids.update(
                p.stem for p in self.root.glob("*.npz")
                if not p.name.startswith(".")
            )
        return sorted(ids)

    @property
    def _sqrt_engine(self) -> bool:
        return self.engine in SQRT_ENGINES

    # ------------------------------------------------------------------
    # device-resident state arena (indirection, allocation, eviction)
    # ------------------------------------------------------------------
    def arena_for(self, bucket: ShapeBucket, dtype=None) -> StateArena:
        """The bucket's arena, created on first use (capacity
        ``arena_rows``); a lost arena is dropped and rebuilt empty — its
        models re-pack lazily from their last-good states."""
        with self._arena_lock:
            arena = self._arenas.get(bucket)
            if arena is not None and arena.lost:
                self._drop_lost_arena(bucket)
                arena = None
            if arena is None:
                arena = self._arenas[bucket] = StateArena(
                    bucket, self.arena_rows, dtype=dtype,
                    sqrt=self._sqrt_engine, mesh=self._mesh,
                    device=self.device)
            return arena

    def _drop_lost_arena(self, bucket: ShapeBucket) -> None:
        """Forget a lost arena and every row mapping into it; its models
        fall back to their last-good states and re-pack on next touch."""
        with self._arena_lock:
            arena = self._arenas.pop(bucket, None)
            if arena is None:
                return
            dropped = [mid for mid, (b, _) in self._row_map.items()
                       if b == bucket]
            for mid in dropped:
                del self._row_map[mid]
                self._arena_lru.pop(mid, None)
            self.arena_events["rebuilds"] += 1
            logger.error("dropped lost arena %s (%d resident model(s) fall "
                         "back to last-good states)", bucket, len(dropped))

    def meta(self, model_id: str):
        """The model's immutable serving metadata — the submit-path
        accessor: the full state in dict mode, the host-side
        :class:`~metran_tpu_torch.serve.state.ModelMeta` in arena mode
        (making the model resident first; same KeyError /
        StateIntegrityError contract as :meth:`get`)."""
        if not self.arena_enabled:
            return self.get(model_id)
        with self._arena_lock:
            if model_id in self._row_map:
                return self._arena_meta[model_id]
        self.ensure_resident(model_id)
        return self._arena_meta[model_id]

    def ensure_resident(self, model_id: str) -> Tuple[ShapeBucket, int]:
        """Make the model arena-resident; returns its ``(bucket, row)``.

        A cold model loads through the same path as a dict-mode
        :meth:`get` (memory, then disk with its checks and quarantine),
        takes a free row — evicting the bucket's least-recently-touched
        unpinned model first when the arena is full — and packs in."""
        if not self.arena_enabled:
            raise ValueError("registry has no arena (arena=False)")
        with self._arena_lock:
            hit = self._row_map.get(model_id)
            if hit is not None:
                arena = self._arenas.get(hit[0])
                if arena is not None and not arena.lost:
                    self._arena_lru.move_to_end(model_id)
                    return hit
                self._drop_lost_arena(hit[0])
            state = self._base_get(model_id)
            bucket = self.bucket_of(state)
            arena = self.arena_for(bucket, dtype=state.dtype)
            row = arena.alloc()
            while row is None:
                victim = next(
                    (m for m in self._arena_lru
                     if self._row_map[m][0] == bucket
                     and m not in self._pinned), None)
                if victim is None:
                    raise RuntimeError(
                        f"arena {bucket} is full and every resident row is "
                        "pinned by in-flight dispatches; size arena_rows "
                        "to the working fleet (or retry)")
                self.evict(victim)
                row = arena.alloc()
            arena.write_row(row, state)
            self._arena_meta[model_id] = ModelMeta.of(state)
            self._row_map[model_id] = (bucket, row)
            self._arena_lru[model_id] = None
            self._arena_lru.move_to_end(model_id)
            self.arena_events["loads"] += 1
            return (bucket, row)

    def rows_for(self, model_ids, pin: bool = False):
        """Bulk :meth:`ensure_resident` under one lock acquisition:
        ``(hits, errs)`` with ``hits[i]`` the ``(bucket, row)`` or
        ``None`` where ``errs[i]`` carries that model's exception.
        ``pin=True`` pins every resolved model until the matching
        :meth:`release_rows`, so neither a colder model later in the same
        batch nor a concurrent load can reassign a resolved row; a model
        whose resolution would need a pinned row's eviction fails its
        own slot."""
        hits, errs = [], []
        with self._arena_lock:
            for mid in model_ids:
                hit = self._row_map.get(mid)
                if hit is not None:
                    arena = self._arenas.get(hit[0])
                    if arena is not None and not arena.lost:
                        self._arena_lru.move_to_end(mid)
                        if pin:
                            self._pinned[mid] = self._pinned.get(mid, 0) + 1
                        hits.append(hit)
                        errs.append(None)
                        continue
                try:
                    hit = self.ensure_resident(mid)
                    if pin:
                        self._pinned[mid] = self._pinned.get(mid, 0) + 1
                    hits.append(hit)
                    errs.append(None)
                except Exception as exc:  # noqa: BLE001 - per-slot
                    hits.append(None)
                    errs.append(exc)
        return hits, errs

    def release_rows(self, model_ids) -> None:
        """Undo one :meth:`rows_for` ``pin=True`` (refcounted; call from
        a ``finally``)."""
        with self._arena_lock:
            for mid in model_ids:
                count = self._pinned.get(mid)
                if count is None:
                    continue
                if count <= 1:
                    del self._pinned[mid]
                else:
                    self._pinned[mid] = count - 1

    def arena_of(self, bucket: ShapeBucket) -> StateArena:
        """The bucket's EXISTING arena — never creates or rebuilds (a
        dispatch that resolved its rows must not be handed a fresh empty
        arena)."""
        with self._arena_lock:
            arena = self._arenas.get(bucket)
            if arena is None:
                raise StateIntegrityError(
                    f"arena {bucket} is not available (dropped after a "
                    "failed dispatch); rows re-pack on next touch")
            return arena

    def evict(self, model_id: str) -> Optional[PosteriorState]:
        """Spill one resident model to its ``.npz`` and free its row.
        The state is persisted (atomically) before the row is released,
        so a crash in between leaves a resident row or a spilled model,
        never a freed row whose state exists nowhere.  Returns the
        spilled state (``None`` when the model was not resident)."""
        with self._arena_lock:
            hit = self._row_map.get(model_id)
            if hit is None:
                return None
            if model_id in self._pinned:
                raise RuntimeError(
                    f"model {model_id!r} is pinned by an in-flight "
                    "dispatch and cannot be evicted right now")
            bucket, row = hit
            arena = self._arenas.get(bucket)
            if arena is None or arena.lost:
                self._drop_lost_arena(bucket)
                return None
            state = arena.materialize(row, self._arena_meta[model_id])
            if self.root is not None:
                state.save(self.path_for(model_id))
                self.arena_events["spills"] += 1
            with self._lock:
                self._states[model_id] = state  # last-good fallback
            arena.clear_row(row)
            del self._row_map[model_id]
            self._arena_lru.pop(model_id, None)
            self.arena_events["evictions"] += 1
            return state

    def spill(self, dirty_only: bool = True, directory=None) -> int:
        """Checkpoint resident rows to disk WITHOUT freeing them (needs
        ``root``; a no-op otherwise): updates dirty their rows in place,
        and dirty rows persist here — on ``MetranService.close`` or an
        operator's checkpoint cadence.  ``directory`` redirects the files
        away from the root.  Returns the number of rows written."""
        if not self.arena_enabled or self.root is None:
            return 0
        target = Path(directory) if directory is not None else None
        snapshots: list = []
        with self._arena_lock:
            by_bucket: Dict[ShapeBucket, list] = {}
            for mid, (bucket, row) in self._row_map.items():
                arena = self._arenas.get(bucket)
                if arena is None or arena.lost:
                    continue
                if dirty_only and not arena.dirty[row]:
                    continue
                by_bucket.setdefault(bucket, []).append((mid, row))
            for bucket, entries in by_bucket.items():
                arena = self._arenas[bucket]
                means, facs = arena.read_rows([r for _, r in entries])
                for (mid, row), mean_p, fac_p in zip(entries, means, facs):
                    snapshots.append((arena, bucket, mid, row,
                                      arena.materialize_values(
                                          mean_p, fac_p, row,
                                          self._arena_meta[mid])))
                    # pinned for the write phase: a concurrent eviction
                    # would persist a newer version this snapshot must
                    # not overwrite
                    self._pinned[mid] = self._pinned.get(mid, 0) + 1
        n = 0
        try:
            for arena, bucket, mid, row, state in snapshots:
                state.save(target / f"{self.check_model_id(mid)}.npz"
                           if target is not None else self.path_for(mid))
                with self._arena_lock:
                    # the row stays spill-clean only if nothing updated
                    # or moved it while we wrote
                    if (self._row_map.get(mid) == (bucket, row)
                            and arena is self._arenas.get(bucket)
                            and not arena.lost
                            and int(arena.version_host[row])
                            == state.version):
                        with arena.lock:
                            arena.dirty[row] = False
                    with self._lock:
                        prev = self._states.get(mid)
                        if prev is None or prev.version <= state.version:
                            self._states[mid] = state
                self.arena_events["spills"] += 1
                n += 1
        finally:
            self.release_rows([mid for _, _, mid, _, _ in snapshots])
        self._last_spill_at = time.monotonic()
        return n

    def last_spill_age(self) -> Optional[float]:
        """Seconds since the last completed :meth:`spill` (``None``
        before the first) — the durability-lag signal ``health()``
        reports."""
        at = self._last_spill_at
        return None if at is None else max(0.0, time.monotonic() - at)

    def loaded_model_ids(self) -> List[str]:
        """Ids with an in-memory state (arena registries keep each
        model's last packed or spilled state here as the rebuild
        fallback)."""
        return list(self._states)

    def last_good_state(self, model_id: str) -> Optional[PosteriorState]:
        """The in-memory copy of a model's state without touching the
        device (in arena mode the last packed/spilled snapshot, possibly
        behind the live row — compare :meth:`current_versions`)."""
        return self._states.get(model_id)

    def current_versions(self) -> Dict[str, int]:
        """Every known model's current serving version, host-side only
        (arena rows answer from the version mirror)."""
        out = {mid: int(st.version) for mid, st in self._states.items()}
        if self.arena_enabled:
            with self._arena_lock:
                for mid, (bucket, row) in self._row_map.items():
                    arena = self._arenas.get(bucket)
                    if arena is None or arena.lost:
                        continue
                    out[mid] = int(arena.version_host[row])
        return out

    def _resident_by_bucket(self, model_id: Optional[str] = None):
        """``{bucket: [(model_id, row), ...]}`` of the resident models
        (all, or one) in live arenas; call under ``_arena_lock``."""
        by_bucket: Dict[ShapeBucket, list] = {}
        for mid, (bucket, row) in self._row_map.items():
            if model_id is not None and mid != model_id:
                continue
            arena = self._arenas.get(bucket)
            if arena is None or arena.lost:
                continue
            by_bucket.setdefault(bucket, []).append((mid, row))
        return by_bucket

    def arena_detect_states(self) -> Dict[str, np.ndarray]:
        """Every resident row's raw (6, N) detector accumulators (one
        device-to-host gather per bucket); :meth:`restore_arena_detect_
        states` is the inverse."""
        out: Dict[str, np.ndarray] = {}
        if not self.arena_enabled:
            return out
        with self._arena_lock:
            for bucket, entries in self._resident_by_bucket().items():
                states = self._arenas[bucket].read_det_rows(
                    [r for _, r in entries])
                for (mid, _row), st in zip(entries, states):
                    out[mid] = st
        return out

    def restore_arena_detect_states(self,
                                    states: Dict[str, np.ndarray]) -> int:
        """Scatter saved detector accumulators back into the arena leaves
        (models made resident first: a re-pack resets the leaf, so a
        restore runs after residency)."""
        n = 0
        by_bucket: Dict[ShapeBucket, list] = {}
        for mid, st in states.items():
            try:
                bucket, row = self.ensure_resident(mid)
            except Exception:  # noqa: BLE001 - per-model isolation
                logger.exception("could not restore detector state for %r",
                                 mid)
                continue
            by_bucket.setdefault(bucket, []).append((row, st))
        for bucket, entries in by_bucket.items():
            arena = self.arena_of(bucket)
            padded = np.zeros((len(entries), entries[0][1].shape[0],
                               bucket[0]), arena.dtype)
            for i, (_row, st) in enumerate(entries):
                padded[i, :, : st.shape[1]] = st
            arena.write_det_rows([r for r, _ in entries], padded)
            n += len(entries)
        return n

    def arena_steady_models(self) -> List[str]:
        """Ids of currently frozen (steady) arena rows."""
        out: List[str] = []
        if not self.arena_enabled:
            return out
        with self._arena_lock:
            for bucket, entries in self._resident_by_bucket().items():
                arena = self._arenas[bucket]
                out.extend(mid for mid, row in entries
                           if bool(arena.steady_host[row]))
        return out

    @property
    def arena_stats(self) -> Dict[str, int]:
        """Arena occupancy and lifetime lifecycle counters (loads,
        spills, evictions, rebuilds)."""
        resident, free = self._arena_rows_count()
        return {"arenas": len(self._arenas), "rows_resident": resident,
                "rows_free": free, **self.arena_events}

    def _arena_rows_count(self) -> Tuple[int, int]:
        with self._arena_lock:
            arenas = list(self._arenas.values())
        return (sum(a.occupied_rows for a in arenas),
                sum(a.free_rows for a in arenas))

    def arena_detect_stats(self, model_id: Optional[str] = None):
        """Live per-slot detection statistics of resident models:
        ``{model_id: (stats (3, n), n_series, version, t_seen)}``, rows
        ``[cusum_pos, cusum_neg, lb_q]``, from one read of each arena's
        detector leaf per query (the update path never pays it)."""
        out = {}
        if not self.arena_enabled:
            return out
        with self._arena_lock:
            for bucket, entries in self._resident_by_bucket(
                    model_id).items():
                arena = self._arenas[bucket]
                det = arena.read_det_rows([r for _, r in entries])
                stats = detect_stats(torch.from_numpy(det)).numpy()
                for (mid, row), st in zip(entries, stats):
                    n = int(arena.n_series_host[row])
                    out[mid] = (st[:, :n].copy(), n,
                                int(arena.version_host[row]),
                                int(arena.t_seen_host[row]))
        return out

    def steady_rows_count(self) -> int:
        """Frozen (steady) rows across every arena."""
        with self._arena_lock:
            arenas = list(self._arenas.values())
        return sum(a.steady_rows for a in arenas)

    # ------------------------------------------------------------------
    # shape buckets & serving functions
    # ------------------------------------------------------------------
    def bucket_of(self, state) -> ShapeBucket:
        """The padded (n_series, n_state) bucket this model serves from
        (a :class:`PosteriorState` or a :class:`ModelMeta`)."""
        m = self.bucket_multiple
        n_pad = pad_to_multiple(state.n_series, m)
        return (n_pad, pad_to_multiple(n_pad + state.n_factors, m))

    def update_fn(self, bucket: ShapeBucket, k: int, gate=None,
                  horizons=None, detect=None, robust=None):
        """The bucket's assimilation function for ``k`` appended steps
        (:func:`~metran_tpu_torch.serve.engine.make_update_fn`): the
        gate, robust and detect specs select the gated or robust update
        and the detector."""
        return make_update_fn(engine=self.engine, gate=gate,
                              horizons=horizons, detect=detect,
                              robust=robust)

    def steady_update_fn(self, bucket: ShapeBucket, k: int, gate=None,
                         horizons=None, detect=None):
        """The bucket's **steady** (frozen-gain, mean-only) update for
        ``k`` appended steps
        (:func:`~metran_tpu_torch.serve.engine.make_steady_update_fn`,
        K14).  Ungated it is engine-agnostic; an enabled gate selects
        the gate form of the exact update this registry thaws back to —
        per slot on the covariance engines, marginal on the square-root
        one."""
        return make_steady_update_fn(
            gate=gate, horizons=horizons,
            sequential_gate=self.steady_sequential_gate(gate),
            detect=detect)

    def steady_sequential_gate(self, gate) -> bool:
        """Whether this registry's frozen models gate per slot: the
        frozen gate must match the exact update a model thaws back to,
        so an enabled gate on a covariance engine freezes (and K14/K17
        read) the sequential gains ``kgain_seq``/``fdiag_seq`` on
        conditional variances; the square-root engine and any ungated
        registry freeze the joint ``kgain``/``fdiag``."""
        return bool(gate is not None and getattr(gate, "enabled", False)
                    and not self._sqrt_engine)

    def forecast_fn(self, bucket: ShapeBucket, steps: int):
        """The bucket's forecast function for a ``steps``-long horizon."""
        return make_forecast_fn(int(steps))

    def arena_update_fn(self, bucket: ShapeBucket, k: int, gate=None,
                        validate: bool = True, horizons=None,
                        steady_tol: float = 0.0, detect=None, robust=None):
        """The bucket's in-place arena assimilation (K16,
        :func:`~metran_tpu_torch.serve.engine.make_arena_update_fn`)."""
        return make_arena_update_fn(
            engine=self.engine, gate=gate, validate=validate,
            horizons=horizons, steady_tol=float(steady_tol),
            detect=detect, robust=robust)

    def arena_steady_update_fn(self, bucket: ShapeBucket, k: int,
                               gate=None, horizons=None, detect=None):
        """The bucket's in-place arena steady update (K17,
        :func:`~metran_tpu_torch.serve.engine.
        make_arena_steady_update_fn`) in this registry's gate form."""
        return make_arena_steady_update_fn(
            gate=gate, horizons=horizons,
            sequential_gate=self.steady_sequential_gate(gate),
            detect=detect)

    def arena_forecast_fn(self, bucket: ShapeBucket, steps: int):
        """The bucket's read-only arena forecast (K18)."""
        return make_arena_forecast_fn(int(steps), sqrt=self._sqrt_engine)

    # ------------------------------------------------------------------
    # arena memory accounting
    # ------------------------------------------------------------------
    def arena_bytes_total(self) -> int:
        """Device bytes pinned by RESIDENT rows across every arena (free
        rows are capacity, not cost)."""
        with self._arena_lock:
            arenas = list(self._arenas.values())
        return sum(a.occupied_rows * a.row_nbytes for a in arenas)

    def arena_bytes_by_model(self) -> Dict[str, int]:
        """Each resident model's device-byte footprint (its bucket's
        per-row bytes)."""
        out: Dict[str, int] = {}
        with self._arena_lock:
            for mid, (bucket, _row) in self._row_map.items():
                arena = self._arenas.get(bucket)
                if arena is not None and not arena.lost:
                    out[mid] = arena.row_nbytes
        return out

    @property
    def integrity_stats(self) -> Dict[str, int]:
        """Lifetime integrity-event counters (quarantines, load
        failures, last-good fallbacks, stale disk reads)."""
        return dict(self._integrity)


__all__ = ["ModelRegistry", "QUARANTINE_DIR", "ShapeBucket"]
