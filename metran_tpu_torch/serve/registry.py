"""Model registry: posterior states, shape buckets, serving functions.

Port of the dict mode of ``metran_tpu/serve/registry.py``.  Models are
bucketed by their padded ``(n_series, n_state)`` shape (both dims
rounded up to ``bucket_multiple``), so one kernel launch serves every
model of a bucket.  States live in memory, with optional write-through
to one ``{model_id}.npz`` per model under ``root``.

PyTorch runs eagerly, so there is nothing to compile per bucket:
:meth:`ModelRegistry.update_fn`/:meth:`~ModelRegistry.steady_update_fn`/
:meth:`~ModelRegistry.forecast_fn` return the bound serving functions.  The arena, quarantine, commit
hooks and observability of the JAX registry come in later slices.
"""

from __future__ import annotations

import threading
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..config import serve_defaults
from ..parallel.mesh import pad_to_multiple
from ..reliability.policy import StateIntegrityError
from .engine import (
    make_forecast_fn,
    make_steady_update_fn,
    make_update_fn,
    posterior_fault,
)
from .state import PosteriorState

ShapeBucket = Tuple[int, int]  # padded (n_series, n_state)


class ModelRegistry:
    """Loads, caches and buckets :class:`PosteriorState`\\ s for serving.

    Parameters
    ----------
    root : directory of per-model ``{model_id}.npz`` state files; ``None``
        for a purely in-memory registry.
    bucket_multiple : both bucket dims round up to a multiple of this
        (default from :func:`metran_tpu_torch.config.serve_defaults`).
    engine : update engine (default ``serve_defaults()["engine"]``):
        ``"joint"`` (covariance form, K1), ``"sequential"`` (covariance
        form, one slot at a time, K12 with the gate off) or ``"sqrt"``
        (square-root form: updates carry Cholesky factors through
        :func:`~metran_tpu_torch.ops.sqrt_filter_append`, K9; posteriors
        are PSD by construction and the per-slot integrity gate is a
        finiteness check — the engine for float32 serving).
    """

    def __init__(self, root=None, bucket_multiple: Optional[int] = None,
                 engine: Optional[str] = None):
        defaults = serve_defaults()
        if engine is None:
            engine = defaults["engine"]
        if bucket_multiple is None:
            bucket_multiple = defaults["bucket_multiple"]
        if engine not in ("joint", "sequential", "sqrt"):
            raise ValueError(
                f"serve engine {engine!r} is not ported yet (ROADMAP A6 for "
                "the associative-scan engines); the port serves "
                "engine='joint', 'sequential' and 'sqrt'"
            )
        self.engine = engine
        self.bucket_multiple = int(bucket_multiple)
        self.root = Path(root) if root is not None else None
        if self.root is not None:
            self.root.mkdir(parents=True, exist_ok=True)
        self._states: Dict[str, PosteriorState] = {}
        self._lock = threading.Lock()
        self._integrity: Counter = Counter()

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

    def put(self, state: PosteriorState,
            persist: bool = True) -> PosteriorState:
        """Insert/replace a model's state (write-through when ``persist``
        and the registry has a root; memory is updated first)."""
        self.check_model_id(state.model_id)
        with self._lock:
            self._states[state.model_id] = state
        if persist and self.root is not None:
            state.save(self.path_for(state.model_id))
        return state

    def _load(self, model_id: str, path: Path) -> PosteriorState:
        try:
            state = PosteriorState.load(path)
        except (StateIntegrityError, ValueError):
            self._integrity["load_failures"] += 1
            raise
        # the numerical posterior gate on every disk load
        fault = posterior_fault(state.mean, state.cov, chol=state.chol)
        if fault is not None:
            self._integrity["load_failures"] += 1
            raise StateIntegrityError(
                f"stored state for model {model_id!r} is invalid: {fault}"
            )
        return state

    def get(self, model_id: str, refresh: bool = False) -> PosteriorState:
        """The model's current state (memory, then disk).  ``refresh``
        re-reads disk, never rolling an in-memory version back."""
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
        return self.engine == "sqrt"

    # ------------------------------------------------------------------
    def bucket_of(self, state: PosteriorState) -> ShapeBucket:
        """The padded (n_series, n_state) bucket this model serves from."""
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
        so an enabled gate on a covariance engine freezes (and K14
        reads) the sequential gains ``kgain_seq``/``fdiag_seq`` on
        conditional variances; the square-root engine and any ungated
        registry freeze the joint ``kgain``/``fdiag``."""
        return bool(gate is not None and getattr(gate, "enabled", False)
                    and not self._sqrt_engine)

    def forecast_fn(self, bucket: ShapeBucket, steps: int):
        """The bucket's forecast function for a ``steps``-long horizon."""
        return make_forecast_fn(int(steps))

    @property
    def integrity_stats(self) -> Dict[str, int]:
        """Lifetime integrity-event counters (load failures, last-good
        fallbacks, stale disk reads)."""
        return dict(self._integrity)


__all__ = ["ModelRegistry", "ShapeBucket"]
