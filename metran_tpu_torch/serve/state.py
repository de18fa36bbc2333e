"""Versioned posterior serving state: the warm handle on a fitted model.

Port of ``metran_tpu/serve/state.py`` (``PosteriorState``,
``posterior_state_from_metran`` and the device-resident
:class:`StateArena` with its :class:`ModelMeta`).  A
fitted DFM's serving answer needs the filtered posterior
``N(mean, cov)`` at the last assimilated timestep plus the static model
parameters and scaler constants — not the observation history.

The state is host-side numpy, persisted one ``.npz`` per model in the
JAX package's format v2 with the same CRC-32 content checksum, so files
written by either package load in the other bit for bit.
"""

from __future__ import annotations

import functools
import threading
import zlib
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import default_dtype, resolve_device
from ..io import atomic_savez
from ..ops import DETECT_STATE_ROWS, dfm_statespace
from ..parallel.mesh import pad_to_multiple
from ..reliability.policy import StateIntegrityError

# v1 files (no checksum) still load; v2 embeds a CRC-32 content checksum
STATE_FORMAT_VERSION = 2


def _content_checksum(payload: Dict[str, np.ndarray]) -> int:
    """CRC-32 over every array's dtype, shape and raw bytes, in sorted
    key order (deterministic across writers)."""
    crc = 0
    for key in sorted(payload):
        a = np.ascontiguousarray(payload[key])
        crc = zlib.crc32(key.encode(), crc)
        crc = zlib.crc32(str(a.dtype).encode(), crc)
        crc = zlib.crc32(repr(a.shape).encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc & 0xFFFFFFFF


_FIELDS = (
    "model_id", "version", "t_seen", "mean", "cov", "params", "loadings",
    "dt", "scaler_mean", "scaler_std", "names", "chol",
)


class PosteriorState(NamedTuple):
    """Everything needed to serve one model, frozen at assimilation time T.

    Attributes
    ----------
    model_id : registry key.
    version : assimilation version, +1 per applied update.
    t_seen : number of grid timesteps assimilated so far.
    mean : (n_state,) filtered state mean.
    cov : (n_state, n_state) filtered state covariance.
    params : (n_series + n_factors,) alphas, ``[sdf..., cdf...]``.
    loadings : (n_series, n_factors) factor loadings.
    dt : grid step in days.
    scaler_mean, scaler_std : per-series standardization constants.
    names : series names, column order.
    chol : optional lower Cholesky factor of ``cov`` (square-root
        engine states); carried through save/load, never served by the
        joint engine, which drops it on the next update.
    """

    model_id: str
    version: int
    t_seen: int
    mean: np.ndarray
    cov: np.ndarray
    params: np.ndarray
    loadings: np.ndarray
    dt: float
    scaler_mean: np.ndarray
    scaler_std: np.ndarray
    names: Tuple[str, ...]
    chol: Optional[np.ndarray] = None

    @property
    def n_series(self) -> int:
        return int(self.loadings.shape[0])

    @property
    def n_factors(self) -> int:
        return int(self.loadings.shape[1])

    @property
    def n_state(self) -> int:
        return int(self.mean.shape[0])

    @property
    def dtype(self):
        return np.asarray(self.mean).dtype

    @classmethod
    def from_arrays(cls, **fields) -> "PosteriorState":
        """A state from its fields as arrays/scalars (e.g. the
        ``_asdict()`` of a JAX-package state); arrays become numpy."""
        missing = [f for f in _FIELDS[:-1] if f not in fields]
        if missing:
            raise ValueError(f"missing posterior-state fields {missing}")
        chol = fields.get("chol")
        return cls(
            model_id=str(fields["model_id"]),
            version=int(fields["version"]),
            t_seen=int(fields["t_seen"]),
            mean=np.asarray(fields["mean"]),
            cov=np.asarray(fields["cov"]),
            params=np.asarray(fields["params"]),
            loadings=np.asarray(fields["loadings"]),
            dt=float(fields["dt"]),
            scaler_mean=np.asarray(fields["scaler_mean"]),
            scaler_std=np.asarray(fields["scaler_std"]),
            names=tuple(str(n) for n in fields["names"]),
            chol=None if chol is None else np.asarray(chol),
        )

    @classmethod
    def from_jax_state(cls, st) -> "PosteriorState":
        """Carry over any object with the state's fields as attributes
        (duck-typed: a JAX-package ``PosteriorState``)."""
        return cls.from_arrays(
            **{f: getattr(st, f, None) for f in _FIELDS}
        )

    def statespace(self, device=None, dtype=None):
        """The model's :class:`~metran_tpu_torch.ops.StateSpace`
        (standardized units), on ``device`` (default: the CUDA card)."""
        n = self.n_series
        return dfm_statespace(
            self.params[:n], self.params[n:], self.loadings, self.dt,
            device=device, dtype=dtype,
        )

    def save(self, path) -> Path:
        """Persist to one ``.npz``, atomically, with an embedded content
        checksum (format v2; ``chol`` rides as one more key)."""
        payload = dict(
            model_id=np.str_(self.model_id),
            version=np.int64(self.version),
            t_seen=np.int64(self.t_seen),
            mean=np.asarray(self.mean),
            cov=np.asarray(self.cov),
            params=np.asarray(self.params),
            loadings=np.asarray(self.loadings),
            dt=np.float64(self.dt),
            scaler_mean=np.asarray(self.scaler_mean),
            scaler_std=np.asarray(self.scaler_std),
            names=np.asarray(list(self.names), dtype=np.str_),
        )
        if self.chol is not None:
            payload["chol"] = np.asarray(self.chol)
        return atomic_savez(
            Path(path),
            format_version=np.int64(STATE_FORMAT_VERSION),
            checksum=np.uint32(_content_checksum(payload)),
            **payload,
        )

    @classmethod
    def load(cls, path) -> "PosteriorState":
        """Restore a state saved by either package, bit-identically.

        Raises :class:`~metran_tpu_torch.reliability.StateIntegrityError`
        for a corrupt file (unparseable, missing fields, checksum
        mismatch) and ``ValueError`` for a well-formed file in a newer
        format.  ``MemoryError``/``OSError`` propagate unchanged.
        """
        path = Path(path)
        try:
            data_ctx = np.load(path, allow_pickle=False)
        except (MemoryError, OSError):
            raise
        except Exception as exc:
            raise StateIntegrityError(
                f"posterior state {path} is unreadable or corrupt: "
                f"{type(exc).__name__}: {exc}"
            ) from exc
        try:
            with data_ctx as data:
                fmt = int(data["format_version"])
                if fmt not in (1, STATE_FORMAT_VERSION):
                    raise ValueError(
                        f"unsupported posterior-state format {fmt} "
                        f"(expected <= {STATE_FORMAT_VERSION}) in {path}"
                    )
                payload = {
                    k: data[k] for k in data.files
                    if k not in ("format_version", "checksum")
                }
                if fmt >= 2:
                    want = int(data["checksum"])
                    got = _content_checksum(payload)
                    if got != want:
                        raise StateIntegrityError(
                            f"posterior state {path} failed its content "
                            f"checksum (stored {want:#010x}, recomputed "
                            f"{got:#010x}): the file is corrupt"
                        )
                return cls.from_arrays(**payload)
        except (StateIntegrityError, ValueError, MemoryError, OSError):
            raise
        except Exception as exc:
            raise StateIntegrityError(
                f"posterior state {path} is unreadable or corrupt: "
                f"{type(exc).__name__}: {exc}"
            ) from exc


def posterior_state_from_metran(mt, model_id: Optional[str] = None,
                                p=None) -> PosteriorState:
    """Extract the serving state from a (fitted) port :class:`Metran`.

    Runs one stored filter pass (K6, or K9 on ``engine="sqrt"``, K19 on
    ``"parallel"``, K21 on ``"sqrt_parallel"``) over the model's current
    (possibly masked) observations at parameters ``p`` (default: the
    fitted optimum, falling back to the initial table like every other
    accessor) and freezes the filtered posterior at the last timestep, as
    float64 host arrays.  A square-root runner's cached factor is frozen
    beside the covariance (``chol``), so a ``ModelRegistry(engine=
    "sqrt")`` (or ``"sqrt_parallel"``) assimilates in factored form from
    the first request.  Factor loadings must exist (call ``solve()`` or
    ``get_factors()`` first).
    """
    if mt.factors is None:
        raise ValueError(
            "model has no factor loadings; call solve() or "
            "get_factors() before extracting a posterior state"
        )
    if len(mt.parameters) != mt.nseries + mt.nfactors:
        # get_factors() without solve(): the __init__-time table predates
        # the factor structure (same consistency guard solve() applies)
        mt.set_init_parameters()
    mt._run_kalman("filter", p=p)
    filt = mt.kf.run_filter()
    sq = getattr(mt.kf, "_sqrt_filtered", None)
    params = mt._param_array(p if p is not None else mt.get_parameters())
    return PosteriorState(
        model_id=str(model_id if model_id is not None else mt.name),
        version=0,
        t_seen=int(mt.kf.y.shape[0]),
        mean=filt.mean_f[-1].double().cpu().numpy(),
        cov=filt.cov_f[-1].double().cpu().numpy(),
        params=np.asarray(params, float),
        loadings=np.asarray(mt.factors, float),
        dt=float(mt._dt),
        scaler_mean=np.asarray(mt.oseries_mean, float),
        scaler_std=np.asarray(mt.oseries_std, float),
        names=tuple(mt.snames),
        chol=None if sq is None else sq.chol_f[-1].double().cpu().numpy(),
    )


# ----------------------------------------------------------------------
# device-resident state arena
# ----------------------------------------------------------------------
#
# The dict registry pays host<->device transfer and per-model host work
# on every dispatch: stack_bucket pads B covariances on the host, ships
# them up, and the results come back down to be re-packed.  The arena
# inverts that: each shape bucket owns preallocated (B, ...) stacked
# leaves that live on the device, only row indices and the new
# observations cross the host boundary, and the update kernels (K16,
# K17) write the dispatched rows in place.


class ModelMeta(NamedTuple):
    """The immutable half of one arena-resident model's state.

    Everything in a :class:`PosteriorState` except the filtered
    posterior moments and the version counters: the host keeps these
    (they never change between re-fits) so submit-path validation,
    standardization and forecast de-standardization need no device
    read, while ``mean``/``chol|cov``/``t_seen``/``version`` live in the
    :class:`StateArena`.  Shares the shape accessors with
    :class:`PosteriorState`, so ``ModelRegistry.bucket_of`` and the
    service's submit paths accept either.
    """

    model_id: str
    params: np.ndarray
    loadings: np.ndarray
    dt: float
    scaler_mean: np.ndarray
    scaler_std: np.ndarray
    names: Tuple[str, ...]
    dtype: np.dtype

    @property
    def n_series(self) -> int:
        return int(self.loadings.shape[0])

    @property
    def n_factors(self) -> int:
        return int(self.loadings.shape[1])

    @classmethod
    def of(cls, state: PosteriorState) -> "ModelMeta":
        return cls(
            model_id=state.model_id,
            params=np.asarray(state.params),
            loadings=np.asarray(state.loadings),
            dt=float(state.dt),
            scaler_mean=np.asarray(state.scaler_mean),
            scaler_std=np.asarray(state.scaler_std),
            names=tuple(state.names),
            dtype=np.dtype(state.dtype),
        )


@functools.lru_cache(maxsize=32)
def _identity_row_ss(bucket: Tuple[int, int], dtype_str: str):
    """The built state-space leaves of a FREE arena row (padded-slot
    identity model: alpha 1, zero loadings), host-side, cached per
    bucket shape — what :meth:`StateArena.clear_row` scatters back."""
    n_pad, s_pad = bucket
    dt = np.dtype(dtype_str)
    ss = dfm_statespace(
        np.ones(n_pad, dt), np.ones(s_pad - n_pad, dt),
        np.zeros((n_pad, s_pad - n_pad), dt), 1.0, device="cpu",
    )
    return tuple(leaf.numpy() for leaf in ss)


def _take_rows(a, pos, g: int, device):
    """The requests ``pos`` of a (G, ...) argument on ``device`` (numpy
    stays on the host); anything else (a scalar) as it is."""
    if isinstance(a, torch.Tensor):
        if a.dim() and a.shape[0] == g:
            return a[torch.as_tensor(pos, device=a.device)].to(device)
        return a
    if isinstance(a, np.ndarray) and a.ndim and a.shape[0] == g:
        return a[pos]
    return a


def _merge_rows(parts, g: int, device):
    """(G, ...) on ``device`` from ``[(positions, (G_k, ...) part)]``."""
    first = parts[0][1]
    if first is None:
        return None
    out = first.new_empty((g, *first.shape[1:]), device=device)
    for pos, part in parts:
        out[torch.as_tensor(pos, device=device)] = part.to(device)
    return out


class ArenaLostError(StateIntegrityError):
    """The arena's device leaves can no longer be trusted (an in-place
    kernel failed part-way, so some of its rows may have been written).
    Rows must be re-packed from the last-good host/disk states;
    :class:`~metran_tpu_torch.serve.registry.ModelRegistry` does that
    automatically on the next touch."""


def _torch_dtype(dtype) -> torch.dtype:
    return torch.float64 if np.dtype(dtype) == np.float64 else torch.float32


class StateArena:
    """One shape bucket's models as device-resident stacked tensors.

    Layout (``B`` = ``capacity`` rows, bucket = padded ``(N, S)``):

    - dynamic leaves, written in place by the update kernels (K16, K17):
      ``mean (B, S)``, ``fac (B, S, S)`` (Cholesky factors under the
      square-root engine, covariances otherwise), ``t_seen (B,)`` and
      ``version (B,)`` (int32);
    - static leaves, written only when a row is (re)packed: the **built**
      state-space matrices ``phi (B, S)``, ``q (B, S, S)``, ``z (B, N,
      S)``, ``r (B, N)`` — built once per row at pack time
      (``dfm_statespace`` on the device), so dispatches read ready
      matrices instead of re-deriving them from parameters every call;
    - the steady leaves ``steady (B,)``, ``kgain (B, S, N)``, ``fdiag (B,
      N)`` (written at freeze/thaw) and the detector leaf ``det (B, 6,
      N)`` (advanced in place by the detecting kernels); every (re)pack
      resets both.

    The host mirrors each row's ``t_seen``/``version`` (advanced from
    each dispatch's ok flags, so answers never need a device read), its
    steady flag, its standardization constants and true series count
    (vectorized bulk validation and (de)standardization), its spill
    dirtiness and its detection display statistics at the last alarm.

    A free row holds the padded-slot identity values (mean 0, factor
    ``I``, alpha 1, zero loadings) — a valid kernel input.  One extra
    scratch row is never allocated (the JAX arena pads dispatch widths
    with it; here it keeps ``capacity`` and :attr:`row_nbytes` equal to
    the JAX arena's — eager PyTorch compiles nothing per width, so no
    dispatch is padded).

    **In-place contract.**  All device access goes through :meth:`apply`
    and its steady/detect variants (in-place updates) and :meth:`query`
    (read-only kernels), serialized under ``self.lock``.  If an update
    raises, the arena marks itself **lost** (an in-place kernel may have
    written some of its rows) and every later access raises
    :class:`ArenaLostError`; the registry then rebuilds the arena from
    last-good states.  Leaves live on ``device`` (default: the CUDA
    card; without one construction raises — pass ``device="cpu"``).

    ``mesh`` (a :class:`~metran_tpu_torch.parallel.mesh.Mesh`) shards
    every leaf along the row axis over the mesh's devices, as the JAX
    arena's ``NamedSharding``: ``capacity`` is rounded up so shards stay
    even, row ``i`` lives in shard ``i // shard_rows`` at local row ``i %
    shard_rows``, and a dispatch groups its rows by shard and launches its
    kernel once per shard it touches (outputs merged back in request
    order on the first device).  The host mirrors stay whole.  Knobs:
    ``METRAN_TPU_SERVE_ARENA{,_ROWS,_MESH}``
    (:func:`metran_tpu_torch.config.serve_defaults`).
    """

    def __init__(self, bucket: Tuple[int, int], capacity: int, dtype=None,
                 sqrt: bool = False, mesh=None, device=None):
        n_pad, s_pad = int(bucket[0]), int(bucket[1])
        self.bucket = (n_pad, s_pad)
        self.sqrt = bool(sqrt)
        self.mesh = mesh
        self.devices = ([resolve_device(device)] if mesh is None
                        else mesh.flat_devices())
        self.device = self.devices[0]
        if dtype is None:
            dtype = default_dtype(self.device)
        if isinstance(dtype, torch.dtype):
            dtype = str(dtype).replace("torch.", "")
        self.dtype = np.dtype(dtype)
        self._tdtype = _torch_dtype(self.dtype)
        capacity = int(capacity) + 1  # the scratch row
        if mesh is not None:
            capacity = pad_to_multiple(capacity, len(self.devices))
        self.capacity = capacity
        #: rows per shard (the whole arena without a mesh)
        self.shard_rows = capacity // len(self.devices)
        self.scratch_row = capacity - 1
        self.lock = threading.RLock()
        self._lost = False
        self.t_seen_host = np.zeros(capacity, np.int64)
        self.version_host = np.zeros(capacity, np.int64)
        #: rows updated since their last spill (durability frontier)
        self.dirty = np.zeros(capacity, bool)
        self.scaler_mean = np.zeros((capacity, n_pad))
        self.scaler_std = np.ones((capacity, n_pad))
        #: each row's true series count (0 = free row)
        self.n_series_host = np.zeros(capacity, np.int64)
        self._free: List[int] = list(range(capacity - 2, -1, -1))
        #: each shard's leaves: mean, fac, t_seen, version, phi, q, z, r,
        #: steady, kgain, fdiag, det
        self._shards = [self._new_leaves(dev, self.shard_rows)
                        for dev in self.devices]
        #: host mirror of the device steady flags (the dispatch-time row
        #: partition reads this, never the device)
        self.steady_host = np.zeros(capacity, bool)
        #: each row's detection display statistics ([C+, C-, LB-Q] per
        #: slot) at its last alarm; live values: registry.arena_detect_stats
        self.det_stats_host = np.zeros((capacity, 3, n_pad))

    def _new_leaves(self, device, rows: int) -> list:
        """``rows`` free rows of every leaf on ``device``."""
        n_pad, s_pad = self.bucket
        new = dict(dtype=self._tdtype, device=device)
        phi0, q0, z0, r0 = (torch.from_numpy(a).to(**new) for a in
                            _identity_row_ss(self.bucket, self.dtype.str))
        return [
            torch.zeros((rows, s_pad), **new),
            torch.eye(s_pad, **new).repeat(rows, 1, 1),
            torch.zeros(rows, dtype=torch.int32, device=device),
            torch.zeros(rows, dtype=torch.int32, device=device),
            phi0.repeat(rows, 1), q0.repeat(rows, 1, 1),
            z0.repeat(rows, 1, 1), r0.repeat(rows, 1),
            torch.zeros(rows, dtype=torch.bool, device=device),
            torch.zeros((rows, s_pad, n_pad), **new),
            torch.ones((rows, n_pad), **new),
            torch.zeros((rows, DETECT_STATE_ROWS, n_pad), **new),
        ]

    # -- shards ---------------------------------------------------------
    def _groups(self, rows):
        """``[(shard, positions, local rows)]`` of the shards ``rows``
        touch, in shard order: ``positions`` index ``rows``, the local rows
        index the shard's leaves (the dtype of ``rows``)."""
        rows = np.asarray(rows)
        flat = rows.astype(np.int64).reshape(-1)
        if len(self._shards) == 1:
            return [(0, np.arange(flat.size), rows)]
        shard = flat // self.shard_rows
        out = []
        for k in np.unique(shard):
            pos = np.flatnonzero(shard == k)
            local = (flat[pos] - k * self.shard_rows).astype(rows.dtype)
            out.append((int(k), pos, local))
        return out

    def _sharded(self, fn, lead, rows, args, skip: int):
        """``fn(*lead(k), local_rows, *args_k)[skip:]`` for each shard ``k``
        the (G,) ``rows`` touch, every G-leading argument cut to the
        shard's requests and moved to its device (scalars pass through);
        each (G_k, ...) output merged back into (G, ...) in request order
        on the first device.  Every shard's launch is queued before any
        output crosses devices."""
        groups = self._groups(rows)
        if len(self._shards) == 1:
            return fn(*lead(0), rows, *args)[skip:]
        g = int(np.asarray(rows).size)
        parts = []
        for k, pos, local in groups:
            dev = self.devices[k]
            sub = [_take_rows(a, pos, g, dev) for a in args]
            parts.append((pos, fn(*lead(k), local, *sub)[skip:]))
        return tuple(_merge_rows([(pos, out[i]) for pos, out in parts], g,
                                 self.device)
                     for i in range(len(parts[0][1])))

    def _where(self, row: int) -> Tuple[int, int]:
        """``(shard, local row)`` of arena row ``row``."""
        return divmod(int(row), self.shard_rows)

    # -- row bookkeeping ------------------------------------------------
    @property
    def row_nbytes(self) -> int:
        """Device bytes one row pins across every leaf: posterior, the
        counters, the resident built state space, the steady leaves and
        the detector leaf (``ModelRegistry.arena_bytes_by_model``)."""
        n_pad, s_pad = self.bucket
        per_row_floats = (
            s_pad + s_pad * s_pad + s_pad + s_pad * s_pad + n_pad * s_pad
            + n_pad + s_pad * n_pad + n_pad + DETECT_STATE_ROWS * n_pad
        )
        return per_row_floats * self.dtype.itemsize + 2 * 4 + 1

    @property
    def free_rows(self) -> int:
        with self.lock:
            return len(self._free)

    @property
    def occupied_rows(self) -> int:
        with self.lock:  # the scratch row is neither free nor occupied
            return self.capacity - 1 - len(self._free)

    @property
    def lost(self) -> bool:
        return self._lost

    def alloc(self) -> Optional[int]:
        """Take a free row (``None`` when the arena is full — the caller
        evicts and retries)."""
        with self.lock:
            return self._free.pop() if self._free else None

    def _check(self) -> None:
        if self._lost:
            raise ArenaLostError(
                f"arena {self.bucket} lost its device leaves (an in-place "
                "update failed mid-flight); rows must be re-packed from "
                "last-good states"
            )

    # -- device access (the in-place discipline lives HERE) -------------
    def _dynamic(self, k: int = 0):
        return tuple(self._shards[k][:4])

    def _static(self, k: int = 0):
        return tuple(self._shards[k][4:8])

    def _steady_leaves(self, k: int = 0):
        return tuple(self._shards[k][8:11])

    def _det_leaf(self, k: int = 0):
        return self._shards[k][11]

    def _run(self, fn, *args):
        """Call ``fn`` under the lock; any failure marks the arena lost
        (its kernel may have written some rows in place)."""
        with self.lock:
            self._check()
            try:
                return fn(*args)
            except BaseException:
                self._lost = True
                raise

    def apply(self, fn, *args):
        """Run an in-place update ``fn(dynamic, static, rows, *args)``
        (from :func:`~metran_tpu_torch.serve.engine.make_arena_update_fn`),
        whose first output is the (updated) dynamic leaves; returns the
        rest (one launch per shard the rows touch)."""
        return self._run(self._sharded, fn, lambda k: (
            self._dynamic(k), self._static(k)), args[0], args[1:], 1)

    def apply_steady(self, fn, *args):
        """Run the in-place **steady** update ``fn(dynamic, static,
        steady_leaves, rows, *args)`` under the same contract as
        :meth:`apply`."""
        return self._run(self._sharded, fn, lambda k: (
            self._dynamic(k), self._static(k), self._steady_leaves(k)),
            args[0], args[1:], 1)

    def apply_det(self, fn, *args):
        """Run an in-place **detect** update ``fn(dynamic, static, det,
        rows, *args)``, whose first two outputs are the updated dynamic and
        detector leaves; returns the rest."""
        return self._run(self._sharded, fn, lambda k: (
            self._dynamic(k), self._static(k), self._det_leaf(k)),
            args[0], args[1:], 2)

    def apply_steady_det(self, fn, *args):
        """Run the in-place **steady detect** update ``fn(dynamic,
        static, steady_leaves, det, rows, *args)`` (:meth:`apply_steady`
        with the detector leaf)."""
        return self._run(self._sharded, fn, lambda k: (
            self._dynamic(k), self._static(k), self._steady_leaves(k),
            self._det_leaf(k)), args[0], args[1:], 2)

    def _gather(self, i: int, rows) -> torch.Tensor:
        """Leaf ``i``'s ``rows`` on the first device."""
        def read(k, local):
            return self._shards[k][i][torch.as_tensor(
                np.asarray(local, np.int64), device=self.devices[k])]

        groups = self._groups(rows)
        if len(self._shards) == 1:
            return read(0, groups[0][2])
        return _merge_rows([(pos, read(k, local)) for k, pos, local in groups],
                           int(np.asarray(rows).size), self.device)

    def _scatter(self, i: int, rows, vals) -> None:
        """Leaf ``i``'s ``rows`` := ``vals`` ((G, ...) or a scalar)."""
        for k, pos, local in self._groups(rows):
            leaf = self._shards[k][i]
            idx = torch.as_tensor(np.asarray(local, np.int64),
                                  device=leaf.device)
            if isinstance(vals, torch.Tensor) and vals.dim():
                leaf[idx] = vals[torch.as_tensor(pos, device=vals.device)
                                 ].to(leaf.device)
            else:
                leaf[idx] = vals

    def read_det_row(self, row: int) -> np.ndarray:
        """One row's detector accumulators back on the host ((6, N))."""
        k, local = self._where(row)
        with self.lock:
            self._check()
            return self._shards[k][11][local].cpu().numpy()

    def read_det_rows(self, rows) -> np.ndarray:
        """Several rows' detector accumulators ((R, 6, N), one
        transfer) — the ``service.anomalies()`` query path."""
        with self.lock:
            self._check()
            return self._gather(11, rows).cpu().numpy()

    def write_det_rows(self, rows, states) -> None:
        """Scatter detector accumulators back into the leaf ((R, 6, N)):
        the recovery path's inverse of :meth:`read_det_rows` (a re-packed
        row resets its detector state by design, so a restore runs AFTER
        its rows are resident)."""
        vals = torch.as_tensor(np.asarray(states), dtype=self._tdtype)
        self._run(self._scatter, 11, rows, vals)

    def query(self, fn, *args):
        """Run a read-only kernel ``fn(mean, fac, static, rows, *args)``
        under the arena lock (so it never races an in-place update)."""
        with self.lock:
            self._check()
            return self._sharded(fn, lambda k: (
                self._shards[k][0], self._shards[k][1], self._static(k)),
                args[0], args[1:], 0)

    def commit_rows(self, rows, ok, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Advance the host mirrors for the rows a dispatch committed
        (``ok`` the kernel's per-row flags); returns the post-commit
        ``(versions, t_seen)`` of ALL the dispatched rows, snapshotted
        under the arena lock."""
        rows = np.asarray(rows, np.int64)
        good = rows[np.asarray(ok, bool)]
        with self.lock:
            self.t_seen_host[good] += int(k)
            self.version_host[good] += 1
            self.dirty[good] = True
            return (
                self.version_host[rows].copy(),
                self.t_seen_host[rows].copy(),
            )

    # -- steady (frozen-gain) rows ---------------------------------------
    def freeze_rows(self, rows, kgains, fdiags) -> None:
        """Mark ``rows`` steady, writing their frozen gains and innovation
        variances (bucket-padded (S, N)/(N,) per row) into the steady
        leaves; the steady update (K17) serves them mean-only from the
        next dispatch on."""
        rows = np.asarray(rows, np.int64)
        kg = torch.as_tensor(np.asarray(kgains), dtype=self._tdtype)
        fd = torch.as_tensor(np.asarray(fdiags), dtype=self._tdtype)

        def write():
            self._scatter(8, rows, True)
            self._scatter(9, rows, kg)
            self._scatter(10, rows, fd)
            self.steady_host[rows] = True

        self._run(write)

    def thaw_rows(self, rows) -> None:
        """Clear ``rows``' steady flags (their gains reset); the exact
        update serves them again from the next dispatch on."""
        rows = np.asarray(rows, np.int64)

        def write():
            self._scatter(8, rows, False)
            self._scatter(9, rows, 0.0)
            self._scatter(10, rows, 1.0)
            self.steady_host[rows] = False

        self._run(write)

    @property
    def steady_rows(self) -> int:
        """Currently frozen rows (the steady-rows gauge's source)."""
        with self.lock:
            return int(np.count_nonzero(self.steady_host))

    # -- pack / unpack ---------------------------------------------------
    def _write_leaves(self, row: int, vals) -> None:
        k, local = self._where(row)

        def write():
            for leaf, val in zip(self._shards[k], vals):
                leaf[local] = torch.as_tensor(val, dtype=leaf.dtype).to(
                    leaf.device)

        self._run(write)

    def write_row(self, row: int, state: PosteriorState) -> None:
        """(Re)pack one model's state into ``row`` — padded exactly like
        ``stack_bucket`` pads a dict-registry dispatch, the state-space
        matrices built once here on the device (the same
        ``dfm_statespace`` the dict path runs per dispatch, so both paths
        serve from identical matrices).  Every (re)pack thaws the row and
        resets its detector accumulators: a ``put`` that replaced the
        posterior must never leave a stale frozen gain or evidence
        gathered against the old parameters."""
        from .engine import pad_state_arrays

        row = int(row)
        a_sdf, a_cdf, lds, mean, cov, chol = pad_state_arrays(
            state, self.bucket, self.dtype, sqrt=self.sqrt)
        fac = chol if self.sqrt else cov
        new = dict(dtype=self._tdtype, device=self.device)
        ss = dfm_statespace(
            torch.from_numpy(a_sdf[None]).to(**new),
            torch.from_numpy(a_cdf[None]).to(**new),
            torch.from_numpy(lds[None]).to(**new),
            torch.tensor([state.dt], **new), device=self.device)
        n_pad, s_pad = self.bucket
        vals = (
            mean, fac, int(state.t_seen), int(state.version),
            ss.phi[0], ss.q[0], ss.z[0], ss.r[0],
            False, np.zeros((s_pad, n_pad), self.dtype),
            np.ones(n_pad, self.dtype),
            np.zeros((DETECT_STATE_ROWS, n_pad), self.dtype),
        )
        with self.lock:
            self._write_leaves(row, vals)
            self.steady_host[row] = False
            self.det_stats_host[row] = 0.0
            self.t_seen_host[row] = int(state.t_seen)
            self.version_host[row] = int(state.version)
            self.dirty[row] = False
            n = state.n_series
            self.scaler_mean[row, :] = 0.0
            self.scaler_std[row, :] = 1.0
            self.scaler_mean[row, :n] = np.asarray(state.scaler_mean)
            self.scaler_std[row, :n] = np.asarray(state.scaler_std)
            self.n_series_host[row] = n

    def read_row(self, row: int) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """One row's dynamic values back on the host: ``(mean (S,), fac
        (S, S), t_seen, version)`` — the cold path (eviction, spill,
        ``registry.get``)."""
        row = int(row)
        k, local = self._where(row)
        with self.lock:
            self._check()
            return (
                self._shards[k][0][local].cpu().numpy(),
                self._shards[k][1][local].cpu().numpy(),
                int(self.t_seen_host[row]), int(self.version_host[row]),
            )

    def read_rows(self, rows) -> Tuple[np.ndarray, np.ndarray]:
        """Several rows' ``(mean, fac)`` back on the host in one transfer
        per leaf — the spill path at fleet size."""
        with self.lock:
            self._check()
            return (self._gather(0, rows).cpu().numpy(),
                    self._gather(1, rows).cpu().numpy())

    def materialize_values(self, mean: np.ndarray, fac: np.ndarray, row: int,
                           meta: ModelMeta) -> PosteriorState:
        """Assemble one row's :class:`PosteriorState` from already-fetched
        padded values plus the host mirrors and metadata (the true slots
        sliced out of the padded layout)."""
        from .engine import state_slot_index

        idx = state_slot_index(meta.n_series, meta.n_factors, self.bucket[0])
        sub = fac[np.ix_(idx, idx)]
        if self.sqrt:
            chol = sub
            cov = chol @ chol.T
        else:
            chol = None
            cov = sub
        with self.lock:
            t_seen = int(self.t_seen_host[row])
            version = int(self.version_host[row])
        return PosteriorState(
            model_id=meta.model_id, version=version, t_seen=t_seen,
            mean=mean[idx], cov=cov, params=meta.params,
            loadings=meta.loadings, dt=meta.dt,
            scaler_mean=meta.scaler_mean, scaler_std=meta.scaler_std,
            names=meta.names, chol=chol,
        )

    def materialize(self, row: int, meta: ModelMeta) -> PosteriorState:
        """The full :class:`PosteriorState` of the model in ``row``."""
        mean, fac, _, _ = self.read_row(row)
        return self.materialize_values(mean, fac, row, meta)

    def clear_row(self, row: int) -> None:
        """Reset ``row`` to the padded-slot identity values and return it
        to the free list (eviction's last step)."""
        row = int(row)
        n_pad, s_pad = self.bucket
        dt = self.dtype
        phi0, q0, z0, r0 = _identity_row_ss(self.bucket, dt.str)
        vals = (
            np.zeros(s_pad, dt), np.eye(s_pad, dtype=dt), 0, 0,
            phi0, q0, z0, r0,
            False, np.zeros((s_pad, n_pad), dt), np.ones(n_pad, dt),
            np.zeros((DETECT_STATE_ROWS, n_pad), dt),
        )
        with self.lock:
            self._write_leaves(row, vals)
            self.steady_host[row] = False
            self.det_stats_host[row] = 0.0
            self.t_seen_host[row] = 0
            self.version_host[row] = 0
            self.dirty[row] = False
            self.scaler_mean[row, :] = 0.0
            self.scaler_std[row, :] = 1.0
            self.n_series_host[row] = 0
            self._free.append(row)


__all__ = [
    "STATE_FORMAT_VERSION",
    "ArenaLostError",
    "ModelMeta",
    "PosteriorState",
    "StateArena",
    "posterior_state_from_metran",
]
