"""Versioned posterior serving state: the warm handle on a fitted model.

Port of ``metran_tpu/serve/state.py`` (``PosteriorState`` and
``posterior_state_from_metran``).  A
fitted DFM's serving answer needs the filtered posterior
``N(mean, cov)`` at the last assimilated timestep plus the static model
parameters and scaler constants — not the observation history.

The state is host-side numpy, persisted one ``.npz`` per model in the
JAX package's format v2 with the same CRC-32 content checksum, so files
written by either package load in the other bit for bit.
"""

from __future__ import annotations

import zlib
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from ..io import atomic_savez
from ..ops import dfm_statespace
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

    Runs one stored filter pass (K6, or K9 on ``engine="sqrt"``) over
    the model's current (possibly masked) observations at parameters
    ``p`` (default: the fitted optimum, falling back to the initial table
    like every other accessor) and freezes the filtered posterior at the
    last timestep, as float64 host arrays.  A square-root runner's
    cached factor is frozen beside the covariance (``chol``), so a
    ``ModelRegistry(engine="sqrt")`` assimilates in factored form from
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
