"""The data panel a fleet is packed from.

Only the :class:`Panel` dataclass of ``metran_tpu/data.py`` is ported
yet (what :func:`metran_tpu_torch.parallel.fleet.pack_fleet` takes);
ingestion and standardization come with the single-model API
(ROADMAP A5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import numpy as np


@dataclass
class Panel:
    """A standardized, regular-grid multivariate series panel.

    Attributes
    ----------
    values : (T, n_series) float array of standardized observations with
        NaNs replaced by 0 (ignored under ``mask``).
    mask : (T, n_series) bool array, True where an observation is present.
    index : the regular DatetimeIndex of the grid.
    names : series names, in column order.
    std, mean : per-series standardization constants (original units).
    dt : grid step in days.
    """

    values: np.ndarray
    mask: np.ndarray
    index: Any
    names: List[str]
    std: np.ndarray
    mean: np.ndarray
    dt: float

    @property
    def n_series(self) -> int:
        return self.values.shape[1]

    @property
    def n_timesteps(self) -> int:
        return self.values.shape[0]
