"""Host-side data layer: ingestion, standardization, dense packing.

Port of ``metran_tpu/data.py`` (a copy: the port imports nothing of the
JAX package).  Parity with the reference's data handling
(``metran/metran.py:102-197, 509-603``): accepts a DataFrame or
list/tuple of Series/single-column DataFrames, requires >= 2 series and
a DatetimeIndex, truncates to tmin/tmax dropping all-NaN rows, resamples
to a regular grid (``asfreq``, gaps become NaN rows), z-scores each
series, and enforces a minimum cross-sectional overlap per series.

Observations are packed to a dense ``(T, n_series)`` float array plus a
boolean mask (:class:`Panel`), the static-shape encoding the kernels
read.  pandas is imported where it is used: :class:`Panel` and the
fleet packing need only numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from logging import getLogger
from typing import Any, List, Optional

import numpy as np

from .utils import freq_to_days, frequency_is_supported

logger = getLogger(__name__)


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


def combine_series(oseries):
    """Combine accepted input types into a single DataFrame.

    Mirrors the reference's input handling (``metran/metran.py:509-567``):
    lists/tuples of Series or single-column DataFrames are concatenated;
    unnamed series get ``Series{i+1}`` names; fewer than 2 series raises.
    Objects exposing a pandas ``.series`` attribute (duck-typed
    ``pastas.TimeSeries``) are unwrapped.
    """
    import pandas as pd

    if isinstance(oseries, (list, tuple)):
        collected = []
        for i, os in enumerate(oseries):
            if not isinstance(os, (pd.Series, pd.DataFrame)) and isinstance(
                getattr(os, "series", None), (pd.Series, pd.DataFrame)
            ):
                os = os.series  # pastas.TimeSeries-like wrapper
            if isinstance(os, pd.DataFrame):
                if os.shape[1] > 1:
                    msg = ("One or more series have DataFrame with multiple "
                           "columns")
                    logger.error(msg)
                    raise Exception(msg)
                os = os.squeeze()
            elif not isinstance(os, pd.Series):
                msg = "List elements must be pandas Series or DataFrame"
                logger.error(msg)
                raise TypeError(msg)
            if os.name is None:
                os = os.rename(f"Series{i + 1}")
            collected.append(os)
        frame = (pd.concat(collected, axis=1) if len(collected) > 1
                 else pd.DataFrame())
    elif isinstance(oseries, pd.DataFrame):
        frame = oseries
    else:
        msg = "Input type should be either a list, tuple, or pandas.DataFrame"
        logger.error(msg)
        raise TypeError(msg)

    if frame.shape[1] < 2:
        msg = f"Metran requires at least 2 series, found {frame.shape[1]}"
        logger.error(msg)
        raise Exception(msg)
    return frame


def truncate(frame, tmin=None, tmax=None):
    """Clip to [tmin, tmax] and drop rows where every series is NaN."""
    tmin = frame.index.min() if tmin is None else tmin
    tmax = frame.index.max() if tmax is None else tmax
    return frame.loc[tmin:tmax].dropna(how="all")


def test_cross_section(frame, min_pairs: int = 20) -> None:
    """Require each series to overlap others on >= min_pairs dates.

    For every series, counts dates where that series is observed; raises
    when any count is below ``max(min_pairs, 1)`` (reference:
    ``metran/metran.py:150-197``).
    """
    if min_pairs == 0:
        logger.warning("min_pairs must be greater than 0.")
    present = frame.notna()
    row_count = present.sum(axis=1)
    pairs = {name: int(row_count[present[name]].count())
             for name in frame.columns}
    bad = [name for name, n in pairs.items() if n < max(min_pairs, 1)]
    if bad:
        msg = (
            "Number of cross-sectional data is less than "
            + str(min_pairs)
            + " for series "
            + ", ".join(str(b) for b in bad)
        )
        logger.error(msg)
        raise Exception(msg)


def standardize(frame):
    """Z-score each column; returns (standardized, std, mean)."""
    std = frame.std()
    mean = frame.mean()
    return ((frame - mean) / std, np.asarray(std.values, float),
            np.asarray(mean.values, float))


def build_panel(oseries, freq: str = "D", tmin=None, tmax=None,
                min_pairs: int = 20, dtype=np.float64) -> Panel:
    """Full ingestion pipeline: combine, truncate, grid, standardize, pack."""
    import pandas as pd

    frequency_is_supported(freq)
    frame = combine_series(oseries)
    frame = truncate(frame, tmin, tmax)
    if not isinstance(frame.index, pd.DatetimeIndex):
        msg = "Index of series must be DatetimeIndex"
        logger.error(msg)
        raise TypeError(msg)
    frame = frame.asfreq(freq)
    standardized, std, mean = standardize(frame)
    test_cross_section(standardized, min_pairs=min_pairs)
    return pack_panel(standardized, std=std, mean=mean, freq=freq,
                      dtype=dtype)


def pack_panel(standardized, std: Optional[np.ndarray] = None,
               mean: Optional[np.ndarray] = None, freq: str = "D",
               dtype=np.float64) -> Panel:
    """Pack a standardized regular-grid DataFrame into dense arrays."""
    raw = np.asarray(standardized.values, dtype)
    mask = np.isfinite(raw)
    values = np.where(mask, raw, 0.0)
    n = raw.shape[1]
    if std is None:
        std = np.ones(n)
    if mean is None:
        mean = np.zeros(n)
    return Panel(
        values=values,
        mask=mask,
        index=standardized.index,
        names=[str(c) for c in standardized.columns],
        std=np.asarray(std, float),
        mean=np.asarray(mean, float),
        dt=freq_to_days(freq),
    )


def panel_to_frame(panel: Panel, values, columns=None):
    """Wrap a (T, k) array back into a DataFrame on the panel's grid."""
    import pandas as pd

    if columns is None:
        columns = panel.names
    return pd.DataFrame(np.asarray(values), index=panel.index,
                        columns=columns)
