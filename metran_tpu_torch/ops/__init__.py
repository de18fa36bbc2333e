"""State-space build, the joint Kalman engine and closed-form forecasts."""

from .forecast import (
    forecast_horizons,
    forecast_observation_moments,
    forecast_state_moments,
)
from .kalman import FilterResult, filter_append, kalman_filter, project
from .statespace import (
    StateSpace,
    ar1_decay,
    dfm_statespace,
    scale_observation_matrix,
)

__all__ = [
    "FilterResult",
    "StateSpace",
    "ar1_decay",
    "dfm_statespace",
    "filter_append",
    "forecast_horizons",
    "forecast_observation_moments",
    "forecast_state_moments",
    "kalman_filter",
    "project",
    "scale_observation_matrix",
]
