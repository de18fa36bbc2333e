"""State-space build, the joint and sequential Kalman engines, the
lane-layout fleet deviance, the lane-layout post-fit products and
closed-form forecasts."""

from .adjoint import ADJOINT_ENGINES, resolve_grad_engine
from .forecast import (
    forecast_horizons,
    forecast_observation_moments,
    forecast_state_moments,
)
from .kalman import (
    FilterResult,
    deviance,
    deviance_terms,
    filter_append,
    kalman_filter,
    log_likelihood,
    project,
)
from .lanes import (
    lanes_deviance_terms,
    lanes_dfm_deviance,
    lanes_statespace,
)
from .lanes_products import (
    lanes_filter_project,
    lanes_forecast,
    lanes_innovations,
    lanes_sample,
    lanes_smooth,
)
from .statespace import (
    StateSpace,
    ar1_decay,
    dfm_statespace,
    scale_observation_matrix,
)

__all__ = [
    "ADJOINT_ENGINES",
    "FilterResult",
    "StateSpace",
    "ar1_decay",
    "deviance",
    "deviance_terms",
    "dfm_statespace",
    "filter_append",
    "forecast_horizons",
    "forecast_observation_moments",
    "forecast_state_moments",
    "kalman_filter",
    "lanes_deviance_terms",
    "lanes_dfm_deviance",
    "lanes_filter_project",
    "lanes_forecast",
    "lanes_innovations",
    "lanes_sample",
    "lanes_smooth",
    "lanes_statespace",
    "log_likelihood",
    "project",
    "resolve_grad_engine",
    "scale_observation_matrix",
]
