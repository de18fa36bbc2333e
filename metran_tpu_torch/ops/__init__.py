"""State-space build, the joint, sequential and square-root Kalman
engines with the serving path's observation gate, the streaming
detector, the RTS smoothers and the single-model products, the
batch-layout closed-form adjoint, the lane-layout fleet deviance, the
lane-layout post-fit products and closed-form forecasts."""

from .adjoint import (
    ADJOINT_ENGINES,
    adjoint_deviance_terms,
    anchored_adjoint_deviance,
    resolve_grad_engine,
)
from .detect import (
    DETECT_STATE_ROWS,
    detect_append,
    detect_init,
    detect_stats,
)
from .forecast import (
    forecast_horizons,
    forecast_observation_moments,
    forecast_state_moments,
)
from .kalman import (
    GATE_DOWNWEIGHTED,
    GATE_PASS,
    GATE_POLICIES,
    GATE_REJECTED,
    FilterResult,
    SmootherResult,
    SqrtFilterResult,
    SqrtSmootherResult,
    chol_outer,
    decompose_states,
    deviance,
    deviance_terms,
    filter_append,
    gated_filter_append,
    gated_sqrt_filter_append,
    innovations,
    kalman_filter,
    log_likelihood,
    project,
    rts_smoother,
    sample_states,
    sqrt_filter_append,
    sqrt_filter_update,
    sqrt_kalman_filter,
    sqrt_rts_smoother,
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
    "DETECT_STATE_ROWS",
    "FilterResult",
    "GATE_DOWNWEIGHTED",
    "GATE_PASS",
    "GATE_POLICIES",
    "GATE_REJECTED",
    "SmootherResult",
    "SqrtFilterResult",
    "SqrtSmootherResult",
    "StateSpace",
    "adjoint_deviance_terms",
    "anchored_adjoint_deviance",
    "ar1_decay",
    "chol_outer",
    "decompose_states",
    "deviance",
    "detect_append",
    "detect_init",
    "detect_stats",
    "deviance_terms",
    "dfm_statespace",
    "filter_append",
    "forecast_horizons",
    "forecast_observation_moments",
    "forecast_state_moments",
    "gated_filter_append",
    "gated_sqrt_filter_append",
    "innovations",
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
    "rts_smoother",
    "sample_states",
    "scale_observation_matrix",
    "sqrt_filter_append",
    "sqrt_filter_update",
    "sqrt_kalman_filter",
    "sqrt_rts_smoother",
]
