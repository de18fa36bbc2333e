"""Online serving: posterior states, registry, batcher and service."""

from .batching import MicroBatcher, Request
from .engine import (
    BucketBatch,
    make_forecast_fn,
    make_update_fn,
    pad_state_arrays,
    posterior_fault,
    stack_bucket,
    state_slot_index,
)
from .registry import ModelRegistry
from .service import Forecast, MetranService
from .state import (
    STATE_FORMAT_VERSION,
    PosteriorState,
    posterior_state_from_metran,
)

__all__ = [
    "BucketBatch",
    "Forecast",
    "MetranService",
    "MicroBatcher",
    "ModelRegistry",
    "PosteriorState",
    "Request",
    "STATE_FORMAT_VERSION",
    "make_forecast_fn",
    "make_update_fn",
    "pad_state_arrays",
    "posterior_fault",
    "posterior_state_from_metran",
    "stack_bucket",
    "state_slot_index",
]
