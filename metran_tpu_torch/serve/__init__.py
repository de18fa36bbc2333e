"""Online serving: posterior states, registry, batcher, the service with
its reliability layer, observation gate, robust updates and streaming
detection."""

from .batching import MicroBatcher, Request
from .engine import (
    BucketBatch,
    DetectSpec,
    GateSpec,
    RobustSpec,
    make_forecast_fn,
    make_update_fn,
    pad_state_arrays,
    posterior_fault,
    stack_bucket,
    state_slot_index,
)
from .monitoring import Alert, AlertBoard, DetectorMirror
from .registry import ModelRegistry
from .service import Forecast, MetranService
from .state import (
    STATE_FORMAT_VERSION,
    PosteriorState,
    posterior_state_from_metran,
)

__all__ = [
    "Alert",
    "AlertBoard",
    "BucketBatch",
    "DetectSpec",
    "DetectorMirror",
    "Forecast",
    "GateSpec",
    "MetranService",
    "MicroBatcher",
    "ModelRegistry",
    "PosteriorState",
    "Request",
    "RobustSpec",
    "STATE_FORMAT_VERSION",
    "make_forecast_fn",
    "make_update_fn",
    "pad_state_arrays",
    "posterior_fault",
    "posterior_state_from_metran",
    "stack_bucket",
    "state_slot_index",
]
