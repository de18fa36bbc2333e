"""Online serving: posterior states, registry (dict or device-resident
state arena), batcher, the service with its reliability layer,
observation gate, robust updates, streaming detection, steady-state
(frozen-gain) serving, fixed-lag smoothing and the materialized read
path (commit-time forecast snapshots)."""

from .batching import MicroBatcher, Request
from .engine import (
    BucketBatch,
    DetectSpec,
    GateSpec,
    RobustSpec,
    SteadySpec,
    make_arena_forecast_fn,
    make_arena_steady_update_fn,
    make_arena_update_fn,
    make_forecast_fn,
    make_steady_update_fn,
    make_update_fn,
    pad_state_arrays,
    posterior_fault,
    stack_bucket,
    state_slot_index,
)
from .monitoring import Alert, AlertBoard, DetectorMirror
from .readpath import (
    ForecastSnapshot,
    SnapshotEntry,
    SnapshotStore,
    parse_horizons,
)
from .registry import ModelRegistry
from .service import ArenaUpdateAck, Forecast, MetranService
from .smoothing import FixedLagTracker, SmoothedWindow
from .state import (
    STATE_FORMAT_VERSION,
    ArenaLostError,
    ModelMeta,
    PosteriorState,
    StateArena,
    posterior_state_from_metran,
)

__all__ = [
    "Alert",
    "AlertBoard",
    "ArenaLostError",
    "ArenaUpdateAck",
    "BucketBatch",
    "DetectSpec",
    "DetectorMirror",
    "FixedLagTracker",
    "Forecast",
    "ForecastSnapshot",
    "GateSpec",
    "MetranService",
    "MicroBatcher",
    "ModelMeta",
    "ModelRegistry",
    "PosteriorState",
    "Request",
    "RobustSpec",
    "STATE_FORMAT_VERSION",
    "SmoothedWindow",
    "SnapshotEntry",
    "SnapshotStore",
    "StateArena",
    "SteadySpec",
    "make_arena_forecast_fn",
    "make_arena_steady_update_fn",
    "make_arena_update_fn",
    "make_forecast_fn",
    "make_steady_update_fn",
    "make_update_fn",
    "pad_state_arrays",
    "parse_horizons",
    "posterior_fault",
    "posterior_state_from_metran",
    "stack_bucket",
    "state_slot_index",
]
