"""Fleet fitting: packed fleets, the lane-layout batched L-BFGS and
``fit_fleet(layout="lanes")``, plus the padding rule."""

from .fleet import (
    Fleet,
    FleetFit,
    autocorr_init_params,
    default_init_params,
    fit_fleet,
    fleet_deviance,
    fleet_value_and_grad,
    pack_fleet,
)
from .mesh import pad_to_multiple

__all__ = [
    "Fleet",
    "FleetFit",
    "autocorr_init_params",
    "default_init_params",
    "fit_fleet",
    "fleet_deviance",
    "fleet_value_and_grad",
    "pack_fleet",
    "pad_to_multiple",
]
