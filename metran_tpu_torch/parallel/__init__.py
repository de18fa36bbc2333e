"""Fleet fitting and products: packed fleets, ``fit_fleet`` in the batch
layout (optax's zoom-line-search L-BFGS, the default) and the lane
layout (the lane-layout batched L-BFGS), the lane-layout post-fit
products (``fleet_simulate``, ``fleet_decompose``, ``fleet_forecast``,
``fleet_innovations``, ``fleet_sample``), standard errors
(``fleet_stderr(method="lanes-fd")``), and the device mesh
(``make_mesh``, ``batch_sharding``, ``replicated``) with the padding
rule."""

from .fleet import (
    Fleet,
    FleetFit,
    autocorr_init_params,
    default_init_params,
    fit_fleet,
    fleet_decompose,
    fleet_deviance,
    fleet_forecast,
    fleet_innovations,
    fleet_sample,
    fleet_simulate,
    fleet_stderr,
    fleet_value_and_grad,
    pack_fleet,
)
from .mesh import (
    BATCH_AXIS,
    Mesh,
    batch_sharding,
    make_mesh,
    pad_to_multiple,
    replicated,
)

__all__ = [
    "BATCH_AXIS",
    "Fleet",
    "FleetFit",
    "Mesh",
    "autocorr_init_params",
    "batch_sharding",
    "default_init_params",
    "fit_fleet",
    "fleet_decompose",
    "fleet_deviance",
    "fleet_forecast",
    "fleet_innovations",
    "fleet_sample",
    "fleet_simulate",
    "fleet_stderr",
    "fleet_value_and_grad",
    "make_mesh",
    "pack_fleet",
    "pad_to_multiple",
    "replicated",
]
