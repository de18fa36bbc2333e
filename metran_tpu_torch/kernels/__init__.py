"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

- :mod:`.joint_filter` — K1, the joint-update filter append;
- :mod:`.forecast` — K2, the closed-form forecast moments;
- :mod:`.lanes` — K3, the lane-layout sequential filter, and K4, its
  closed-form adjoint;
- :mod:`.build` — the ``nvcc`` build, the ``ctypes`` binding and the
  launch counters.

Each wrapper (``joint_filter_append``, ``forecast_moments``,
``lanes_filter``, ``lanes_adjoint``) launches its kernel (``*_kernel``,
which takes CUDA tensors only and raises if it cannot build or launch)
on CUDA tensors and runs the plain version (``*_plain``) on CPU
tensors; there is no fallback between them.  Nothing is built or
loaded at import.
"""

from . import build
from .build import launches, reset_launches
from .forecast import (
    forecast_moments,
    forecast_moments_kernel,
    forecast_moments_plain,
)
from .joint_filter import (
    joint_filter_append,
    joint_filter_append_kernel,
    joint_filter_append_plain,
)
from .lanes import (
    LanesFilterResult,
    lanes_adjoint,
    lanes_adjoint_kernel,
    lanes_adjoint_plain,
    lanes_filter,
    lanes_filter_kernel,
    lanes_filter_plain,
)

__all__ = [
    "LanesFilterResult",
    "build",
    "forecast_moments",
    "forecast_moments_kernel",
    "forecast_moments_plain",
    "joint_filter_append",
    "joint_filter_append_kernel",
    "joint_filter_append_plain",
    "lanes_adjoint",
    "lanes_adjoint_kernel",
    "lanes_adjoint_plain",
    "lanes_filter",
    "lanes_filter_kernel",
    "lanes_filter_plain",
    "launches",
    "reset_launches",
]
