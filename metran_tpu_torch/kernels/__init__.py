"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

- :mod:`.joint_filter` — K1, the joint-update filter append, with or
  without segment boundaries, or with every step's moments stored (a
  group of warps per model; the earlier one-block-per-model kernel stays
  beside it as its bit-for-bit oracle, ``joint_filter_*_block``);
- :mod:`.forecast` — K2, the closed-form forecast moments;
- :mod:`.lanes` — K3, the lane-layout sequential filter (a chain warp
  and update warps a lane), and K4, its closed-form adjoint (replay warps
  filling a ring of segment records for its sweep warps); the earlier
  one-warp-per-lane kernels stay beside them as their bit-for-bit
  oracles, ``lanes_filter_warp_kernel`` and ``lanes_adjoint_warp_kernel``;
- :mod:`.lanes_products` — K5, the lane-layout smoother's backward
  pass, K6, the forward filter with per-step outputs (or, in its
  ``store`` mode, the stored moments), and K7, the simulation
  smoother's path draw;
- :mod:`.smoother` — K8, the RTS smoother over stored moments;
- :mod:`.sqrt_filter` — K9, the square-root (QR array) filter, with its
  per-step store, with segment boundaries or with neither, from
  ``(0, I)`` or a given carry, or gated (the observation gate) or robust
  (the implicit-MAP update) from a given carry (a group of warps per
  lane; the earlier one-block-per-lane kernel stays beside it as its
  bit-for-bit oracle, ``sqrt_filter*_block``);
- :mod:`.sqrt_smoother` — K10, the factored RTS smoother over K9's
  stored factors;
- :mod:`.joint_adjoint` — K11, the closed-form reverse sweep of the
  batch-layout deviance (the backward of ``ops.adjoint``);
- :mod:`.gated_filter` — K12, the gated sequential-processing filter
  append (the observation gate; with the gate off, the sequential
  serving update; in its robust modes, the implicit-MAP update);
- :mod:`.implicit_map` — the scalar MAP solve of the robust modes of K12
  and K9 (``csrc/implicit_map.cuh`` on the card), in PyTorch ops;
- :mod:`.detect` — K13, the streaming detector over z-scores;
- :mod:`.steady_filter` — K14, the frozen-gain (steady-state) mean
  append of frozen serving models, in the vector (joint gain) or the
  per-slot (sequential gains) form;
- :mod:`.dare` — K15, the steady-state DARE solve by Newton-Kleinman
  with doubled Lyapunov solves, and the frozen gains from it;
- :mod:`.arena` — the state arena's in-place kernels: K16, the exact
  update (gather, the engine's step body, the integrity gate, the
  detection tail and the masked scatter; joint, sequential/gated/robust
  and square-root families), K17, the frozen-gain update, and K18, the
  forecast (imported as ``metran_tpu_torch.kernels.arena``: its plain
  versions use the ops' detector statistics and convergence test);
- :mod:`.pkalman` — K19-K22, the associative-scan (parallel-in-time)
  filter and smoother in covariance and in square-root form, and K19/
  K20's ``total``, ``carry`` and ``prefix`` modes for the time axis
  sharded over a device mesh;
- :mod:`.build` — the ``nvcc`` build, the ``ctypes`` binding and the
  launch counters.

Each wrapper (``joint_filter_append``, ``joint_filter_store``,
``forecast_moments``, ``lanes_filter``, ``lanes_adjoint``,
``lanes_smooth_bwd``, ``lanes_forward``, ``lanes_sample``,
``rts_smooth``, ``sqrt_filter``, ``sqrt_filter_gated``,
``sqrt_filter_robust``, ``sqrt_smooth``, ``joint_adjoint``,
``gated_filter_append``, ``robust_filter_append``, ``detect_scan``,
``steady_filter``, ``dare_gains``, ``arena_update``,
``arena_steady_update``, ``arena_forecast``, ``parallel_filter``,
``parallel_smooth``, ``sqrt_parallel_filter``, ``sqrt_parallel_smooth``,
``parallel_filter_total``/``_carry``/``_prefix``,
``parallel_smooth_total``/``_carry``/``_prefix``)
launches its kernel (``*_kernel``, which takes CUDA tensors only and
raises if it cannot build or launch) on CUDA tensors and runs the plain
version (``*_plain``) on CPU tensors; there is no fallback between
them.  Nothing is built or loaded at import.  The robust modes count
their launches apart (``gated_filter_robust``, ``sqrt_filter_robust``),
so a run shows which instantiation a dispatch went through.
"""

from . import build
from .build import launches, reset_launches
from .dare import dare_gains, dare_gains_kernel, dare_gains_plain
from .detect import detect_scan, detect_scan_kernel, detect_scan_plain
from .forecast import (
    forecast_moments,
    forecast_moments_kernel,
    forecast_moments_plain,
)
from .gated_filter import (
    gated_filter_append,
    gated_filter_append_kernel,
    gated_filter_append_plain,
    robust_filter_append,
    robust_filter_append_kernel,
    robust_filter_append_plain,
)
from .joint_adjoint import (
    joint_adjoint,
    joint_adjoint_kernel,
    joint_adjoint_plain,
)
from .joint_filter import (
    joint_filter_append,
    joint_filter_append_block,
    joint_filter_append_kernel,
    joint_filter_append_plain,
    joint_filter_store,
    joint_filter_store_block,
    joint_filter_store_kernel,
    joint_filter_store_plain,
)
from .lanes import (
    LanesFilterResult,
    lanes_adjoint,
    lanes_adjoint_kernel,
    lanes_adjoint_plain,
    lanes_adjoint_warp_kernel,
    lanes_filter,
    lanes_filter_kernel,
    lanes_filter_plain,
    lanes_filter_warp_kernel,
)
from .lanes_products import (
    lanes_forward,
    lanes_forward_kernel,
    lanes_forward_plain,
    lanes_sample,
    lanes_sample_kernel,
    lanes_sample_plain,
    lanes_smooth_bwd,
    lanes_smooth_bwd_kernel,
    lanes_smooth_bwd_plain,
)
from .pkalman import (
    parallel_filter,
    parallel_filter_kernel,
    parallel_filter_plain,
    parallel_smooth,
    parallel_smooth_kernel,
    parallel_smooth_plain,
    sqrt_parallel_filter,
    sqrt_parallel_filter_kernel,
    sqrt_parallel_filter_plain,
    sqrt_parallel_smooth,
    sqrt_parallel_smooth_kernel,
    sqrt_parallel_smooth_plain,
)
from .smoother import rts_smooth, rts_smooth_kernel, rts_smooth_plain
from .sqrt_filter import (
    sqrt_filter,
    sqrt_filter_block,
    sqrt_filter_gated,
    sqrt_filter_gated_block,
    sqrt_filter_gated_kernel,
    sqrt_filter_gated_plain,
    sqrt_filter_kernel,
    sqrt_filter_plain,
    sqrt_filter_robust,
    sqrt_filter_robust_block,
    sqrt_filter_robust_kernel,
    sqrt_filter_robust_plain,
)
from .sqrt_smoother import (
    sqrt_smooth,
    sqrt_smooth_kernel,
    sqrt_smooth_plain,
)
from .steady_filter import (
    steady_filter,
    steady_filter_kernel,
    steady_filter_plain,
)

__all__ = [
    "LanesFilterResult",
    "build",
    "dare_gains",
    "dare_gains_kernel",
    "dare_gains_plain",
    "detect_scan",
    "detect_scan_kernel",
    "detect_scan_plain",
    "forecast_moments",
    "forecast_moments_kernel",
    "forecast_moments_plain",
    "gated_filter_append",
    "gated_filter_append_kernel",
    "gated_filter_append_plain",
    "joint_adjoint",
    "joint_adjoint_kernel",
    "joint_adjoint_plain",
    "joint_filter_append",
    "joint_filter_append_block",
    "joint_filter_append_kernel",
    "joint_filter_append_plain",
    "joint_filter_store",
    "joint_filter_store_block",
    "joint_filter_store_kernel",
    "joint_filter_store_plain",
    "lanes_adjoint",
    "lanes_adjoint_kernel",
    "lanes_adjoint_plain",
    "lanes_adjoint_warp_kernel",
    "lanes_filter",
    "lanes_filter_kernel",
    "lanes_filter_plain",
    "lanes_filter_warp_kernel",
    "lanes_forward",
    "lanes_forward_kernel",
    "lanes_forward_plain",
    "lanes_sample",
    "lanes_sample_kernel",
    "lanes_sample_plain",
    "lanes_smooth_bwd",
    "lanes_smooth_bwd_kernel",
    "lanes_smooth_bwd_plain",
    "launches",
    "parallel_filter",
    "parallel_filter_kernel",
    "parallel_filter_plain",
    "parallel_smooth",
    "parallel_smooth_kernel",
    "parallel_smooth_plain",
    "reset_launches",
    "robust_filter_append",
    "robust_filter_append_kernel",
    "robust_filter_append_plain",
    "rts_smooth",
    "rts_smooth_kernel",
    "rts_smooth_plain",
    "sqrt_filter",
    "sqrt_filter_block",
    "sqrt_filter_gated",
    "sqrt_filter_gated_block",
    "sqrt_filter_gated_kernel",
    "sqrt_filter_gated_plain",
    "sqrt_filter_kernel",
    "sqrt_filter_plain",
    "sqrt_filter_robust",
    "sqrt_filter_robust_block",
    "sqrt_filter_robust_kernel",
    "sqrt_filter_robust_plain",
    "sqrt_parallel_filter",
    "sqrt_parallel_filter_kernel",
    "sqrt_parallel_filter_plain",
    "sqrt_parallel_smooth",
    "sqrt_parallel_smooth_kernel",
    "sqrt_parallel_smooth_plain",
    "sqrt_smooth",
    "sqrt_smooth_kernel",
    "sqrt_smooth_plain",
    "steady_filter",
    "steady_filter_kernel",
    "steady_filter_plain",
]
