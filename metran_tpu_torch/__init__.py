"""metran_tpu_torch: the PyTorch/CUDA port of metran-tpu.

A package of its own beside the JAX reference (``metran_tpu``): it
imports ``torch``, ``numpy``, the standard library and (for the
whiteness test of :mod:`.diagnostics`) ``scipy`` only.  Module
paths mirror the JAX package (``metran_tpu/serve/engine.py`` ->
``metran_tpu_torch/serve/engine.py``).

Ported so far — the serving path, the lane-layout fleet fit and the
lane-layout post-fit products of a fitted fleet:

- :mod:`.ops` — DFM state-space build, the joint and sequential Kalman
  engines (``kalman_filter``/``filter_append``/``deviance``), the
  lane-layout deviance with its closed-form adjoint, the lane-layout
  products (smoother, filtered projections, innovations, forecasts,
  path draws) and closed-form forecasts;
- :mod:`.kernels` — the hand-written Hopper kernels those ops run on
  CUDA tensors (K1 joint filter append, K2 forecast moments, K3 lanes
  filter, K4 lanes adjoint, K5 lanes smoother, K6 lanes forward filter
  with outputs, K7 path draw), each beside its plain PyTorch version;
- :mod:`.parallel` — packed fleets, the batched L-BFGS,
  ``fit_fleet(layout="lanes")`` and the fleet products;
- :mod:`.diagnostics` — the Ljung-Box whiteness test of innovations;
- :mod:`.serve` — posterior states, shape-bucketed registry,
  micro-batcher and ``MetranService``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (or CPU tensors); without a card they raise.
"""

__version__ = "0.1.0"
