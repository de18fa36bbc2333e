"""metran_tpu_torch: the PyTorch/CUDA port of metran-tpu.

A package of its own beside the JAX reference (``metran_tpu``): it
imports ``torch``, ``numpy`` and the standard library only.  Module
paths mirror the JAX package (``metran_tpu/serve/engine.py`` ->
``metran_tpu_torch/serve/engine.py``).

Ported so far — the serving path and the lane-layout fleet fit:

- :mod:`.ops` — DFM state-space build, the joint and sequential Kalman
  engines (``kalman_filter``/``filter_append``/``deviance``), the
  lane-layout deviance with its closed-form adjoint, and closed-form
  forecasts;
- :mod:`.kernels` — the hand-written Hopper kernels those ops run on
  CUDA tensors (K1 joint filter append, K2 forecast moments, K3 lanes
  filter, K4 lanes adjoint), each beside its plain PyTorch version;
- :mod:`.parallel` — packed fleets, the batched L-BFGS and
  ``fit_fleet(layout="lanes")``;
- :mod:`.serve` — posterior states, shape-bucketed registry,
  micro-batcher and ``MetranService``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (or CPU tensors); without a card they raise.
"""

__version__ = "0.1.0"
