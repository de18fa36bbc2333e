"""metran_tpu_torch: the PyTorch/CUDA port of metran-tpu.

A package of its own beside the JAX reference (``metran_tpu``): it
imports ``torch``, ``numpy`` and the standard library only.  Module
paths mirror the JAX package (``metran_tpu/serve/engine.py`` ->
``metran_tpu_torch/serve/engine.py``).

Ported so far — the serving path:

- :mod:`.ops` — DFM state-space build, the joint Kalman engine
  (``kalman_filter``/``filter_append``) and closed-form forecasts;
- :mod:`.kernels` — the hand-written Hopper kernels those ops run on
  CUDA tensors (K1 joint filter append, K2 forecast moments), each
  beside its plain PyTorch version;
- :mod:`.serve` — posterior states, shape-bucketed registry,
  micro-batcher and ``MetranService``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (or CPU tensors); without a card they raise.
"""

__version__ = "0.1.0"
