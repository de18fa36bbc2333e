"""metran_tpu_torch: the PyTorch/CUDA port of metran-tpu.

A package of its own beside the JAX reference (``metran_tpu``): it
imports ``torch``, ``numpy``, the standard library, ``scipy`` and (for
the single-model API) ``pandas`` only.  Module paths mirror the JAX
package (``metran_tpu/serve/engine.py`` ->
``metran_tpu_torch/serve/engine.py``).

Ported so far — the serving path, the lane-layout fleet fit, the
lane-layout post-fit products of a fitted fleet and the single-model
``Metran`` API:

- :mod:`.models` — ``Metran`` (``Metran(series).solve()`` and its
  products), ``FactorAnalysis``, ``ScipySolve`` and ``LanesSolve``,
  exported here (imported at first use, so the rest of the package
  imports without pandas);
- :mod:`.ops` — DFM state-space build, the joint and sequential Kalman
  engines (``kalman_filter``, ``store=True`` included, ``filter_append``,
  ``deviance``), the RTS smoother, the lane-layout deviance with its
  closed-form adjoint, the lane-layout products (smoother, filtered
  projections, innovations, forecasts, path draws), closed-form
  forecasts and factor analysis;
- :mod:`.kernels` — the hand-written Hopper kernels those ops run on
  CUDA tensors (K1 joint filter append, K2 forecast moments, K3 lanes
  filter, K4 lanes adjoint, K5 lanes smoother, K6 lanes forward filter
  with outputs or stored moments, K7 path draw, K8 RTS smoother), each
  beside its plain PyTorch version;
- :mod:`.parallel` — packed fleets, the batched L-BFGS,
  ``fit_fleet(layout="lanes")``, ``fleet_stderr(method="lanes-fd")`` and
  the fleet products;
- :mod:`.data`, :mod:`.utils` — ingestion, standardization and packing;
- :mod:`.diagnostics` — the Ljung-Box whiteness test of innovations;
- :mod:`.serve` — posterior states, shape-bucketed registry,
  micro-batcher and ``MetranService``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (or CPU tensors); without a card they raise.
"""

__version__ = "0.1.0"

_MODELS = ("Metran", "FactorAnalysis", "ScipySolve", "LanesSolve")


def __getattr__(name):
    if name in _MODELS:
        from . import models

        return getattr(models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["__version__", *_MODELS]
