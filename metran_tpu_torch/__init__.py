"""metran_tpu_torch: the PyTorch/CUDA port of metran-tpu.

A package of its own beside the JAX reference (``metran_tpu``): it
imports ``torch``, ``numpy``, the standard library, ``scipy`` and (for
the single-model API) ``pandas`` only.  Module paths mirror the JAX
package (``metran_tpu/serve/engine.py`` ->
``metran_tpu_torch/serve/engine.py``).

Ported so far — the serving path, the lane-layout and batch-layout
fleet fits, the lane-layout post-fit products of a fitted fleet, the
single-model ``Metran`` API, the square-root engine and the serving
path's input defences (reliability, observation gate, detection):

- :mod:`.models` — ``Metran`` (``Metran(series).solve()`` and its
  products), ``FactorAnalysis``, ``ScipySolve``, ``JaxSolve`` and
  ``LanesSolve``, exported here (imported at first use, so the rest of
  the package imports without pandas), and the batched L-BFGS with the
  zoom line search (``models.lbfgs``, a copy of optax's);
- :mod:`.ops` — DFM state-space build, the joint, sequential and
  square-root Kalman engines (``kalman_filter``, ``filter_append``,
  ``deviance``), the observation gate (``gated_filter_append``,
  ``gated_sqrt_filter_append``), streaming detection (``ops.detect``),
  the RTS smoothers, the closed-form adjoints (lane
  layout, and the batch layout of ``ops.adjoint``), the lane-layout
  products (smoother, filtered projections, innovations, forecasts,
  path draws), closed-form forecasts and factor analysis;
- :mod:`.kernels` — the hand-written Hopper kernels those ops run on
  CUDA tensors (K1 joint filter append, K2 forecast moments, K3 lanes
  filter, K4 lanes adjoint, K5 lanes smoother, K6 lanes forward filter
  with outputs or stored moments, K7 path draw, K8 RTS smoother, K9
  square-root filter, K10 square-root smoother, K11 batch-layout
  adjoint, K12 gated sequential update, K13 detector), each beside its
  plain PyTorch version;
- :mod:`.parallel` — packed fleets, the batched L-BFGS,
  ``fit_fleet`` (``layout="batch"``, the default, and ``"lanes"``),
  ``fleet_stderr(method="lanes-fd")`` and the fleet products;
- :mod:`.obs` — the per-fit optimizer telemetry;
- :mod:`.data`, :mod:`.utils` — ingestion, standardization and packing;
- :mod:`.diagnostics` — the Ljung-Box whiteness test of innovations;
- :mod:`.reliability` — retries, circuit breakers, the health monitor;
- :mod:`.serve` — posterior states, shape-bucketed registry,
  micro-batcher, gate and detection specs, alerting and
  ``MetranService``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (or CPU tensors); without a card they raise.
"""

__version__ = "0.1.0"

_MODELS = ("Metran", "FactorAnalysis", "ScipySolve", "JaxSolve",
           "LanesSolve")


def __getattr__(name):
    if name in _MODELS:
        from . import models

        return getattr(models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["__version__", *_MODELS]
