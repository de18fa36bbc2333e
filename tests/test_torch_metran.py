"""The port's single-model ``Metran`` at the golden optimum, on the CPU.

The example series (5 series, T = 6,255 daily steps, n = 6 states) with
the golden ``optimal`` table set as ``parameters["optimal"]`` (the JAX
API's own way to carry a fitted table across; solving at this size runs
the plain filter, a Python loop, so ``tests/test_torch_metran_solve.py``
solves a short panel instead).  The products run the plain versions of
kernels K6 (``store``), K8, K2 and K7 in f64 and are held

- against the golden rows at ``tests/test_metran.py``'s bars;
- against the JAX ``Metran`` at the same table within 1e-9 (relative to
  each product's scale);
- ``to_posterior_state()`` against the JAX model's within 1e-10, and the
  port's ``ModelRegistry`` takes it;
- the reports against the JAX model's text for the same table and the
  same fit statistics.
"""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import metran_tpu
import metran_tpu_torch

# the plain versions make thousands of tiny LAPACK calls (one Cholesky per
# step); with several test processes on one host, torch's OpenMP threads
# oversubscribe the cores and each call waits on spinning threads (600x
# slower, measured), so a test process keeps torch to one thread
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden" / "metran_example.json"
NAME = "B21B0214"


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def _at_optimum(model, golden):
    model.get_factors(model.oseries)
    model.set_init_parameters()
    model.parameters["optimal"] = pd.Series(golden["optimal"],
                                            index=golden["param_names"])
    return model


@pytest.fixture(scope="module")
def mt(series_list, golden):
    return _at_optimum(metran_tpu_torch.Metran(series_list, name=NAME,
                                               device="cpu"), golden)


@pytest.fixture(scope="module")
def mt_jax(series_list, golden):
    return _at_optimum(metran_tpu.Metran(series_list, name=NAME), golden)


def _close(got, want, bar=1e-9):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= bar * np.abs(want[fin]).max()


def test_products_at_the_golden_optimum(mt, mt_jax, golden):
    rows = golden["state_means_rows_idx"]
    assert mt.dtype == torch.float64
    states = mt.get_state_means()
    assert list(states.columns) == golden["state_means_columns"]
    for got, want, key, atol in (
        (states, mt_jax.get_state_means(), "state_means_rows", 2e-4),
        (mt.get_state_variances(), mt_jax.get_state_variances(),
         "state_variances_rows", 2e-4),
        (mt.get_simulated_means(), mt_jax.get_simulated_means(),
         "simulated_means_rows", 2e-3),
        (mt.get_simulated_variances(), mt_jax.get_simulated_variances(),
         "simulated_variances_rows", 2e-3),
    ):
        np.testing.assert_allclose(got.iloc[rows].values, golden[key],
                                   atol=atol)
        _close(got.values, want.values)
        assert got.index.equals(want.index)
    dec = mt.decompose_simulation("B21B0214001")
    assert list(dec.columns) == golden["decomposition_columns"]
    np.testing.assert_allclose(dec.iloc[rows].values,
                               golden["decomposition_rows"], atol=2e-3)
    _close(dec.values, mt_jax.decompose_simulation("B21B0214001").values)
    # the means; the interval is sqrt of a variance that is ~0 at
    # observed dates (r = 0), where 1e-16 of rounding becomes ~1e-8
    sim = mt.get_simulation("B21B0214005", alpha=None)
    _close(sim.values, mt_jax.get_simulation("B21B0214005",
                                             alpha=None).values)
    band = mt.get_simulation("B21B0214005")
    assert (band["lower"] <= band["mean"]).all()
    assert (band["mean"] <= band["upper"]).all()
    state = mt.get_state(5, method="filter")
    _close(state.values, mt_jax.get_state(5, method="filter").values)
    assert mt.get_state(99) is None


def test_innovations_whiteness_and_forecasts(mt, mt_jax):
    _close(mt.get_innovations(warmup=50).values,
           mt_jax.get_innovations(warmup=50).values)
    got, want = mt.test_whiteness(), mt_jax.test_whiteness()
    _close(got["Q"].values, want["Q"].values)
    assert (got["white"] == want["white"]).all()
    fc = mt.forecast("B21B0214003", steps=14)
    _close(fc.values, mt_jax.forecast("B21B0214003", steps=14).values)
    assert fc.index.equals(mt_jax.forecast("B21B0214003", steps=14).index)
    _close(mt.get_forecast_variances(7, standardized=True).values,
           mt_jax.get_forecast_variances(7, standardized=True).values)
