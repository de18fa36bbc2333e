"""The port's single-model ``Metran`` on the square-root engine, on the
CPU, at the golden optimum of the example (5 series, T = 6,255 daily
steps, n = 6 states).  Its filter is the plain version of kernel K9
(``store``), its smoother K10's, its path draws K7 + K9 + K10 (mean
only) and its forecasts K2's, in f64.  The products are held

- against the JAX ``Metran(engine="sqrt")`` at the same table within
  1e-9 (relative to each product's scale), and the golden rows at
  ``tests/test_metran.py``'s bars;
- against the port's own ``engine="sequential"`` model within 1e-9;
- ``to_posterior_state().chol`` against the JAX model's factor through
  the covariance it stands for (a filtered factor is rank-deficient
  under ``r = 0``, see ``tests/test_torch_sqrt_kalman.py``).

The engine default is checked through :func:`default_engine`, which
needs no card: ``"sqrt"`` for a CUDA device, ``"sequential"`` on the
CPU, as the JAX package chooses by accelerator.
"""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import metran_tpu
import metran_tpu_torch
from metran_tpu_torch.models.metran import default_engine
from metran_tpu_torch.serve.engine import posterior_fault

# the plain versions make thousands of tiny LAPACK calls; with several
# test processes on one host, torch's OpenMP threads oversubscribe the
# cores, so a test process keeps torch to one thread
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
                                               engine="sqrt", device="cpu"),
                       golden)


@pytest.fixture(scope="module")
def mt_seq(series_list, golden):
    return _at_optimum(metran_tpu_torch.Metran(series_list, name=NAME,
                                               device="cpu"), golden)


@pytest.fixture(scope="module")
def mt_jax(series_list, golden):
    return _at_optimum(metran_tpu.Metran(series_list, name=NAME,
                                         engine="sqrt"), golden)


def _close(got, want, bar=1e-9):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= bar * np.abs(want[fin]).max()


def test_engine_defaults_follow_the_device(series_list):
    assert default_engine("cuda") == "sqrt"
    assert default_engine(torch.device("cuda", 0)) == "sqrt"
    assert default_engine("cpu") == "sequential"
    model = metran_tpu_torch.Metran(series_list, device="cpu")
    assert model._engine == "sequential"
    assert metran_tpu_torch.Metran(series_list, engine="sqrt",
                                   device="cpu")._engine == "sqrt"


def test_sqrt_products_match_jax_the_golden_rows_and_sequential(
        mt, mt_seq, mt_jax, golden):
    assert mt._engine == "sqrt" and mt.dtype == torch.float64
    rows = golden["state_means_rows_idx"]
    for name, key, atol in (
        ("get_state_means", "state_means_rows", 2e-4),
        ("get_state_variances", "state_variances_rows", 2e-4),
        ("get_simulated_means", "simulated_means_rows", 2e-3),
        ("get_simulated_variances", "simulated_variances_rows", 2e-3),
    ):
        got = getattr(mt, name)()
        np.testing.assert_allclose(got.iloc[rows].values, golden[key],
                                   atol=atol)
        _close(got.values, getattr(mt_jax, name)().values)
        _close(got.values, getattr(mt_seq, name)().values)
        assert got.index.equals(getattr(mt_jax, name)().index)
    # the products ran on the factored pass (K9 store + K10)
    assert mt.kf._sqrt_filtered is not None
    dec = mt.decompose_simulation("B21B0214001")
    np.testing.assert_allclose(dec.iloc[rows].values,
                               golden["decomposition_rows"], atol=2e-3)
    _close(dec.values, mt_jax.decompose_simulation("B21B0214001").values)
    _close(dec.values, mt_seq.decompose_simulation("B21B0214001").values)
    sim = mt.get_simulation("B21B0214005", alpha=None)
    _close(sim.values, mt_jax.get_simulation("B21B0214005",
                                             alpha=None).values)
    state = mt.get_state(5, method="filter")
    _close(state.values, mt_jax.get_state(5, method="filter").values)


def test_sqrt_innovations_forecasts_and_draws(mt, mt_seq, mt_jax):
    _close(mt.get_innovations(warmup=50).values,
           mt_jax.get_innovations(warmup=50).values)
    _close(mt.get_innovations(warmup=50).values,
           mt_seq.get_innovations(warmup=50).values)
    fc = mt.forecast("B21B0214003", steps=14)
    _close(fc.values, mt_jax.forecast("B21B0214003", steps=14).values)
    _close(fc.values, mt_seq.forecast("B21B0214003", steps=14).values)
    _close(mt.get_forecast_variances(7, standardized=True).values,
           mt_jax.get_forecast_variances(7, standardized=True).values)
    # path draws (K7 + K9 + K10 mean-only) pass through the data
    draws = mt.sample_simulation("B21B0214002", n_draws=2, seed=1)
    obs = mt.get_observations()["B21B0214002"]
    seen = obs.notna().values
    np.testing.assert_allclose(
        draws.values[seen], np.repeat(obs.values[seen, None], 2, 1),
        atol=1e-8)
    assert draws.values[~seen].std() > 0


def test_sqrt_posterior_state_carries_the_factor(mt, mt_jax):
    got = mt.to_posterior_state()
    want = mt_jax.to_posterior_state()
    assert got.chol is not None and want.chol is not None
    for field in ("mean", "cov", "params", "loadings"):
        _close(getattr(got, field), getattr(want, field), bar=1e-10)
    _close(got.chol @ got.chol.T, want.chol @ want.chol.T, bar=1e-10)
    _close(got.chol @ got.chol.T, got.cov, bar=1e-12)
    assert np.all(np.triu(got.chol, 1) == 0)
    assert posterior_fault(got.mean, got.cov, psd_tol=0.0,
                           chol=got.chol) is None


def test_sqrt_scipy_solve_waits_for_the_b7_adjoint(monkeypatch):
    """A float64 ScipySolve differentiates the deviance in "adjoint" mode,
    which the square-root engine now has (B7: K9 with segment boundaries,
    then K11; their plain versions here): the fit runs without
    ``METRAN_TPU_GRAD_ENGINE=autodiff`` and lands on the JAX package's
    ScipySolve optimum on the same engine (a short panel: the plain
    filter over the example's 6,255 steps is too slow for tier-1)."""
    from test_torch_metran_solve import short_panel

    monkeypatch.delenv("METRAN_TPU_GRAD_ENGINE", raising=False)
    series = short_panel(6, t=60, n=3)
    fits = []
    for pkg, kw in ((metran_tpu, {}), (metran_tpu_torch, {"device": "cpu"})):
        model = pkg.Metran(series, name="syn", engine="sqrt", **kw)
        model.solve(solver=pkg.models.ScipySolve, report=False)
        fits.append(model)
    want, got = fits
    assert got._resolved_grad() == "adjoint"
    assert got.fit.obj_func == pytest.approx(want.fit.obj_func, rel=1e-8)
    np.testing.assert_allclose(got.parameters["optimal"].values,
                               want.parameters["optimal"].values, rtol=1e-4)
