"""The port's single-model ``Metran`` at the golden optimum, on the CPU:
masking, the deviance, path draws, the serving state, the reports and
the engine and device rules (the products are in
``tests/test_torch_metran.py``).

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
from metran_tpu_torch.models.solver import BaseSolver
from metran_tpu_torch.serve import ModelRegistry

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


def test_masked_golden_value_and_mle(mt, golden):
    mask = (0 * mt.get_observations()).astype(bool)
    mask.loc["1997-8-28", "B21B0214005"] = True
    before = mt.get_simulation("B21B0214005", alpha=None)
    mt.mask_observations(mask)
    sim = mt.get_simulation("B21B0214005", alpha=None)
    np.testing.assert_allclose(float(sim.loc["1997-08-28"]),
                               golden["masked_sim_1997"][0], atol=2e-3)
    mt.unmask_observations()
    sim = mt.get_simulation("B21B0214005", alpha=None)
    np.testing.assert_allclose(float(sim.loc["1997-08-28"]),
                               golden["unmasked_sim_1997"][0], atol=2e-3)
    assert (sim == before).all()
    got = mt.get_mle(np.array(golden["optimal"]))
    np.testing.assert_allclose(got, golden["deviance_at_optimal"], rtol=1e-8)
    # the runner's own deviance from the stored filter agrees
    np.testing.assert_allclose(mt.kf.get_mle(), got, rtol=1e-12)


def test_sample_simulation_passes_through_the_data(mt):
    draws = mt.sample_simulation("B21B0214002", n_draws=2, seed=1)
    assert draws.shape == (len(mt.oseries), 2)
    assert list(draws.columns) == ["draw0", "draw1"]
    obs = mt.get_observations()["B21B0214002"]
    seen = obs.notna().values
    np.testing.assert_allclose(
        draws.values[seen], np.repeat(obs.values[seen, None], 2, 1),
        atol=1e-8)
    assert draws.values[~seen].std() > 0  # the draws spread in the gaps


def test_posterior_state_matches_jax_and_registers(mt, mt_jax, tmp_path):
    got = mt.to_posterior_state()
    want = mt_jax.to_posterior_state()
    for field in ("mean", "cov", "params", "loadings", "scaler_mean",
                  "scaler_std"):
        _close(getattr(got, field), getattr(want, field), bar=1e-10)
    assert (got.model_id, got.t_seen, got.dt, got.names) == (
        want.model_id, want.t_seen, want.dt, want.names)
    registry = ModelRegistry(root=tmp_path)
    registry.put(got)
    back = registry.get(NAME, refresh=True)
    np.testing.assert_array_equal(back.cov, got.cov)


def test_reports_match_jax_for_the_same_table(mt, mt_jax, golden):
    assert mt.metran_report() == mt_jax.metran_report()
    n = len(golden["optimal"])
    pcov = np.diag(np.square(golden["stderr"])) + 0.1
    for model in (mt, mt_jax):
        fit = (BaseSolver if model is mt else
               metran_tpu.models.solver.BaseSolver)(mt=model)
        fit._setup()
        _, _, stderr = fit._finalize(np.asarray(golden["optimal"]),
                                     golden["obj_func"], golden["nfev"],
                                     True, pcov)
        model.fit = fit
        model.parameters["stderr"] = stderr
        model.settings["solver"] = fit._name
    assert n == 6
    # neither BaseSolver records optimizer telemetry, so the whole text
    # compares
    assert mt.fit_report() == mt_jax.fit_report()


def test_engines_devices_and_unported_features(series_list, mt):
    # the square-root engine is ported (kernels K9/K10); its products
    # are held against JAX in tests/test_torch_metran_sqrt.py
    assert metran_tpu_torch.Metran(series_list, engine="sqrt",
                                   device="cpu")._engine == "sqrt"
    # the joint engine waits for its single-model products (ROADMAP
    # A2); the associative-scan engines are ported (kernels K19-K22, held
    # against JAX in tests/test_torch_metran_parallel.py)
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        metran_tpu_torch.Metran(series_list, engine="joint", device="cpu")
    for engine in ("parallel", "sqrt_parallel"):
        model = metran_tpu_torch.Metran(series_list, engine=engine,
                                        device="cpu")
        assert model._engine == engine
    assert metran_tpu_torch.Metran(series_list, engine="numba",
                                   device="cpu")._engine == "sequential"
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        mt.plots
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        mt.to_file("model.json")
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        metran_tpu_torch.Metran.from_file("model.json")
