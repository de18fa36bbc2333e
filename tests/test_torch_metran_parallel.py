"""The port's single-model ``Metran`` and serving registry on the
associative-scan engines, on the CPU, in f64.

``Metran(engine="parallel")`` filters and smooths on the plain versions
of kernels K19/K20, ``engine="sqrt_parallel"`` on K21/K22 (its factors
cached as on ``"sqrt"``); the path draws run the sequential twins
(``"joint"``: K1 ``store`` + K8; ``"sqrt"``: K9 + K10), the forecasts
K2.  On a cut of the reference's example (two years of daily steps, 716
steps; the JAX associative scan compiles per length, so the full 6,255
steps would dominate the suite) at the golden optimum, the products are
held against the JAX ``Metran`` on the same engine and against the
port's own sequential engine within 1e-9 of each product's scale, as
``tests/test_torch_metran_sqrt.py`` does for ``"sqrt"``; square-root
factors through the covariance they stand for.

``ModelRegistry(engine="sqrt_parallel")`` updates exactly as ``"sqrt"``
(the JAX package's square-root engines): its service equals an
``engine="sqrt"`` service fed the same states bit for bit, and the JAX
``sqrt_parallel`` service at ``tests/test_torch_serve_sqrt.py``'s bar.
"""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import metran_tpu
import metran_tpu_torch
from metran_tpu.cluster._testing import make_states
from metran_tpu.serve import MetranService as JaxService
from metran_tpu.serve import ModelRegistry as JaxRegistry
from metran_tpu_torch.serve import MetranService, ModelRegistry
from metran_tpu_torch.serve import PosteriorState
from metran_tpu_torch.serve.state import posterior_state_from_metran
from test_torch_serve import _script
from test_torch_serve_sqrt import _compare

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden" / "metran_example.json"
CUT = slice("1990-01-01", "1991-12-31")
ENGINES = ("parallel", "sqrt_parallel")


def _at_optimum(model):
    golden = json.loads(GOLDEN.read_text())
    model.get_factors(model.oseries)
    model.set_init_parameters()
    model.parameters["optimal"] = pd.Series(golden["optimal"],
                                            index=golden["param_names"])
    return model


@pytest.fixture(scope="module")
def cut(series_list):
    return [s.loc[CUT] for s in series_list]


@pytest.fixture(scope="module")
def models(cut):
    """``{engine: (port model, JAX model)}`` and the port's sequential
    model, all at the golden optimum."""
    out = {eng: (_at_optimum(metran_tpu_torch.Metran(
                     cut, name="cut", engine=eng, device="cpu")),
                 _at_optimum(metran_tpu.Metran(cut, name="cut",
                                               engine=eng)))
           for eng in ENGINES}
    out["sequential"] = _at_optimum(metran_tpu_torch.Metran(
        cut, name="cut", device="cpu"))
    return out


def _close(got, want, bar=1e-9):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= bar * np.abs(want[fin]).max()


@pytest.mark.parametrize("engine", ENGINES)
def test_products_match_jax_and_the_sequential_engine(models, engine):
    mt, mt_jax = models[engine]
    mt_seq = models["sequential"]
    assert mt._engine == engine and mt.dtype == torch.float64
    for name in ("get_state_means", "get_state_variances",
                 "get_simulated_means", "get_simulated_variances"):
        got = getattr(mt, name)()
        _close(got.values, getattr(mt_jax, name)().values)
        _close(got.values, getattr(mt_seq, name)().values)
        assert got.index.equals(getattr(mt_jax, name)().index)
    # the factored engine's products ran on its cached factors
    assert (mt.kf._sqrt_filtered is not None) == (engine == "sqrt_parallel")
    name = mt.snames[0]
    for fn in (lambda m: m.decompose_simulation(name),
               lambda m: m.get_simulation(mt.snames[4], alpha=None),
               lambda m: m.get_state(5, method="filter"),
               lambda m: m.get_innovations(warmup=20),
               lambda m: m.forecast(mt.snames[2], steps=14),
               lambda m: m.get_forecast_variances(7, standardized=True)):
        _close(fn(mt).values, fn(mt_jax).values)
        _close(fn(mt).values, fn(mt_seq).values)


@pytest.mark.parametrize("engine", ENGINES)
def test_posterior_state_and_draws(models, engine):
    mt, mt_jax = models[engine]
    got, want = mt.to_posterior_state(), mt_jax.to_posterior_state()
    for field in ("mean", "cov", "params", "loadings"):
        _close(getattr(got, field), getattr(want, field), bar=1e-10)
    if engine == "sqrt_parallel":
        assert got.chol is not None and want.chol is not None
        _close(got.chol @ got.chol.T, want.chol @ want.chol.T, bar=1e-10)
        assert np.all(np.triu(got.chol, 1) == 0)
    else:
        assert got.chol is None and want.chol is None
    # the draws run the sequential twin and pass through the data
    assert mt.kf.draw_engine == {"parallel": "joint",
                                 "sqrt_parallel": "sqrt"}[engine]
    name = mt.snames[1]
    draws = mt.sample_simulation(name, n_draws=2, seed=1)
    obs = mt.get_observations()[name]
    seen = obs.notna().values
    np.testing.assert_allclose(
        draws.values[seen], np.repeat(obs.values[seen, None], 2, 1),
        atol=1e-8)
    assert draws.values[~seen].std() > 0


def test_engine_names_and_the_joint_engine(cut):
    for engine in ENGINES:
        assert metran_tpu_torch.Metran(cut, engine=engine,
                                       device="cpu")._engine == engine
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        metran_tpu_torch.Metran(cut, engine="joint", device="cpu")


def _service(engine, states, jax=False):
    if jax:
        reg = JaxRegistry(root=None, engine=engine)
        for st in states:
            reg.put(st, persist=False)
        return JaxService(reg, flush_deadline=None, persist_updates=False)
    reg = ModelRegistry(root=None, engine=engine, device="cpu")
    for st in states:
        reg.put(st, persist=False)
    return MetranService(reg, flush_deadline=None, persist_updates=False,
                         device="cpu")


def test_sqrt_parallel_registry_updates_as_sqrt_and_as_jax(models):
    """The state of the port's ``sqrt_parallel`` model (its K21 factor
    handed over) beside two fixture states, served by a
    ``sqrt_parallel`` registry: bit for bit an ``engine="sqrt"``
    registry's service, and the JAX ``sqrt_parallel`` service's."""
    mt, mt_jax = models["sqrt_parallel"]
    st = posterior_state_from_metran(mt, model_id="cut")
    assert st.chol is not None
    jstates = [mt_jax.to_posterior_state()] + list(make_states(n_models=2))
    pstates = [st] + [PosteriorState.from_jax_state(s) for s in jstates[1:]]
    ids = [s.model_id for s in jstates]
    assert ids[0] == "cut"
    par = _service("sqrt_parallel", pstates)
    assert par.registry._sqrt_engine
    seq = _service("sqrt", pstates)
    jsvc = _service("sqrt_parallel", jstates, jax=True)
    got = _script(par, ids, seed=3)
    twin = _script(seq, ids, seed=3)
    want = _script(jsvc, ids, seed=3)
    for g, t in zip(got, twin):
        assert type(g) is type(t) and g.version == t.version
        for field in ("mean", "cov", "chol", "means", "variances"):
            if hasattr(g, field):
                np.testing.assert_array_equal(getattr(g, field),
                                              getattr(t, field))
    _compare(want, got)
    for svc in (par, seq, jsvc):
        svc.close()
    with pytest.raises(ValueError, match="no serving update"):
        ModelRegistry(root=None, engine="parallel", device="cpu")
