"""Port parity: square-root serving — ``ModelRegistry(engine="sqrt")`` +
``MetranService`` of ``metran_tpu_torch.serve`` against the JAX
``metran_tpu.serve`` with ``engine="sqrt"`` on the CPU, f64.

Both services run the request script of ``tests/test_torch_serve.py``
(forecasts, three flush rounds of updates with same-model chains, sync
calls, batch calls) on the JAX package's serving fixture, whose states
carry no factor (each is migrated once, ``psd_factor``), and on a state
extracted from a JAX ``Metran(engine="sqrt")``, which carries its
filtered factor.  Versions and ``t_seen`` must be equal; means,
covariances and forecasts agree to ``rtol=1e-10`` (``atol=1e-12``); the
committed factors are compared through the covariance they stand for
(a filtered factor is rank-deficient under ``r = 0``, see
``tests/test_torch_sqrt_kalman.py``).
"""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import metran_tpu
from metran_tpu.cluster._testing import make_states
from metran_tpu.serve import MetranService as JaxService
from metran_tpu.serve import ModelRegistry as JaxRegistry
from metran_tpu.serve import engine as jeng
from metran_tpu_torch.serve import MetranService, ModelRegistry
from metran_tpu_torch.serve import PosteriorState
from metran_tpu_torch.serve import engine as peng
from test_torch_serve import _script

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
GOLDEN = Path(__file__).parent / "golden" / "metran_example.json"


def _services(states):
    jreg = JaxRegistry(root=None, engine="sqrt")
    preg = ModelRegistry(root=None, engine="sqrt")
    for st in states:
        jreg.put(st, persist=False)
        preg.put(PosteriorState.from_jax_state(st), persist=False)
    jsvc = JaxService(jreg, flush_deadline=None, persist_updates=False)
    psvc = MetranService(preg, flush_deadline=None, persist_updates=False,
                         device="cpu")
    return jsvc, psvc


def _compare(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert not isinstance(g, BaseException), g
        assert type(g).__name__ == type(w).__name__
        assert g.version == w.version
        if hasattr(w, "cov"):
            assert g.t_seen == w.t_seen and g.model_id == w.model_id
            np.testing.assert_allclose(g.mean, w.mean, **TOL)
            np.testing.assert_allclose(g.cov, w.cov, **TOL)
            # the committed state carries its factor, lower-triangular
            assert g.chol is not None and w.chol is not None
            np.testing.assert_allclose(g.chol @ g.chol.T, w.chol @ w.chol.T,
                                       **TOL)
            np.testing.assert_array_equal(g.cov, g.chol @ g.chol.T)
            assert np.all(np.triu(g.chol, 1) == 0)
        else:
            assert g.names == w.names
            np.testing.assert_allclose(g.means, w.means, **TOL)
            np.testing.assert_allclose(g.variances, w.variances, **TOL)


def test_sqrt_service_matches_jax_service():
    states = make_states(n_models=4)
    jsvc, psvc = _services(states)
    assert psvc.registry.engine == "sqrt"
    ids = [st.model_id for st in states]
    want = _script(jsvc, ids, seed=5)
    got = _script(psvc, ids, seed=5)
    _compare(want, got)
    for m in ids:
        j, p = jsvc.registry.get(m), psvc.registry.get(m)
        assert (p.version, p.t_seen) == (j.version, j.t_seen)
    assert psvc.registry.get(ids[0]).version == 10
    jsvc.close()
    psvc.close()


def test_pad_state_arrays_sqrt_with_and_without_a_factor():
    st = make_states(n_models=1, n=5, kf=2)[0]
    bucket = (8, 16)
    rng = np.random.default_rng(4)
    a = rng.normal(size=(st.n_state, st.n_state))
    with_chol = st._replace(chol=np.linalg.cholesky(a @ a.T + np.eye(7)))
    for state in (st, with_chol):
        want = jeng.pad_state_arrays(state, bucket, sqrt=True)
        got = peng.pad_state_arrays(PosteriorState.from_jax_state(state),
                                    bucket, sqrt=True)
        assert got[4] is None and want[4] is None
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(got[5], want[5], rtol=1e-12, atol=1e-14)
    # without a factor, the migration shim factors the covariance
    f = peng.psd_factor(st.cov)
    np.testing.assert_allclose(f @ f.T, st.cov, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(f, jeng.psd_factor(st.cov), atol=1e-12)
    # the covariance-form pad keeps its five leading entries, no factor
    got = peng.pad_state_arrays(PosteriorState.from_jax_state(st), bucket)
    assert got[5] is None and got[4] is not None
    batch = peng.stack_bucket([PosteriorState.from_jax_state(with_chol)],
                              bucket, device="cpu", sqrt=True)
    want = jeng.stack_bucket([with_chol], bucket, sqrt=True)
    assert batch.cov is None and want.cov is None
    np.testing.assert_array_equal(batch.chol.numpy(), np.asarray(want.chol))


def test_posterior_fault_with_a_factor_matches_jax():
    rng = np.random.default_rng(6)
    chol = np.tril(rng.normal(size=(4, 4)))
    cov = chol @ chol.T
    mean = rng.normal(size=4)
    bad_chol = chol.copy()
    bad_chol[2, 1] = np.nan
    big = np.full((4, 4), 1e200)
    for args in ((mean, cov, chol), (mean, cov, bad_chol),
                 (mean, big @ big.T, big), (mean * np.nan, cov, chol)):
        want = jeng.posterior_fault(*args[:2], psd_tol=0.0, chol=args[2])
        got = peng.posterior_fault(*args[:2], psd_tol=0.0, chol=args[2])
        assert got == want
    assert peng.posterior_fault(mean, cov, psd_tol=0.0, chol=chol) is None
    assert "factor" in peng.posterior_fault(mean, cov, chol=bad_chol)


def test_jax_metran_sqrt_state_served_by_the_port(series_list):
    golden = json.loads(GOLDEN.read_text())
    mt = metran_tpu.Metran(series_list, name="B21B0214", engine="sqrt")
    mt.get_factors(mt.oseries)
    mt.set_init_parameters()
    mt.parameters["optimal"] = pd.Series(golden["optimal"],
                                         index=golden["param_names"])
    st = mt.to_posterior_state()
    assert st.chol is not None
    states = [st] + list(make_states(n_models=2))
    jsvc, psvc = _services(states)
    ids = [s.model_id for s in states]
    want = _script(jsvc, ids, seed=9)
    got = _script(psvc, ids, seed=9)
    _compare(want, got)
    assert psvc.registry.get(st.model_id).version == \
        jsvc.registry.get(st.model_id).version
    jsvc.close()
    psvc.close()
