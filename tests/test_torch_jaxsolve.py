"""The port's optax-L-BFGS solvers (``metran_tpu_torch.models.solver``:
``JaxSolve`` and ``batched_lbfgs`` over the port's copy of optax's
L-BFGS, ``models/lbfgs.py``) against the JAX package's, f64 on the CPU.

Tolerances: the optimum rel 1e-9, parameters and standard errors rtol
1e-5 — the same algorithm on the same objective, so the two differ by
roundoff carried through the line searches.
"""

import numpy as np
import pytest
import torch
from test_torch_metran_solve import short_panel

import metran_tpu
import metran_tpu_torch

# one torch thread per test process (see tests/test_torch_metran.py)
torch.set_num_threads(1)


def test_jaxsolve_matches_the_jax_packages():
    """``JaxSolve`` end to end (fit through ``run_lbfgs``, the exact
    Hessian's standard errors) against the JAX package's, f64, on the
    CPU default engine (its deviance differentiates by the closed-form
    adjoint, K4's plain version)."""
    series = short_panel(4, t=60, n=3)
    fits = []
    for pkg, kw in ((metran_tpu, {}), (metran_tpu_torch, {"device": "cpu"})):
        m = pkg.Metran(series, name="syn", **kw)
        m.solve(solver=pkg.models.JaxSolve, report=False)
        fits.append(m)
    want, got = fits
    assert got.fit.obj_func == pytest.approx(want.fit.obj_func, rel=1e-9)
    np.testing.assert_allclose(got.parameters["optimal"].values,
                               want.parameters["optimal"].values, rtol=1e-5)
    np.testing.assert_allclose(got.parameters["stderr"].values,
                               want.parameters["stderr"].values, rtol=1e-5)
    assert got.fit.nfev == want.fit.nfev
    assert got.fit.telemetry.stop_reason == want.fit.telemetry.stop_reason
    assert "Fit telemetry" in got.fit_report()


def test_batched_lbfgs_matches_the_jax_packages():
    """``batched_lbfgs`` over three models' sqrt-engine deviances (a
    batched objective here, a vmapped scalar one in JAX)."""
    import jax.numpy as jnp

    from metran_tpu.models.solver import batched_lbfgs as jax_batched
    from metran_tpu.ops import deviance as jdev
    from metran_tpu.ops import dfm_statespace as jdfm
    from metran_tpu_torch.models.solver import batched_lbfgs
    from metran_tpu_torch.ops import deviance, dfm_statespace

    rng = np.random.default_rng(8)
    b, n, t = 3, 3, 50
    y = rng.normal(size=(b, t, n))
    mask = rng.uniform(size=(b, t, n)) > 0.25
    y = np.where(mask, y, 0.0)
    lds = rng.uniform(0.4, 0.8, (b, n, 1))
    theta0 = np.log(rng.uniform(3.0, 30.0, (b, n + 1)))

    def jax_obj(th, yy, mm, ld):
        a = jnp.exp(th)
        return jdev(jdfm(a[:n], a[n:], ld, 1.0), yy, mm, engine="sqrt")

    def port_obj(th, yy, mm, ld):
        a = torch.exp(th)
        return deviance(dfm_statespace(a[:, :n], a[:, n:], ld, device="cpu"),
                        yy, mm, engine="sqrt")

    want = jax_batched(jax_obj, jnp.asarray(theta0),
                       (jnp.asarray(y), jnp.asarray(mask), jnp.asarray(lds)),
                       maxiter=30)
    got = batched_lbfgs(port_obj, torch.tensor(theta0),
                        (torch.tensor(y), torch.tensor(mask),
                         torch.tensor(lds)), maxiter=30)
    np.testing.assert_allclose(got.value, want.value, rtol=1e-9)
    np.testing.assert_allclose(got.value0, want.value0, rtol=1e-12)
    np.testing.assert_allclose(got.theta, want.theta, rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(got.converged, want.converged)
