"""The port's solvers (``metran_tpu_torch.models.solver``) on the CPU:
the exact-Hessian covariance of ``BaseSolver`` (torch autograd through
the plain filter) against the JAX package's ``jax.hessian`` at f64
(rtol 1e-7), ``LanesSolve``'s scope, the solvers that are not ported
yet raising with their ROADMAP item, and ``run_lbfgs``'s telemetry
(``JaxSolve`` and ``batched_lbfgs`` against the JAX package's are in
``tests/test_torch_jaxsolve.py``).
"""

import numpy as np
import pytest
import torch
from test_torch_metran_solve import short_panel

import metran_tpu
import metran_tpu_torch

# one torch thread per test process (see tests/test_torch_metran.py)
torch.set_num_threads(1)


def test_exact_hessian_covariance_matches_jax():
    """``BaseSolver._get_covariance``: the exact Hessian through the
    plain filter (torch autograd) against JAX's ``jax.hessian``."""
    series = short_panel(1, t=60, n=3)
    models = []
    for pkg, kw in ((metran_tpu, {}), (metran_tpu_torch, {"device": "cpu"})):
        m = pkg.Metran(series, name="syn", **kw)
        m.get_factors(m.oseries)
        m._init_kalmanfilter()
        m.set_init_parameters()
        fit = pkg.models.solver.BaseSolver(mt=m)
        fit._setup()
        models.append(fit._get_covariance(fit.initial[fit.vary] * 1.3))
    want, got = models
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-10)


def test_unported_solvers_raise_naming_the_roadmap():
    """``LmfitSolve`` and the multi-start ``LanesSolve`` are ROADMAP A3
    (``JaxSolve`` is ported: held below)."""
    series = short_panel(2, t=40, n=3)
    mp = metran_tpu_torch.Metran(series, name="syn", device="cpu")
    from metran_tpu_torch.models import LmfitSolve

    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        mp.solve(solver=LmfitSolve, report=False)
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        mp.solve(solver=metran_tpu_torch.LanesSolve, n_starts=3,
                 report=False)


def test_lanessolve_supports_only_the_standard_box():
    series = short_panel(3, t=40, n=3)
    mp = metran_tpu_torch.Metran(series, name="syn", device="cpu")
    mp.get_factors(mp.oseries)
    mp._init_kalmanfilter()
    mp.set_init_parameters()
    assert metran_tpu_torch.LanesSolve.supports(mp)
    mp.parameters.loc[mp.parameters.index[0], "vary"] = False
    assert not metran_tpu_torch.LanesSolve.supports(mp)
    with pytest.raises(ValueError, match="vary=False"):
        metran_tpu_torch.LanesSolve(mt=mp).solve()


def test_run_lbfgs_telemetry_names_the_engine():
    """``run_lbfgs`` records the gradient engine and per-chunk wall times
    (``tests/test_adjoint.py``'s contract); unknown labels raise."""
    from metran_tpu_torch.models.solver import run_lbfgs
    from metran_tpu_torch.obs import FitTelemetry

    tele = FitTelemetry()
    theta, value, iters, nfev, converged = run_lbfgs(
        lambda x: torch.sum((x - 1.0) ** 2), torch.zeros(3,
                                                         dtype=torch.float64),
        maxiter=30, telemetry=tele, grad_engine="adjoint")
    assert converged and float(value) < 1e-12
    torch.testing.assert_close(theta, torch.ones(3, dtype=torch.float64))
    assert tele.grad_engine == "adjoint" and tele.stop_reason == "gradient"
    assert tele.checkpoints and all("wall_s" in c for c in tele.checkpoints)
    assert tele.iteration_wall_s() is not None
    assert "grad_engine=adjoint" in tele.summary()
    with pytest.raises(ValueError, match="unknown"):
        run_lbfgs(lambda x: torch.sum(x**2), torch.zeros(2), maxiter=2,
                  grad_engine="nope")
