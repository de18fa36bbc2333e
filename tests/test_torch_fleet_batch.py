"""Port parity: the batch-layout fleet fit (``metran_tpu_torch.parallel``:
``fit_fleet`` with ``layout="batch"``, the JAX defaults; the engines'
plain filters with segment boundaries, the plain version of kernel K11
and the port's copy of optax's L-BFGS) against ``metran_tpu.parallel``,
on the CPU.  Its objective and gradient are held in
``tests/test_torch_fleet_batch_grad.py``.

Tolerances: the fit with defaults (f64): deviance rtol 1e-8, parameters
rtol 1e-5, the same
``converged``/``stalled`` flags (the line search compares values, so
trajectories agree to roundoff, not bits).  The float32 fit with the
stall stop is held to the JAX package's float64 optimum at the f32 fleet
bar of ``tests/test_precision.py`` (deviance rel 1e-3), not to the JAX
float32 batch fit, which fails on the seed (``tests/test_convergence.py``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fleet import _structured

from metran_tpu.parallel import fleet as jf
from metran_tpu_torch.parallel import fleet as pf

# one torch thread per test process (see tests/test_torch_metran.py)
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _fleets():
    jfleet, pfleet = _structured(np.random.default_rng(3), batch=3, n=4,
                                 t=80)
    p0 = np.asarray(jf.autocorr_init_params(jfleet))
    return jfleet, pfleet, p0


@functools.lru_cache(maxsize=None)
def _jax_fit():
    jfleet, _, p0 = _fleets()
    return jf.fit_fleet(jfleet, p0=jnp.asarray(p0), maxiter=40)


def test_fit_fleet_with_the_jax_defaults_matches_jax():
    _, pfleet, p0 = _fleets()
    want = _jax_fit()
    got = pf.fit_fleet(pfleet, p0=torch.as_tensor(p0), maxiter=40)
    np.testing.assert_allclose(got.deviance.numpy(),
                               np.asarray(want.deviance), rtol=1e-8)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               rtol=1e-5)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.stalled.numpy(),
                                  np.asarray(want.stalled))
    assert got.converged.all() and got.nfev is None  # as JAX fills it


def test_f32_fit_with_the_stall_stop_reaches_the_f64_optimum():
    _, pfleet, p0 = _fleets()
    f32 = pf.Fleet(*(None if a is None else (
        a.to(torch.float32) if a.is_floating_point() else a) for a in pfleet))
    got = pf.fit_fleet(f32, p0=torch.as_tensor(p0, dtype=torch.float32),
                       maxiter=40, tol=0.05)
    assert got.deviance.dtype == torch.float32
    want = np.asarray(_jax_fit().deviance)
    rel = np.abs(got.deviance.double().numpy() - want) / np.abs(want)
    assert (rel < 1e-3).all(), rel
    assert got.converged.all()


def test_batch_fit_rejects_what_is_not_ported():
    _, pfleet, p0 = _fleets()
    # engine="parallel" is ported (K19; on the CPU autograd through its
    # plain version): the fit lands on the JAX joint fit's optimum
    got = pf.fit_fleet(pfleet, p0=torch.as_tensor(p0), engine="parallel",
                       maxiter=40)
    want = _jax_fit()
    np.testing.assert_allclose(got.deviance.numpy(),
                               np.asarray(want.deviance), rtol=1e-8)
    assert got.converged.all()
    with pytest.raises(ValueError, match="unknown layout"):
        pf.fit_fleet(pfleet, layout="tiles", maxiter=2)
