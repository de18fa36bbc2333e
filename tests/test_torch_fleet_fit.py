"""Port parity: ``fit_fleet(layout="lanes")`` of
``metran_tpu_torch.parallel`` against ``metran_tpu.parallel`` on a
structured 4-model fleet (6 series, 1 factor, 150 steps), f64 on the CPU
(the plain versions of kernels K3/K4), at the bars of
``tests/test_parallel.py``: deviance rtol 1e-6, params rtol 1e-4 /
atol 1e-6, with equal iteration counts and flags.
"""

import numpy as np

from metran_tpu.parallel import fleet as jf
from metran_tpu_torch.parallel import fleet as pf
from test_torch_fleet import _structured

FIT = dict(maxiter=60, chunk=2, layout="lanes", remat_seg=32,
           max_linesearch_steps=4, stall_tol=1e-3)


def test_fit_fleet_lanes_parity():
    """A fit to convergence (the stall stop at 1e-3, the flagship
    setting) from the
    autocorrelation init lands where the JAX fit lands, in as many
    iterations, with the same flags."""
    rng = np.random.default_rng(3)
    jfleet, pfleet = _structured(rng)
    want = jf.fit_fleet(jfleet, p0=jf.autocorr_init_params(jfleet), **FIT)
    got = pf.fit_fleet(pfleet, p0=pf.autocorr_init_params(pfleet), **FIT)
    np.testing.assert_allclose(got.deviance.numpy(), np.asarray(want.deviance),
                               rtol=1e-6)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.stalled.numpy(),
                                  np.asarray(want.stalled))
    np.testing.assert_array_equal(got.nfev.numpy(), np.asarray(want.nfev))
    assert got.converged.all()
