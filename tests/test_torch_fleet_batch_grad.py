"""Port parity: the batch-layout fleet objective
(``metran_tpu_torch.parallel``: ``fleet_deviance`` and
``fleet_value_and_grad`` with ``layout="batch"``, the JAX defaults, for
the three engines; the engines' plain filters, with segment boundaries
under differentiation, and the plain version of kernel K11) against
``metran_tpu.parallel``, f64 on the CPU.

Tolerances: deviances rtol 1e-12, gradients 1e-10 normwise (the JAX
package's adjoint-vs-autodiff bar).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fleet import _structured

from metran_tpu.parallel import fleet as jf
from metran_tpu_torch.parallel import fleet as pf

# one torch thread per test process (see tests/test_torch_metran.py)
torch.set_num_threads(1)


def _fleets():
    jfleet, pfleet = _structured(np.random.default_rng(3), batch=3, n=4,
                                 t=80)
    p0 = np.asarray(jf.autocorr_init_params(jfleet))
    return jfleet, pfleet, p0


@pytest.mark.parametrize("engine", ["joint", "sqrt", "sequential"])
def test_fleet_deviance_and_gradient_match_jax(engine):
    jfleet, pfleet, p0 = _fleets()
    p = p0 * np.array([1.3, 0.7, 1.0, 2.0, 0.9])  # away from the init
    want = np.asarray(jf.fleet_deviance(jnp.asarray(p), jfleet,
                                        engine=engine))
    got = pf.fleet_deviance(p, pfleet, engine=engine)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    vj, gj = jf.fleet_value_and_grad(jnp.asarray(p), jfleet, engine=engine,
                                     grad="adjoint")
    vp, gp = pf.fleet_value_and_grad(p, pfleet, engine=engine)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=1e-12)
    gj = np.asarray(gj)
    assert np.max(np.abs(gp.numpy() - gj)) / np.max(np.abs(gj)) < 1e-10
    assert torch.equal(vp, got)  # the value is the same either way
