"""Port parity of the sharded fit: the port's ``fit_fleet(mesh=...)`` on a
virtual mesh of 8 CPU devices against the JAX package's
``fit_fleet(mesh=make_mesh(8))`` on the 8 virtual XLA CPU devices that
``tests/conftest.py`` sets up, on the same panels (5 models padded to 8),
f64, at the JAX test's bars (``tests/test_parallel.py``).  The batch
layout here, parameters rtol 1e-3 / atol 1e-6 and deviances rtol 1e-8;
the lanes layout in ``tests/test_torch_fleet_mesh_lanes_jax.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fleet_mesh import LANES, _fleet, _mesh
from test_torch_fleet_mesh_batch import BATCH

from metran_tpu.parallel import fleet as jf
from metran_tpu.parallel import mesh as jmesh
from metran_tpu_torch.parallel import fit_fleet, pad_to_multiple

pytestmark = pytest.mark.shard

torch.set_num_threads(1)

BARS = {"batch": (dict(rtol=1e-3, atol=1e-6), dict(rtol=1e-8)),
        "lanes": (dict(rtol=1e-4, atol=1e-6), dict(rtol=1e-6))}


def check_against_jax(layout):
    """The port's sharded fit and the JAX package's on the same fleet."""
    pfleet = _fleet(pad_batch_to=pad_to_multiple(5, 8))
    jfleet = jf.Fleet(*(None if a is None else jnp.asarray(a.numpy())
                        for a in pfleet))
    kw = BATCH if layout == "batch" else LANES
    want = jf.fit_fleet(jfleet, mesh=jmesh.make_mesh(8), **kw)
    got = fit_fleet(pfleet, mesh=_mesh(), **kw)
    par_bar, dev_bar = BARS[layout]
    np.testing.assert_allclose(got.params[:5].numpy(),
                               np.asarray(want.params[:5]), **par_bar)
    np.testing.assert_allclose(got.deviance[:5].numpy(),
                               np.asarray(want.deviance[:5]), **dev_bar)
    assert got.params.shape == tuple(want.params.shape)


def test_sharded_batch_fit_matches_jax_sharded_fit():
    check_against_jax("batch")
