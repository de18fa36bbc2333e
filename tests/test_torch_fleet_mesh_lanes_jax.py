"""Port parity of the sharded lanes fit: the port's ``fit_fleet(layout=
"lanes", mesh=...)`` on a virtual mesh of 8 CPU devices against the JAX
package's on its 8 virtual XLA CPU devices, on the same panels, at the
JAX test's bars (``tests/test_parallel.py``): deviances rtol 1e-6 and
parameters rtol 1e-4 / atol 1e-6 (the batch layout:
``tests/test_torch_fleet_mesh_jax.py``).
"""

import pytest
import torch
from test_torch_fleet_mesh_jax import check_against_jax

pytestmark = pytest.mark.shard

torch.set_num_threads(1)


def test_sharded_lanes_fit_matches_jax_sharded_fit():
    check_against_jax("lanes")
