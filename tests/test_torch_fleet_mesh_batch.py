"""``fit_fleet(mesh=...)`` in the batch layout (the default) on a
virtual mesh of 8 CPU devices, against the unsharded fit, at the JAX
test's bars (``tests/test_parallel.py::test_fit_fleet_sharded_matches_
unsharded``): parameters rtol 1e-3 / atol 1e-6 and deviances rtol 1e-8
(each shard's line-search rounds follow its own slowest lane, so a
model's iterate path may differ from the unsharded one's by the rounds'
reduction order).
"""

import numpy as np
import pytest
import torch
from test_torch_fleet_mesh import _fleet, _mesh

from metran_tpu_torch.parallel import fit_fleet, pad_to_multiple

pytestmark = pytest.mark.shard

torch.set_num_threads(1)

BATCH = dict(maxiter=8)


@pytest.fixture(scope="module")
def fleet():
    return _fleet(pad_batch_to=pad_to_multiple(5, 8))


@pytest.fixture(scope="module")
def batch_base(fleet):
    return fit_fleet(fleet, **BATCH)


@pytest.mark.parametrize("use_shard_map", [False, True])
def test_fit_fleet_sharded_matches_unsharded(fleet, batch_base,
                                             use_shard_map):
    sharded = fit_fleet(fleet, mesh=_mesh(), **BATCH,
                        use_shard_map=use_shard_map)
    np.testing.assert_allclose(sharded.params[:5].numpy(),
                               batch_base.params[:5].numpy(), rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(sharded.deviance[:5].numpy(),
                               batch_base.deviance[:5].numpy(), rtol=1e-8)
    assert sharded.params.shape == batch_base.params.shape
    assert sharded.params.device == torch.device("cpu")
