"""``fit_fleet(mesh=...)`` in the lanes layout on a virtual mesh of CPU
devices, against the unsharded fit, at the JAX test's bars
(``tests/test_parallel.py``): deviances rtol 1e-6 and parameters rtol
1e-4 / atol 1e-6 (lanes never interact; the batch layout:
``tests/test_torch_fleet_mesh_batch.py``).  Also the JAX
checks and defaults the mesh brings: a fleet the mesh does not divide
raises, the lanes layout ignores ``use_shard_map`` with a warning, and
``lane_min_batch`` (a TPU lane-tile pad in the JAX package) changes
nothing.
"""

import logging

import numpy as np
import pandas as pd
import pytest
import torch

from metran_tpu_torch import data as pdata
from metran_tpu_torch.parallel import (
    fit_fleet,
    make_mesh,
    pack_fleet,
    pad_to_multiple,
)

pytestmark = pytest.mark.shard

torch.set_num_threads(1)

LANES = dict(maxiter=12, chunk=6, layout="lanes", remat_seg=16)


def _panel(rng, n_series, t, missing=0.3):
    """``tests/test_parallel.py::_random_panel``'s recipe."""
    idx = pd.date_range("2000-01-01", periods=t, freq="D")
    raw = rng.normal(size=(t, n_series))
    raw[rng.uniform(size=raw.shape) < missing] = np.nan
    raw[0] = np.nan
    frame = pd.DataFrame(raw, index=idx,
                         columns=[f"s{i}" for i in range(n_series)])
    return pdata.pack_panel(frame)


def _fleet(sizes=(4, 3, 4, 4, 3), t=32, pad_batch_to=8, seed=42):
    rng = np.random.default_rng(seed)
    panels = [_panel(rng, n, t) for n in sizes]
    loadings = [rng.uniform(0.3, 0.8, (n, 1)) for n in sizes]
    return pack_fleet(panels, loadings, pad_batch_to=pad_batch_to,
                      device="cpu")


def _mesh(n=8, axes=("batch",)):
    return make_mesh(n, axes, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def fleet():
    return _fleet(pad_batch_to=pad_to_multiple(5, 8))


def test_fit_fleet_lanes_sharded_matches_unsharded(fleet):
    base = fit_fleet(fleet, **LANES)
    sharded = fit_fleet(fleet, mesh=_mesh(4, ("batch", "series")), **LANES)
    np.testing.assert_allclose(sharded.deviance[:5].numpy(),
                               base.deviance[:5].numpy(), rtol=1e-6)
    np.testing.assert_allclose(sharded.params[:5].numpy(),
                               base.params[:5].numpy(), rtol=1e-4,
                               atol=1e-6)
    assert torch.equal(sharded.iterations, base.iterations)
    assert torch.equal(sharded.converged, base.converged)


def test_mesh_must_divide_the_fleet():
    small = _fleet(sizes=(4, 3, 4), t=16, pad_batch_to=None)
    for layout in ("batch", "lanes"):
        with pytest.raises(ValueError, match=r"mesh size 8 must divide the "
                           r"fleet batch 3; pad with pack_fleet\(\.\.\., "
                           r"pad_batch_to=pad_to_multiple\(3, 8\)\)"):
            fit_fleet(small, layout=layout, maxiter=2, mesh=_mesh())


def test_lanes_ignore_use_shard_map_with_a_warning(caplog):
    small = _fleet(sizes=(4, 3), t=16, pad_batch_to=None)
    with caplog.at_level(logging.WARNING):
        got = fit_fleet(small, layout="lanes", maxiter=3,
                        use_shard_map=True)
    assert "use_shard_map is ignored" in caplog.text
    want = fit_fleet(small, layout="lanes", maxiter=3)
    assert torch.equal(got.params, want.params)


def test_lane_min_batch_changes_nothing():
    """``lane_min_batch`` is accepted for the JAX signature: the JAX
    package pads a tiny lanes fleet to a TPU lane tile by replicating
    models, which changes no result; the port's lanes run at any width,
    so the option leaves the fit as it is, with and without a mesh."""
    small = _fleet(sizes=(4, 3), t=24, pad_batch_to=None)
    for mesh in (None, _mesh(2)):
        base = fit_fleet(small, layout="lanes", maxiter=15, mesh=mesh)
        got = fit_fleet(small, layout="lanes", maxiter=15, lane_min_batch=8,
                        mesh=mesh)
        assert got.params.shape == (2, small.n_params)
        for name in ("params", "deviance", "iterations", "converged"):
            assert torch.equal(getattr(got, name), getattr(base, name)), name
