"""The port's device mesh (``metran_tpu_torch.parallel.mesh``) against
``metran_tpu.parallel.mesh`` on the CPU.

``make_mesh`` builds the JAX package's shapes, 1-D and 2-D (the minor
axis from ``_largest_minor_factor``), over a virtual mesh of CPU devices
(``METRAN_TPU_VIRTUAL_DEVICES``, the counterpart of the 8 virtual XLA
devices ``conftest.py`` gives JAX); the shardings split and gather a
tensor exactly; ``pad_to_multiple`` is the JAX rule.
"""

import jax
import numpy as np
import pytest
import torch

from metran_tpu.parallel import mesh as jmesh
from metran_tpu_torch import parallel as ppar
from metran_tpu_torch.config import mesh_devices
from metran_tpu_torch.parallel import mesh as pmesh

pytestmark = pytest.mark.shard


@pytest.fixture()
def cpu8(monkeypatch):
    monkeypatch.setenv("METRAN_TPU_VIRTUAL_DEVICES", "8")
    return mesh_devices("cpu")


def test_mesh_devices_repeat_the_cpu(monkeypatch):
    assert mesh_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setenv("METRAN_TPU_VIRTUAL_DEVICES", "3")
    assert mesh_devices("cpu") == [torch.device("cpu")] * 3
    monkeypatch.setenv("METRAN_TPU_VIRTUAL_DEVICES", "0")
    with pytest.raises(ValueError, match="VIRTUAL_DEVICES"):
        mesh_devices("cpu")


@pytest.mark.parametrize("axes", [("batch",), ("batch", "series")])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_make_mesh_shapes_match_jax(cpu8, axes, n):
    want = jmesh.make_mesh(n, axes, devices=jax.devices()[:8])
    got = pmesh.make_mesh(n, axes, devices=cpu8)
    assert got.devices.shape == want.devices.shape
    assert got.shape == dict(want.shape)
    assert got.size == want.size
    assert got.axis_names == tuple(want.axis_names)
    assert all(d == torch.device("cpu") for d in got.flat_devices())


def test_largest_minor_factor_is_the_jax_rule():
    for n in range(1, 65):
        assert pmesh._largest_minor_factor(n) == jmesh._largest_minor_factor(n)


def test_make_mesh_refuses_what_it_cannot_build(cpu8):
    with pytest.raises(ValueError, match="VIRTUAL_DEVICES"):
        pmesh.make_mesh(9, devices=cpu8)
    with pytest.raises(ValueError, match="1D or 2D"):
        pmesh.make_mesh(8, ("a", "b", "c"), devices=cpu8)
    with pytest.raises(KeyError, match="seq"):
        pmesh.make_mesh(4, devices=cpu8).axis_devices("seq")


def test_make_mesh_defaults_to_the_card(monkeypatch):
    """Like every entry point, ``make_mesh`` takes the card unless asked
    for other devices: without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        pmesh.make_mesh()
    assert pmesh.make_mesh(devices=mesh_devices("cpu")).size == 1


def test_shardings_split_and_gather_exactly(cpu8):
    mesh = pmesh.make_mesh(8, ("batch", "series"), devices=cpu8)
    x = torch.arange(8 * 3 * 5, dtype=torch.float64).reshape(8, 3, 5)
    sh = ppar.batch_sharding(mesh, 3)
    parts = sh.split(x)
    assert len(parts) == mesh.shape["batch"] == 4
    assert all(p.shape == (2, 3, 5) for p in parts)
    assert torch.equal(sh.gather(parts), x)
    last = pmesh.batch_sharding(mesh, 3, axis="series", dim=2)
    with pytest.raises(ValueError, match="divisible"):
        last.split(x)
    with pytest.raises(ValueError, match="3-D"):
        sh.split(x[0])
    rep = ppar.replicated(mesh)
    copies = rep.split(x)
    assert len(copies) == 8 and all(torch.equal(c, x) for c in copies)
    assert torch.equal(rep.gather(copies), x)


def test_pad_to_multiple_is_the_jax_rule():
    for n in range(0, 40):
        for m in (1, 3, 8):
            assert pmesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)
    assert ppar.pad_to_multiple is pmesh.pad_to_multiple
    assert ppar.BATCH_AXIS == jmesh.BATCH_AXIS
