"""Port parity of the sharded arena service: a port ``MetranService`` over
``ModelRegistry(arena=True, arena_mesh=8)`` on a virtual mesh of 8 CPU
devices against the JAX ``MetranService`` over its own
``ModelRegistry(arena=True, arena_mesh=8)`` on the 8 virtual XLA CPU
devices that ``tests/conftest.py`` sets up, on the same models and
stream as ``tests/test_torch_serve_arena.py`` and at its bars (equal acks
and failures, posteriors and forecasts to 1e-10 relative, equal booked
outcomes).  Seven rows (eight with the scratch row) put one row on each
shard, so the five models touch five shards.  The joint engine with the
gate and detection here; the square-root and sequential engines in
``tests/test_torch_serve_arena_mesh_engines.py``.  Bit for bit against
``arena_mesh=0``: ``tests/test_torch_arena_mesh.py``.
"""

import pytest
import torch
from test_torch_serve_arena import _services, check_service

pytestmark = pytest.mark.shard

torch.set_num_threads(1)


def check_sharded(case, monkeypatch):
    """The port's and the JAX package's sharded arena services on one
    stream, with every model on a shard of its own."""
    monkeypatch.setenv("METRAN_TPU_VIRTUAL_DEVICES", "8")
    states, jsvc, psvc = _services(case, mesh=8, rows=7)
    reg = psvc.registry
    check_service(states, jsvc, psvc, case)
    arena = next(iter(reg._arenas.values()))
    assert len(arena.devices) == 8 and arena.shard_rows == 1
    assert len({reg._row_map[st.model_id][1] for st in states}) == 5


def test_sharded_arena_service_matches_jax(monkeypatch):
    check_sharded("joint_gate_detect", monkeypatch)
