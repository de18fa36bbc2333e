"""Port parity of the sharded arena service on the square-root engine
with steady-state serving and on the sequential engine with the censored
robust likelihood: ``ModelRegistry(arena=True, arena_mesh=8)`` of the
port against the JAX package's, as ``tests/test_torch_serve_arena_mesh.py``
holds the joint engine.
"""

import pytest
import torch
from test_torch_serve_arena_mesh import check_sharded

pytestmark = pytest.mark.shard

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["sqrt_steady", "sequential_robust"])
def test_sharded_arena_service_matches_jax(case, monkeypatch):
    check_sharded(case, monkeypatch)
