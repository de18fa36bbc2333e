"""The sharded state arena (``ModelRegistry(arena=True, arena_mesh=n)``,
``StateArena(mesh=...)``) on a virtual mesh of 8 CPU devices.

Mirrors ``tests/test_arena.py``'s sharding section on the port: rows
spread over the shards (a small ``arena_rows`` so 8 models touch several
shards), every dispatch launches its kernel once per shard it touches,
and the posteriors, covariances, versions, ``t_seen`` and forecasts are
bit for bit the unsharded arena's (``arena_mesh=0``), per request and in
bulk, with the gate, detection, steady serving and the read path armed;
eviction, spill and a warm restart from disk work on the sharded arena;
a failed launch marks it lost; concurrent readers and writers on a
background-flush service see no error.
"""

import threading

import numpy as np
import pytest
from test_torch_arena import _make_states, _run_traffic

from metran_tpu_torch import kernels
from metran_tpu_torch.serve import (
    ArenaLostError,
    ArenaUpdateAck,
    DetectSpec,
    GateSpec,
    MetranService,
    ModelRegistry,
    SteadySpec,
)

pytestmark = pytest.mark.shard

N_MODELS = 8


@pytest.fixture(autouse=True)
def virtual8(monkeypatch):
    monkeypatch.setenv("METRAN_TPU_VIRTUAL_DEVICES", "8")


def _service(states, mesh, engine="joint", rows=15, root=None, **kw):
    reg = ModelRegistry(root=root, arena=True, arena_rows=rows,
                        arena_mesh=mesh, engine=engine, device="cpu")
    for st in states:
        reg.put(st, persist=root is not None)
    return reg, MetranService(reg, flush_deadline=None,
                              persist_updates=root is not None,
                              device="cpu", **kw)


def _same(reg_a, reg_b, fc_a, fc_b, n=N_MODELS):
    for i in range(n):
        a, b = reg_a.get(f"m{i}"), reg_b.get(f"m{i}")
        assert np.array_equal(a.mean, b.mean), i
        assert np.array_equal(a.cov, b.cov), i
        assert a.version == b.version and a.t_seen == b.t_seen, i
        assert np.array_equal(fc_a[i].means, fc_b[i].means), i
        assert np.array_equal(fc_a[i].variances, fc_b[i].variances), i
        assert fc_a[i].version == fc_b[i].version, i


@pytest.mark.parametrize("engine", ["joint", "sqrt"])
def test_sharded_arena_matches_unsharded_bit_for_bit(rng, engine):
    states = _make_states(rng, n_models=N_MODELS)
    rounds = [rng.normal(size=(N_MODELS, 2, 5)) for _ in range(2)]
    reg_1, svc_1 = _service(states, 0, engine)
    _, fc_1 = _run_traffic(svc_1, N_MODELS, rounds)
    reg_8, svc_8 = _service(states, 8, engine)
    kernels.reset_launches()
    acks, fc_8 = _run_traffic(svc_8, N_MODELS, rounds)
    assert all(isinstance(a, ArenaUpdateAck) for a in acks)
    arena = next(iter(reg_8._arenas.values()))
    assert len(arena.devices) == 8 and arena.capacity == 16
    assert arena.shard_rows == 2
    touched = {reg_8._row_map[f"m{i}"][1] // 2 for i in range(N_MODELS)}
    assert len(touched) == 4  # the models span four shards
    _same(reg_1, reg_8, fc_1, fc_8)
    # bulk ticks: the same rows, one launch per touched shard
    ids = [f"m{i}" for i in range(N_MODELS)]
    assert svc_1.update_batch(ids, list(rounds[0])) == \
        svc_8.update_batch(ids, list(rounds[0]))
    _same(reg_1, reg_8, svc_1.forecast_batch(ids, 7),
          svc_8.forecast_batch(ids, 7))
    svc_1.close()
    svc_8.close()


def test_sharded_arena_with_every_defence_armed(rng):
    """The gate, detection, steady serving and the read path armed: the
    detect, steady and horizons variants of the in-place update merge
    their outputs across shards as the unsharded arena's."""
    states = _make_states(rng, n_models=N_MODELS)
    obs = rng.normal(size=(N_MODELS, 1, 5))
    obs[2, 0, 1] = 40.0  # a spike the gate rejects
    kw = dict(gate=GateSpec(policy="reject", nsigma=4.0, min_seen=10),
              detect=DetectSpec(enabled=True, min_seen=1),
              steady=SteadySpec(tol=1e-3, min_seen=1), readpath=True,
              horizons="1-5")
    runs = []
    for mesh in (0, 8):
        reg, svc = _service(states, mesh, **kw)
        acks = []
        for t in range(6):
            futs = [svc.update_async(f"m{i}", obs[i] * (1 + 0.1 * t))
                    for i in range(N_MODELS)]
            svc.flush()
            acks.append([f.result() for f in futs])
        fcs = [svc.forecast(f"m{i}", 5) for i in range(N_MODELS)]
        runs.append((reg, svc, acks, fcs))
    (reg_1, svc_1, acks_1, fc_1), (reg_8, svc_8, acks_8, fc_8) = runs
    assert acks_1 == acks_8
    _same(reg_1, reg_8, fc_1, fc_8)
    assert svc_1.gate_verdicts.snapshot() == svc_8.gate_verdicts.snapshot()
    assert svc_1.anomalies() == svc_8.anomalies()
    assert svc_1.health()["steady"] == svc_8.health()["steady"]
    for svc in (svc_1, svc_8):
        svc.close()


def test_sharded_arena_evicts_spills_and_warm_restarts(rng, tmp_path):
    """Seven usable rows on eight shards for twelve models: eviction and
    reload go through every shard, and ``close()`` spills the sharded
    rows so a fresh sharded registry warm-starts bit for bit."""
    states = _make_states(rng, n_models=12)
    obs = rng.normal(size=(12, 1, 5))
    runs = []
    for mesh, root in ((0, tmp_path / "one"), (8, tmp_path / "eight")):
        reg, svc = _service(states, mesh, rows=7, root=root)
        for i in range(12):
            assert isinstance(svc.update(f"m{i}", obs[i]), ArenaUpdateAck)
        runs.append((reg, svc, root))
    (reg_1, svc_1, _), (reg_8, svc_8, root_8) = runs
    assert reg_8.arena_stats["rows_resident"] <= 7
    for i in range(12):
        a, b = reg_1.get(f"m{i}"), reg_8.get(f"m{i}")
        assert np.array_equal(a.mean, b.mean) and a.version == b.version
    svc_8.close()
    svc_1.close()
    fresh = ModelRegistry(root=root_8, arena=True, arena_rows=7,
                          arena_mesh=8, device="cpu")
    for i in range(12):
        back, want = fresh.get(f"m{i}"), reg_1.get(f"m{i}")
        assert back.version == want.version == 1
        assert np.array_equal(back.mean, want.mean)
        assert np.array_equal(back.cov, want.cov)


def test_failed_launch_marks_the_sharded_arena_lost(rng):
    states = _make_states(rng, n_models=N_MODELS)
    reg, svc = _service(states, 8)
    svc.update("m0", rng.normal(size=(1, 5)))
    arena = next(iter(reg._arenas.values()))

    def boom(*args):
        raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        arena.apply(boom, np.arange(4, dtype=np.int32))
    assert arena.lost
    with pytest.raises(ArenaLostError):
        arena.read_row(0)
    # the registry rebuilds the arena from last-good states on next touch
    ack = svc.update("m1", rng.normal(size=(1, 5)))
    assert isinstance(ack, ArenaUpdateAck)
    svc.close()


@pytest.mark.parametrize("mesh", [0, 8])
def test_concurrent_reads_and_writes_on_the_sharded_arena(rng, mesh):
    """Two readers and a writer on a background-flush service over the
    sharded arena: every call answers, every read's version is one the
    writer committed."""
    states = _make_states(rng, n_models=N_MODELS)
    reg, svc = _service(states, mesh)
    svc.close()
    svc = MetranService(reg, flush_deadline=0.001, persist_updates=False,
                        device="cpu")
    obs = rng.normal(size=(1, 5))
    errors, versions = [], []

    def writer(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(20):
                svc.update(f"m{r.integers(N_MODELS)}", obs, deadline=30.0)
        except Exception as exc:  # pragma: no cover - the regression
            errors.append(exc)

    def reader(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(30):
                fc = svc.forecast(f"m{r.integers(N_MODELS)}", 5,
                                  deadline=30.0)
                versions.append(fc.version)
                assert np.isfinite(fc.means).all()
        except Exception as exc:  # pragma: no cover - the regression
            errors.append(exc)

    threads = [threading.Thread(target=writer, args=(1,)),
               threading.Thread(target=reader, args=(2,)),
               threading.Thread(target=reader, args=(3,))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    svc.close()
    assert not errors, f"concurrent access failed: {errors!r}"
    assert len(versions) == 60 and max(versions) <= 20
    assert sum(reg.get(f"m{i}").version for i in range(N_MODELS)) == 20
