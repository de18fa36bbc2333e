"""The port's device-resident state arena on the CPU (the plain versions
of K16, K17 and K18 behind ``ModelRegistry(arena=True)``).

Mirrors ``tests/test_arena.py`` on ``metran_tpu_torch.serve``:

1. **round-trip** — pack -> arena -> evict -> reload is bit-identical;
   ``close()`` spills dirty rows and a fresh registry warm-starts from
   them; ``get`` materializes the current row;
2. **path equivalence** — the arena serves the posteriors, forecasts and
   gate telemetry the dict registry serves (joint, sequential and
   square-root engines, gate off and ``"reject"``), f64 at rtol 1e-12 /
   atol 1e-13 and one f32 case at 2e-5 / 1e-6 (the JAX test's bars); the
   bulk API equals the per-request path;
3. **reliability semantics** — a poisoned row fails alone with its row
   unchanged, quarantine round-trips, LRU eviction keeps every model
   serviceable, an oversized bulk tick cannot corrupt rows, and a
   repeated row in one launch raises;
4. **fixed lag** — ``smoothed()`` on an arena registry equals the dict
   registry's.

The fleet is built with the JAX package's filter (as its own test builds
it) and carried into the port with ``PosteriorState.from_jax_state``.
"""

import numpy as np
import pytest
import torch

from metran_tpu.ops import dfm_statespace, kalman_filter
from metran_tpu_torch.kernels import arena as karena
from metran_tpu_torch.reliability import StateIntegrityError
from metran_tpu_torch.serve import (
    ArenaUpdateAck,
    GateSpec,
    MetranService,
    ModelRegistry,
    PosteriorState,
)


def _make_states(rng, n_models=8, n=5, kf=1, t=80, dtype=np.float64,
                 poison=None):
    """Heterogeneous-but-one-bucket states frozen from real filters."""
    states = []
    for i in range(n_models):
        loadings = (rng.uniform(0.3, 0.8, (n, kf)) / np.sqrt(kf)).astype(
            dtype)
        a_s = rng.uniform(5.0, 40.0, n).astype(dtype)
        a_c = rng.uniform(10.0, 60.0, kf).astype(dtype)
        ss = dfm_statespace(a_s, a_c, loadings, 1.0)
        y = rng.normal(size=(t, n))
        mask = rng.uniform(size=(t, n)) > 0.3
        y = np.where(mask, y, 0.0)
        res = kalman_filter(ss, y.astype(dtype), mask, engine="joint")
        mean = np.asarray(res.mean_f[-1], dtype)
        if poison == i:
            mean = np.full_like(mean, np.nan)
        states.append(PosteriorState(
            model_id=f"m{i}", version=0, t_seen=t, mean=mean,
            cov=np.asarray(res.cov_f[-1], dtype),
            params=np.concatenate([a_s, a_c]), loadings=loadings, dt=1.0,
            scaler_mean=rng.normal(size=n).astype(dtype),
            scaler_std=rng.uniform(0.5, 2.0, n).astype(dtype),
            names=tuple(f"s{j}" for j in range(n)),
        ))
    return states


def _service(states, arena, engine="joint", gate=None, rows=32, root=None,
             persist=False):
    reg = ModelRegistry(root=root, arena=arena, arena_rows=rows,
                        arena_mesh=0, engine=engine, device="cpu")
    for st in states:
        reg.put(st, persist=persist and root is not None)
    svc = MetranService(reg, flush_deadline=None, persist_updates=persist,
                        gate=gate, device="cpu")
    return reg, svc


def _collect(futs):
    out = []
    for f in futs:
        try:
            out.append(f.result())
        except Exception as exc:  # per-slot failures ride the results
            out.append(exc)
    return out


def _run_traffic(svc, n_models, obs_rounds, steps=7):
    """A few update rounds and one forecast round, manual-flush mode."""
    for obs in obs_rounds:
        futs = [svc.update_async(f"m{i}", obs[i]) for i in range(n_models)]
        svc.flush()
        results = _collect(futs)
    futs = [svc.forecast_async(f"m{i}", steps) for i in range(n_models)]
    svc.flush()
    return results, _collect(futs)


# ----------------------------------------------------------------------
# 1. round-trip
# ----------------------------------------------------------------------
def test_arena_pack_evict_reload_bit_identical(rng, tmp_path):
    states = _make_states(rng, n_models=4)
    reg = ModelRegistry(root=tmp_path, arena=True, arena_rows=8,
                        arena_mesh=0, device="cpu")
    for st in states:
        reg.put(st)
    for st in states:
        reg.ensure_resident(st.model_id)
    assert reg.arena_stats["rows_resident"] == 4
    for st in states:
        assert reg.evict(st.model_id) is not None
    assert reg.arena_stats["rows_resident"] == 0
    for st in states:
        back = reg.get(st.model_id)
        assert back.version == st.version and back.t_seen == st.t_seen
        for field in ("mean", "cov", "params", "loadings", "scaler_mean"):
            assert np.array_equal(getattr(back, field), getattr(st, field))
        assert back.names == st.names


def test_arena_spill_on_close_warm_starts_from_disk(rng, tmp_path):
    states = _make_states(rng, n_models=4)
    reg, svc = _service(states, arena=True, root=tmp_path, persist=True)
    acks, _ = _run_traffic(svc, 4, [rng.normal(size=(4, 2, 5))])
    assert all(isinstance(a, ArenaUpdateAck) and a.version == 1
               for a in acks)
    before = [reg.get(f"m{i}") for i in range(4)]
    svc.close()  # spills the dirty rows
    assert svc.health()["arena"]["spills"] == 4
    reg2 = ModelRegistry(root=tmp_path, arena=True, arena_rows=8,
                         device="cpu")
    for i in range(4):
        back = reg2.get(f"m{i}")
        assert back.version == 1 and back.t_seen == before[i].t_seen
        assert np.array_equal(back.mean, before[i].mean)
        assert np.array_equal(back.cov, before[i].cov)


def test_arena_get_materializes_current_row(rng):
    states = _make_states(rng, n_models=2)
    reg, svc = _service(states, arena=True)
    ack = svc.update("m0", rng.normal(size=(3, 5)), deadline=30.0)
    st = reg.get("m0")
    assert isinstance(ack, ArenaUpdateAck)
    assert st.version == ack.version == 1
    assert st.t_seen == ack.t_seen == states[0].t_seen + 3
    assert not np.array_equal(st.mean, states[0].mean)
    svc.close()


# ----------------------------------------------------------------------
# 2. arena path == dict path
# ----------------------------------------------------------------------
@pytest.mark.parametrize("engine,policy,dtype", [
    ("joint", "off", np.float64),
    ("sequential", "off", np.float64),
    ("sqrt", "off", np.float64),
    ("joint", "reject", np.float64),
    ("sequential", "reject", np.float64),
    ("sqrt", "reject", np.float64),
    ("sqrt", "reject", np.float32),
])
def test_arena_path_matches_dict_path(rng, engine, policy, dtype):
    """Same kernels' plain versions, different residency; spiky rows make
    an armed gate trip, so the gated outputs and the verdict booking are
    compared under fire."""
    n_models, n = 6, 5
    f64 = dtype == np.float64
    states = _make_states(rng, n_models=n_models, n=n, dtype=dtype)
    gate = (None if policy == "off"
            else GateSpec(policy=policy, nsigma=4.0, min_seen=10))
    obs_rounds = [rng.normal(size=(n_models, 1, n)),
                  rng.normal(size=(n_models, 2, n))]
    obs_rounds[1][2, 0, 1] = 40.0  # a spike the gate must flag
    obs_rounds[1][4, 1, 3] = np.nan  # and a missing cell
    reg_d, svc_d = _service(states, arena=False, engine=engine, gate=gate)
    acks_d, fc_d = _run_traffic(svc_d, n_models, obs_rounds)
    reg_a, svc_a = _service(states, arena=True, engine=engine, gate=gate)
    acks_a, fc_a = _run_traffic(svc_a, n_models, obs_rounds)
    tol = dict(rtol=1e-12, atol=1e-13) if f64 else dict(rtol=2e-5, atol=1e-6)
    for i in range(n_models):
        sd, sa = reg_d.get(f"m{i}"), reg_a.get(f"m{i}")
        assert sa.version == sd.version == 2
        assert sa.t_seen == sd.t_seen
        np.testing.assert_allclose(sa.mean, sd.mean, **tol)
        np.testing.assert_allclose(sa.cov, sd.cov, **tol)
        np.testing.assert_allclose(fc_a[i].means, fc_d[i].means, **tol)
        np.testing.assert_allclose(fc_a[i].variances, fc_d[i].variances,
                                   **tol)
        assert fc_a[i].version == fc_d[i].version
    assert svc_a.gate_verdicts.snapshot() == svc_d.gate_verdicts.snapshot()
    if gate is not None:
        assert svc_a.gate_verdicts.snapshot().get("rejected", 0) >= 1
    assert all(isinstance(a, ArenaUpdateAck) for a in acks_a)
    assert [(a.version, a.t_seen) for a in acks_a] == [
        (s.version, s.t_seen) for s in acks_d]
    svc_d.close()
    svc_a.close()


@pytest.mark.parametrize("engine,policy", [("joint", "off"),
                                           ("sqrt", "reject")])
def test_bulk_fleet_api_matches_per_request_path(rng, engine, policy):
    """``update_batch``/``forecast_batch`` give the per-request path's
    posteriors, forecasts and gate telemetry, a poisoned model failing
    alone on both; duplicate ids in one tick are refused."""
    n_models, n = 6, 5
    states = _make_states(rng, n_models=n_models, poison=4)
    gate = (None if policy == "off"
            else GateSpec(policy=policy, nsigma=4.0, min_seen=10))
    obs = rng.normal(size=(n_models, 2, n))
    obs[1, 0, 2] = 30.0
    ids = [f"m{i}" for i in range(n_models)]
    reg_req, svc_req = _service(states, arena=True, engine=engine,
                                gate=gate)
    acks_req, fc_req = _run_traffic(svc_req, n_models, [obs])
    reg_blk, svc_blk = _service(states, arena=True, engine=engine,
                                gate=gate)
    acks_blk = svc_blk.update_batch(ids, list(obs))
    fc_blk = svc_blk.forecast_batch(ids, 7)
    for i in range(n_models):
        if i == 4:
            assert isinstance(acks_blk[i], StateIntegrityError)
            assert isinstance(acks_req[i], StateIntegrityError)
            continue
        assert acks_blk[i] == acks_req[i]
        sd, sb = reg_req.get(ids[i]), reg_blk.get(ids[i])
        np.testing.assert_allclose(sb.mean, sd.mean, rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(sb.cov, sd.cov, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(fc_blk[i].means, fc_req[i].means,
                                   rtol=1e-12, atol=1e-12)
        assert fc_blk[i].version == fc_req[i].version
    assert svc_blk.gate_verdicts.snapshot() == \
        svc_req.gate_verdicts.snapshot()
    assert svc_blk.stats["poisoned_updates"] == 1
    with pytest.raises(ValueError):
        svc_blk.update_batch(["m0", "m0"], [obs[0], obs[1]])
    svc_req.close()
    svc_blk.close()


# ----------------------------------------------------------------------
# 3. reliability semantics
# ----------------------------------------------------------------------
def test_poisoned_row_fails_alone_in_arena_batch(rng):
    n_models = 8
    states = _make_states(rng, n_models=n_models, poison=3)
    reg, svc = _service(states, arena=True)
    obs = rng.normal(size=(1, 5))
    futs = [svc.update_async(f"m{i}", obs) for i in range(n_models)]
    svc.flush()
    for i, f in enumerate(futs):
        if i == 3:
            with pytest.raises(StateIntegrityError):
                f.result()
        else:
            assert f.result().version == 1
    bad = reg.get("m3")
    assert bad.version == 0 and np.isnan(bad.mean).all()
    assert np.array_equal(bad.cov, states[3].cov)
    assert svc.stats["poisoned_updates"] == 1
    svc.close()


def test_arena_lru_eviction_keeps_models_serviceable(rng):
    n_models = 8
    states = _make_states(rng, n_models=n_models)
    obs = rng.normal(size=(1, 5))
    reg_d, svc_d = _service(states, arena=False)
    reg_a, svc_a = _service(states, arena=True, rows=4)
    for svc in (svc_d, svc_a):
        for i in range(n_models):  # one by one: forces row churn
            svc.update(f"m{i}", obs, deadline=30.0)
    stats = reg_a.arena_stats
    assert stats["rows_resident"] == 4
    assert stats["evictions"] >= 4
    for i in range(n_models):
        sd, sa = reg_d.get(f"m{i}"), reg_a.get(f"m{i}")
        assert sa.version == sd.version == 1
        np.testing.assert_allclose(sa.mean, sd.mean, rtol=1e-12, atol=1e-13)
    svc_d.close()
    svc_a.close()


def test_arena_quarantines_corrupt_file_and_recovers(rng, tmp_path):
    states = _make_states(rng, n_models=3)
    reg = ModelRegistry(root=tmp_path, arena=True, arena_rows=8,
                        device="cpu")
    for st in states:
        reg.put(st)
    reg._states.clear()  # residency must come from the disk load path
    (tmp_path / "m1.npz").write_bytes(b"not an npz at all")
    svc = MetranService(reg, flush_deadline=None, device="cpu")
    with pytest.raises(StateIntegrityError):
        svc.update_async("m1", rng.normal(size=(1, 5)))
    futs = [svc.update_async(f"m{i}", rng.normal(size=(1, 5)))
            for i in (0, 2)]
    svc.flush()
    assert all(f.result().version == 1 for f in futs)
    assert (tmp_path / ".quarantine" / "m1.npz").exists()
    assert reg.integrity_stats["quarantined"] == 1
    reg.put(states[1])  # heal
    assert svc.update("m1", rng.normal(size=(1, 5)),
                      deadline=30.0).version == 1
    svc.close()


def test_bulk_batch_larger_than_arena_cannot_corrupt_rows(rng):
    """One bulk tick bigger than the arena: resolved rows are pinned, so
    the overflow models fail their own slots and every committed model
    carries exactly the per-model path's posterior."""
    n_models = 8
    states = _make_states(rng, n_models=n_models)
    obs = rng.normal(size=(1, 5))
    ids = [f"m{i}" for i in range(n_models)]
    reg, svc = _service(states, arena=True, rows=4)
    out = svc.update_batch(ids, [obs] * n_models)
    ok = [r for r in out if not isinstance(r, BaseException)]
    failed = [r for r in out if isinstance(r, BaseException)]
    assert len(ok) == 4 and len(failed) == 4
    assert all("pinned" in str(e) or "full" in str(e) for e in failed)
    reg_d, svc_d = _service(states, arena=False)
    for r in ok:
        svc_d.update(r.model_id, obs, deadline=30.0)
        sa, sd = reg.get(r.model_id), reg_d.get(r.model_id)
        assert sa.version == 1
        np.testing.assert_allclose(sa.mean, sd.mean, rtol=1e-12, atol=1e-13)
    for i, r in enumerate(out):
        if isinstance(r, BaseException):
            st = reg.get(ids[i])
            assert st.version == 0
            assert np.array_equal(st.mean, states[i].mean)
    svc.close()
    svc_d.close()


def test_repeated_rows_in_one_launch_raise(rng):
    """Two blocks writing one row would race: every arena wrapper refuses
    a repeated row before touching a leaf."""
    states = _make_states(rng, n_models=3)
    reg = ModelRegistry(arena=True, arena_rows=4, device="cpu")
    for st in states:
        reg.put(st, persist=False)
        reg.ensure_resident(st.model_id)
    arena = reg.arena_of(reg.bucket_of(states[0]))
    leaves = arena._dynamic() + arena._static()
    before = [t.clone() for t in leaves]
    y = np.zeros((2, 1, 8))
    mask = np.ones((2, 1, 8), bool)
    with pytest.raises(ValueError, match="distinct"):
        karena.arena_update(*leaves, [1, 1], y, mask)
    with pytest.raises(ValueError, match="distinct"):
        karena.arena_steady_update(
            leaves[0], leaves[2], leaves[3], leaves[4], leaves[6],
            *arena._steady_leaves(), [0, 0], np.ones((2, 8), bool), y, mask)
    with pytest.raises(ValueError, match="distinct"):
        karena.arena_forecast(leaves[0], leaves[1], *arena._static(),
                              [2, 2], torch.ones(1, dtype=torch.float64))
    for a, b in zip(leaves, before):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("engine", ["joint", "sqrt"])
def test_fixed_lag_smoothing_on_an_arena_registry(rng, engine):
    """``smoothed()`` on an arena registry (the tracker re-anchors from
    the row ``registry.get`` reads back) equals the dict registry's."""
    states = _make_states(rng, n_models=3)
    rows = rng.normal(size=(6, 3, 1, 5))
    windows = []
    for arena in (False, True):
        reg = ModelRegistry(engine=engine, arena=arena, arena_rows=4,
                            device="cpu")
        for st in states:
            reg.put(st, persist=False)
        svc = MetranService(reg, flush_deadline=None, persist_updates=False,
                            fixed_lag=4, device="cpu")
        for obs in rows:
            futs = [svc.update_async(f"m{i}", obs[i]) for i in range(3)]
            svc.flush()
            assert all(f.result().version >= 1 for f in futs)
        windows.append(svc.smoothed("m1"))
        svc.close()
    d, a = windows
    for field in d._fields:
        got, want = getattr(a, field), getattr(d, field)
        if isinstance(want, np.ndarray):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
        else:
            assert got == want
