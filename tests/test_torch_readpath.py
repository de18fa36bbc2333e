"""The port's materialized read path (``serve/readpath.py``), case by case
after ``tests/test_readpath.py``, on the CPU in f64 (the plain versions
of the ``horizons`` modes of K16, K17 and K14, and of K2).

1. **bit-identity** — a cached read equals the port's compute path at
   the same version: bit for bit at f64 on the arena and the dict
   registries (the dict square-root engine to a few ulps: the fused pass
   forms ``fac fac'`` in torch, the compute path reads the host's
   ``chol chol'``), 2e-5 at f32; frozen rows within 1e-8 of the exact
   twin (``tests/test_steady.py:393``);
2. **parity** — the port's cached moments equal the JAX service's cached
   moments on the same states (``PosteriorState.from_jax_state``) to
   1e-12, and the arena's equal the dict registry's;
3. **invalidation** — a commit republishes exactly the written model; an
   external ``registry.put`` marks the entry stale and the read falls
   through, also to a lower version;
4. **concurrency** — reads racing a writer are never torn, never newer
   than the highest version the writer may have committed, and never
   older than an acknowledged one (the invariant; the JAX test's own
   reference differs from its cached variances in the last bits);
5. **fallthrough** — misses and stale reads compute, hits dispatch
   nothing, bypass the breaker, and are read-only views.
"""

import threading
import time

import numpy as np
import pytest
import torch

from metran_tpu.ops import dfm_statespace, kalman_filter
from metran_tpu.serve import MetranService as JaxService
from metran_tpu.serve import ModelRegistry as JaxRegistry
from metran_tpu_torch import kernels
from metran_tpu_torch.reliability import CircuitOpenError
from metran_tpu_torch.serve import (
    GateSpec,
    MetranService,
    ModelRegistry,
    PosteriorState,
    SnapshotStore,
    SteadySpec,
    parse_horizons,
)
from metran_tpu_torch.serve.readpath import contiguous_prefix

torch.set_num_threads(1)

N = 5


def _jax_states(rng, n_models=4, n=N, kf=1, t=60, dtype=np.float64,
                converged=False):
    """The JAX test's fitted states (its ``_make_states``); ``converged``:
    a fully observed 220-step history with short memories, whose
    covariance has settled (``tests/test_steady.py``'s states)."""
    states = []
    if converged:
        t = 220
    for i in range(n_models):
        loadings = (rng.uniform(0.3, 0.8, (n, kf)) / np.sqrt(kf)).astype(
            dtype)
        a_s = rng.uniform(*((3.0, 12.0) if converged else (5.0, 40.0)),
                          n).astype(dtype)
        a_c = rng.uniform(*((5.0, 20.0) if converged else (10.0, 60.0)),
                          kf).astype(dtype)
        ss = dfm_statespace(a_s, a_c, loadings, 1.0)
        y = rng.normal(size=(t, n))
        mask = rng.uniform(size=(t, n)) > (-1.0 if converged else 0.3)
        y = np.where(mask, y, 0.0)
        res = kalman_filter(ss, y.astype(dtype), mask, engine="joint")
        from metran_tpu.serve import PosteriorState as JaxState

        states.append(JaxState(
            model_id=f"m{i}", version=0, t_seen=t,
            mean=np.asarray(res.mean_f[-1], dtype),
            cov=np.asarray(res.cov_f[-1], dtype),
            params=np.concatenate([a_s, a_c]),
            loadings=loadings, dt=1.0,
            scaler_mean=rng.normal(size=n).astype(dtype),
            scaler_std=rng.uniform(0.5, 2.0, n).astype(dtype),
            names=tuple(f"s{j}" for j in range(n)),
        ))
    return states


def _make_states(rng, **kw):
    return [PosteriorState.from_jax_state(st) for st in _jax_states(rng, **kw)]


def _service(states, readpath, horizons="1-5", engine="joint", gate=None,
             arena=False, steady=None):
    reg = ModelRegistry(root=None, engine=engine, arena=arena, arena_rows=16,
                        device="cpu")
    for st in states:
        reg.put(st, persist=False)
    svc = MetranService(reg, flush_deadline=None, persist_updates=False,
                        gate=gate, readpath=readpath, horizons=horizons,
                        steady=steady, device="cpu")
    return reg, svc


def _update_all(svc, n_models, obs):
    futs = [svc.update_async(f"m{i}", obs[i]) for i in range(n_models)]
    svc.flush()
    return [f.result() for f in futs]


def _forecast_compute(svc, model_id, steps):
    """A forecast through the dispatch path, past any cache."""
    fut = svc._forecast_async_compute(model_id, steps)
    svc.flush()
    return fut.result()


# ----------------------------------------------------------------------
# horizon-spec parsing
# ----------------------------------------------------------------------
def test_parse_horizons_and_prefix():
    assert parse_horizons("1,7,30") == (1, 7, 30)
    assert parse_horizons("1-5") == (1, 2, 3, 4, 5)
    assert parse_horizons("1-3,7, 30") == (1, 2, 3, 7, 30)
    assert parse_horizons((3, 1, 2, 2)) == (1, 2, 3)
    assert parse_horizons("") == ()
    assert parse_horizons(None) == ()
    assert contiguous_prefix((1, 2, 3, 7)) == 3
    assert contiguous_prefix((1, 7, 30)) == 1
    assert contiguous_prefix((2, 3)) == 0
    with pytest.raises(ValueError):
        parse_horizons("0-3")
    with pytest.raises(ValueError):
        SnapshotStore(())


# ----------------------------------------------------------------------
# 1. cached read == compute path at matching version
# ----------------------------------------------------------------------
@pytest.mark.parametrize("engine,policy,arena,dtype", [
    ("joint", "off", False, np.float64),
    ("joint", "off", True, np.float64),
    ("joint", "reject", True, np.float64),
    ("sequential", "reject", False, np.float64),
    ("sqrt", "off", True, np.float64),
    ("sqrt", "reject", True, np.float64),
    ("sqrt", "reject", False, np.float64),
    ("sqrt", "reject", True, np.float32),
])
def test_cached_reads_match_compute_path(rng, engine, policy, arena, dtype):
    """A snapshot hit equals what the dispatch path computes from the same
    posterior version: bit for bit at f64 (the dict square-root engine to
    a few ulps, see the module doc), 2e-5 at f32."""
    n_models, steps = 4, 5
    states = _make_states(rng, n_models=n_models, dtype=dtype)
    gate = (None if policy == "off"
            else GateSpec(policy=policy, nsigma=4.0, min_seen=10))
    obs = rng.normal(size=(n_models, 2, N))
    obs[1, 0, 2] = 30.0  # an armed gate trips
    _, svc_c = _service(states, True, engine=engine, gate=gate, arena=arena)
    _, svc_p = _service(states, False, engine=engine, gate=gate, arena=arena)
    _update_all(svc_c, n_models, obs)
    _update_all(svc_p, n_models, obs)
    h0 = svc_c.readpath.hits
    for i in range(n_models):
        cached = svc_c.forecast(f"m{i}", steps)
        computed = _forecast_compute(svc_p, f"m{i}", steps)
        assert cached.version == computed.version == 1
        assert cached.names == computed.names
        if dtype == np.float64:
            assert np.array_equal(cached.means, computed.means)
            if engine == "sqrt" and not arena:
                np.testing.assert_allclose(cached.variances,
                                           computed.variances, rtol=1e-13,
                                           atol=1e-15)
            else:
                assert np.array_equal(cached.variances, computed.variances)
        else:
            np.testing.assert_allclose(cached.means, computed.means,
                                       rtol=2e-5, atol=1e-6)
            np.testing.assert_allclose(cached.variances, computed.variances,
                                       rtol=2e-5, atol=1e-6)
    assert svc_c.readpath.hits - h0 == n_models
    svc_c.close()
    svc_p.close()


def test_cached_prefix_rows_match_longer_compute(rng):
    """steps beyond the horizon prefix miss and compute; the compute
    result's leading rows equal the cached rows."""
    states = _make_states(rng)
    _, svc = _service(states, True, horizons="1-5", arena=True)
    _update_all(svc, 4, rng.normal(size=(4, 1, N)))
    cached = svc.forecast("m0", 5)
    m0 = svc.readpath.misses
    longer = svc.forecast("m0", 9)  # 9 > prefix 5: compute path
    assert svc.readpath.misses == m0 + 1
    assert longer.version == cached.version
    assert np.array_equal(longer.means[:5], cached.means)
    assert np.array_equal(longer.variances[:5], cached.variances)
    svc.close()


@pytest.mark.parametrize("arena", [False, True])
def test_non_contiguous_horizons_serve_their_prefix(rng, arena):
    """{1, 7, 30} serves steps=1 from the cache (bit for bit the compute
    path) and computes steps=2; the entry holds the three horizons."""
    states = _make_states(rng)
    _, svc = _service(states, True, horizons="1,7,30", arena=arena)
    _update_all(svc, 4, rng.normal(size=(4, 1, N)))
    entry = svc.readpath.read("m1", 1)
    assert entry.means.shape == (3, N)
    one = svc.forecast("m1", 1)
    ref = _forecast_compute(svc, "m1", 30)
    assert np.array_equal(one.means, ref.means[:1])
    assert np.array_equal(entry.means, ref.means[[0, 6, 29]])
    assert np.array_equal(entry.variances, ref.variances[[0, 6, 29]])
    m0 = svc.readpath.misses
    svc.forecast("m1", 2)
    assert svc.readpath.misses == m0 + 1
    svc.close()


# ----------------------------------------------------------------------
# 2. parity: the JAX service's cached moments; arena == dict
# ----------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["joint", "sqrt"])
def test_cached_moments_match_the_jax_service(rng, engine):
    """The same states (carried across with ``from_jax_state``) and
    observations through the JAX service and the port's, both with the
    read path armed: the cached moments agree to 1e-12, and the port's
    arena registry serves what its dict registry serves."""
    jstates = _jax_states(rng)
    obs = rng.normal(size=(4, 2, N))
    jreg = JaxRegistry(root=None, engine=engine)
    for st in jstates:
        jreg.put(st, persist=False)
    jsvc = JaxService(jreg, flush_deadline=None, persist_updates=False,
                      readpath=True, horizons="1-6")
    _update_all(jsvc, 4, obs)
    pstates = [PosteriorState.from_jax_state(st) for st in jstates]
    cached = {}
    for arena in (False, True):
        _, psvc = _service(pstates, True, horizons="1-6", engine=engine,
                           arena=arena)
        _update_all(psvc, 4, obs)
        cached[arena] = [psvc.forecast(f"m{i}", 6) for i in range(4)]
        psvc.close()
    for i in range(4):
        want = jsvc.forecast(f"m{i}", 6)
        got = cached[True][i]
        assert got.version == want.version == 1
        np.testing.assert_allclose(got.means, want.means, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(got.variances, want.variances,
                                   rtol=1e-12, atol=1e-12)
        dict_hit = cached[False][i]
        assert np.array_equal(got.means, dict_hit.means)
        if engine == "sqrt":  # the dict pass forms fac fac' in another
            np.testing.assert_allclose(got.variances, dict_hit.variances,
                                       rtol=1e-13, atol=1e-15)
        else:
            assert np.array_equal(got.variances, dict_hit.variances)
    jsvc.close()


# ----------------------------------------------------------------------
# 3. invalidation
# ----------------------------------------------------------------------
def test_commit_invalidates_exactly_the_written_model(rng):
    states = _make_states(rng)
    _, svc = _service(states, True, arena=True)
    _update_all(svc, 4, rng.normal(size=(4, 1, N)))
    before = {i: svc.forecast(f"m{i}", 3) for i in range(4)}
    assert all(f.version == 1 for f in before.values())
    fut = svc.update_async("m1", rng.normal(size=(1, N)))
    svc.flush()
    fut.result()
    h0, s0 = svc.readpath.hits, svc.readpath.stale
    after = {i: svc.forecast(f"m{i}", 3) for i in range(4)}
    assert after[1].version == 2
    assert not np.array_equal(after[1].means, before[1].means)
    for i in (0, 2, 3):
        assert after[i].version == 1
        assert np.array_equal(after[i].means, before[i].means)
    assert svc.readpath.hits - h0 == 4 and svc.readpath.stale == s0
    svc.close()


@pytest.mark.parametrize("arena", [False, True])
def test_external_put_marks_entry_stale_and_read_falls_through(rng, arena):
    """A ``registry.put`` from outside the service carries no snapshot:
    the commit hook marks the entry stale and the next read computes from
    the new state — also when the put lowers the version."""
    states = _make_states(rng)
    reg, svc = _service(states, True, arena=arena)
    _update_all(svc, 4, rng.normal(size=(4, 1, N)))
    assert svc.forecast("m2", 3).version == 1
    reg.put(reg.get("m2")._replace(version=7), persist=False)
    s0 = svc.readpath.stale
    fresh = svc.forecast("m2", 3)
    assert svc.readpath.stale == s0 + 1
    assert fresh.version == 7
    assert np.array_equal(fresh.means, _forecast_compute(svc, "m2", 3).means)
    reg.put(states[2], persist=False)  # version 0, the pre-update state
    s1 = svc.readpath.stale
    back = svc.forecast("m2", 3)
    assert svc.readpath.stale == s1 + 1 and back.version == 0
    fut = svc.update_async("m2", rng.normal(size=(1, N)))
    svc.flush()
    fut.result()
    again = svc.forecast("m2", 3)  # republished: a fresh hit at v1
    assert again.version == 1
    assert np.array_equal(again.means,
                          _forecast_compute(svc, "m2", 3).means)
    svc.close()
    # close() detaches the store: later puts no longer reach it
    n_hooks = len(reg._commit_hooks)
    reg.put(states[1], persist=False)
    assert n_hooks == 0 and svc.readpath._latest["m1"] == 1


# ----------------------------------------------------------------------
# 4. snapshot reads under concurrent writes
# ----------------------------------------------------------------------
def test_concurrent_reads_never_torn_or_newer_than_committed(rng):
    """Readers hammer one model while a writer commits: every read's
    moments are the exact per-version moments (never torn), its version
    never exceeds the highest the writer may have committed, and a read
    started after an ack sees at least that version (read-your-writes)."""
    n_versions, steps = 12, 3
    states = _make_states(rng, n_models=2)
    obs_seq = [rng.normal(size=(1, N)) for _ in range(n_versions)]
    # per-version references from a cache-less shadow service fed the
    # same observations (the port's compute path: bit for bit the cache)
    _, shadow = _service(states, False, arena=True)
    expected = {}
    for v, obs in enumerate(obs_seq, start=1):
        fut = shadow.update_async("m0", obs)
        shadow.flush()
        fut.result()
        expected[v] = _forecast_compute(shadow, "m0", steps)
    shadow.close()

    _, svc = _service(states, True, arena=True)
    fut = svc.update_async("m0", obs_seq[0])
    svc.flush()
    fut.result()
    base = svc.forecast("m0", steps)
    assert np.array_equal(base.means, expected[1].means)
    assert np.array_equal(base.variances, expected[1].variances)
    allowed_max = [1]  # bumped BEFORE each submit
    acked = [1]  # bumped AFTER each ack
    failures: list = []
    reads = [0]
    done = threading.Event()

    def writer():
        try:
            for v, obs in enumerate(obs_seq[1:], start=2):
                allowed_max[0] = v
                f = svc.update_async("m0", obs)
                svc.flush()
                f.result()
                acked[0] = v
        except Exception as exc:  # pragma: no cover - fails the test
            failures.append(f"writer: {exc!r}")
        finally:
            done.set()

    def reader():
        while not done.is_set() and not failures:
            time.sleep(1e-4)  # let the writer's dispatch have the GIL
            lo = acked[0]
            f = svc.forecast("m0", steps)
            hi = allowed_max[0]
            reads[0] += 1
            if not lo <= f.version <= hi:
                failures.append(f"version {f.version} outside [{lo}, {hi}]")
                return
            ref = expected[f.version]
            if not (np.array_equal(f.means, ref.means)
                    and np.array_equal(f.variances, ref.variances)):
                failures.append(f"torn read at version {f.version}")
                return

    threads = [threading.Thread(target=reader) for _ in range(2)]
    wt = threading.Thread(target=writer)
    for t in threads:
        t.start()
    wt.start()
    wt.join(30)
    for t in threads:
        t.join(30)
    assert not failures, failures[:3]
    assert reads[0] > 0
    final = svc.forecast("m0", steps)
    assert final.version == n_versions
    assert np.array_equal(final.means, expected[n_versions].means)
    assert np.array_equal(final.variances, expected[n_versions].variances)
    svc.close()


# ----------------------------------------------------------------------
# 5. service semantics around the cache
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arena", [False, True])
def test_forecast_batch_serves_hits_and_computes_misses(rng, arena):
    states = _make_states(rng, n_models=6)
    _, svc = _service(states, True, arena=arena)
    futs = [svc.update_async(f"m{i}", rng.normal(size=(1, N)))
            for i in range(3)]
    svc.flush()
    [f.result() for f in futs]
    h0, m0 = svc.readpath.hits, svc.readpath.misses
    out = svc.forecast_batch([f"m{i}" for i in range(6)], 4)
    assert svc.readpath.hits - h0 == 3
    assert svc.readpath.misses - m0 == 3
    for i, fc in enumerate(out):
        assert fc.version == (1 if i < 3 else 0)
        ref = _forecast_compute(svc, f"m{i}", 4)
        assert np.array_equal(fc.means, ref.means)
        assert np.array_equal(fc.variances, ref.variances)
    svc.close()


def test_warm_forecast_batch_launches_nothing(rng):
    """A fully warm fleet tick is answered from host memory: the launch
    counters (plain paths count none, so the forecast functions are
    spied on) see no forecast call."""
    states = _make_states(rng)
    reg, svc = _service(states, True, arena=True)
    _update_all(svc, 4, rng.normal(size=(4, 1, N)))
    calls = []
    real = reg.arena_forecast_fn
    reg.arena_forecast_fn = lambda *a: calls.append(a) or real(*a)
    before = kernels.launches()
    out = svc.forecast_batch([f"m{i}" for i in range(4)], 5)
    assert all(fc.version == 1 for fc in out)
    assert calls == [] and kernels.launches() == before
    svc.close()


def test_async_hit_short_circuits_the_breaker(rng):
    """A cached hit resolves at once and still serves while the model's
    breaker is open (the breaker protects compute)."""
    states = _make_states(rng)
    _, svc = _service(states, True, arena=True)
    _update_all(svc, 4, rng.normal(size=(4, 1, N)))
    fut = svc.forecast_async("m0", 3)
    assert fut.done() and fut.result().version == 1
    assert "m0" not in svc.breakers.open_models()
    breaker = svc.breakers.get("m0")
    for _ in range(svc.reliability.breaker_failures + 1):
        breaker.record_failure()
    with pytest.raises(CircuitOpenError):
        svc.forecast("m0", 99)  # beyond the prefix: compute, refused
    assert svc.forecast("m0", 3).version == 1
    svc.close()


class _Gauges:
    """A metrics registry with the JAX package's ``gauge`` signature."""

    def __init__(self):
        self.gauges = {}

    def gauge(self, name, help, callback=None):  # noqa: A002 - its name
        self.gauges[name] = callback


def test_metrics_views_and_health(rng):
    states = _make_states(rng)
    _, svc = _service(states, True, arena=True)
    _update_all(svc, 4, rng.normal(size=(4, 1, N)))
    metrics = _Gauges()
    svc.readpath.bind_metrics(metrics)
    hit = svc.forecast("m0", 3)
    # served views are read-only: writing through one would corrupt
    # every later read of this version
    with pytest.raises(ValueError):
        hit.means[0, 0] = 1.0
    svc.forecast("m0", 99)  # miss (beyond the prefix)
    g = {k: cb() for k, cb in metrics.gauges.items()}
    assert g["metran_serve_forecast_cache_hits_total"] == 1.0
    assert g["metran_serve_forecast_cache_misses_total"] == 1.0
    assert g["metran_serve_forecast_cache_stale_total"] == 0.0
    assert g["metran_serve_forecast_snapshot_entries"] == 4.0
    assert g["metran_serve_forecast_snapshot_age_seconds"] >= 0.0
    assert svc.health()["readpath"]["entries"] == 4
    assert svc.readpath.stats()["publishes"] == 1
    svc.close()


def test_readpath_off_has_no_store_and_identical_results(rng):
    states = _make_states(rng)
    obs = rng.normal(size=(4, 1, N))
    reg, svc = _service(states, False, arena=False)
    assert svc.readpath is None and reg._commit_hooks == []
    acks = _update_all(svc, 4, obs)
    assert all(a.version == 1 for a in acks)
    assert "readpath" not in svc.health()
    _, svc_on = _service(states, True, arena=False)
    on = _update_all(svc_on, 4, obs)
    for a, b in zip(acks, on):
        assert np.array_equal(a.mean, b.mean) and np.array_equal(a.cov, b.cov)
    svc.close()
    svc_on.close()


# ----------------------------------------------------------------------
# frozen rows (tests/test_steady.py:393)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arena", [False, True])
def test_steady_readpath_snapshots_match_compute(rng, arena):
    """Frozen models' cached forecasts (the means of each commit, the
    variances frozen at freeze) agree with the exact service's
    compute-path forecasts to 1e-8, and a frozen commit's means equal the
    compute path's on its own posterior bit for bit."""
    states = _make_states(rng, n_models=3, converged=True)
    _, svc_s = _service(states, True, horizons="1-6", arena=arena,
                        steady=SteadySpec(tol=1e-9, min_seen=1))
    _, svc_e = _service(states, False, arena=arena)
    ids = [st.model_id for st in states]
    stream = rng.normal(size=(4, 3, 1, N)) * 0.3
    for t in range(4):
        if arena:
            svc_s.update_batch(ids, stream[t])
            svc_e.update_batch(ids, stream[t])
        else:
            _update_all(svc_s, 3, stream[t])
            _update_all(svc_e, 3, stream[t])
    assert svc_s._steady_count() == 3
    hits_before = svc_s.readpath.hits
    for mid in ids:
        fs = svc_s.forecast(mid, 6)  # a hit
        fe = svc_e.forecast(mid, 6)  # the exact twin's compute path
        assert fs.version == fe.version
        assert float(np.max(np.abs(fs.means - fe.means))) < 1e-8
        assert float(np.max(np.abs(fs.variances - fe.variances))) < 1e-8
        own = _forecast_compute(svc_s, mid, 6)
        assert np.array_equal(fs.means, own.means)
    assert svc_s.readpath.hits == hits_before + len(ids)
    svc_s.close()
    svc_e.close()
