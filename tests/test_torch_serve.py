"""Port parity: ``metran_tpu_torch.serve`` against the JAX
``metran_tpu.serve`` on the CPU, f64.

The fleet is the JAX package's own serving fixture
(``metran_tpu.cluster._testing.make_states``), carried into the port
with ``PosteriorState.from_jax_state``; both services then run the same
request script.  Versions and ``t_seen`` must be equal; posteriors and
forecasts agree to ``rtol=1e-10`` (``atol=1e-12`` for covariance entries
that are zero in exact arithmetic) — the kernels' plain versions and
the JAX scan differ only by Cholesky/solve roundoff.
"""

import numpy as np
import pytest
import torch

from metran_tpu.cluster._testing import make_states
from metran_tpu.serve import MetranService as JaxService
from metran_tpu.serve import ModelRegistry as JaxRegistry
from metran_tpu.serve import PosteriorState as JaxState
from metran_tpu.serve import engine as jeng
from metran_tpu.serve import state as jstate
from metran_tpu_torch.reliability import (
    DeadlineExceededError,
    StateIntegrityError,
)
from metran_tpu_torch.serve import MetranService, ModelRegistry
from metran_tpu_torch.serve import PosteriorState
from metran_tpu_torch.serve import engine as peng
from metran_tpu_torch.serve import state as pstate

TOL = dict(rtol=1e-10, atol=1e-12)


def _assert_states_identical(a, b):
    for field in a._fields:
        va, vb = getattr(a, field), getattr(b, field)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if va is None or vb is None:
                assert va is None and vb is None, field
                continue
            assert va.dtype == vb.dtype and va.shape == vb.shape, field
            assert va.tobytes() == vb.tobytes(), field
        else:
            assert va == vb, field


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("with_chol", [False, True])
def test_npz_round_trip_both_ways(tmp_path, dtype, with_chol):
    st = make_states(n_models=1, dtype=dtype)[0]
    if with_chol:
        st = st._replace(chol=np.linalg.cholesky(
            st.cov + 1e-3 * np.eye(st.n_state, dtype=dtype)
        ).astype(dtype))
    # JAX writes, the port reads
    st.save(tmp_path / "jax.npz")
    got = PosteriorState.load(tmp_path / "jax.npz")
    _assert_states_identical(st, got)
    # the port writes, JAX reads
    got.save(tmp_path / "port.npz")
    back = JaxState.load(tmp_path / "port.npz")
    _assert_states_identical(st, back)
    # both writers embed the same checksum of the same payload
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert int(a["checksum"]) == int(b["checksum"])
        payload = {k: a[k] for k in a.files
                   if k not in ("format_version", "checksum")}
        assert pstate._content_checksum(payload) == \
            jstate._content_checksum(payload)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_state_statespace_parity(dtype):
    st = make_states(n_models=1, n=5, kf=2, dtype=dtype)[0]
    want = st.statespace()
    got = PosteriorState.from_jax_state(st).statespace(device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6
                                   if dtype == np.float32 else 1e-15)


def test_corrupt_file_raises_state_integrity_error(tmp_path):
    st = PosteriorState.from_jax_state(make_states(n_models=1)[0])
    path = st.save(tmp_path / "m.npz")
    raw = bytearray(path.read_bytes())
    with np.load(path) as data:
        mean_bytes = np.asarray(data["mean"]).tobytes()
    pos = bytes(raw).find(mean_bytes)
    raw[pos] ^= 0xFF  # flip one stored byte of the mean
    path.write_bytes(bytes(raw))
    with pytest.raises(StateIntegrityError):
        PosteriorState.load(path)
    (tmp_path / "trunc.npz").write_bytes(bytes(raw[:40]))
    with pytest.raises(StateIntegrityError):
        PosteriorState.load(tmp_path / "trunc.npz")


def test_stack_bucket_pad_and_slot_index_parity():
    states = make_states(n_models=3, n=5, kf=2)
    bucket = (8, 16)
    want = jeng.stack_bucket(states, bucket)
    got = peng.stack_bucket(
        [PosteriorState.from_jax_state(s) for s in states], bucket,
        device="cpu",
    )
    for g, w in zip(got.ss, want.ss):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15)
    np.testing.assert_array_equal(got.mean.numpy(), np.asarray(want.mean))
    np.testing.assert_array_equal(got.cov.numpy(), np.asarray(want.cov))
    for st in states:
        jp = jeng.pad_state_arrays(st, bucket)
        pp = peng.pad_state_arrays(PosteriorState.from_jax_state(st), bucket)
        for a, b in zip(pp, (jp[0], jp[1], jp[2], jp[3], jp[4])):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(peng.state_slot_index(5, 2, 8),
                                  jeng.state_slot_index(5, 2, 8))
    with pytest.raises(ValueError, match="does not fit"):
        peng.pad_state_arrays(PosteriorState.from_jax_state(states[0]),
                              (4, 8))


def test_posterior_fault_parity():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(4, 4))
    good = a @ a.T
    asym = good.copy()
    asym[0, 1] += 1.0
    nonpsd = good - 50.0 * np.eye(4)
    nan_cov = good.copy()
    nan_cov[2, 2] = np.nan
    mean = rng.normal(size=4)
    bad_mean = mean.copy()
    bad_mean[1] = np.inf
    cases = [(mean, good), (mean, asym), (mean, nonpsd), (mean, nan_cov),
             (bad_mean, good)]
    for m, c in cases:
        assert peng.posterior_fault(m, c) == jeng.posterior_fault(m, c)
    chol = np.linalg.cholesky(good)
    assert peng.posterior_fault(mean, good, chol=chol) is None
    assert peng.posterior_fault(mean, good, chol=chol * np.nan) == \
        jeng.posterior_fault(mean, good, chol=chol * np.nan)


def test_registry_buckets_and_persistence(tmp_path):
    states = make_states(n_models=2, n=5, kf=1)
    jreg = JaxRegistry(root=None)
    preg = ModelRegistry(root=tmp_path)
    for st in states:
        assert preg.bucket_of(PosteriorState.from_jax_state(st)) == \
            jreg.bucket_of(st)
        preg.put(PosteriorState.from_jax_state(st))
    fresh = ModelRegistry(root=tmp_path)
    assert fresh.model_ids() == ["m0", "m1"]
    _assert_states_identical(fresh.get("m1"), states[1])
    # the JAX registry reads the port's directory
    _assert_states_identical(JaxRegistry(root=tmp_path).get("m0"), states[0])
    assert "m0" in fresh and "nope" not in fresh
    with pytest.raises(KeyError):
        fresh.get("nope")
    assert fresh.integrity_stats == {}


def _services(n_models=4):
    states = make_states(n_models=n_models)
    jreg, preg = JaxRegistry(root=None), ModelRegistry(root=None)
    for st in states:
        jreg.put(st, persist=False)
        preg.put(PosteriorState.from_jax_state(st), persist=False)
    jsvc = JaxService(jreg, flush_deadline=None, persist_updates=False)
    psvc = MetranService(preg, flush_deadline=None, persist_updates=False,
                         device="cpu")
    return states, jsvc, psvc


def _script(svc, ids, seed):
    rng = np.random.default_rng(seed)
    n = 5
    out = []
    for steps in (1, 14):
        futs = [svc.forecast_async(m, steps) for m in ids]
        svc.flush()
        out += [f.result() for f in futs]
    for _ in range(3):
        futs = []
        for m in ids:
            obs = rng.normal(size=(2, n))
            obs[rng.uniform(size=obs.shape) < 0.25] = np.nan
            futs.append(svc.update_async(m, obs))
        # a second update to one model inside the same flush (same k:
        # one batcher group, two dispatch rounds) ...
        futs.append(svc.update_async(ids[0], rng.normal(size=(2, n))))
        # ... and a third with another k (deferred behind the others)
        futs.append(svc.update_async(ids[0], rng.normal(size=(1, n))))
        svc.flush()
        out += [f.result() for f in futs]
    out.append(svc.update(ids[1], rng.normal(size=(1, n))))
    out.append(svc.forecast(ids[1], 14))
    out += svc.update_batch(ids, rng.normal(size=(len(ids), 1, n)))
    out += svc.forecast_batch(ids, 14)
    return out


def test_slice_end_to_end_matches_jax_service():
    states, jsvc, psvc = _services()
    ids = [st.model_id for st in states]
    want = _script(jsvc, ids, seed=5)
    got = _script(psvc, ids, seed=5)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert not isinstance(g, BaseException), g
        assert type(g).__name__ == type(w).__name__
        assert g.version == w.version
        if hasattr(w, "cov"):
            assert g.t_seen == w.t_seen and g.model_id == w.model_id
            assert g.mean.dtype == w.mean.dtype
            np.testing.assert_allclose(g.mean, w.mean, **TOL)
            np.testing.assert_allclose(g.cov, w.cov, **TOL)
        else:
            assert g.names == w.names
            np.testing.assert_allclose(g.means, w.means, **TOL)
            np.testing.assert_allclose(g.variances, w.variances, **TOL)
    # 3 rounds x 3 updates + 1 sync + 1 batch for m0 ... the versions
    # agree model by model with the JAX registry
    for m in ids:
        j, p = jsvc.registry.get(m), psvc.registry.get(m)
        assert (p.version, p.t_seen) == (j.version, j.t_seen)
    assert psvc.registry.get(ids[0]).version == 10
    assert psvc.stats.get("masked_values", 0) > 0
    jsvc.close()
    psvc.close()


def test_poisoned_state_fails_alone_in_both():
    states, jsvc, psvc = _services()
    ids = [st.model_id for st in states]
    bad = states[2]
    poisoned = bad._replace(mean=np.full_like(bad.mean, np.nan))
    jsvc.registry.put(poisoned, persist=False)
    psvc.registry.put(PosteriorState.from_jax_state(poisoned),
                      persist=False)
    rng = np.random.default_rng(8)
    obs = rng.normal(size=(4, 1, 5))
    for svc in (jsvc, psvc):
        futs = [svc.update_async(m, obs[i]) for i, m in enumerate(ids)]
        svc.flush()
        for i, f in enumerate(futs):
            if i == 2:
                assert isinstance(f.exception(), Exception)
                assert type(f.exception()).__name__ == "StateIntegrityError"
            else:
                assert f.result().version == 1
    assert psvc.registry.get(ids[2]).version == 0
    assert psvc.stats["poisoned_updates"] == 1
    with pytest.raises(StateIntegrityError):
        psvc.forecast(ids[2], 3)
    for m in (ids[0], ids[1], ids[3]):
        np.testing.assert_allclose(psvc.registry.get(m).mean,
                                   jsvc.registry.get(m).mean, **TOL)
    jsvc.close()
    psvc.close()


def test_submit_validation_raises():
    _, _, psvc = _services(n_models=1)
    with pytest.raises(ValueError, match="series"):
        psvc.update_async("m0", np.zeros((1, 4)))
    with pytest.raises(ValueError, match="infinite"):
        psvc.update_async("m0", np.array([[0.0, np.inf, 0.0, 0.0, 0.0]]))
    with pytest.raises(ValueError, match="steps"):
        psvc.forecast_async("m0", 0)
    with pytest.raises(KeyError):
        psvc.forecast_async("missing", 3)
    with pytest.raises(ValueError, match="distinct"):
        psvc.update_batch(["m0", "m0"], np.zeros((2, 1, 5)))
    assert psvc.stats["validation_errors"] == 3
    assert psvc.registry.get("m0").version == 0
    psvc.close()


def test_update_in_background_flush_mode_and_deadline():
    states = make_states(n_models=2)
    reg = ModelRegistry(root=None)
    for st in states:
        reg.put(PosteriorState.from_jax_state(st), persist=False)
    with MetranService(reg, flush_deadline=0.001, device="cpu") as svc:
        st = svc.update("m0", np.zeros((1, 5)))
        assert st.version == 1 and st.t_seen == states[0].t_seen + 1
        fc = svc.forecast("m1", 2)
        assert fc.means.shape == (2, 5) and fc.version == 0
    assert reg.get("m0").version == 1


def test_sync_call_past_its_deadline_is_cancelled_unapplied():
    _, _, psvc = _services(n_models=1)
    with pytest.raises(DeadlineExceededError) as info:
        psvc.update("m0", np.zeros((1, 5)), deadline=0.0)
    assert info.value.in_flight is False
    psvc.flush()
    assert psvc.registry.get("m0").version == 0
    assert psvc.stats["deadline_exceeded"] == 1
    psvc.close()
