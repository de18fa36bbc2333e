"""Port parity: steady-state (frozen-gain) serving — a steady-armed port
``MetranService(steady=SteadySpec(...), device="cpu")`` against its
exact twin and against the JAX steady service, on the same converged
states and the same stream (CPU: the plain versions of K14, K15 and the
exact updates).

Bars (the JAX package's own, ``tests/test_steady.py``): freeze
tolerance ``_TOL`` and frozen-vs-exact mean deviation ``_DEV_BOUND`` per
dtype over 12 k = 1 appends, on the joint, sequential and square-root
registries, gated and ungated; after a thaw the replayed update matches
the exact twin to 1e-8; against the JAX service the freeze and thaw
transitions are equal round by round and the means agree to 1e-10
(relative, f64).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import metran_tpu.ops as jops
from metran_tpu.obs import Observability
from metran_tpu.serve import GateSpec as JaxGate
from metran_tpu.serve import MetranService as JaxService
from metran_tpu.serve import ModelRegistry as JaxRegistry
from metran_tpu.serve import PosteriorState as JaxState
from metran_tpu.serve import SteadySpec as JaxSteady
from metran_tpu.serve.engine import DetectSpec as JaxDetect
from metran_tpu.serve.engine import make_steady_update_fn as jax_steady_fn
from metran_tpu_torch.serve import (
    DetectSpec,
    GateSpec,
    MetranService,
    ModelRegistry,
    PosteriorState,
    RobustSpec,
    SteadySpec,
    make_steady_update_fn,
    stack_bucket,
)
from metran_tpu_torch.serve import service as service_mod

torch.set_num_threads(1)

N, K = 4, 1
#: the JAX test's frozen-vs-exact deviation bounds and freeze tolerances
_DEV_BOUND = {np.float64: 1e-8, np.float32: 2e-3}
_TOL = {np.float64: 1e-9, np.float32: 1e-4}


@functools.lru_cache(maxsize=2)
def _jax_states(n_models=4, t_hist=220, seed=7):
    """Converged serving states (the JAX test's recipe): a fully
    observed 220-step history through the JAX joint filter."""
    rng = np.random.default_rng(seed)
    a_s = rng.uniform(3.0, 12.0, (n_models, N))
    a_c = rng.uniform(5.0, 20.0, (n_models, K))
    lds = rng.uniform(0.3, 0.8, (n_models, N, K))
    y = rng.normal(size=(n_models, t_hist, N))

    def one(s, c, ld, yy):
        res = jops.kalman_filter(jops.dfm_statespace(s, c, ld, 1.0), yy,
                                 jnp.ones(yy.shape, bool), engine="joint",
                                 store=False)
        return res.mean_f, res.cov_f

    means, covs = jax.jit(jax.vmap(one))(a_s, a_c, lds, y)
    return tuple(dict(
        model_id=f"m{i}", version=0, t_seen=t_hist,
        mean=np.asarray(means[i]), cov=np.asarray(covs[i]),
        params=np.concatenate([a_s[i], a_c[i]]), loadings=lds[i], dt=1.0,
        scaler_mean=np.zeros(N), scaler_std=np.ones(N),
        names=tuple(f"s{j}" for j in range(N))) for i in range(n_models))


def _states(cls, n_models, dtype=np.float64):
    out = []
    for d in _jax_states()[:n_models]:
        d = dict(d, mean=d["mean"].astype(dtype), cov=d["cov"].astype(dtype))
        out.append(cls(**d))
    return out


def _service(states, tol, engine="joint", gate=None, **kw):
    reg = ModelRegistry(root=None, engine=engine)
    for st in states:
        reg.put(st, persist=False)
    return MetranService(
        reg, flush_deadline=None, persist_updates=False,
        gate=gate if gate is not None else GateSpec(policy="off"),
        steady=SteadySpec(tol=tol, min_seen=1), device="cpu", **kw)


def _jax_service(states, tol, engine="joint", gate=None):
    reg = JaxRegistry(root=None, engine=engine)
    for st in states:
        reg.put(st, persist=False)
    return JaxService(
        reg, flush_deadline=None, persist_updates=False,
        observability=Observability.disabled(),
        gate=gate if gate is not None else JaxGate(policy="off"),
        steady=JaxSteady(tol=tol, min_seen=1))


def _mean(svc, mid):
    return np.asarray(svc.registry.get(mid).mean, float)


GATE = dict(policy="reject", nsigma=4.0, min_seen=1)


def _row(svc, mid, rng, scale=0.3):
    """A gate-clean row: the model's own one-step forecast plus noise at
    ``scale`` of its predictive sd (a converged model's innovations are
    tight, so raw noise could legitimately trip a 4-sigma gate)."""
    f = svc.forecast(mid, 1)
    return f.means + scale * np.sqrt(f.variances) * rng.normal(
        size=f.means.shape)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("engine", ["joint", "sequential", "sqrt"])
def test_frozen_matches_exact_within_tolerance(engine, gated, dtype):
    """A steady-armed service and an exact twin consume the same stream:
    every model freezes, serves through the frozen gain and stays within
    the JAX test's deviation bound; forecasts from the frozen posterior
    (K2 on the stored covariance) agree to the same order."""
    n_models = 4
    states = _states(PosteriorState, n_models, dtype)
    gate = GateSpec(**GATE) if gated else None
    svc_s = _service(states, _TOL[dtype], engine, gate)
    svc_e = _service(states, 0.0, engine, gate)
    rng = np.random.default_rng(7)
    ids = [st.model_id for st in states]
    for _ in range(12):
        for mid in ids:
            row = _row(svc_e, mid, rng)
            a, b = svc_s.update(mid, row), svc_e.update(mid, row)
            assert a.version == b.version
    assert svc_s._steady_count() == n_models
    assert svc_e._steady_count() == 0
    trans = svc_s.steady_transitions.snapshot()
    assert trans.get("freeze") == n_models and "thaw" not in trans
    bound = _DEV_BOUND[dtype]
    for mid in ids:
        dev = float(np.abs(_mean(svc_s, mid) - _mean(svc_e, mid)).max())
        assert dev <= bound, (mid, dev, bound)
        # a frozen commit keeps the stored covariance (and factor)
        st = svc_s.registry.get(mid)
        assert st.cov.dtype == np.dtype(dtype)
        fs, fe = svc_s.forecast(mid, 5), svc_e.forecast(mid, 5)
        assert float(np.abs(fs.means - fe.means).max()) <= 10 * bound
    # the frozen gate form follows the registry: per slot on gated
    # covariance engines, marginal otherwise
    info = svc_s._steady_info[ids[0]]
    seq = gated and engine != "sqrt"
    n_pad = svc_s.registry.bucket_of(states[0])[0]
    g = jops.steady_gains(jops.dfm_statespace(
        states[0].params[:N], states[0].params[N:], states[0].loadings,
        1.0))
    want = np.asarray(g.fdiag_seq if seq else g.fdiag)
    assert np.allclose(info.fdiag[:N], want, rtol=1e-5 if dtype ==
                       np.float32 else 1e-12)
    assert np.array_equal(info.fdiag[N:], np.ones(n_pad - N))
    svc_s.close()
    svc_e.close()


def _frozen_pair(seed, gate=None, engine="joint", **kw):
    states = _states(PosteriorState, 2)
    svc_s = _service(states, 1e-9, engine, gate, **kw)
    svc_e = _service(states, 0.0, engine, gate)
    rng = np.random.default_rng(seed)
    for _ in range(2):
        row = _row(svc_e, "m0", rng, scale=0.0)
        svc_s.update("m0", row)
        svc_e.update("m0", row)
    assert svc_s._steady_count() >= 1
    return svc_s, svc_e, row


def test_thaw_on_nan_masked_slot():
    """A missing cell breaks time-invariance: the model thaws, the row
    replays through the exact update in the same dispatch, and the
    result is the exact twin's."""
    svc_s, svc_e, row = _frozen_pair(11)
    bad = row.copy()
    bad[0, 2] = np.nan
    a, b = svc_s.update("m0", bad), svc_e.update("m0", bad)
    assert a.version == b.version
    assert svc_s.steady_transitions.snapshot().get("thaw") == 1
    assert "m0" not in svc_s._steady_info
    assert float(np.abs(_mean(svc_s, "m0") - _mean(svc_e, "m0")).max()) \
        <= 1e-8
    # the thawed commit carries the exact update's covariance (from the
    # frozen one, which the twin's moved by at most the freeze tolerance)
    assert float(np.abs(svc_s.registry.get("m0").cov
                        - svc_e.registry.get("m0").cov).max()) <= 1e-8


@pytest.mark.parametrize("engine", ["sequential", "sqrt"])
def test_thaw_on_gate_fire(engine):
    """A tripped reject gate thaws the frozen model; the spike is
    handled by the exact gated update — the twin's verdicts and
    posterior."""
    svc_s, svc_e, row = _frozen_pair(13, gate=GateSpec(**GATE),
                                     engine=engine)
    spike = row.copy()
    spike[0, 1] += 80.0
    svc_s.update("m0", spike)
    svc_e.update("m0", spike)
    assert svc_s._steady_count() == 0
    assert svc_s.steady_transitions.snapshot().get("thaw") == 1
    assert svc_s.gate_verdicts.snapshot() == svc_e.gate_verdicts.snapshot()
    assert svc_s.gate_verdicts.snapshot().get("rejected") == 1
    assert float(np.abs(_mean(svc_s, "m0") - _mean(svc_e, "m0")).max()) \
        <= 1e-8


def test_huber_hit_stays_frozen():
    """``huber`` only reweights the innovation, which the frozen gain
    absorbs: a hit is booked and the model stays frozen."""
    svc_s, _, row = _frozen_pair(15, gate=GateSpec(policy="huber",
                                                   nsigma=4.0, min_seen=1))
    spike = row.copy()
    spike[0, 1] += 80.0
    svc_s.update("m0", spike)
    assert svc_s._steady_count() >= 1
    assert "thaw" not in svc_s.steady_transitions.snapshot()
    assert svc_s.gate_verdicts.snapshot().get("downweighted") == 1


def test_thaw_on_external_put():
    """An external ``registry.put`` replaces the posterior under the
    frozen gain: the next update thaws and runs exact."""
    states = _states(PosteriorState, 1)
    svc = _service(states, 1e-9)
    rng = np.random.default_rng(17)
    svc.update("m0", _row(svc, "m0", rng))
    assert svc._steady_count() == 1
    svc.registry.put(states[0], persist=False)  # a hot swap, version 0
    res = svc.update("m0", _row(svc, "m0", rng))
    assert res.version == states[0].version + 1
    assert svc.steady_transitions.snapshot().get("thaw") == 1


def test_thaw_on_same_version_put():
    """A restore that reuses the frozen version number still thaws: the
    frozen state pins its posterior by object identity."""
    states = _states(PosteriorState, 1)
    svc = _service(states, 1e-9)
    rng = np.random.default_rng(37)
    st1 = svc.update("m0", _row(svc, "m0", rng))
    assert svc._steady_count() == 1
    svc.registry.put(st1._replace(params=np.array(st1.params),
                                  loadings=np.array(st1.loadings)),
                     persist=False)
    res = svc.update("m0", _row(svc, "m0", rng))
    assert res.version == st1.version + 1
    assert svc.steady_transitions.snapshot().get("thaw") == 1


def test_thaw_on_robust_arming():
    """An armed robust likelihood is time-varying: a model frozen while
    below the robust floor thaws when it reaches it, and does not freeze
    again while armed."""
    states = _states(PosteriorState, 1)
    t0 = states[0].t_seen
    svc = _service(states, 1e-9,
                   robust=RobustSpec(likelihood="huber_t", min_seen=t0 + 2))
    rng = np.random.default_rng(19)
    svc.update("m0", _row(svc, "m0", rng, scale=0.0))
    assert svc._steady_count() == 1  # t_seen t0 + 1: not armed yet
    svc.update("m0", _row(svc, "m0", rng, scale=0.0))  # frozen, unarmed
    assert svc._steady_count() == 1
    svc.update("m0", _row(svc, "m0", rng, scale=0.0))  # armed: thaws
    assert svc._steady_count() == 0
    assert svc.steady_transitions.snapshot() == {"freeze": 1, "thaw": 1}
    svc._steady_thawed_at["m0"] -= 2 * service_mod.STEADY_REFREEZE_COOLDOWN_S
    svc.update("m0", _row(svc, "m0", rng, scale=0.0))
    assert svc._steady_count() == 0  # armed robust models never freeze


def test_refreeze_cooldown():
    """A thawed model waits out the cooldown before it freezes again."""
    svc_s, _, row = _frozen_pair(21)
    bad = row.copy()
    bad[0, 0] = np.nan
    svc_s.update("m0", bad)
    assert svc_s._steady_count() == 0  # m0 thawed; m1 was never updated
    # back to the converged posterior (the masked step widened the
    # covariance): the model would freeze now but for the cooldown
    svc_s.registry.put(_states(PosteriorState, 1)[0], persist=False)
    rng = np.random.default_rng(22)
    for _ in range(3):
        svc_s.update("m0", _row(svc_s, "m0", rng, scale=0.0))
    assert "m0" not in svc_s._steady_info
    svc_s._steady_thawed_at["m0"] -= service_mod.STEADY_REFREEZE_COOLDOWN_S
    svc_s.update("m0", _row(svc_s, "m0", rng, scale=0.0))
    assert "m0" in svc_s._steady_info
    assert svc_s.steady_transitions.snapshot() == {"freeze": 2, "thaw": 1}


def test_health_sections_and_defaults(monkeypatch):
    states = _states(PosteriorState, 2)
    svc = _service(states, 1e-9)
    rng = np.random.default_rng(23)
    svc.update("m0", _row(svc, "m0", rng))
    health = svc.health()
    assert health["steady"] == {"frozen": 1, "tol": 1e-9, "freeze": 1}
    assert "fixed_lag" not in health
    svc.close()
    off = MetranService(svc.registry, flush_deadline=None, device="cpu")
    assert not off.steady.enabled and "steady" not in off.health()
    off.close()
    monkeypatch.setenv("METRAN_TPU_SERVE_STEADY_TOL", "1e-6")
    monkeypatch.setenv("METRAN_TPU_SERVE_STEADY_MIN_SEEN", "12")
    monkeypatch.setenv("METRAN_TPU_SERVE_FIXED_LAG", "5")
    env = MetranService(svc.registry, flush_deadline=None, device="cpu")
    assert env.steady == SteadySpec(tol=1e-6, min_seen=12)
    assert env.smoother.lag == 5
    env.close()
    with pytest.raises(ValueError, match="tol"):
        SteadySpec(tol=-1.0).validate()


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("engine", ["joint", "sequential", "sqrt"])
def test_matches_the_jax_steady_service(engine, gated):
    """The port's steady service and the JAX one on the same states and
    stream, with a thaw of each kind on the way (a NaN cell, a spike
    under the gate, an external put): the same freeze and thaw
    transitions round by round, means to 1e-10."""
    n_models = 3
    pstates = _states(PosteriorState, n_models)
    jstates = _states(JaxState, n_models)
    psvc = _service(pstates, 1e-9, engine,
                    GateSpec(**GATE) if gated else None)
    jsvc = _jax_service(jstates, 1e-9, engine,
                        JaxGate(**GATE) if gated else None)
    ids = [st.model_id for st in pstates]
    rng = np.random.default_rng(29)
    for r in range(10):
        for mid in ids:
            row = _row(psvc, mid, rng, scale=0.2)
            if (r, mid) == (4, "m1"):
                row[0, 2] = np.nan
            if (r, mid) == (6, "m2") and gated:
                row[0, 0] += 60.0
            if (r, mid) == (7, "m0"):
                for svc, st in ((psvc, pstates[0]), (jsvc, jstates[0])):
                    svc.registry.put(st, persist=False)
            a, b = psvc.update(mid, row), jsvc.update(mid, row)
            assert a.version == b.version
            got, want = _mean(psvc, mid), _mean(jsvc, mid)
            assert float(np.abs(got - want).max()
                         / max(np.abs(want).max(), 1e-300)) <= 1e-10
        assert psvc._steady_count() == jsvc._steady_count(), r
        assert psvc.steady_transitions.snapshot() == \
            jsvc.metrics.steady_transitions.snapshot(), r
    trans = psvc.steady_transitions.snapshot()
    assert trans["freeze"] >= n_models and trans["thaw"] == (
        3 if gated else 2)
    if gated:
        assert psvc.gate_verdicts.snapshot() == \
            jsvc.metrics.gate_verdicts.snapshot()
    psvc.close()
    jsvc.close()


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("engine", ["joint", "sequential", "sqrt"])
def test_frozen_gain_pair_is_the_jax_services(engine, gated):
    """The registry's one rule for the frozen gate form (per slot on a
    gated covariance engine, joint otherwise), which both the steady
    update and the freeze read, and the bucket-padded gain pair the
    service freezes with it: the JAX service's to 1e-10."""
    gate = GateSpec(**GATE) if gated else None
    reg = ModelRegistry(root=None, engine=engine)
    assert reg.steady_sequential_gate(gate) == (gated and engine != "sqrt")
    psvc = _service(_states(PosteriorState, 2), 1e-9, engine, gate)
    jsvc = _jax_service(_states(JaxState, 2), 1e-9, engine,
                        JaxGate(**GATE) if gated else None)
    rng = np.random.default_rng(31)
    for _ in range(2):
        for mid in ("m0", "m1"):
            row = _row(psvc, mid, rng, scale=0.0)
            psvc.update(mid, row)
            jsvc.update(mid, row)
    assert psvc._steady_count() == jsvc._steady_count() == 2
    for mid in ("m0", "m1"):
        got, want = psvc._steady_info[mid], jsvc._steady_info[mid]
        for a, b in ((got.kgain, want.kgain), (got.fdiag, want.fdiag)):
            b = np.asarray(b)
            assert a.shape == b.shape
            assert float(np.abs(a - b).max()) <= 1e-10 * max(
                float(np.abs(b).max()), 1.0)
    psvc.close()
    jsvc.close()


def test_steady_update_fn_matches_jax_with_detection():
    """The bucket's steady update with the gate (per-slot form) and
    detection against JAX's, on a batch where one row breaks: equal
    outputs, and the broken row's detector state carried unchanged."""
    states = _states(PosteriorState, 3)
    bucket = (8, 16)
    batch = stack_bucket(states, bucket, device="cpu", factors=False)
    assert batch.cov is None and batch.chol is None
    rng = np.random.default_rng(31)
    kg = rng.normal(size=(3, 16, 8)) * 0.1
    fd = rng.uniform(0.5, 1.5, (3, 8))
    kg[:, :, N:] = 0.0
    fd[:, N:] = 1.0
    real = np.zeros((3, 8), bool)
    real[:, :N] = True
    y = np.zeros((3, 2, 8))
    y[:, :, :N] = rng.normal(size=(3, 2, N)) * 2.0
    mask = np.zeros((3, 2, 8), bool)
    mask[:, :, :N] = True
    mask[1, 0, 2] = False
    armed = np.array([True, True, False])
    det_state = np.abs(rng.normal(size=(3, 6, 8)))
    det_armed = np.array([True, True, True])
    gate = dict(policy="reject", nsigma=1.5, min_seen=1)
    det = dict(enabled=True, min_seen=1, cusum_h=2.0)
    fn = make_steady_update_fn(GateSpec(**gate), sequential_gate=True,
                               detect=DetectSpec(**det))
    jfn = jax_steady_fn(JaxGate(**gate), sequential_gate=True,
                        detect=JaxDetect(**det))
    t = torch.as_tensor
    got = fn(batch.ss, batch.mean, t(kg), t(fd), t(real), t(y), t(mask),
             t(armed), t(det_state), t(det_armed))
    jss = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), batch.ss)
    want = jfn(jss, jnp.asarray(batch.mean.numpy()), kg, fd, real, y, mask,
               armed, det_state, det_armed)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype.kind == "f":
            assert np.array_equal(np.isnan(g), np.isnan(w))
            fin = np.isfinite(w)
            assert np.abs(g[fin] - w[fin]).max() <= 1e-12
        else:
            assert np.array_equal(g, w)
    broke = got[3].numpy()
    assert broke[1]  # the masked slot
    assert np.array_equal(got[6][1].numpy(), det_state[1])
    # the read path's frozen half (K14's horizons mode): the means of the
    # commit-time forecast pass ride after the gate's outputs, before the
    # detector's, as in the JAX function
    fn = make_steady_update_fn(GateSpec(**gate), horizons=(1, 2, 5),
                               sequential_gate=True,
                               detect=DetectSpec(**det))
    jfn = jax_steady_fn(JaxGate(**gate), horizons=(1, 2, 5),
                        sequential_gate=True, detect=JaxDetect(**det))
    got = fn(batch.ss, batch.mean, t(kg), t(fd), t(real), t(y), t(mask),
             t(armed), t(det_state), t(det_armed))
    want = jfn(jss, jnp.asarray(batch.mean.numpy()), kg, fd, real, y, mask,
               armed, det_state, det_armed)
    assert len(got) == len(want) == 10 and got[6].shape == (3, 3, 8)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        fin = np.isfinite(w)
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert np.abs(g[fin].astype(float) - w[fin]).max() <= 1e-12
