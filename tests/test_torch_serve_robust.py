"""Port parity: robust (implicit-MAP) serving — ``RobustSpec``,
``make_update_fn(robust=...)`` and ``MetranService(robust=...)`` of the
port on the CPU against the JAX package's, f64.

Checks: the spec's defaults, validation, environment overrides and
properties equal JAX's; gate and robust exclude each other; an armed
service on a stream that never flags serves bit for bit what the plain
service serves and books each commit as a fallback; verdicts and
counters are booked off the robust outputs (the monitor's window counts
the non-converged solves, the iteration tally the MAP slots); detection
through the robust update counts each observation once; and a 4-model
service (one model cold, below ``min_seen``) on the joint, sequential
and square-root registries is held to the JAX service round by round:
posteriors 1e-10 (relative; matmul/QR roundoff and the elementary
functions' last bits), equal versions, equal robust counters
(``map_updates``, ``map_slots``, ``fallback_updates``, ``nonconverged``),
iteration totals and gate windows.
"""

import numpy as np
import pytest
import torch

from metran_tpu.cluster._testing import make_states
from metran_tpu.serve import MetranService as JaxService
from metran_tpu.serve import ModelRegistry as JaxRegistry
from metran_tpu.serve.engine import DetectSpec as JaxDetect
from metran_tpu.serve.engine import RobustSpec as JaxRobust
from metran_tpu_torch import kernels
from metran_tpu_torch.serve import (
    DetectSpec,
    GateSpec,
    MetranService,
    ModelRegistry,
    PosteriorState,
    RobustSpec,
    make_update_fn,
)

torch.set_num_threads(1)

COLD = "m3"


# ----------------------------------------------------------------------
# the spec
# ----------------------------------------------------------------------
BAD = [dict(likelihood="cauchy"),
       dict(likelihood="censored", rail_lo=1.0, rail_hi=-1.0),
       dict(likelihood="censored"),
       dict(likelihood="quantized", quantum=0.0),
       dict(likelihood="huber_t", nu=2.0),
       dict(likelihood="huber_t", min_seen=-1),
       dict(likelihood="censored", rail_hi=1.0, scale=0.0)]
GOOD = [dict(), dict(likelihood="gaussian"),
        dict(likelihood="censored", rail_hi=0.5),
        dict(likelihood="quantized", quantum=0.1),
        dict(likelihood="huber_t", nu=5.0, scale=0.2, min_seen=0)]


def test_robust_spec_matches_jax():
    assert tuple(RobustSpec()) == tuple(JaxRobust())
    assert RobustSpec._fields == JaxRobust._fields
    for kw in GOOD:
        got, want = RobustSpec(**kw).validate(), JaxRobust(**kw).validate()
        assert tuple(got) == tuple(want)
        for prop in ("enabled", "time_varying", "flags_selectively"):
            assert getattr(got, prop) == getattr(want, prop), (kw, prop)
        assert got.compile_key() == want.compile_key()
    for kw in BAD:
        with pytest.raises(ValueError) as want:
            JaxRobust(**kw).validate()
        with pytest.raises(ValueError) as got:
            RobustSpec(**kw).validate()
        assert str(got.value) == str(want.value)


def test_robust_spec_from_the_environment_matches_jax(monkeypatch):
    assert tuple(RobustSpec.from_defaults()) == tuple(
        JaxRobust.from_defaults())
    assert not RobustSpec.from_defaults().enabled
    env = dict(METRAN_TPU_SERVE_ROBUST="1",
               METRAN_TPU_SERVE_ROBUST_LIKELIHOOD="censored",
               METRAN_TPU_SERVE_ROBUST_RAIL_LO="-2.5",
               METRAN_TPU_SERVE_ROBUST_RAIL_HI="3.0",
               METRAN_TPU_SERVE_ROBUST_QUANTUM="0.01",
               METRAN_TPU_SERVE_ROBUST_NU="6",
               METRAN_TPU_SERVE_ROBUST_SCALE="0.1",
               METRAN_TPU_SERVE_ROBUST_MIN_SEEN="8")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = RobustSpec.from_defaults()
    assert got.enabled and tuple(got) == tuple(JaxRobust.from_defaults())
    # a service built with no spec reads the same defaults
    svc = MetranService(ModelRegistry(root=None), flush_deadline=None,
                        device="cpu")
    assert svc.robust == got
    svc.close()


def test_gate_and_robust_are_mutually_exclusive():
    with pytest.raises(ValueError, match="mutually exclusive"):
        MetranService(ModelRegistry(root=None), flush_deadline=None,
                      gate=GateSpec(policy="reject"),
                      robust=RobustSpec(likelihood="huber_t"),
                      device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_update_fn("sqrt", gate=GateSpec(policy="huber"),
                       robust=RobustSpec(likelihood="huber_t"))
    # a disarmed spec is no clash
    svc = MetranService(ModelRegistry(root=None), flush_deadline=None,
                        gate=GateSpec(policy="reject"),
                        robust=RobustSpec(), device="cpu")
    svc.close()


# ----------------------------------------------------------------------
# services
# ----------------------------------------------------------------------
def _states(engine, n_models=4):
    states = make_states(n_models=n_models)
    if n_models > 3:
        states[3] = states[3]._replace(t_seen=5)  # cold: below min_seen
    return states


def _port_service(engine, states, **kw):
    reg = ModelRegistry(root=None, engine=engine)
    for st in states:
        reg.put(PosteriorState.from_jax_state(st), persist=False)
    return MetranService(reg, flush_deadline=None, persist_updates=False,
                         device="cpu", **kw)


def _jax_service(engine, states, **kw):
    reg = JaxRegistry(root=None, engine=engine)
    for st in states:
        reg.put(st, persist=False)
    return JaxService(reg, flush_deadline=None, persist_updates=False, **kw)


def _rows(states, rounds, likelihood, seed=5, spikes=()):
    """Per round and model one row in data units: the scaler mean plus
    noise, some gaps, degraded as the likelihood's sensor reports it
    (clipped at the rails, rounded to the quantum, or spiked)."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(rounds):
        per = {}
        for st in states:
            z = rng.normal(size=st.n_series) * 0.6
            z[rng.uniform(size=z.shape) < 0.15] = np.nan
            for mid, slot, rnd, size in spikes:
                if mid == st.model_id and rnd == r:
                    z[slot] = size
            row = st.scaler_mean + st.scaler_std * z
            if likelihood == "censored":
                row = np.clip(row, RAILS[0], RAILS[1])
            elif likelihood == "quantized":
                row = QUANTUM * np.round(row / QUANTUM)
            per[st.model_id] = row[None]
        rows.append(per)
    return rows


RAILS = (-0.9, 0.9)
QUANTUM = 0.25
SPIKES = (("m0", 1, 2, 9.0), ("m1", 3, 4, -9.0), (COLD, 0, 1, 9.0))


def _spec(likelihood, cls):
    kw = dict(likelihood=likelihood, min_seen=32, scale=0.1)
    if likelihood == "censored":
        kw.update(rail_lo=RAILS[0], rail_hi=RAILS[1])
    if likelihood == "quantized":
        kw.update(quantum=QUANTUM)
    return cls(**kw)


def _drive(svc, rows):
    out = []
    for per in rows:
        futs = {mid: svc.update_async(mid, row) for mid, row in per.items()}
        svc.flush()
        out.append({mid: f.result() for mid, f in futs.items()})
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("engine,likelihood", [
    ("joint", "censored"), ("sequential", "quantized"),
    ("sqrt", "huber_t"), ("sqrt", "censored")])
def test_robust_service_matches_jax(engine, likelihood):
    states = _states(engine)
    rounds = 6
    rows = _rows(states, rounds, likelihood,
                 spikes=SPIKES if likelihood == "huber_t" else ())
    detect = likelihood == "censored" and engine == "joint"
    jkw = dict(robust=_spec(likelihood, JaxRobust))
    pkw = dict(robust=_spec(likelihood, RobustSpec))
    if detect:
        jkw["detect"] = JaxDetect(enabled=True, min_seen=8)
        pkw["detect"] = DetectSpec(enabled=True, min_seen=8)
    jsvc = _jax_service(engine, states, **jkw)
    psvc = _port_service(engine, states, **pkw)
    kernels.reset_launches()
    want, got = _drive(jsvc, rows), _drive(psvc, rows)
    assert set(kernels.launches().values()) == {0}  # the plain path
    for w_round, g_round in zip(want, got):
        for mid, w in w_round.items():
            g = g_round[mid]
            assert (g.version, g.t_seen) == (w.version, w.t_seen)
            assert _rel(g.mean, w.mean) <= 1e-10, mid
            assert _rel(g.cov, w.cov) <= 1e-10, mid
    counts = psvc.robust_total.snapshot()
    assert counts == jsvc.metrics.robust_total.snapshot()
    assert counts.get("map_updates", 0) > 0
    # the cold model is disarmed: it never books a robust commit
    assert counts.get("map_updates", 0) + counts.get(
        "fallback_updates", 0) == rounds * (len(states) - 1)
    tally = psvc.robust_iters.snapshot()
    assert sum(tally.values()) == counts["map_slots"]
    hist = jsvc.obs.metrics.snapshot()[
        "metran_serve_robust_solver_iterations"]
    assert sum(tally.values()) == hist["count"]
    assert sum(k * v for k, v in tally.items()) == hist["sum"]
    assert psvc.monitor.gate_stats() == jsvc.monitor.gate_stats()
    health = psvc.health()
    assert health["robust_total"] == counts
    assert health["robust_iterations"] == tally
    if detect:
        an_w, an_g = jsvc.anomalies(), psvc.anomalies()
        assert an_g.keys() == an_w.keys()
        for mid in an_w:
            for key in ("anomalies", "cusum_alarms", "lb_alarms"):
                assert an_g[mid][key] == an_w[mid][key]
    jsvc.close()
    psvc.close()


@pytest.mark.parametrize("engine", ["sqrt", "sequential"])
def test_armed_clean_service_is_bit_identical_to_the_plain_one(engine):
    """On a stream that never rails, an armed censored service commits
    what the plain service commits, bit for bit, and books every commit
    as a fallback (the fallback contract at the service level)."""
    states = _states(engine, n_models=2)
    rows = _rows(states, 8, "none")
    rob = RobustSpec(likelihood="censored", rail_lo=-1e6, rail_hi=1e6,
                     min_seen=1)
    plain = _port_service(engine, states)
    armed = _port_service(engine, states, robust=rob)
    for a, b in zip(_drive(plain, rows), _drive(armed, rows)):
        for mid in a:
            assert np.array_equal(a[mid].mean, b[mid].mean)
            assert np.array_equal(a[mid].cov, b[mid].cov)
    counts = armed.robust_total.snapshot()
    assert counts == {"fallback_updates": 8 * len(states)}
    assert armed.robust_iters.snapshot() == {}
    plain.close()
    armed.close()


@pytest.mark.parametrize("engine", ["sqrt", "sequential"])
def test_detection_through_the_robust_update_counts_once(engine):
    """Detection rides the robust update's z-scores: on a clean stream
    the detector states, the anomaly counts and the posteriors are those
    of a detect-only service — each observation counted once."""
    states = _states(engine, n_models=2)
    rows = _rows(states, 10, "none", seed=6,
                 spikes=(("m0", 1, 4, 7.0),))
    det = DetectSpec(enabled=True, min_seen=1, nsigma=3.0)
    rob = RobustSpec(likelihood="censored", rail_lo=-1e6, rail_hi=1e6,
                     min_seen=1)
    a = _port_service(engine, states, detect=det)
    b = _port_service(engine, states, detect=det, robust=rob)
    ra, rb = _drive(a, rows), _drive(b, rows)
    for mid in ra[-1]:
        assert np.array_equal(ra[-1][mid].mean, rb[-1][mid].mean)
    ea, eb = a.detector._entries, b.detector._entries
    assert ea.keys() == eb.keys()
    for mid in ea:
        assert np.array_equal(ea[mid].state, eb[mid].state)
    assert a.anomalies() == b.anomalies()
    assert a.anomalies()["m0"]["anomalies"] >= 1
    a.close()
    b.close()


def test_booking_off_the_robust_outputs():
    """A railed stream books MAP commits and slots, the iteration tally
    counts the MAP slots, the monitor's window counts the observations,
    and a cold model books nothing robust."""
    states = _states("sqrt")
    rows = _rows(states, 5, "censored", seed=7)
    rob = _spec("censored", RobustSpec)
    svc = _port_service("sqrt", states, robust=rob)
    _drive(svc, rows)
    counts = svc.robust_total.snapshot()
    assert counts["map_updates"] > 0
    assert counts["map_slots"] >= counts["map_updates"]
    assert sum(svc.robust_iters.snapshot().values()) == counts["map_slots"]
    observed = sum(int(np.isfinite(per[st.model_id]).sum())
                   for per in rows for st in states)
    window = svc.monitor.gate_stats()
    assert sum(v["observed"] for v in window.values()) == observed
    assert sum(v["rejected"] for v in window.values()) == counts.get(
        "nonconverged", 0)
    svc.close()
