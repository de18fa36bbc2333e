"""Port parity of the arena service: a port ``MetranService`` over
``ModelRegistry(arena=True, device="cpu")`` (the plain versions of K16,
K17 and K18) and the JAX ``MetranService`` over its own arena registry,
on the same fitted models and the same observation stream (f64, CPU).

Three configurations: the joint engine with the ``"reject"`` gate and
streaming detection; the square-root engine with steady-state serving
(freezes after a fully observed round, a masked round that thaws some
rows); the sequential engine with the censored robust likelihood.  The
stream carries spikes and a poisoned model.  Checks: equal acks
(version, ``t_seen``) and failures round by round, posteriors and
forecasts to 1e-10 (relative; matmul/QR roundoff), and equal booked
gate verdicts, detection counts, robust outcomes and steady
transitions.
"""

import numpy as np
import pytest
import torch

from metran_tpu.cluster._testing import make_states
from metran_tpu.serve import MetranService as JaxService
from metran_tpu.serve import ModelRegistry as JaxRegistry
from metran_tpu.serve.engine import DetectSpec as JaxDetect
from metran_tpu.serve.engine import GateSpec as JaxGate
from metran_tpu.serve.engine import RobustSpec as JaxRobust
from metran_tpu.serve.engine import SteadySpec as JaxSteady
from metran_tpu_torch.serve import (
    ArenaUpdateAck,
    DetectSpec,
    GateSpec,
    MetranService,
    ModelRegistry,
    PosteriorState,
    RobustSpec,
    SteadySpec,
)

torch.set_num_threads(1)

ROUNDS = 8
POISONED = "m3"
CASES = {
    "joint_gate_detect": dict(
        engine="joint",
        gate=dict(policy="reject", nsigma=4.0, min_seen=32),
        detect=dict(enabled=True, min_seen=8, cusum_h=6.0)),
    "sqrt_steady": dict(
        engine="sqrt", steady=dict(tol=5e-2, min_seen=0)),
    "sequential_robust": dict(
        engine="sequential",
        robust=dict(likelihood="censored", rail_lo=-2.0, rail_hi=2.0,
                    min_seen=32)),
}


def _services(case, mesh=0, rows=16):
    cfg = CASES[case]
    states = make_states(n_models=5)
    bad = states[3]
    states[3] = bad._replace(mean=np.full_like(bad.mean, np.nan))
    jreg = JaxRegistry(root=None, engine=cfg["engine"], arena=True,
                       arena_rows=rows, arena_mesh=mesh)
    preg = ModelRegistry(root=None, engine=cfg["engine"], arena=True,
                         arena_rows=rows, arena_mesh=mesh, device="cpu")
    for st in states:
        jreg.put(st, persist=False)
        preg.put(PosteriorState.from_jax_state(st), persist=False)
    jkw, pkw = {}, {}
    for key, jcls, pcls in (("gate", JaxGate, GateSpec),
                            ("detect", JaxDetect, DetectSpec),
                            ("steady", JaxSteady, SteadySpec),
                            ("robust", JaxRobust, RobustSpec)):
        if key in cfg:
            jkw[key] = jcls(**cfg[key])
            pkw[key] = pcls(**cfg[key])
    jsvc = JaxService(jreg, flush_deadline=None, persist_updates=False,
                      **jkw)
    psvc = MetranService(preg, flush_deadline=None, persist_updates=False,
                         device="cpu", **pkw)
    return states, jsvc, psvc


def _stream(states, seed=5):
    """Per round and model one row (data units); round 2 carries spikes
    beyond the rails and the gate, round 5 a masked cell per model."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(ROUNDS):
        per = {}
        for st in states:
            z = rng.normal(size=st.n_series) * 0.5
            if r == 2:
                z[1] = 9.0
            if r == 5:
                z[0] = np.nan
            per[st.model_id] = (st.scaler_mean + st.scaler_std * z)[None]
        rows.append(per)
    return rows


def _drive(svc, ids, rows):
    """Every model's row per round through ``update_async`` and one
    flush: per round each model's (version, t_seen) ack or the name of
    the exception it failed with (the poisoned model's breaker opens
    after five failures)."""
    out = []
    for per in rows:
        futs = {}
        for mid in ids:
            try:
                futs[mid] = svc.update_async(mid, per[mid])
            except Exception as exc:  # noqa: BLE001 - each side's class
                futs[mid] = type(exc).__name__
        svc.flush()
        res = {}
        for mid, f in futs.items():
            if isinstance(f, str):
                res[mid] = f
                continue
            exc = f.exception()
            res[mid] = (type(exc).__name__ if exc is not None
                        else (f.result().version, f.result().t_seen))
        out.append(res)
    return out


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("case", list(CASES))
def test_arena_service_matches_jax(case):
    check_service(*_services(case), case)


def check_service(states, jsvc, psvc, case):
    """Both services through the same stream: acks, posteriors,
    forecasts and the booked outcomes."""
    ids = [st.model_id for st in states]
    rows = _stream(states)
    jout = _drive(jsvc, ids, rows)
    pout = _drive(psvc, ids, rows)
    assert pout == jout
    assert {r[POISONED] for r in pout} == {"StateIntegrityError",
                                           "CircuitOpenError"}
    assert isinstance(psvc.update(ids[0], rows[0][ids[0]], deadline=30.0),
                      ArenaUpdateAck)
    jsvc.update(ids[0], rows[0][ids[0]], deadline=30.0)
    for mid in ids:
        js, ps = jsvc.registry.get(mid), psvc.registry.get(mid)
        assert (ps.version, ps.t_seen) == (js.version, js.t_seen)
        if mid == POISONED:
            assert np.isnan(ps.mean).all()
            continue
        assert _rel(ps.mean, js.mean) <= 1e-10
        assert _rel(ps.cov, js.cov) <= 1e-10
    jfc = jsvc.forecast_batch(ids, 6)
    pfc = psvc.forecast_batch(ids, 6)
    for jf, pf in zip(jfc, pfc):
        if isinstance(jf, Exception):
            assert type(pf).__name__ == type(jf).__name__
            continue
        assert pf.version == jf.version
        assert _rel(pf.means, jf.means) <= 1e-10
        assert _rel(pf.variances, jf.variances) <= 1e-10
    jm = jsvc.metrics
    assert psvc.gate_verdicts.snapshot() == jm.gate_verdicts.snapshot()
    if "gate" in CASES[case]:
        assert psvc.gate_verdicts.snapshot().get("rejected", 0) >= 1
    if "detect" in CASES[case]:
        assert psvc.detect_total.snapshot() == jm.detect_total.snapshot()
        ja, pa = jsvc.anomalies(), psvc.anomalies()
        for mid in ids:
            if mid == POISONED:
                continue
            for key in ("anomalies", "cusum_alarms", "lb_alarms"):
                assert pa[mid][key] == ja[mid][key], (mid, key)
            np.testing.assert_allclose(pa[mid]["cusum_pos"],
                                       ja[mid]["cusum_pos"], atol=1e-8)
    if "robust" in CASES[case]:
        snap = psvc.robust_total.snapshot()
        assert snap == jm.robust_total.snapshot()
        assert snap.get("map_updates", 0) >= 1
    if "steady" in CASES[case]:
        snap = psvc.steady_transitions.snapshot()
        assert snap == jm.steady_transitions.snapshot()
        assert snap.get("freeze", 0) >= 1 and snap.get("thaw", 0) >= 1
        assert psvc.health()["steady"]["frozen"] == \
            jsvc.health()["steady"]["frozen"]
    jsvc.close()
    psvc.close()
