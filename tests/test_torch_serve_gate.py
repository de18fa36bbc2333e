"""Port parity: the serving path with its input defences — a port
``MetranService(device="cpu")`` and the JAX ``MetranService`` on the same
fitted models and the same observation stream, with an armed
observation gate, streaming detection and the reliability layer, on
the joint, sequential and square-root registries (f64, CPU).

The stream carries spikes on known (model, slot) cells, a level shift
on one series, a cold model (``t_seen < min_seen``, disarmed) and a
poisoned model whose breaker must open after ``breaker_failures``
failed updates while the other slots of the same dispatch commit.
Checks: posteriors to 1e-10 (relative; the two sides' updates differ by
matmul/QR roundoff), equal versions, equal gate-verdict counts, equal
detection counts and flagged slots with the CUSUM/LB statistics to
1e-8 (absolute), equal breaker states and ``health()`` verdicts.
"""

import numpy as np
import pytest
import torch

from metran_tpu.cluster._testing import make_states
from metran_tpu.reliability import ReliabilityPolicy as JaxPolicy
from metran_tpu.serve import MetranService as JaxService
from metran_tpu.serve import ModelRegistry as JaxRegistry
from metran_tpu.serve.engine import DetectSpec as JaxDetect
from metran_tpu.serve.engine import GateSpec as JaxGate
from metran_tpu_torch.ops.kalman import NotPortedError
from metran_tpu_torch.reliability import (
    ReliabilityPolicy,
    StateIntegrityError,
)
from metran_tpu_torch.serve import (
    DetectSpec,
    GateSpec,
    MetranService,
    ModelRegistry,
    PosteriorState,
)

torch.set_num_threads(1)

ROUNDS = 14
SPIKES = {("m1", 2, 3): 9.0, ("m1", 0, 6): -9.0, ("m0", 4, 9): 8.0,
          ("m4", 1, 4): 9.0}
SHIFT = ("m2", 0, 5, 6.0)  # model, slot, first round, size in sd units
POISONED, COLD = "m3", "m4"
FAILURES = 3


def _services(engine, policy="reject"):
    states = make_states(n_models=5)
    states[4] = states[4]._replace(t_seen=5)  # cold: below min_seen
    bad = states[3]
    states[3] = bad._replace(mean=np.full_like(bad.mean, np.nan))
    jreg = JaxRegistry(root=None, engine=engine)
    preg = ModelRegistry(root=None, engine=engine)
    for st in states:
        jreg.put(st, persist=False)
        preg.put(PosteriorState.from_jax_state(st), persist=False)
    gate = dict(policy=policy, nsigma=4.0, min_seen=32)
    detect = dict(enabled=True, min_seen=8, cusum_h=6.0)
    jsvc = JaxService(jreg, flush_deadline=None, persist_updates=False,
                      reliability=JaxPolicy(breaker_failures=FAILURES),
                      gate=JaxGate(**gate), detect=JaxDetect(**detect))
    psvc = MetranService(preg, flush_deadline=None, persist_updates=False,
                         reliability=ReliabilityPolicy(
                             breaker_failures=FAILURES),
                         gate=GateSpec(**gate), detect=DetectSpec(**detect),
                         device="cpu")
    return [st.model_id for st in states], jsvc, psvc


def _stream(ids, seed=11):
    """Per round and model one row (data units): the state's scaler mean
    plus unit-sd noise, with the spikes and the level shift added."""
    rng = np.random.default_rng(seed)
    scaler = {st.model_id: st for st in make_states(n_models=5)}
    rows = []
    for r in range(ROUNDS):
        per = {}
        for mid in ids:
            st = scaler[mid]
            z = rng.normal(size=st.n_series) * 0.5
            z[rng.uniform(size=z.shape) < 0.15] = np.nan
            for (m, slot, rnd), size in SPIKES.items():
                if m == mid and rnd == r:
                    z[slot] = size
            if mid == SHIFT[0] and r >= SHIFT[2]:
                z[SHIFT[1]] = SHIFT[3] + rng.normal() * 0.3
            per[mid] = (st.scaler_mean + st.scaler_std * z)[None]
        rows.append(per)
    return rows


def _drive(svc, ids, rows):
    """Every model's row per round through ``update_async`` + one flush;
    returns the per-round outcomes (a state, or the exception's name)."""
    out = []
    for per in rows:
        futs = {}
        for mid in ids:
            try:
                futs[mid] = svc.update_async(mid, per[mid])
            except Exception as exc:  # noqa: BLE001 - each side's class
                assert type(exc).__name__ == "CircuitOpenError", exc
                futs[mid] = "CircuitOpenError"
        svc.flush()
        res = {}
        for mid, f in futs.items():
            if isinstance(f, str):
                res[mid] = f
            elif f.exception() is not None:
                res[mid] = type(f.exception()).__name__
            else:
                res[mid] = f.result()
        out.append(res)
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("engine", ["joint", "sequential", "sqrt"])
def test_gated_detecting_service_matches_jax(engine):
    ids, jsvc, psvc = _services(engine)
    rows = _stream(ids)
    want = _drive(jsvc, ids, rows)
    got = _drive(psvc, ids, rows)
    for w_round, g_round in zip(want, got):
        for mid in ids:
            w, g = w_round[mid], g_round[mid]
            if isinstance(w, str):
                assert g == w, (mid, g, w)
                continue
            assert not isinstance(g, str), (mid, g)
            assert (g.version, g.t_seen) == (w.version, w.t_seen)
            assert _rel(g.mean, w.mean) <= 1e-10
            assert _rel(g.cov, w.cov) <= 1e-10
    # the poisoned model failed alone, FAILURES times, then its breaker
    # opened; the other models of the same dispatches committed
    outcomes = [r[POISONED] for r in got]
    assert outcomes[:FAILURES] == ["StateIntegrityError"] * FAILURES
    assert set(outcomes[FAILURES:]) == {"CircuitOpenError"}
    assert psvc.registry.get("m0").version == ROUNDS
    for svc in (jsvc, psvc):
        assert svc.breakers.get(POISONED).state == "open"
        assert svc.breakers.get("m0").state == "closed"
    # verdicts: the spikes were caught, the cold model never gated
    verdicts = psvc.gate_verdicts.snapshot()
    assert verdicts == jsvc.metrics.gate_verdicts.snapshot()
    assert verdicts.get("rejected", 0) >= len(SPIKES) - 1
    gate_w = jsvc.monitor.gate_stats()
    gate_g = psvc.monitor.gate_stats()
    assert gate_g == gate_w
    assert gate_g[COLD]["rejected"] == 0  # disarmed: its spike went in
    # detection: the level shift raised a changepoint and an alert
    an_w, an_g = jsvc.anomalies(), psvc.anomalies()
    assert an_g.keys() == an_w.keys()
    for mid in an_w:
        for key in ("anomalies", "cusum_alarms", "lb_alarms", "version",
                    "t_seen", "last_alarm_t_seen", "slots_flagged"):
            assert an_g[mid][key] == an_w[mid][key], (mid, key)
        for key in ("cusum_pos", "cusum_neg", "lb_q"):
            np.testing.assert_allclose(an_g[mid][key], an_w[mid][key],
                                       rtol=0, atol=1e-8)
    assert an_g[SHIFT[0]]["cusum_alarms"] >= 1
    assert f"s{SHIFT[1]}" in an_g[SHIFT[0]]["slots_flagged"]
    kinds = {(a["model_id"], a["kind"]) for a in psvc.alerts()}
    assert kinds == {(a["model_id"], a["kind"]) for a in jsvc.alerts()}
    assert (SHIFT[0], "changepoint") in kinds
    assert SHIFT[0] in psvc.monitor.changepoint_models()
    # health: the open breaker, the readiness bit, the gate window
    h_w, h_g = jsvc.health(), psvc.health()
    assert h_g["breakers"]["open"] == h_w["breakers"]["open"] == [POISONED]
    for key in ("ready", "window", "window_errors", "changepoints_pending"):
        assert h_g[key] == h_w[key], key
    assert h_g["gate"] == h_w["gate"]
    assert h_g["detect"]["alerts"] == h_w["detect"]["alerts"]
    jsvc.close()
    psvc.close()


@pytest.mark.parametrize("policy", ["huber", "inflate"])
def test_soft_policies_match_jax_on_the_joint_registry(policy):
    ids, jsvc, psvc = _services("joint", policy=policy)
    rows = _stream(ids, seed=13)
    want = _drive(jsvc, ids, rows)
    got = _drive(psvc, ids, rows)
    for mid in ids:
        w, g = want[-1][mid], got[-1][mid]
        if isinstance(w, str):
            assert g == w
            continue
        assert _rel(g.mean, w.mean) <= 1e-10
        assert _rel(g.cov, w.cov) <= 1e-10
    verdicts = psvc.gate_verdicts.snapshot()
    assert verdicts == jsvc.metrics.gate_verdicts.snapshot()
    assert verdicts.get("downweighted", 0) >= len(SPIKES) - 1
    assert "rejected" not in verdicts
    jsvc.close()
    psvc.close()


def test_retries_deadline_specs_and_unported_layers():
    ids, _, psvc = _services("joint")
    psvc.close()
    states = make_states(n_models=1)
    reg = ModelRegistry(root=None)
    reg.put(PosteriorState.from_jax_state(states[0]), persist=False)
    sleeps = []
    pol = ReliabilityPolicy(sleep=sleeps.append)
    svc = MetranService(reg, flush_deadline=None, persist_updates=False,
                        reliability=pol, device="cpu")
    assert not svc.gate.enabled and not svc.detect.enabled
    with pytest.raises(ValueError, match="detection is disabled"):
        svc.anomalies()
    # a transient dispatch failure is retried once, after the backoff
    calls = []
    real = svc._run_update

    def flaky(*args):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("transient")
        return real(*args)

    svc._run_update = flaky
    st = svc.update("m0", np.zeros((1, 5)))
    assert st.version == 1 and len(calls) == 2
    assert sleeps == [pol.retry.delay(1)] and svc.stats["retries"] == 1
    # a deterministic failure is not retried
    with pytest.raises(ValueError):
        svc.update("m0", np.zeros((1, 4)))
    assert svc.stats["retries"] == 1
    health = svc.health()
    assert health["ready"] and health["breakers"]["open"] == []
    svc.close()
    # the read path is ported (A4.5): readpath=True arms the store; the
    # refit worker still names its item
    svc_rp = MetranService(reg, flush_deadline=None, device="cpu",
                           readpath=True)
    assert svc_rp.readpath is not None
    svc_rp.close()
    with pytest.raises(NotPortedError, match="ROADMAP A4.9"):
        MetranService(reg, flush_deadline=None, device="cpu",
                      refit=type("R", (), {"enabled": True})())
    with pytest.raises(ValueError, match="mutually exclusive"):
        MetranService(reg, flush_deadline=None, device="cpu",
                      gate=GateSpec(policy="reject"),
                      robust=type("R", (), {"enabled": True})())
    with pytest.raises(StateIntegrityError):
        bad = states[0]._replace(model_id="bad",
                                 mean=np.full_like(states[0].mean, np.nan))
        reg.put(PosteriorState.from_jax_state(bad), persist=False)
        MetranService(reg, flush_deadline=None, device="cpu").update(
            "bad", np.zeros((1, 5)))


def test_external_put_resets_the_detector_state():
    """A ``registry.put`` that replaces a posterior (a restore) resets
    the accumulated evidence, as in the JAX service."""
    states = make_states(n_models=1)
    reg = ModelRegistry(root=None)
    reg.put(PosteriorState.from_jax_state(states[0]), persist=False)
    svc = MetranService(reg, flush_deadline=None, persist_updates=False,
                        detect=DetectSpec(enabled=True, min_seen=1),
                        device="cpu")
    for _ in range(6):
        svc.update("m0", states[0].scaler_mean[None] + 0.5)
    entry = svc.detector._entries["m0"]
    assert float(entry.state[5].max()) > 5.0 and entry.version == 6
    reg.put(PosteriorState.from_jax_state(states[0]), persist=False)
    svc.update("m0", states[0].scaler_mean[None])
    entry = svc.detector._entries["m0"]
    assert float(entry.state[5].max()) == 1.0
    assert svc.anomalies()["m0"]["version"] == 1
    svc.close()
