"""Port parity: the reliability layer (``metran_tpu_torch.reliability``)
against the JAX package's ``metran_tpu.reliability`` — the same event
sequences on the same fake clock drive both sides' retry schedule,
circuit breakers and health monitor, and their states must be equal
after every step.  Host code: equality is exact.
"""

import numpy as np
import pytest

from metran_tpu import reliability as jrel
from metran_tpu_torch import reliability as prel


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_retry_policy_schedule_and_retryable_errors():
    for kw in ({}, dict(max_attempts=4, backoff_s=0.1, multiplier=3.0,
                        max_backoff_s=0.5)):
        p, j = prel.RetryPolicy(**kw), jrel.RetryPolicy(**kw)
        assert [p.delay(a) for a in range(6)] == [j.delay(a)
                                                  for a in range(6)]
        assert p.max_attempts == j.max_attempts
    cases = [(OSError("io"), True), (RuntimeError("x"), True),
             (ValueError("bad"), False), (KeyError("m"), False),
             (KeyboardInterrupt(), False)]
    for exc, want in cases:
        assert prel.is_retryable(exc) is want
        assert jrel.is_retryable(exc) is want
    for name in ("StateIntegrityError", "ChainedRequestError"):
        assert not prel.is_retryable(getattr(prel, name)("x"))
    assert not prel.is_retryable(prel.CircuitOpenError("m", 1.0))
    assert not prel.is_retryable(prel.DeadlineExceededError(
        "update", "m", 1.0, in_flight=False))


def _state(b):
    return (b.state, b._failures, b._opened_at, b._probe is None)


def test_circuit_breaker_transitions_match_jax():
    """Failures open the breaker, the cooldown half-opens it, one probe
    at a time, a stale verdict moves nothing, a successful probe closes
    it and a failed one re-opens it."""
    ck_p, ck_j = _Clock(), _Clock()
    seen_p, seen_j = [], []
    bp = prel.CircuitBreaker("m", 3, 5.0, ck_p,
                             on_transition=lambda *a: seen_p.append(a))
    bj = jrel.CircuitBreaker("m", 3, 5.0, ck_j,
                             on_transition=lambda *a: seen_j.append(a))
    tokens = {}

    def both(step, t=None):
        outs = []
        for b, ck, side in ((bp, ck_p, "p"), (bj, ck_j, "j")):
            if t is not None:
                ck.t = t
            try:
                out = step(b, side)
            except Exception as exc:  # noqa: BLE001 - each side's class
                out = type(exc).__name__
            outs.append(out)
        assert outs[0] == outs[1], outs
        assert _state(bp) == _state(bj)

    def admit(key):
        def step(b, side):
            tokens[side, key] = b.allow()
            return tokens[side, key] is None
        return step

    both(admit("stale"))  # admitted closed, finishes late
    for _ in range(3):
        both(lambda b, s: b.record_failure())
    both(admit("x"), t=1.0)  # open: rejected
    both(lambda b, s: b.record_success(tokens[s, "stale"]))  # ignored
    both(admit("probe"), t=6.0)  # half-open: the probe
    both(admit("second"), t=6.5)  # one probe at a time
    both(lambda b, s: b.record_failure(tokens[s, "stale"]))  # stale
    both(lambda b, s: b.record_failure(tokens[s, "probe"]))  # re-opens
    both(admit("probe2"), t=12.0)
    both(lambda b, s: b.record_abandoned(tokens[s, "probe2"]))
    both(admit("probe3"), t=12.5)
    both(lambda b, s: b.record_success(tokens[s, "probe3"]))  # closes
    both(admit("after"), t=13.0)
    assert seen_p == seen_j and seen_p[-1] == ("m", "half_open", "closed")
    assert bp.state == "closed"


def test_breaker_board_and_reliability_policy_defaults(monkeypatch):
    ck = _Clock()
    bp = prel.BreakerBoard(2, 1.0, ck)
    bj = jrel.BreakerBoard(2, 1.0, ck)
    for board in (bp, bj):
        for _ in range(2):
            board.get("b").record_failure()
        board.get("a").record_failure()
    assert bp.open_models() == bj.open_models() == ["b"]
    assert len(bp) == len(bj) == 2
    monkeypatch.setenv("METRAN_TPU_SERVE_BREAKER_FAILURES", "7")
    monkeypatch.setenv("METRAN_TPU_SERVE_RETRY_ATTEMPTS", "3")
    monkeypatch.setenv("METRAN_TPU_SERVE_DEADLINE_S", "2.5")
    p, j = (prel.ReliabilityPolicy.from_defaults(),
            jrel.ReliabilityPolicy.from_defaults())
    for field in ("deadline_s", "breaker_failures", "breaker_cooldown_s",
                  "validate_updates", "health_window", "max_error_rate"):
        assert getattr(p, field) == getattr(j, field), field
    assert vars(p.retry) == vars(j.retry)  # two classes, equal fields
    assert p.breaker_failures == 7 and p.retry.max_attempts == 3


def test_health_monitor_matches_jax():
    """Outcomes, bulk outcomes, the gate window, changepoints and the
    refit-candidate queue through both monitors on one fake clock."""
    ck = _Clock(10.0)
    kw = dict(window=8, max_error_rate=0.25, gate_window=3,
              max_rejection_rate=0.2, changepoint_ttl_s=50.0, clock=ck)
    mp, mj = prel.HealthMonitor(**kw), jrel.HealthMonitor(**kw)
    rng = np.random.default_rng(2)

    def both(name, *args):
        outs = [getattr(m, name)(*args) for m in (mp, mj)]
        assert outs[0] == outs[1], (name, outs)
        return outs[0]

    for ok in rng.uniform(size=12) > 0.3:
        both("record", bool(ok))
        both("error_rate")
        both("healthy")
    both("record_many", 5, 20)
    assert not both("healthy")
    both("record_many", 8, 0)
    assert both("healthy")
    for obs, flagged in ((10, 0), (10, 4), (0, 5), (10, 1), (10, 0)):
        both("record_gate", "s", obs, flagged)
        both("degraded_models")
        both("rejection_rate", "s")
    both("record_gate_many", [("t", 10, 9), ("u", 0, 3)])
    both("record_changepoint", "c")
    both("note_progress", "p", 100)
    ck.t = 30.0
    both("note_progress", "p", 160)
    both("changepoint_models")
    cands = both("refit_candidates", 50, 0.0)
    assert [c.model_id for c in cands][:2] == ["t", "c"]
    assert isinstance(cands[0], prel.RefitCandidate)
    assert both("begin_refit", "c") is True
    assert both("begin_refit", "c") is False
    both("end_refit", "c", 5.0)
    both("refit_candidates", 50, 15.0)
    ck.t = 100.0  # the changepoint flag expires
    both("changepoint_models")
    both("reset_gate", "t")
    both("gate_stats")
    snap = [m.snapshot({"extra": 1}) for m in (mp, mj)]
    assert snap[0] == snap[1]
    mp.bind_metrics(object())  # no metrics registry yet: publishes nothing


@pytest.mark.parametrize("kind", ["update", "forecast"])
def test_deadline_error_message_matches_jax(kind):
    for flight in (True, False):
        p = prel.DeadlineExceededError(kind, "m", 0.25, in_flight=flight)
        j = jrel.DeadlineExceededError(kind, "m", 0.25, in_flight=flight)
        assert str(p) == str(j) and p.in_flight is flight
    assert str(prel.CircuitOpenError("m", 2.0)) == \
        str(jrel.CircuitOpenError("m", 2.0))
