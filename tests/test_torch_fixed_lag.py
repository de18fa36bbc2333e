"""Port parity: fixed-lag smoothing — ``ops.fixed_lag_smooth`` (K9
``store`` from a given carry, then K10) against the JAX function, bit
for bit against the port's own full square-root filter + smoother over
the whole history, and ``serve.smoothing.FixedLagTracker`` behind
``MetranService(fixed_lag=L).smoothed()`` against the JAX service on the
same states and stream (f64, CPU: the plain versions).

Bars: smoothed means 1e-12 and covariances (compared as S S': the
factors are not unique under r = 0) 1e-12 relative against JAX; exact
equality against the port's full pass; the served windows 1e-10
(relative; the two packages' QR codes round differently) — the
variances to 1e-10 of max(1, their largest): under r = 0 an observed
slot's smoothed variance is zero up to roundoff (~1e-17), which no
relative bar can hold.
"""

import numpy as np
import pytest
import torch

import metran_tpu.ops as jops
import metran_tpu_torch.ops as tops
from metran_tpu.serve import GateSpec as JaxGate
from metran_tpu.serve import MetranService as JaxService
from metran_tpu.serve import ModelRegistry as JaxRegistry
from metran_tpu.serve import PosteriorState as JaxState
from metran_tpu_torch.serve import (
    FixedLagTracker,
    GateSpec,
    MetranService,
    ModelRegistry,
    PosteriorState,
)

torch.set_num_threads(1)

N, K = 4, 1


def _model(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(3.0, 12.0, N), rng.uniform(5.0, 20.0, K),
            rng.uniform(0.3, 0.8, (N, K)))


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), 1e-300))


def _panel(seed, t):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(t, N))
    mask = rng.uniform(size=(t, N)) > 0.15
    return np.where(mask, y, 0.0), mask


def test_fixed_lag_smooth_matches_jax():
    a_s, a_c, lds = _model(23)
    jss = jops.dfm_statespace(a_s, a_c, lds, 1.0)
    tss = tops.dfm_statespace(a_s, a_c, lds, 1.0, device="cpu")
    t, lag = 60, 12
    y, mask = _panel(24, t)
    filt = jops.sqrt_kalman_filter(jss, y, mask)
    m0 = np.asarray(filt.mean_f[t - lag - 1])
    c0 = np.asarray(filt.chol_f[t - lag - 1])
    want = jops.fixed_lag_smooth(jss, m0, c0, y[t - lag:], mask[t - lag:])
    got = tops.fixed_lag_smooth(tss, m0, c0, y[t - lag:], mask[t - lag:],
                                device="cpu")
    assert np.abs(got.mean_s.numpy() - np.asarray(want.mean_s)).max() \
        <= 1e-12
    assert _rel(tops.chol_outer(got.chol_s),
                np.asarray(jops.chol_outer(want.chol_s))) <= 1e-12


def test_window_is_the_full_filter_and_smoother_bitwise():
    """The windowed pass from the full filter's carry at T - L - 1 is
    the port's full filter + smoother's last L steps, bit for bit."""
    a_s, a_c, lds = _model(25)
    tss = tops.dfm_statespace(a_s, a_c, lds, 1.0, device="cpu")
    t, lag = 80, 12
    y, mask = _panel(26, t)
    filt = tops.sqrt_kalman_filter(tss, y, mask, device="cpu")
    full = tops.sqrt_rts_smoother(tss, filt)
    win = tops.fixed_lag_smooth(tss, filt.mean_f[t - lag - 1],
                                filt.chol_f[t - lag - 1], y[t - lag:],
                                mask[t - lag:], device="cpu")
    assert torch.equal(win.mean_s, full.mean_s[t - lag:])
    assert torch.equal(win.chol_s, full.chol_s[t - lag:])


def test_fixed_lag_smooth_refuses_a_non_diagonal_q():
    a_s, a_c, lds = _model(27)
    tss = tops.dfm_statespace(a_s, a_c, lds, 1.0, device="cpu")
    q = tss.q.clone()
    q[0, 1] = q[1, 0] = 1e-3
    bad = tss._replace(q=q)
    with pytest.raises(ValueError, match="diagonal"):
        tops.fixed_lag_smooth(bad, torch.zeros(N + K), torch.eye(N + K),
                              np.zeros((3, N)), np.ones((3, N), bool),
                              device="cpu")


def _state(cls, seed, t_hist=120, chol=True):
    """A square-root posterior after ``t_hist`` steps of the model's own
    data, with a scaler, as each package's ``PosteriorState``."""
    a_s, a_c, lds = _model(seed)
    ss = jops.dfm_statespace(a_s, a_c, lds, 1.0)
    y = np.random.default_rng(seed + 1).normal(size=(t_hist, N)) * 0.5
    filt = jops.sqrt_kalman_filter(ss, y, np.ones_like(y, bool))
    fac = np.asarray(filt.chol_f[-1])
    return cls(
        model_id=f"m{seed}", version=0, t_seen=t_hist,
        mean=np.asarray(filt.mean_f[-1]), cov=fac @ fac.T,
        params=np.concatenate([a_s, a_c]), loadings=lds, dt=1.0,
        scaler_mean=np.full(N, 2.0), scaler_std=np.full(N, 1.5),
        names=tuple(f"s{j}" for j in range(N)),
        chol=fac if chol else None)


def _services(engine, lag, gate=None, seeds=(29, 31)):
    jreg = JaxRegistry(root=None, engine=engine)
    preg = ModelRegistry(root=None, engine=engine)
    for seed in seeds:
        jreg.put(_state(JaxState, seed), persist=False)
        preg.put(_state(PosteriorState, seed), persist=False)
    jgate = JaxGate(**gate) if gate else JaxGate(policy="off")
    pgate = GateSpec(**gate) if gate else GateSpec(policy="off")
    jsvc = JaxService(jreg, flush_deadline=None, persist_updates=False,
                      gate=jgate, fixed_lag=lag)
    psvc = MetranService(preg, flush_deadline=None, persist_updates=False,
                         gate=pgate, fixed_lag=lag, device="cpu")
    return jsvc, psvc, [f"m{s}" for s in seeds]


@pytest.mark.parametrize("engine", ["sqrt", "joint"])
def test_service_smoothed_matches_jax(engine):
    """Updates streamed through both services build the windows (the
    anchor advances past the first L rows, one masked cell included);
    ``smoothed`` agrees, for the full and a shorter lag."""
    lag, rounds = 6, 10
    jsvc, psvc, ids = _services(engine, lag)
    rng = np.random.default_rng(33)
    for r in range(rounds):
        for mid in ids:
            row = 2.0 + 1.5 * rng.normal(size=(1, N)) * 0.5
            if r == 4:
                row[0, 1] = np.nan
            jsvc.update(mid, row)
            psvc.update(mid, row)
    for mid in ids:
        for want_lag in (None, 3):
            want = jsvc.smoothed(mid, want_lag)
            got = psvc.smoothed(mid, want_lag)
            assert got.lag == want.lag and got.t_end == want.t_end
            assert got.names == want.names
            for field in ("means", "state_means"):
                err = _rel(getattr(got, field), getattr(want, field))
                assert err <= 1e-10, (mid, field, err)
            scale = max(1.0, float(np.abs(want.variances).max()))
            err = float(np.abs(got.variances - want.variances).max())
            assert err <= 1e-10 * scale, (mid, err)
    assert psvc.smoothed(ids[0]).lag == lag
    health = psvc.health()
    assert health["fixed_lag"] == {"lag": lag, "tracked": len(ids)}
    jsvc.close()
    psvc.close()


def test_smoother_restarts_on_gate_intervention():
    """The window does not buffer observations the gate rejected: the
    tracker restarts from the served posterior and refills."""
    gate = dict(policy="reject", nsigma=4.0, min_seen=1)
    jsvc, psvc, ids = _services("joint", 4, gate=gate, seeds=(41,))
    mid = ids[0]
    for _ in range(5):
        row = np.asarray(psvc.forecast(mid, 1).means)
        jsvc.update(mid, row)
        psvc.update(mid, row)
    assert psvc.smoothed(mid).lag == 4
    spike = row.copy()
    spike[0, 1] += 100.0
    jsvc.update(mid, spike)
    psvc.update(mid, spike)
    assert psvc.gate_verdicts.snapshot().get("rejected", 0) >= 1
    for svc in (jsvc, psvc):
        with pytest.raises(ValueError, match="empty"):
            svc.smoothed(mid)
    for _ in range(2):
        row = np.asarray(psvc.forecast(mid, 1).means)
        jsvc.update(mid, row)
        psvc.update(mid, row)
    got, want = psvc.smoothed(mid), jsvc.smoothed(mid)
    assert got.lag == want.lag == 2
    assert _rel(got.means, want.means) <= 1e-10
    jsvc.close()
    psvc.close()


def test_smoothed_requires_arming_and_tracking():
    preg = ModelRegistry(root=None)
    preg.put(_state(PosteriorState, 43), persist=False)
    svc = MetranService(preg, flush_deadline=None, device="cpu")
    assert svc.smoother is None and "fixed_lag" not in svc.health()
    with pytest.raises(ValueError, match="disabled"):
        svc.smoothed("m43")
    svc.close()
    svc2 = MetranService(preg, flush_deadline=None, fixed_lag=4,
                         device="cpu")
    with pytest.raises(KeyError):
        svc2.smoothed("m43")  # no updates streamed yet
    with pytest.raises(KeyError):
        svc2.smoothed("nope")  # an unknown model stays a KeyError
    svc2.close()
    with pytest.raises(ValueError, match=">= 1"):
        FixedLagTracker(0, device="cpu")


def test_tracker_dump_restore_and_advance():
    """The tracker alone: a restart on a t_seen gap, the anchor advancing
    through the replay, and dump/restore reproducing the window."""
    st = _state(PosteriorState, 47)
    tr = FixedLagTracker(3, device="cpu")
    rng = np.random.default_rng(48)
    tr.observe("m", np.zeros((1, N)), np.ones((1, N), bool),
               st.t_seen + 1, lambda: st._replace(t_seen=st.t_seen + 1))
    assert tr.tracking("m") and len(tr) == 1
    rows = rng.normal(size=(5, N))
    for i in range(5):
        tr.observe("m", rows[i][None], np.ones((1, N), bool),
                   st.t_seen + 2 + i, lambda: None)
    win = tr.smooth("m")
    assert win.lag == 3 and win.t_end == st.t_seen + 6
    copy = FixedLagTracker(3, device="cpu")
    copy.restore(tr.dump())
    again = copy.smooth("m")
    for field in ("means", "variances", "state_means"):
        assert np.array_equal(getattr(again, field), getattr(win, field))
    # a gap in t_seen restarts the window from the posterior given
    tr.observe("m", rows[0][None], np.ones((1, N), bool), st.t_seen + 50,
               lambda: st._replace(t_seen=st.t_seen + 50))
    with pytest.raises(ValueError, match="empty"):
        tr.smooth("m")
    tr.forget("m")
    assert not tr.tracking("m")
