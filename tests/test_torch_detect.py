"""Port parity: streaming detection (``metran_tpu_torch.ops.detect``, the
plain version of kernel K13 on CPU tensors), the serving specs that arm
the gate and the detector, and the alert board — each against the JAX
package's twin on the same inputs, f64 on the CPU.

Bars: the detector state and ``detect_stats`` to 1e-12 (relative to
each row's largest entry; both sides run the same elementwise
recursion), alarm counts equal; the specs and the alert board
(host code) field for field.
"""

import numpy as np
import pytest
import torch

from metran_tpu.ops import detect as jdet
from metran_tpu.serve import engine as jeng
from metran_tpu.serve import monitoring as jmon
from metran_tpu_torch.ops import detect as pdet
from metran_tpu_torch.serve import engine as peng
from metran_tpu_torch.serve import monitoring as pmon

torch.set_num_threads(1)

KW = dict(cusum_k=0.5, cusum_h=8.0, lb_window=24, lb_thresh=9.0,
          nsigma=3.0)


def _streams(seed, k=150, n=4):
    """Clean, level-shifted and autocorrelated z-score streams, with
    NaNs and masked cells."""
    rng = np.random.default_rng(seed)
    clean = rng.normal(size=(k, n))
    shifted = clean.copy()
    shifted[k // 2:, 1] += 3.0
    ar = clean.copy()
    for t in range(1, k):
        ar[t] = 0.9 * ar[t - 1] + 0.45 * clean[t]
    out = []
    for zs in (clean, shifted, ar):
        zs = zs.copy()
        mask = rng.uniform(size=zs.shape) > 0.1
        zs[::13, 2] = np.nan
        out.append((np.where(mask, zs, np.nan), mask))
    return out


def _rel(got, want):
    want = np.asarray(want)
    scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1e-300)
    return float((np.abs(got - want) / scale).max())


@pytest.mark.parametrize("which", [0, 1, 2])
def test_detect_append_and_stats_match_jax(which):
    zs, mask = _streams(3)[which]
    state0 = np.zeros((6, zs.shape[1]))
    # two appends carry the state across calls, as the service does
    j_state, j_counts = jdet.detect_append(state0, zs[:70], mask[:70], **KW)
    j_state, j_c2 = jdet.detect_append(j_state, zs[70:], mask[70:], **KW)
    p_state, p_counts = pdet.detect_append(
        pdet.detect_init(zs.shape[1], device="cpu"), zs[:70], mask[:70],
        **KW)
    p_state, p_c2 = pdet.detect_append(p_state, zs[70:], mask[70:], **KW)
    assert p_counts.dtype == torch.int32
    np.testing.assert_array_equal(p_counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(p_c2.numpy(), np.asarray(j_c2))
    assert _rel(p_state.numpy(), j_state) <= 1e-12
    assert _rel(pdet.detect_stats(p_state).numpy(),
                jdet.detect_stats(j_state)) <= 1e-12
    total = p_counts + p_c2
    if which == 1:  # the shift raised CUSUM alarms on its slot
        assert total[1, 1] >= 1
    if which == 2:  # serial structure raised the LB statistic's alarm
        assert total[2].sum() >= 1


def test_disarmed_masked_and_nan_steps_change_nothing():
    zs, mask = _streams(4)[1]
    state, _ = pdet.detect_append(pdet.detect_init(4, device="cpu"), zs[:40],
                                  mask[:40], **KW)
    for args in ((zs[40:60], mask[40:60], False),
                 (zs[40:60], np.zeros_like(mask[40:60]), True),
                 (np.full_like(zs[40:60], np.nan), mask[40:60], True)):
        new, counts = pdet.detect_append(state, *args, **KW)
        assert torch.equal(new, state) and not counts.any()
    # a batch: per-model armed flags, one call
    batch = torch.stack([state, state])
    new, counts = pdet.detect_append(
        batch, np.stack([zs[40:60]] * 2), np.stack([mask[40:60]] * 2),
        armed=torch.tensor([True, False]), **KW)
    one, c1 = pdet.detect_append(state, zs[40:60], mask[40:60], **KW)
    assert torch.equal(new[0], one) and torch.equal(counts[0], c1)
    assert torch.equal(new[1], state) and not counts[1].any()
    with pytest.raises(ValueError, match="lag"):
        pdet.detect_append(state, zs[:2], mask[:2], lb_window=1)


def test_specs_ship_off_and_validate_as_jax(monkeypatch):
    for key in [k for k in list(__import__("os").environ)
                if k.startswith("METRAN_TPU_SERVE_")]:
        monkeypatch.delenv(key)
    assert peng.GateSpec.from_defaults() == jeng.GateSpec.from_defaults()
    assert not peng.GateSpec.from_defaults().enabled
    assert peng.DetectSpec.from_defaults() == jeng.DetectSpec.from_defaults()
    assert not peng.DetectSpec.from_defaults().enabled
    monkeypatch.setenv("METRAN_TPU_SERVE_GATE_POLICY", "huber")
    monkeypatch.setenv("METRAN_TPU_SERVE_GATE_NSIGMA", "3.5")
    monkeypatch.setenv("METRAN_TPU_SERVE_DETECT", "1")
    monkeypatch.setenv("METRAN_TPU_SERVE_DETECT_LB_WINDOW", "32")
    monkeypatch.setenv("METRAN_TPU_SERVE_DETECT_MIN_SEEN", "7")
    gate, det = peng.GateSpec.from_defaults(), peng.DetectSpec.from_defaults()
    assert tuple(gate) == tuple(jeng.GateSpec.from_defaults())
    assert tuple(det) == tuple(jeng.DetectSpec.from_defaults())
    assert gate.enabled and gate.nsigma == 3.5
    assert det.enabled and det.lb_window == 32 and det.min_seen == 7
    assert det.kernel_params == jeng.DetectSpec(*det).kernel_params
    bad = [(peng.GateSpec, jeng.GateSpec, dict(policy="clip")),
           (peng.GateSpec, jeng.GateSpec, dict(policy="reject", nsigma=0.0)),
           (peng.DetectSpec, jeng.DetectSpec, dict(enabled=True,
                                                   lb_window=1)),
           (peng.DetectSpec, jeng.DetectSpec, dict(enabled=True,
                                                   cusum_h=0.0)),
           (peng.DetectSpec, jeng.DetectSpec, dict(enabled=True,
                                                   min_seen=-1)),
           (peng.DetectSpec, jeng.DetectSpec, dict(enabled=True,
                                                   nsigma=0.0))]
    for pcls, jcls, kw in bad:
        with pytest.raises(ValueError):
            jcls(**kw).validate()
        with pytest.raises(ValueError):
            pcls(**kw).validate()
    # an unarmed detector is never rejected, whatever its thresholds
    assert peng.DetectSpec(enabled=False, lb_window=1).validate()


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_alert_board_raise_clear_and_flap_suppression():
    """The same alarm sequence on a fake clock through both boards: the
    raise, the absorbed alarms, the anomaly bar, the clear after the
    cooldown, the suppressed flap and the fresh raise after it."""
    clocks = _Clock(), _Clock()
    boards = (pmon.AlertBoard(cooldown_s=10.0, clock=clocks[0]),
              jmon.AlertBoard(cooldown_s=10.0, clock=clocks[1]))
    script = [(0.0, "m0", "changepoint", 1, ("s1",)),
              (1.0, "m0", "changepoint", 2, ("s2",)),
              (2.0, "m1", "anomaly", 1, ("s0",)),  # below the bar
              (3.0, "m1", "anomaly", 1, ("s0",)),  # raises
              (15.0, None, None, 0, ()),  # both quiet past the cooldown
              (16.0, "m0", "changepoint", 1, ("s1",)),  # flap: suppressed
              (40.0, None, None, 0, ()),
              (45.0, "m0", "changepoint", 1, ("s3",))]  # a new episode
    for dt, mid, kind, count, slots in script:
        outs = []
        for clock, board in zip(clocks, boards):
            clock.t = 100.0 + dt
            if mid is None:
                outs.append(board.sweep())
            else:
                raised = board.note(mid, kind, count, slots)
                outs.append(None if raised is None else raised.as_dict())
        assert outs[0] == outs[1], (dt, outs)
        assert boards[0].stats() == boards[1].stats()
        assert (boards[0].alerts(active_only=False)
                == boards[1].alerts(active_only=False))
    assert boards[0].stats() == {"active": 1, "raised_total": 3,
                                 "cleared_total": 3, "suppressed_total": 1}


def test_detector_mirror_resets_on_a_version_gap():
    mirror, jmirror = pmon.DetectorMirror(), jmon.DetectorMirror()
    state = np.arange(12.0).reshape(6, 2)
    stats = np.ones((3, 2))
    for m in (mirror, jmirror):
        m.commit("a", 1, 10, 2, stats, np.array([1, 0, 0]), state=state,
                 slots=("s0",))
        m.commit("a", 2, 11, 2, stats, np.array([0, 1, 0]), state=state)
    assert mirror.snapshot() == jmirror.snapshot()
    np.testing.assert_array_equal(mirror.stack(["a", "b"], [2, 0], 3, 6,
                                               float),
                                  jmirror.stack(["a", "b"], [2, 0], 3, 6,
                                                float))
    # an external put (version 5 != 2): the evidence restarts at zeros
    assert not mirror.stack(["a"], [5], 2, 6, float).any()
    for m in (mirror, jmirror):
        m.commit("a", 6, 12, 2, stats, np.array([0, 0, 1]), state=state)
    assert mirror.snapshot() == jmirror.snapshot()
    assert mirror.snapshot()["a"]["lb_alarms"] == 1
    assert mirror.snapshot()["a"]["cusum_alarms"] == 0
