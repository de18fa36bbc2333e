"""Port parity: the observation gate of ``metran_tpu_torch.ops`` (the
plain versions of kernel K12 and of K9's gated instantiation, on CPU
tensors) against the JAX package's ``gated_filter_append`` /
``gated_sqrt_filter_append``, f64 on the CPU.

Bars: posteriors and likelihood terms 1e-12 (relative to each array's
largest entry; the two sides run the same recursion with different
matmul/QR codes), square-root factors compared through ``S S'`` (a
factor is not unique under r = 0), z-scores 1e-12 and NaN-strict,
verdicts equal.  The bit-exactness contracts (gate off, or armed but
never tripping, against the ungated update) are held with
``torch.equal`` inside the port.
"""

import numpy as np
import pytest
import torch

from metran_tpu import ops as jops
from metran_tpu.reliability.scenarios import simulate_dfm_panel
from metran_tpu_torch import ops as pops
from metran_tpu_torch.ops.statespace import StateSpace

torch.set_num_threads(1)

POLICIES = ("reject", "huber", "inflate")
BAR = 1e-12


def _port_ss(ss):
    return StateSpace(*(torch.as_tensor(np.array(leaf)) for leaf in ss))


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    if not fin.any():
        return 0.0
    scale = max(np.abs(want[fin]).max(), 1e-300)
    return float(np.abs(got[fin] - want[fin]).max() / scale)


def _stream(seed, n=5, k_fct=1, t_hist=120, k_app=6, missing=0.2,
            spikes=((0, 2, 8.0), (3, 0, -9.0))):
    """A DFM, its filtered carry after a model-simulated history, and
    ``k_app`` appended rows with spikes injected on known cells."""
    rng = np.random.default_rng(seed)
    loadings = rng.uniform(0.3, 0.8, (n, k_fct)) / np.sqrt(k_fct)
    ss = jops.dfm_statespace(rng.uniform(5.0, 40.0, n),
                             rng.uniform(10.0, 60.0, k_fct), loadings, 1.0)
    _, y_all, m_all = simulate_dfm_panel(ss, t_hist + k_app, rng,
                                         missing_p=missing)
    y_hist = np.where(m_all[:t_hist], y_all[:t_hist], 0.0)
    res = jops.kalman_filter(ss, y_hist, m_all[:t_hist],
                             engine="sequential")
    sres = jops.sqrt_kalman_filter(ss, y_hist, m_all[:t_hist])
    y_new, m_new = y_all[t_hist:].copy(), m_all[t_hist:].copy()
    for row, col, size in spikes:
        m_new[row, col] = True
        y_new[row, col] += size
    y_new = np.where(m_new, y_new, 0.0)
    carry = (np.asarray(res.mean_f[-1]), np.asarray(res.cov_f[-1]))
    scarry = (np.asarray(sres.mean_f[-1]), np.asarray(sres.chol_f[-1]))
    return ss, carry, scarry, y_new, m_new


def _bitequal(got, want, n=4):
    for g, w in zip(got[:n], want[:n]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("policy", ("off",) + POLICIES)
def test_gated_filter_append_matches_jax(policy):
    ss, (m0, c0), _, y_new, m_new = _stream(1)
    want = jops.gated_filter_append(ss, m0, c0, y_new, m_new,
                                    policy=policy, nsigma=4.0)
    got = pops.gated_filter_append(_port_ss(ss), m0, c0, y_new, m_new,
                                   policy=policy, nsigma=4.0, device="cpu")
    for g, w in zip(got[:5], want[:5]):
        assert _rel(g, w) <= BAR
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    assert got[5].dtype == torch.int8
    if policy != "off":  # the spikes trip the gate where they were put
        assert got[5][0, 2] != 0 and got[5][3, 0] != 0


@pytest.mark.parametrize("policy", ("off",) + POLICIES)
def test_gated_sqrt_filter_append_matches_jax(policy):
    ss, _, (m0, s0), y_new, m_new = _stream(2)
    want = jops.gated_sqrt_filter_append(ss, m0, s0, y_new, m_new,
                                         policy=policy, nsigma=4.0)
    got = pops.gated_sqrt_filter_append(_port_ss(ss), m0, s0, y_new, m_new,
                                        policy=policy, nsigma=4.0,
                                        device="cpu")
    assert _rel(got[0], want[0]) <= BAR
    w_fac = np.asarray(want[1])
    assert _rel(got[1] @ got[1].T, w_fac @ w_fac.T) <= BAR
    for g, w in zip(got[2:5], want[2:5]):
        assert _rel(g, w) <= BAR
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    if policy != "off":
        assert got[5][0, 2] != 0 and got[5][3, 0] != 0


def test_off_is_the_sequential_filter_append_and_matches_jax():
    ss, (m0, c0), _, y_new, m_new = _stream(3)
    pss = _port_ss(ss)
    seq = pops.filter_append(pss, m0, c0, y_new, m_new, device="cpu")
    off = pops.gated_filter_append(pss, m0, c0, y_new, m_new, policy="off",
                                   device="cpu")
    _bitequal(off, seq)
    assert torch.isnan(off[4]).all() and not off[5].any()
    # the default engine is the JAX function's, "sequential"
    want = jops.filter_append(ss, m0, c0, y_new, m_new)
    for g, w in zip(seq, want):
        assert _rel(g, w) <= BAR


@pytest.mark.parametrize("policy", POLICIES)
def test_armed_gate_that_never_trips_is_bit_identical(policy):
    ss, (m0, c0), (sm0, s0), y_new, m_new = _stream(4)
    pss = _port_ss(ss)
    base = pops.filter_append(pss, m0, c0, y_new, m_new, device="cpu")
    sbase = pops.sqrt_filter_append(pss, sm0, s0, y_new, m_new,
                                    device="cpu")
    # nsigma = inf: armed on spiked data, and no slot can trip
    got = pops.gated_filter_append(pss, m0, c0, y_new, m_new, policy=policy,
                                   nsigma=float("inf"), device="cpu")
    _bitequal(got, base)
    assert not got[5].any()
    sgot = pops.gated_sqrt_filter_append(pss, sm0, s0, y_new, m_new,
                                         policy=policy, nsigma=float("inf"),
                                         device="cpu")
    _bitequal(sgot, sbase)
    assert not sgot[5].any()
    # clean model data under a wide gate: armed, silent, bit-identical
    ss, (m0, c0), (sm0, s0), y_new, m_new = _stream(5, spikes=())
    pss = _port_ss(ss)
    got = pops.gated_filter_append(pss, m0, c0, y_new, m_new, policy=policy,
                                   nsigma=6.0, device="cpu")
    assert not got[5].any()
    _bitequal(got, pops.filter_append(pss, m0, c0, y_new, m_new,
                                      device="cpu"))
    sgot = pops.gated_sqrt_filter_append(pss, sm0, s0, y_new, m_new,
                                         policy=policy, nsigma=6.0,
                                         device="cpu")
    assert not sgot[5].any()
    _bitequal(sgot, pops.sqrt_filter_append(pss, sm0, s0, y_new, m_new,
                                            device="cpu"))


def test_reject_equals_masking_on_both_engines():
    ss, (m0, c0), (sm0, s0), y_new, m_new = _stream(6)
    pss = _port_ss(ss)
    got = pops.gated_filter_append(pss, m0, c0, y_new, m_new,
                                   policy="reject", nsigma=5.0, device="cpu")
    kept = torch.as_tensor(m_new) & (got[5] != pops.GATE_REJECTED)
    assert (got[5] == pops.GATE_REJECTED).sum() >= 2
    ref = pops.filter_append(pss, m0, c0, y_new, kept, device="cpu")
    for g, w in zip(got[:4], ref):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-13)
    sgot = pops.gated_sqrt_filter_append(pss, sm0, s0, y_new, m_new,
                                         policy="reject", nsigma=5.0,
                                         device="cpu")
    kept = torch.as_tensor(m_new) & (sgot[5] != pops.GATE_REJECTED)
    sref = pops.sqrt_filter_append(pss, sm0, s0, y_new, kept, device="cpu")
    torch.testing.assert_close(sgot[0], sref[0], rtol=1e-12, atol=1e-13)
    torch.testing.assert_close(sgot[1] @ sgot[1].T, sref[1] @ sref[1].T,
                               rtol=1e-12, atol=1e-13)
    torch.testing.assert_close(sgot[2], sref[2], rtol=1e-12, atol=1e-13)


def test_huber_and_inflate_lie_between_reject_and_full():
    # one spike: its clipped influence puts the posterior closer to the
    # rejection posterior than full assimilation of the spike is
    ss, (m0, c0), (sm0, s0), y_new, m_new = _stream(7, spikes=((0, 2, 8.0),))
    pss = _port_ss(ss)
    for fn, base, carry in (
            (pops.gated_filter_append, pops.filter_append, (m0, c0)),
            (pops.gated_sqrt_filter_append, pops.sqrt_filter_append,
             (sm0, s0))):
        args = (pss, *carry, y_new, m_new)
        m_full = base(*args, device="cpu")[0]
        m_rej = fn(*args, policy="reject", nsigma=5.0, device="cpu")[0]
        for policy in ("huber", "inflate"):
            got = fn(*args, policy=policy, nsigma=5.0, device="cpu")
            assert (got[5] == pops.GATE_DOWNWEIGHTED).any(), policy
            assert (torch.linalg.norm(got[0] - m_rej)
                    < torch.linalg.norm(m_full - m_rej)), policy


def test_per_model_armed_in_a_batch():
    ss, (m0, c0), (sm0, s0), y_new, m_new = _stream(8)
    pss = _port_ss(ss)
    batch = StateSpace(*(torch.stack([leaf] * 3) for leaf in pss))
    armed = torch.tensor([True, False, True])
    y3, m3 = np.stack([y_new] * 3), np.stack([m_new] * 3)
    got = pops.gated_filter_append(batch, np.stack([m0] * 3),
                                   np.stack([c0] * 3), y3, m3, armed=armed,
                                   policy="reject", nsigma=4.0, device="cpu")
    one = pops.gated_filter_append(pss, m0, c0, y_new, m_new,
                                   policy="reject", nsigma=4.0, device="cpu")
    full = pops.filter_append(pss, m0, c0, y_new, m_new, device="cpu")
    assert got[5][0].any() and not got[5][1].any()
    for g, w in zip(got, one):
        torch.testing.assert_close(g[0], w, rtol=0, atol=0, equal_nan=True)
    for g, w in zip(got[:4], full):  # the disarmed model took the spikes
        torch.testing.assert_close(g[1], w, rtol=1e-13, atol=1e-14)
    sgot = pops.gated_sqrt_filter_append(
        batch, np.stack([sm0] * 3), np.stack([s0] * 3), y3, m3,
        armed=armed, policy="inflate", nsigma=4.0, device="cpu")
    assert sgot[5][2].any() and not sgot[5][1].any()
    # a padded slot (zero loadings, never observed) stays NaN / PASS
    pad = pss._replace(z=torch.cat([pss.z, torch.zeros(2, pss.z.shape[1],
                                                       dtype=pss.z.dtype)]),
                       r=torch.cat([pss.r, torch.zeros(2, dtype=pss.r.dtype)]))
    y_p = np.concatenate([y_new, np.zeros((y_new.shape[0], 2))], 1)
    m_p = np.concatenate([m_new, np.zeros((m_new.shape[0], 2), bool)], 1)
    got_p = pops.gated_filter_append(pad, m0, c0, y_p, m_p, policy="reject",
                                     nsigma=4.0, device="cpu")
    assert torch.isnan(got_p[4][:, -2:]).all() and not got_p[5][:, -2:].any()
    for g, w in zip(got_p[:4], one[:4]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_unknown_policy_raises():
    ss, (m0, c0), (sm0, s0), y_new, m_new = _stream(9)
    with pytest.raises(ValueError, match="policy"):
        pops.gated_filter_append(_port_ss(ss), m0, c0, y_new, m_new,
                                 policy="clip", device="cpu")
    with pytest.raises(ValueError, match="policy"):
        pops.gated_sqrt_filter_append(_port_ss(ss), sm0, s0, y_new, m_new,
                                      policy="clip", device="cpu")
