"""Port parity: ``metran_tpu_torch.ops.forecast`` (the plain version of
kernel K2 on CPU tensors) against the JAX ``metran_tpu.ops.forecast``,
f64 on the CPU.

Tolerance ``rtol=1e-12, atol=1e-14``: both sides evaluate the same
closed form (log/exp/expm1 elementwise, then Z P_h Z' reductions whose
summation order differs).
"""

import numpy as np
import pytest
import torch

from conftest import random_ssm
from metran_tpu.ops import forecast as jf
from metran_tpu.ops import kalman as jk
from metran_tpu.ops import statespace as jss
from metran_tpu_torch.ops import forecast as pf
from metran_tpu_torch.ops.statespace import StateSpace

TOL = dict(rtol=1e-12, atol=1e-14)


def _port_ss(ss):
    return StateSpace(*(torch.as_tensor(np.array(leaf)) for leaf in ss))


def _posterior(ss, y, mask):
    res = jk.kalman_filter(ss, y, mask, engine="joint", store=False)
    return np.array(res.mean_f), np.array(res.cov_f)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("h_max", [1, 14, 90])
@pytest.mark.parametrize("n_series,n_factors", [(5, 1), (7, 2)])
def test_forecast_observation_moments_parity(h_max, n_series, n_factors):
    rng = np.random.default_rng(60 + h_max + n_series)
    ss, y, mask = random_ssm(rng, n_series, n_factors, t=200)
    m, c = _posterior(ss, y, mask)
    hz = np.arange(1, h_max + 1)
    want = jf.forecast_observation_moments(ss, m, c, hz)
    got = pf.forecast_observation_moments(_port_ss(ss), m, c, hz,
                                          device="cpu")
    _close(got, want)
    assert got[0].shape == (h_max, n_series)


@pytest.mark.parametrize("h_max", [1, 14, 90])
def test_forecast_horizons_parity_at_arbitrary_horizon_sets(h_max):
    rng = np.random.default_rng(70 + h_max)
    ss, y, mask = random_ssm(rng, 4, 1, t=100)
    m, c = _posterior(ss, y, mask)
    hz = np.unique(np.concatenate([[1], rng.integers(1, h_max + 1, 5)]))
    want = jf.forecast_horizons(ss, m, c, hz, sqrt=False)
    got = pf.forecast_horizons(_port_ss(ss), m, c, hz, device="cpu")
    _close(got, want)


def test_forecast_state_moments_parity():
    rng = np.random.default_rng(80)
    ss, y, mask = random_ssm(rng, 5, 2, t=100)
    m, c = _posterior(ss, y, mask)
    hz = np.arange(1, 15)
    want = jf.forecast_state_moments(ss, m, c, hz)
    got = pf.forecast_state_moments(_port_ss(ss), m, c, hz, device="cpu")
    _close(got, want)


@pytest.mark.parametrize("h_max", [14, 90])
def test_near_unit_root_forecast_parity(h_max):
    # alpha ~ 3e4: pp -> 1 where the literal (1 - pp^h)/(1 - pp) loses
    # its digits; both sides use the expm1 form
    a_s = np.array([3e4, 12.0, 25.0])
    a_c = np.array([3e4])
    lds = np.array([[0.6], [0.5], [0.7]])
    ss = jss.dfm_statespace(a_s, a_c, lds)
    rng = np.random.default_rng(90)
    y = rng.normal(size=(80, 3))
    mask = rng.uniform(size=(80, 3)) > 0.2
    m, c = _posterior(ss, np.where(mask, y, 0.0), mask)
    hz = np.arange(1, h_max + 1)
    want = jf.forecast_observation_moments(ss, m, c, hz)
    got = pf.forecast_observation_moments(_port_ss(ss), m, c, hz,
                                          device="cpu")
    _close(got, want)


def test_unit_root_pp_one_guard():
    # one phi exactly 1: its pp == 1 entry takes the limit h * q
    phi = np.array([1.0, 0.9, 0.8])
    q = np.diag([0.1, 0.2, 0.3])
    z = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.4]])
    r = np.array([0.0, 0.05])
    ss = jss.StateSpace(phi=phi, q=q, z=z, r=r)
    m = np.array([0.3, -0.2, 0.1])
    c = np.array([[0.5, 0.1, 0.0], [0.1, 0.4, 0.05], [0.0, 0.05, 0.3]])
    hz = np.arange(1, 15)
    want = jf.forecast_observation_moments(ss, m, c, hz)
    got = pf.forecast_observation_moments(_port_ss(ss), m, c, hz,
                                          device="cpu")
    _close(got, want)
    _, cov_h = pf.forecast_state_moments(_port_ss(ss), m, c, hz,
                                         device="cpu")
    np.testing.assert_allclose(
        cov_h[:, 0, 0].numpy(), c[0, 0] + hz * q[0, 0], rtol=1e-14
    )


def test_batched_forecast_matches_per_model():
    rng = np.random.default_rng(95)
    models = [random_ssm(rng, 4, 1, t=60) for _ in range(3)]
    posts = [_posterior(*mdl) for mdl in models]
    pss = [_port_ss(ss) for ss, _, _ in models]
    stacked = StateSpace(*(torch.stack(leaves) for leaves in zip(*pss)))
    means = np.stack([p[0] for p in posts])
    covs = np.stack([p[1] for p in posts])
    hz = np.arange(1, 15)
    bm, bv = pf.forecast_observation_moments(stacked, means, covs, hz,
                                             device="cpu")
    for i, ((ss, _, _), (m, c)) in enumerate(zip(models, posts)):
        wm, wv = jf.forecast_observation_moments(ss, m, c, hz)
        np.testing.assert_allclose(bm[i].numpy(), np.asarray(wm), **TOL)
        np.testing.assert_allclose(bv[i].numpy(), np.asarray(wv), **TOL)


def test_sqrt_horizons_raise_until_ported():
    # ported with the square-root engine: the factor form is its
    # ``fac fac'`` ahead of K2, as in the JAX function
    rng = np.random.default_rng(99)
    ss, y, mask = random_ssm(rng, 3, 1, t=10)
    res = jk.sqrt_kalman_filter(ss, y, mask, store=False)
    m, c = np.array(res.mean_f), np.array(res.chol_f)
    want = jf.forecast_horizons(ss, m, c, np.array([1, 2]), sqrt=True)
    _close(pf.forecast_horizons(_port_ss(ss), m, c, [1, 2], sqrt=True,
                                device="cpu"), want)
