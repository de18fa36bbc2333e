"""Port parity: the square-root engine of ``metran_tpu.ops.kalman`` —
``sqrt_kalman_filter`` (kernel K9, with and without its store),
``sqrt_rts_smoother`` (K10), ``sqrt_filter_update``/``sqrt_filter_append``
(K9 from a given carry), ``kalman_filter``/``deviance``/``rts_smoother``/
``sample_states`` on ``engine="sqrt"`` and ``forecast_horizons(sqrt=True)``
— on the kernels' plain versions, f64 on the CPU, against the JAX
functions.

Bars: rtol 1e-10 / atol 1e-12 on moments and factors.  A filtered or
smoothed factor is compared through the covariance it stands for
(``S S'``): with ``r = 0`` an observed direction is known exactly, the
factor is rank-deficient, and its columns past a zero pivot are any
orthonormal completion — two QR implementations pick different ones
from their roundoff.  The predicted factors have full rank (``q > 0``)
and are compared entrywise.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import random_ssm

import metran_tpu
from metran_tpu.ops import forecast as jf
from metran_tpu.ops import kalman as jk
from metran_tpu_torch.ops import dfm_statespace
from metran_tpu_torch.ops import forecast as pf
from metran_tpu_torch.ops import kalman as pk
from metran_tpu_torch.ops.statespace import StateSpace

# the plain versions make thousands of tiny LAPACK calls; with several
# test processes on one host, torch's OpenMP threads oversubscribe the
# cores, so a test process keeps torch to one thread
torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)


def _port_ss(ss):
    return StateSpace(*(torch.as_tensor(np.array(leaf)) for leaf in ss))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, **tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **(tol or TOL))


def _outer(chol):
    chol = _np(chol)
    return chol @ np.swapaxes(chol, -1, -2)


@pytest.fixture()
def panel():
    """A random DFM panel with an all-masked first step (random_ssm's)
    and a fully masked series."""
    rng = np.random.default_rng(31)
    ss, y, mask = random_ssm(rng, 5, 2, t=120)
    mask[:, 3] = False
    y = np.where(mask, y, 0.0)
    return ss, y, mask


def test_sqrt_kalman_filter_store_and_carry_match_jax(panel):
    ss, y, mask = panel
    pss = _port_ss(ss)
    want = jk.sqrt_kalman_filter(ss, y, mask, store=True)
    got = pk.sqrt_kalman_filter(pss, y, mask, store=True, device="cpu")
    assert isinstance(got, pk.SqrtFilterResult)
    for name in ("mean_p", "chol_p", "mean_f", "sigma", "detf"):
        _close(getattr(got, name), getattr(want, name))
    _close(_outer(got.chol_f), _outer(want.chol_f))
    # lower-triangular factors with a non-negative diagonal
    assert np.all(np.triu(_np(got.chol_f), 1) == 0)
    assert np.all(np.diagonal(_np(got.chol_p), 0, -2, -1) > 0)
    carry = pk.sqrt_kalman_filter(pss, y, mask, store=False, device="cpu")
    want_c = jk.sqrt_kalman_filter(ss, y, mask, store=False)
    _close(carry.mean_f, want_c.mean_f)
    _close(_outer(carry.chol_f), _outer(want_c.chol_f))
    _close(carry.sigma, want_c.sigma)
    _close(carry.detf, want_c.detf)
    # kalman_filter(engine="sqrt") reconstitutes the covariances
    for store in (True, False):
        kw = jk.kalman_filter(ss, y, mask, engine="sqrt", store=store)
        kg = pk.kalman_filter(pss, y, mask, engine="sqrt", store=store,
                              device="cpu")
        for g, w in zip(kg, kw):
            _close(g, w)
    # a batch of two models is one call with one lane each
    both = pk.sqrt_kalman_filter(
        StateSpace(*(torch.stack([leaf, leaf]) for leaf in pss)),
        np.stack([y, y]), np.stack([mask, mask]), device="cpu")
    _close(both.mean_f[1], want.mean_f)


def test_sqrt_rts_smoother_and_dispatch_match_jax(panel):
    ss, y, mask = panel
    pss = _port_ss(ss)
    filt_j = jk.sqrt_kalman_filter(ss, y, mask)
    filt_p = pk.sqrt_kalman_filter(pss, y, mask, device="cpu")
    want = jk.sqrt_rts_smoother(ss, filt_j)
    got = pk.sqrt_rts_smoother(pss, filt_p)
    assert isinstance(got, pk.SqrtSmootherResult)
    _close(got.mean_s, want.mean_s)
    _close(_outer(got.chol_s), _outer(want.chol_s))
    # rts_smoother dispatches on the factored result and reconstitutes
    sm_w = jk.rts_smoother(ss, filt_j, engine="sqrt")
    sm_p = pk.rts_smoother(pss, filt_p, engine="sqrt")
    _close(sm_p.mean_s, sm_w.mean_s)
    _close(sm_p.cov_s, sm_w.cov_s)
    # the factored smoother agrees with the covariance smoother (K8)
    seq = pk.rts_smoother(pss, pk.kalman_filter(
        pss, y, mask, engine="sequential", store=True, device="cpu"))
    _close(sm_p.mean_s, seq.mean_s, rtol=1e-8, atol=1e-10)
    _close(sm_p.cov_s, seq.cov_s, rtol=1e-8, atol=1e-10)


def test_sqrt_update_and_append_match_jax(panel):
    ss, y, mask = panel
    pss = _port_ss(ss)
    full = jk.sqrt_kalman_filter(ss, y, mask)
    m0 = np.asarray(full.mean_f[99])
    # any factor of the covariance will do: a rotated (non-triangular)
    # one is re-triangularized by the first predict
    rot = np.linalg.qr(np.random.default_rng(2).normal(size=(7, 7)))[0]
    c0 = np.asarray(full.chol_f[99]) @ rot
    want = jk.sqrt_filter_update(ss, m0, c0, y[100], mask[100])
    got = pk.sqrt_filter_update(pss, m0, c0, y[100], mask[100],
                                device="cpu")
    _close(got[0], want[0])
    _close(_outer(got[1]), _outer(want[1]))
    _close(got[2], want[2])
    _close(got[3], want[3])
    want = jk.sqrt_filter_append(ss, m0, c0, y[100:], mask[100:])
    got = pk.sqrt_filter_append(pss, m0, c0, y[100:], mask[100:],
                                device="cpu")
    _close(got[0], want[0])
    _close(_outer(got[1]), _outer(want[1]))
    _close(got[2], want[2])
    _close(got[3], want[3])
    _close(got[0], full.mean_f[-1])
    # the covariance-form append refuses the square-root engine
    with pytest.raises(ValueError, match="sqrt_filter_append"):
        pk.filter_append(pss, m0, _outer(c0), y[100:], mask[100:],
                         engine="sqrt", device="cpu")


def test_golden_sqrt_deviances_of_the_reference_example(series_list):
    """The reference's deviance at its initial parameters and at three
    random parameter vectors (``tests/golden/metran_example.json``) on
    the square-root engine: one K9 batch of four lanes."""
    golden = json.loads(
        (Path(__file__).parent / "golden" / "metran_example.json").read_text())
    m = metran_tpu.Metran(series_list, name="B21B0214", engine="sequential")
    m.factors = np.array(golden["factors"])
    m.nfactors = m.factors.shape[1]
    m._init_kalmanfilter()
    m.set_init_parameters()
    n = m.nseries
    params = np.array([golden["p_init"]]
                      + [case["p"] for case in golden["deviance_at_random"]])
    want = [golden["deviance_at_init"]] + [
        case["deviance"] for case in golden["deviance_at_random"]]
    b = len(params)
    y = np.broadcast_to(np.asarray(m.kf.y), (b,) + np.shape(m.kf.y))
    mask = np.broadcast_to(np.asarray(m.kf.mask), y.shape)
    ss = dfm_statespace(params[:, :n], params[:, n:],
                        np.broadcast_to(m.factors, (b,) + m.factors.shape),
                        float(m._dt), device="cpu")
    got = pk.deviance(ss, y, mask, warmup=m.settings["warmup"],
                      engine="sqrt", device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_sqrt_deviance_and_the_rejectable_step_match_jax(panel):
    ss, y, mask = panel
    pss = _port_ss(ss)
    for warmup in (0, 1, 5):
        want = float(jk.deviance(ss, y, mask, warmup=warmup, engine="sqrt"))
        got = float(pk.deviance(pss, y, mask, warmup=warmup, engine="sqrt",
                                device="cpu"))
        assert got == pytest.approx(want, rel=1e-10)
    # an observed slot with r < 0: sqrt(r) = NaN fails the step's `ok`,
    # which passes the state through and books detf = +inf
    bad = pss._replace(r=torch.full_like(pss.r, -2.0))
    assert float(pk.deviance(bad, y, mask, engine="sqrt",
                             device="cpu")) == np.inf
    res = pk.sqrt_kalman_filter(bad, y, mask, device="cpu")
    observed = mask.any(axis=1)
    assert np.all(_np(res.detf)[observed] == np.inf)
    assert np.all(_np(res.sigma)[observed] == 0)
    assert np.all(_np(res.detf)[~observed] == 0)
    _close(res.mean_f, res.mean_p)
    _close(res.chol_f, res.chol_p)


def test_sqrt_autodiff_gradient_matches_jax_and_adjoint_raises():
    # one factor: JAX's QR derivative goes through R^-1, and with two
    # factors (or a never-observed series) the r = 0 pre-array's R can be
    # singular enough for it to come out NaN, which is no reference
    rng = np.random.default_rng(5)
    _, y, mask = random_ssm(rng, 5, 1, t=120)
    a = rng.uniform(5.0, 40.0, 6)
    loadings = rng.uniform(0.3, 0.9, (5, 1))
    want = jax.grad(lambda p: jk.deviance(
        metran_tpu.ops.dfm_statespace(p[:5], p[5:], loadings),
        y, mask, engine="sqrt", grad="autodiff"))(jnp.asarray(a))
    p = torch.tensor(a, requires_grad=True)
    value = pk.deviance(dfm_statespace(p[:5], p[5:], loadings,
                                       device="cpu"),
                        y, mask, engine="sqrt", grad="autodiff",
                        device="cpu")
    (got,) = torch.autograd.grad(value, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    # the closed-form adjoint of the square-root deviance (B7: K9 with
    # segment boundaries, then K11; here their plain versions), which
    # float64 "auto" resolves to: the same value, bit for bit, and the
    # gradient of JAX's sqrt autodiff at the JAX package's adjoint bar
    # (tests/test_adjoint.py, rel 1e-10)
    for grad in ("adjoint", "auto"):
        q = torch.tensor(a, requires_grad=True)
        adj = pk.deviance(dfm_statespace(q[:5], q[5:], loadings,
                                         device="cpu"),
                          y, mask, engine="sqrt", grad=grad, device="cpu")
        assert float(adj) == float(value)
        (g_adj,) = torch.autograd.grad(adj, q)
        assert (np.linalg.norm(g_adj.numpy() - np.asarray(want))
                / np.linalg.norm(np.asarray(want))) < 1e-10
    free = pk.deviance(dfm_statespace(a[:5], a[5:], loadings, device="cpu"),
                       y, mask, engine="sqrt", grad="adjoint", device="cpu")
    assert float(free) == pytest.approx(float(value.detach()), rel=1e-14)


def _jax_normals(key, n_draws, t_steps, n, n_obs):
    """The normals ``metran_tpu.ops.kalman._sample_states`` draws: per
    draw key, ``x0``, ``w`` and ``e`` from its three-way split."""
    x0, w, e = [], [], []
    for k in jax.random.split(key, n_draws):
        k0, kw, ke = jax.random.split(k, 3)
        x0.append(np.asarray(jax.random.normal(k0, (n,), jnp.float64)))
        w.append(np.asarray(jax.random.normal(kw, (t_steps, n),
                                              jnp.float64)))
        e.append(np.asarray(jax.random.normal(ke, (t_steps, n_obs),
                                              jnp.float64)))
    return np.stack(x0), np.stack(w), np.stack(e)


def test_sample_states_sqrt_given_jax_normals_matches_jax():
    rng = np.random.default_rng(17)
    ss, y, mask = random_ssm(rng, 4, 1, t=60)
    key = jax.random.PRNGKey(3)
    n_draws = 5
    want = jk._sample_states(ss, y, mask, key, None, n_draws=n_draws,
                             engine="sqrt", draw_chunk=2)
    normals = _jax_normals(key, n_draws, 60, 5, 4)
    got = pk._sample_states_given(_port_ss(ss), y, mask, *normals,
                                  engine="sqrt", draw_chunk=2, device="cpu")
    assert got.shape == (n_draws, 60, 5)
    _close(got, want, rtol=1e-10, atol=1e-10)
    seq = pk._sample_states_given(_port_ss(ss), y, mask, *normals,
                                  engine="sequential", draw_chunk=2,
                                  device="cpu")
    _close(got, seq, rtol=1e-8, atol=1e-8)


def test_forecast_horizons_sqrt_matches_jax(panel):
    ss, y, mask = panel
    filt = jk.sqrt_kalman_filter(ss, y, mask)
    m, c = np.asarray(filt.mean_f[-1]), np.asarray(filt.chol_f[-1])
    hz = np.array([1, 3, 7, 30])
    want = jf.forecast_horizons(ss, m, c, jnp.asarray(hz), sqrt=True)
    got = pf.forecast_horizons(_port_ss(ss), m, c, hz, sqrt=True,
                               device="cpu")
    for g, w in zip(got, want):
        _close(g, w)
    cov = pf.forecast_horizons(_port_ss(ss), m, _outer(c), hz, device="cpu")
    for g, w in zip(got, cov):
        _close(g, w)
