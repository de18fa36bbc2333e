"""The robust (implicit-MAP) update of ``metran_tpu_torch.ops`` — the
plain versions of K12's and K9's robust instantiations, on CPU tensors:
the scalar pieces (``log_ndtr``, the likelihoods' derivatives, the
Newton solve) against the JAX package's, the port's bit-exactness
contracts, and the semantic tests of ``tests/test_implicit_map.py``
mirrored (the updates' parity with JAX's ``implicit_map_*`` is in
``test_torch_implicit_map_parity.py``).

``log_ndtr`` and its derivatives against JAX's on a grid crossing both
segments of each dtype: f64 1e-13 / 1e-12 / 1e-10 (value, first, second
derivative, relative to ``max(|x|, 1)``), f32 1e-5 / 1e-4 / 1e-2 — the
second derivative ``r (-x - r)`` cancels, so the two libraries' ``erfc``
differences in their last bits grow by ``x^2``; the likelihoods'
derivatives against jitted JAX autodiff (whose fused arithmetic rounds
on its own) at 1e-14 / 1e-12 / 1e-9 in f64 and the f32 bars.  The bit-exactness
contracts (gaussian, disarmed, unrailed censored against the plain
update) are held with ``torch.equal`` inside the port, f32 and f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import log_ndtr as jax_log_ndtr

from metran_tpu import ops as jops
from metran_tpu.ops import implicit_map as jim
from metran_tpu.reliability.scenarios import simulate_dfm_panel
from metran_tpu_torch import ops as pops
from metran_tpu_torch.kernels import (
    robust_filter_append,
    sqrt_filter_robust,
)
from metran_tpu_torch.kernels import implicit_map as pim
from metran_tpu_torch.ops.statespace import StateSpace

torch.set_num_threads(1)

LIKELIHOODS = ("censored", "quantized", "huber_t")
BAR = 1e-10


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


# ----------------------------------------------------------------------
# the scalar pieces
# ----------------------------------------------------------------------
GRID = np.concatenate([np.linspace(-40.0, 12.0, 1041),
                       [-20.0, -19.999, -20.001, -10.0, -9.999, -10.001,
                        5.0, 4.999, 5.001, 8.0, 7.999, 8.001]])
GRID_BARS = {np.float64: (1e-13, 1e-12, 1e-10),
             np.float32: (1e-5, 1e-4, 1e-2)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_log_ndtr_and_its_derivatives_match_jax(dtype):
    x = GRID.astype(dtype)
    jx = jnp.asarray(x)
    g = jax.grad(lambda v: jnp.sum(jax_log_ndtr(v)))
    want = jax.jit(lambda v: (jax_log_ndtr(v), g(v),
                              jax.jvp(g, (v,), (jnp.ones_like(v),))[1]))(jx)
    xt = torch.as_tensor(x)
    f = pim.log_ndtr(xt)
    r = pim.mills(xt, f)
    got = (f, r, r * (-xt - r))
    for g_, w, bar in zip(got, want, GRID_BARS[dtype]):
        w = np.asarray(w)
        assert g_.dtype == xt.dtype
        err = np.abs(g_.numpy() - w) / np.maximum(np.abs(w), 1.0)
        assert err.max() <= bar, (dtype, err.max(), bar)


def _points(seed, n, dtype):
    """Points across both rails, the reflection and the tails: in f64
    down to tail arguments of about -100; in f32 to about -25, below
    which the second derivative's cancellation leaves f32 no digits
    (JAX's and the port's f32 values there are both ~10% off the f64
    value, each in its own way)."""
    rng = np.random.default_rng(seed)
    spread = 3.0 if dtype == np.float64 else 1.5
    s = (rng.normal(size=n) * spread).astype(dtype)
    y = (rng.normal(size=n) * 2.0).astype(dtype)
    sig = 0.1 if dtype == np.float64 else 0.2
    par = dict(sig=np.full(n, sig, dtype), quantum=np.full(n, 0.3, dtype),
               lo=np.full(n, -1.0, dtype), hi=np.full(n, 1.0, dtype))
    return s, y, par


LIK_BARS = {np.float64: (1e-14, 1e-12, 1e-9), np.float32: (1e-5, 1e-4, 1e-2)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("likelihood", LIKELIHOODS)
def test_likelihood_derivatives_match_jax_autodiff(likelihood, dtype):
    """The closed forms against ``jax.grad`` and ``jax.jvp`` of the JAX
    likelihood at points across both rails, the reflection and the deep
    tails."""
    s, y, par = _points(1, 3000, dtype)
    nll = jim._nll_factory(likelihood, 4.0)
    jpar = [jnp.asarray(par[k]) for k in ("sig", "quantum", "lo", "hi")]

    def f(v):
        return nll(v, jnp.asarray(y), *jpar)

    g1 = jax.grad(lambda v: jnp.sum(f(v)))
    want = jax.jit(lambda v: (f(v), *jax.jvp(g1, (v,), (jnp.ones_like(v),))
                              ))(jnp.asarray(s))
    t = {k: torch.as_tensor(v) for k, v in par.items()}
    got = pim.nll_derivs(likelihood, 4.0, torch.as_tensor(s),
                         torch.as_tensor(y), t["sig"], t["quantum"],
                         t["lo"], t["hi"])
    for g_, w, bar in zip(got, want, LIK_BARS[dtype]):
        w = np.asarray(w)
        assert np.array_equal(np.isfinite(g_.numpy()), np.isfinite(w))
        fin = np.isfinite(w)
        err = np.abs(g_.numpy()[fin] - w[fin]) / np.maximum(
            np.abs(w[fin]), 1.0)
        assert err.max() <= bar, (likelihood, err.max(), bar)


@pytest.mark.parametrize("likelihood", LIKELIHOODS)
def test_likelihood_derivatives_match_torch_autograd(likelihood):
    """On the smooth branches (``log_ndtr``'s middle segment, no clip)
    the closed forms are torch autograd's first and second derivatives
    of the plain likelihood."""
    s, y, par = _points(2, 400, np.float64)
    if likelihood == "censored":
        # both rails, the tail arguments inside (-10, 5)
        hi = np.arange(400) % 2 == 0
        y = np.where(hi, 1.5, -1.5)
        u = np.random.default_rng(3).uniform(0.05, 1.45, 400)
        s = np.where(hi, u, -u)
    if likelihood == "quantized":
        s = y + np.clip(s, -1.0, 1.0) * 0.3
    t = {k: torch.as_tensor(v) for k, v in par.items()}
    st = torch.as_tensor(s).requires_grad_(True)
    f, d1, d2 = pim.nll_derivs(likelihood, 4.0, st, torch.as_tensor(y),
                               t["sig"], t["quantum"], t["lo"], t["hi"])
    (g,) = torch.autograd.grad(f.sum(), st, create_graph=True)
    (h,) = torch.autograd.grad(g.sum(), st)
    assert _rel(d1.detach(), g.detach().numpy()) <= 1e-10
    assert _rel(d2.detach(), h.numpy()) <= 1e-9


@pytest.mark.parametrize("likelihood", LIKELIHOODS)
def test_scalar_map_solve_matches_jax(likelihood):
    """The capped Newton loop against JAX's ``_scalar_map_solve`` over
    independent lanes, some inactive: the MAP point, the Laplace
    curvature, the steps taken and the verdicts."""
    rng = np.random.default_rng(3)
    n = 200
    mu = rng.normal(size=n) * 2.0
    c = rng.uniform(0.01, 2.0, n)
    y = mu + rng.normal(size=n) * np.where(np.arange(n) % 5 == 0, 20.0, 1.0)
    sig = np.full(n, 0.1)
    q = np.full(n, 0.4)
    lo, hi = np.full(n, -0.5), np.full(n, 0.5)
    if likelihood == "censored":
        y = np.clip(y, -0.5, 0.5)
    active = rng.uniform(size=n) > 0.2
    nll = jim._nll_factory(likelihood, 4.0)
    want = jax.jit(lambda *a: jim._scalar_map_solve(
        a[0], a[1], lambda s: nll(s, *a[2:7]), jnp.float64, active=a[7]))(
        *(jnp.asarray(v) for v in (mu, c, y, sig, q, lo, hi, active)))
    T = torch.as_tensor
    s_hat, w, _, iters, nonconv = pim.scalar_map_solve_plain(
        likelihood, 4.0, T(mu), T(c), T(y), T(sig), T(q), T(lo), T(hi),
        T(active))
    assert _rel(s_hat, want[0]) <= 1e-12
    assert _rel(w[T(active)], np.asarray(want[1])[active]) <= 1e-10
    np.testing.assert_array_equal(iters.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(nonconv.numpy()[active],
                                  np.asarray(want[3])[active])
    assert iters.dtype == torch.int32 and not iters[~T(active)].any()
    assert iters.max() <= pim.NEWTON_ITERS


# ----------------------------------------------------------------------
# the updates (their parity with JAX: test_torch_implicit_map_parity.py)
# ----------------------------------------------------------------------
def _model(rng, n=5, k_fct=1, t_hist=120, k_app=6, missing=0.2,
           dtype=np.float64):
    loadings = rng.uniform(0.3, 0.8, (n, k_fct)) / np.sqrt(k_fct)
    ss = jops.dfm_statespace(
        jnp.asarray(rng.uniform(5.0, 40.0, n), dtype),
        jnp.asarray(rng.uniform(10.0, 60.0, k_fct), dtype),
        jnp.asarray(loadings, dtype), 1.0)
    _, y_all, m_all = simulate_dfm_panel(ss, t_hist + k_app, rng,
                                         missing_p=missing)
    y_hist = np.where(m_all[:t_hist], y_all[:t_hist], 0.0).astype(dtype)
    res = jops.kalman_filter(ss, y_hist, m_all[:t_hist],
                             engine="sequential")
    sres = jops.sqrt_kalman_filter(ss, y_hist, m_all[:t_hist])
    carry = (np.asarray(res.mean_f[-1]), np.asarray(res.cov_f[-1]))
    scarry = (np.asarray(sres.mean_f[-1]), np.asarray(sres.chol_f[-1]))
    return (ss, carry, scarry, y_all[t_hist:].astype(dtype),
            m_all[t_hist:].copy())


def _degrade(likelihood, y, m, rng):
    """Readings as the likelihood's sensor reports them, and the
    per-slot parameters: both rails (censored), a grid (quantized) or
    spikes on observed cells (huber_t)."""
    n = y.shape[-1]
    obs = y[m]
    par = dict(scale=np.full(n, 0.1))
    if likelihood == "censored":
        lo, hi = np.quantile(obs, 0.2), np.quantile(obs, 0.8)
        par.update(rail_lo=np.full(n, lo), rail_hi=np.full(n, hi))
        y = np.clip(y, lo, hi)
    elif likelihood == "quantized":
        par.update(quantum=np.full(n, 0.3))
        y = 0.3 * np.round(y / 0.3)
    else:
        cells = np.argwhere(m)
        for row, col in cells[rng.choice(len(cells), 2, replace=False)]:
            y[row, col] += 6.0 * rng.choice([-1.0, 1.0])
    return np.where(m, y, 0.0), par


def _batch(seed, likelihood, n_models=3, k_app=6):
    """``n_models`` models of one shape with their carries, ``k_app``
    degraded rows and parameters; the last model disarmed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_models):
        ss, carry, scarry, y, m = _model(rng, k_app=k_app)
        y, par = _degrade(likelihood, y, m, rng)
        out.append((ss, carry, scarry, y, m, i != n_models - 1, par))
    return out


def test_defaults_and_validation():
    (ss, carry, scarry, y, m, _, _), = _batch(7, "censored", 1)
    pss = _port_ss(ss)
    # the JAX defaults: censored with no rails flags nothing, and is the
    # plain sequential update
    got = pops.implicit_map_filter_append(pss, *carry, y, m, device="cpu")
    base = pops.filter_append(pss, *carry, y, m, device="cpu")
    for g, w in zip(got[:4], base):
        assert torch.equal(g, w)
    assert not got[5].any() and torch.isfinite(got[4][torch.as_tensor(m)]
                                                ).all()
    with pytest.raises(ValueError, match="unknown robust likelihood"):
        pops.implicit_map_filter_append(pss, *carry, y, m, device="cpu",
                                        likelihood="cauchy")
    with pytest.raises(ValueError, match="unknown robust likelihood"):
        pops.implicit_map_sqrt_filter_append(pss, *scarry, y, m,
                                             device="cpu",
                                             likelihood="gaussianish")
    # the wrappers check the per-slot parameters
    ph, q, z, r = (torch.as_tensor(np.asarray(a))[None] for a in ss)
    mean, cov = (torch.as_tensor(a)[None] for a in carry)
    yt, mt = torch.as_tensor(y)[None], torch.as_tensor(m)[None]
    armed = torch.ones(1, dtype=torch.bool)
    good = torch.zeros(1, y.shape[1], dtype=torch.float64)
    with pytest.raises(ValueError, match="rail_lo must be"):
        robust_filter_append(ph, q, z, r, mean, cov, yt, mt, armed,
                             good[:, :2], good, good, good)
    with pytest.raises(TypeError, match="scale is"):
        robust_filter_append(ph, q, z, r, mean, cov, yt, mt, armed, good,
                             good, good, good.float())
    with pytest.raises(ValueError, match="robust kernels take"):
        robust_filter_append(ph, q, z, r, mean, cov, yt, mt, armed, good,
                             good, good, good, likelihood="gaussian")
    lanes = pops.kalman._lanes_ss(StateSpace(ph, q, z, r), "sqrt")
    with pytest.raises(ValueError, match="quantum must be"):
        sqrt_filter_robust(*lanes, yt, mt,
                           torch.as_tensor(scarry[0])[None],
                           torch.as_tensor(scarry[1])[None], armed, good,
                           good, good[:, 1:], good)


# ----------------------------------------------------------------------
# the bit-exactness contracts, inside the port
# ----------------------------------------------------------------------
def _bitequal(got, want):
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fallback_contracts_are_bit_exact(dtype):
    """``likelihood="gaussian"``, ``armed=False`` (each likelihood) and an
    armed censored update whose readings never rail are the plain
    update from the same carry, bit for bit, on both engines."""
    rng = np.random.default_rng(8)
    ss, carry, scarry, y, m = _model(rng, dtype=dtype)
    y = np.where(m, y, 0.0).astype(dtype)
    pss = _port_ss(ss)
    t = torch.float64 if dtype == np.float64 else torch.float32
    c = [torch.as_tensor(a, dtype=t) for a in carry]
    sc = [torch.as_tensor(a, dtype=t) for a in scarry]
    base = pops.filter_append(pss, *c, y, m, engine="sequential",
                              device="cpu")
    sbase = pops.sqrt_filter_append(pss, *sc, y, m, device="cpu")
    runs = [dict(likelihood="gaussian"),
            dict(likelihood="censored", rail_lo=-1e6, rail_hi=1e6)]
    runs += [dict(likelihood=lik, armed=False, quantum=0.5, scale=0.1,
                  rail_lo=-0.1, rail_hi=0.1) for lik in LIKELIHOODS]
    for kw in runs:
        got = pops.implicit_map_filter_append(pss, *c, y, m, device="cpu",
                                              **kw)
        _bitequal(got, base)
        assert not got[5].any() and not got[6].any()
        sgot = pops.implicit_map_sqrt_filter_append(pss, *sc, y, m,
                                                    device="cpu", **kw)
        _bitequal(sgot, sbase)
        assert not sgot[5].any() and not sgot[6].any()


# ----------------------------------------------------------------------
# MAP semantics (tests/test_implicit_map.py, mirrored on the port)
# ----------------------------------------------------------------------
def test_censored_moves_the_state_toward_the_rail_only():
    rng = np.random.default_rng(9)
    ss, (m0, c0), _, y, m = _model(rng, missing=0.0)
    pss = _port_ss(ss)
    rail = float(np.quantile(y, 0.3))
    y_c = np.clip(y, rail, None)
    railed = y <= rail
    out = pops.implicit_map_filter_append(
        pss, m0, c0, y_c, m, armed=True, likelihood="censored",
        rail_lo=rail, rail_hi=1e6, scale=0.1, device="cpu")
    v = out[5].numpy()
    assert (v[railed & m] != 0).all() and (v[~railed & m] == 0).all()
    assert torch.isfinite(out[0]).all()
    assert np.linalg.eigvalsh(out[1].numpy()).min() > -1e-9
    it = out[6].numpy()
    assert it.max() <= pim.NEWTON_ITERS and it[railed & m].max() >= 1
    # one step, one railed slot: its prediction moves only up, to the
    # side the reading says the truth lies on
    row = np.full(y.shape[1], np.nan)
    row[0] = rail
    msk = np.isfinite(row)
    one = pops.implicit_map_filter_append(
        pss, m0, c0, np.nan_to_num(row)[None], msk[None],
        likelihood="censored", rail_lo=rail, rail_hi=1e6, scale=0.1,
        device="cpu")
    z0 = np.asarray(ss.z)[0]
    phi = np.asarray(ss.phi)
    prior = z0 @ (phi * m0)
    if prior < rail:
        assert z0 @ one[0].numpy() >= prior


def test_huber_t_bounds_the_influence_of_a_spike():
    rng = np.random.default_rng(10)
    ss, (m0, c0), _, y, m = _model(rng, missing=0.0)
    pss = _port_ss(ss)
    y, m = y[:1], m[:1]
    clean = pops.filter_append(pss, m0, c0, y, m, engine="sequential",
                               device="cpu")
    y_sp = y.copy()
    y_sp[0, 0] += 25.0
    naive = pops.filter_append(pss, m0, c0, y_sp, m, engine="sequential",
                               device="cpu")
    kw = dict(armed=True, likelihood="huber_t", nu=4.0, scale=0.1,
              device="cpu")
    rob_clean = pops.implicit_map_filter_append(pss, m0, c0, y, m, **kw)
    rob_spike = pops.implicit_map_filter_append(pss, m0, c0, y_sp, m, **kw)
    shift_naive = (naive[0] - clean[0]).abs().max()
    shift_rob = (rob_spike[0] - rob_clean[0]).abs().max()
    assert shift_rob < shift_naive / 3.0


def test_quantized_lands_inside_its_cell():
    rng = np.random.default_rng(11)
    ss, (m0, c0), _, y, m = _model(rng, missing=0.0)
    q = 1.0
    y_q = q * np.round(y / q)
    out = pops.implicit_map_filter_append(
        _port_ss(ss), m0, c0, y_q, m, armed=True, likelihood="quantized",
        quantum=q, scale=0.1, device="cpu")
    pred = np.asarray(ss.z) @ out[0].numpy()
    assert np.abs(pred - y_q[-1]).max() < q / 2 + 0.35
    assert (out[5].numpy()[m] != 0).all()


def test_covariance_and_sqrt_engines_agree():
    rng = np.random.default_rng(12)
    ss, carry, scarry, y, m = _model(rng, missing=0.0)
    pss = _port_ss(ss)
    rail = float(np.quantile(y, 0.7))
    y_c = np.clip(y, None, rail)
    kw = dict(armed=True, likelihood="censored", rail_hi=rail, scale=0.1,
              device="cpu")
    out = pops.implicit_map_filter_append(pss, *carry, y_c, m, **kw)
    sout = pops.implicit_map_sqrt_filter_append(pss, *scarry, y_c, m, **kw)
    assert np.allclose(out[0].numpy(), sout[0].numpy(), atol=2e-2)
    cov_s = (sout[1] @ sout[1].T).numpy()
    assert np.allclose(out[1].numpy(), cov_s, atol=2e-2)
