"""Port parity: the fleet products of ``metran_tpu_torch.parallel``
(``fleet_simulate``, ``fleet_decompose``, ``fleet_forecast``,
``fleet_innovations``, ``fleet_sample``, on CPU fleets: the plain
versions of kernels K3, K5, K6, K7 and K2) against the JAX wrappers with
``layout="lanes"``, and ``diagnostics.fleet_whiteness`` against the JAX
one, f64 on the CPU.

Bars are ``tests/test_lanes_products.py``'s: means rtol/atol 1e-9,
variances rtol 1e-8 / atol 1e-9, forecasts 1e-9 / 1e-10, chunked vs
unchunked 1e-12.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metran_tpu import diagnostics as jd
from metran_tpu.data import Panel as JPanel
from metran_tpu.parallel import fleet as jf
from metran_tpu_torch import diagnostics as pd_
from metran_tpu_torch.data import Panel
from metran_tpu_torch.parallel import fleet as pf

SEG = 16


def make_fleets(seed, b=3, n=4, k=2, t=60, missing=0.3, full_step=False):
    """``tests/test_lanes_products.py::make_fleet``'s panels as the JAX
    fleet and the port's (CPU tensors), with random parameters (B, N+K).
    ``full_step``: every slot observed (a 1-step panel needs data)."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(b, t, n))
    mask = rng.uniform(size=(b, t, n)) > missing
    mask[:, 0] = False  # no-observation leading timestep
    if b > 1 and t > 9:
        mask[1, 5:9] = False  # an all-missing stretch
    if full_step:
        mask[:] = True
    y = np.where(mask, y, 0.0)
    loadings = rng.uniform(0.3, 0.8, (b, n, k)) / np.sqrt(k)
    dt = rng.uniform(0.5, 2.0, b)
    jfleet = jf.Fleet(y=jnp.asarray(y), mask=jnp.asarray(mask),
                      loadings=jnp.asarray(loadings), dt=jnp.asarray(dt),
                      n_series=jnp.full(b, n, jnp.int32))
    params = rng.uniform(5.0, 40.0, (b, n + k))
    return jfleet, _port(jfleet), params


def _port(jfleet):
    return pf.Fleet(*(None if a is None else torch.as_tensor(np.array(a))
                      for a in jfleet))


def _close(got, want, rtols=(1e-9, 1e-8), atol=1e-9):
    for g, w, rtol in zip(got, want, rtols):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("smooth", [True, False])
def test_fleet_simulate_parity(smooth):
    jfleet, pfleet, params = make_fleets(0)
    want = jf.fleet_simulate(jnp.asarray(params), jfleet, smooth=smooth,
                             seg=SEG)
    got = pf.fleet_simulate(params, pfleet, smooth=smooth, seg=SEG)
    _close(got, want)


@pytest.mark.parametrize("smooth", [True, False])
def test_fleet_decompose_parity(smooth):
    jfleet, pfleet, params = make_fleets(1)
    want = jf.fleet_decompose(jnp.asarray(params), jfleet, smooth=smooth,
                              seg=SEG)
    got = pf.fleet_decompose(params, pfleet, smooth=smooth, seg=SEG)
    _close(got, want, rtols=(1e-9, 1e-9))


def test_fleet_innovations_parity_with_warmup():
    jfleet, pfleet, params = make_fleets(2)
    want = jf.fleet_innovations(jnp.asarray(params), jfleet, warmup=10)
    got = pf.fleet_innovations(params, pfleet, warmup=10)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        assert np.isnan(g[:, :10]).all()
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)


def test_fleet_forecast_parity_own_data_end():
    """Each member forecasts from its own ``t_steps``."""
    jfleet, _, params = make_fleets(3, k=1, t=50)
    jfleet = jfleet._replace(t_steps=jnp.asarray([50, 35, 50], jnp.int32),
                             mask=jfleet.mask.at[1, 35:].set(False))
    params = params[:, :5]
    want = jf.fleet_forecast(jnp.asarray(params), jfleet, steps=12)
    got = pf.fleet_forecast(params, _port(jfleet), steps=12)
    _close(got, want, rtols=(1e-9, 1e-9), atol=1e-10)


def _random_panel(rng, n, t):
    """``tests/test_parallel.py::_random_panel``'s recipe, both packages."""
    values = rng.normal(size=(t, n))
    mask = rng.uniform(size=(t, n)) > 0.2
    values = np.where(mask, values, 0.0)
    args = (values, mask, None, [f"s{i}" for i in range(n)], np.ones(n),
            np.zeros(n), 1.0)
    return JPanel(*args), Panel(*args)


def test_padded_fleet_products_parity():
    """Padded series slots, padded members and time padding give the
    JAX lanes products (the padding semantics of the fit)."""
    rng = np.random.default_rng(4)
    shapes = ((4, 50), (2, 40), (3, 50))
    panels = [_random_panel(rng, n, t) for n, t in shapes]
    loadings = [rng.uniform(0.3, 0.8, (n, 1)) for n, _ in shapes]
    jfleet = jf.pack_fleet([p[0] for p in panels], loadings, pad_batch_to=4)
    pfleet = pf.pack_fleet([p[1] for p in panels], loadings, pad_batch_to=4,
                           device="cpu")
    params = rng.uniform(5.0, 40.0, (4, jfleet.n_params))
    jp_ = jnp.asarray(params)
    _close(pf.fleet_simulate(params, pfleet, seg=SEG),
           jf.fleet_simulate(jp_, jfleet, seg=SEG))
    _close(pf.fleet_decompose(params, pfleet, seg=SEG),
           jf.fleet_decompose(jp_, jfleet, seg=SEG), rtols=(1e-9, 1e-9))
    for g, w in zip(pf.fleet_innovations(params, pfleet),
                    jf.fleet_innovations(jp_, jfleet)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9)
    _close(pf.fleet_forecast(params, pfleet, 7),
           jf.fleet_forecast(jp_, jfleet, 7), rtols=(1e-9, 1e-9), atol=1e-10)


@pytest.mark.parametrize(
    "b,n,k,t",
    [
        (1, 4, 1, 30),  # single member
        (3, 4, 1, 1),  # single timestep
        (3, 4, 1, 10),  # T < seg (whole series in one padded segment)
        (2, 2, 3, 25),  # more factors than series
    ],
)
def test_edge_shapes_parity(b, n, k, t):
    jfleet, pfleet, params = make_fleets(5, b=b, n=n, k=k, t=t,
                                         full_step=t == 1)
    jp_ = jnp.asarray(params)
    _close(pf.fleet_simulate(params, pfleet, seg=SEG),
           jf.fleet_simulate(jp_, jfleet, seg=SEG))
    for g, w in zip(pf.fleet_innovations(params, pfleet),
                    jf.fleet_innovations(jp_, jfleet)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9)


def test_chunked_products_match_unchunked():
    """Chunks of 2 over 3 members (an edge-replicated tail) give the
    one-dispatch results."""
    _, pfleet, params = make_fleets(6)
    for fn in (lambda **kw: pf.fleet_simulate(params, pfleet, seg=SEG, **kw),
               lambda **kw: pf.fleet_forecast(params, pfleet, 5, **kw)):
        for a, b in zip(fn(), fn(batch_chunk=2)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


def test_fleet_sample_conditioning_and_moments():
    """Draws pass through the observed entries (r = 0) and their mean
    approaches the JAX smoothed projection in the gaps (the JAX test's
    CLT bound)."""
    jfleet, pfleet, params = make_fleets(7, b=2, n=3, k=1, t=40)
    draws = pf.fleet_sample(params, pfleet, n_draws=200, seed=7, seg=SEG)
    assert draws.shape == (2, 200, 40, 3)
    y, mask = np.asarray(jfleet.y), np.asarray(jfleet.mask)
    d = draws.numpy()
    for i in range(2):
        np.testing.assert_allclose(
            d[i][:, mask[i]],
            np.broadcast_to(y[i][mask[i]], d[i][:, mask[i]].shape),
            atol=1e-7)
    pm, pv = jf.fleet_simulate(jnp.asarray(params), jfleet, seg=SEG)
    mean_err = np.abs(d.mean(axis=1) - np.asarray(pm))
    sd = np.sqrt(np.maximum(np.asarray(pv), 0.0))
    assert np.all(mean_err <= 5.0 * sd / np.sqrt(200) + 1e-6)


def test_fleet_sample_chunk_invariant_and_state_draws():
    """Each member's draws depend on the seed and its index only, not on
    ``batch_chunk``; ``project=False`` gives state draws."""
    _, pfleet, params = make_fleets(8, b=3, n=3, k=1, t=30)
    params = params[:, :4]
    d1 = pf.fleet_sample(params, pfleet, n_draws=2, seed=3, seg=SEG)
    d2 = pf.fleet_sample(params, pfleet, n_draws=2, seed=3, seg=SEG,
                         batch_chunk=1)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), rtol=1e-12,
                               atol=1e-12)
    states = pf.fleet_sample(params, pfleet, n_draws=3, seg=SEG,
                             project=False)
    assert states.shape == (3, 3, 30, 4)


def test_layouts_and_engine_rules(caplog):
    _, pfleet, params = make_fleets(9, b=2, t=20)
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        pf.fleet_simulate(params, pfleet, layout="batch")
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        pf.fleet_sample(params, pfleet, layout="batch")
    with pytest.raises(ValueError, match="unknown layout"):
        pf.fleet_innovations(params, pfleet, layout="lane")
    with caplog.at_level(logging.WARNING,
                         logger="metran_tpu_torch.parallel.fleet"):
        pf.fleet_forecast(params, pfleet, 3, engine="sqrt")
    assert "engine='sqrt' is ignored" in caplog.text


def test_fleet_whiteness_parity():
    """The port's Ljung-Box over its own innovations equals the JAX one
    on the JAX innovations (and on the same array)."""
    jfleet, pfleet, params = make_fleets(10, t=120)
    v_p, _ = pf.fleet_innovations(params, pfleet, warmup=5)
    v_j, _ = jf.fleet_innovations(jnp.asarray(params), jfleet, warmup=5)
    got = pd_.fleet_whiteness(v_p, lags=10)
    want = jd.fleet_whiteness(np.asarray(v_j), lags=10)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-8, equal_nan=True)
    same = pd_.fleet_whiteness(np.asarray(v_j), lags=10)
    for g, w in zip(same, want):
        np.testing.assert_array_equal(g, w)
    frame = __import__("pandas").DataFrame(v_p[0].numpy(),
                                           columns=list("abcd"))
    t_got = pd_.whiteness_table(frame, lags=10)
    t_want = jd.whiteness_table(frame, lags=10)
    assert t_got.equals(t_want)
