"""Port parity: the lane-layout post-fit products
(``metran_tpu_torch.ops.lanes_products`` over the plain versions of
kernels K3, K5, K6, K7 and K2 on CPU tensors) against
``metran_tpu.ops.lanes_products``, f64 on the CPU.

Inputs follow ``tests/test_lanes_products.py::make_fleet``: an all-masked
first step, an all-missing stretch, and T = 60 with ``seg=16`` (not a
multiple).  Bars are that file's: means rtol/atol 1e-9, variances rtol
1e-8 / atol 1e-9, forecasts 1e-9 / 1e-10, mean-only vs full 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metran_tpu.ops import dfm_statespace, kalman_filter, project, rts_smoother
from metran_tpu.ops import lanes_products as jp
from metran_tpu.ops.lanes import lanes_statespace as j_lanes_statespace
from metran_tpu_torch.ops import lanes_products as pp

B, N, K, T_STEPS, SEG = 3, 4, 2, 60, 16


def make_lanes(seed, b=B, n=N, k=K, t=T_STEPS, missing=0.3):
    """``make_fleet``'s panels in lane layout: ``(phi, q, z, r, y, mask)``
    as numpy, (T, N, B) data, plus the batch-leading ``(params, y,
    mask, loadings, dt)``."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(b, t, n))
    mask = rng.uniform(size=(b, t, n)) > missing
    mask[:, 0] = False  # no-observation leading timestep
    if b > 1 and t > 9:
        mask[1, 5:9] = False  # an all-missing stretch
    y = np.where(mask, y, 0.0)
    loadings = rng.uniform(0.3, 0.8, (b, n, k)) / np.sqrt(k)
    dt = rng.uniform(0.5, 2.0, b)
    params = rng.uniform(5.0, 40.0, (b, n + k))
    ss = j_lanes_statespace(jnp.asarray(params.T),
                            jnp.asarray(np.transpose(loadings, (1, 2, 0))),
                            jnp.asarray(dt))
    lanes = tuple(np.asarray(a) for a in ss) + (
        np.transpose(y, (1, 2, 0)), np.transpose(mask, (1, 2, 0)))
    return lanes, (params, y, mask, loadings, dt)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("want_cov", [True, False])
def test_lanes_smooth_parity(want_cov):
    lanes, _ = make_lanes(0)
    want = jp.lanes_smooth(*_jax(*lanes), seg=SEG, want_cov=want_cov)
    got = pp.lanes_smooth(*lanes, seg=SEG, want_cov=want_cov, device="cpu")
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-8,
                               atol=1e-9)
    assert got[0].shape == (T_STEPS, N + K, B)
    assert got[2].shape == (T_STEPS, N, B)


def test_lanes_smooth_mean_only_matches_full():
    lanes, _ = make_lanes(1)
    full = pp.lanes_smooth(*lanes, seg=SEG, want_cov=True, device="cpu")
    mean_only = pp.lanes_smooth(*lanes, seg=SEG, want_cov=False,
                                device="cpu")
    np.testing.assert_allclose(_np(mean_only[0]), _np(full[0]), rtol=1e-12)
    np.testing.assert_allclose(_np(mean_only[1]), _np(full[1]), rtol=1e-12)
    assert bool((mean_only[2] == 0).all())


def test_lanes_smooth_matches_rts_smoother():
    """A third oracle: the JAX package's RTS smoother + ``project`` per
    model (the gain form, not the D-K recursion)."""
    lanes, (params, y, mask, loadings, dt) = make_lanes(2, b=2)
    mean_s, pm, pv = pp.lanes_smooth(*lanes, seg=SEG, device="cpu")
    for i in range(2):
        p = params[i]
        ss = dfm_statespace(jnp.asarray(p[:N]), jnp.asarray(p[N:]),
                            jnp.asarray(loadings[i]), dt[i])
        filt = kalman_filter(ss, jnp.asarray(y[i]), jnp.asarray(mask[i]))
        sm = rts_smoother(ss, filt)
        ref_pm, ref_pv = project(ss.z, sm.mean_s, sm.cov_s)
        np.testing.assert_allclose(_np(mean_s[:, :, i]), _np(sm.mean_s),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(_np(pm[:, :, i]), _np(ref_pm), rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(_np(pv[:, :, i]), _np(ref_pv), rtol=1e-8,
                                   atol=1e-9)


def test_lanes_filter_project_parity():
    lanes, _ = make_lanes(3)
    want = jp.lanes_filter_project(*_jax(*lanes))
    got = pp.lanes_filter_project(*lanes, device="cpu")
    for g, w, rtol in zip(got, want, (1e-9, 1e-9, 1e-8)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=1e-9)


@pytest.mark.parametrize("standardized", [True, False])
def test_lanes_innovations_parity(standardized):
    """Standardized and raw, with ``warmup`` > 0: the same values and
    NaN exactly where the JAX function puts them."""
    lanes, _ = make_lanes(4)
    want = jp.lanes_innovations(*_jax(*lanes), standardized=standardized,
                                warmup=7)
    got = pp.lanes_innovations(*lanes, standardized=standardized, warmup=7,
                               device="cpu")
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        assert np.isnan(g[:7]).all()
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)


def test_lanes_forecast_parity_heterogeneous_t_last():
    """Each lane forecasts from its own ``t_last``: 0 (the initial
    N(0, I)), an interior step and T."""
    lanes, _ = make_lanes(5)
    t_last = np.array([T_STEPS, 0, 35], np.int32)
    want = jp.lanes_forecast(*_jax(*lanes), jnp.asarray(t_last), 12)
    got = pp.lanes_forecast(*lanes, t_last, 12, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == (12, N, B)
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-9, atol=1e-10)


def test_lanes_forecast_unit_root_guard_and_clip():
    """K2's closed form equals the JAX lanes formula at its edges: a
    state with phi == 1 (the ``pp == 1`` limit h) and a lane whose
    negative process noise drives the horizon variances below 0 (clipped
    at 0 before r is added)."""
    lanes, _ = make_lanes(6)
    phi, q, z, r, y, mask = (np.array(a) for a in lanes)
    phi[0, 0] = 1.0
    q[:, 2] = -2.0
    r[:, 1] = 0.25
    t_last = np.array([T_STEPS, 20, 0], np.int32)
    want = jp.lanes_forecast(*_jax(phi, q, z, r, y, mask),
                             jnp.asarray(t_last), 9)
    got = pp.lanes_forecast(phi, q, z, r, y, mask, t_last, 9, device="cpu")
    assert (_np(got[1])[:, :, 2] == 0).any()  # the clip took effect
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-9, atol=1e-10)


def _jax_normals(seed, b, n_draws, t, n_state, n_obs):
    """The standard normals JAX's ``lanes_sample`` draws from per-model
    keys (its ``model_normals`` recipe), lane ``d * B + model`` last."""
    keys = jax.random.split(jax.random.PRNGKey(seed), b)

    def model_normals(key, shape):
        draws = jax.vmap(lambda k: jax.random.normal(
            k, shape + (n_draws,), jnp.float64))(key)
        return np.asarray(jnp.moveaxis(draws, 0, -1).reshape(
            shape + (n_draws * b,)))

    ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    return keys, (model_normals(ks[:, 0], (n_state,)),
                  model_normals(ks[:, 1], (t, n_state)),
                  model_normals(ks[:, 2], (t, n_obs)))


@pytest.mark.parametrize("project_draws", [True, False])
def test_lanes_sample_given_jax_normals_parity(project_draws):
    """Fed JAX's own normals, the port's simulation smoother gives JAX's
    draws (observation or state space)."""
    lanes, _ = make_lanes(7)
    keys, normals = _jax_normals(11, B, 3, T_STEPS, N + K, N)
    want = jp.lanes_sample(*_jax(*lanes), keys, n_draws=3, seg=SEG,
                           project=project_draws)
    got = pp._lanes_sample_given(*lanes, *normals, seg=SEG,
                                 project=project_draws, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-9, atol=1e-9)


def test_lanes_sample_passes_through_observations():
    """Draws from the port's own generator pass exactly through every
    observed entry (r = 0) and are reproducible from the seed."""
    lanes, (_, y, mask, _, _) = make_lanes(8)
    gen = torch.Generator().manual_seed(4)
    draws = pp.lanes_sample(*lanes, generator=gen, n_draws=5, seg=SEG,
                            device="cpu")
    assert draws.shape == (5, T_STEPS, N, B)
    d = _np(draws).transpose(3, 0, 1, 2)  # (B, D, T, N)
    for i in range(B):
        np.testing.assert_allclose(d[i][:, mask[i]],
                                   np.broadcast_to(y[i][mask[i]],
                                                   (5, mask[i].sum())),
                                   atol=1e-9)
    again = pp.lanes_sample(*lanes, generator=torch.Generator().manual_seed(4),
                            n_draws=5, seg=SEG, device="cpu")
    assert torch.equal(draws, again)
