"""Port parity: the single-model products of ``metran_tpu.ops.kalman``
and ``metran_tpu.ops.forecast`` — ``innovations``, ``decompose_states``,
``_forecast_from_filtered`` (kernel K2) and the simulation smoother
``_sample_states`` (K7's path draws, each chunk of draws smoothed by K6
``store`` + K8) — on the kernels' plain versions, f64 on the CPU.

The sampler is fed JAX's own normals (``_sample_states_given``): the
port draws from a ``torch.Generator``, whose numbers differ from JAX's
PRNG.  Bar: 1e-10 normwise relative (NaN positions exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import random_ssm

from metran_tpu.ops import forecast as jf
from metran_tpu.ops import kalman as jk
from metran_tpu_torch.ops import forecast as pf
from metran_tpu_torch.ops import kalman as pk
from metran_tpu_torch.ops.statespace import StateSpace

# the plain versions make thousands of tiny LAPACK calls (one Cholesky per
# step); with several test processes on one host, torch's OpenMP threads
# oversubscribe the cores and each call waits on spinning threads (600x
# slower, measured), so a test process keeps torch to one thread
torch.set_num_threads(1)


def _port_ss(ss):
    return StateSpace(*(torch.as_tensor(np.array(leaf)) for leaf in ss))


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def test_innovations_decompose_and_forecast_match_jax():
    rng = np.random.default_rng(13)
    ss, y, mask = random_ssm(rng, 5, 2, t=100)
    filt_j = jk.kalman_filter(ss, y, mask, engine="sequential", store=True)
    filt_p = pk.kalman_filter(_port_ss(ss), y, mask, engine="sequential",
                              store=True, device="cpu")
    for standardized in (True, False):
        want = jk.innovations(ss, y, mask, filt=filt_j,
                              standardized=standardized, warmup=7)
        got = pk.innovations(_port_ss(ss), y, mask, filt=filt_p,
                             standardized=standardized, warmup=7)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert np.array_equal(np.isnan(g.numpy()), np.isnan(w))
            fin = np.isfinite(w)
            assert np.abs(g.numpy()[fin] - w[fin]).max() <= (
                1e-10 * np.abs(w[fin]).max())
    # without a filter result, innovations run the stored filter itself
    own = pk.innovations(_port_ss(ss), y, mask, device="cpu")
    ref = pk.innovations(_port_ss(ss), y, mask, filt=filt_p)
    assert torch.equal(own[0].isnan(), ref[0].isnan())
    sm_j = jk.rts_smoother(ss, filt_j)
    sm_p = pk.rts_smoother(_port_ss(ss), filt_p)
    z = np.asarray(ss.z) * rng.uniform(1.0, 3.0, (5, 1))  # scaled units
    want = jk.decompose_states(jnp.asarray(z), sm_j.mean_s, 5)
    got = pk.decompose_states(torch.as_tensor(z), sm_p.mean_s, 5)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-10
    assert got[1].shape == (2, 100, 5)
    want = jf._forecast_from_filtered(ss._replace(z=jnp.asarray(z)),
                                      filt_j.mean_f[-1], filt_j.cov_f[-1], 9)
    got = pf._forecast_from_filtered(
        _port_ss(ss)._replace(z=torch.as_tensor(z)), filt_p.mean_f[-1],
        filt_p.cov_f[-1], 9)
    for g, w in zip(got, want):
        assert g.shape == (9, 5)
        assert _rel(g, w) <= 1e-10


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


@pytest.mark.parametrize("draw_chunk", [2, 8])
def test_sample_states_given_jax_normals_matches_jax(draw_chunk):
    rng = np.random.default_rng(17)
    ss, y, mask = random_ssm(rng, 4, 1, t=60)
    key = jax.random.PRNGKey(3)
    n_draws = 5
    want = jk._sample_states(ss, y, mask, key, None, n_draws=n_draws,
                             engine="sequential", draw_chunk=draw_chunk)
    normals = _jax_normals(key, n_draws, 60, 5, 4)
    got = pk._sample_states_given(_port_ss(ss), y, mask, *normals,
                                  draw_chunk=draw_chunk, device="cpu")
    assert got.shape == (n_draws, 60, 5)
    assert _rel(got, want) <= 1e-10
    # r = 0: every draw passes through the observed entries
    proj = got.numpy() @ np.asarray(ss.z).T
    obs = np.broadcast_to(mask, proj.shape)
    assert np.abs(proj - y[None])[obs].max() < 1e-9


def test_sample_states_is_seeded_and_rejects_non_diagonal_q():
    rng = np.random.default_rng(19)
    ss, y, mask = random_ssm(rng, 3, 1, t=40)
    pss = _port_ss(ss)
    a = pk.sample_states(pss, y, mask, 4, n_draws=3, device="cpu")
    b = pk.sample_states(pss, y, mask, torch.Generator().manual_seed(4),
                         n_draws=3, draw_chunk=1, device="cpu")
    assert a.shape == (3, 40, 4)
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    bad = pss._replace(q=pss.q + 1e-3)
    with pytest.raises(ValueError, match="diagonal"):
        pk.sample_states(bad, y, mask, 0, device="cpu")
