"""Port parity: the lane-layout deviance and its closed-form adjoint
(``metran_tpu_torch.ops.lanes`` over the plain versions of kernels K3
and K4 on CPU tensors) against ``metran_tpu.ops.lanes``, f64 on the CPU
(the sequential engine of ``ops/kalman.py`` that rides K3 is held in
``tests/test_torch_kalman_sequential.py``).

Tolerances are those of the JAX package's own tests
(``tests/test_lanes_adjoint.py``): values rtol 1e-12 (the two sides
reduce the same sums in different orders), gradients rtol/atol 1e-11,
near-unit-root 1e-9/1e-12, f32 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metran_tpu.ops import lanes as jl
from metran_tpu_torch.kernels import lanes as kl
from metran_tpu_torch.ops import lanes as pl

N, K = 6, 1
# one panel shape for most tests, so the JAX reference compiles once per
# (dtype, segment, warmup)
B, T_STEPS, SEG = 4, 100, 32


def _workload(rng, b, t, missing=0.3, n=N):
    """Lane-layout (T, N, B) observations with a leading all-masked step,
    and (N, K, B) loadings (``tests/test_lanes_adjoint.py``'s recipe)."""
    loadings = rng.uniform(0.4, 0.8, (b, n, K))
    y = rng.normal(size=(b, t, n))
    mask = rng.uniform(size=y.shape) > missing
    mask[:, 0] = False
    return (np.transpose(np.where(mask, y, 0.0), (1, 2, 0)),
            np.transpose(mask, (1, 2, 0)), np.transpose(loadings, (1, 2, 0)))


def _jax_vg(alpha, ld, dt, y, mask, seg, warmup=1, score="adjoint"):
    def f(a):
        return jl.lanes_dfm_deviance(a, jnp.asarray(ld), jnp.asarray(dt),
                                     jnp.asarray(y), jnp.asarray(mask),
                                     warmup=warmup, remat_seg=seg,
                                     score=score)

    val, vjp = jax.vjp(f, jnp.asarray(alpha))
    (g,) = vjp(jnp.ones_like(val))
    return np.asarray(val), np.asarray(g)


def _port_vg(alpha, ld, dt, y, mask, seg, warmup=1, score="adjoint"):
    a = torch.tensor(alpha, requires_grad=True)
    val = pl.lanes_dfm_deviance(a, torch.as_tensor(ld), torch.as_tensor(dt),
                                torch.as_tensor(y), torch.as_tensor(mask),
                                warmup=warmup, remat_seg=seg, score=score)
    (g,) = torch.autograd.grad(val.sum(), a)
    return val.detach().numpy(), g.numpy()


def test_lanes_statespace_parity():
    rng = np.random.default_rng(1)
    b = 5
    alpha = rng.uniform(2.0, 3e4, (N + K, b))
    ld = rng.uniform(0.3, 0.8, (N, K, b))
    dt = rng.uniform(0.5, 2.0, b)
    want = jl.lanes_statespace(jnp.asarray(alpha), jnp.asarray(ld),
                               jnp.asarray(dt))
    got = pl.lanes_statespace(torch.tensor(alpha), torch.tensor(ld),
                              torch.tensor(dt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14,
                                   atol=1e-14)


@pytest.mark.parametrize("seg", [SEG, None])
def test_lanes_dfm_deviance_and_gradient_parity(seg):
    """Values at rtol 1e-12 and the adjoint gradient at 1e-11, with a
    segment length that does not divide T (the padded tail) and with
    none (one segment)."""
    rng = np.random.default_rng(10)
    b = B
    y, mask, ld = _workload(rng, b, T_STEPS)
    dt = np.ones(b)
    alpha = rng.uniform(2.0, 50.0, (N + K, b))
    v_want, g_want = _jax_vg(alpha, ld, dt, y, mask, seg)
    v_got, g_got = _port_vg(alpha, ld, dt, y, mask, seg)
    np.testing.assert_allclose(v_got, v_want, rtol=1e-12)
    np.testing.assert_allclose(g_got, g_want, rtol=1e-11, atol=1e-11)
    # the autodiff score runs torch autograd through the plain filter:
    # same values, the same gradient to rounding
    v_ad, g_ad = _port_vg(alpha, ld, dt, y, mask, seg, score="autodiff")
    np.testing.assert_allclose(v_ad, v_want, rtol=1e-12)
    np.testing.assert_allclose(g_ad, g_want, rtol=1e-11, atol=1e-11)


def test_adjoint_near_unit_root():
    """The cap regime (alpha = 3e4, phi -> 1), where a wrong adjoint
    term would be amplified."""
    rng = np.random.default_rng(3)
    b = B
    y, mask, ld = _workload(rng, b, T_STEPS)
    dt = np.ones(b)
    alpha = np.full((N + K, b), 3e4)
    v_want, g_want = _jax_vg(alpha, ld, dt, y, mask, SEG)
    v_got, g_got = _port_vg(alpha, ld, dt, y, mask, SEG)
    np.testing.assert_allclose(v_got, v_want, rtol=1e-12)
    np.testing.assert_allclose(g_got, g_want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", ["masked_series", "masked_first_step"])
def test_adjoint_masking(case):
    """A series masked at every step (the padding pattern) contributes
    nothing and leaves finite gradients; an all-masked first step is a
    predict only."""
    rng = np.random.default_rng(4)
    b = B
    y, mask, ld = _workload(rng, b, T_STEPS)
    if case == "masked_series":
        mask[:, -1, :] = False
    else:
        mask[:3] = False
    dt = np.ones(b)
    alpha = rng.uniform(2.0, 50.0, (N + K, b))
    v_want, g_want = _jax_vg(alpha, ld, dt, y, mask, SEG)
    v_got, g_got = _port_vg(alpha, ld, dt, y, mask, SEG)
    assert np.isfinite(g_got).all()
    np.testing.assert_allclose(v_got, v_want, rtol=1e-12)
    np.testing.assert_allclose(g_got, g_want, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("warmup", [0, 1, 5])
def test_warmup_rule(warmup):
    """Observed-step rank for sigma/detf, grid steps for nobs: a panel
    whose first steps are unobserved tells the two apart."""
    rng = np.random.default_rng(5)
    b, t_steps = B, T_STEPS
    y, mask, ld = _workload(rng, b, t_steps)
    mask[:4, :, 0] = False
    dt = np.ones(b)
    alpha = rng.uniform(2.0, 50.0, (N + K, b))
    v_want, g_want = _jax_vg(alpha, ld, dt, y, mask, SEG, warmup=warmup)
    v_got, g_got = _port_vg(alpha, ld, dt, y, mask, SEG, warmup=warmup)
    np.testing.assert_allclose(v_got, v_want, rtol=1e-12)
    np.testing.assert_allclose(g_got, g_want, rtol=1e-11, atol=1e-11)
    sig = rng.normal(size=(t_steps, b))
    det = rng.normal(size=(t_steps, b))
    np.testing.assert_allclose(
        pl.lanes_deviance_terms(torch.tensor(sig), torch.tensor(det),
                                torch.tensor(mask), warmup).numpy(),
        np.asarray(jl.lanes_deviance_terms(jnp.asarray(sig), jnp.asarray(det),
                                           jnp.asarray(mask), warmup)),
        rtol=1e-13)


def test_adjoint_treats_loadings_and_y_as_data():
    """Under the adjoint score the loadings and observations are fixed
    data: their cotangents are exactly zero (not silently partial)."""
    rng = np.random.default_rng(6)
    b = 3
    y, mask, ld = _workload(rng, b, 40)
    alpha = torch.tensor(rng.uniform(2.0, 50.0, (N + K, b)),
                         requires_grad=True)
    ld_t = torch.tensor(ld, requires_grad=True)
    y_t = torch.tensor(y, requires_grad=True)
    val = pl.lanes_dfm_deviance(alpha, ld_t, torch.ones(b, dtype=torch.float64),
                                y_t, torch.as_tensor(mask), remat_seg=16)
    g_a, g_ld, g_y = torch.autograd.grad(val.sum(), [alpha, ld_t, y_t],
                                         allow_unused=True,
                                         materialize_grads=True)
    assert torch.count_nonzero(g_a) > 0
    assert torch.count_nonzero(g_ld) == 0 and torch.count_nonzero(g_y) == 0


def test_adjoint_f32():
    rng = np.random.default_rng(7)
    b, t_steps = 8, 200
    y, mask, ld = _workload(rng, b, t_steps)
    y, ld = y.astype(np.float32), ld.astype(np.float32)
    dt = np.ones(b, np.float32)
    alpha = rng.uniform(2.0, 50.0, (N + K, b)).astype(np.float32)
    v_want, g_want = _jax_vg(alpha, ld, dt, y, mask, 50)
    v_got, g_got = _port_vg(alpha, ld, dt, y, mask, 50)
    assert v_got.dtype == np.float32 and g_got.dtype == np.float32
    np.testing.assert_allclose(v_got, v_want, rtol=1e-6)
    np.testing.assert_allclose(g_got, g_want, rtol=2e-4, atol=2e-4)


# ----------------------------------------------------------------------
# the plain versions of K3/K4 against the JAX segment programs
# ----------------------------------------------------------------------
def _lane_inputs(rng, b, t_steps):
    y, mask, ld = _workload(rng, b, t_steps)
    alpha = rng.uniform(2.0, 50.0, (N + K, b))
    phi, q, z, r = jl.lanes_statespace(jnp.asarray(alpha), jnp.asarray(ld),
                                       jnp.ones(b))
    return phi, q, z, r, y, mask


def test_filter_bounds_and_adjoint_match_the_jax_segment_programs():
    """K3's plain version (with boundaries) against ``_run_segments``,
    K4's against ``_terms_adjoint_bwd`` under random cotangents."""
    rng = np.random.default_rng(8)
    b, t_steps, seg = 3, 70, 32
    phi, q, z, r, y, mask = _lane_inputs(rng, b, t_steps)
    y_seg, m_seg = jl._segment(jnp.asarray(y), jnp.asarray(mask), seg,
                               jnp.float64)
    sig, det, bounds = jax.jit(jl._run_segments, static_argnums=6)(
        phi, q, z, r, y_seg, m_seg, True)
    args = [torch.tensor(np.asarray(a)) for a in (phi, q, z, r)]
    data = (torch.tensor(np.transpose(y, (2, 0, 1))),
            torch.tensor(np.transpose(mask, (2, 0, 1))))
    got = kl.lanes_filter(*args, *data, seg=seg, keep_bounds=True)
    np.testing.assert_allclose(got.sigma.numpy(), np.asarray(sig)[:t_steps],
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got.detf.numpy(), np.asarray(det)[:t_steps],
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got.bounds_mean.numpy(), np.asarray(bounds[0]),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got.bounds_cov.numpy(), np.asarray(bounds[1]),
                               rtol=1e-12, atol=1e-13)
    sb = rng.normal(size=(t_steps, b))
    db = rng.normal(size=(t_steps, b))
    pad = y_seg.shape[0] * seg - t_steps
    cot = tuple(jnp.asarray(np.concatenate([c, np.zeros((pad, b))]))
                for c in (sb, db))
    _, res = jax.jit(jl._terms_adjoint_fwd, static_argnums=6)(
        phi, q, z, r, y_seg, m_seg, seg)
    want = jax.jit(jl._terms_adjoint_bwd, static_argnums=0)(seg, res,
                                                            cot)[:2]
    phibar, qbar = kl.lanes_adjoint(*args, *data, None, seg, got.bounds_mean,
                                    got.bounds_cov, torch.tensor(sb),
                                    torch.tensor(db))
    np.testing.assert_allclose(phibar.numpy(), np.asarray(want[0]),
                               rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(qbar.numpy(), np.asarray(want[1]),
                               rtol=1e-11, atol=1e-11)


def test_lane_map_runs_trials_over_one_copy_of_the_data():
    """K trial lanes reading B data lanes through a lane map equal the
    same lanes over K tiled copies of the data, bit for bit."""
    rng = np.random.default_rng(9)
    b, t_steps, trials = 3, 50, 4
    y, mask, ld = _workload(rng, b, t_steps)
    alpha = rng.uniform(2.0, 50.0, (N + K, trials * b))
    phi, q, z, r = pl.lanes_statespace(
        torch.tensor(alpha), torch.tensor(np.tile(ld, (1, 1, trials))),
        torch.ones(trials * b, dtype=torch.float64))
    y_d = torch.tensor(np.transpose(y, (2, 0, 1)))
    m_d = torch.tensor(np.transpose(mask, (2, 0, 1)))
    lane_map = torch.arange(b, dtype=torch.int32).repeat(trials)
    got = kl.lanes_filter(phi, q, z, r, y_d, m_d, lane_map, seg=16,
                          keep_bounds=True)
    want = kl.lanes_filter(phi, q, z, r, y_d.repeat(trials, 1, 1),
                           m_d.repeat(trials, 1, 1), seg=16, keep_bounds=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="lane_map"):
        kl.lanes_filter(phi, q, z, r, y_d, m_d, lane_map + b)
