"""Port parity: the joint engine of ``metran_tpu_torch.ops.kalman`` (the
plain version of kernel K1 on CPU tensors) against the JAX
``metran_tpu.ops.kalman`` joint engine, f64 on the CPU.

Tolerance: mean, cov, sigma and detf to ``rtol=1e-10, atol=1e-12`` —
the two sides factor the same innovation covariances with different
Cholesky/triangular-solve implementations (LAPACK vs XLA), so results
differ by roundoff amplified by the covariances' conditioning.
"""

import numpy as np
import pytest
import torch

from conftest import random_ssm
from metran_tpu.ops import kalman as jk
from metran_tpu.ops import statespace as jss
from metran_tpu_torch.kernels import joint_filter_append_plain
from metran_tpu_torch.ops import kalman as pk
from metran_tpu_torch.ops.statespace import StateSpace

TOL = dict(rtol=1e-10, atol=1e-12)


def _port_ss(ss):
    return StateSpace(*(torch.as_tensor(np.array(leaf)) for leaf in ss))


def _close(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("n_series,n_factors", [(5, 1), (8, 2), (3, 1)])
def test_kalman_filter_joint_store_false_parity(n_series, n_factors):
    rng = np.random.default_rng(20 + n_series + n_factors)
    ss, y, mask = random_ssm(rng, n_series, n_factors, t=200)
    want = jk.kalman_filter(ss, y, mask, engine="joint", store=False)
    got = pk.kalman_filter(_port_ss(ss), y, mask, engine="joint",
                           store=False, device="cpu")
    _close(got, want)
    assert got.sigma.shape == (200,)
    assert got.detf[0].item() == 0.0  # random_ssm masks the first step


@pytest.mark.parametrize("k", [1, 7])
@pytest.mark.parametrize("n_series,n_factors", [(5, 1), (8, 2)])
def test_filter_append_joint_parity(k, n_series, n_factors):
    rng = np.random.default_rng(40 + k + n_series)
    ss, y, mask = random_ssm(rng, n_series, n_factors, t=200)
    base = jk.kalman_filter(ss, y, mask, engine="joint", store=False)
    m0, c0 = np.asarray(base.mean_f), np.asarray(base.cov_f)
    y_new = rng.normal(size=(k, n_series))
    m_new = rng.uniform(size=(k, n_series)) > 0.3
    if k > 1:
        m_new[1] = False  # a fully masked appended row
    want = jk.filter_append(ss, m0, c0, y_new, m_new, engine="joint")
    got = pk.filter_append(_port_ss(ss), m0, c0, y_new, m_new,
                           engine="joint", device="cpu")
    _close(got, want)
    assert got[2].shape == (k,)


def test_filter_append_equals_refilter_and_batches():
    # appending rows == filtering the longer panel; a batch of models in
    # one call == each model alone
    rng = np.random.default_rng(5)
    models = [random_ssm(rng, 4, 1, t=60) for _ in range(3)]
    pss = [_port_ss(ss) for ss, _, _ in models]
    full = [pk.kalman_filter(p, y, m, engine="joint", store=False,
                             device="cpu")
            for p, (_, y, m) in zip(pss, models)]
    head = [pk.kalman_filter(p, y[:50], m[:50], engine="joint", store=False,
                             device="cpu")
            for p, (_, y, m) in zip(pss, models)]
    for p, h, f, (_, y, m) in zip(pss, head, full, models):
        app = pk.filter_append(p, h.mean_f, h.cov_f, y[50:], m[50:],
                               device="cpu")
        np.testing.assert_allclose(app[0].numpy(), f.mean_f.numpy(), **TOL)
        np.testing.assert_allclose(app[1].numpy(), f.cov_f.numpy(), **TOL)
    stacked = StateSpace(*(torch.stack(leaves) for leaves in zip(*pss)))
    ys = np.stack([y for _, y, _ in models])
    ms = np.stack([m for _, _, m in models])
    batch = pk.kalman_filter(stacked, ys, ms, engine="joint", store=False,
                             device="cpu")
    for i, f in enumerate(full):
        np.testing.assert_allclose(batch.mean_f[i].numpy(),
                                   f.mean_f.numpy(), rtol=1e-13, atol=1e-14)
        np.testing.assert_allclose(batch.detf[i].numpy(),
                                   f.detf.numpy(), rtol=1e-13, atol=1e-14)


def test_padded_bucket_parity_and_padding_is_invisible():
    # a (4, 5) model padded into an (8, 16) bucket: alpha 1.0 and zero
    # loadings in the padding, padded series always masked
    rng = np.random.default_rng(9)
    n, kf, n_pad, s_pad = 4, 1, 8, 16
    a_s = rng.uniform(5.0, 40.0, n)
    a_c = rng.uniform(10.0, 60.0, kf)
    lds = rng.uniform(0.3, 0.8, (n, kf))
    y = rng.normal(size=(120, n))
    mask = rng.uniform(size=(120, n)) > 0.3
    mask[0] = False
    y = np.where(mask, y, 0.0)
    alpha_s = np.ones(n_pad)
    alpha_s[:n] = a_s
    alpha_c = np.ones(s_pad - n_pad)
    alpha_c[:kf] = a_c
    lds_p = np.zeros((n_pad, s_pad - n_pad))
    lds_p[:n, :kf] = lds
    y_p = np.zeros((120, n_pad))
    m_p = np.zeros((120, n_pad), bool)
    y_p[:, :n], m_p[:, :n] = y, mask
    ss_p = jss.dfm_statespace(alpha_s, alpha_c, lds_p)
    want = jk.kalman_filter(ss_p, y_p, m_p, engine="joint", store=False)
    got = pk.kalman_filter(_port_ss(ss_p), y_p, m_p, engine="joint",
                           store=False, device="cpu")
    _close(got, want)
    # the real slots equal the unpadded model's filter
    small = pk.kalman_filter(_port_ss(jss.dfm_statespace(a_s, a_c, lds)),
                             y, mask, engine="joint", store=False,
                             device="cpu")
    idx = np.concatenate([np.arange(n), n_pad + np.arange(kf)])
    np.testing.assert_allclose(got.mean_f.numpy()[idx],
                               small.mean_f.numpy(), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got.cov_f.numpy()[np.ix_(idx, idx)],
                               small.cov_f.numpy(), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got.detf.numpy(), small.detf.numpy(),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("k", [1, 7])
def test_indefinite_innovation_covariance_is_a_noop_in_both(k):
    rng = np.random.default_rng(13)
    ss, y, mask = random_ssm(rng, 4, 1, t=30)
    q = np.array(ss.q)
    q[0, 0] = -10.0  # negative process noise -> indefinite F
    bad = type(ss)(phi=ss.phi, q=q, z=ss.z, r=ss.r)
    m0 = rng.normal(size=5) * 0.1
    c0 = np.eye(5) * 0.5
    y_new = rng.normal(size=(k, 4))
    m_new = np.ones((k, 4), bool)
    want = jk.filter_append(bad, m0, c0, y_new, m_new, engine="joint")
    got = pk.filter_append(_port_ss(bad), m0, c0, y_new, m_new,
                           engine="joint", device="cpu")
    assert np.all(np.isinf(np.asarray(want[3])))
    assert torch.isinf(got[3]).all()
    np.testing.assert_array_equal(got[2].numpy(), 0.0)
    _close(got, want)
    # the carried moments are the predicted ones, k times over
    phi, qq = np.asarray(ss.phi), q
    m_exp, c_exp = m0, c0
    for _ in range(k):
        m_exp = phi * m_exp
        c_exp = phi[:, None] * c_exp * phi[None, :] + qq
    np.testing.assert_allclose(got[0].numpy(), m_exp, rtol=1e-13)
    np.testing.assert_allclose(got[1].numpy(), c_exp, rtol=1e-13)


def test_core_step_matches_jax_filter_update():
    rng = np.random.default_rng(17)
    ss, y, mask = random_ssm(rng, 6, 2, t=40)
    base = jk.kalman_filter(ss, y, mask, engine="joint", store=False)
    m0, c0 = np.array(base.mean_f), np.array(base.cov_f)
    y_t = rng.normal(size=6)
    m_t = np.array([1, 0, 1, 1, 0, 1], bool)
    want = jk.filter_update(ss, m0, c0, y_t, m_t, engine="joint")
    pss = _port_ss(ss)
    core = pk._make_core_step(pss, "joint")
    got = core(torch.as_tensor(m0), torch.as_tensor(c0),
               torch.as_tensor(y_t), torch.as_tensor(m_t))
    _close(got[2:], want)


def test_project_parity():
    rng = np.random.default_rng(19)
    z = rng.normal(size=(4, 6))
    means = rng.normal(size=(5, 6))
    a = rng.normal(size=(5, 6, 6))
    covs = a @ np.swapaxes(a, -1, -2)
    want = jk.project(z, means, covs)
    got = pk.project(torch.as_tensor(z), torch.as_tensor(means),
                     torch.as_tensor(covs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13,
                                   atol=1e-13)


def test_plain_kernel_version_is_what_cpu_tensors_run():
    rng = np.random.default_rng(23)
    ss, y, mask = random_ssm(rng, 3, 1, t=12)
    pss = _port_ss(ss)
    leaves = [leaf[None] for leaf in pss]
    s = pss.phi.shape[0]
    mean0 = torch.zeros(1, s, dtype=torch.float64)
    cov0 = torch.eye(s, dtype=torch.float64)[None]
    direct = joint_filter_append_plain(
        *leaves, mean0, cov0, torch.as_tensor(y)[None],
        torch.as_tensor(mask)[None],
    )
    via_op = pk.kalman_filter(pss, y, mask, engine="joint", store=False,
                              device="cpu")
    for a, b in zip(direct, (via_op.mean_f, via_op.cov_f, via_op.sigma,
                             via_op.detf)):
        torch.testing.assert_close(a[0], b, rtol=0, atol=0)


@pytest.mark.parametrize("engine", ["sequential", "sqrt", "parallel"])
def test_unported_engines_and_store_raise(engine):
    rng = np.random.default_rng(29)
    ss, y, mask = random_ssm(rng, 3, 1, t=5)
    pss = _port_ss(ss)
    if engine == "sqrt":
        # ported (kernel K9): kalman_filter reconstitutes the factors'
        # covariances as the JAX function does; the covariance-form
        # append refuses the engine as JAX's does
        for store in (False, True):
            got = pk.kalman_filter(pss, y, mask, engine="sqrt", store=store,
                                   device="cpu")
            want = jk.kalman_filter(ss, y, mask, engine="sqrt", store=store)
            _close(got, want)
        with pytest.raises(ValueError, match="sqrt_filter_append"):
            pk.filter_append(pss, np.zeros(4), np.eye(4), y[:1], mask[:1],
                             engine=engine, device="cpu")
    elif engine == "sequential":
        # ported: the append is kernel K12 with the gate off
        _close(pk.filter_append(pss, np.zeros(4), np.eye(4), y[:1],
                                mask[:1], engine=engine, device="cpu"),
               jk.filter_append(ss, np.zeros(4), np.eye(4), y[:1], mask[:1],
                                engine=engine))
    else:
        # ported (kernel K19): the associative-scan filter keeps the JAX
        # function's store=False shapes; the covariance append has no
        # such engine (the JAX one has no update for it either)
        for store in (False, True):
            got = pk.kalman_filter(pss, y, mask, engine=engine, store=store,
                                   device="cpu")
            want = jk.kalman_filter(ss, y, mask, engine=engine, store=store)
            _close(got, want)
        with pytest.raises(ValueError, match="no path through this"):
            pk.filter_append(pss, np.zeros(4), np.eye(4), y[:1], mask[:1],
                             engine=engine, device="cpu")
    # the joint store is ported too (K1's store mode)
    _close(pk.kalman_filter(pss, y, mask, engine="joint", store=True,
                            device="cpu"),
           jk.kalman_filter(ss, y, mask, engine="joint", store=True))
    # the sequential engine stores its per-step moments (kernel K6's
    # store mode); tests/test_torch_smoother.py holds them against JAX
    stored = pk.kalman_filter(pss, y, mask, engine="sequential", store=True,
                              device="cpu")
    assert stored.cov_p.shape == (5, 4, 4)


def test_kalman_filter_defaults_are_the_jax_functions():
    """``kalman_filter(ss, y, mask)`` with the JAX defaults
    (``engine="sequential", store=True``): every step's stored moments,
    shape (T, n), equal to the JAX function's default call."""
    rng = np.random.default_rng(31)
    ss, y, mask = random_ssm(rng, 4, 1, t=40)
    want = jk.kalman_filter(ss, y, mask)
    got = pk.kalman_filter(_port_ss(ss), y, mask, device="cpu")
    assert got.mean_f.shape == np.asarray(want.mean_f).shape == (40, 5)
    assert got.cov_p.shape == (40, 5, 5)
    _close(got, want)


@pytest.mark.parametrize("n_series,n_factors", [(5, 1), (4, 2)])
def test_kalman_filter_joint_store_parity_and_its_last_step(n_series,
                                                            n_factors):
    """``kalman_filter(engine="joint", store=True)`` (the plain version
    of K1's ``store`` mode) against the JAX function, every step's
    moments; its last filtered step is the carry-only pass, bit for
    bit, and a batch stores each model's own steps."""
    rng = np.random.default_rng(41)
    ss, y, mask = random_ssm(rng, n_series, n_factors, t=60)
    pss = _port_ss(ss)
    want = jk.kalman_filter(ss, y, mask, engine="joint", store=True)
    got = pk.kalman_filter(pss, y, mask, engine="joint", store=True,
                           device="cpu")
    assert got.cov_p.shape == (60, n_series + n_factors,
                               n_series + n_factors)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-13)
    carry = pk.kalman_filter(pss, y, mask, engine="joint", store=False,
                             device="cpu")
    assert torch.equal(got.mean_f[-1], carry.mean_f)
    assert torch.equal(got.cov_f[-1], carry.cov_f)
    assert torch.equal(got.sigma, carry.sigma)
    stacked = StateSpace(*(torch.stack([leaf, leaf]) for leaf in pss))
    batch = pk.kalman_filter(stacked, np.stack([y, y]), np.stack([mask] * 2),
                             engine="joint", store=True, device="cpu")
    for b, g in zip(batch, got):
        assert torch.equal(b[1], g)


def test_c2_default_engines_are_the_jax_functions():
    """The three defaults ROADMAP C2 listed: ``filter_append`` is
    ``"sequential"``, ``innovations`` and ``sample_states`` are
    ``"joint"``, as in the JAX package; each default call equals the
    JAX function's default call."""
    import inspect

    for name in ("filter_append", "innovations", "sample_states"):
        p_def = inspect.signature(getattr(pk, name)).parameters["engine"]
        j_def = inspect.signature(getattr(jk, name)).parameters["engine"]
        assert p_def.default == j_def.default, name
    rng = np.random.default_rng(43)
    ss, y, mask = random_ssm(rng, 4, 1, t=50)
    pss = _port_ss(ss)
    base = jk.kalman_filter(ss, y[:40], mask[:40], engine="joint",
                            store=False)
    m0, c0 = np.asarray(base.mean_f), np.asarray(base.cov_f)
    _close(pk.filter_append(pss, m0, c0, y[40:], mask[40:], device="cpu"),
           jk.filter_append(ss, m0, c0, y[40:], mask[40:]))
    _close(pk.innovations(pss, y, mask, device="cpu"),
           jk.innovations(ss, y, mask))
    # sample_states: JAX's own normals fed to the port (its RNG differs)
    import jax

    from test_torch_kalman_products import _jax_normals

    key = jax.random.PRNGKey(5)
    want = jk.sample_states(ss, y, mask, key, n_draws=3)
    got = pk._sample_states_given(pss, y, mask,
                                  *_jax_normals(key, 3, 50, 5, 4),
                                  engine="joint", device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-10)
