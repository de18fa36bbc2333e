"""Port parity: the stored sequential filter (kernel K6's ``store`` mode,
plain version on CPU tensors) and the RTS smoother (K8's plain version)
against ``metran_tpu.ops.kalman``, f64 on the CPU (the single-model
products are in ``test_torch_kalman_products.py``).

Inputs are ``tests/conftest.py::random_ssm`` panels (T <= 150, an
all-masked first step).  Bars: 1e-10 normwise relative against the JAX
functions (the lanes step forms ``P - k k' f`` as the JAX
``_sequential_update`` does, but sums in another order), 1e-9 against
``tests/reference_impl.py``'s numpy loops (a third oracle; its smoother
inverts with ``pinv``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import random_ssm
from reference_impl import np_filter, np_smoother

from metran_tpu.ops import kalman as jk
from metran_tpu_torch.kernels import smoother as ksm
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


@pytest.mark.parametrize("n_series,n_factors,t", [(5, 1, 150), (8, 2, 90)])
def test_stored_filter_and_smoother_match_jax(n_series, n_factors, t):
    rng = np.random.default_rng(11 + n_series)
    ss, y, mask = random_ssm(rng, n_series, n_factors, t=t)
    assert not mask[0].any()  # the all-masked first step
    want = jk.kalman_filter(ss, y, mask, engine="sequential", store=True)
    got = pk.kalman_filter(_port_ss(ss), y, mask, engine="sequential",
                           store=True, device="cpu")
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-10
    sw = jk.rts_smoother(ss, want)
    sg = pk.rts_smoother(_port_ss(ss), got)
    for g, w in zip(sg, sw):
        assert _rel(g, w) <= 1e-10


def test_stored_filter_and_smoother_match_numpy_oracle():
    rng = np.random.default_rng(3)
    ss, y, mask = random_ssm(rng, 4, 1, t=120)
    leaves = [np.asarray(a) for a in ss]
    ref = np_filter(*leaves, y, mask)
    got = pk.kalman_filter(_port_ss(ss), y, mask, engine="sequential",
                           store=True, device="cpu")
    for name in ("mean_p", "cov_p", "mean_f", "cov_f", "sigma", "detf"):
        assert _rel(getattr(got, name), ref[name]) <= 1e-9, name
    mean_s, cov_s = np_smoother(ref, leaves[0])
    sm = pk.rts_smoother(_port_ss(ss), got)
    assert _rel(sm.mean_s, mean_s) <= 1e-9
    assert _rel(sm.cov_s, cov_s) <= 1e-9


def test_batch_of_lanes_matches_one_model_at_a_time():
    rng = np.random.default_rng(5)
    models = [random_ssm(rng, 4, 1, t=60) for _ in range(3)]
    stacked = StateSpace(*(torch.stack([_port_ss(m[0])[i] for m in models])
                           for i in range(4)))
    ys = np.stack([m[1] for m in models])
    ms = np.stack([m[2] for m in models])
    batch = pk.kalman_filter(stacked, ys, ms, engine="sequential",
                             store=True, device="cpu")
    sm_batch = pk.rts_smoother(stacked, batch)
    assert batch.cov_p.shape == (3, 60, 5, 5)
    assert batch.sigma.shape == (3, 60)
    for i, (ss, y, mask) in enumerate(models):
        one = pk.kalman_filter(_port_ss(ss), y, mask, engine="sequential",
                               store=True, device="cpu")
        sm = pk.rts_smoother(_port_ss(ss), one)
        for a, b in zip((*batch, *sm_batch), (*one, *sm)):
            torch.testing.assert_close(a[i], b, rtol=1e-12, atol=1e-12)


def test_smoother_degrades_a_step_whose_predicted_cov_is_not_pd():
    """A hand-made filter result whose P_p at one step is indefinite:
    like ``jnp.linalg.cholesky``'s NaN in the JAX function, the failed
    Cholesky makes that step (and the carry) the filtered moments."""
    rng = np.random.default_rng(7)
    ss, y, mask = random_ssm(rng, 4, 1, t=40)
    filt = jk.kalman_filter(ss, y, mask, engine="sequential", store=True)
    bad = 17
    cov_p = np.array(filt.cov_p)
    cov_p[bad + 1] = cov_p[bad + 1] - 10.0 * np.eye(cov_p.shape[-1])
    filt = filt._replace(cov_p=jnp.asarray(cov_p))
    want = jk.rts_smoother(ss, filt)
    port_filt = pk.FilterResult(*(torch.as_tensor(np.array(a))
                                  for a in filt))
    got = pk.rts_smoother(_port_ss(ss), port_filt)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-10
    # the degraded step is the filtered one, carry included
    np.testing.assert_array_equal(got.mean_s[bad].numpy(),
                                  np.asarray(filt.mean_f[bad]))
    np.testing.assert_array_equal(got.cov_s[bad].numpy(),
                                  np.asarray(filt.cov_f[bad]))
    # a NaN in P_p degrades the step in the plain version too
    phi = torch.as_tensor(np.array(ss.phi))[None]
    args = [a[None] for a in port_filt]
    cov_nan = args[1].clone()
    cov_nan[0, bad + 1, 0, 0] = torch.nan
    ms, cs = ksm.rts_smooth(phi, args[2], args[3], args[0], cov_nan)
    assert torch.equal(ms[0, bad], args[2][0, bad])
    assert bool(torch.isfinite(cs).all())


def test_smoother_edges_and_mean_only():
    rng = np.random.default_rng(9)
    ss, y, mask = random_ssm(rng, 3, 1, t=30)
    filt = pk.kalman_filter(_port_ss(ss), y, mask, engine="sequential",
                            store=True, device="cpu")
    phi = torch.as_tensor(np.array(ss.phi))[None]
    args = [a[None] for a in (filt.mean_f, filt.cov_f, filt.mean_p,
                              filt.cov_p)]
    full = ksm.rts_smooth(phi, *args)
    mean_only = ksm.rts_smooth(phi, *args, want_cov=False)
    assert mean_only[1] is None
    assert torch.equal(mean_only[0], full[0])
    one = ksm.rts_smooth(phi, *(a[:, :1] for a in args))
    assert torch.equal(one[0][0, 0], args[0][0, 0])
    empty = ksm.rts_smooth(phi, *(a[:, :0] for a in args))
    assert empty[0].shape == (1, 0, 4) and empty[1].shape == (1, 0, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ksm.rts_smooth_kernel(phi, *args)
    with pytest.raises(ValueError):
        ksm.rts_smooth(phi, args[0], args[1][:, :5], args[2], args[3])


def test_joint_store_and_other_smoothers_raise_naming_the_roadmap():
    rng = np.random.default_rng(23)
    ss, y, mask = random_ssm(rng, 3, 1, t=10)
    pss = _port_ss(ss)
    # the joint store is ported (K1's store mode): its smoother is the
    # JAX function's
    joint = pk.rts_smoother(pss, pk.kalman_filter(pss, y, mask,
                                                  engine="joint", store=True,
                                                  device="cpu"),
                            engine="joint")
    jref = jk.rts_smoother(ss, jk.kalman_filter(ss, y, mask, engine="joint"),
                           engine="joint")
    np.testing.assert_allclose(joint.mean_s.numpy(), np.asarray(jref.mean_s),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(joint.cov_s.numpy(), np.asarray(jref.cov_s),
                               rtol=1e-10, atol=1e-12)
    filt = pk.kalman_filter(pss, y, mask, engine="sequential", store=True,
                            device="cpu")
    # engine="parallel" is the reverse associative scan (K20), the JAX
    # function's parallel_smoother
    par = pk.rts_smoother(pss, filt, engine="parallel")
    jpar = jk.rts_smoother(ss, jk.kalman_filter(ss, y, mask,
                                                engine="sequential"),
                           engine="parallel")
    np.testing.assert_allclose(par.mean_s.numpy(), np.asarray(jpar.mean_s),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(par.cov_s.numpy(), np.asarray(jpar.cov_s),
                               rtol=1e-10, atol=1e-12)
    # engine="sqrt" over a covariance-form result is the covariance
    # smoother (K8), as in the JAX function; a factored result goes to
    # the factored smoother (K10, tests/test_torch_sqrt_kalman.py)
    got = pk.rts_smoother(pss, filt, engine="sqrt")
    want = pk.rts_smoother(pss, filt, engine="sequential")
    torch.testing.assert_close(got.mean_s, want.mean_s, rtol=0, atol=0)
    torch.testing.assert_close(got.cov_s, want.cov_s, rtol=0, atol=0)
    ref = jk.rts_smoother(ss, jk.kalman_filter(ss, y, mask,
                                               engine="sequential"),
                          engine="sqrt")
    np.testing.assert_allclose(got.mean_s.numpy(), np.asarray(ref.mean_s),
                               rtol=1e-10, atol=1e-12)
