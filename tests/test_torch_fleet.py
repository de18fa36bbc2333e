"""Port parity: the lane-layout fleet fit (``metran_tpu_torch.parallel``:
``pack_fleet``, the autocorrelation init, the lanes deviance and its
gradient, the batched L-BFGS and ``fit_fleet(layout="lanes")``) against
``metran_tpu.parallel``, f64 on the CPU (the plain versions of kernels
K3/K4).

Tolerances: packing exact, the init 1e-12; deviances rtol 1e-12 and
gradients 1e-11; the optimizer state after 5 iterations 1e-9 (the
sides reduce in different orders and the line search compares values);
tail compaction at ``tests/test_parallel.py``'s 1e-12.  The fit to
convergence is held in ``tests/test_torch_fleet_fit.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metran_tpu.data import Panel as JPanel
from metran_tpu.parallel import fleet as jf
from metran_tpu.parallel import lanes_lbfgs as jlb
from metran_tpu_torch.data import Panel
from metran_tpu_torch.parallel import fleet as pf
from metran_tpu_torch.parallel import lanes_lbfgs as plb


def _structured(rng, batch=4, n=6, t=150, missing=0.2):
    """``tests/test_parallel.py::_structured_fleet``'s recipe: panels with
    a true common factor plus AR(1) specifics (a well-defined optimum);
    returns the JAX fleet and the port's on the CPU."""
    loadings = rng.uniform(0.4, 0.7, (batch, n, 1))
    alpha_c = rng.uniform(10, 40, (batch, 1))
    alpha_s = rng.uniform(5, 20, (batch, n))
    phi_c, phi_s = np.exp(-1.0 / alpha_c), np.exp(-1.0 / alpha_s)
    e_c = rng.normal(size=(t, batch, 1)) * np.sqrt(1 - phi_c**2)
    e_s = rng.normal(size=(t, batch, n)) * np.sqrt(1 - phi_s**2)
    common = np.zeros((t, batch, 1))
    specific = np.zeros((t, batch, n))
    for i in range(1, t):
        common[i] = phi_c * common[i - 1] + e_c[i]
        specific[i] = phi_s * specific[i - 1] + e_s[i]
    comm = np.sum(loadings**2, axis=2)
    y = np.transpose(specific * np.sqrt(1 - comm)[None]
                     + np.einsum("tbk,bnk->tbn", common, loadings), (1, 0, 2))
    mask = rng.uniform(size=y.shape) > missing
    y = np.where(mask, y, 0.0)
    jfleet = jf.Fleet(y=jnp.asarray(y), mask=jnp.asarray(mask),
                      loadings=jnp.asarray(loadings), dt=jnp.ones(batch),
                      n_series=jnp.full(batch, n, np.int32))
    pfleet = pf.Fleet(*(None if a is None else torch.as_tensor(np.asarray(a))
                        for a in jfleet))
    return jfleet, pfleet


def _panels(rng, shapes):
    """Heterogeneous (T, N) panels for ``pack_fleet`` in both packages."""
    jp, pp, lds = [], [], []
    for t, n in shapes:
        values = rng.normal(size=(t, n))
        mask = rng.uniform(size=(t, n)) > 0.25
        values = np.where(mask, values, 0.0)
        dt = float(rng.choice([1.0, 7.0]))
        args = (values, mask, None, [f"s{i}" for i in range(n)],
                np.ones(n), np.zeros(n), dt)
        jp.append(JPanel(*args))
        pp.append(Panel(*args))
        lds.append(rng.uniform(0.3, 0.8, (n, 1)))
    return jp, pp, lds


def test_pack_fleet_and_autocorr_init_parity():
    rng = np.random.default_rng(0)
    jp, pp, lds = _panels(rng, [(80, 4), (60, 3), (80, 5)])
    want = jf.pack_fleet(jp, lds, pad_batch_to=4, dtype=np.float64)
    got = pf.pack_fleet(pp, lds, pad_batch_to=4, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.y.dtype == torch.float64 and got.mask.dtype == torch.bool
    np.testing.assert_allclose(pf.autocorr_init_params(got).numpy(),
                               np.asarray(jf.autocorr_init_params(want)),
                               rtol=1e-12)
    _, pfleet = _structured(rng)
    jfleet = jf.Fleet(*(None if a is None else jnp.asarray(a.numpy())
                        for a in pfleet))
    np.testing.assert_allclose(pf.autocorr_init_params(pfleet).numpy(),
                               np.asarray(jf.autocorr_init_params(jfleet)),
                               rtol=1e-12)


def test_theta_alpha_round_trip_and_soft_cap():
    cap = float(np.log(jf.ALPHA_MAX))
    theta = np.linspace(-3.0, cap + 8.0, 41)
    got = pf._theta_to_alpha(torch.tensor(theta), cap)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jf._theta_to_alpha(jnp.asarray(theta), cap)),
        rtol=1e-14)
    alpha = np.array([1e-3, 1.0, 10.0, 250.0, 2e4, 2.9e4, 3e4, 1e6])
    back = pf._alpha_to_theta(torch.tensor(alpha), cap)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jf._alpha_to_theta(jnp.asarray(alpha), cap)),
        rtol=1e-12)
    inner = alpha[alpha < 2e4]
    np.testing.assert_allclose(
        pf._theta_to_alpha(pf._alpha_to_theta(torch.tensor(inner), cap),
                           cap).numpy(), inner, rtol=1e-9)


def test_fleet_deviance_and_value_and_grad_parity():
    rng = np.random.default_rng(1)
    jfleet, pfleet = _structured(rng, t=80)
    params = rng.uniform(3.0, 40.0, (jfleet.batch, jfleet.n_params))
    kw = dict(layout="lanes", remat_seg=32)
    np.testing.assert_allclose(
        pf.fleet_deviance(params, pfleet, **kw).numpy(),
        np.asarray(jf.fleet_deviance(jnp.asarray(params), jfleet, **kw)),
        rtol=1e-12)
    v_got, g_got = pf.fleet_value_and_grad(params, pfleet, **kw)
    v_want, g_want = jf.fleet_value_and_grad(jnp.asarray(params), jfleet, **kw)
    np.testing.assert_allclose(v_got.numpy(), np.asarray(v_want), rtol=1e-12)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), rtol=1e-11,
                               atol=1e-11)
    assert g_got.shape == (jfleet.batch, jfleet.n_params)


def test_lanes_lbfgs_state_direction_and_chunk_parity():
    """``init_state``, a 5-iteration chunk and the two-loop direction of
    the filled history against the JAX optimizer on the same objective."""
    rng = np.random.default_rng(2)
    jfleet, pfleet = _structured(rng, t=80)
    cap = float(np.log(jf.ALPHA_MAX))
    cfg = (1, 1e-8, 5, 60, jlb.default_ls_steps(4), 8, cap, 32, 1e-6)
    j_init, j_chunk = jf._make_lanes_runner(*cfg)
    p_init, p_chunk = pf._make_lanes_runner(*cfg)
    p0 = np.asarray(jf.autocorr_init_params(jfleet))
    theta = jf._alpha_to_theta(jnp.asarray(p0), cap)
    jargs = jf._lanes_args(theta, jfleet)
    theta_p, data, ld, dt = pf._lanes_args(np.asarray(theta), pfleet)
    pargs = (data, ld, dt, torch.arange(pfleet.batch, dtype=torch.int32))

    def close(got, want, tol):
        for name, g, w in zip(got._fields, got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                       atol=tol, err_msg=name)

    j_state = j_init(jargs[0], *jargs[1:])
    p_state = p_init(theta_p, *pargs)
    close(p_state, j_state, 1e-11)
    j_state = j_chunk(j_state, *jargs[1:])
    p_state = p_chunk(p_state, *pargs)
    close(p_state, j_state, 1e-9)
    assert p_state.count.dtype == torch.int32
    assert p_state.frozen.dtype == torch.bool
    assert int(p_state.count.min()) == 5
    np.testing.assert_allclose(plb._direction(p_state).numpy(),
                               np.asarray(jlb._direction(j_state)),
                               rtol=1e-9, atol=1e-9)


def test_fit_fleet_lanes_compaction_invariant():
    """Tail compaction (live lanes gathered into a smaller working set,
    reading the data through the lane map) changes no lane's result
    (the bars of ``tests/test_parallel.py``: the plain version's
    reductions over a narrower batch may round differently; the card's
    kernels are per lane)."""
    rng = np.random.default_rng(4)
    _, pfleet = _structured(rng, batch=6, t=40)
    kw = dict(maxiter=16, chunk=4, layout="lanes", remat_seg=16,
              max_linesearch_steps=4, stall_tol=1e-3)
    base = pf.fit_fleet(pfleet, compact_min=pfleet.batch, **kw)
    compacted = pf.fit_fleet(pfleet, compact_min=1, **kw)
    np.testing.assert_allclose(compacted.deviance.numpy(),
                               base.deviance.numpy(), rtol=1e-12)
    np.testing.assert_allclose(compacted.params.numpy(), base.params.numpy(),
                               rtol=1e-12)
    for name in ("iterations", "converged", "stalled", "nfev"):
        assert torch.equal(getattr(compacted, name), getattr(base, name))
    assert len(set(base.iterations.tolist())) > 1  # lanes froze apart


@pytest.mark.parametrize("option", [
    dict(layout="batch", checkpoint="fit.npz"), dict(checkpoint="fit.npz")])
def test_unported_fit_options_raise(option):
    # layout="batch" is ported (tests/test_torch_fleet_batch.py), and so
    # are the mesh, use_shard_map and the lane-tile pad
    # (tests/test_torch_fleet_mesh.py); the checkpoint raises in either
    # layout
    rng = np.random.default_rng(5)
    _, pfleet = _structured(rng, batch=2, t=20)
    kw = dict(layout="lanes", maxiter=2)
    kw.update(option)
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        pf.fit_fleet(pfleet, **kw)
