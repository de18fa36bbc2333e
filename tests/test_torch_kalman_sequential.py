"""Port parity: the sequential engine of ``metran_tpu_torch.ops.kalman``
(``kalman_filter``/``deviance``/``log_likelihood`` over the plain
version of kernel K3, one lane per model, and K4 under differentiation)
against ``metran_tpu.ops.kalman`` and the reference numpy filter, f64 on
the CPU.

Tolerances: values rtol 1e-12 (``tests/test_metran.py``'s golden bar;
the sides sum in different orders), gradients rtol/atol 1e-10.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metran_tpu
from conftest import random_ssm
from metran_tpu.ops import kalman as jk
from metran_tpu_torch.ops import dfm_statespace, kalman as pk
from metran_tpu_torch.ops.statespace import StateSpace
from reference_impl import np_deviance, np_filter


def _port_ss(ss):
    return StateSpace(*(torch.as_tensor(np.array(leaf)) for leaf in ss))


@pytest.mark.parametrize("n_series,n_factors", [(5, 1), (8, 2)])
def test_sequential_filter_and_deviance_parity(n_series, n_factors):
    """``kalman_filter``/``deviance``/``log_likelihood`` with
    ``engine="sequential"`` against the JAX functions and the reference
    numpy filter (a third oracle)."""
    rng = np.random.default_rng(30 + n_series)
    ss, y, mask = random_ssm(rng, n_series, n_factors, t=100)
    want = jk.kalman_filter(ss, y, mask, engine="sequential", store=False)
    got = pk.kalman_filter(_port_ss(ss), y, mask, engine="sequential",
                           store=False, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-13)
    dev_j = float(jk.deviance(ss, y, mask, engine="sequential"))
    dev_p = pk.deviance(_port_ss(ss), y, mask, device="cpu")
    np.testing.assert_allclose(dev_p.item(), dev_j, rtol=1e-12)
    ref = np_filter(*(np.asarray(a) for a in ss), y, mask)
    np.testing.assert_allclose(dev_p.item(), np_deviance(ref, mask),
                               rtol=1e-12)
    np.testing.assert_allclose(
        pk.log_likelihood(_port_ss(ss), y, mask, device="cpu").item(),
        float(jk.log_likelihood(ss, y, mask)), rtol=1e-12)


def test_sequential_deviance_gradient_matches_jax():
    """The gradient w.r.t. the transition parameters through K4 (the
    batch-layout ``deviance`` differentiates into ``ss.phi`` and
    ``diag(ss.q)``) against JAX autodiff through the same engine."""
    rng = np.random.default_rng(31)
    ss, y, mask = random_ssm(rng, 4, 1, t=90)

    def jdev(phi, qd):
        ss_j = ss._replace(phi=phi, q=jnp.diag(qd))
        return jk.deviance(ss_j, y, mask, engine="sequential",
                           grad="autodiff")

    gj = jax.grad(jdev, argnums=(0, 1))(ss.phi, jnp.diagonal(ss.q))
    phi = torch.tensor(np.asarray(ss.phi), requires_grad=True)
    qd = torch.tensor(np.diagonal(np.asarray(ss.q)), requires_grad=True)
    ss_p = StateSpace(phi, torch.diag(qd), torch.tensor(np.asarray(ss.z)),
                      torch.tensor(np.asarray(ss.r)))
    for grad in ("adjoint", "autodiff"):
        val = pk.deviance(ss_p, y, mask, remat_seg=32, grad=grad)
        gp = torch.autograd.grad(val, [phi, qd])
        for g, w in zip(gp, gj):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                       atol=1e-10)


def test_sequential_engine_rejects_a_non_diagonal_q():
    rng = np.random.default_rng(32)
    ss, y, mask = random_ssm(rng, 3, 1, t=10)
    q = np.array(ss.q)
    q[0, 1] = q[1, 0] = 0.01
    bad = _port_ss(ss._replace(q=q))
    with pytest.raises(ValueError, match="diagonal"):
        pk.kalman_filter(bad, y, mask, engine="sequential", device="cpu")
    with pytest.raises(ValueError, match="diagonal"):
        pk.deviance(bad, y, mask, device="cpu")


def test_golden_deviances_of_the_reference_example(series_list):
    """The reference's deviance at its initial parameters and at three
    random parameter vectors (``tests/golden/metran_example.json``), the
    panel and loadings taken from the JAX ``Metran`` with the golden
    factors; the four evaluations are one batch."""
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
    got = pk.deviance(ss, y, mask, warmup=m.settings["warmup"], device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
