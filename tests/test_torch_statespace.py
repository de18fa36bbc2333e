"""Port parity: ``metran_tpu_torch.ops.statespace`` against the JAX
``metran_tpu.ops.statespace`` on the same numpy inputs (CPU).

Tolerances: f64 ``rtol=1e-14`` (the same elementwise exp/expm1
formulas), f32 ``rtol=1e-6`` (one or two f32 roundings apart between
XLA's and PyTorch's transcendental implementations).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from metran_tpu.ops import statespace as jss
from metran_tpu_torch.ops import statespace as pss

GOLDEN = Path(__file__).resolve().parent / "golden" / "metran_example.json"
TOL = {np.float64: dict(rtol=1e-14, atol=1e-15),
       np.float32: dict(rtol=1e-6, atol=1e-7)}


def _params(rng, n, k, dtype, batch=()):
    a_s = rng.uniform(5.0, 50.0, (*batch, n)).astype(dtype)
    a_c = rng.uniform(5.0, 50.0, (*batch, k)).astype(dtype)
    lds = (rng.uniform(0.3, 0.9, (*batch, n, k)) / np.sqrt(k)).astype(dtype)
    return a_s, a_c, lds


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n,k", [(5, 1), (8, 2), (3, 3)])
def test_dfm_statespace_unbatched_parity(dtype, n, k):
    rng = np.random.default_rng(100 + n + k)
    a_s, a_c, lds = _params(rng, n, k, dtype)
    want = jss.dfm_statespace(a_s, a_c, lds, 1.0)
    got = pss.dfm_statespace(a_s, a_c, lds, 1.0, device="cpu")
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == (
            torch.float32 if dtype == np.float32 else torch.float64
        )
        np.testing.assert_allclose(g.numpy(), w, **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dfm_statespace_batched_matches_vmapped_jax(dtype):
    import jax

    rng = np.random.default_rng(7)
    a_s, a_c, lds = _params(rng, 6, 2, dtype, batch=(4,))
    dts = np.array([1.0, 0.5, 2.0, 1.0], dtype)
    want = jax.vmap(jss.dfm_statespace)(a_s, a_c, lds, dts)
    got = pss.dfm_statespace(a_s, a_c, lds, dts, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL[dtype])
    assert got.n_state == 8 and got.n_obs == 6


def test_dfm_statespace_near_unit_root_q_keeps_digits_in_f32():
    # the expm1 form of 1 - phi^2 keeps f32 digits at alpha ~ 3e4
    a_s = np.array([3e4, 10.0], np.float32)
    a_c = np.array([3e4], np.float32)
    lds = np.array([[0.5], [0.6]], np.float32)
    got = pss.dfm_statespace(a_s, a_c, lds, device="cpu")
    exact = -np.expm1(-2.0 / np.float64(3e4))
    np.testing.assert_allclose(
        got.q[2, 2].item(), exact, rtol=1e-6
    )
    want = jss.dfm_statespace(a_s, a_c, lds)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q),
                               **TOL[np.float32])


def test_dfm_statespace_golden_at_init():
    golden = json.loads(GOLDEN.read_text())
    p = np.asarray(golden["p_init"], float)
    factors = np.asarray(golden["factors"], float)
    n = factors.shape[0]
    ss = pss.dfm_statespace(p[:n], p[n:], factors, 1.0, device="cpu")
    np.testing.assert_allclose(
        ss.phi.numpy(), golden["transition_matrix_diag_at_init"],
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        torch.diagonal(ss.q).numpy(),
        golden["transition_covariance_diag_at_init"], rtol=1e-12,
    )
    np.testing.assert_allclose(
        ss.z.numpy(), golden["observation_matrix"], rtol=1e-12
    )


@pytest.mark.parametrize("batch", [(), (3,)])
def test_scale_observation_matrix_and_ar1_decay_parity(batch):
    rng = np.random.default_rng(11)
    z = rng.normal(size=(*batch, 4, 5))
    scale = rng.uniform(0.5, 2.0, (*batch, 4))
    got = pss.scale_observation_matrix(torch.as_tensor(z),
                                       torch.as_tensor(scale))
    if batch:
        want = np.stack([np.asarray(jss.scale_observation_matrix(a, s))
                         for a, s in zip(z, scale)])
    else:
        want = np.asarray(jss.scale_observation_matrix(z, scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)
    alpha = rng.uniform(1.0, 100.0, 7)
    np.testing.assert_allclose(
        pss.ar1_decay(torch.as_tensor(alpha), 1.5).numpy(),
        np.asarray(jss.ar1_decay(alpha, 1.5)), rtol=1e-15,
    )


def test_statespace_follows_tensor_device_and_needs_one_otherwise():
    rng = np.random.default_rng(3)
    a_s, a_c, lds = _params(rng, 3, 1, np.float64)
    ss = pss.dfm_statespace(torch.as_tensor(a_s), torch.as_tensor(a_c),
                            torch.as_tensor(lds))
    assert ss.phi.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device required"):
            pss.dfm_statespace(a_s, a_c, lds)
