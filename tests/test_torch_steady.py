"""Port parity: steady-state (frozen-gain) serving ops — ``dare_solve``,
``steady_gains``, ``steady_filter_append`` and ``steady_converged`` of
``metran_tpu_torch.ops`` against the JAX package's on the same inputs
(f64, CPU: the plain versions of K15 and K14).

Bars: the DARE fixed point and every field of the gains to 1e-10
(relative, the four alpha regimes of ``tests/test_steady.py``); the
frozen recursion's means to 1e-12 (absolute) in every policy, form and
armed state, with ``broke``, the verdicts and the NaN pattern of the
z-scores equal; the frozen recursion equal to the port's exact
``filter_append`` at the fixed point to 1e-11 (the JAX test's bar).
"""

import numpy as np
import pytest
import torch

import metran_tpu.ops as jops
import metran_tpu_torch.ops as tops
from metran_tpu_torch.kernels import steady_filter_plain
from metran_tpu_torch.serve.engine import state_slot_index

torch.set_num_threads(1)

N, K = 4, 1

#: the four alpha regimes of tests/test_steady.py
ALPHAS = {
    "fast": (np.full(N, 0.1), np.full(K, 0.1)),
    "init": (np.full(N, 10.0), np.full(K, 10.0)),
    "near_unit_root": (np.full(N, 3e4), np.full(K, 3e4)),
    "mixed": (np.linspace(0.1, 100.0, N), np.array([1e4])),
}


def _params(regime, seed=0):
    rng = np.random.default_rng(seed)
    loadings = rng.uniform(0.3, 0.8, (N, K)) / np.sqrt(K)
    a_s, a_c = ALPHAS[regime]
    return a_s, a_c, loadings


def _both(regime, seed=0):
    a_s, a_c, lds = _params(regime, seed)
    return (jops.dfm_statespace(a_s, a_c, lds, 1.0),
            tops.dfm_statespace(a_s, a_c, lds, 1.0, device="cpu"))


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("regime", sorted(ALPHAS))
def test_dare_and_gains_match_jax(regime):
    jss, tss = _both(regime)
    want = jops.steady_gains(jss)
    got = tops.steady_gains(tss)
    for field in want._fields:
        err = _rel(getattr(got, field), getattr(want, field))
        assert err <= 1e-10, (regime, field, err)
    assert _rel(tops.dare_solve(tss), jops.dare_solve(jss)) <= 1e-10
    # the gains at a given steady covariance: no solve, the same fields
    again = tops.steady_gains(tss, p_pred=got.p_pred)
    for field in want._fields:
        assert _rel(getattr(again, field), getattr(got, field)) <= 1e-13


def test_dare_is_batched_over_models():
    """One call over models that share their dimensions is each model's
    own call (the service's one launch per freeze group)."""
    rngs = [_params(r, seed=i) for i, r in enumerate(sorted(ALPHAS))]
    a_s, a_c, lds = (np.stack(p) for p in zip(*rngs))
    batch = tops.steady_gains(tops.dfm_statespace(a_s, a_c, lds, 1.0,
                                                  device="cpu"))
    for i, (s, c, ld) in enumerate(rngs):
        one = tops.steady_gains(tops.dfm_statespace(s, c, ld, 1.0,
                                                    device="cpu"))
        for field in one._fields:
            assert _rel(getattr(batch, field)[i], getattr(one, field)) \
                <= 1e-13


def _stream(seed, k=6, spikes=True):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(k, N)) * 0.4
    if spikes:
        y[1, 2] += 6.0
        y[3, 0] -= 9.0
        y[4, 1] += 2.5
    return y, np.ones((k, N), bool)


FORMS = [(p, False) for p in ("off", "reject", "huber", "inflate")] + \
    [(p, True) for p in ("reject", "huber", "inflate")]


@pytest.mark.parametrize("armed", [True, False], ids=["armed", "disarmed"])
@pytest.mark.parametrize("policy,seq", FORMS,
                         ids=[f"{p}-{'slot' if s else 'vector'}"
                              for p, s in FORMS])
def test_steady_append_matches_jax(policy, seq, armed):
    jss, tss = _both("init", seed=3)
    gains = jops.steady_gains(jss)
    kg = gains.kgain_seq if seq else gains.kgain
    fd = gains.fdiag_seq if seq else gains.fdiag
    mean = np.random.default_rng(4).normal(size=N + K) * 0.3
    y, mask = _stream(5)
    want = jops.steady_filter_append(
        jss, mean, kg, fd, y, mask, armed=armed, policy=policy,
        nsigma=2.0, sequential_gate=seq)
    got = tops.steady_filter_append(
        tss, mean, np.asarray(kg), np.asarray(fd), y, mask, armed=armed,
        policy=policy, nsigma=2.0, sequential_gate=seq, device="cpu")
    assert np.abs(got[0].numpy() - np.asarray(want[0])).max() <= 1e-12
    for i in (1, 2):
        assert _rel(got[i], want[i]) <= 1e-12
    assert bool(got[3]) == bool(want[3])
    zs_g, zs_w = got[4].numpy(), np.asarray(want[4])
    assert np.array_equal(np.isnan(zs_g), np.isnan(zs_w))
    fin = np.isfinite(zs_w)
    assert np.abs(zs_g[fin] - zs_w[fin]).max() <= 1e-12
    assert np.array_equal(got[5].numpy(), np.asarray(want[5]))
    if armed and policy != "off":
        # the spikes trip the gate; reject and inflate break the frozen
        # recursion, huber is absorbed by the frozen gain
        assert got[5].numpy().any()
        assert bool(got[3]) == (policy in ("reject", "inflate"))
    else:
        assert not got[5].numpy().any() and not bool(got[3])


def test_broke_trips_on_a_nan_masked_slot():
    jss, tss = _both("init", seed=6)
    gains = tops.steady_gains(tss)
    y, mask = _stream(7, spikes=False)
    mask[2, 1] = False  # a missing (NaN) reading: masked
    y[2, 1] = 0.0
    mean = np.zeros(N + K)
    got = tops.steady_filter_append(tss, mean, gains.kgain, gains.fdiag, y,
                                    mask, device="cpu")
    want = jops.steady_filter_append(jss, mean, np.asarray(gains.kgain),
                                     np.asarray(gains.fdiag), y, mask)
    assert bool(got[3]) and bool(want[3])
    assert np.isnan(got[4][2, 1].item())
    clean = tops.steady_filter_append(tss, mean, gains.kgain, gains.fdiag,
                                      y, np.ones_like(mask), device="cpu")
    assert not bool(clean[3])
    # a non-finite mean breaks it too
    bad = tops.steady_filter_append(tss, np.full(N + K, np.nan), gains.kgain,
                                    gains.fdiag, y, np.ones_like(mask),
                                    device="cpu")
    assert bool(bad[3])


@pytest.mark.parametrize("seq", [False, True], ids=["vector", "slot"])
def test_bucket_padded_with_explicit_real(seq):
    """The serving layout: a (4, 5) model padded into the (8, 16) bucket,
    its frozen gain scattered into the padded slots, an explicit ``real``
    mask (the padded Z rows are nonzero, so the default would be wrong);
    a batch of three models, one of them with a masked slot."""
    n_pad, s_pad = 8, 16
    idx = state_slot_index(N, K, n_pad)
    rng = np.random.default_rng(8)
    rows = []
    for b in range(3):
        a_s = rng.uniform(3.0, 12.0, N)
        a_c = rng.uniform(5.0, 20.0, K)
        lds = rng.uniform(0.3, 0.8, (N, K))
        g = jops.steady_gains(jops.dfm_statespace(a_s, a_c, lds, 1.0))
        kg = np.zeros((s_pad, n_pad))
        kg[np.ix_(idx, np.arange(N))] = np.asarray(
            g.kgain_seq if seq else g.kgain)
        fd = np.ones(n_pad)
        fd[:N] = np.asarray(g.fdiag_seq if seq else g.fdiag)
        alpha = np.ones(s_pad)
        alpha[:N], alpha[n_pad:n_pad + K] = a_s, a_c
        ld = np.zeros((n_pad, s_pad - n_pad))
        ld[:N, :K] = lds
        rows.append((alpha, ld, kg, fd))
    alpha, ld, kg, fd = (np.stack(p) for p in zip(*rows))
    k = 4
    y = np.zeros((3, k, n_pad))
    mask = np.zeros((3, k, n_pad), bool)
    y[:, :, :N] = rng.normal(size=(3, k, N)) * 0.5
    y[0, 2, 3] += 12.0
    mask[:, :, :N] = True
    mask[2, 1, 0] = False
    real = np.zeros((3, n_pad), bool)
    real[:, :N] = True
    mean = np.zeros((3, s_pad))
    mean[:, idx] = rng.normal(size=(3, N + K)) * 0.2
    policy = "reject" if seq else "huber"
    got = tops.steady_filter_append(
        tops.dfm_statespace(alpha[:, :n_pad], alpha[:, n_pad:], ld, 1.0,
                            device="cpu"),
        mean, kg, fd, y, mask, armed=True, policy=policy, real=real,
        sequential_gate=seq, device="cpu")
    for b in range(3):
        jss = jops.dfm_statespace(alpha[b, :n_pad], alpha[b, n_pad:], ld[b],
                                  1.0)
        want = jops.steady_filter_append(
            jss, mean[b], kg[b], fd[b], y[b], mask[b], armed=True,
            policy=policy, real=real[b], sequential_gate=seq)
        assert np.abs(got[0][b].numpy() - np.asarray(want[0])).max() \
            <= 1e-12
        assert bool(got[3][b]) == bool(want[3])
        assert np.array_equal(got[5][b].numpy(), np.asarray(want[5]))
        assert np.array_equal(np.isnan(got[4][b].numpy()),
                              np.isnan(np.asarray(want[4])))
    assert bool(got[3][2])  # the masked slot
    assert bool(got[3][0]) == (policy == "reject")
    # padded slots carry the frozen gain's zeros: their state slots stay
    pad = np.setdiff1d(np.arange(s_pad), idx)
    assert np.array_equal(got[0][:, pad].numpy(),
                          np.zeros((3, len(pad))))


def test_steady_converged_matches_jax():
    rng = np.random.default_rng(9)
    b, s, k = 6, 5, 2
    before = rng.normal(size=(b, s, s))
    after = before + rng.uniform(-1, 1, (b, s, s)) * np.array(
        [1e-10, 1e-8, 1e-12, 1e-6, 1e-10, 0.0])[:, None, None]
    after[5, 0, 0] = np.nan
    mask = np.ones((b, k, N), bool)
    mask[2, 1, 3] = False
    real = np.ones((b, N), bool)
    want = np.asarray(jops.steady_converged(before, after, mask, real, 1e-9))
    got = tops.steady_converged(torch.as_tensor(before),
                                torch.as_tensor(after), mask, real, 1e-9)
    assert np.array_equal(got.numpy(), want)
    assert got.tolist() == [True, False, False, False, True, False]


def _converged_cov(tss, chunk=256, tol=1e-14, max_chunks=200):
    """The exact joint filter's fixed point, by the port's own
    ``filter_append`` over fully-observed zero rows."""
    s = tss.phi.shape[0]
    cov = torch.eye(s, dtype=torch.float64)
    y0, m0 = torch.zeros((chunk, N), dtype=torch.float64), \
        torch.ones((chunk, N), dtype=torch.bool)
    for _ in range(max_chunks):
        _, cov2, _, _ = tops.filter_append(tss, torch.zeros(s), cov, y0, m0,
                                           engine="joint", device="cpu")
        delta = float((cov2 - cov).abs().max())
        cov = cov2
        if delta < tol:
            return cov
    raise AssertionError(f"no fixed point (last delta {delta:.2e})")


def test_steady_append_matches_exact_at_fixed_point():
    """At the fixed point the frozen recursion IS the port's exact
    filter: the same means over a fully-observed stream (1e-11)."""
    _, tss = _both("init", seed=1)
    cov = _converged_cov(tss)
    gains = tops.steady_gains(tss)
    # the DARE's filtered covariance is that fixed point
    assert _rel(gains.p_filt, cov) <= 1e-10
    y = np.random.default_rng(2).normal(size=(16, N)) * 0.5
    mask = np.ones((16, N), bool)
    s = N + K
    m_exact = tops.filter_append(tss, np.zeros(s), cov, y, mask,
                                 engine="joint", device="cpu")[0]
    out = tops.steady_filter_append(tss, np.zeros(s), gains.kgain,
                                    gains.fdiag, y, mask, device="cpu")
    assert not bool(out[3])
    assert float((out[0] - m_exact).abs().max()) <= 1e-11


def test_plain_steady_filter_is_the_single_model_call():
    """The batched plain version over models equals each model's own
    call bit for bit (the kernel's oracle is per-model arithmetic)."""
    rng = np.random.default_rng(10)
    models = [_params("init", seed=s) for s in range(3)]
    a_s, a_c, lds = (np.stack(p) for p in zip(*models))
    tss = tops.dfm_statespace(a_s, a_c, lds, 1.0, device="cpu")
    g = tops.steady_gains(tss)
    mean = torch.as_tensor(rng.normal(size=(3, N + K)))
    y = torch.as_tensor(rng.normal(size=(3, 5, N)) * 2.0)
    mask = torch.ones((3, 5, N), dtype=torch.bool)
    real = torch.ones((3, N), dtype=torch.bool)
    armed = torch.tensor([True, False, True])
    out = steady_filter_plain(tss.phi, tss.z, g.kgain_seq, g.fdiag_seq,
                              real, mean, y, mask, armed, "huber", 4.0,
                              True)
    for b in range(3):
        one = steady_filter_plain(
            tss.phi[b:b + 1], tss.z[b:b + 1], g.kgain_seq[b:b + 1],
            g.fdiag_seq[b:b + 1], real[b:b + 1], mean[b:b + 1],
            y[b:b + 1], mask[b:b + 1], armed[b:b + 1], "huber", 4.0, True)
        for a, c in zip(out, one):
            assert torch.equal(a[b], c[0])
