"""Port parity: the associative-scan engines (``metran_tpu_torch.ops.
pkalman``, the plain versions of kernels K19-K22) against
``metran_tpu.ops.pkalman`` on the CPU, in f64.

Bars, the JAX tests' (``tests/test_pkalman.py``,
``tests/test_sqrt_kalman.py``): filter moments and terms and smoother
moments within 1e-9 of the JAX functions (relative to each output's
scale); square-root factors compared through ``S S'`` (a factor is
unique only up to column signs, and not at all where ``r = 0`` makes it
rank-deficient); every ``block`` (one chunk, the automatic chunk length,
a short chunk with a ragged tail) within 1e-10 of the others; a step
that cannot factor books ``+inf`` exactly.  The CPU autograd gradient of
``engine="parallel"`` is held to the sequential engine's at rtol 1e-7
(``tests/test_pkalman.py``); JAX's gradient of its associative scan is
not taken in this process (its suite runs it in a subprocess, XLA:CPU
has crashed on it).
"""

import numpy as np
import pytest
import torch
from conftest import random_ssm

from metran_tpu import ops as jops
from metran_tpu_torch import kernels
from metran_tpu_torch import ops as pops
from metran_tpu_torch.kernels import pkalman as kpk
from metran_tpu_torch.ops.kalman import NotPortedError
from metran_tpu_torch.ops.pkalman import _refuse_card_grad
from metran_tpu_torch.ops.statespace import StateSpace, dfm_statespace

torch.set_num_threads(1)

BLOCKS = (None, "auto", 7)


def _port(ss):
    return StateSpace(*(torch.as_tensor(np.array(leaf)) for leaf in ss))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    if not fin.any():
        return 0.0
    return float(np.abs(got[fin] - want[fin]).max()
                 / max(np.abs(want[fin]).max(), 1e-300))


def _outer(c):
    c = _np(c)
    return c @ np.swapaxes(c, -1, -2)


@pytest.fixture(scope="module")
def ssm():
    ss, y, mask = random_ssm(np.random.default_rng(42), n_series=5,
                             n_factors=2, t=60, missing=0.3)
    mask[17] = False  # an all-missing step inside the series
    return ss, np.where(mask, y, 0.0), mask


@pytest.fixture(scope="module")
def jax_results(ssm):
    ss, y, mask = ssm
    filt = jops.parallel_filter(ss, y, mask)
    sq = jops.sqrt_parallel_filter(ss, y, mask)
    return {"filter": filt, "smoother": jops.parallel_smoother(ss, filt),
            "sqrt_filter": sq,
            "sqrt_smoother": jops.sqrt_parallel_smoother(ss, sq)}


@pytest.mark.parametrize("block", BLOCKS)
def test_parallel_filter_and_smoother_match_jax(ssm, jax_results, block):
    ss, y, mask = ssm
    pss = _port(ss)
    got = pops.parallel_filter(pss, y, mask, block=block, device="cpu")
    for g, w in zip(got, jax_results["filter"]):
        assert _rel(g, w) <= 1e-9
    sm = pops.parallel_smoother(pss, got, block=block)
    for g, w in zip(sm, jax_results["smoother"]):
        assert _rel(g, w) <= 1e-9
    assert (float(pops.parallel_deviance(pss, y, mask, block=block,
                                         device="cpu"))
            == pytest.approx(float(jops.parallel_deviance(ss, y, mask)),
                             rel=1e-10))


@pytest.mark.parametrize("block", BLOCKS)
def test_sqrt_parallel_filter_and_smoother_match_jax(ssm, jax_results,
                                                     block):
    ss, y, mask = ssm
    pss = _port(ss)
    got = pops.sqrt_parallel_filter(pss, y, mask, block=block, device="cpu")
    want = jax_results["sqrt_filter"]
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (1, 3):  # factors, through S S'
            g, w = _outer(g), _outer(w)
        assert _rel(g, w) <= 1e-9, i
    assert np.all(np.triu(_np(got.chol_f), 1) == 0)
    sm = pops.sqrt_parallel_smoother(pss, got, block=block)
    wsm = jax_results["sqrt_smoother"]
    assert _rel(sm.mean_s, wsm.mean_s) <= 1e-9
    assert _rel(_outer(sm.chol_s), _outer(wsm.chol_s)) <= 1e-9
    assert (float(pops.sqrt_parallel_deviance(pss, y, mask, block=block,
                                              device="cpu"))
            == pytest.approx(float(jops.sqrt_parallel_deviance(ss, y, mask)),
                             rel=1e-10))


@pytest.mark.parametrize("engine", ["parallel", "sqrt_parallel"])
def test_every_block_agrees_and_a_batch_is_its_models(engine):
    rng = np.random.default_rng(3)
    models = [random_ssm(rng, n_series=4, n_factors=1, t=41)
              for _ in range(3)]
    pss = [_port(m[0]) for m in models]
    filt = (pops.parallel_filter if engine == "parallel"
            else pops.sqrt_parallel_filter)
    runs = {}
    for block in (None, "auto", 1, 5, 41, 100):
        runs[block] = filt(pss[0], models[0][1], models[0][2], block=block,
                           device="cpu")
    def parts(res):  # square-root factors through S S'
        return [_outer(x) if engine == "sqrt_parallel" and i in (1, 3)
                else _np(x) for i, x in enumerate(res)]

    ref = parts(runs[None])
    for block, res in runs.items():
        for g, w in zip(parts(res), ref):
            assert _rel(g, w) <= 1e-10, block
    # a batch (leaves leading with B) is its models, one by one
    batch = StateSpace(*(torch.stack(leaves) for leaves in zip(*pss)))
    y = np.stack([m[1] for m in models])
    mask = np.stack([m[2] for m in models])
    got = filt(batch, y, mask, device="cpu")
    for b in range(3):
        one = filt(pss[b], models[b][1], models[b][2], device="cpu")
        for g, w in zip(parts(got), parts(one)):
            assert _rel(g[b], w) <= 1e-12
    dev = (pops.parallel_deviance if engine == "parallel"
           else pops.sqrt_parallel_deviance)(batch, y, mask, device="cpu")
    assert dev.shape == (3,)
    for b in range(3):
        assert float(dev[b]) == pytest.approx(float(pops.deviance(
            pss[b], models[b][1], models[b][2], engine="sequential",
            device="cpu")), rel=1e-10)


def _jax_filter(jax_results, engine, store):
    """The JAX ``kalman_filter(engine=..., store=...)`` result, formed from
    the JAX scan's own outputs as that function forms it (covariances
    reconstituted from factors; with ``store=False`` the last step's
    moments and every step's terms) — without compiling it again."""
    if engine == "parallel":
        res = [np.asarray(x) for x in jax_results["filter"]]
    else:
        res = [np.asarray(x) for x in jax_results["sqrt_filter"]]
        res[1], res[3] = _outer(res[1]), _outer(res[3])
    if store:
        return res
    return res[2][-1], res[3][-1], res[2][-1], res[3][-1], res[4], res[5]


@pytest.mark.parametrize("engine", ["parallel", "sqrt_parallel"])
@pytest.mark.parametrize("store", [False, True])
def test_kalman_filter_dispatch_and_store_shapes(ssm, jax_results, engine,
                                                 store):
    ss, y, mask = ssm
    got = pops.kalman_filter(_port(ss), y, mask, engine=engine, store=store,
                             device="cpu")
    for g, w in zip(got, _jax_filter(jax_results, engine, store)):
        assert _rel(g, w) <= 1e-9
    if not store:
        assert got.mean_f.shape == (7,) and got.cov_f.shape == (7, 7)
        assert got.sigma.shape == (60,)


@pytest.mark.parametrize("engine", ["parallel", "sqrt_parallel"])
def test_deviance_and_rts_smoother_dispatch(ssm, jax_results, engine):
    ss, y, mask = ssm
    pss = _port(ss)
    got = float(pops.deviance(pss, y, mask, engine=engine, device="cpu"))
    want = (jops.parallel_deviance if engine == "parallel"
            else jops.sqrt_parallel_deviance)(ss, y, mask)
    assert got == pytest.approx(float(want), rel=1e-10)
    with pytest.raises(ValueError, match="remat_seg"):
        pops.deviance(pss, y, mask, engine=engine, remat_seg=16,
                      device="cpu")
    with pytest.raises(ValueError, match="adjoint"):
        pops.deviance(pss, y, mask, engine=engine, grad="adjoint",
                      device="cpu")
    # a factored result under either associative-scan engine goes to the
    # factored smoother (K22) and comes back as covariances, as JAX's
    # rts_smoother routes it
    sq = pops.sqrt_parallel_filter(pss, y, mask, device="cpu")
    got = pops.rts_smoother(pss, sq, engine=engine)
    want = jax_results["sqrt_smoother"]
    assert _rel(got.mean_s, want.mean_s) <= 1e-9
    assert _rel(got.cov_s, _outer(want.chol_s)) <= 1e-9
    # a covariance result under "parallel" goes to K20; under
    # "sqrt_parallel" to the sequential smoother, as in JAX
    filt = pops.kalman_filter(pss, y, mask, engine="parallel", device="cpu")
    got = pops.rts_smoother(pss, filt, engine=engine)
    want = (jax_results["smoother"] if engine == "parallel"
            else pops.rts_smoother(pss, filt, engine="sequential"))
    assert _rel(got.mean_s, want.mean_s) <= 1e-9
    assert _rel(got.cov_s, want.cov_s) <= 1e-9


def test_indefinite_step_books_inf_on_both_engines(ssm):
    """``r = -2``: no innovation covariance factors, every observed step
    books ``detf = +inf`` and the deviance is ``+inf`` exactly (JAX
    ``tests/test_sqrt_kalman.py``), on the kernels' plain versions."""
    ss, y, mask = ssm
    bad = ss._replace(r=np.full(np.asarray(ss.r).shape, -2.0))
    pbad = _port(bad)
    for engine in ("parallel", "sqrt_parallel"):
        assert float(pops.deviance(pbad, y, mask, engine=engine,
                                   device="cpu")) == np.inf
        got = pops.kalman_filter(pbad, y, mask, engine=engine, device="cpu")
        want = jops.kalman_filter(bad, y, mask, engine=engine)
        seen = mask.any(axis=1)
        assert np.all(_np(got.detf)[seen] == np.inf)
        assert np.array_equal(_np(got.detf) == np.inf,
                              np.asarray(want.detf) == np.inf)
        assert np.isfinite(_np(got.mean_f)).all()


def _alpha_deviance(engine, y, mask, n=5, k=2, grad=None):
    rng = np.random.default_rng(7)
    loadings = torch.as_tensor(rng.uniform(0.3, 0.8, (n, k)) / np.sqrt(k))
    alpha = torch.tensor(rng.uniform(5.0, 40.0, n + k), requires_grad=True)
    ss = dfm_statespace(alpha[:n], alpha[n:], loadings, 1.0, device="cpu",
                        dtype=torch.float64)
    value = pops.deviance(ss, y, mask, warmup=1, engine=engine, grad=grad,
                          device="cpu")
    (g,) = torch.autograd.grad(value, alpha)
    return float(value), g.numpy()


def test_parallel_gradients_match_the_sequential_engines(ssm):
    """CPU autograd through the plain associative scans (the JAX
    engines' autodiff): ``"parallel"`` within rtol 1e-7 of the
    sequential engine's gradient (``tests/test_pkalman.py``'s bar);
    ``"sqrt_parallel"``, whose re-triangularizations of rank-deficient
    factors carry documented O(1e-5) gradient noise in the JAX package
    (``sqrt_parallel_filter``'s docstring), within 1e-5 of the
    square-root engine's closed-form adjoint."""
    _, y, mask = ssm
    v_seq, g_seq = _alpha_deviance("sequential", y, mask)
    v_par, g_par = _alpha_deviance("parallel", y, mask)
    assert v_par == pytest.approx(v_seq, rel=1e-10)
    np.testing.assert_allclose(g_par, g_seq, rtol=1e-7)
    v_adj, g_adj = _alpha_deviance("sqrt", y, mask, grad="adjoint")
    v_sqp, g_sqp = _alpha_deviance("sqrt_parallel", y, mask)
    assert v_sqp == pytest.approx(v_adj, rel=1e-10)
    assert np.abs(g_sqp - g_adj).max() <= 1e-5 * np.abs(g_adj).max()


def test_associative_scan_draws_are_the_joint_engines(ssm):
    """``sample_states(engine="parallel")`` smooths each chunk of draws on
    K19/K20; from the same normals it gives the joint engine's draws."""
    from metran_tpu_torch.ops.kalman import _sample_states_given

    ss, y, mask = ssm
    pss = _port(ss)
    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn((3, 7), generator=gen, dtype=torch.float64)
    w = torch.randn((3, 60, 7), generator=gen, dtype=torch.float64)
    e = torch.randn((3, 60, 5), generator=gen, dtype=torch.float64)
    got = _sample_states_given(pss, y, mask, x0, w, e, engine="parallel",
                               draw_chunk=2, device="cpu")
    want = _sample_states_given(pss, y, mask, x0, w, e, engine="joint",
                                draw_chunk=2, device="cpu")
    assert _rel(got, want) <= 1e-9
    sq = _sample_states_given(pss, y, mask, x0, w, e,
                              engine="sqrt_parallel", device="cpu")
    assert _rel(sq, want) <= 1e-9


def test_mesh_and_card_gradient_raise_naming_a6(ssm, monkeypatch):
    """The sharded scan is ported (tests/test_torch_pkalman_sharded.py);
    a CUDA tensor that needs a gradient has no backward on the card, on
    one card or sharded over a mesh."""
    from metran_tpu_torch.parallel.mesh import make_mesh

    _, y, mask = ssm
    alpha = torch.full((7,), 10.0, dtype=torch.float64, requires_grad=True)
    ss_g = dfm_statespace(alpha[:5], alpha[5:], torch.full(
        (5, 2), 0.4, dtype=torch.float64), 1.0, device="cpu",
        dtype=torch.float64)
    yt = torch.as_tensor(y)
    mesh = make_mesh(2, ("seq",), devices=["cpu"] * 2)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda")))
    for engine in ("parallel", "sqrt_parallel"):
        with pytest.raises(NotPortedError, match="ROADMAP A6"):
            _refuse_card_grad(ss_g, yt, engine)
    with pytest.raises(NotPortedError, match="ROADMAP A6"):
        pops.sequence_sharded_filter(ss_g, yt[:200], torch.as_tensor(
            mask)[:200], mesh)


def test_kernel_launchers_refuse_cpu_and_plain_counts_nothing(ssm):
    ss, y, mask = ssm
    pss = _port(ss)
    yb = torch.as_tensor(y)[None]
    mb = torch.as_tensor(mask)[None]
    phi, q, z, r = (leaf[None].contiguous() for leaf in pss)
    qd = torch.diagonal(q, 0, -2, -1).contiguous()
    kernels.reset_launches()
    filt = kpk.parallel_filter(phi, q, z, r, yb, mb, 8)
    sq = kpk.sqrt_parallel_filter(phi, qd, z, r, yb, mb, 8)
    kpk.parallel_smooth(phi, filt[2], filt[3], filt[0], filt[1], 8)
    kpk.sqrt_parallel_smooth(phi, qd, sq[2], sq[3], sq[0], sq[1], 8)
    assert all(kernels.launches()[k] == 0 for k in (
        "parallel_filter", "parallel_smooth", "sqrt_parallel_filter",
        "sqrt_parallel_smooth"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kpk.parallel_filter_kernel(phi, q, z, r, yb, mb, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kpk.sqrt_parallel_filter_kernel(phi, qd, z, r, yb, mb, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kpk.parallel_smooth_kernel(phi, filt[2], filt[3], filt[0], filt[1],
                                   8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kpk.sqrt_parallel_smooth_kernel(phi, qd, sq[2], sq[3], sq[0], sq[1],
                                        8)
    with pytest.raises(ValueError, match="chunk"):
        kpk.parallel_filter(phi, q, z, r, yb, mb, 0)
    with pytest.raises(TypeError, match="bool"):
        kpk.parallel_filter(phi, q, z, r, yb, mb.to(torch.uint8), 4)


def test_auto_chunk_fills_the_card_and_keeps_one_chunk_per_fleet_model():
    # one long model: ~sqrt(3T) chunks
    assert kpk.n_chunks(5000, kpk.auto_chunk(5000, 1)) in range(115, 130)
    assert kpk.n_chunks(32768, kpk.auto_chunk(32768, 1)) in range(300, 320)
    # a fleet that fills the card runs one chunk per model
    assert kpk.auto_chunk(5000, 512) == 5000
    assert kpk.n_chunks(5000, kpk.auto_chunk(5000, 16)) == 33
    assert kpk.auto_chunk(1, 1) == 1
    # the JAX module's blocking constants keep their names and values
    from metran_tpu.ops import pkalman as jpk
    from metran_tpu_torch.ops import pkalman as ppk

    assert (ppk.AUTO_BLOCK, ppk.AUTO_BLOCK_MIN_T) == (
        jpk.AUTO_BLOCK, jpk.AUTO_BLOCK_MIN_T)
