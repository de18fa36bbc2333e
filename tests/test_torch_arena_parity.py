"""Port parity of the arena kernels' functions: identical arena leaves,
built with numpy from a seed, go through the JAX package's
``make_arena_update_fn`` / ``make_arena_steady_update_fn`` /
``make_arena_forecast_fn`` and the port's, whose CPU path is the plain
version of K16 / K17 / K18.

Outputs and the written leaves agree in f64 to 1e-12 (relative, with a
1e-12 floor for entries that are zero in exact arithmetic; square-root
factors compared as ``F F'``, since under ``r = 0`` the columns past a
zero pivot differ between QR codes), and the ``ok``, ``verdict`` and
``applied`` flags, the detector counts and the ``t_seen``/``version``
counters are equal exactly.  The rows mix armed and unarmed models, a
masked cell, a fully masked row, a NaN-poisoned row and (covariance
arenas) a non-PSD row; rows not named in the dispatch must come back
bit-identical.  A rejected row's per-step terms come from its NaN or
non-PSD prior, so for it only the verdict and the unchanged leaves are
held.  The ``horizons`` modes (the read path's commit-time forecast
pass, at a non-contiguous horizon set) are held the same way: K16's
means and variances of every row as written (NaN where the written row
is the poisoned prior), K17's means.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metran_tpu.cluster._testing import make_states
from metran_tpu.serve import engine as jeng
from metran_tpu_torch.serve import engine as peng
from metran_tpu_torch.serve import (
    DetectSpec,
    GateSpec,
    PosteriorState,
    RobustSpec,
    StateArena,
)

TOL = dict(rtol=1e-12, atol=1e-12)
BUCKET = (8, 16)
ROWS = np.array([4, 1, 2, 0, 5], np.int32)  # row 3 and 6 stay unnamed
DET = DetectSpec(enabled=True, cusum_k=0.5, cusum_h=3.0, lb_window=8,
                 lb_thresh=2.0, nsigma=2.0, min_seen=30)
HORIZONS = (1, 3, 7)  # a set whose horizons are not 1..H


def _leaves(seed, sqrt, poison=True):
    """Arena leaves (numpy) packed from six fitted models, with spread
    ``t_seen`` (armed and unarmed rows), a poisoned row 2 and, on a
    covariance arena, a non-PSD row 5."""
    rng = np.random.default_rng(seed)
    states = [PosteriorState.from_jax_state(s)
              for s in make_states(seed=seed, n_models=6, n=5, kf=2)]
    arena = StateArena(BUCKET, 6, dtype=np.float64, sqrt=sqrt, device="cpu")
    for st in states:
        arena.write_row(arena.alloc(), st)
    dyn = [t.numpy().copy() for t in arena._dynamic()]
    static = [t.numpy().copy() for t in arena._static()]
    dyn[2][:] = rng.integers(0, 60, dyn[2].shape)  # t_seen
    dyn[3][:] = rng.integers(0, 9, dyn[3].shape)   # version
    if poison:
        dyn[0][2, 1] = np.nan
        if not sqrt:
            dyn[1][5] -= 50.0 * np.eye(BUCKET[1])
    det = np.abs(rng.normal(size=(7, 6, BUCKET[0]))) * 0.5
    det[:, 5] = rng.uniform(0.0, 10.0, (7, BUCKET[0]))  # n_eff
    return dyn, static, det


def _data(seed, k=2):
    rng = np.random.default_rng(seed + 100)
    g, n = len(ROWS), BUCKET[0]
    y = rng.normal(size=(g, k, n))
    y[3, 0, 1] = 9.0  # a spike the gates flag
    mask = np.zeros((g, k, n), bool)
    mask[:, :, :5] = rng.uniform(size=(g, k, 5)) > 0.1
    mask[1] = False  # a fully masked row
    mask[0, :, :5] = True
    mask[4, :, :5] = True
    y = np.where(mask, y, 0.0)
    real = np.zeros((g, n), bool)
    real[:, :5] = True
    return y, mask, real


def _torch(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _jax(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, sqrt_fac=False):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if sqrt_fac:
        got = got @ np.swapaxes(got, -1, -2)
        want = want @ np.swapaxes(want, -1, -2)
    if got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def _unnamed_untouched(leaves, ref):
    for t, r in zip(leaves, ref):
        for row in (3, 6):
            a = t[row].numpy() if isinstance(t, torch.Tensor) else t[row]
            assert np.array_equal(a, r[row], equal_nan=True)


@pytest.mark.parametrize("case", [
    "joint_off", "sqrt_reject_detect", "sequential_robust_censored",
    "joint_gated_steady_tol"])
def test_arena_update_matches_jax(case):
    _check_arena_update(case)


@pytest.mark.parametrize("case", [
    "joint_off", "sqrt_reject_detect", "sequential_robust_censored",
    "joint_gated_steady_tol"])
def test_arena_update_horizons_match_jax(case):
    """K16's horizons mode (plain version) against the JAX kernel's fused
    horizon pass, in the JAX output order."""
    _check_arena_update(case, HORIZONS)


def _check_arena_update(case, horizons=None):
    seed = 11
    engine = {"joint_off": "joint", "sqrt_reject_detect": "sqrt",
              "sequential_robust_censored": "sequential",
              "joint_gated_steady_tol": "joint"}[case]
    sqrt = engine == "sqrt"
    dyn, static, det = _leaves(seed, sqrt)
    y, mask, real = _data(seed)
    kw = {}
    args = (ROWS, y, mask)
    tail = ()
    if case == "sqrt_reject_detect":
        kw = dict(gate=GateSpec("reject", 2.0, 20), detect=DET)
    elif case == "sequential_robust_censored":
        kw = dict(robust=RobustSpec("censored", rail_lo=-0.8, rail_hi=0.9,
                                    min_seen=20))
    elif case == "joint_gated_steady_tol":
        kw = dict(gate=GateSpec("huber", 2.0, 20), steady_tol=10.0)
    jkw = {key: val for key, val in kw.items()}
    if "gate" in jkw:
        jkw["gate"] = jeng.GateSpec(*kw["gate"])
    if "detect" in jkw:
        jkw["detect"] = jeng.DetectSpec(*kw["detect"])
    if "robust" in jkw:
        jkw["robust"] = jeng.RobustSpec(*kw["robust"])
    jfn = jeng.make_arena_update_fn(engine=engine, horizons=horizons, **jkw)
    pfn = peng.make_arena_update_fn(engine=engine, horizons=horizons, **kw)
    if case == "sqrt_reject_detect":
        tail = (np.int32(20), real, np.int32(DET.min_seen))
    elif case == "sequential_robust_censored":
        g = len(ROWS)
        rob = (np.full((g, 8), -0.8), np.full((g, 8), 0.9),
               np.ones((g, 8)), np.full((g, 8), 0.05))
        tail = (np.int32(20),) + rob
    elif case == "joint_gated_steady_tol":
        tail = (np.int32(20), real)
    p_dyn, p_static = _torch(dyn), _torch(static)
    p_det = torch.from_numpy(det.copy())
    if "detect" in kw:
        jout = jfn(_jax(dyn), _jax(static), jnp.asarray(det), *args, *tail)
        pout = pfn(p_dyn, p_static, p_det, *args, *tail)
        j_new_dyn, j_det, jrest = jout[0], jout[1], jout[2:]
        prest = pout[2:]
        _close(p_det, j_det)
        assert np.array_equal(p_det.numpy()[[3, 6]], det[[3, 6]])
    else:
        jout = jfn(_jax(dyn), _jax(static), *args, *tail)
        pout = pfn(p_dyn, p_static, *args, *tail)
        j_new_dyn, jrest, prest = jout[0], jout[1:], pout[1:]
    assert len(prest) == len(jrest)
    ok = np.array(jrest[0])
    np.testing.assert_array_equal(prest[0].numpy(), ok)
    assert not ok[2]  # the poisoned row is rejected
    if not sqrt:
        assert not ok[4]  # and the non-PSD one (ROWS[4] = 5)
    # sigma, detf, zs, verdicts, iters, conv, counts of the accepted rows
    # (a rejected row's terms come from its NaN or non-PSD prior: only
    # its verdict and its unchanged leaves are well posed)
    for got, want in zip(prest[1:], jrest[1:]):
        _close(got[ok], np.asarray(want)[ok])
    if horizons is not None:
        # (fm, fv) come after the update's outputs, before conv and the
        # detector's; the pass reads the rows as written, so a rejected
        # row's moments are its prior's (NaN on the poisoned row)
        pos = len(prest) - 2 - ("steady_tol" in kw) - 2 * ("detect" in kw)
        fm, fv = prest[pos], prest[pos + 1]
        assert tuple(fm.shape) == (len(ROWS), len(horizons), BUCKET[0])
        _close(fm, jrest[pos])
        _close(fv, jrest[pos + 1])
        assert np.isnan(fm.numpy()[2]).any()
    for i, (got, want) in enumerate(zip(p_dyn, j_new_dyn)):
        _close(got, want, sqrt_fac=sqrt and i == 1)
    # a rejected row and the unnamed rows are bit-identical
    for t, ref in zip(p_dyn, dyn):
        assert np.array_equal(t.numpy()[ROWS[~ok]], ref[ROWS[~ok]],
                              equal_nan=True)
    _unnamed_untouched(p_dyn, dyn)


@pytest.mark.parametrize("detect", [False, True])
def test_arena_steady_update_matches_jax(detect):
    _check_arena_steady_update(detect)


@pytest.mark.parametrize("detect", [False, True])
def test_arena_steady_update_horizons_match_jax(detect):
    """K17's horizons mode (plain version): the frozen rows' commit-time
    means, ``Z (phi^h o m)`` of each written mean, against JAX's."""
    _check_arena_steady_update(detect, HORIZONS)


def _check_arena_steady_update(detect, horizons=None):
    seed = 5
    rng = np.random.default_rng(seed)
    dyn, static, det = _leaves(seed, False, poison=False)
    y, mask, real = _data(seed)
    steady = rng.uniform(size=7) > 0.3
    steady[[0, 4]] = True
    kgain = rng.normal(size=(7, 16, 8)) * 0.05
    fdiag = rng.uniform(0.5, 2.0, (7, 8))
    steady_leaves = (steady, kgain, fdiag)
    gate = GateSpec("reject", 4.0, 20)
    jfn = jeng.make_arena_steady_update_fn(
        gate=jeng.GateSpec(*gate), horizons=horizons, sequential_gate=True,
        detect=jeng.DetectSpec(*DET) if detect else None)
    pfn = peng.make_arena_steady_update_fn(
        gate=gate, horizons=horizons, sequential_gate=True,
        detect=DET if detect else None)
    args = (ROWS, real, y, mask, np.int32(20))
    p_dyn, p_static = _torch(dyn), _torch(static)
    p_det = torch.from_numpy(det.copy())
    if detect:
        jout = jfn(_jax(dyn), _jax(static), _jax(steady_leaves),
                   jnp.asarray(det), *args, np.int32(DET.min_seen))
        pout = pfn(p_dyn, p_static, _torch(steady_leaves), p_det, *args,
                   np.int32(DET.min_seen))
        _close(p_det, jout[1])
        j_new_dyn, jrest, prest = jout[0], jout[2:], pout[2:]
    else:
        jout = jfn(_jax(dyn), _jax(static), _jax(steady_leaves), *args)
        pout = pfn(p_dyn, p_static, _torch(steady_leaves), *args)
        j_new_dyn, jrest, prest = jout[0], jout[1:], pout[1:]
    applied = np.asarray(jrest[0])
    np.testing.assert_array_equal(prest[0].numpy(), applied)
    assert applied.any() and not applied.all()
    assert len(prest) == len(jrest)
    for got, want in zip(prest[1:], jrest[1:]):
        _close(got, want)
    if horizons is not None:
        fm = prest[5]
        assert tuple(fm.shape) == (len(ROWS), len(horizons), BUCKET[0])
    for got, want in zip(p_dyn, j_new_dyn):
        _close(got, want)
    # the factor leaf is never touched, and unapplied rows stay as they were
    assert np.array_equal(p_dyn[1].numpy(), dyn[1])
    for t, ref in zip(p_dyn, dyn):
        assert np.array_equal(t.numpy()[ROWS[~applied]],
                              ref[ROWS[~applied]])
    _unnamed_untouched(p_dyn, dyn)


@pytest.mark.parametrize("sqrt", [False, True])
def test_arena_forecast_matches_jax(sqrt):
    dyn, static, _ = _leaves(3, sqrt, poison=False)
    jfn = jeng.make_arena_forecast_fn(6, sqrt=sqrt)
    pfn = peng.make_arena_forecast_fn(6, sqrt=sqrt)
    jm, jv = jfn(jnp.asarray(dyn[0]), jnp.asarray(dyn[1]), _jax(static),
                 ROWS)
    pm, pv = pfn(torch.from_numpy(dyn[0]), torch.from_numpy(dyn[1]),
                 _torch(static), ROWS)
    assert tuple(pm.shape) == (len(ROWS), 6, BUCKET[0])
    _close(pm, jm)
    _close(pv, jv)
