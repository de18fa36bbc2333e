"""``Metran.solve`` parity with the JAX package on short panels, on the
CPU (f64, the plain versions of kernels K3/K4 under ``ScipySolve``).

Synthetic pandas series (T = 150, N = 4: an AR(1) common factor and
AR(1) specific parts, 20% missing).  Both packages run the same solver
on the same panel: the optimum agrees within rtol 1e-3 and ``obj_func``
within 1e-6 relative, stderr is finite.  The collapse guard (every alpha
at the lower bound) warns where the JAX package's warns, and the
``init="autocorr"`` re-solve does not.  ``LanesSolve`` is in
``tests/test_torch_metran_lanessolve.py``.
"""

import logging

import numpy as np
import pandas as pd
import pytest
import torch

import metran_tpu
import metran_tpu_torch

# the plain versions make thousands of tiny LAPACK calls; with several
# test processes on one host, torch's OpenMP threads oversubscribe the
# cores (see tests/test_torch_metran.py), so a test process keeps torch
# to one thread
torch.set_num_threads(1)


def short_panel(seed=0, t=150, n=4, missing=0.2):
    rng = np.random.default_rng(seed)
    common = np.zeros(t)
    specific = np.zeros((t, n))
    for i in range(1, t):
        common[i] = 0.95 * common[i - 1] + rng.normal() * 0.3
        specific[i] = 0.8 * specific[i - 1] + rng.normal(size=n) * 0.3
    y = common[:, None] * rng.uniform(0.6, 1.0, n) + specific
    y[rng.uniform(size=y.shape) < missing] = np.nan
    idx = pd.date_range("2000-01-01", periods=t, freq="D")
    return [pd.Series(y[:, i], index=idx, name=f"s{i}") for i in range(n)]


def collapse_panel(seed=42, t=150, n=3, missing=0.1):
    """``tests/test_forecast.py::_small_model``'s panel: near-white
    specific parts, from which the constant init collapses."""
    rng = np.random.default_rng(seed)
    common = np.zeros(t)
    for i in range(1, t):
        common[i] = 0.9 * common[i - 1] + rng.normal() * np.sqrt(1 - 0.81)
    raw = 0.8 * common[:, None] + 0.6 * rng.normal(size=(t, n))
    raw[rng.uniform(size=raw.shape) < missing] = np.nan
    idx = pd.date_range("2015-01-01", periods=t, freq="D")
    return pd.DataFrame(raw, index=idx, columns=[f"s{i}" for i in range(n)])


class _Records(logging.Handler):
    def __init__(self, logger):
        super().__init__()
        self.messages = []
        self.logger = logging.getLogger(logger)

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)

    def collapsed(self):
        return any("collapsed to the lower bound" in m
                   for m in self.messages)


def assert_same_fit(mp, mj):
    np.testing.assert_allclose(
        mp.parameters["optimal"].values.astype(float),
        mj.parameters["optimal"].values.astype(float), rtol=1e-3)
    assert mp.fit.obj_func == pytest.approx(mj.fit.obj_func, rel=1e-6)
    assert np.isfinite(mp.parameters["stderr"].values.astype(float)).all()
    assert list(mp.parameters.index) == list(mj.parameters.index)
    assert mp.settings["solver"] == mj.settings["solver"]


def test_scipysolve_matches_jax():
    series = short_panel()
    mj = metran_tpu.Metran(series, name="syn")
    mj.solve(solver=metran_tpu.ScipySolve, report=False)
    mp = metran_tpu_torch.Metran(series, name="syn", device="cpu")
    with _Records("metran_tpu_torch") as rec:
        mp.solve(report=False)  # the CPU default: ScipySolve
    assert isinstance(mp.fit, metran_tpu_torch.ScipySolve)
    assert_same_fit(mp, mj)
    assert not [m for m in rec.messages if "estimated" in m]
    # the solver's objective and gradient are the port's deviance
    p = mp.parameters["optimal"].values.astype(float)
    value, grad = mp._deviance_value_and_grad(p)
    assert value == pytest.approx(mp.get_mle(p), rel=1e-12)
    assert np.abs(grad).max() < 1e-2  # at the optimum


def test_collapse_guard_warns_where_jax_warns():
    frame = collapse_panel()
    mj = metran_tpu.Metran(frame, name="fc")
    mp = metran_tpu_torch.Metran(frame, name="fc", device="cpu")
    for init in ("reference", "autocorr"):
        with _Records("metran_tpu") as rj:
            mj.solve(report=False, init=init)
        with _Records("metran_tpu_torch") as rp:
            mp.solve(report=False, init=init)
        assert rp.collapsed() == rj.collapsed() == (init == "reference")
        np.testing.assert_allclose(
            mp.parameters["initial"].values.astype(float),
            mj.parameters["initial"].values.astype(float), rtol=1e-10)
        assert mp.fit.obj_func == pytest.approx(mj.fit.obj_func, rel=1e-6)
