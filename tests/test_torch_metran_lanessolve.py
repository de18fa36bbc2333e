"""``Metran.solve(solver=LanesSolve)`` parity with the JAX package on a
short panel, on the CPU: the fit is ``fit_fleet(layout="lanes")`` at
batch 1 (the plain versions of kernels K3/K4 and the grid line-search
L-BFGS), the standard errors ``fleet_stderr(method="lanes-fd")``.  Bars
as ``tests/test_torch_metran_solve.py``'s (optimum rtol 1e-3,
``obj_func`` 1e-6 relative) and the stderr of both packages within
1e-6 (the same central differences of the same exact gradient).
"""

import numpy as np
import torch
from test_torch_metran_solve import _Records, assert_same_fit, short_panel

import metran_tpu
import metran_tpu_torch

# one torch thread per test process (see tests/test_torch_metran.py)
torch.set_num_threads(1)


def test_lanessolve_matches_jax():
    series = short_panel()
    mj = metran_tpu.Metran(series, name="syn")
    mj.solve(solver=metran_tpu.LanesSolve, report=False)
    mp = metran_tpu_torch.Metran(series, name="syn", device="cpu")
    with _Records("metran_tpu_torch") as rec:
        mp.solve(solver=metran_tpu_torch.LanesSolve, report=False)
    assert_same_fit(mp, mj)
    assert not [m for m in rec.messages if "estimated" in m]
    np.testing.assert_allclose(
        mp.parameters["stderr"].values.astype(float),
        mj.parameters["stderr"].values.astype(float), rtol=1e-6)
    assert mp.fit.nfev == mj.fit.nfev
    assert "LanesSolve" in mp.fit_report()
    # a re-solve on the same model keeps the table consistent
    mp.solve(solver=metran_tpu_torch.LanesSolve, report=False)
    assert len(mp.parameters) == 5
