"""Port parity: ``fleet_stderr(method="lanes-fd")`` against the JAX
package's, f64 on the CPU (the plain versions of kernels K3 and K4).

Both central-difference the exact lanes gradient with the same steps
``h = cbrt(eps) max(|p|, 1)``, so they share the truncation error: pcov
agrees within 1e-6 relative (normwise), stderr's NaN positions exactly.
The port's 2P perturbation lanes of a model read one copy of its data
through the lane map (the JAX function repeats it 2P times).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import random_ssm

from metran_tpu.data import Panel as JPanel
from metran_tpu.parallel import fleet as jf
from metran_tpu_torch.data import Panel
from metran_tpu_torch.ops import lanes as planes
from metran_tpu_torch.parallel import fleet as pf

B, N, K, T = 3, 4, 1, 90


def _fleets(seed=0):
    """A 3-model ``random_ssm`` fleet (one model with a shorter panel),
    packed by both packages, and parameters near each model's truth."""
    rng = np.random.default_rng(seed)
    panels, jpanels, lds, params = [], [], [], []
    for b in range(B):
        t = T if b != 1 else T - 20
        ss, y, mask = random_ssm(rng, N, K, t=t)
        names = [f"s{i}" for i in range(N)]
        args = (y, mask, None, names, np.ones(N), np.zeros(N), 1.0)
        panels.append(Panel(*args))
        jpanels.append(JPanel(*args))
        lds.append(np.asarray(ss.z)[:, N:])
        params.append(rng.uniform(5.0, 40.0, N + K))
    return (jf.pack_fleet(jpanels, lds),
            pf.pack_fleet(panels, lds, device="cpu"), np.stack(params))


@pytest.mark.parametrize("batch_chunk", [None, 2])
def test_lanes_fd_stderr_matches_jax(batch_chunk):
    jfleet, pfleet, params = _fleets()
    w_se, w_pcov = jf.fleet_stderr(jnp.asarray(params), jfleet,
                                   method="lanes-fd", remat_seg=32,
                                   batch_chunk=batch_chunk)
    g_se, g_pcov = pf.fleet_stderr(params, pfleet, method="lanes-fd",
                                   remat_seg=32, batch_chunk=batch_chunk)
    w_pcov, w_se = np.asarray(w_pcov), np.asarray(w_se)
    assert g_pcov.shape == (B, N + K, N + K)
    err = np.abs(g_pcov.numpy() - w_pcov).max() / np.abs(w_pcov).max()
    assert err <= 1e-6
    assert np.array_equal(np.isnan(g_se.numpy()), np.isnan(w_se))
    fin = np.isfinite(w_se)
    np.testing.assert_allclose(g_se.numpy()[fin], w_se[fin], rtol=1e-6)
    # the Hessian is symmetrized before the pinv
    torch.testing.assert_close(g_pcov, g_pcov.transpose(1, 2), rtol=1e-10,
                               atol=1e-12)


def test_perturbation_lanes_read_one_data_copy(monkeypatch):
    _, pfleet, params = _fleets(1)
    seen = []
    real = planes.lanes_filter

    def spy(phi, q, z, r, y, mask, lane_map=None, *args, **kw):
        seen.append((phi.shape[1], y.shape[0], lane_map.clone()))
        return real(phi, q, z, r, y, mask, lane_map, *args, **kw)

    monkeypatch.setattr(planes, "lanes_filter", spy)
    pf.fleet_stderr(params, pfleet, method="lanes-fd", remat_seg=32)
    reps = 2 * (N + K)
    assert seen, "the lanes filter never ran"
    for lanes, data_lanes, lane_map in seen:
        assert (lanes, data_lanes) == (B * reps, B)
        assert torch.equal(lane_map, torch.arange(
            B, dtype=torch.int32).repeat_interleave(reps))


def test_exact_method_raises_naming_the_roadmap():
    _, pfleet, params = _fleets(2)
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        pf.fleet_stderr(params, pfleet, method="exact")
    with pytest.raises(ValueError, match="unknown method"):
        pf.fleet_stderr(params, pfleet, method="fd")
