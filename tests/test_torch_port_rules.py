"""The port's standing rules, checked on the CPU:

- ``metran_tpu_torch`` and ``chip_smoke.py`` import neither ``jax``,
  ``optax`` nor the JAX package (checked in a fresh interpreter and by
  source scan);
- every ROADMAP item a not-ported message names exists in
  ``ROADMAP.md``;
- entry points default to the CUDA card and raise without one instead
  of running on the CPU quietly;
- the CUDA kernel launchers take CUDA tensors only, and the dispatching
  wrappers never count a launch for the plain CPU path (the products'
  K5/K6/K7, K6's store mode, the RTS smoother K8, the square-root
  engine's K9/K10, K1's store mode, the gated updates K12 and gated K9,
  their robust modes and the detector K13 included), and the robust
  modes count under names of their own;
- robust updates are ported: no not-ported message names their item
  (A4.3); nor does one name the state arena's (A4.8), whose registry,
  factories and kernels K16-K18 take the CPU when asked and refuse it
  in their launchers;
- the score that needs a plain version (``score="autodiff"``) refuses
  CUDA tensors, so no plain version runs on the card's path.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import metran_tpu_torch
from metran_tpu_torch import kernels
from metran_tpu_torch.kernels import build
from metran_tpu_torch.kernels import smoother as ksm
from metran_tpu_torch.ops import (
    detect_append,
    deviance,
    filter_append,
    gated_filter_append,
    gated_sqrt_filter_append,
    implicit_map_filter_append,
    implicit_map_sqrt_filter_append,
    kalman_filter,
    lanes_dfm_deviance,
)
from metran_tpu_torch.ops import lanes_products as products
from metran_tpu_torch.ops.kalman import sample_states, sqrt_filter_append
from metran_tpu_torch.ops.lanes import LanesData, lanes_terms
from metran_tpu_torch.ops.statespace import StateSpace, dfm_statespace
from metran_tpu_torch.parallel import (
    Fleet,
    fit_fleet,
    fleet_decompose,
    fleet_deviance,
    fleet_forecast,
    fleet_innovations,
    fleet_sample,
    fleet_simulate,
    fleet_stderr,
    fleet_value_and_grad,
    pack_fleet,
)
from metran_tpu_torch.serve import (
    DetectSpec,
    GateSpec,
    MetranService,
    ModelRegistry,
    RobustSpec,
    SteadySpec,
)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "metran_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]
# an import of jax, of optax or of the JAX package (``metran_tpu`` not
# followed by ``_torch``): import statements and dynamic imports
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|optax|metran_tpu)\b"
    r"|(?:import_module|__import__)\(\s*[\"'](?:jax|optax|metran_tpu)\b",
    re.MULTILINE,
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_and_chip_smoke_import_no_jax_in_a_fresh_interpreter():
    script = """
import importlib, pkgutil, sys
import metran_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    metran_tpu_torch.__path__, "metran_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "optax", "metran_tpu")
             or m.startswith(("jax.", "optax.", "metran_tpu.")))
# the single-model API's modules (pandas-based, imported on demand)
assert {"metran_tpu_torch.models.metran", "metran_tpu_torch.models.solver",
        "metran_tpu_torch.models.kalman_runner", "metran_tpu_torch.ops.fa",
        "metran_tpu_torch.kernels.smoother", "metran_tpu_torch.utils",
        "metran_tpu_torch.models.lbfgs", "metran_tpu_torch.obs.telemetry",
        } <= set(names), names
metran_tpu_torch.Metran, metran_tpu_torch.LanesSolve
print(len(names), bad)
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=_env())
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 37, out.stdout  # every submodule was imported
    assert bad == "[]", bad


def test_source_scan_finds_no_jax_import():
    hits = []
    for path in PORT_FILES:
        text = path.read_text()
        hits += [f"{path.relative_to(REPO)}: {m.group(0).strip()}"
                 for m in FORBIDDEN.finditer(text)]
    assert not hits, hits
    # the pattern itself catches what it must
    for line in ("import jax", "from jax import numpy", "import metran_tpu",
                 "from metran_tpu.ops import x", "  from metran_tpu import y",
                 "importlib.import_module('metran_tpu.serve')",
                 "import optax", "import optax.tree_utils as otu",
                 "from optax import lbfgs"):
        assert FORBIDDEN.search(line), line
    for line in ("import metran_tpu_torch", "from metran_tpu_torch.ops "
                 "import x", "# the JAX package's metran_tpu/ops/kalman.py"):
        assert not FORBIDDEN.search(line), line


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        MetranService(ModelRegistry(root=None), flush_deadline=None)
    rng = np.random.default_rng(1)
    a_s, a_c = rng.uniform(5, 40, 3), rng.uniform(5, 40, 1)
    lds = rng.uniform(0.3, 0.8, (3, 1))
    with pytest.raises(RuntimeError, match="CUDA device required"):
        dfm_statespace(a_s, a_c, lds)
    ss_np = StateSpace(*(np.asarray(leaf) for leaf in dfm_statespace(
        a_s, a_c, lds, device="cpu")))
    y, mask = np.zeros((2, 3)), np.ones((2, 3), bool)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        filter_append(ss_np, np.zeros(4), np.eye(4), y, mask)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        kalman_filter(ss_np, y, mask)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        deviance(ss_np, y, mask)
    # the fit slice: numpy inputs go to the card by default
    ld = np.asarray(lds)[:, :, None]  # (N, K, B=1)
    alpha = np.full((4, 1), 10.0)
    y_l, m_l = y.T[:, :, None][:, :3], mask[:, :3, None]
    with pytest.raises(RuntimeError, match="CUDA device required"):
        lanes_dfm_deviance(alpha, ld, np.ones(1), y_l, m_l)
    fleet = Fleet(y[None], mask[None], np.asarray(lds)[None], np.ones(1),
                  np.array([3]))
    for fn in (fleet_deviance, fleet_value_and_grad):
        for layout in ("lanes", "batch"):
            with pytest.raises(RuntimeError, match="CUDA device required"):
                fn(np.full((1, 4), 10.0), fleet, layout=layout)
    for layout in ("lanes", "batch"):
        with pytest.raises(RuntimeError, match="CUDA device required"):
            fit_fleet(fleet, layout=layout, maxiter=1)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        pack_fleet([], [])
    # the products slice: numpy fleets and lane inputs go to the card too
    params = np.full((1, 4), 10.0)
    for fn in (fleet_simulate, fleet_decompose, fleet_innovations,
               fleet_sample, lambda p, f: fleet_forecast(p, f, 3)):
        with pytest.raises(RuntimeError, match="CUDA device required"):
            fn(params, fleet)
    lane_inputs = (np.full((4, 1), 0.9), np.full((4, 1), 0.1),
                   np.concatenate([np.eye(3), np.asarray(lds)], 1)[:, :, None],
                   np.zeros((3, 1)), y_l, m_l)
    for fn in (products.lanes_smooth, products.lanes_filter_project,
               products.lanes_innovations, products.lanes_sample,
               lambda *a: products.lanes_forecast(*a, np.ones(1, np.int32),
                                                  2)):
        with pytest.raises(RuntimeError, match="CUDA device required"):
            fn(*lane_inputs)
    # the single-model slice: the stored filter, the path draws, the
    # lanes-fd stderr and Metran itself
    with pytest.raises(RuntimeError, match="CUDA device required"):
        kalman_filter(ss_np, y, mask, engine="sequential", store=True)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        sample_states(ss_np, y, mask, 0)
    # the square-root engine's entry points
    with pytest.raises(RuntimeError, match="CUDA device required"):
        kalman_filter(ss_np, y, mask, engine="sqrt", store=True)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        deviance(ss_np, y, mask, engine="sqrt")
    with pytest.raises(RuntimeError, match="CUDA device required"):
        sqrt_filter_append(ss_np, np.zeros(4), np.eye(4), y, mask)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        MetranService(ModelRegistry(root=None, engine="sqrt"),
                      flush_deadline=None)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        fleet_stderr(params, fleet, method="lanes-fd")
    # the serving defences: the gated updates, the detector, the service
    with pytest.raises(RuntimeError, match="CUDA device required"):
        gated_filter_append(ss_np, np.zeros(4), np.eye(4), y, mask)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        gated_sqrt_filter_append(ss_np, np.zeros(4), np.eye(4), y, mask)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        detect_append(np.zeros((6, 3)), y, mask)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        MetranService(ModelRegistry(root=None, engine="sequential"),
                      flush_deadline=None, gate=GateSpec(policy="reject"),
                      detect=DetectSpec(enabled=True))
    # the robust updates and the robust service
    for fn in (implicit_map_filter_append, implicit_map_sqrt_filter_append):
        with pytest.raises(RuntimeError, match="CUDA device required"):
            fn(ss_np, np.zeros(4), np.eye(4), y, mask, likelihood="huber_t")
    with pytest.raises(RuntimeError, match="CUDA device required"):
        MetranService(ModelRegistry(root=None, engine="sqrt"),
                      flush_deadline=None,
                      robust=RobustSpec(likelihood="huber_t"))
    # the associative-scan engines (K19-K22) and their registry
    from metran_tpu_torch.ops import pkalman

    for fn in (pkalman.parallel_filter, pkalman.sqrt_parallel_filter,
               pkalman.parallel_deviance, pkalman.sqrt_parallel_deviance):
        with pytest.raises(RuntimeError, match="CUDA device required"):
            fn(ss_np, y, mask)
    for engine in ("parallel", "sqrt_parallel"):
        with pytest.raises(RuntimeError, match="CUDA device required"):
            kalman_filter(ss_np, y, mask, engine=engine)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        MetranService(ModelRegistry(root=None, engine="sqrt_parallel"),
                      flush_deadline=None)
    import pandas as pd

    idx = pd.date_range("2000-01-01", periods=30, freq="D")
    frame = pd.DataFrame(np.random.default_rng(2).normal(size=(30, 3)),
                         index=idx, columns=["a", "b", "c"])
    with pytest.raises(RuntimeError, match="CUDA device required"):
        metran_tpu_torch.Metran(frame)
    assert metran_tpu_torch.Metran(frame, device="cpu").device.type == "cpu"
    # asked for explicitly, the CPU runs (the plain versions)
    out = filter_append(ss_np, np.zeros(4), np.eye(4), y, mask,
                        device="cpu")
    assert out[0].device.type == "cpu"
    svc = MetranService(ModelRegistry(root=None), flush_deadline=None,
                        device="cpu")
    svc.close()


def _k1_args(device="cpu", dtype=torch.float64, b=2, k=3, n=4, s=5):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(b, s, s, generator=g, dtype=dtype)
    return [
        torch.rand(b, s, generator=g, dtype=dtype),
        torch.eye(s, dtype=dtype).expand(b, s, s).contiguous() * 0.1,
        torch.randn(b, n, s, generator=g, dtype=dtype),
        torch.zeros(b, n, dtype=dtype),
        torch.zeros(b, s, dtype=dtype),
        a @ a.transpose(-1, -2),
        torch.randn(b, k, n, generator=g, dtype=dtype),
        torch.ones(b, k, n, dtype=torch.bool),
    ]


def _k3_args(dtype=torch.float64, lanes=3, t=7, n_obs=2, n=3):
    g = torch.Generator().manual_seed(1)
    return [
        torch.rand(n, lanes, generator=g, dtype=dtype) * 0.9,
        torch.rand(n, lanes, generator=g, dtype=dtype) * 0.1,
        torch.randn(n_obs, n, lanes, generator=g, dtype=dtype),
        torch.zeros(n_obs, lanes, dtype=dtype),
        torch.randn(lanes, t, n_obs, generator=g, dtype=dtype),
        torch.rand(lanes, t, n_obs, generator=g) > 0.3,
    ]


def _k7_args(dtype=torch.float64, lanes=3, t=7, n_obs=2, n=3):
    phi, q, z, r = _k3_args(dtype, lanes, t, n_obs, n)[:4]
    g = torch.Generator().manual_seed(2)
    return [phi, q, z, r, torch.randn(lanes, n, generator=g, dtype=dtype),
            torch.randn(lanes, t, n, generator=g, dtype=dtype),
            torch.randn(lanes, t, n_obs, generator=g, dtype=dtype)]


def _k11_args(dtype=torch.float64, b=2, t=5, n_obs=3, s=4, seg=2):
    """K11's inputs: K1's model and data with boundaries every ``seg``
    steps and unit cotangents."""
    phi, q, z, r, mean, cov, y, mask = _k1_args(dtype=dtype, b=b, k=t,
                                                n=n_obs, s=s)
    out = kernels.joint_filter_append(phi, q, z, r, mean, cov, y, mask,
                                      bounds_seg=seg)
    ones = torch.ones(b, t, dtype=dtype)
    return (phi, torch.diagonal(q, 0, -2, -1).contiguous(), z, r, y, mask,
            out[4], out[5], ones, ones)


def _k13_args(dtype=torch.float64, b=2, k=4, n=3):
    g = torch.Generator().manual_seed(3)
    return (torch.zeros(b, 6, n, dtype=dtype),
            torch.randn(b, k, n, generator=g, dtype=dtype),
            torch.rand(b, k, n, generator=g) > 0.2,
            torch.ones(b, dtype=torch.bool))


def test_kernel_launchers_raise_on_cpu_tensors():
    args = _k1_args()
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.joint_filter_append_kernel(*args)
    hz = torch.arange(1, 4, dtype=torch.float64)
    fc = args[:6] + [hz]
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.forecast_moments_kernel(*fc)
    k3 = _k3_args()
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.lanes_filter_kernel(*k3, seg=4, keep_bounds=True)
    res = kernels.lanes_filter(*k3, seg=4, keep_bounds=True)
    cot = torch.ones_like(res.sigma)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.lanes_adjoint_kernel(*k3, None, 4, res.bounds_mean,
                                     res.bounds_cov, cot, cot)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.lanes_smooth_bwd_kernel(*k3, None, 4, res.bounds_mean,
                                        res.bounds_cov, True)
    for mode in ("project", "innovations", "latch"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.lanes_forward_kernel(
                *k3, mode, None, torch.full((3,), 7, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.lanes_sample_kernel(*_k7_args())
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.lanes_forward_kernel(*k3, "store")
    stored = kernels.lanes_forward(*k3, "store")
    phi_l = k3[0].T.contiguous()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ksm.rts_smooth_kernel(phi_l, stored[2], stored[3], stored[0],
                              stored[1])
    # the square-root engine: K9 in both instantiations and from a given
    # carry, K10 in both modes
    for kw in ({}, {"store": True},
               {"mean0": torch.zeros(3, 3, dtype=torch.float64),
                "chol0": torch.eye(3, dtype=torch.float64).expand(
                    3, 3, 3).contiguous()}):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.sqrt_filter_kernel(*k3, **kw)
    sq = kernels.sqrt_filter(*k3, store=True)
    q_l = k3[1].T.contiguous()
    for want_cov in (True, False):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.sqrt_smooth_kernel(phi_l, q_l, sq[2], sq[3], sq[0],
                                       sq[1], want_cov=want_cov)
    # the batch-layout adjoint's forward modes and K11
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.joint_filter_append_kernel(*args, bounds_seg=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.sqrt_filter_kernel(*k3, bounds_seg=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.joint_adjoint_kernel(*_k11_args(), 2)
    # the joint store, the gated updates and the detector
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.joint_filter_store_kernel(*args)
    armed = torch.ones(2, dtype=torch.bool)
    for policy in ("off", "reject", "huber", "inflate"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.gated_filter_append_kernel(*args, armed, policy, 16.0)
    m0 = torch.zeros(3, 3, dtype=torch.float64)
    c0 = torch.eye(3, dtype=torch.float64).expand(3, 3, 3).contiguous()
    for policy in ("reject", "huber", "inflate"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.sqrt_filter_gated_kernel(*k3, m0, c0,
                                             torch.ones(3, dtype=torch.bool),
                                             policy, 16.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.detect_scan_kernel(*_k13_args())
    # the robust modes of K12 and K9
    for lik in ("censored", "quantized", "huber_t"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.robust_filter_append_kernel(*args, armed,
                                                *_robust_params(2, 4),
                                                likelihood=lik)
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.sqrt_filter_robust_kernel(
                *k3, m0, c0, torch.ones(3, dtype=torch.bool),
                *_robust_params(3, 2), likelihood=lik)
    # the steady-state append (each policy and form) and the DARE solve
    k14 = _k14_args()
    for policy, seq in (("off", False), ("reject", False), ("huber", True),
                        ("inflate", True)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.steady_filter_kernel(*k14, policy, 16.0, seq)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.dare_gains_kernel(*args[:4])


def _k14_args(b=2, n=4, s=5, k=3):
    """Inputs of the steady append: frozen gains from the plain DARE of
    K1's test models."""
    phi, q, z, r = _k1_args()[:4]
    g = kernels.dare_gains(phi, q, z, r)
    return (phi, z, g[2], g[3], torch.ones((b, n), dtype=torch.bool),
            torch.zeros((b, s), dtype=torch.float64),
            torch.zeros((b, k, n), dtype=torch.float64),
            torch.ones((b, k, n), dtype=torch.bool),
            torch.ones(b, dtype=torch.bool))


def _robust_params(b, n, dtype=torch.float64):
    """Per-slot robust parameters that flag everything the censored
    likelihood sees (rails at +-0.1)."""
    return (torch.full((b, n), -0.1, dtype=dtype),
            torch.full((b, n), 0.1, dtype=dtype),
            torch.full((b, n), 0.5, dtype=dtype),
            torch.full((b, n), 0.1, dtype=dtype))


def test_autodiff_score_refuses_the_card(monkeypatch):
    """``score="autodiff"`` differentiates the plain filter; on a CUDA
    tensor it raises instead of running a plain version on the card."""
    phi, q, z, r, y, mask = _k3_args()
    data = LanesData(y, mask, mask.sum(2).T)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda")))
    with pytest.raises(RuntimeError, match="CPU tensors only"):
        lanes_terms(phi, q, z, r, data, None, 4, score="autodiff")


@pytest.mark.parametrize("bad", ["dtype", "shape", "mask", "int"])
def test_wrappers_check_their_inputs(bad):
    args = _k1_args()
    if bad == "dtype":
        args[1] = args[1].float()
        err = TypeError
    elif bad == "shape":
        args[3] = args[3][:, :2]
        err = ValueError
    elif bad == "mask":
        args[7] = args[7].to(torch.uint8)
        err = TypeError
    else:
        args = [a.long() if a.is_floating_point() else a for a in args]
        err = TypeError
    with pytest.raises(err):
        kernels.joint_filter_append(*args)


def _sharded_scan_plain_calls():
    """Every sharded mode of K19/K20 once through its wrapper on CPU
    tensors (two shards of 6 steps; counts no launch)."""
    from metran_tpu_torch.kernels import pkalman as kpk
    from metran_tpu_torch.ops import dfm_statespace

    rng = np.random.default_rng(4)
    ss = dfm_statespace(rng.uniform(5, 40, (2, 3)), rng.uniform(5, 40, (2, 1)),
                        rng.uniform(0.3, 0.8, (2, 3, 1)), 1.0, device="cpu",
                        dtype=torch.float64)
    y = torch.as_tensor(rng.normal(size=(2, 12, 3)))
    mask = torch.ones((2, 12, 3), dtype=torch.bool)
    halves = (slice(0, 6), slice(6, 12))
    tots = [kpk.parallel_filter_total(*ss, y[:, h], mask[:, h], 4, k == 0)
            for k, h in enumerate(halves)]
    pre = kpk.parallel_filter_carry(torch.stack([t[0] for t in tots], 1), 4)
    f = kpk.parallel_filter_prefix(*ss, y[:, 6:], mask[:, 6:], 4, tots[1][1],
                                   pre[:, 0])
    total, tot = kpk.parallel_smooth_total(ss.phi, f[2], f[3], f[0], f[1], 4)
    kpk.parallel_smooth_carry(torch.stack([total, total], 1), 4)
    kpk.parallel_smooth_prefix(ss.phi, f[2], f[3], f[0], f[1], 4, tot)


def test_plain_path_counts_no_launch_and_counters_reset():
    kernels.reset_launches()
    args = _k1_args()
    kernels.joint_filter_append(*args)
    kernels.forecast_moments(*args[:6], torch.arange(1, 3).double())
    k3 = _k3_args()
    res = kernels.lanes_filter(*k3, seg=4, keep_bounds=True)
    kernels.lanes_adjoint(*k3, None, 4, res.bounds_mean, res.bounds_cov,
                          torch.ones_like(res.sigma), res.detf)
    kernels.lanes_smooth_bwd(*k3, None, 4, res.bounds_mean, res.bounds_cov,
                             True)
    for mode in ("project", "innovations", "latch"):
        kernels.lanes_forward(*k3, mode, None,
                              torch.full((3,), 5, dtype=torch.int32))
    kernels.lanes_sample(*_k7_args())
    stored = kernels.lanes_forward(*k3, "store")
    ksm.rts_smooth(k3[0].T.contiguous(), stored[2], stored[3], stored[0],
                   stored[1])
    sq = kernels.sqrt_filter(*k3, store=True)
    kernels.sqrt_filter(*k3, mean0=sq[2][:, -1].contiguous(),
                        chol0=sq[3][:, -1].contiguous())
    for want_cov in (True, False):
        kernels.sqrt_smooth(k3[0].T.contiguous(), k3[1].T.contiguous(),
                            sq[2], sq[3], sq[0], sq[1], want_cov=want_cov)
    kernels.sqrt_filter(*k3, bounds_seg=3)
    kernels.joint_adjoint(*_k11_args(), 2)  # K1 bounds and K11
    kernels.joint_filter_store(*args)
    armed = torch.tensor([True, False])
    for policy in ("off", "reject", "huber", "inflate"):
        kernels.gated_filter_append(*args, armed, policy, 1.0)
    for policy in ("reject", "huber", "inflate"):
        kernels.sqrt_filter_gated(*k3, sq[2][:, -1].contiguous(),
                                  sq[3][:, -1].contiguous(),
                                  torch.ones(3, dtype=torch.bool), policy,
                                  1.0)
    kernels.detect_scan(*_k13_args())
    for lik in ("censored", "quantized", "huber_t"):
        out = kernels.robust_filter_append(*args, armed,
                                           *_robust_params(2, 4),
                                           likelihood=lik)
        assert (out[5] != 0).any()  # the MAP path ran
        out = kernels.sqrt_filter_robust(
            *k3, sq[2][:, -1].contiguous(), sq[3][:, -1].contiguous(),
            torch.ones(3, dtype=torch.bool), *_robust_params(3, 2),
            likelihood=lik)
        assert (out[5] != 0).any()
    for policy, seq in (("off", False), ("reject", False), ("huber", True)):
        kernels.steady_filter(*_k14_args(), policy, 16.0, seq)
    kernels.dare_gains(*args[:4])
    _arena_plain_calls()
    _sharded_scan_plain_calls()
    assert kernels.launches() == {"joint_filter_append": 0,
                                  "joint_filter_store": 0,
                                  "forecast_moments": 0,
                                  "lanes_filter": 0, "lanes_adjoint": 0,
                                  "lanes_smooth_bwd": 0, "lanes_forward": 0,
                                  "lanes_sample": 0, "rts_smooth": 0,
                                  "sqrt_filter": 0, "sqrt_filter_gated": 0,
                                  "sqrt_smooth": 0, "joint_adjoint": 0,
                                  "gated_filter": 0, "detect": 0,
                                  "gated_filter_robust": 0,
                                  "sqrt_filter_robust": 0,
                                  "steady_filter": 0, "dare": 0,
                                  "arena_update": 0,
                                  "arena_update_sqrt": 0,
                                  "arena_steady_update": 0,
                                  "arena_forecast": 0,
                                  "parallel_filter": 0,
                                  "parallel_smooth": 0,
                                  "sqrt_parallel_filter": 0,
                                  "sqrt_parallel_smooth": 0,
                                  "parallel_filter_total": 0,
                                  "parallel_filter_carry": 0,
                                  "parallel_filter_prefix": 0,
                                  "parallel_smooth_total": 0,
                                  "parallel_smooth_carry": 0,
                                  "parallel_smooth_prefix": 0}
    build.count_launch("forecast_moments")
    assert kernels.launches()["forecast_moments"] == 1
    kernels.reset_launches()
    assert set(kernels.launches().values()) == {0}


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


def test_library_name_follows_the_sources():
    for src in build.sources():
        path = build.library_path(src)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{src.stem}-")
    assert {p.name for p in build.sources()} == {
        "joint_filter.cu", "forecast.cu", "lanes_filter.cu",
        "lanes_filter_warp.cu", "lanes_adjoint.cu", "lanes_adjoint_warp.cu",
        "lanes_smooth.cu",
        "lanes_forward.cu",
        "lanes_sample.cu", "rts_smoother.cu", "sqrt_filter.cu",
        "sqrt_filter_block.cu", "sqrt_smoother.cu", "joint_adjoint.cu",
        "gated_filter.cu",
        "detect.cu", "steady_filter.cu", "dare.cu", "arena_joint.cu",
        "arena_gated.cu", "arena_sqrt.cu", "arena_steady.cu",
        "arena_forecast.cu", "pkalman_filter.cu", "pkalman_smoother.cu",
        "sqrt_pkalman_filter.cu", "sqrt_pkalman_smoother.cu"}
    assert set(build._SIGNATURES) == {p.stem for p in build.sources()}


def test_chip_smoke_refuses_without_a_card_and_outside_a_checkout(tmp_path):
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=_env())
    assert out.returncode != 0 and out.stdout == ""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""


# the ROADMAP items a message names: "ROADMAP A3", "ROADMAP A2, A6",
# "ROADMAP A4.2 for 'sequential', A6 for ..." (a kernel's own name, as in
# "kernel B8", is not an item)
_ID = r"[AC]\d+(?:\.\d+)?"
ITEM = re.compile(rf"ROADMAP\s+({_ID}(?:(?:,\s*|/|\s+and\s+|"
                  rf"\s+for\s+'[^']*',\s*){_ID})*)")
ITEM_ID = re.compile(r"\b([AC])(\d+)(?:\.(\d+))?\b")


def _roadmap_items():
    """``{"A1", "A4", "A4.2", "C1", ...}``: the numbered entries of
    ROADMAP.md's sections A and C (an item is ``N.`` at the start of a
    line within its section; ``A4.2`` an ``   2.`` sub-entry)."""
    items, section, parent = set(), None, None
    for line in (REPO / "ROADMAP.md").read_text().splitlines():
        head = re.match(r"### ([AC])\. ", line)
        if head:
            section = head.group(1)
            continue
        if line.startswith("## "):
            section = None
            continue
        if section is None:
            continue
        top = re.match(r"(\d+)\. ", line)
        if top:
            parent = top.group(1)
            items.add(f"{section}{parent}")
            continue
        sub = re.match(r"\s{2,}(\d+)\. ", line)
        if sub and parent is not None:
            items.add(f"{section}{parent}.{sub.group(1)}")
    return items


def test_not_ported_messages_name_items_that_exist_in_the_roadmap():
    items = _roadmap_items()
    assert {"A1", "A2", "A3", "A4.2", "A6", "C1"} <= items, items
    named = {}
    for path in sorted((REPO / "metran_tpu_torch").rglob("*.py")):
        text = path.read_text()
        for m in ITEM.finditer(text):
            for sec, num, sub in ITEM_ID.findall(m.group(1)):
                key = f"{sec}{num}" + (f".{sub}" if sub else "")
                named.setdefault(key, []).append(path.name)
    assert named, "no ROADMAP item named anywhere"
    missing = {k: v for k, v in named.items() if k not in items}
    assert not missing, missing


def test_robust_updates_are_ported_and_named_by_no_message():
    """Robust updates (B12) are ported: no not-ported message of the
    port names their ROADMAP item, the service and the update factory
    take a robust spec, and the robust modes count under names of their
    own."""
    for path in sorted((REPO / "metran_tpu_torch").rglob("*.py")):
        for m in ITEM.finditer(path.read_text()):
            assert "A4.3" not in m.group(1), (path.name, m.group(0))
    svc = MetranService(ModelRegistry(root=None), flush_deadline=None,
                        robust=RobustSpec(likelihood="huber_t"),
                        device="cpu")
    assert svc.robust.enabled
    svc.close()
    assert {"gated_filter_robust", "sqrt_filter_robust"} <= set(
        kernels.launches())


def test_steady_and_fixed_lag_are_ported_and_named_by_no_message():
    """Steady-state serving (A4.6) and fixed-lag smoothing (A4.7) are
    ported: no not-ported message names their items, the service takes
    both, and K14 and K15 count under names of their own."""
    for path in sorted((REPO / "metran_tpu_torch").rglob("*.py")):
        for m in ITEM.finditer(path.read_text()):
            assert "A4.6" not in m.group(1), (path.name, m.group(0))
            assert "A4.7" not in m.group(1), (path.name, m.group(0))
    svc = MetranService(ModelRegistry(root=None), flush_deadline=None,
                        steady=SteadySpec(tol=1e-6), fixed_lag=8,
                        device="cpu")
    assert svc.steady.enabled and svc.smoother.lag == 8
    svc.close()
    assert {"steady_filter", "dare"} <= set(kernels.launches())


def _arena_leaves(sqrt=False):
    """A CPU arena's leaves with two packed fleet models."""
    from metran_tpu_torch.serve.state import StateArena

    reg = ModelRegistry(arena=True, arena_rows=3, device="cpu",
                        engine="sqrt" if sqrt else "joint")
    arena = StateArena((8, 16), 3, dtype=np.float64, sqrt=sqrt,
                       device="cpu")
    return arena, reg


def _arena_plain_calls():
    """Every arena wrapper's plain path once (counts no launch)."""
    from metran_tpu_torch.kernels import arena as karena

    for sqrt in (False, True):
        arena, _ = _arena_leaves(sqrt)
        leaves = arena._dynamic() + arena._static()
        y = torch.zeros((2, 1, 8), dtype=torch.float64)
        mask = torch.ones((2, 1, 8), dtype=torch.bool)
        for body in (("sqrt",) if sqrt else ("joint", "gated")):
            karena.arena_update(*leaves, [0, 1], y, mask, body=body)
        karena.arena_forecast(*arena._dynamic()[:2], *arena._static(),
                              [0, 1], torch.ones(2, dtype=torch.float64),
                              sqrt=sqrt)
    mean, _, t_seen, version = arena._dynamic()
    phi, _, z, _ = arena._static()
    karena.arena_steady_update(
        mean, t_seen, version, phi, z, *arena._steady_leaves(), [0, 2],
        torch.ones((2, 8), dtype=torch.bool), y, mask)


def test_arena_is_ported_and_named_by_no_message(monkeypatch):
    """The state arena (A4.8, kernels K16-K18) is ported: no not-ported
    message names it; ``ModelRegistry(arena=True)`` defaults to the card
    and raises without one unless asked for the CPU; the launchers refuse
    CPU leaves; a sharded arena (A6's mesh half) shards its rows over
    the mesh; the fused horizon pass (A4.5) runs in the arena factories
    and the service arms the read path."""
    from metran_tpu_torch.kernels import arena as karena
    from metran_tpu_torch.serve import engine as peng

    for path in sorted((REPO / "metran_tpu_torch").rglob("*.py")):
        for m in ITEM.finditer(path.read_text()):
            assert "A4.8" not in m.group(1), (path.name, m.group(0))
    assert {"arena_update", "arena_update_sqrt", "arena_steady_update",
            "arena_forecast"} <= set(kernels.launches())
    reg = ModelRegistry(arena=True, arena_mesh=-1, device="cpu")
    assert reg.arena_enabled and reg.arena_stats["arenas"] == 0
    monkeypatch.setenv("METRAN_TPU_VIRTUAL_DEVICES", "4")
    sharded = ModelRegistry(arena=True, arena_mesh=4, device="cpu")
    arena = sharded.arena_for((8, 16), dtype=np.float64)
    assert len(arena.devices) == 4 and arena.capacity % 4 == 0
    monkeypatch.delenv("METRAN_TPU_VIRTUAL_DEVICES")
    for make in (peng.make_arena_update_fn,
                 peng.make_arena_steady_update_fn):
        assert callable(make(horizons=(1, 2)))
    svc = MetranService(reg, flush_deadline=None, readpath=True,
                        device="cpu")
    assert svc.readpath is not None and svc.readpath.horizons == tuple(
        range(1, 31))
    svc.close()
    arena, _ = _arena_leaves()
    leaves = arena._dynamic() + arena._static()
    y = torch.zeros((1, 1, 8), dtype=torch.float64)
    mask = torch.ones((1, 1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA leaves"):
        karena.arena_update_kernel(*leaves, [0], y, mask)
    with pytest.raises(ValueError, match="CUDA leaves"):
        mean, _, t_seen, version = arena._dynamic()
        phi, _, z, _ = arena._static()
        karena.arena_steady_update_kernel(
            mean, t_seen, version, phi, z, *arena._steady_leaves(), [0],
            torch.ones((1, 8), dtype=torch.bool), y, mask)
    with pytest.raises(ValueError, match="CUDA leaves"):
        karena.arena_forecast_kernel(*arena._dynamic()[:2],
                                     *arena._static(), [0],
                                     torch.ones(1, dtype=torch.float64))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device required"):
        ModelRegistry(arena=True)


def test_read_path_is_ported_and_named_by_no_message():
    """The materialized read path (A4.5) is ported: no not-ported message
    names it, every update factory takes ``horizons`` and the service arms
    a snapshot store; K16, K17 and K14 keep their launch counters."""
    from metran_tpu_torch.serve import engine as peng

    for path in sorted((REPO / "metran_tpu_torch").rglob("*.py")):
        for m in ITEM.finditer(path.read_text()):
            assert "A4.5" not in m.group(1), (path.name, m.group(0))
    for make in (peng.make_update_fn, peng.make_steady_update_fn,
                 peng.make_arena_update_fn,
                 peng.make_arena_steady_update_fn):
        assert callable(make(horizons=(1, 7, 30)))
    assert {"arena_update", "arena_update_sqrt", "arena_steady_update",
            "steady_filter", "forecast_moments"} <= set(kernels.launches())


def test_c3_detect_init_follows_the_precision_policy():
    """C3: ``detect_init``'s dtype defaults to None, the precision policy
    of its device (float64 on the CPU, as JAX's default call under the
    suite's x64), like the JAX function's."""
    import inspect

    from metran_tpu.ops import detect as jdet
    from metran_tpu_torch.ops import detect as pdet

    assert inspect.signature(pdet.detect_init).parameters[
        "dtype"].default is None
    assert inspect.signature(jdet.detect_init).parameters[
        "dtype"].default is None
    got = pdet.detect_init(5, device="cpu")
    want = np.asarray(jdet.detect_init(5))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_c4_service_keywords_and_defaults_are_the_jax_services(monkeypatch):
    """C4: ``MetranService.__init__`` takes the JAX service's keywords in
    its order and with its defaults (the port's ``device`` last);
    ``METRAN_TPU_SERVE_READPATH=1`` arms the read path through the
    ``"default"`` readpath and ``METRAN_TPU_SERVE_HORIZONS`` sets its
    horizons; an armed ``observability`` or ``capacity`` names A7."""
    import inspect

    from metran_tpu.serve import MetranService as JaxService
    from metran_tpu_torch.ops.kalman import NotPortedError

    jpar = inspect.signature(JaxService.__init__).parameters
    ppar = inspect.signature(MetranService.__init__).parameters
    assert list(ppar) == list(jpar) + ["device"]
    for name, par in jpar.items():
        assert ppar[name].default == par.default, name
    assert ppar["readpath"].default == "default"
    reg = ModelRegistry(root=None)
    svc = MetranService(reg, flush_deadline=None, device="cpu")
    assert svc.readpath is None and svc.horizons == tuple(range(1, 31))
    svc.close()
    monkeypatch.setenv("METRAN_TPU_SERVE_READPATH", "1")
    monkeypatch.setenv("METRAN_TPU_SERVE_HORIZONS", "1,7,30")
    svc = MetranService(reg, flush_deadline=None, device="cpu")
    assert svc.readpath is not None
    assert svc.readpath.horizons == (1, 7, 30) and svc.readpath.prefix == 1
    assert reg._commit_hooks == [svc.readpath.note_commit]
    svc.close()
    assert reg._commit_hooks == []
    monkeypatch.delenv("METRAN_TPU_SERVE_READPATH")
    for name in ("observability", "capacity"):
        with pytest.raises(NotPortedError, match="ROADMAP A7"):
            MetranService(reg, flush_deadline=None, device="cpu",
                          **{name: type("On", (), {"enabled": True})()})
