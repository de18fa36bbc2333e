#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits
non-zero):

1. device — card name, CUDA version, ``nvidia-smi`` name/power limit;
2. build — ``nvcc`` builds the kernels from ``metran_tpu_torch/kernels/
   csrc`` (time, ``-Xptxas -v`` registers/shared memory per kernel);
3. kernels — each kernel against its plain PyTorch version on the card,
   f64 and f32 (bars: normwise relative error 1e-9 and 1e-3), then at
   the main paths' shapes in f32, where kernel and plain version are
   also timed (CUDA events) beside the kernel's bound (the plain lanes
   filter and adjoint, a Python loop over 5,000 steps and 20 slots, run
   once there);
4. main path — a 512-model flagship fleet (20 series, 1 factor, 5,000
   steps, 30% missing, f32) filtered by the port's ``kalman_filter`` and
   served by ``MetranService``: forecasts, 10 update rounds, forecasts,
   then threaded synchronous calls; the launch counters must show the
   path went through both kernels, and 8 models are recomputed in f64 on
   the CPU with the plain versions;
5. fit path — the same flagship fleet (its own seed) packed with
   ``pack_fleet`` and fitted by ``fit_fleet(layout="lanes")`` under the
   JAX bench's fit settings (autocorrelation init, ``remat_seg=100``,
   ``tol=0.05``, ``stall_tol=1e-3``, 4 line-search trials,
   ``maxiter=60``, ``chunk=8``); the launch counters must show K3 and K4,
   every lane must end finite and no worse than it started, and 8 lanes
   are recomputed in f64 on the CPU with the plain versions.

The line before the last is ``nvidia-smi``'s ``name, power.limit``; the
line before that the ``{"kernels": [...]}`` summary; the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# flagship configuration (bench.py: 20 series, 1 factor, 5,000 steps,
# 30% missing, fleet of 512)
N_SERIES, N_FACTORS, T_STEPS, MISSING, FLEET = 20, 1, 5_000, 0.3, 512
BUCKET = (24, 32)  # the registry's bucket of a (20, 21) model
FORECAST_STEPS = 14
UPDATE_ROUNDS = 10
SEED = 0
# the JAX bench's fit settings (bench.py:48-65, :395-416)
FIT = dict(layout="lanes", remat_seg=100, tol=0.05, stall_tol=1e-3,
           max_linesearch_steps=4, maxiter=60, chunk=8)
LS_TRIALS = 4  # the grid line search's trial points per iteration
DEVICE = "cuda"  # the card the lanes and fit phases run on

# H100 SXM peaks (NVIDIA data sheet; dense, no sparsity)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "float64": 34e12}  # non-tensor-core


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what) -> None:
    """A check of the run that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# workload (bench.py::make_workload's recipe, keeping the alphas)
# ----------------------------------------------------------------------
def make_workload(rng, batch, n=N_SERIES, k=N_FACTORS, t=T_STEPS,
                  missing=MISSING):
    """Synthetic standardized DFM panels with a true common factor:
    ``(y, mask, loadings, alpha_sdf, alpha_cdf)``."""
    import numpy as np

    loadings = rng.uniform(0.4, 0.8, (batch, n, k)) / np.sqrt(k)
    alpha_c = rng.uniform(10.0, 60.0, (batch, k))
    alpha_s = rng.uniform(5.0, 40.0, (batch, n))
    phi_c = np.exp(-1.0 / alpha_c)
    phi_s = np.exp(-1.0 / alpha_s)
    e_c = rng.normal(size=(t, batch, k)) * np.sqrt(1 - phi_c**2)
    e_s = rng.normal(size=(t, batch, n)) * np.sqrt(1 - phi_s**2)
    common = np.zeros((t, batch, k))
    specific = np.zeros((t, batch, n))
    for i in range(1, t):
        common[i] = phi_c * common[i - 1] + e_c[i]
        specific[i] = phi_s * specific[i - 1] + e_s[i]
    comm = np.sum(loadings**2, axis=2)
    y = np.transpose(
        specific * np.sqrt(1 - comm)[None]
        + np.einsum("tbk,bnk->tbn", common, loadings),
        (1, 0, 2),
    )
    mask = rng.uniform(size=y.shape) > missing
    return np.where(mask, y, 0.0), mask, loadings, alpha_s, alpha_c


def padded_inputs(rng, batch, t, dtype, device, bucket=BUCKET):
    """A fleet padded into ``bucket`` as the serving engine pads it:
    ``(phi, q, z, r, y, mask)`` tensors, one fully masked step."""
    import numpy as np
    import torch

    from metran_tpu_torch.ops import dfm_statespace

    y, mask, lds, a_s, a_c = make_workload(rng, batch, t=t)
    n_pad, s_pad = bucket
    alpha_s = np.ones((batch, n_pad))
    alpha_s[:, :N_SERIES] = a_s
    alpha_c = np.ones((batch, s_pad - n_pad))
    alpha_c[:, :N_FACTORS] = a_c
    loadings = np.zeros((batch, n_pad, s_pad - n_pad))
    loadings[:, :N_SERIES, :N_FACTORS] = lds
    yp = np.zeros((batch, t, n_pad))
    mp = np.zeros((batch, t, n_pad), bool)
    yp[:, :, :N_SERIES] = y
    mp[:, :, :N_SERIES] = mask
    if t > 3:
        mp[:, 3] = False  # a fully masked step
    ss = dfm_statespace(alpha_s, alpha_c, loadings, 1.0, device=device,
                        dtype=dtype)
    return (*ss, torch.as_tensor(yp, dtype=dtype, device=device),
            torch.as_tensor(mp, device=device))


# ----------------------------------------------------------------------
# measurement helpers
# ----------------------------------------------------------------------
def cuda_ms(fn, reps=20, warm=2):
    """``(median milliseconds of fn() by CUDA events, the last call's
    result)``."""
    import statistics

    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def _nonfinite_match(got, want) -> bool:
    """Whether ``got`` is non-finite exactly where ``want`` is, with the
    same NaNs and infinities of the same sign."""
    import torch

    fin = torch.isfinite(want)
    inf = torch.isinf(want)
    return (torch.equal(fin, torch.isfinite(got))
            and torch.equal(torch.isnan(want), torch.isnan(got))
            and torch.equal(want[inf], got[inf]))


def rel_err(got, want) -> float:
    """Normwise relative error ``max|got - want| / max|want|`` over the
    finite entries; a non-finite value that ``want`` does not have at the
    same place (a NaN, an infinity) makes it infinite, never NaN."""
    import torch

    got, want = got.double(), want.double()
    if not _nonfinite_match(got, want):
        return float("inf")
    fin = torch.isfinite(want)
    if not fin.any():
        return 0.0
    scale = want[fin].abs().max().clamp_min(1e-300)
    return float((got[fin] - want[fin]).abs().max() / scale)


def abs_err(got, want) -> float:
    import torch

    got, want = got.double(), want.double()
    if not _nonfinite_match(got, want):
        return float("inf")
    fin = torch.isfinite(want)
    if not fin.any():
        return 0.0
    return float((got[fin] - want[fin]).abs().max())


def within(errs, bar) -> bool:
    """Every error is a number at or under ``bar`` (NaN and inf fail)."""
    return all(e <= bar for e in errs)


def k1_cost(z, q, mask, itemsize):
    """Bytes the K1 call must move (each input read once, each output
    written once) and the operations this run's data needs at the least:
    the square-root form of each update (``W = L^-1 Z_m P``,
    ``P -= W'W``, ``m += W' L^-1 v``) over the rows observed at that
    step, symmetric matrices on their upper halves, only the nonzeros of
    Z and q, and ``phi phi'`` once per model.  The kernel's own form
    (``K' = F^-1 Z_m P``, ``P -= K F K'``, full matrices) does more."""
    import torch

    b, n, s = z.shape
    k = mask.shape[1]
    nbytes = (b * (2 * s + 2 * s * s + n * s + n) * itemsize  # phi q z r m P
              + b * k * n * (itemsize + 1)  # y, mask
              + b * (s + s * s + 2 * k) * itemsize)  # mean, cov, sigma, detf
    half = s * (s + 1) / 2
    m = mask.double()
    n_t = m.sum(-1)  # observed rows per (model, step)
    nz_t = (m @ (z != 0).double().sum(-1)[..., None])[..., 0]  # nnz(Z_m)
    update = (2 * nz_t  # v = y - Z m
              + 2 * nz_t * s  # G = Z_m P
              + nz_t * (n_t + 1) + n_t  # F = G Z_m' + diag(r), upper half
              + n_t**3 / 3  # Cholesky
              + n_t**2 * s + n_t**2  # W = L^-1 G, u = L^-1 v
              + 4 * n_t  # sigma, detf
              + 2 * n_t * s  # m += W'u
              + s * (s + 1) * n_t)  # P -= W'W, upper half
    q_up = int(torch.triu(q != 0).sum())
    predict = b * k * (s + half) + k * q_up  # phi o m; (phi phi') o P + q
    return nbytes, b * half + predict + float(update.sum())


def k2_cost(z, q, h, itemsize):
    """Bytes the K2 call must move and the operations its data needs at
    the least: only the entries of ``P_h`` that ``diag(Z P_h Z')`` reads
    (the union of each row's support), only the nonzeros of Z and q, and
    the per-model logarithms and ``expm1(log pp)`` once per model."""
    import torch

    b, n, s = z.shape
    nbytes = (b * (2 * s + 2 * s * s + n * s + n) * itemsize + h * itemsize
              + 2 * b * h * n * itemsize)
    supp = (z != 0).double()
    need = torch.triu((supp.transpose(-1, -2) @ supp) > 0)
    n_need = int(need.sum())
    n_need_q = int((need & (q != 0)).sum())
    n_states = int((supp.sum(1) > 0).sum())  # states that Z reads
    nz_row = supp.sum(-1)
    per_model = n_states + n_need + n_need_q  # log phi, log pp, expm1 log pp
    per_h = (3 * n_states + 2 * float(nz_row.sum())  # m_h, Z m_h
             + 3 * n_need + 5 * n_need_q  # P_h entries, their q terms
             + float((nz_row * (nz_row + 1)).sum())  # z_a' P_h z_a
             + 2 * b * n)  # clip, + r
    return nbytes, per_model + h * per_h


def _lanes_shape(z, lane_map, count, seg):
    """``(L, n, N, K, T, n_seg, observed slots over all lanes)`` of a
    lanes launch; ``count`` (T, D) is the observed slots per data step."""
    big_n, n, lanes = z.shape
    t_steps = count.shape[0]
    obs = float(count.double().sum(0)[lane_map.long()].sum())
    return lanes, n, big_n, n - big_n, t_steps, -(-t_steps // seg), obs


def _filter_ops(n, k, lanes, t_steps, obs):
    """The least operations of the forward filter: per lane and step the
    diagonal predict on P's upper half (``phi_a phi_b`` once per lane);
    per observed slot, with Z = [I | L], ``v`` and ``f`` from the K+1
    nonzeros of z_i, ``d = P[:, i] + P[:, N:] L_i``, ``k = d/f``,
    ``m += k v``, ``P -= k d'`` on the upper half, sigma and log f."""
    half = n * (n + 1) / 2
    predict = lanes * (half + t_steps * (n + half + n))
    per_obs = ((2 * k + 2) + n * (2 * k + 1) + (2 * k + 3) + n + 2 * n
               + n * (n + 1) + 5)
    return predict + obs * per_obs


def k3_cost(z, lane_map, count, data_shape, seg, keep_bounds, itemsize):
    """Bytes the K3 call must move (each input once: the lane constants,
    the D data lanes' y and mask, the lane map; each output once) and the
    least operations this run's data needs (:func:`_filter_ops`: only
    observed slots, Z's structure, symmetric halves)."""
    lanes, n, big_n, k, t_steps, n_seg, obs = _lanes_shape(
        z, lane_map, count, seg)
    d_lanes = data_shape[0]
    nbytes = (lanes * (2 * n + big_n * n + big_n) * itemsize  # phi q z r
              + d_lanes * t_steps * big_n * (itemsize + 1) + 4 * lanes
              + lanes * (2 * t_steps + n + n * n) * itemsize)  # sigma detf m P
    if keep_bounds:
        nbytes += lanes * n_seg * (n + n * n) * itemsize
    return nbytes, _filter_ops(n, k, lanes, t_steps, obs)


def k4_cost(z, lane_map, count, data_shape, seg, itemsize):
    """Bytes the K4 call must move (the lane constants, data, lane map,
    boundaries and both cotangents read once; phibar and qbar written
    once) and the least operations: the forward replay
    (:func:`_filter_ops`, the boundaries are all it gets) and per
    observed slot the reverse update kept on W = S + S' (symmetric:
    ``W d`` on the upper half, the rank-2 update on z_i's K+1 nonzeros),
    per step the predict adjoint on the upper half."""
    lanes, n, big_n, k, t_steps, n_seg, obs = _lanes_shape(
        z, lane_map, count, seg)
    d_lanes = data_shape[0]
    nbytes = (lanes * (2 * n + big_n * n + big_n) * itemsize
              + d_lanes * t_steps * big_n * (itemsize + 1) + 4 * lanes
              + lanes * n_seg * (n + n * n) * itemsize  # boundaries
              + 2 * t_steps * lanes * itemsize  # sb, db
              + 2 * n * lanes * itemsize)  # phibar, qbar
    half = n * (n + 1) / 2
    per_obs = (2 * n  # u.d
               + 2 * n * n + 2 * n  # W d, d'W d
               + 18  # vbar, fbar
               + 4 * n + 2 * (k + 1)  # dvec, u update
               + 4 * n * (k + 1))  # W += dvec z' + z dvec'
    per_step = 2 * n + 3 * half + n + half + 2 * n  # phibar, qbar, rescale
    rev = obs * per_obs + lanes * t_steps * per_step
    return nbytes, _filter_ops(n, k, lanes, t_steps, obs) + rev


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_device():
    import torch

    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi})
    return smi


def phase_build():
    from metran_tpu_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    build.load_library("joint_filter")
    wall = time.perf_counter() - t0
    ptxas = {}
    for src, text in build.build_info.get("ptxas", {}).items():
        entries = []
        fn = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None:
                smem = re.search(r"(\d+) bytes smem", line)
                entries.append({
                    "function": fn, "registers": int(m.group(1)),
                    "static_smem_bytes": int(smem.group(1)) if smem else 0,
                })
            if "spill" in line and fn is not None and entries:
                entries[-1]["spills"] = line.split(":", 1)[-1].strip()
        ptxas[src] = entries
    emit({"phase": "build", "nvcc_seconds": build.build_info.get("seconds"),
          "load_seconds": wall, "libraries": build.build_info.get("paths"),
          "ptxas": ptxas})


def phase_kernels():
    """Each kernel against its plain version on the card."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import (
        forecast_moments,
        forecast_moments_plain,
        joint_filter_append,
        joint_filter_append_plain,
    )
    from metran_tpu_torch.kernels.joint_filter import smem_bytes

    dev = torch.device("cuda")
    checks = []
    b = 64
    t_hist = T_STEPS
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        rng = np.random.default_rng(SEED + 1)
        phi, q, z, r, y, mask = padded_inputs(rng, b + 1, t_hist, dtype, dev)
        # the last model's negative process noise makes its innovation
        # covariance indefinite: every step must degrade to a no-op
        q = q.clone()
        q[-1, 0, 0] = -10.0
        mask = mask.clone()
        mask[-1] = True
        mask[-1, :, N_SERIES:] = False
        s = phi.shape[1]
        mean0 = torch.zeros((b + 1, s), dtype=dtype, device=dev)
        cov0 = torch.eye(s, dtype=dtype, device=dev).expand(
            b + 1, s, s).contiguous()
        # a warm posterior to append to (plain, f64 on the card)
        warm = joint_filter_append_plain(
            *(a.double() for a in (phi, q, z, r, mean0, cov0)),
            y[:, :64].double(), mask[:, :64])
        wm, wc = warm[0].to(dtype), warm[1].to(dtype)
        cases = [("k=1", 1, wm, wc, slice(None)),
                 ("k=16", 16, wm, wc, slice(None)),
                 (f"k={t_hist} from N(0,I)", t_hist, mean0, cov0,
                  slice(0, b))]
        for label, k, m0, c0, sel in cases:
            args = (phi[sel], q[sel], z[sel], r[sel], m0[sel], c0[sel],
                    y[sel, 64:64 + k] if k < t_hist else y[sel, :k],
                    mask[sel, 64:64 + k] if k < t_hist else mask[sel, :k])
            got = joint_filter_append(*args)
            want = joint_filter_append_plain(*args)
            torch.cuda.synchronize()
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            bar = 1e-9 if dtype == torch.float64 else 1e-3
            n_inf = int(torch.isinf(want[3]).sum())
            ok = within(errs, bar)  # detf = +inf at the same steps too
            if sel == slice(None):  # the indefinite model degrades
                ok = ok and bool(torch.isinf(want[3][-1]).all())
            checks.append({
                "kernel": "joint_filter_append", "case": label,
                "dtype": name, "rel_err": errs, "bar": bar,
                "max_abs_err": max(abs_err(g, w) for g, w in zip(got, want)),
                "detf_inf_steps": n_inf, "ok": ok,
            })
        rng = np.random.default_rng(SEED + 2)
        phi, q, z, r, y, mask = padded_inputs(rng, b, 8, dtype, dev)
        phi = phi.clone()
        phi[0, 0] = float(np.exp(-1.0 / 3e4))  # near-unit-root model
        s = phi.shape[1]
        for h_max in (14, 90):
            hz = torch.arange(1, h_max + 1, device=dev).to(dtype)
            args = (phi, q, z, r, wm[:b], wc[:b], hz)
            got = forecast_moments(*args)
            want = forecast_moments_plain(*args)
            torch.cuda.synchronize()
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            bar = 1e-9 if dtype == torch.float64 else 1e-3
            checks.append({
                "kernel": "forecast_moments", "case": f"H={h_max}",
                "dtype": name, "rel_err": errs, "bar": bar,
                "max_abs_err": max(abs_err(g, w) for g, w in zip(got, want)),
                "ok": within(errs, bar),
            })
    for c in checks:
        emit({"phase": "kernel_check", **c})

    # each kernel at the main path's shapes (f32): held against its plain
    # version on the same inputs, then timed beside it
    times = {}
    dtype = torch.float32

    def at_main_shape(key, kernel, label, fn, plain, args, bar, cost,
                      reps=20, warm=2, plain_reps=20):
        ms, got = cuda_ms(lambda: fn(*args), reps=reps, warm=warm)
        plain_ms, want = cuda_ms(lambda: plain(*args), reps=plain_reps,
                                 warm=min(warm, plain_reps))
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        checks.append({
            "kernel": kernel, "case": f"main path: {label}",
            "dtype": "float32", "rel_err": errs, "bar": bar,
            "max_abs_err": max(abs_err(g, w) for g, w in zip(got, want)),
            "ok": within(errs, bar),
        })
        emit({"phase": "kernel_check", **checks[-1]})
        bms, bby = bound_ms(*cost, "float32")
        times[key] = {"shape": label, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bms, "bound_by": bby}

    rng = np.random.default_rng(SEED + 3)
    phi, q, z, r, y, mask = padded_inputs(rng, FLEET, 1, dtype, dev)
    s = phi.shape[1]
    n = z.shape[1]
    mean0 = torch.zeros((FLEET, s), dtype=dtype, device=dev)
    cov0 = torch.eye(s, dtype=dtype, device=dev).expand(FLEET, s, s).contiguous()
    at_main_shape(
        "joint_filter_append", "joint_filter_append",
        f"B={FLEET} k=1 N={n} S={s} f32 (update dispatch)",
        joint_filter_append, joint_filter_append_plain,
        (phi, q, z, r, mean0, cov0, y, mask), 1e-3,
        k1_cost(z, q, mask, 4),
    )
    times["joint_filter_append"]["smem_bytes"] = smem_bytes(n, s, dtype)
    hz = torch.arange(1, FORECAST_STEPS + 1, device=dev).to(dtype)
    at_main_shape(
        "forecast_moments", "forecast_moments",
        f"B={FLEET} H={FORECAST_STEPS} N={n} S={s} f32 (forecast dispatch)",
        forecast_moments, forecast_moments_plain,
        (phi, q, z, r, mean0, cov0, hz), 1e-3,
        k2_cost(z, q, FORECAST_STEPS, 4),
    )
    # the history pass: one K1 launch over the unpadded (20, 21) fleet
    from metran_tpu_torch.ops import dfm_statespace

    yh, mh, lds, a_s, a_c = make_workload(np.random.default_rng(SEED + 4),
                                          FLEET)
    ss = dfm_statespace(a_s, a_c, lds, 1.0, device=dev, dtype=dtype)
    s_h, n_h = ss.phi.shape[1], N_SERIES
    hist = (*ss, torch.zeros((FLEET, s_h), dtype=dtype, device=dev),
            torch.eye(s_h, dtype=dtype, device=dev).expand(
                FLEET, s_h, s_h).contiguous(),
            torch.as_tensor(yh, dtype=dtype, device=dev),
            torch.as_tensor(mh, device=dev))
    at_main_shape(
        "joint_filter_append_history", "joint_filter_append",
        f"B={FLEET} k={T_STEPS} N={n_h} S={s_h} f32 (history pass)",
        joint_filter_append, joint_filter_append_plain, hist, 1e-3,
        k1_cost(hist[2], hist[1], hist[7], 4),
        reps=5, warm=1, plain_reps=1,
    )
    emit({"phase": "kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "rel_err", "bar", "ok")}
        for c in checks], "times": times})
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"kernel disagrees with its plain version: {bad}")
    return checks, times


def phase_main_path():
    """The port's serving path at full width on the card."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import launches, reset_launches
    from metran_tpu_torch.ops import (
        dfm_statespace,
        filter_append,
        forecast_observation_moments,
        kalman_filter,
    )
    from metran_tpu_torch.serve import (
        MetranService,
        ModelRegistry,
        PosteriorState,
    )

    dev = torch.device("cuda")
    t_hist = T_STEPS
    rng = np.random.default_rng(SEED)
    y, mask, lds, a_s, a_c = make_workload(rng, FLEET)
    f32 = np.float32
    reset_launches()

    # 1. history pass: the fleet's posteriors, one K1 launch
    ss = dfm_statespace(a_s.astype(f32), a_c.astype(f32), lds.astype(f32),
                        1.0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = kalman_filter(ss, y.astype(f32), mask, engine="joint", store=False)
    means, covs = res.mean_f.cpu().numpy(), res.cov_f.cpu().numpy()
    t_history = time.perf_counter() - t0
    n_hist_degraded = int(torch.isinf(res.detf).sum())

    reg = ModelRegistry(root=None)
    names = tuple(f"s{j}" for j in range(N_SERIES))
    for i in range(FLEET):
        reg.put(PosteriorState(
            model_id=f"m{i}", version=0, t_seen=t_hist,
            mean=means[i], cov=covs[i],
            params=np.concatenate([a_s[i], a_c[i]]).astype(f32),
            loadings=lds[i].astype(f32), dt=1.0,
            scaler_mean=np.zeros(N_SERIES, f32),
            scaler_std=np.ones(N_SERIES, f32), names=names,
        ), persist=False)
    ids = [f"m{i}" for i in range(FLEET)]

    def timed_flush(svc, futs):
        t = time.perf_counter()
        svc.flush()
        out = [f.result() for f in futs]
        return time.perf_counter() - t, out

    fc_times, upd_times = [], []
    upd_rows = []  # (G, k, n) per round, kept for the CPU recompute
    with MetranService(reg, flush_deadline=None, max_batch=1024,
                       device=dev) as svc:
        dt_, first_fc = timed_flush(
            svc, [svc.forecast_async(m, FORECAST_STEPS) for m in ids])
        fc_times.append(dt_)
        urng = np.random.default_rng(SEED + 10)
        for _ in range(UPDATE_ROUNDS):
            obs = urng.normal(size=(FLEET, 1, N_SERIES))
            obs[urng.uniform(size=obs.shape) < 0.1] = np.nan
            upd_rows.append(obs)
            dt_, out = timed_flush(
                svc, [svc.update_async(m, obs[i]) for i, m in enumerate(ids)])
            upd_times.append(dt_)
        dt_, fc_after = timed_flush(
            svc, [svc.forecast_async(m, FORECAST_STEPS) for m in ids])
        fc_times.append(dt_)
        stats_batch = svc.stats
    for i, m in enumerate(ids):
        st = reg.get(m)
        require(st.version == UPDATE_ROUNDS, (m, st.version))
        require(st.t_seen == t_hist + UPDATE_ROUNDS, (m, st.t_seen))
        require(np.all(np.isfinite(st.mean)) and np.all(np.isfinite(st.cov)),
                (m, "non-finite posterior"))
        f = fc_after[i]
        require(f.version == UPDATE_ROUNDS, (m, f.version))
    for f in first_fc + fc_after:
        require(np.all(np.isfinite(f.means))
                and np.all(np.isfinite(f.variances)), "non-finite forecast")

    # threaded synchronous calls through the background flusher
    sync_ids = ids[:64]
    sync_rows = np.random.default_rng(SEED + 11).normal(
        size=(64, 1, N_SERIES))
    call_ms: dict = {"update": [], "forecast": []}
    errors: list = []
    lock = threading.Lock()
    with MetranService(reg, flush_deadline=0.002, max_batch=1024,
                       device=dev) as svc2:

        def worker(w):
            try:
                for j in range(w, 64, 8):
                    t = time.perf_counter()
                    st = svc2.update(sync_ids[j], sync_rows[j])
                    t_u = time.perf_counter() - t
                    t = time.perf_counter()
                    f = svc2.forecast(ids[64 + j], FORECAST_STEPS)
                    t_f = time.perf_counter() - t
                    require(st.version == UPDATE_ROUNDS + 1,
                            (sync_ids[j], st.version))
                    require(np.all(np.isfinite(f.means))
                            and np.all(np.isfinite(f.variances)),
                            "non-finite forecast")
                    with lock:
                        call_ms["update"].append(t_u * 1e3)
                        call_ms["forecast"].append(t_f * 1e3)
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                with lock:
                    errors.append(exc)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
            require(not th.is_alive(), "a sync-call thread hung")
        stats_sync = svc2.stats
    if errors:
        raise errors[0]
    counts = launches()
    for m in sync_ids:
        st = reg.get(m)
        require(st.version == UPDATE_ROUNDS + 1
                and st.t_seen == t_hist + UPDATE_ROUNDS + 1,
                (m, st.version, st.t_seen))
    for kind in ("poisoned_updates", "poisoned_forecasts",
                 "finalize_failures", "lookup_failures", "chain_failures"):
        require(stats_batch.get(kind, 0) == 0, (kind, stats_batch))
        require(stats_sync.get(kind, 0) == 0, (kind, stats_sync))
    require(not reg.integrity_stats, reg.integrity_stats)
    for kern in ("joint_filter_append", "forecast_moments"):
        require(counts[kern] > 0, f"main path never launched {kern}")

    # 8 models the sync calls left alone, recomputed in f64 on the CPU
    # with the plain versions
    errs = {"mean": [], "cov": [], "fc_means": [], "fc_vars": []}
    n_sync = len(sync_ids)
    for i in range(n_sync, FLEET, (FLEET - n_sync) // 8):
        ss_c = dfm_statespace(a_s[i].astype(f32).astype(float),
                              a_c[i].astype(f32).astype(float),
                              lds[i].astype(f32).astype(float), 1.0,
                              device="cpu")
        r_c = kalman_filter(ss_c, y[i].astype(f32).astype(float), mask[i],
                            device="cpu")
        m_c, c_c = r_c.mean_f, r_c.cov_f
        for rows in upd_rows:
            row = rows[i]
            msk = np.isfinite(row)
            m_c, c_c, _, _ = filter_append(
                ss_c, m_c, c_c, np.where(msk, row, 0.0), msk, device="cpu")
        fm, fv = forecast_observation_moments(
            ss_c, m_c, c_c, np.arange(1, FORECAST_STEPS + 1), device="cpu")
        st = reg.get(ids[i])
        errs["mean"].append(rel_err(torch.as_tensor(st.mean), m_c))
        errs["cov"].append(rel_err(torch.as_tensor(st.cov), c_c))
        errs["fc_means"].append(
            rel_err(torch.as_tensor(fc_after[i].means), fm))
        errs["fc_vars"].append(
            rel_err(torch.as_tensor(fc_after[i].variances), fv))
    worst = {key: max(e) for key, e in errs.items()}
    require(all(within(e, 1e-3) for e in errs.values()), errs)

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p)) if xs else None

    emit({
        "phase": "main_path", "fleet": FLEET, "t_history": t_hist,
        "history_pass_s": t_history,
        "history_degraded_steps": n_hist_degraded,
        "update_dispatch_ms": {"median": pct(upd_times, 50) * 1e3,
                               "p99": pct(upd_times, 99) * 1e3,
                               "rounds": len(upd_times)},
        "forecast_dispatch_ms": {"median": pct(fc_times, 50) * 1e3,
                                 "p99": pct(fc_times, 99) * 1e3,
                                 "dispatches": len(fc_times)},
        "sync_update_ms": {"p50": pct(call_ms["update"], 50),
                           "p99": pct(call_ms["update"], 99)},
        "sync_forecast_ms": {"p50": pct(call_ms["forecast"], 50),
                             "p99": pct(call_ms["forecast"], 99)},
        "launches": counts, "cpu_f64_rel_err": worst,
    })
    return counts


def lanes_case(rng, b, t, dtype, dev, n_pad=0, trials=1, unit_root=None):
    """A lanes launch's inputs from the flagship recipe: ``(phi, q, z, r,
    y, mask, lane_map, count)`` for ``trials`` lanes per data lane (the
    line search's layout), ``n_pad`` padded series slots (masked, zero
    loadings), a fully masked real series and a fully masked step;
    ``unit_root`` = "all" puts every state of lane 0 at alpha = 3e4,
    "factor" its common factor."""
    import numpy as np
    import torch

    from metran_tpu_torch.ops.lanes import lanes_statespace, prepare_data

    y, mask, lds, a_s, a_c = make_workload(rng, b, t=t)
    n_obs = N_SERIES + n_pad
    yp = np.zeros((b, t, n_obs))
    mp = np.zeros((b, t, n_obs), bool)
    yp[:, :, :N_SERIES] = y
    mp[:, :, :N_SERIES] = mask
    mp[:, :, 5] = False  # a fully masked real series
    if t > 3:
        mp[:, 3] = False  # a fully masked step
    ld = np.zeros((n_obs, N_FACTORS, b))
    ld[:N_SERIES] = np.transpose(lds, (1, 2, 0))
    alpha = np.ones((n_obs + N_FACTORS, b)) * 10.0
    alpha[:N_SERIES] = a_s.T
    alpha[n_obs:] = a_c.T
    lanes = trials * b
    alpha = np.tile(alpha, (1, trials)) * rng.uniform(0.5, 2.0, (1, lanes))
    if unit_root == "all":
        alpha[:, 0] = 3e4
    elif unit_root == "factor":
        alpha[n_obs:, 0] = 3e4
    new = dict(dtype=dtype, device=dev)
    phi, q, z, r = lanes_statespace(
        torch.as_tensor(alpha, **new),
        torch.as_tensor(np.tile(ld, (1, 1, trials)), **new),
        torch.ones(lanes, **new))
    data = prepare_data(torch.as_tensor(yp, **new), torch.as_tensor(mp, device=dev))
    lane_map = torch.arange(b, dtype=torch.int32, device=dev).repeat(trials)
    return phi, q, z, r, data.y, data.mask, lane_map, data.count


def deviance_cotangents(count, lane_map, warmup=1):
    """The cotangents ``(sb, db)`` that the deviance's sum sends back to
    K3's (sigma, detf): 1 where the warmup rule keeps the step."""
    import torch

    c = count[:, lane_map.long()]
    has_obs = c > 0
    keep = has_obs & (torch.cumsum(has_obs, dim=0) - 1 >= warmup)
    return keep.float(), keep.float()


def phase_lanes_kernels():
    """K3 (lanes filter) and K4 (lanes adjoint) against their plain
    versions on the card: small cases in f64 and f32, then the fit
    path's launches at full size in f32, timed."""
    import numpy as np
    import torch

    from metran_tpu_torch.kernels import (
        lanes_adjoint,
        lanes_adjoint_plain,
        lanes_filter,
        lanes_filter_plain,
    )

    dev = torch.device(DEVICE)
    checks = []

    def compare(kernel, case, dtype, got, want, bar):
        errs = [rel_err(g, w) for g, w in zip(got, want) if w is not None]
        checks.append({
            "kernel": kernel, "case": case,
            "dtype": str(dtype).replace("torch.", ""), "rel_err": errs,
            "bar": bar, "ok": within(errs, bar),
            "max_abs_err": max(abs_err(g, w) for g, w in zip(got, want)
                               if w is not None),
        })
        emit({"phase": "kernel_check", **checks[-1]})

    seg = 100
    for dtype, bar in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        cases = [
            ("padded series (24 slots, 20 real), a masked series and step, "
             "T=250 seg=100", dict(n_pad=4)),
            # f32: every state at the cap leaves these random panels an
            # innovation variance ~1e-5 of P, where f32 itself disagrees
            # with f64 by ~1e-2; the cap-pinned factor is the fit's regime
            ("near-unit-root lane (alpha=3e4)",
             dict(unit_root="all" if dtype == torch.float64 else "factor")),
            ("lane map, K=4 trials over 16 data lanes", dict(trials=4)),
        ]
        for label, kw in cases:
            rng = np.random.default_rng(SEED + 20)
            *args, count = lanes_case(rng, 16, 250, dtype, dev, **kw)
            got = lanes_filter(*args, seg=seg, keep_bounds=True)
            want = lanes_filter_plain(*args, seg=seg, keep_bounds=True)
            torch.cuda.synchronize()
            compare("lanes_filter", label, dtype, got, want, bar)
            cot = deviance_cotangents(count, args[-1])
            adj = (*args, seg, want.bounds_mean, want.bounds_cov,
                   *(c.to(dtype) for c in cot))
            got = lanes_adjoint(*adj)
            want = lanes_adjoint_plain(*adj)
            torch.cuda.synchronize()
            compare("lanes_adjoint", label, dtype, got, want, bar)

    # the fit path's launches, f32, full size: K3 over K*B trial lanes
    # (no boundaries), K3 over B lanes with boundaries (the value and
    # gradient's forward), K4 over B lanes
    dtype = torch.float32
    times = {}
    rng = np.random.default_rng(SEED + 21)
    *trial_args, count = lanes_case(rng, FLEET, T_STEPS, dtype, dev,
                                    trials=LS_TRIALS)
    lane_map = trial_args[-1]
    vg_args = [a[..., :FLEET] for a in trial_args[:4]] + [
        trial_args[4], trial_args[5], lane_map[:FLEET]]
    data_shape = tuple(trial_args[4].shape)
    z = trial_args[2]
    ms, got_trial = cuda_ms(lambda: lanes_filter(*trial_args, seg=seg),
                            reps=5, warm=1)
    ms_vg, got_vg = cuda_ms(
        lambda: lanes_filter(*vg_args, seg=seg, keep_bounds=True),
        reps=5, warm=1)
    plain_ms, want = cuda_ms(
        lambda: lanes_filter_plain(*trial_args, seg=seg, keep_bounds=True),
        reps=1, warm=0)
    compare("lanes_filter", f"main path: K*B={LS_TRIALS * FLEET} lanes "
            f"T={T_STEPS} N={N_SERIES} f32 (line-search trials)", dtype,
            got_trial[:4], want[:4], 1e-3)
    want_vg = [w[..., :FLEET] for w in want]
    compare("lanes_filter", f"main path: B={FLEET} lanes with boundaries "
            "(value and gradient)", dtype, got_vg, want_vg, 1e-3)
    nb, ops = k3_cost(z, lane_map, count, data_shape, seg, False, 4)
    bms, bby = bound_ms(nb, ops, "float32")
    nb_vg, ops_vg = k3_cost(z[..., :FLEET], lane_map[:FLEET], count,
                            data_shape, seg, True, 4)
    bms_vg, bby_vg = bound_ms(nb_vg, ops_vg, "float32")
    times["lanes_filter"] = {
        "shape": f"K*B={LS_TRIALS * FLEET} T={T_STEPS} N={N_SERIES} "
                 f"n={N_SERIES + N_FACTORS} f32 (line-search trials; plain "
                 "once, with boundaries)",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
        "vg_launch": {"shape": f"B={FLEET} with boundaries, seg={seg}",
                      "ms": ms_vg, "bound_ms": bms_vg, "bound_by": bby_vg},
    }
    cot = deviance_cotangents(count, lane_map[:FLEET])
    adj = (*vg_args, seg, got_vg.bounds_mean, got_vg.bounds_cov, *cot)
    ms4, got4 = cuda_ms(lambda: lanes_adjoint(*adj), reps=3, warm=1)
    plain4, want4 = cuda_ms(lambda: lanes_adjoint_plain(*adj), reps=1,
                            warm=0)
    compare("lanes_adjoint", f"main path: B={FLEET} T={T_STEPS} "
            f"N={N_SERIES} seg={seg} f32 (gradient)", dtype, got4, want4,
            1e-3)
    nb4, ops4 = k4_cost(z[..., :FLEET], lane_map[:FLEET], count, data_shape,
                        seg, 4)
    bms4, bby4 = bound_ms(nb4, ops4, "float32")
    times["lanes_adjoint"] = {
        "shape": f"B={FLEET} T={T_STEPS} N={N_SERIES} seg={seg} f32 "
                 "(plain once)",
        "ms": ms4, "plain_ms": plain4, "bound_ms": bms4, "bound_by": bby4,
    }
    emit({"phase": "lanes_kernels", "checks": [
        {k: c[k] for k in ("kernel", "case", "dtype", "rel_err", "bar", "ok")}
        for c in checks], "times": times})
    bad = [c for c in checks if not c["ok"]]
    require(not bad, f"kernel disagrees with its plain version: {bad}")
    return checks, times


class _KernelTimer:
    """CUDA events around every K3/K4 launch of a window, and host-clock
    times of each optimizer dispatch (its working-set width): the fit's
    device-busy share and its tail dispatches."""

    def __init__(self):
        self.events = []
        self.dispatches = []

    def __enter__(self):
        import torch

        from metran_tpu_torch.kernels import lanes as kl
        from metran_tpu_torch.parallel import lanes_lbfgs

        self._saved = (kl.lanes_filter_kernel, kl.lanes_adjoint_kernel,
                       lanes_lbfgs.make_chunk_runner)

        def timed(fn):
            def wrapper(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                self.events.append((start, end))
                return out
            return wrapper

        make_runner = self._saved[2]

        def make_timed_runner(*args, **kw):
            run = make_runner(*args, **kw)
            chunk = args[5]

            def run_chunk(state, *data):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = run(state, *data)
                torch.cuda.synchronize()
                self.dispatches.append({
                    "lanes": int(state.theta.shape[-1]), "iterations": chunk,
                    "ms": (time.perf_counter() - t) * 1e3})
                return out
            return run_chunk

        kl.lanes_filter_kernel = timed(self._saved[0])
        kl.lanes_adjoint_kernel = timed(self._saved[1])
        lanes_lbfgs.make_chunk_runner = make_timed_runner
        return self

    def __exit__(self, *exc):
        from metran_tpu_torch.kernels import lanes as kl
        from metran_tpu_torch.parallel import lanes_lbfgs

        (kl.lanes_filter_kernel, kl.lanes_adjoint_kernel,
         lanes_lbfgs.make_chunk_runner) = self._saved

    def kernel_ms(self):
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def phase_fit_path():
    """The port's fleet fit at full width on the card."""
    import numpy as np
    import torch

    from metran_tpu_torch.data import Panel
    from metran_tpu_torch.kernels import launches, reset_launches
    from metran_tpu_torch.parallel import (
        autocorr_init_params,
        fit_fleet,
        fleet_deviance,
        pack_fleet,
    )
    from metran_tpu_torch.parallel.fleet import (
        ALPHA_MAX,
        _alpha_to_theta,
        _theta_to_alpha,
    )

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 30)
    y, mask, lds, _, _ = make_workload(rng, FLEET, t=T_STEPS)
    y32 = y.astype(np.float32)
    names = [f"s{j}" for j in range(N_SERIES)]

    def panels(idx, values):
        return [Panel(values[i], mask[i], None, names, np.ones(N_SERIES),
                      np.zeros(N_SERIES), 1.0) for i in idx]

    t0 = time.perf_counter()
    fleet = pack_fleet(panels(range(FLEET), y32), list(lds),
                       dtype=torch.float32, device=dev)
    p0 = autocorr_init_params(fleet)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # the optimizer's own start: p0 through the theta parametrization
    cap = float(np.log(ALPHA_MAX))
    p_start = _theta_to_alpha(_alpha_to_theta(p0, cap), cap)
    dev_start = fleet_deviance(p_start, fleet, layout="lanes",
                               remat_seg=FIT["remat_seg"])

    reset_launches()
    with _KernelTimer() as timer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = fit_fleet(fleet, p0=p0, **FIT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        kernel_ms = timer.kernel_ms()
    for kern in ("lanes_filter", "lanes_adjoint"):
        require(counts[kern] > 0, f"fit path never launched {kern}")
    iters = fit.iterations.cpu().numpy()
    dev_fit = fit.deviance.cpu().numpy()
    params = fit.params.cpu().numpy()
    require(np.isfinite(dev_fit).all() and np.isfinite(params).all(),
            "a lane ended non-finite")
    worse = np.flatnonzero(dev_fit > dev_start.cpu().numpy())
    require(worse.size == 0, f"lanes ended worse than they started: {worse}")
    require(int(iters.max()) <= FIT["maxiter"], f"iterations {iters.max()}")

    # 8 lanes recomputed in f64 on the CPU with the plain versions at the
    # card's fitted parameters (the same f32-rounded observations)
    idx = list(range(0, FLEET, FLEET // 8))
    cpu_fleet = pack_fleet(panels(idx, y32.astype(np.float64)),
                           [lds[i] for i in idx], dtype=torch.float64,
                           device="cpu")
    t1 = time.perf_counter()
    dev_cpu = fleet_deviance(params[idx].astype(np.float64), cpu_fleet,
                             layout="lanes",
                             remat_seg=FIT["remat_seg"]).numpy()
    cpu_s = time.perf_counter() - t1
    rel = np.abs(dev_fit[idx] - dev_cpu) / np.abs(dev_cpu)
    require(within(rel.tolist(), 1e-4), f"card f32 vs CPU f64: {rel}")

    tails = [d for d in timer.dispatches if d["lanes"] < FLEET]
    emit({
        "phase": "fit_path", "fleet": FLEET, "t_steps": T_STEPS,
        "settings": FIT, "setup_s": setup_s, "fit_wall_s": wall,
        "fits_per_s": FLEET / wall,
        "iterations": {"mean": float(iters.mean()), "max": int(iters.max())},
        "converged_frac": float(fit.converged.float().mean()),
        "stalled_frac": float(fit.stalled.float().mean()),
        "kernel_ms": kernel_ms, "kernel_busy_share": kernel_ms / 1e3 / wall,
        "dispatches": len(timer.dispatches),
        "dispatch_ms": [round(d["ms"], 1) for d in timer.dispatches],
        "tail_dispatches": tails,
        "launches": counts,
        "deviance_mean": float(dev_fit.mean()),
        "improvement_mean": float((dev_start.cpu().numpy() - dev_fit).mean()),
        "cpu_f64_rel_err": float(rel.max()), "cpu_recompute_s": cpu_s,
    })
    return counts


KERNELS = {
    "joint_filter_append": {
        "source": "metran_tpu_torch/kernels/csrc/joint_filter.cu",
        "replaces": "metran_tpu/ops/kalman.py:329",
    },
    "forecast_moments": {
        "source": "metran_tpu_torch/kernels/csrc/forecast.cu",
        "replaces": "metran_tpu/ops/forecast.py:75",
    },
    "lanes_filter": {
        "source": "metran_tpu_torch/kernels/csrc/lanes_filter.cu",
        "replaces": "metran_tpu/ops/lanes.py:104",
    },
    "lanes_adjoint": {
        "source": "metran_tpu_torch/kernels/csrc/lanes_adjoint.cu",
        "replaces": "metran_tpu/ops/lanes.py:232",
    },
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (REPO / "metran_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the port",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    phase_build()
    checks, times = phase_kernels()
    lanes_checks, lanes_times = phase_lanes_kernels()
    checks += lanes_checks
    times.update(lanes_times)
    counts = phase_main_path()
    counts.update({k: v for k, v in phase_fit_path().items()
                   if k.startswith("lanes_")})

    summary = []
    for name, meta in KERNELS.items():
        t = times[name]
        f32 = [c["max_abs_err"] for c in checks
               if c["kernel"] == name and c["dtype"] == "float32"]
        entry = {
            "name": name, "route": "cuda", **meta,
            "launches": counts[name], "max_abs_err": max(f32),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": t["shape"],
        }
        if name == "joint_filter_append":
            entry["history_pass"] = times["joint_filter_append_history"]
        if name == "lanes_filter":
            entry["vg_launch"] = t["vg_launch"]
        summary.append(entry)
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
